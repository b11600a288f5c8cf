"""Operation and byte counts against shapes reckoned by hand."""
import pytest

from portbench.counts import dense, kernels, mamba2


def test_flash_attention_counts_causal_pairs():
    # 1 row, 4 tokens, 1 head, hd 2: pairs 1+2+3+4 = 10, 2 products of
    # 2*hd operations each
    f, b = kernels.flash_attention(1, 4, 1, 1, 2)
    assert f == 10 * 2 * (2 * 2)
    # q, k, v read and o written: 4 tensors of 4 x 2 bf16
    assert b == 4 * 4 * 2 * 2


def test_decode_attention_counts_valid_keys():
    f, b = kernels.decode_attention([3, 5], 2, 1, 4)
    assert f == 4 * 2 * 4 * 8
    # K and V of 8 positions, 1 KV head, hd 4; q and o of 2 rows x 2 heads
    assert b == (2 * 1 * 4 * 8 + 2 * 2 * 4 * 2) * 2 + 4 * 2


def test_ssd_scan_counts_chunks():
    f, b = kernels.ssd_scan(rows=1, S=8, H=1, P=2, N=3, Q=4)
    # two chunks: C Bt 2*16*3, y_diag 2*16*2, states and y_off 4*4*3*2,
    # the carry 2*3*2
    per = 2 * 16 * 3 + (2 * 16 * 2 + 4 * 4 * 3 * 2 + 2 * 3 * 2)
    assert f == 2 * per
    assert b == (2 * 8 * 1 * 2 + 8 * 1 + 2 * 8 * 3) * 2 + 1 * 2 * 3 * 4 \
        + 1 * 4


def test_dense_model_counts():
    d = {"d_model": 4, "n_layers": 3, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 2, "d_ff": 8, "vocab_size": 10}
    lin = 2 * (4 * 4 + 2 * 4 * 2 + 4 * 4 + 3 * 4 * 8)
    V = 256
    assert dense.join_flops(d, 2, 5) == 2 * (3 * (5 * lin + 2 * 2 * 2 * 5 * 6)
                                             + 2 * 4 * V)
    assert dense.step_flops(d, [7]) == 3 * (lin + 4 * 2 * 2 * 7) + 2 * 4 * V
    assert dense.join_launches(d, 2, 5)["flash_attention"] == \
        [kernels.flash_attention(2, 5, 2, 1, 2)] * 3
    assert dense.step_launches(d, [7, 9])["decode_attention"] == \
        [kernels.decode_attention([7, 9], 2, 1, 2)] * 3


def test_mamba2_model_counts():
    d = {"d_model": 4, "n_layers": 2, "ssm_expand": 2, "ssm_head_dim": 2,
         "ssm_state": 3, "ssm_chunk": 4, "vocab_size": 10}
    di, H = 8, 4
    lin = 2 * 4 * (2 * di + 2 * 3 + H) + 2 * di * 4
    scan = kernels.ssd_scan(1, 8, H, 2, 3, 4)[0]
    assert mamba2.join_flops(d, 3, 8) == pytest.approx(
        3 * (2 * (8 * lin + scan) + 2 * 4 * 256))
    assert mamba2.step_flops(d, [1, 1]) == 2 * (2 * (lin + 4 * H * 2 * 3)
                                               + 2 * 4 * 256)
    assert mamba2.step_launches(d, [1]) == {}
