"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the decoder on the card against the CPU.  Marked ``cuda``;
every test skips, with its reason, where no CUDA device is present.  Run on
a machine with an NVIDIA H100 with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.models import (decode_step_ragged, init_cache,  # noqa: E402
                                init_params, prefill)

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2e-2, torch.float32: 3e-5}   # as chip_smoke.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(2, 100, 228, 6, 3, 64, True, 100),
                                  (2, 1, 96, 6, 3, 72, True, 32),
                                  (1, 130, 130, 4, 2, 96, False, 0),
                                  (1, 64, 64, 2, 1, 128, True, 0)], ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Sk, Hq, Hkv, hd, causal, w = case
    q = torch.randn(B, Sq, Hq, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, Sk, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, Sk, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    n = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=w)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    _close(out, flash_attention_plain(q, k, v, causal=causal, window=w),
           dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(3, 300, 6, 3, 64), (2, 33, 4, 4, 72),
                                  (2, 200, 8, 1, 128)], ids=str)
def test_decode_attention_kernel_matches_plain(cuda, case, dtype):
    B, L, Hq, Hkv, hd = case
    q = torch.randn(B, Hq, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, L, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, L, Hkv, hd, generator=cuda, device="cuda").to(dtype)
    vlen = torch.randint(1, L + 1, (B,), generator=cuda, device="cuda",
                         dtype=torch.int32)
    vlen[0] = 0
    out = decode_attention(q, k, v, vlen)
    torch.cuda.synchronize()
    assert not out[0].any()
    _close(out, decode_attention_plain(q, k, v, vlen), dtype)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 80, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)


def test_decoder_on_the_card_matches_the_cpu(cuda):
    cfg = get_config("minicpm-2b", reduced=True).with_(
        compute_dtype="float32", param_dtype="float32")
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = {"embed": p_cpu["embed"].cuda(),
             "final_norm": p_cpu["final_norm"].cuda(),
             "groups": [{n: t.cuda() for n, t in g.items()}
                        for g in p_cpu["groups"]]}
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    before = ops.launch_counts()
    out = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        lg, cache = prefill(cfg, p, toks.to(dev),
                            init_cache(cfg, 2, 20, dev))
        t = torch.tensor([16, 11], dtype=torch.int32, device=dev)
        l1, _ = decode_step_ragged(cfg, p, cache, lg.argmax(-1), t)
        out[dev] = (lg.cpu(), l1.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    after = ops.launch_counts()
    assert after["attention"] - before["attention"] == cfg.n_layers
    assert after["decode_attention"] - before["decode_attention"] \
        == cfg.n_layers
