"""Head dim 256 (gemma3-1b at published width: 4 query heads over 1 KV
head, so a decode group of G = 4 at G * hd = 1024) on the CPU: the plain
flash and decode versions against the Pallas kernels in interpret mode,
and a gemma3-shaped decoder against the JAX package's on its
``pallas_interpret`` path, as tests/test_kernel_dispatch.py runs it.  The
CUDA instances run in tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as j_decode_pallas  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash_pallas  # noqa: E402
from repro.models import decode_step_ragged as j_ragged  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    HEAD_DIMS as DEC_HEAD_DIMS, MAX_GROUP_WIDTH, decode_attention)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS as FA_HEAD_DIMS, flash_attention)
from repro_torch.models import (decode_step_ragged, forward,  # noqa: E402
                                init_cache, params_from_numpy, prefill)

TOL = dict(rtol=3e-5, atol=3e-5)         # ops, f32
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)   # model logits, f32

# (B, Sq, Sk, Hq, Hkv, causal, window): gemma3's prefill (causal, and its
# local window), a non-causal one, and a one-query non-causal row over a
# long K (the shape of whisper's cross-attention in decode)
FA_CASES = [
    (2, 96, 96, 4, 1, True, 0),
    (1, 160, 160, 4, 1, True, 64),
    (1, 72, 72, 4, 1, False, 0),
    (2, 1, 300, 4, 1, False, 0),
]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_the_wrappers_take_head_dim_256_at_group_width_1024():
    assert 256 in FA_HEAD_DIMS and 256 in DEC_HEAD_DIMS
    assert 4 * 256 <= MAX_GROUP_WIDTH
    cfg = get_config("gemma3-1b")
    assert cfg.hd == 256 and cfg.n_heads // cfg.n_kv_heads == 4


@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_attention_plain_matches_pallas_at_hd256(case):
    B, Sq, Sk, Hq, Hkv, causal, w = case
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, B, Sq, Hq, 256), _rand(rng, B, Sk, Hkv, 256),
               _rand(rng, B, Sk, Hkv, 256))
    want = np.asarray(j_flash_pallas(*map(jnp.asarray, (q, k, v)),
                                     causal=causal, window=w, interpret=True,
                                     block_q=64, block_k=64))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          causal=causal, window=w)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("vlen", [[37, 200], [0, 129]], ids=["rows",
                                                             "zero-row"])
def test_decode_attention_plain_matches_pallas_at_hd256(vlen):
    B, L, Hq, Hkv = 2, 200, 4, 1
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, B, Hq, 256), _rand(rng, B, L, Hkv, 256),
               _rand(rng, B, L, Hkv, 256))
    vl = np.array(vlen, np.int32)
    want = np.asarray(j_decode_pallas(*map(jnp.asarray, (q, k, v, vl)),
                                      block_k=64, interpret=True))
    got = decode_attention(*map(torch.from_numpy, (q, k, v, vl)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if 0 in vlen:
        assert not got[vlen.index(0)].any()


def test_gemma3_at_hd256_matches_jax_on_its_pallas_path():
    """gemma3 reduced, with the published head shape (4 heads of 256 over
    one KV head): the local ring (window 64, wrapped by the prompt) and the
    global prefix, through forward, prefill and a ragged decode step."""
    kw = dict(head_dim=256, n_heads=4, n_kv_heads=1,
              compute_dtype="float32", param_dtype="float32")
    jc = j_get_config("gemma3-1b", reduced=True).with_(
        kernels="pallas_interpret", **kw)
    tc = get_config("gemma3-1b", reduced=True).with_(**kw)
    jp = j_init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    S = 80
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, (2, S))
    lj, _ = j_forward(jc, jp, jnp.asarray(toks, jnp.int32))
    lt, _ = forward(tc, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **MODEL_TOL)
    lgj, cj = j_prefill(jc, jp, jnp.asarray(toks, jnp.int32),
                        j_init_cache(jc, 2, S + 4))
    lgt, ct = prefill(tc, tp, torch.from_numpy(toks),
                      init_cache(tc, 2, S + 4, "cpu"))
    np.testing.assert_allclose(lgt.numpy(), np.asarray(lgj), **MODEL_TOL)
    tok = np.asarray(jnp.argmax(lgj, axis=-1)).astype(np.int32)
    t = np.array([S, S - 5], np.int32)
    l1j, _ = j_ragged(jc, jp, cj, jnp.asarray(tok), jnp.asarray(t))
    l1t, _ = decode_step_ragged(tc, tp, ct, torch.from_numpy(tok),
                                torch.from_numpy(t))
    np.testing.assert_allclose(l1t.numpy(), np.asarray(l1j), **MODEL_TOL)
