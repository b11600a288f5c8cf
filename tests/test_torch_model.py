"""The port's decoder against the JAX package's, on the CPU: weights are
initialised in JAX and bridged, inputs come from numpy, and the JAX side
runs both its reference path ("xla") and its Pallas kernels in interpret
mode.  Also the decode properties of tests/test_kernel_dispatch.py, re-run
on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (ModelConfig, decode_step,  # noqa: E402
                                decode_step_ragged, forward, init_cache,
                                init_params, params_from_numpy, prefill)

F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = dict(rtol=2e-4, atol=2e-4)     # model logits, as test_kernel_dispatch


def _dense(**kw):
    base = dict(name="t-dense", arch_type="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, **F32)
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _minicpm(**kw):
    return (j_get_config("minicpm-2b", reduced=True).with_(**kw),
            get_config("minicpm-2b", reduced=True).with_(**kw))


PAIRS = {
    "dense": _dense(),
    "swa": _dense(sliding_window=4, name="t-swa"),   # ring cache < prompt
    "one-layer": _dense(n_layers=1, name="t-one"),   # unstacked params
    "minicpm-reduced": _minicpm(**F32),              # hd 72, MHA
}


def _bridge(jcfg, tcfg, seed=0):
    p = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return p, params_from_numpy(tcfg, jax.tree.map(np.asarray, p), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cache_leaves(cache):
    return [e[k] for e in cache["layers"] for k in ("k", "v")]


def _clone(cache):
    return {"layers": [{k: t.clone() for k, t in e.items()}
                       for e in cache["layers"]]}


@pytest.mark.parametrize("kern", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("name", list(PAIRS))
def test_forward_prefill_decode_match_jax(name, kern):
    jc, tc = PAIRS[name]
    jc = jc.with_(kernels=kern)
    jp, tp = _bridge(jc, tc)
    S = 8
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, S))
    ttoks = torch.from_numpy(toks)
    lj, _ = j_forward(jc, jp, jnp.asarray(toks, jnp.int32))
    lt, aux = forward(tc, tp, ttoks)
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    assert float(aux) == 0.0

    lgj, cj = j_prefill(jc, jp, jnp.asarray(toks, jnp.int32),
                        j_init_cache(jc, 2, S + 4))
    lgt, ct = prefill(tc, tp, ttoks, init_cache(tc, 2, S + 4, "cpu"))
    np.testing.assert_allclose(_np(lgt), _np(lgj), **TOL)
    for a, b in zip(_cache_leaves(ct), jax.tree.leaves(cj)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)

    tok = np.asarray(jnp.argmax(lgj, axis=-1)).astype(np.int32)
    l1j, c1j = j_decode_step(jc, jp, cj, jnp.asarray(tok), jnp.int32(S))
    l1t, c1t = decode_step(tc, tp, ct, torch.from_numpy(tok), S)
    np.testing.assert_allclose(_np(l1t), _np(l1j), **TOL)
    for a, b in zip(_cache_leaves(c1t), jax.tree.leaves(c1j)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("name", list(PAIRS))
def test_ragged_uniform_t_equals_decode_step(name):
    """decode_step_ragged with a uniform position vector IS decode_step."""
    jc, tc = PAIRS[name]
    _, tp = _bridge(jc, tc)
    S = 8
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, tc.vocab_size, (2, S)))
    lg, cache = prefill(tc, tp, toks, init_cache(tc, 2, S + 4, "cpu"))
    tok = lg.argmax(-1)
    l1, c1 = decode_step(tc, tp, _clone(cache), tok, S)
    l2, c2 = decode_step_ragged(tc, tp, _clone(cache), tok,
                                torch.full((2,), S, dtype=torch.int32))
    assert torch.equal(l1, l2)
    for a, b in zip(_cache_leaves(c1), _cache_leaves(c2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["dense", "swa"], ids=["full", "windowed"])
def test_ragged_rows_match_independent_sequences(name):
    """A ragged batch at different depths computes, row for row, what each
    row computes alone at its own position (test_kernel_dispatch.py's
    continuous-batching property, on the port)."""
    jc, tc = PAIRS[name]
    _, tp = _bridge(jc, tc)
    max_len, prompts = 12, [6, 9]
    rng = np.random.default_rng(2)
    row_caches, row_toks = [], []
    for n in prompts:
        toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (1, n)))
        lg1, c1 = prefill(tc, tp, toks, init_cache(tc, 1, max_len, "cpu"))
        row_caches.append(c1)
        row_toks.append(lg1.argmax(-1))
    cache = {"layers": [{k: torch.cat([rc["layers"][i][k]
                                        for rc in row_caches], dim=1)
                         for k in ("k", "v")}
                        for i in range(len(row_caches[0]["layers"]))]}
    lr, cr = decode_step_ragged(tc, tp, cache, torch.cat(row_toks),
                                torch.tensor(prompts, dtype=torch.int32))
    for i, n in enumerate(prompts):
        li, ci = decode_step(tc, tp, row_caches[i], row_toks[i], n)
        np.testing.assert_allclose(_np(lr[i:i + 1]), _np(li),
                                   rtol=2e-5, atol=2e-5)
        for a, b in zip(_cache_leaves(cr), _cache_leaves(ci)):
            np.testing.assert_allclose(_np(a[:, i:i + 1]), _np(b),
                                       rtol=2e-5, atol=2e-5)


def test_bf16_minicpm_reduced_matches_jax():
    """bf16 end to end (the serving dtype).  The two frameworks round at
    other places (matmul accumulation, silu, the embedding scale is exact
    in neither), so the logits are held to 2e-2 of their largest magnitude
    over a prefill and one decode step."""
    jc, tc = _minicpm()
    jp, tp = _bridge(jc, tc)
    S = 8
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, S))
    lgj, cj = j_prefill(jc, jp, jnp.asarray(toks, jnp.int32),
                        j_init_cache(jc, 2, S + 2))
    lgt, ct = prefill(tc, tp, torch.from_numpy(toks),
                      init_cache(tc, 2, S + 2, "cpu"))
    assert lgt.dtype == torch.bfloat16
    tok = np.asarray(jnp.argmax(lgj, axis=-1)).astype(np.int32)
    l1j, _ = j_decode_step(jc, jp, cj, jnp.asarray(tok), jnp.int32(S))
    l1t, _ = decode_step(tc, tp, ct, torch.from_numpy(tok), S)
    for got, want in ((lgt, lgj), (l1t, l1j)):
        bound = 2e-2 * np.abs(_np(want)).max()
        assert np.abs(_np(got) - _np(want)).max() <= bound


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "whisper-tiny",
                                  "zamba2-1.2b"])
def test_unported_layers_raise_naming_their_roadmap_item(arch):
    cfg = get_config(arch, reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_cache(cfg, 1, 8, device="cpu")


def test_frontend_models_refuse_forward():
    cfg = get_config("phi-3-vision-4.2b", reduced=True)
    p = init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="frontend"):
        forward(cfg, p, torch.zeros((1, 4), dtype=torch.long))
