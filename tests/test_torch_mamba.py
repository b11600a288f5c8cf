"""The port's Mamba2 decoder against the JAX package's, on the CPU: weights
are initialised in JAX and bridged, inputs come from numpy, and the JAX side
runs both its reference path ("xla") and its Pallas SSD kernel in interpret
mode.  Also the serving executor's joins and steps against
``ContinuousJaxExecutor``, and the bridge's float32 Mamba leaves."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import decode_step_ragged as j_decode_ragged  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving.executor import ContinuousJaxExecutor  # noqa: E402
from repro.serving.executor import ServedModel as JServed  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import (ModelConfig, decode_step,  # noqa: E402
                                decode_step_ragged, forward, init_cache,
                                init_params, params_from_numpy, prefill)
from repro_torch.serving import (ContinuousTorchExecutor,  # noqa: E402
                                 ServedModel)

F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = dict(rtol=2e-4, atol=2e-4)     # model logits, as test_kernel_dispatch
MAMBA_LEAVES = ("A_log", "dt_bias", "conv_b", "D")


def _ssm(**kw):
    """tests/test_kernel_dispatch.py's ``_ssm()``: H 4, P 64, N 16, Q 64."""
    base = dict(name="t-ssm", arch_type="ssm", n_layers=2, d_model=128,
                n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=256,
                ssm_state=16, **F32)
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _mamba2(**kw):
    """mamba2-370m reduced: H 16, P 32, N 32, Q 16."""
    return (j_get_config("mamba2-370m", reduced=True).with_(**kw),
            get_config("mamba2-370m", reduced=True).with_(**kw))


PAIRS = {
    "ssm": _ssm(),
    "one-layer": _ssm(n_layers=1, name="t-ssm-one"),   # unstacked params
    "mamba2-reduced": _mamba2(**F32),
}


def _bridge(jcfg, tcfg, seed=0):
    p = j_init_params(jcfg, jax.random.PRNGKey(seed))
    return p, params_from_numpy(tcfg, jax.tree.map(np.asarray, p), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cache_leaves(cache):
    return [e[k] for e in cache["layers"] for k in ("conv", "state")]


def _clone(cache):
    return {"layers": [{k: t.clone() for k, t in e.items()}
                       for e in cache["layers"]]}


@pytest.mark.parametrize("kern", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("name", list(PAIRS))
def test_forward_prefill_decode_match_jax(name, kern):
    """S = 40 is no multiple of either chunk (64, 16), so the dt = 0
    padding runs too."""
    jc, tc = PAIRS[name]
    jc = jc.with_(kernels=kern)
    jp, tp = _bridge(jc, tc)
    S = 40
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
        assert a.shape == b.shape and a.dtype == getattr(torch, str(b.dtype))
        np.testing.assert_allclose(_np(a), _np(b), **TOL)

    tok = np.asarray(jnp.argmax(lgj, axis=-1)).astype(np.int32)
    for step in range(2):
        l1j, cj = j_decode_step(jc, jp, cj, jnp.asarray(tok),
                                jnp.int32(S + step))
        l1t, ct = decode_step(tc, tp, ct, torch.from_numpy(tok), S + step)
        np.testing.assert_allclose(_np(l1t), _np(l1j), **TOL)
        for a, b in zip(_cache_leaves(ct), jax.tree.leaves(cj)):
            np.testing.assert_allclose(_np(a), _np(b), **TOL)
        tok = np.asarray(jnp.argmax(l1j, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("name", list(PAIRS))
def test_decode_step_ragged_matches_jax(name):
    """Rows at other depths: a Mamba row carries its own state, so the
    per-row positions change nothing, in either package."""
    jc, tc = PAIRS[name]
    jp, tp = _bridge(jc, tc)
    S = 24
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (3, S))
    _, cj = j_prefill(jc, jp, jnp.asarray(toks, jnp.int32),
                      j_init_cache(jc, 3, S + 8))
    _, ct = prefill(tc, tp, torch.from_numpy(toks),
                    init_cache(tc, 3, S + 8, "cpu"))
    tok = np.array([[3], [7], [11]], np.int32)
    t = np.array([S, S + 5, S - 9], np.int32)
    lj, cj = j_decode_ragged(jc, jp, cj, jnp.asarray(tok), jnp.asarray(t))
    lt, ct = decode_step_ragged(tc, tp, ct, torch.from_numpy(tok),
                                torch.from_numpy(t))
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    for a, b in zip(_cache_leaves(ct), jax.tree.leaves(cj)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("name", list(PAIRS))
def test_ragged_uniform_t_equals_decode_step(name):
    """decode_step_ragged with a uniform position vector IS decode_step."""
    jc, tc = PAIRS[name]
    _, tp = _bridge(jc, tc)
    S = 20
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, tc.vocab_size, (2, S)))
    lg, cache = prefill(tc, tp, toks, init_cache(tc, 2, S + 4, "cpu"))
    tok = lg.argmax(-1)
    l1, c1 = decode_step(tc, tp, _clone(cache), tok, S)
    l2, c2 = decode_step_ragged(tc, tp, _clone(cache), tok,
                                torch.full((2,), S, dtype=torch.int32))
    assert torch.equal(l1, l2)
    for a, b in zip(_cache_leaves(c1), _cache_leaves(c2)):
        assert torch.equal(a, b)


def test_ragged_rows_match_independent_sequences():
    """A ragged batch of prompts of other lengths computes, row for row,
    what each row computes alone."""
    jc, tc = PAIRS["mamba2-reduced"]
    _, tp = _bridge(jc, tc)
    prompts = [6, 19]
    rng = np.random.default_rng(3)
    row_caches, row_toks = [], []
    for n in prompts:
        toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (1, n)))
        lg1, c1 = prefill(tc, tp, toks, init_cache(tc, 1, 24, "cpu"))
        row_caches.append(c1)
        row_toks.append(lg1.argmax(-1))
    cache = {"layers": [{k: torch.cat([rc["layers"][i][k]
                                        for rc in row_caches], dim=1)
                         for k in ("conv", "state")}
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


def test_bf16_mamba2_reduced_matches_jax():
    """bf16 end to end (the serving dtype), float32 Mamba leaves bridged as
    float32.  The frameworks round bf16 at other places (matmul
    accumulation, the conv's sums, silu), so the logits are held to 2e-2 of
    their largest magnitude over a prefill and two decode steps."""
    jc, tc = _mamba2()
    jp, tp = _bridge(jc, tc)
    S = 40
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (2, S))
    lgj, cj = j_prefill(jc, jp, jnp.asarray(toks, jnp.int32),
                        j_init_cache(jc, 2, S + 2))
    lgt, ct = prefill(tc, tp, torch.from_numpy(toks),
                      init_cache(tc, 2, S + 2, "cpu"))
    assert lgt.dtype == torch.bfloat16
    assert ct["layers"][0]["conv"].dtype == torch.bfloat16
    assert ct["layers"][0]["state"].dtype == torch.float32
    pairs = [(lgt, lgj)]
    tok = np.asarray(jnp.argmax(lgj, axis=-1)).astype(np.int32)
    for step in range(2):
        l1j, cj = j_decode_step(jc, jp, cj, jnp.asarray(tok),
                                jnp.int32(S + step))
        l1t, ct = decode_step(tc, tp, ct, torch.from_numpy(tok), S + step)
        pairs.append((l1t, l1j))
        tok = np.asarray(jnp.argmax(l1j, axis=-1)).astype(np.int32)
    for got, want in pairs:
        bound = 2e-2 * np.abs(_np(want)).max()
        assert np.abs(_np(got) - _np(want)).max() <= bound


def test_bridge_keeps_the_float32_mamba_leaves():
    """Under the published bf16 config the JAX package keeps A_log,
    dt_bias, conv_b and D in float32; the bridge keeps every leaf's dtype
    and value, and the port's own init_params gives the same dtypes and
    the same deterministic Mamba leaves (to float32 rounding)."""
    jc, tc = _mamba2()
    jp, tp = _bridge(jc, tc)
    own = init_params(tc, seed=0, device="cpu")
    for jg, tg, og in zip(jp["groups"], tp["groups"], own["groups"]):
        for name, leaf in jg.items():
            want = torch.float32 if name in MAMBA_LEAVES else torch.bfloat16
            assert str(leaf.dtype) == str(want).split(".")[1], name
            assert tg[name].dtype == og[name].dtype == want, name
            np.testing.assert_array_equal(_np(tg[name]), _np(leaf))
        for name in MAMBA_LEAVES:     # A_log: linspace rounds apart
            np.testing.assert_allclose(_np(og[name]), _np(tg[name]),
                                       rtol=1e-6, atol=0, err_msg=name)
    assert tp["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="neither float32"):
        params_from_numpy(tc.with_(param_dtype="float32"),
                          jax.tree.map(np.asarray, jp), "cpu")


def _to_torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32 if a.dtype != np.int32 else np.int32)),
        tree)


def test_executor_joins_and_steps_match_the_jax_executor():
    """Same weights, same prompt tokens, same script of joins (including a
    padded bucket), steps and a slot release: tok/pos agree exactly, the
    conv and state slab within the model-logit tolerance."""
    fn = "gen"
    jcfg, tcfg = _mamba2(**F32)
    P, G = 20, 3
    jex = ContinuousJaxExecutor({fn: JServed(jcfg, prompt_len=P, gen_len=G)},
                                max_batch=4)
    tex = ContinuousTorchExecutor({fn: ServedModel(tcfg, prompt_len=P,
                                                   gen_len=G)},
                                  max_batch=4, device="cpu")
    js, ts = jex._ensure(fn), tex._ensure(fn)
    ts.params = params_from_numpy(tcfg, jax.tree.map(np.asarray, js.params),
                                  "cpu")
    ts.slab = _to_torch_tree(js.slab)
    ts.tok = torch.from_numpy(np.array(js.tok))
    ts.pos = torch.from_numpy(np.array(js.pos))

    def j_join(slots, toks):
        b, ids = jex._pad_slots(slots)
        t = jnp.asarray(toks, jnp.int32)
        if b > len(slots):
            t = jnp.concatenate([t, jnp.broadcast_to(
                t[:1], (b - len(slots),) + t.shape[1:])])
        js.slab, js.tok, js.pos = js.join_fns[b](js.params, js.slab, js.tok,
                                                 js.pos, t, ids)

    def j_step(slots):
        b, ids = jex._pad_slots(slots)
        js.slab, js.tok, js.pos = js.step_fns[b](js.params, js.slab, js.tok,
                                                 js.pos, ids)

    rng = np.random.default_rng(5)
    script = [("join", [0, 1]), ("step", [0, 1]), ("join", [2]),
              ("step", [0, 1, 2]), ("release", [1]), ("join", [1, 3]),
              ("step", [0, 1, 2, 3]), ("step", [0, 2, 3])]
    for op, slots in script:
        if op == "join":
            toks = rng.integers(0, jcfg.vocab_size, (len(slots), P))
            j_join(slots, toks)
            tex._admit_tokens(fn, toks, slots)
        elif op == "step":
            j_step(slots)
            tex.step(fn, slots)
        else:
            jex.release_slots(fn, slots)
            tex.release_slots(fn, slots)
        np.testing.assert_array_equal(ts.tok.numpy(), np.asarray(js.tok))
        np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
        for e, je in zip(ts.slab["layers"], js.slab["layers"]):
            for k in ("conv", "state"):
                np.testing.assert_allclose(e[k].numpy(), np.asarray(je[k]),
                                           **TOL)
    assert tex.n_admits == 3 and tex.n_steps == 4
    assert tex.logits_finite(fn)


def test_serve_on_cpu_answers_every_request():
    cfg = get_config("mamba2-370m", reduced=True).with_(**F32)
    rep = serve(cfg, n_requests=5, rps=None, prompt_len=24, gen_len=3,
                max_batch=4, device="cpu", seed=1)
    assert rep["completed"] == rep["n_requests"] == 5
    assert all(len(t) == 4 and all(0 <= x < cfg.vocab_padded for x in t)
               for t in rep["tokens"])
    assert rep["logits_finite"]
    assert rep["kernel_launches"] == {k: 0 for k in ops.KERNEL_TABLE}
    assert rep["batcher"]["n_joins"] == 5


def test_init_cache_matches_the_jax_layout():
    jc, tc = _mamba2()
    want = j_init_cache(jc, 3, 50)
    got = init_cache(tc, 3, 50, "cpu")
    for a, b in zip(_cache_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[1] == str(b.dtype)
        assert not a.any()
