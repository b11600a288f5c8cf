"""Training in the port against the JAX package, on the CPU: the substrate
cases of tests/test_train_substrate.py run on the port; the data stream bit
for bit; the schedules and ``adamw_update`` on the same numbers; ``lm_loss``
and its gradients on bridged weights for five reduced architectures; a
three-step trajectory; remat; the kernels' autograd Functions (gradcheck in
float64 with the plain version as the forward); checkpoints cross-loading
both ways; and ``launch.train``.  Float32 unless stated; the same numpy
inputs go to both packages."""
import importlib
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import train as jtrain  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import (lm_loss, params_from_numpy,  # noqa: E402
                                transformer)
from repro_torch.train import (DataConfig, Prefetcher,  # noqa: E402
                               SyntheticLM, adamw_init, adamw_update,
                               checkpoint, cosine_schedule, make_schedule,
                               make_train_step, wsd_schedule)
from repro_torch.train.tree import leaves, leaves_with_paths  # noqa: E402

# the wrapper modules (``repro_torch.kernels`` exports the functions under
# the same names)
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan")
F32 = dict(compute_dtype="float32", param_dtype="float32")
S = 40          # no multiple of the reduced SSM chunk (16): the scan pads
LOSS_RTOL = 2e-4            # as the logits are held (tests/test_torch_zoo.py)
# each leaf's gradient against JAX's, relative to that leaf's max |g|: f32
# sums in other orders through a few layers of a reduced model
GRAD_TOL = 2e-4
OPT_TOL = dict(rtol=1e-6, atol=1e-7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_paths(tree):
    """JAX leaves keyed as the checkpoints key them."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_paths(tree):
    return {"/".join(path): t for path, t in leaves_with_paths(tree)}


# ---------------------------------------------------------------------------
# tests/test_train_substrate.py's cases, on the port
# ---------------------------------------------------------------------------


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    loss = lambda p: torch.sum(p["w"] ** 2)  # noqa: E731
    for _ in range(300):
        w = params["w"].detach().requires_grad_(True)
        grads = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, opt = adamw_update(grads, opt, params,
                                   lr=torch.tensor(0.05), weight_decay=0.0)
    assert float(loss(params)) < 1e-3
    assert int(opt.step) == 300


def test_adamw_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    huge = {"w": torch.full((4,), 1e9)}
    p2, _ = adamw_update(huge, opt, params, lr=torch.tensor(0.1),
                         weight_decay=0.0, grad_clip=1.0)
    # first-step Adam update magnitude is ~lr regardless of raw grad size
    assert float(p2["w"].abs().max()) < 0.2


def test_wsd_schedule_shape():
    s = wsd_schedule(peak_lr=1.0, warmup=10, stable=80, decay=10)
    xs = [float(s(torch.tensor(i, dtype=torch.int32))) for i in range(105)]
    assert xs[0] == 0.0
    assert xs[10] == pytest.approx(1.0)
    assert all(x == pytest.approx(1.0) for x in xs[10:90])   # plateau
    assert xs[100] < 0.2                                     # decayed
    assert xs[95] > xs[100]                                  # monotone decay


def test_cosine_schedule_endpoints():
    s = cosine_schedule(peak_lr=2.0, warmup=5, total=100, floor_frac=0.1)
    assert float(s(torch.tensor(5, dtype=torch.int32))) == pytest.approx(2.0)
    assert float(s(torch.tensor(100, dtype=torch.int32))) == \
        pytest.approx(0.2, rel=1e-3)


def test_synthetic_data_deterministic_and_in_range():
    cfg = DataConfig(vocab_size=1000, seq_len=64, batch_size=4, seed=3)
    d1, d2 = SyntheticLM(cfg), SyntheticLM(cfg)
    b1, b2 = d1.batch(7), d2.batch(7)
    np.testing.assert_array_equal(b1, b2)       # seekable + deterministic
    assert b1.shape == (4, 64)
    assert b1.min() >= 0 and b1.max() < 1000
    assert not np.array_equal(d1.batch(7), d1.batch(8))


def test_synthetic_data_has_bigram_structure():
    """Markov structure => bigram-conditional entropy < unigram entropy."""
    cfg = DataConfig(vocab_size=200, seq_len=512, batch_size=8, seed=0)
    data = SyntheticLM(cfg)
    batch, succ = data.batch(0), data.successors
    hits = sum(int(b in succ[a]) for row in batch
               for a, b in zip(row[:-1], row[1:]))
    assert hits / (batch.shape[0] * (batch.shape[1] - 1)) > 0.5


def test_prefetcher_preserves_order():
    cfg = DataConfig(vocab_size=100, seq_len=16, batch_size=2)
    data = SyntheticLM(cfg)
    pf = Prefetcher(data.iterate())
    got = [next(pf) for _ in range(5)]
    pf.close()
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, data.batch(i))


def test_checkpoint_roundtrip():
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nested": {"b": torch.ones(4, dtype=torch.bfloat16)}}
    opt = adamw_init(params)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 42, params, opt)
        assert checkpoint.latest_step(d) == 42
        p2, o2 = checkpoint.restore(d, 42, params, opt)
        for a, b in zip(leaves(params), leaves(p2)):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
        assert int(o2.step) == int(opt.step)


def test_checkpoint_shape_mismatch_rejected():
    params = {"a": torch.zeros((2, 3))}
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, params)
        with pytest.raises(ValueError):
            checkpoint.restore(d, 1, {"a": torch.zeros((3, 2))})


# ---------------------------------------------------------------------------
# the same numbers as the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab", [(0, 1000), (3, 122753), (11, 50)])
def test_synthetic_batches_equal_the_jax_packages(seed, vocab):
    cfg = dict(vocab_size=vocab, seq_len=33, batch_size=3, seed=seed)
    mine, ref = SyntheticLM(DataConfig(**cfg)), \
        jtrain.SyntheticLM(jtrain.DataConfig(**cfg))
    np.testing.assert_array_equal(mine.successors, ref.successors)
    for step in (0, 1, 17):
        b = mine.batch(step)
        assert b.dtype == np.int32
        np.testing.assert_array_equal(b, ref.batch(step))


@pytest.mark.parametrize("kind,args", [
    ("wsd", (3e-4, 10, 80, 10)), ("wsd", (1.0, 1, 6, 1, 0.2)),
    ("cosine", (2.0, 5, 100)), ("cosine", (1e-3, 1, 8, 0.05)),
    ("make_wsd", ("wsd", 1e-3, 8)), ("make_cosine", ("cosine", 3e-4, 300))])
def test_schedules_equal_the_jax_packages(kind, args):
    mine = {"wsd": wsd_schedule, "cosine": cosine_schedule}.get(
        kind, make_schedule)(*args)
    ref = {"wsd": jtrain.wsd_schedule, "cosine": jtrain.cosine_schedule}.get(
        kind, jtrain.make_schedule)(*args)
    n = 110 if kind.endswith("wsd") else 310
    got = np.array([float(mine(torch.tensor(i, dtype=torch.int32)))
                    for i in range(n)], np.float32)
    want = np.array([float(ref(jnp.int32(i))) for i in range(n)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _opt_case(rng, dtype, big):
    """Params, gradients and a step-5 state as numpy, the same for both."""
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}

    def draw(tree, scale):
        if isinstance(tree, dict):
            return {k: draw(v, scale) for k, v in tree.items()}
        return (rng.standard_normal(tree) * scale).astype(np.float32)

    p, g = draw(shapes, 0.5), draw(shapes, 1e3 if big else 1e-2)
    mu, nu = draw(shapes, 1e-2), draw(shapes, 1e-2)
    nu = jax.tree.map(np.abs, nu)
    if dtype == "bfloat16":     # values a bf16 parameter can hold
        p = jax.tree.map(lambda a: np.asarray(
            jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), p)
    return p, g, mu, nu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("big", [False, True], ids=["unclipped", "clipped"])
def test_adamw_update_equals_the_jax_packages(dtype, big):
    rng = np.random.default_rng(7)
    p, g, mu, nu = _opt_case(rng, dtype, big)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    j_state = jtrain.AdamWState(step=jnp.int32(5),
                                mu=jax.tree.map(jnp.asarray, mu),
                                nu=jax.tree.map(jnp.asarray, nu))
    jp, js = jtrain.adamw_update(jax.tree.map(jnp.asarray, g), j_state,
                                 jax.tree.map(lambda a: jnp.asarray(a, jd),
                                              p),
                                 lr=jnp.float32(3e-3))
    to_t = lambda tree, d: jax.tree.map(  # noqa: E731
        lambda a: torch.from_numpy(np.array(a)).to(d), tree)
    t_state = ttrain.AdamWState(step=torch.tensor(5, dtype=torch.int32),
                                mu=to_t(mu, torch.float32),
                                nu=to_t(nu, torch.float32))
    tp, ts = adamw_update(to_t(g, torch.float32), t_state,
                          to_t(p, td), lr=torch.tensor(3e-3))
    assert int(ts.step) == int(js.step) == 6
    for name, mine, ref in (("p", tp, jp), ("mu", ts.mu, js.mu),
                            ("nu", ts.nu, js.nu)):
        mine, ref = _torch_paths(mine), _jax_paths(ref)
        assert set(mine) == set(ref)
        for key in mine:
            want = td if name == "p" else torch.float32
            assert mine[key].dtype == want, (name, key)
            np.testing.assert_allclose(_np(mine[key]), _np(ref[key]),
                                       **OPT_TOL, err_msg=f"{name} {key}")


# ---------------------------------------------------------------------------
# lm_loss and its gradients, a trajectory, remat
# ---------------------------------------------------------------------------


def _model_case(arch, seed=0):
    jc = j_get_config(arch, reduced=True).with_(**F32)
    tc = get_config(arch, reduced=True).with_(**F32)
    jp = j_init_params(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, tc.vocab_size, (2, S)).astype(np.int32)
    fe = None
    if tc.frontend:
        fe = rng.standard_normal((2, tc.n_frontend_tokens, tc.d_model)
                                 ).astype(np.float32)
    return jc, tc, jp, toks, fe


def _bridge(tc, jp):
    return params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")


def _tfe(fe):
    return None if fe is None else torch.from_numpy(fe)


def _torch_loss_and_grads(tc, params, toks, fe):
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss = lm_loss(tc, params, torch.from_numpy(toks), _tfe(fe))
    grads = torch.autograd.grad(loss, flat)
    return loss, {"/".join(p): g for (p, _), g in
                  zip(leaves_with_paths(params), grads)}


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m",
                                  "mixtral-8x22b", "zamba2-1.2b",
                                  "whisper-tiny"])
def test_lm_loss_and_its_gradients_equal_the_jax_packages(arch):
    jc, tc, jp, toks, fe = _model_case(arch)
    jfe = None if fe is None else jnp.asarray(fe)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_lm_loss(jc, p, jnp.asarray(toks), jfe)))(jp)
    loss, grads = _torch_loss_and_grads(tc, _bridge(tc, jp), toks, fe)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    j_grads = _jax_paths(j_grads)
    assert set(grads) == set(j_grads)
    for key, g in grads.items():
        want = np.asarray(j_grads[key], np.float32)
        scale = np.abs(want).max()
        assert scale > 0, key
        err = np.abs(_np(g) - want).max() / scale
        assert err <= GRAD_TOL, f"{arch} {key}: {err:.3g} of max |g|"


def test_moe_aux_loss_enters_the_loss():
    jc, tc, jp, toks, _ = _model_case("mixtral-8x22b")
    params = _bridge(tc, jp)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        base = lm_loss(tc, params, t, aux_weight=0.0)
        _, aux = transformer.forward(tc, params, t)
        with_aux = lm_loss(tc, params, t, aux_weight=0.5)
    assert float(aux) > 0
    np.testing.assert_allclose(float(with_aux), float(base + 0.5 * aux),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m"])
def test_three_training_steps_equal_the_jax_packages(arch):
    jc, tc, jp, toks, _ = _model_case(arch)
    data = jtrain.SyntheticLM(jtrain.DataConfig(
        vocab_size=tc.vocab_size, seq_len=S, batch_size=2))
    j_step = jax.jit(jtrain.make_train_step(jc, total_steps=3,
                                            peak_lr=1e-3))
    t_step = make_train_step(tc, total_steps=3, peak_lr=1e-3)
    j_opt, params = jtrain.adamw_init(jp), _bridge(tc, jp)
    opt = adamw_init(params)
    for step in range(3):
        batch = data.batch(step)
        jp, j_opt, j_loss = j_step(jp, j_opt, jnp.asarray(batch))
        params, opt, loss = t_step(params, opt, torch.from_numpy(batch))
        np.testing.assert_allclose(float(loss), float(j_loss),
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")
    assert int(opt.step) == int(j_opt.step) == 3


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_remat_changes_neither_loss_nor_gradients(arch, monkeypatch):
    _, tc, jp, toks, fe = _model_case(arch)
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for remat in (True, False):
        cfg = tc.with_(remat=remat)
        out[remat] = _torch_loss_and_grads(cfg, _bridge(cfg, jp), toks, fe)
    n_layers = sum(g.count for g in tc.groups())
    assert len(calls) == n_layers          # one checkpoint a layer, remat on
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-6,
                               atol=0)
    for key, g in out[True][1].items():
        torch.testing.assert_close(g, out[False][1][key], rtol=1e-6,
                                   atol=1e-9, msg=key)


def test_serving_runs_no_checkpoint_without_a_gradient(monkeypatch):
    _, tc, jp, toks, _ = _model_case("mamba2-370m")
    params = _bridge(tc, jp)
    assert tc.remat and torch.is_grad_enabled()

    def refuse(*a, **k):
        raise AssertionError("checkpoint on a path with no gradient")

    monkeypatch.setattr(transformer, "checkpoint", refuse)
    logits, _ = transformer.forward(tc, params, torch.from_numpy(toks))
    assert logits.grad_fn is None


def test_a_leaf_without_a_gradient_raises(monkeypatch):
    """A kernel whose output carries no gradient leaves the weights in
    front of it untrained without an error; the train step refuses."""
    _, tc, jp, toks, _ = _model_case("minicpm-2b")
    params = _bridge(tc, jp)
    plain = ops.attention
    monkeypatch.setattr(ops, "attention",
                        lambda *a, **k: plain(*a, **k).detach())
    step = make_train_step(tc, total_steps=3)
    with pytest.raises(RuntimeError, match="groups/0/wq"):
        step(params, adamw_init(params), torch.from_numpy(toks))


# ---------------------------------------------------------------------------
# the kernels' autograd Functions, with the plain version as the forward
# ---------------------------------------------------------------------------


def _f64(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape))


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, Hq, Hkv, hd, causal, window, grads of q, k, v)
    (1, 6, 6, 2, 2, 4, True, 0, (True, True, True)),
    (1, 7, 7, 2, 2, 4, True, 3, (True, True, True)),
    (2, 3, 5, 2, 2, 4, False, 0, (True, True, True)),     # cross
    (1, 5, 5, 4, 2, 4, True, 0, (True, True, True)),      # GQA
    (1, 5, 5, 4, 2, 4, True, 0, (True, False, False))])
def test_flash_attention_function_gradcheck(case):
    B, Sq, Sk, Hq, Hkv, hd, causal, window, need = case
    rng = np.random.default_rng(0)
    q, k, v = (_f64(rng, B, Sq, Hq, hd), _f64(rng, B, Sk, Hkv, hd),
               _f64(rng, B, Sk, Hkv, hd))
    for t, n in zip((q, k, v), need):
        t.requires_grad_(n)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa_mod.FlashAttentionFn.apply(
            q, k, v, causal, window, fa_mod.flash_attention_plain),
        (q, k, v))


def _ssd_inputs(rng, B, S, H, P, N, init):
    x = _f64(rng, B, S, H, P)
    dt = torch.nn.functional.softplus(_f64(rng, B, S, H))
    A = -torch.exp(0.5 * _f64(rng, H))
    Bm, Cm = _f64(rng, B, S, N), _f64(rng, B, S, N)
    s0 = _f64(rng, B, H, P, N) if init else None
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("S,init", [(8, False), (7, False), (6, True)])
def test_ssd_scan_function_gradcheck(S, init):
    rng = np.random.default_rng(1)
    inputs = _ssd_inputs(rng, 1, S, 2, 2, 3, init)
    for t in inputs:
        if t is not None:
            t.requires_grad_(True)

    def fn(x, dt, A, Bm, Cm, s0):
        return ssd_mod.SSDScanFn.apply(x, dt, A, Bm, Cm, s0, 4,
                                       ssd_mod.ssd_scan_plain)

    if init:
        assert torch.autograd.gradcheck(fn, inputs)
    else:
        assert torch.autograd.gradcheck(lambda *a: fn(*a, None), inputs[:5])


def test_ssd_scan_function_takes_no_gradient_of_the_final_state():
    """Training discards the final state: its gradient arrives as None, and
    the backward gives the same gradients as autograd through the plain
    version of ``y`` alone."""
    rng = np.random.default_rng(2)
    inputs = _ssd_inputs(rng, 2, 10, 2, 2, 3, False)[:5]
    w = _f64(rng, 2, 10, 2, 2)
    got = {}
    for name in ("function", "plain"):
        xs = [t.detach().requires_grad_(True) for t in inputs]
        if name == "function":
            y, _ = ssd_mod.SSDScanFn.apply(*xs, None, 4,
                                           ssd_mod.ssd_scan_plain)
        else:
            y, _ = ssd_mod.ssd_scan_plain(*xs, chunk=4)
        got[name] = torch.autograd.grad((y * w).sum(), xs)
    for a, b in zip(got["function"], got["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kernel", ["flash", "ssd"])
def test_wrappers_take_the_function_only_to_carry_a_gradient(kernel,
                                                             monkeypatch):
    """On a tensor off the plain devices (meta here, dropped from
    ``PLAIN_DEVICES``, for CUDA) the wrapper launches directly when no input
    requires a gradient (serving) and through the kernel's Function
    otherwise; each launch counts once."""
    calls = []
    if kernel == "flash":
        mod = fa_mod

        def launch(q, k, v, *, causal, window):
            calls.append(1)
            return torch.empty_like(q)

        args = [torch.empty(1, 4, 2, 64, device="meta") for _ in range(3)]
        run = lambda a: fa_mod.flash_attention(*a)  # noqa: E731
        fn_name = "FlashAttentionFnBackward"
    else:
        mod = ssd_mod

        def launch(x, dt, A, Bm, Cm, *, chunk, init_state):
            calls.append(1)
            return torch.empty_like(x), torch.empty(1, 2, 32, 16,
                                                    device="meta")

        args = [torch.empty(*s, device="meta") for s in
                ((1, 8, 2, 32), (1, 8, 2), (2,), (1, 8, 16), (1, 8, 16))]
        run = lambda a: ssd_mod.ssd_scan(*a, chunk=16)[0]  # noqa: E731
        fn_name = "SSDScanFnBackward"
    monkeypatch.setattr(mod, "_launch", launch)
    monkeypatch.setattr(mod, "PLAIN_DEVICES", ("cpu",))
    assert run(args).grad_fn is None
    with torch.no_grad():
        assert run([a.requires_grad_(True) for a in args]).grad_fn is None
    out = run(args)
    assert type(out.grad_fn).__name__.startswith(fn_name)
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# checkpoints cross-load
# ---------------------------------------------------------------------------


def _ckpt_trees(rng):
    """A bf16 model's params (its f32 Mamba leaves too) and a trained-looking
    optimizer state, as numpy trees."""
    jc = j_get_config("zamba2-1.2b", reduced=True)
    jp = jax.tree.map(np.asarray, j_init_params(jc, jax.random.PRNGKey(3)))
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                      .astype(np.float32), jp)
    nu = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape))
                      .astype(np.float32), jp)
    return jc, jp, mu, nu


def _dtype_of(arr):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        np.asarray(arr).dtype.name]


def test_a_jax_checkpoint_restores_in_the_port():
    jc, jp, mu, nu = _ckpt_trees(np.random.default_rng(4))
    j_opt = jtrain.AdamWState(step=jnp.int32(17),
                              mu=jax.tree.map(jnp.asarray, mu),
                              nu=jax.tree.map(jnp.asarray, nu))
    tc = get_config("zamba2-1.2b", reduced=True)
    like = transformer.init_params(tc, seed=9, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        jtrain.checkpoint.save(d, 17, jax.tree.map(jnp.asarray, jp), j_opt)
        assert checkpoint.latest_step(d) == 17
        p, o = checkpoint.restore(d, 17, like, adamw_init(like))
    assert o.step.dtype == torch.int32 and int(o.step) == 17
    for mine, ref in ((p, jp), (o.mu, mu), (o.nu, nu)):
        mine, ref = _torch_paths(mine), _jax_paths(ref)
        assert set(mine) == set(ref)
        for key, t in mine.items():
            assert t.dtype == _dtype_of(ref[key]), key
            np.testing.assert_array_equal(_np(t), _np(ref[key]), key)


def test_a_port_checkpoint_restores_in_jax():
    jc, jp, mu, nu = _ckpt_trees(np.random.default_rng(5))
    tc = get_config("zamba2-1.2b", reduced=True)
    params = params_from_numpy(tc, jp, "cpu")
    opt = ttrain.AdamWState(
        step=torch.tensor(23, dtype=torch.int32),
        mu=params_from_numpy(tc.with_(param_dtype="float32"), mu, "cpu"),
        nu=params_from_numpy(tc.with_(param_dtype="float32"), nu, "cpu"))
    j_like = j_init_params(jc, jax.random.PRNGKey(0))
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 23, params, opt)
        assert jtrain.checkpoint.latest_step(d) == 23
        p, o = jtrain.checkpoint.restore(d, 23, j_like,
                                         jtrain.adamw_init(j_like))
    assert int(o.step) == 23
    for mine, ref in ((params, p), (opt.mu, o.mu), (opt.nu, o.nu)):
        mine, ref = _torch_paths(mine), _jax_paths(ref)
        assert set(mine) == set(ref)
        for key, t in mine.items():
            assert _dtype_of(ref[key]) == t.dtype, key
            np.testing.assert_array_equal(_np(t), _np(ref[key]), key)


def test_a_jax_checkpoint_of_another_shape_is_refused():
    with tempfile.TemporaryDirectory() as d:
        jtrain.checkpoint.save(d, 1, {"a": jnp.zeros((2, 3))})
        with pytest.raises(ValueError, match="p/a"):
            checkpoint.restore(d, 1, {"a": torch.zeros((3, 2))})


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------


def test_launch_train_runs_on_the_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        launch_train.main(["--arch", "mamba2-370m", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--device", "cpu",
                           "--ckpt", d, "--ckpt-every", "2"])
        assert checkpoint.latest_step(d) == 2
        assert os.path.exists(os.path.join(d, "step_00000002.npz"))
    out = capsys.readouterr().out
    assert "step    1 loss" in out and "tokens/s" in out
    assert "[train] done" in out


def test_launch_train_refuses_to_fall_back_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "mamba2-370m", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.Trainer(get_config("mamba2-370m", reduced=True),
                             steps=1, batch=1, seq=16, lr=1e-3)
