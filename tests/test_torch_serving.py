"""The port's serving seam against the JAX package's: the batch seed, the
continuous executor's joins and steps, the continuous batcher on the event
engine, and the serve launcher on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import ContinuousBatcher as JBatcher  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.serving.executor import ContinuousJaxExecutor  # noqa: E402
from repro.serving.executor import ServedModel as JServed  # noqa: E402
from repro.serving.executor import batch_seed as j_batch_seed  # noqa: E402
from repro.sim.engine import SimEnv as JSimEnv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ContinuousBatcher  # noqa: E402
from repro_torch.core import types  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousTorchExecutor,  # noqa: E402
                                 ServedModel, batch_seed)
from repro_torch.sim import SimEnv  # noqa: E402

F32 = dict(compute_dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("ids", [[0], [3, 1, 2], [7, 7, 1 << 40],
                                 list(range(100))])
def test_batch_seed_equals_jax(ids):
    assert batch_seed(ids) == j_batch_seed(ids)
    assert batch_seed(reversed(ids)) == batch_seed(ids)


def _to_torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32 if a.dtype != np.int32 else np.int32)),
        tree)


def test_executor_joins_and_steps_match_the_jax_executor():
    """Same weights, same prompt tokens, same script of joins (including a
    padded bucket), steps and a slot release: tok/pos agree exactly, the
    KV slab within the model-logit tolerance."""
    fn = "gen"
    jcfg = j_get_config("minicpm-2b", reduced=True).with_(**F32)
    tcfg = get_config("minicpm-2b", reduced=True).with_(**F32)
    P, G = 8, 3
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

    rng = np.random.default_rng(0)
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
            for k in ("k", "v"):
                np.testing.assert_allclose(e[k].numpy(), np.asarray(je[k]),
                                           rtol=2e-4, atol=2e-4)
    assert tex.n_admits == 3 and tex.n_steps == 4
    assert tex.logits_finite(fn)


def _drive(env_cls, batcher_cls, tmod):
    """A scripted data plane under the batcher: arrivals at several
    instants, a mid-flight drop, slot reuse.  Returns what happened, with
    invocations named by their creation index."""
    env = env_cls()
    trace, done = [], []
    dag = tmod.DagSpec("d", (tmod.FunctionSpec("f", 0.1),))
    invs = [tmod.Invocation(request=tmod.Request(dag=dag, arrival_time=0.0),
                            fn=dag.fn("f"), ready_time=0.0)
            for _ in range(7)]
    name = {inv.inv_id: i for i, inv in enumerate(invs)}

    def admit(fn, joiners, slots):
        trace.append(("admit", [name[i.inv_id] for i in joiners], slots))
        return 0.04 + 0.01 * len(slots)

    def step(fn, slots):
        trace.append(("step", list(slots)))
        return 0.01

    released = []
    b = batcher_cls(env, admit, step, lambda fn: 3, max_batch=3,
                    release=lambda fn, s: released.append(list(s)))
    arrivals = [0.0, 0.0, 0.0, 0.02, 0.05, 0.05, 0.3]
    for inv, t in zip(invs, arrivals):
        env.call_at(t, b.submit, inv,
                    lambda s, i=name[inv.inv_id]: done.append(
                        (i, round(env.now(), 9), round(s, 9))))
    env.call_at(0.045, b.drop, [invs[1].inv_id])
    env.run()
    return trace, done, released, b.counters()


def test_batcher_matches_the_jax_batcher():
    got = _drive(SimEnv, ContinuousBatcher, types)
    want = _drive(JSimEnv, JBatcher, jtypes)
    assert got == want
    trace, done, released, counters = got
    assert counters["n_dropped_invocations"] == 1 and released == [[1]]
    assert sorted(i for i, _, _ in done) == [0, 2, 3, 4, 5, 6]


def test_serve_on_cpu_answers_every_request():
    cfg = get_config("minicpm-2b", reduced=True).with_(**F32)
    rep = serve(cfg, n_requests=5, rps=None, prompt_len=8, gen_len=3,
                max_batch=4, device="cpu", seed=1)
    assert rep["completed"] == rep["n_requests"] == 5
    assert all(len(t) == 4 and all(0 <= x < cfg.vocab_padded for x in t)
               for t in rep["tokens"])
    assert rep["logits_finite"]
    assert rep["device_name"] == "cpu"
    assert rep["kernel_launches"] == {"attention": 0, "decode_attention": 0,
                                      "ssd": 0}
    bc = rep["batcher"]
    assert bc["n_joins"] == 5 and bc["n_decode_ticks"] > 0
    assert rep["latency_p50_s"] > 0 and rep["latency_p99_s"] \
        >= rep["latency_p50_s"]
    assert 0 < rep["ttft_p50_s"] <= rep["ttft_p99_s"] \
        <= rep["latency_p99_s"]
    assert 0 < rep["token_gap_p50_s"] <= rep["token_gap_p99_s"]
    assert set(rep["bucket_admit_ms"]) == {1, 2, 4}


# -- what the timed regions hold ---------------------------------------------

HOUR = 3600.0


@pytest.fixture
def clock(monkeypatch):
    """The executors' clock, advanced by an hour wherever a test says so:
    an hour seen in a measured time is the marked work inside its timed
    region."""
    from repro_torch.serving import executor as texec
    skew = [0.0]
    real = texec.time.perf_counter

    class Clock:
        @staticmethod
        def perf_counter():
            return real() + skew[0]

    monkeypatch.setattr(texec, "time", Clock)

    def advance_in(fn):
        def wrapped(*a, **kw):
            skew[0] += HOUR
            return fn(*a, **kw)
        return wrapped

    return texec, advance_in


def _served(texec):
    cfg = get_config("mamba2-370m", reduced=True).with_(**F32)
    return {"gen": texec.ServedModel(cfg, prompt_len=4, gen_len=1)}


def test_a_run_or_a_join_times_its_prompt_draw(clock, monkeypatch):
    """As in the JAX package, the prompt's draw (and its copy to the
    device) falls inside the timed region of ``ModelInstance.run``, a
    windowed batch and a continuous join."""
    texec, advance_in = clock
    monkeypatch.setattr(texec, "prompt_tokens",
                        advance_in(texec.prompt_tokens))
    ex = texec.TorchModelExecutor(_served(texec), device="cpu")
    inst = ex.ensure_instance("gen")
    assert inst.setup_seconds < HOUR
    assert inst.run(seed=1) >= HOUR
    assert inst.run_tokens(np.zeros((1, 4), np.int64)) < HOUR
    bex = texec.BatchingTorchExecutor(_served(texec), max_batch=2,
                                      device="cpu")
    inv = types.Invocation(request=types.Request(
        dag=types.DagSpec("d", (types.FunctionSpec("gen", 0.1),)),
        arrival_time=0.0), fn=types.FunctionSpec("gen", 0.1), ready_time=0.0)
    assert bex.run_batch("gen", [inv]) >= HOUR
    cex = texec.ContinuousTorchExecutor(_served(texec), max_batch=2,
                                        device="cpu")
    assert cex.admit("gen", [inv], [0]) >= HOUR
    assert cex._admit_tokens("gen", np.zeros((1, 4), np.int64), [1]) < HOUR
    assert cex.step("gen", [0, 1]) < HOUR


def test_the_kernel_build_is_never_a_sandbox_set_up(clock, monkeypatch):
    """The executors build the kernels before a sandbox's set-up clock
    starts: the build counts in ``build_seconds``, never in
    ``setup_seconds`` (the modeled cold start)."""
    texec, advance_in = clock
    monkeypatch.setattr(texec, "build_kernels",
                        advance_in(lambda device: HOUR))
    ex = texec.TorchModelExecutor(_served(texec), device="cpu")
    bex = texec.BatchingTorchExecutor(_served(texec), max_batch=2,
                                      device="cpu")
    cex = texec.ContinuousTorchExecutor(_served(texec), max_batch=2,
                                        device="cpu")
    specs = [e.calibrate(runs=1)["gen"] for e in (ex, bex, cex)]
    for e, spec in zip((ex, bex, cex), specs):
        assert e.build_seconds >= HOUR
        assert spec.setup_time < HOUR and spec.exec_time < HOUR
    assert all(i.setup_seconds < HOUR for i in bex._instances.values())


def test_finiteness_is_noted_after_the_clock_stops(clock, monkeypatch):
    """The continuous executor's ``isfinite`` bookkeeping runs after a
    join's or step's clock stops, on the logits kept for it, and
    ``logits_finite`` keeps its meaning."""
    texec, advance_in = clock
    cls = texec.ContinuousTorchExecutor
    monkeypatch.setattr(cls, "_note_finite", advance_in(cls._note_finite))
    cex = cls(_served(texec), max_batch=2, device="cpu")
    assert cex._admit_seeded("gen", [3], [0]) < HOUR
    assert cex.step("gen", [0]) < HOUR
    st = cex._state["gen"]
    assert st.logits is None and cex.logits_finite("gen")
    st.params["embed"][:] = float("nan")
    cex.step("gen", [0])
    assert not cex.logits_finite("gen")
