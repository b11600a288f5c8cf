"""The serving executors' compiled programs (``repro_torch.serving.graphs``)
on the CPU.

* Capture safety: every join and step body of the continuous executor and
  every prefill and decode body of ``ModelInstance``, for each reduced
  config the executor serves, runs under a dispatch mode that refuses what
  a CUDA graph cannot hold: a sync with the host (``.item()``, a Python
  ``if`` on a tensor), an op whose output shape depends on the data, and a
  tensor made from host data inside the body.
* Launch accounting, with counting stand-ins for the three kernel wrappers
  and a stand-in for the CUDA graph: capture leaves the counters as they
  were, each replay adds the captured count, a failing capture raises out
  of set-up, and set-up's clock holds the capture.
* Replays through the static buffers equal the bodies run directly, and
  the continuous executor's joins and steps in a mixed bucket order match
  a fresh ``ContinuousJaxExecutor`` with the same weights and prompts.

The card's own checks (a real capture and replay against the eager body)
are the ``cuda``-marked tests of ``tests/test_torch_cuda.py`` and phase 6
of ``chip_smoke.py``.
"""
import gc
import traceback
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.serving.executor import ContinuousJaxExecutor  # noqa: E402
from repro.serving.executor import ServedModel as JServed  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import executor as texec  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402

F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = dict(rtol=2e-4, atol=2e-4)     # model logits, as test_kernel_dispatch
HOUR = 3600.0

# aten ops a captured body must not reach: syncs with the host, outputs
# shaped by the data, and tensors lifted from host data
REFUSED = {"_local_scalar_dense", "item", "is_nonzero", "equal", "nonzero",
           "masked_select", "bincount", "lift", "lift_fresh",
           "lift_fresh_copy"}


class RefuseHostSync(TorchDispatchMode):
    """Raise on an op that a CUDA graph cannot capture (``REFUSED``, every
    ``unique``, and indexing by a boolean mask), naming the line of the
    port that called it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[1]
        masked = name == "index" and any(
            t is not None and t.dtype == torch.bool for t in args[1])
        if name in REFUSED or "unique" in name or masked:
            where = [f"{f.filename.split('src/')[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()
                     if "repro_torch" in f.filename]
            raise AssertionError(f"{func} in a captured body, at "
                                 f"{where[-1] if where else '?'}")
        return func(*args, **(kwargs or {}))


def _served(arch, **kw):
    cfg = get_config(arch, reduced=True).with_(**kw)
    return {"gen": texec.ServedModel(cfg, prompt_len=8, gen_len=2)}


CONTINUOUS = [a for a in ARCH_IDS
              if not get_config(a, reduced=True).frontend
              and get_config(a, reduced=True).arch_type != "encdec"]


def test_the_refusing_mode_refuses():
    x = torch.ones(3)
    for bad in (lambda: x.sum().item(), lambda: bool(x.any()),
                lambda: torch.tensor(2.0), lambda: x[x > 0],
                lambda: torch.nonzero(x), lambda: torch.unique(x)):
        with pytest.raises(AssertionError, match="captured body"):
            with RefuseHostSync():
                bad()
    with RefuseHostSync():
        torch.full((), 2.0) * x[torch.arange(2)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_instance_bodies_can_be_captured(arch):
    inst = texec.TorchModelExecutor(_served(arch),
                                    device="cpu").ensure_instance("gen")
    for prog in (inst.prefill_fn, inst.decode_fn):
        with RefuseHostSync():
            prog.body(**prog.inputs)


@pytest.mark.parametrize("arch", CONTINUOUS)
def test_continuous_join_and_step_bodies_can_be_captured(arch):
    ex = texec.ContinuousTorchExecutor(_served(arch), max_batch=2,
                                       device="cpu")
    st = ex._ensure("gen")
    assert sorted(st.joins) == sorted(st.steps) == [1, 2]
    for prog in st.programs.programs:
        with RefuseHostSync():
            prog.body(**prog.inputs)


def test_a_dropped_executor_is_freed_without_the_cycle_collector():
    """A program's body holds its owner (an instance, a function's state)
    weakly: an executor let go of is freed at once, its weights, caches
    and, on the card, its graphs' memory with it, without waiting for the
    cycle collector."""
    served = _served("minicpm-2b")
    collecting = gc.isenabled()
    gc.disable()
    try:
        execs = [texec.ContinuousTorchExecutor(served, max_batch=2,
                                               device="cpu"),
                 texec.BatchingTorchExecutor(served, max_batch=2,
                                             device="cpu"),
                 texec.TorchModelExecutor(served, device="cpu")]
        for e in execs:
            e.calibrate(runs=1)
        refs = [weakref.ref(e) for e in execs]
        refs += [weakref.ref(execs[0]._state["gen"])]
        refs += [weakref.ref(i) for e in execs[1:]
                 for i in e._instances.values()]
        del execs, e
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        if collecting:
            gc.enable()


# -- launch accounting --------------------------------------------------------


class StandInGraph:
    """A CUDA graph's stand-in off the card: capture runs the body once
    (the counting wrappers see its launches) and keeps its outputs; a
    replay runs it again into those outputs with the counters held, as a
    real replay calls no wrapper."""

    def __init__(self, pool, stream):
        assert pool is None and stream is None      # off the card
        self.body = self.outputs = None

    def capture(self, body):
        self.body = body
        self.outputs = body()
        return self.outputs

    def replay(self):
        held = ops.launch_counts()
        self.outputs.copy_(self.body())
        ops.set_launch_counts(held)


@pytest.fixture
def counting(monkeypatch):
    """The three ``kernels.ops`` wrappers as counting stand-ins (the plain
    version, and one launch on the real wrapper's counter); the counters
    are set to 0 and given back afterwards."""
    held = ops.launch_counts()
    for name, real in ops.KERNEL_TABLE.items():
        def stand_in(*a, _real=real, **k):
            _real.launches += 1
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, stand_in)
    ops.reset_launch_counts()
    yield
    ops.set_launch_counts(held)


@pytest.fixture
def stand_in_graph(monkeypatch):
    monkeypatch.setattr(graphs, "graph_for", lambda device: StandInGraph)


def _add(a, b, n=1):
    return {k: a[k] + n * b[k] for k in a}


def test_capture_keeps_the_counters_and_each_replay_adds_its_count(
        counting, stand_in_graph):
    served = _served("minicpm-2b", **F32)
    L = served["gen"].cfg.n_layers
    join = {"attention": L, "decode_attention": 0, "ssd": 0}
    step = {"attention": 0, "decode_attention": L, "ssd": 0}
    ex = texec.ContinuousTorchExecutor(served, max_batch=4, device="cpu")
    st = ex._ensure("gen")
    # set-up: one warm-up join and step per bucket; the capture adds none
    assert ops.launch_counts() == {k: 3 * (join[k] + step[k]) for k in join}
    for b in (1, 2, 4):
        assert isinstance(st.joins[b].graph, StandInGraph)
        assert st.joins[b].launches == join
        assert st.steps[b].launches == step
    before = ops.launch_counts()
    ex._admit_seeded("gen", [0, 1, 2], [0, 1, 2])           # bucket 4
    assert ops.launch_counts() == _add(before, join)
    ex.step("gen", [0, 1, 2])
    ex.step("gen", [1])
    assert ops.launch_counts() == _add(_add(before, join), step, 2)
    assert (st.joins[4].runs, st.steps[4].runs, st.steps[1].runs) == (1, 1, 1)
    assert ex.n_executions == sum(p.runs for p in st.programs.programs) == 3

    tex = texec.TorchModelExecutor(served, device="cpu")
    ops.reset_launch_counts()
    inst = tex.ensure_instance("gen")
    assert ops.launch_counts() == _add(join, step)
    inst.run(seed=3)
    assert ops.launch_counts() == _add(_add(_add(join, step), join), step, 2)
    assert (inst.prefill_fn.runs, inst.decode_fn.runs) == (1, 2)


def test_a_failing_capture_raises_out_of_set_up(counting, monkeypatch):
    class Refusing(StandInGraph):
        def capture(self, body):
            body()
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(graphs, "graph_for", lambda device: Refusing)
    served = _served("mamba2-370m", **F32)
    ex = texec.ContinuousTorchExecutor(served, max_batch=2, device="cpu")
    with pytest.raises(RuntimeError, match="capturing"):
        ex._ensure("gen")
    assert "gen" not in ex._state
    # the warm-up's launches only: the failed capture gave its back
    L = served["gen"].cfg.n_layers
    assert ops.launch_counts() == {"attention": 0, "decode_attention": 0,
                                   "ssd": 2 * L}
    for cls in (texec.TorchModelExecutor, texec.BatchingTorchExecutor):
        with pytest.raises(RuntimeError, match="capturing"):
            cls(served, device="cpu").calibrate(runs=1)


def test_set_up_clock_holds_the_capture(counting, monkeypatch):
    """A capture that takes an hour (a skewed clock) lands in every
    executor's ``setup_seconds``, never in a run, a join or a step."""
    real = texec.time.perf_counter
    skew = [0.0]

    class Clock:
        @staticmethod
        def perf_counter():
            return real() + skew[0]

    class Slow(StandInGraph):
        def capture(self, body):
            skew[0] += HOUR
            return super().capture(body)

    monkeypatch.setattr(texec, "time", Clock)
    monkeypatch.setattr(graphs, "graph_for", lambda device: Slow)
    served = _served("mamba2-370m", **F32)
    exs = (texec.TorchModelExecutor(served, device="cpu"),
           texec.BatchingTorchExecutor(served, max_batch=2, device="cpu"),
           texec.ContinuousTorchExecutor(served, max_batch=2, device="cpu"))
    for e in exs:
        spec = e.calibrate(runs=1)["gen"]
        assert spec.setup_time >= HOUR and spec.exec_time < HOUR
    assert all(i.setup_seconds >= HOUR for i in exs[1]._instances.values())
    assert exs[2]._state["gen"].setup_seconds >= 4 * HOUR   # 2 buckets x 2
    assert exs[2].step("gen", [0, 1]) < HOUR


# -- replays against the bodies, and against JAX ------------------------------


def test_replays_through_the_static_buffers_equal_the_bodies(
        counting, monkeypatch):
    """The same script of joins (padded buckets too) and steps on two
    continuous executors, one replaying stand-in graphs through the staged
    static buffers and one running its bodies: the same slab, tokens,
    positions and logits, bit for bit; and the same for ``ModelInstance``'s
    greedy tokens."""
    served = _served("gemma3-1b", **F32)
    plain = texec.ContinuousTorchExecutor(served, max_batch=8, device="cpu")
    plain._ensure("gen")
    monkeypatch.setattr(graphs, "graph_for", lambda device: StandInGraph)
    replayed = texec.ContinuousTorchExecutor(served, max_batch=8,
                                             device="cpu")
    rs = replayed._ensure("gen")
    ps = plain._state["gen"]
    rng = np.random.default_rng(2)
    for op, slots in (("join", [0, 1, 2, 3, 4, 5, 6]), ("step", [0, 3, 6]),
                      ("join", [7]), ("step", list(range(8))),
                      ("join", [1, 2]), ("step", [1, 2, 7])):
        if op == "join":
            toks = rng.integers(0, served["gen"].cfg.vocab_size,
                                (len(slots), 8))
            got = [e._admit_tokens("gen", toks, slots) for e in
                   (plain, replayed)]
        else:
            got = [e.step("gen", slots) for e in (plain, replayed)]
        assert all(g > 0 for g in got)
        b = 1 << (len(slots) - 1).bit_length()
        kind = "joins" if op == "join" else "steps"
        mine, theirs = getattr(rs, kind)[b], getattr(ps, kind)[b]
        assert mine.graph is not None and theirs.graph is None
        assert torch.equal(mine.outputs, theirs.outputs)
        for a, c in ((ps.tok, rs.tok), (ps.pos, rs.pos)):
            assert torch.equal(a, c)
        for pe, re in zip(ps.slab["layers"], rs.slab["layers"]):
            for k in pe:
                assert torch.equal(pe[k], re[k]), k
    assert replayed.logits_finite("gen") and plain.logits_finite("gen")

    tok = np.random.default_rng(3).integers(
        0, served["gen"].cfg.vocab_size, (1, 8))
    monkeypatch.setattr(graphs, "graph_for", lambda device: None)
    a = texec.TorchModelExecutor(served, device="cpu").ensure_instance("gen")
    monkeypatch.setattr(graphs, "graph_for", lambda device: StandInGraph)
    b = texec.TorchModelExecutor(served, device="cpu").ensure_instance("gen")
    assert a.prefill_fn.graph is None and b.prefill_fn.graph is not None
    for inst in (a, b):
        inst.run_tokens(tok)
        inst.run_tokens(tok)
    assert torch.equal(a.last_tokens, b.last_tokens)
    assert a.last_tokens.shape == (1, 3)


def _to_torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32 if a.dtype != np.int32 else np.int32)),
        tree)


def test_joins_and_steps_in_mixed_bucket_order_match_a_fresh_jax_executor():
    """minicpm-2b reduced (float32), max_batch 8: joins at buckets 8, 1, 4,
    2, 8 (padded ones too) with steps between them, against a fresh
    ``ContinuousJaxExecutor`` holding the same weights and prompts: tokens
    and positions equal, the K/V slab within the model-logit tolerance."""
    fn, P, G = "gen", 12, 4
    jcfg = j_get_config("minicpm-2b", reduced=True).with_(**F32)
    tcfg = get_config("minicpm-2b", reduced=True).with_(**F32)
    jex = ContinuousJaxExecutor({fn: JServed(jcfg, prompt_len=P, gen_len=G)},
                                max_batch=8)
    tex = texec.ContinuousTorchExecutor(
        {fn: texec.ServedModel(tcfg, prompt_len=P, gen_len=G)}, max_batch=8,
        device="cpu")
    js, ts = jex._ensure(fn), tex._ensure(fn)
    ts.params = params_from_numpy(tcfg, jax.tree.map(np.asarray, js.params),
                                  "cpu")
    ts.slab = _to_torch_tree(js.slab)
    ts.tok = torch.from_numpy(np.array(js.tok))
    ts.pos = torch.from_numpy(np.array(js.pos))

    def j_join(slots, toks):
        b, ids = jex._pad_slots(slots)
        t = jnp.asarray(toks, jnp.int32)
        t = jnp.concatenate([t, jnp.broadcast_to(
            t[:1], (b - len(slots),) + t.shape[1:])])
        js.slab, js.tok, js.pos = js.join_fns[b](js.params, js.slab, js.tok,
                                                 js.pos, t, ids)

    def j_step(slots):
        b, ids = jex._pad_slots(slots)
        js.slab, js.tok, js.pos = js.step_fns[b](js.params, js.slab, js.tok,
                                                 js.pos, ids)

    rng = np.random.default_rng(7)
    script = [("join", list(range(8))), ("step", list(range(8))),
              ("join", [5]), ("step", [5]),
              ("join", [1, 2, 3]), ("step", [1, 2, 3, 5]),
              ("join", [6, 7]), ("step", [6, 7]), ("release", [0, 4]),
              ("join", [0, 4, 2, 3, 1]), ("step", list(range(8))),
              ("step", [0, 2, 4, 6, 7])]
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
                                           **TOL)
    assert tex.n_admits == 5 and tex.n_steps == 6
    assert {b: p.runs for b, p in ts.joins.items()} == {1: 1, 2: 1, 4: 1,
                                                        8: 2}
    assert tex.logits_finite(fn)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m"])
def test_set_up_leaves_the_slab_as_the_reference_does(arch):
    """After ``_ensure`` and no join, the slab, the tokens and the
    positions equal ``ContinuousJaxExecutor``'s, which warms up into
    locals and leaves them as allocated (zeros): the port warms up in
    place and zeroes them after."""
    fn, P, G = "f", 16, 4
    jex = ContinuousJaxExecutor(
        {fn: JServed(j_get_config(arch, reduced=True), prompt_len=P,
                     gen_len=G)}, max_batch=4)
    tex = texec.ContinuousTorchExecutor(
        {fn: texec.ServedModel(get_config(arch, reduced=True),
                               prompt_len=P, gen_len=G)},
        max_batch=4, device="cpu")
    js, ts = jex._ensure(fn), tex._ensure(fn)
    np.testing.assert_array_equal(ts.tok.numpy(), np.asarray(js.tok))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    assert len(ts.slab["layers"]) == len(js.slab["layers"])
    for e, je in zip(ts.slab["layers"], js.slab["layers"]):
        assert sorted(e) == sorted(je)
        for k in e:
            np.testing.assert_array_equal(
                e[k].float().numpy(), np.asarray(je[k], np.float32), k)
    assert tex.logits_finite(fn)
