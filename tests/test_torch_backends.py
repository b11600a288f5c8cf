"""The port's ``torch`` / ``torch-batched`` backends on the CPU: the smoke
app served under every stack, the scheduling timeline against the JAX
package's batched backend with scripted times, the worker-crash slot
release, and the executors' greedy tokens against the JAX ``ModelInstance``
with the same weights and prompt."""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.sim as jsim  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.serving import apps as japps  # noqa: E402
from repro.serving import executor as jexec  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import apps as tapps  # noqa: E402
from repro_torch.serving import executor as texec  # noqa: E402

STACKS = ["archipelago", "baseline", "fifo", "pull", "sparrow"]
BACKENDS = [("torch-batched", dict(batching="continuous")),
            ("torch-batched", dict(batching="windowed")),
            ("torch", {})]
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _serve(stack, backend, kwargs, rps=8.0):
    return tsim.simulate(tsim.Experiment(
        stack=stack, backend=backend,
        backend_kwargs=dict(kwargs, device="cpu", calib_runs=1),
        workload_factory="serving_apps",
        workload_kwargs=dict(apps=tapps.smoke_apps(), duration=1.5, rps=rps),
        cluster=tcore.ClusterConfig(n_sgs=2, workers_per_sgs=2,
                                    cores_per_worker=2, pool_mem_mb=2048.0),
        drain=30.0, seed=1))


@pytest.mark.parametrize("backend,kwargs", BACKENDS,
                         ids=["continuous", "windowed", "torch"])
@pytest.mark.parametrize("stack", STACKS)
def test_torch_backends_serve_the_smoke_app_under_every_stack(stack, backend,
                                                              kwargs):
    r = _serve(stack, backend, kwargs)
    acc = r.accounting
    assert r.n_requests > 0 and r.n_completed == r.n_requests
    assert acc["lost"] == 0 and acc["duplicate_completions"] == 0
    assert acc["completed"] == acc["arrivals"] == r.n_requests_total
    assert r.data_plane == {"device": "cpu",
                            "batching": kwargs.get("batching", "none")}
    c = r.backend_counters
    if kwargs.get("batching") == "continuous":
        assert c["n_joins"] >= r.n_requests
        assert c["n_decode_ticks"] > 0
    elif backend == "torch-batched":
        assert c["n_batched_invocations"] == r.n_requests
    else:
        assert c["n_executions"] == r.n_requests


# -- scripted times: the same timeline as the JAX package's backend -----------

# scripted seconds: a sandbox's set-up, a request alone, a windowed batch,
# a continuous join and a continuous decode step
SETUP_S, EXEC_S, BATCH_S, ADMIT_S, STEP_S = 0.2, 0.03, 0.035, 0.012, 0.006


def _scripted(cls):
    """A test-only executor that runs the model as its base class does but
    reports scripted seconds, so that both packages schedule on the same
    numbers."""

    class Scripted(cls):
        def calibrate(self, mem_mb=512.0, runs=3):
            return {n: dataclasses.replace(s, exec_time=EXEC_S,
                                           setup_time=SETUP_S)
                    for n, s in super().calibrate(mem_mb, runs=1).items()}

        def run_batch(self, fn_name, invs):
            super().run_batch(fn_name, invs)
            return BATCH_S

        def admit(self, fn_name, invs, slots):
            super().admit(fn_name, invs, slots)
            return ADMIT_S

        def step(self, fn_name, slots):
            super().step(fn_name, slots)
            return STEP_S

        def release_slots(self, fn_name, slots):
            super().release_slots(fn_name, slots)
            st = self._state[fn_name]
            scrubbed = bool((np.asarray(st.tok)[slots] == 0).all()
                            and (np.asarray(st.pos)[slots] == 0).all())
            vars(self).setdefault("released", []).append(
                (fn_name, sorted(slots), scrubbed))

    return Scripted


def _scripted_backend(backend_cls, executors, **kw):
    windowed, continuous = executors

    class Backend(backend_cls):
        def _make_executor(self, served):
            cls = continuous if self.batching == "continuous" else windowed
            return cls(dict(served), max_batch=self.max_batch, **kw)

    return Backend


J_BACKEND = _scripted_backend(jcore.BatchedJaxBackend,
                              (_scripted(jexec.BatchingJaxExecutor),
                               _scripted(jexec.ContinuousJaxExecutor)))
T_BACKEND = _scripted_backend(tcore.BatchedTorchBackend,
                              (_scripted(texec.BatchingTorchExecutor),
                               _scripted(texec.ContinuousTorchExecutor)),
                              device="cpu")


def _scripted_run(pkg, batching, faults=False, app_set="smoke_apps",
                  rps=30.0, n_sgs=1, pool_mem_mb=2048.0):
    core, sim, apps, backend_cls = pkg
    extra = {} if backend_cls is J_BACKEND else {"device": "cpu"}
    backend = backend_cls(batching=batching, max_batch=2, batch_window=0.01,
                          **extra)
    plan = None
    if faults:
        plan = core.FaultPlan(events=(core.worker_crash(k=1, at=0.5),
                                      core.worker_crash(k=1, at=1.1)),
                              seed=4)
    return sim.simulate(sim.Experiment(
        stack="archipelago", backend=backend,
        workload_factory="serving_apps",
        workload_kwargs=dict(apps=getattr(apps, app_set)(), duration=1.5,
                             rps=rps, prewarm_per_fn=1),
        cluster=core.ClusterConfig(n_sgs=n_sgs, workers_per_sgs=2,
                                   cores_per_worker=2,
                                   pool_mem_mb=pool_mem_mb),
        drain=10.0, seed=2, faults=plan))


def _timeline(res) -> str:
    h = hashlib.sha256()
    for r in res.sim.metrics.requests:
        h.update(f"{r.arrival_time!r}|{r.completion_time!r}|"
                 f"{r.n_cold_starts}|{r.sgs_id}|"
                 f"{r.total_queuing_delay!r}\n".encode())
    return h.hexdigest()


JAX_PKG = (jcore, jsim, japps, J_BACKEND)
TORCH_PKG = (tcore, tsim, tapps, T_BACKEND)


@pytest.mark.parametrize("batching", ["continuous", "windowed"])
def test_scripted_torch_batched_schedules_as_jax_batched(batching):
    j, t = (_scripted_run(p, batching) for p in (JAX_PKG, TORCH_PKG))
    assert _timeline(t) == _timeline(j)
    rows = [r.to_dict() for r in (j, t)]
    for r in rows:
        # the backend's name (also in the row's name) and data-plane identity
        # differ by design
        del r["wall_s"], r["data_plane"], r["backend"], r["name"]
    assert rows[0] == rows[1]
    assert t.n_completed == t.n_requests > 0
    assert t.data_plane == {"device": "cpu", "batching": batching}


def test_scripted_multitenant_apps_schedule_as_jax_batched():
    """``multitenant_apps``' four tenants (dense, SSM, MoE and the
    two-stage VLM DAG) on windowed ``torch-batched`` give
    ``jax-batched``'s timeline on scripted times (continuous batching
    refuses the VLM in both packages)."""
    j, t = (_scripted_run(p, "windowed", app_set="multitenant_apps",
                          rps=6.0, n_sgs=2, pool_mem_mb=4096.0)
            for p in (JAX_PKG, TORCH_PKG))
    assert _timeline(t) == _timeline(j)
    rows = [r.to_dict() for r in (j, t)]
    for r in rows:
        del r["wall_s"], r["data_plane"], r["backend"], r["name"]
    assert rows[0] == rows[1]
    assert sorted(t.per_class) == ["caption", "chat", "complete", "moe"]
    assert t.n_completed == t.n_requests > 0
    assert t.accounting["lost"] == 0


@pytest.mark.parametrize("backend,kwargs", BACKENDS[1:],
                         ids=["windowed", "torch"])
def test_torch_backends_serve_multitenant_apps(backend, kwargs):
    """The four tenants of ``multitenant_apps`` under ``archipelago`` on
    the CPU: every request completes once, every function of a request
    runs once, and the caption DAG runs ``vlm/embed`` before
    ``vlm/decode``."""
    be = tcore.get_backend(backend)(**kwargs, device="cpu", calib_runs=1)
    exp = tsim.Experiment(
        stack="archipelago", backend=be, workload_factory="serving_apps",
        workload_kwargs=dict(apps=tapps.multitenant_apps(), duration=1.0,
                             rps=4.0),
        cluster=tcore.ClusterConfig(n_sgs=2, workers_per_sgs=2,
                                    cores_per_worker=2, pool_mem_mb=4096.0),
        drain=60.0, seed=3)
    be.build(exp, exp.resolve_workload())        # calibrate once, here
    ex, ran = be.executor, []
    if kwargs:
        run_batch = ex.run_batch

        def counted(fn, invs):
            ran.extend((inv.request.req_id, fn) for inv in invs)
            return run_batch(fn, invs)
        ex.run_batch = counted
    else:
        execute = ex.execute

        def counted(inv):
            ran.append((inv.request.req_id, inv.fn.name))
            return execute(inv)
        ex.execute = counted
    r = tsim.simulate(exp)
    acc = r.accounting
    assert sorted(r.per_class) == ["caption", "chat", "complete", "moe"]
    assert all(st.n_completed == st.n_requests > 0
               for st in r.per_class.values())
    assert acc["lost"] == 0 and acc["duplicate_completions"] == 0
    assert acc["completed"] == acc["arrivals"] == r.n_requests_total
    assert len(ran) == len(set(ran))
    order = {}
    for req, fn in ran:
        order.setdefault(req, []).append(fn)
    captions = [fns for fns in order.values() if "vlm/embed" in fns]
    assert len(captions) == r.per_class["caption"].n_requests
    assert all(fns == ["vlm/embed", "vlm/decode"] for fns in captions)


def test_worker_crash_releases_the_dead_members_slots():
    """Under torch-batched continuous, a crashed worker's in-flight members
    leave the batch: their cache slots are scrubbed (``release_slots``)
    and every request still completes exactly once, as under JAX."""
    j, t = (_scripted_run(p, "continuous", faults=True)
            for p in (JAX_PKG, TORCH_PKG))
    released = vars(t.sim.backend.executor).get("released", [])
    assert t.backend_counters["n_dropped_invocations"] > 0
    assert released and all(slots and scrubbed
                            for _, slots, scrubbed in released)
    acc = t.accounting
    assert acc["lost"] == 0 and acc["duplicate_completions"] == 0
    assert acc["completed"] == acc["arrivals"]
    assert t.n_retries > 0
    assert _timeline(t) == _timeline(j)
    assert released == vars(j.sim.backend.executor).get("released")


# -- greedy tokens against the JAX ModelInstance ------------------------------


def _jax_greedy(inst, tokens):
    """The JAX ``ModelInstance.run`` loop on given prompt tokens."""
    sm = inst.served
    logits, cache = inst.prefill_fn(inst.params, jnp.asarray(tokens,
                                                              jnp.int32),
                                    inst.cache0)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(sm.gen_len):
        logits, cache = inst.decode_fn(inst.params, cache, tok,
                                       jnp.int32(sm.prompt_len + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-370m"])
@pytest.mark.parametrize("batched", [False, True],
                         ids=["per-invocation", "windowed"])
def test_executors_produce_the_jax_greedy_tokens(arch, batched):
    P, G, B = 10, 4, 2 if batched else 1
    jcfg = j_get_config(arch, reduced=True).with_(**F32)
    tcfg = get_config(arch, reduced=True).with_(**F32)
    jinst = jexec.ModelInstance(jexec.ServedModel(jcfg, prompt_len=P,
                                                  gen_len=G, batch=B))
    jinst.setup()
    served = {"gen": texec.ServedModel(tcfg, prompt_len=P, gen_len=G)}
    if batched:
        ex = texec.BatchingTorchExecutor(served, max_batch=2, device="cpu")
        inst = ex.ensure_instance("gen", B)
    else:
        ex = texec.TorchModelExecutor(served, device="cpu")
        inst = ex.ensure_instance("gen")
    inst.params = params_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                       jinst.params), "cpu")
    tokens = texec.prompt_tokens(inst.served, seed=5, n=B)
    assert tokens.shape == (B, P)
    secs = inst.run_tokens(tokens)
    assert secs > 0
    np.testing.assert_array_equal(inst.last_tokens.numpy(),
                                  _jax_greedy(jinst, tokens))
    assert ex.build_seconds == 0.0      # nothing to build off the card


def test_prompt_tokens_follow_the_seed():
    sm = texec.ServedModel(get_config("mamba2-370m", reduced=True),
                           prompt_len=6)
    a, b = (texec.prompt_tokens(sm, 3, 2) for _ in range(2))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 6) and 0 <= a.min() and a.max() < sm.cfg.vocab_size
    assert not np.array_equal(a, texec.prompt_tokens(sm, 4, 2))


def test_run_sweep_runs_torch_cells_sequentially():
    """Cells on a backend that times work on a device never go to the
    process pool: they would share the card."""
    base = tsim.Experiment(
        stack="archipelago", backend="torch-batched",
        backend_kwargs=dict(device="cpu", calib_runs=1),
        workload_factory="serving_apps",
        workload_kwargs=dict(apps=tapps.smoke_apps(), duration=0.5, rps=4.0),
        drain=10.0)
    with pytest.warns(RuntimeWarning, match="sequentially"):
        sweep = tsim.run_sweep(base, {"backend_kwargs.batching":
                                      ["windowed", "continuous"]}, workers=2)
    rows = [r["result"] for r in sweep.rows]
    assert [r["data_plane"]["batching"] for r in rows] == ["windowed",
                                                           "continuous"]
    assert all(r["n_completed"] == r["n_requests"] > 0 for r in rows)
