"""Sharded parallel simulation core: epoch-synchronized SGS islands.

Archipelago's partition structure (§3) is the parallelism: between LBS
routing points the SGSs are independent islands — an SGS only ever reacts
to (a) submissions routed to it by the LBS and (b) its own internal events
(dispatch, completion, estimator ticks).  ``simulate_sharded`` exploits
this as a conservative parallel discrete-event simulation:

* The **coordinator** (parent process) runs the whole control plane — the
  arrival pump, the LBS replica clocks, routing/lottery draws, the
  piggyback-EWMA fold state, per-DAG SGS scaling, and the optional LBS
  replica autoscaler — on a real
  :class:`~repro_torch.sim.engine.SimEnv` whose
  events are inserted in exactly the sequential order (so ``(t, seq)``
  tie-breaks replicate automatically).
* Each **shard** (child process) owns a disjoint set of SGSs with their
  worker pools and sandbox state, advancing its own event loop.
* They synchronize at **epoch barriers**: the coordinator advances every
  shard to a time bound ``T`` and collects the piggyback reports generated
  up to ``T``; routed submissions and scale-out preallocations accumulated
  since the previous barrier ride on the advance message as compact numpy
  blocks.

Barrier placement is driven by *lookahead*: a submission routed at arrival
time ``t`` cannot reach an SGS before ``t + minlat`` where ``minlat`` is
the minimum control-plane latency (``lb_cost + sgs_cost * min_fns``), so
shards may safely run ahead of the coordinator by up to ``minlat``.
Barriers are forced only where cross-shard state is actually read:

* **Scale ticks** (``LoadBalancer.check_scaling`` every
  ``decision_interval / 5``) read every DAG's folded report window —
  inclusive barrier exactly at the tick time.
* **Multi-SGS routed arrivals** (a DAG whose active set has >1 SGS, or a
  non-empty removed list) read per-SGS EWMAs in the lottery — barrier at
  ``min(next_tick, t + minlat)``; when the bound is ``t + minlat`` it is
  *exclusive* (``SimEnv.run_until_before``) because a submission can land
  at exactly that instant and must execute in the next epoch.

Single-SGS arrivals (the common case — the fast path in
``LoadBalancer._lottery`` consumes one RNG draw and reads no report state)
and LBS autoscaler ticks (which read only coordinator-local clocks) run
ahead of the shard frontier freely.

Determinism is a hard contract: same seed ⇒ an ``ExperimentResult``
byte-identical to the single-process path at ANY shard count and ANY
partition of SGS ids (``tests/test_shards.py`` pins both in the JAX
package, ``tests/test_torch_shards.py`` in the port).  See docs/PERF.md
("The sharded core") for the epoch protocol and message formats.

Copy of ``src/repro/sim/shard.py`` (the port imports nothing of
``repro``).  As there, only the ``modeled`` backend shards: the torch
backends time real work on the card in one process and are refused by
:func:`validate_shardable`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.cluster import ClusterConfig, build_sgs_pool
from ..core.stacks import _ServiceClock, make_archipelago_submit
from ..core.lbs import LoadBalancer
from ..core.types import DagSpec, Request
from .engine import SimEnv

__all__ = ["simulate_sharded", "validate_shardable", "default_partition"]

# response sentinel a shard sends instead of a payload when its loop raised
_ERR = "__shard_error__"


# ---------------------------------------------------------------------------
# Validation / partitioning
# ---------------------------------------------------------------------------


def validate_shardable(exp, hooks: Sequence = (),
                       timed_calls: Sequence = ()) -> None:
    """Reject experiment shapes the sharded core cannot reproduce
    byte-identically.  Raises ``ValueError`` with the reason; callers that
    cannot shard for *environmental* reasons (daemonic pool workers) fall
    back to the sequential path silently instead — that path is identical
    by contract, so only semantic mismatches are errors."""
    n = int(exp.shards)
    if exp.stack != "archipelago":
        raise ValueError(
            f"shards={n} requires stack='archipelago' (the sharded core "
            f"partitions SGS islands); got stack={exp.stack!r}")
    if exp.backend != "modeled":
        raise ValueError(
            f"shards={n} requires the modeled execution backend (shard "
            f"processes own their data plane); got "
            f"backend={exp.backend_name()!r}")
    if exp.faults is not None and exp.faults.events:
        raise ValueError(
            f"shards={n} does not support fault plans yet (fault events "
            f"mutate cross-shard control-plane state mid-epoch)")
    if exp.params.get("hedge_timeout"):
        raise ValueError(
            f"shards={n} does not support hedged retries (shard processes "
            f"build their SGS pools directly, bypassing the stack's hedge "
            f"wiring); drop params['hedge_timeout'] or run sequentially")
    if hooks or timed_calls:
        raise ValueError(
            f"shards={n} does not support simulate(hooks=/timed_calls=) "
            f"(they observe one process's event loop)")
    if exp.workload_method != "numpy":
        raise ValueError(
            f"shards={n} requires workload_method='numpy'")
    cc = exp.cluster or ClusterConfig()
    if n > cc.n_sgs:
        raise ValueError(
            f"shards={n} exceeds the cluster's {cc.n_sgs} SGSs "
            f"(each shard needs at least one island)")
    spec = exp.resolve_workload()
    if getattr(spec, "pre_pump", None) is not None:
        raise ValueError(
            f"shards={n} does not support workloads with a pre_pump hook")


def default_partition(n_sgs: int, shards: int) -> List[List[int]]:
    """Contiguous near-even blocks of SGS ids, one per shard."""
    return [a.tolist() for a in np.array_split(np.arange(n_sgs), shards)]


def _check_partition(partition: Sequence[Sequence[int]], n_sgs: int) -> None:
    flat = [s for part in partition for s in part]
    if sorted(flat) != list(range(n_sgs)):
        raise ValueError(
            f"partition must cover each SGS id 0..{n_sgs - 1} exactly once")
    if any(len(p) == 0 for p in partition):
        raise ValueError("every shard needs at least one SGS id")


# ---------------------------------------------------------------------------
# Coordinator-side SGS stand-in
# ---------------------------------------------------------------------------


class _SGSProxy:
    """What the coordinator's ``LoadBalancer`` sees instead of a live
    ``SemiGlobalScheduler``: the id (routing is by id), the piggyback
    ``report`` attribute the LBS wires in, and ``preallocate`` — which
    records the scale-out warm-up into the owning shard's outbox instead of
    touching sandbox state."""

    __slots__ = ("sgs_id", "report", "_pre_out", "_dag_pos")

    def __init__(self, sgs_id: int, pre_out: List[tuple],
                 dag_pos: Dict[str, int]):
        self.sgs_id = sgs_id
        self._pre_out = pre_out
        self._dag_pos = dag_pos

    def preallocate(self, dag: DagSpec, n_per_fn: int) -> None:
        self._pre_out.append((self.sgs_id, self._dag_pos[dag.dag_id],
                              n_per_fn))

    def submit_request(self, req: Request) -> None:  # pragma: no cover
        raise RuntimeError(
            "submissions to a sharded SGS go through the epoch outbox, "
            "not the proxy")


# ---------------------------------------------------------------------------
# Shard worker (child process)
# ---------------------------------------------------------------------------


def _shard_worker(conn, cc: ClusterConfig, sgs_cfg,
                  tenant_dags: List[DagSpec], sgs_ids: List[int]) -> None:
    """One shard: a private event loop over this partition's SGSs.

    Protocol (coordinator → shard):

    * ``("adv", T, inclusive, subs, pre)`` — apply preallocations ``pre``
      (``(sgs_id, dag_idx, n_per_fn)`` triples, generated at the previous
      tick = this shard's current clock), schedule submission block ``subs``
      (parallel numpy arrays ``(m_idx, sgs_id, t_sched, arrival_t,
      dag_idx)``), then advance to ``T`` (``run_until`` when inclusive,
      ``run_until_before`` otherwise).  Replies with the epoch's piggyback
      report block ``(rt, dag_idx, sgs_id, qdelay, sandbox_count)`` as
      numpy arrays (or ``None``).
    * ``("fin",)`` — reply with the terminal payload (completion columns,
      leftover in-flight rows, per-SGS queuing samples, counters, event
      count) and exit.
    """
    try:
        env = SimEnv()
        sgss = build_sgs_pool(env, cc, sgs_cfg, list(sgs_ids))
        by_id = {s.sgs_id: s for s in sgss}
        dag_pos = {d.dag_id: k for k, d in enumerate(tenant_dags)}

        reports: List[tuple] = []

        def report(dag_id: str, sgs_id: int, qdelay: float,
                   sandbox_count: int,
                   _append=reports.append, _pos=dag_pos) -> None:
            _append((env._now, _pos[dag_id], sgs_id, qdelay, sandbox_count))

        comp: List[tuple] = []
        pend: Dict[int, Request] = {}

        def on_complete(req: Request, now: float,
                        _append=comp.append, _pop=pend.pop) -> None:
            _append((req.m_idx, now, req.n_cold_starts, req.sgs_id,
                     req.total_queuing_delay))
            _pop(req.m_idx, None)

        for s in sgss:
            s.report = report
            s.on_complete = on_complete

        call_at = env.call_at
        while True:
            msg = conn.recv()
            tag = msg[0]
            if tag == "adv":
                _, T, inclusive, subs, pre = msg
                if pre is not None:
                    for sid, didx, n_per in pre:
                        by_id[sid].preallocate(tenant_dags[didx], n_per)
                if subs is not None:
                    mi, si, ts, at, di = subs
                    for m, s, t, a, d in zip(mi.tolist(), si.tolist(),
                                             ts.tolist(), at.tolist(),
                                             di.tolist()):
                        req = Request(dag=tenant_dags[d], arrival_time=a)
                        req.m_idx = m
                        pend[m] = req
                        call_at(t, by_id[s].submit_request, req)
                if inclusive:
                    env.run_until(T)
                else:
                    env.run_until_before(T)
                if reports:
                    rt, rd, rs, rq, rc = zip(*reports)
                    reports.clear()
                    conn.send((np.asarray(rt, dtype=np.float64),
                               np.asarray(rd, dtype=np.int64),
                               np.asarray(rs, dtype=np.int64),
                               np.asarray(rq, dtype=np.float64),
                               np.asarray(rc, dtype=np.int64)))
                else:
                    conn.send(None)
            elif tag == "fin":
                if comp:
                    ci, ct, cold, cs, cq = zip(*comp)
                    comp_block = (np.asarray(ci, dtype=np.int64),
                                  np.asarray(ct, dtype=np.float64),
                                  np.asarray(cold, dtype=np.int64),
                                  np.asarray(cs, dtype=np.int64),
                                  np.asarray(cq, dtype=np.float64))
                else:
                    comp_block = None
                pend_rows = [(i, r.n_cold_starts,
                              -1 if r.sgs_id is None else r.sgs_id,
                              r.total_queuing_delay)
                             for i, r in pend.items()]
                queuing = [(s.sgs_id,
                            np.asarray(s.queuing_delays, dtype=np.float64),
                            np.asarray(s.queuing_delay_times,
                                       dtype=np.float64))
                           for s in sgss]
                conn.send({
                    "comp": comp_block,
                    "pend": pend_rows,
                    "queuing": queuing,
                    "cold_starts": sum(s.n_cold_starts for s in sgss),
                    "warm_hits": sum(s.n_warm_hits for s in sgss),
                    "n_events": env.n_events,
                })
                return
            else:  # pragma: no cover - protocol bug
                raise RuntimeError(f"unknown shard message {tag!r}")
    except BaseException:  # pragma: no cover - surfaced by the coordinator
        import traceback
        try:
            conn.send((_ERR, traceback.format_exc()))
        except Exception:
            pass
        raise


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


def simulate_sharded(exp, partition: Optional[Sequence[Sequence[int]]] = None):
    """Run ``exp`` through the sharded core, returning an
    ``ExperimentResult`` byte-identical to ``simulate`` on the sequential
    path (modulo ``wall_s``).  ``partition`` overrides the default
    contiguous split with an explicit list of SGS-id groups (any partition
    yields identical results — the determinism property the tests sweep)."""
    # local imports: experiment.py imports this module lazily, and a
    # top-level import back into it would be circular
    from ..core.backends import resolve_backend
    from ..core.stacks import get_stack
    from .experiment import (SimResult, _arrival_columns, _build_result,
                             _validate_params)
    from .metrics import Metrics

    stack_cls = get_stack(exp.stack)
    _validate_params(exp, stack_cls)
    spec = exp.resolve_workload()
    backend = resolve_backend(exp.backend, exp.backend_kwargs)
    spec = backend.build(exp, spec)
    env = SimEnv()
    backend.bind(env)
    cc = exp.cluster or ClusterConfig()
    n_shards = int(exp.shards)
    if partition is None:
        partition = default_partition(cc.n_sgs, n_shards)
    else:
        partition = [list(p) for p in partition]
        _check_partition(partition, cc.n_sgs)
    n_shards = len(partition)
    counters_before = dict(backend.counters())

    t0 = time.perf_counter()
    times, dags, arr_np, idx_np, tenant_dags = _arrival_columns(
        spec, exp.seed, exp.workload_method)
    metrics = Metrics.flat(arr_np, idx_np, tenant_dags)
    n = len(times)
    dag_pos = {d.dag_id: k for k, d in enumerate(tenant_dags)}
    dag_ids = [d.dag_id for d in tenant_dags]
    # conservative lookahead: no routed submission can land earlier than
    # arrival + (one LB decision + the smallest SGS decision)
    minlat = exp.lb_cost + exp.sgs_cost * (
        min(d._n_fns for d in tenant_dags) if tenant_dags else 1)
    if minlat <= 0.0:
        raise ValueError(
            "sharded runs need positive control-plane decision costs "
            "(lb_cost + sgs_cost): the lookahead window is what lets "
            "shards run ahead of the coordinator")

    # --- coordinator control plane (mirrors ArchipelagoStack.build) --------
    owner: Dict[int, int] = {}
    for k, part in enumerate(partition):
        for sid in part:
            owner[sid] = k
    sub_out: List[List[tuple]] = [[] for _ in range(n_shards)]
    pre_out: List[List[tuple]] = [[] for _ in range(n_shards)]
    proxies = [_SGSProxy(sid, pre_out[owner[sid]], dag_pos)
               for sid in range(cc.n_sgs)]
    lb = LoadBalancer(proxies, config=exp.lbs)
    auto = exp.autoscale
    if auto is not None:
        n_lb = int(exp.params.get("n_lbs", auto.min_replicas))
        n_lb = max(1, max(auto.min_replicas, min(n_lb, auto.max_replicas)))
    else:
        n_lb = max(1, int(exp.params.get("n_lbs", 4)))
    lb_clocks = [_ServiceClock() for _ in range(n_lb)]
    sgs_clocks = {sid: _ServiceClock() for sid in lb.sgss}
    scaler = None
    if auto is not None:
        from ..core.autoscale import LBSReplicaAutoscaler
        scaler = LBSReplicaAutoscaler(lb_clocks, exp.lb_cost, auto,
                                      make_clock=_ServiceClock)

    idx_l = idx_np.tolist()

    def deliver(t_sched: float, sgs_id: int, req: Request,
                _out=sub_out, _owner=owner) -> None:
        _out[_owner[sgs_id]].append((req.m_idx, sgs_id, t_sched))

    submit = make_archipelago_submit(lb_clocks, sgs_clocks, lb.select,
                                     env.call_at, exp.lb_cost, exp.sgs_cost,
                                     scaler=scaler, deliver=deliver)

    # --- parent event chains, inserted in the sequential order -------------
    # (pump first, then the scale-tick chain, then the autoscaler chain —
    # matching _run_experiment + ArchipelagoStack.start_background, so
    # (t, seq) heap tie-breaks replicate the single-process run)
    horizon = spec.duration + exp.drain

    def pump(i: int) -> None:
        now = times[i]
        req = Request(dag=dags[i], arrival_time=now)
        req.m_idx = i
        submit(req, now)
        i += 1
        if i < n:
            env.call_at(times[i], pump, i)

    pump._shard_kind = 1

    tick_interval = lb.cfg.decision_interval / 5.0
    next_tick = [tick_interval]

    def tick_scale() -> None:
        t = env._now
        next_tick[0] = t + tick_interval
        lb.check_scaling(t)
        env.call_after(tick_interval, tick_scale)

    tick_scale._shard_kind = 2

    if n:
        env.call_at(times[0], pump, 0)
    env.call_after(tick_interval, tick_scale)
    if scaler is not None:
        auto_interval = scaler.cfg.interval

        def tick_auto() -> None:
            scaler.tick(env._now)
            env.call_after(auto_interval, tick_auto)

        env.call_after(auto_interval, tick_auto)

    # --- spawn shards -------------------------------------------------------
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    conns = []
    procs = []
    try:
        for part in partition:
            pconn, cconn = ctx.Pipe()
            p = ctx.Process(target=_shard_worker,
                            args=(cconn, cc, exp.sgs, tenant_dags,
                                  list(part)),
                            daemon=True)
            p.start()
            cconn.close()
            conns.append(pconn)
            procs.append(p)

        # --- merged piggyback-report buffer --------------------------------
        r_t: List[float] = []
        r_did: List[int] = []
        r_sid: List[int] = []
        r_qd: List[float] = []
        r_cnt: List[int] = []
        rpos = 0
        barrier_wait = 0.0
        n_epochs = 0

        def _recv(k: int):
            blk = conns[k].recv()
            if isinstance(blk, tuple) and len(blk) == 2 and blk[0] == _ERR:
                raise RuntimeError(f"shard {k} failed:\n{blk[1]}")
            return blk

        def barrier(T: float, inclusive: bool) -> None:
            nonlocal rpos, barrier_wait, n_epochs
            for k in range(n_shards):
                out = sub_out[k]
                if out:
                    mi_l, si_l, ts_l = zip(*out)
                    out.clear()
                    mi = np.asarray(mi_l, dtype=np.int64)
                    subs = (mi, np.asarray(si_l, dtype=np.int64),
                            np.asarray(ts_l, dtype=np.float64),
                            arr_np[mi], idx_np[mi])
                else:
                    subs = None
                # NOTE: proxies hold a reference to pre_out[k]; clear in
                # place (send() pickles synchronously, so clearing after is
                # safe)
                pre = pre_out[k]
                conns[k].send(("adv", T, inclusive, subs,
                               pre if pre else None))
                if pre:
                    del pre[:]
            w0 = time.perf_counter()
            blocks = [_recv(k) for k in range(n_shards)]
            barrier_wait += time.perf_counter() - w0
            n_epochs += 1
            live = [b for b in blocks if b is not None]
            if live:
                if len(live) == 1:
                    bt, bd, bs, bq, bc = live[0]
                else:
                    bt = np.concatenate([b[0] for b in live])
                    bd = np.concatenate([b[1] for b in live])
                    bs = np.concatenate([b[2] for b in live])
                    bq = np.concatenate([b[3] for b in live])
                    bc = np.concatenate([b[4] for b in live])
                # stable time-sort: equal-instant ties keep the fixed shard
                # order, and per-SGS report order (the one the EWMA fold is
                # sensitive to) is preserved because an SGS lives in exactly
                # one shard
                order = np.argsort(bt, kind="stable")
                r_t.extend(bt[order].tolist())
                r_did.extend(bd[order].tolist())
                r_sid.extend(bs[order].tolist())
                r_qd.extend(bq[order].tolist())
                r_cnt.extend(bc[order].tolist())
            if rpos > 65536:    # trim the consumed prefix
                del r_t[:rpos]
                del r_did[:rpos]
                del r_sid[:rpos]
                del r_qd[:rpos]
                del r_cnt[:rpos]
                rpos = 0

        lb_report = lb.report

        def feed(t: float) -> None:
            """Deliver received piggyback reports with timestamp <= t into
            the LBS pending buffers (exactly what the in-process report
            channel would have accumulated by now)."""
            nonlocal rpos
            pos = rpos
            end = len(r_t)
            while pos < end and r_t[pos] <= t:
                lb_report(dag_ids[r_did[pos]], r_sid[pos], r_qd[pos],
                          r_cnt[pos])
                pos += 1
            rpos = pos

        # --- the epoch drive loop ------------------------------------------
        import heapq
        heap = env._events
        heappop = heapq.heappop
        dag_state = lb._dag_state
        S = 0.0             # shard frontier (all shards advanced to S)
        S_excl = False      # True: the frontier barrier was exclusive
        parent_events = 0
        while heap:
            head = heap[0]
            t = head[0]
            if t > horizon:
                break
            if t > S or (t == S and S_excl):
                kind = getattr(head[2], "_shard_kind", 0)
                if kind == 2:
                    # scale tick: needs every report generated up to (and
                    # including) the tick instant
                    barrier(t, True)
                    S, S_excl = t, False
                    continue
                if kind == 1:
                    st = dag_state.get(dags[head[3][0]].dag_id)
                    if st is not None and (len(st.active) > 1 or st.removed):
                        # multi-SGS lottery reads per-SGS EWMAs: stall until
                        # reports through t are in.  The bound is capped at
                        # the next scale tick so tick barriers stay exact.
                        b = t + minlat
                        if next_tick[0] <= b:
                            barrier(next_tick[0], True)
                            S, S_excl = next_tick[0], False
                        else:
                            # a submission can land at exactly t + minlat
                            # (idle clocks): exclusive bound so it executes
                            # next epoch, after delivery
                            barrier(b, False)
                            S, S_excl = b, True
                        continue
            feed(t)
            heappop(heap)
            env._now = t
            parent_events += 1
            head[2](*head[3])
        env._now = max(env._now, horizon)
        # final epoch: drain every shard through the horizon and flush any
        # leftover outbox (submissions scheduled past the horizon simply
        # stay unprocessed, exactly like the sequential heap leftovers)
        barrier(horizon, True)
        for k in range(n_shards):
            conns[k].send(("fin",))
        finals = [_recv(k) for k in range(n_shards)]
        for p in procs:
            p.join()
    finally:
        for c in conns:
            c.close()
        for p in procs:
            if p.is_alive():
                p.terminate()

    # --- merge shard state into the run's metrics --------------------------
    blocks = [f["comp"] for f in finals if f["comp"] is not None]
    if blocks:
        ci = np.concatenate([b[0] for b in blocks])
        ct = np.concatenate([b[1] for b in blocks])
        cold = np.concatenate([b[2] for b in blocks])
        cs = np.concatenate([b[3] for b in blocks])
        cq = np.concatenate([b[4] for b in blocks])
    else:
        ci = np.empty(0, dtype=np.int64)
        ct = np.empty(0, dtype=np.float64)
        cold = np.empty(0, dtype=np.int64)
        cs = np.empty(0, dtype=np.int64)
        cq = np.empty(0, dtype=np.float64)
    pending: Dict[int, Request] = {}
    for f in finals:
        for i, n_cold, sid, qd in f["pend"]:
            r = Request(dag=tenant_dags[idx_l[i]], arrival_time=times[i])
            r.m_idx = i
            r.n_cold_starts = n_cold
            r.sgs_id = None if sid < 0 else sid
            r.total_queuing_delay = qd
            pending[i] = r
    metrics.absorb_sharded(ci, ct, cold, cs, cq, pending)
    # queuing-sample chunks in global ascending SGS id — the order
    # ArchipelagoStack.collect adds them in (dict insertion order)
    chunks = {sid: (d, qt) for f in finals for sid, d, qt in f["queuing"]}
    for sid in sorted(chunks):
        d, qt = chunks[sid]
        metrics.add_queuing_samples(d, qt)

    shard_events = [f["n_events"] for f in finals]
    env.n_events = parent_events + sum(shard_events)
    warm_hits = sum(f["warm_hits"] for f in finals)
    wall = time.perf_counter() - t0

    counters = {k: v - counters_before.get(k, 0)
                for k, v in backend.counters().items()}
    sim = SimResult(metrics=metrics, env=env, lbs=lb, scheduler=None,
                    backend=backend, backend_counters=counters,
                    injector=None)
    # sharded-run telemetry for benchmarks (per-shard event counts, barrier
    # wait): carried on the live sim handle, NOT the result row — rows stay
    # byte-identical to the sequential path
    sim.shard_stats = {
        "shards": n_shards,
        "partition": [list(p) for p in partition],
        "parent_events": parent_events,
        "shard_events": shard_events,
        "n_epochs": n_epochs,
        "barrier_wait_s": round(barrier_wait, 4),
    }
    events = list(getattr(lb, "scaling_log", ()))
    if scaler is not None:
        events.extend(scaler.events)
    events.sort(key=lambda e: (e.t, e.component))
    scaling = [e.to_dict() for e in events]
    return _build_result(exp, spec, sim, warm_hits, wall, scaling)
