"""The readings of the port's tracer (``repro_torch.trace``): the one
definition of each number its records give.

From the spans (:func:`summarize`; the host's clock, device intervals from
the event pairs and marks).  A join or step whose span overlaps a profiled
slice (``profiled``: host-clock intervals) is left out, since the profiler
slows what it watches:

* ``launch_ms``: the mean ``launch`` span of a join or step
  (``Program.launch``: the replay's ``cudaGraphLaunch``);
* ``step_device_ms``: the mean device interval of a step, from the event
  before its staged copies to the one after its replay;
* ``slab_copy_ms``: the mean ``gather`` + ``scatter`` of a step, timed by
  the marks inside its graph;
* ``step_mamba_ms`` / ``step_attn_ms``: the mean over steps of the device
  time of a step's Mamba groups / attention groups, summed over its groups
  (the ``mamba`` / ``attn`` marks inside the model); None where no step
  has such a group;
* ``slab_in_place_pct``: 100 × the bytes of slab rows the steps addressed
  in place over those plus the bytes they copied (gathered and
  scattered): 100 where every cache leaf is a full-attention group's K/V,
  0 for a pure SSM;
* ``call_idle_pct``: 100 × (1 − Σ device interval / Σ timed seconds) over
  the joins and steps: the device's idle outside each call's device
  interval (the host's staging before the first event, the wake-up after
  the last).  Idle inside the interval (between the staged copies and the
  graph's first kernel, between its kernels) it does not see, so it is a
  lower bound on the idle of a call;
* ``join`` / ``step``: per kind, the count and the mean ms of the timed
  seconds, its ``stage`` / ``launch`` / ``sync`` spans, its device interval
  and its phases.

From a profile (:func:`profile_readings` over :func:`profile_events`;
kineto's clock, ns):

* ``idle_in_calls_pct``: the share of the device's idle (the gaps between
  the union of its operations) that lies inside ``executor.join`` /
  ``executor.step`` ranges;
* ``graph_idle_pct``: inside each call, from the first device operation
  that starts after its ``launch`` range opens to its last one's end, the
  share of that interval no operation covers: the idle between a replay's
  kernels, as the profiler sees it (its own cost included);
* ``graph_idle_after_launch_pct``: the same from the end of the call's
  ``cudaGraphLaunch``, when every node is submitted: the idle a slow
  launch does not hold back;
* ``graph_launches``, ``launch_ranges``, ``graph_launches_in_launch``: the
  ``cudaGraphLaunch`` calls, the ``launch`` ranges, and the calls that lie
  inside a ``launch`` range.

:func:`clock_agreement` holds the spans mirrored in a profile against
their ranges.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

CALLS = ("executor.join", "executor.step")
CHILDREN = ("stage", "launch", "sync")

Interval = Tuple[float, float]


def _mean_ms(xs: Sequence[float]) -> Optional[float]:
    return 1e3 * sum(xs) / len(xs) if xs else None


def _calls(spans: Sequence[Any], profiled: Sequence[Interval] = ()
          ) -> List[Tuple[int, Any]]:
    """(index, span) of each closed join and step that overlaps no
    profiled slice."""
    return [(i, s) for i, s in enumerate(spans)
            if s.name in CALLS and s.end is not None
            and not any(s.start < t1 and s.end > t0 for t0, t1 in profiled)]


def summarize(spans: Sequence[Any], profiled: Sequence[Interval] = ()
              ) -> Dict[str, Any]:
    """The span readings (module docstring); None where nothing is read."""
    kept = _calls(spans, profiled)
    child: Dict[int, Dict[str, float]] = defaultdict(dict)
    for s in spans:
        if s.parent is not None and s.end is not None:
            child[s.parent][s.name] = s.end - s.start
    steps = [s for _, s in kept if s.name == "executor.step"]
    timed = sum(s.end - s.start for _, s in kept)
    device = [s.device_s for _, s in kept if s.device_s is not None]
    in_place = sum(s.in_place_bytes for s in steps)
    slab = in_place + sum(s.copied_bytes for s in steps)
    out: Dict[str, Any] = {
        "launch_ms": _mean_ms([child[i].get("launch", 0.0)
                               for i, _ in kept]),
        "step_device_ms": _mean_ms([s.device_s for s in steps
                                    if s.device_s is not None]),
        "slab_copy_ms": _mean_ms([s.phases["gather"] + s.phases["scatter"]
                                  for s in steps if "gather" in s.phases]),
        "step_mamba_ms": _mean_ms([s.phases["mamba"] for s in steps
                                   if "mamba" in s.phases]),
        "step_attn_ms": _mean_ms([s.phases["attn"] for s in steps
                                  if "attn" in s.phases]),
        "slab_in_place_pct": 100.0 * in_place / slab if slab else None,
        "call_idle_pct": (100.0 * (1.0 - sum(device) / timed)
                          if device and len(device) == len(kept) and timed
                          else None),
    }
    for name in CALLS:
        lst = [(i, s) for i, s in kept if s.name == name]
        if not lst:
            out[name.split(".")[1]] = None
            continue
        kind = {"n": len(lst),
                "timed_ms": _mean_ms([s.end - s.start for _, s in lst])}
        for c in CHILDREN:
            kind[c + "_ms"] = _mean_ms([child[i].get(c, 0.0) for i, _ in lst])
        kind["device_ms"] = _mean_ms([s.device_s for _, s in lst
                                      if s.device_s is not None])
        for p in (lst[0][1].phases or {}):
            kind[p + "_ms"] = _mean_ms([s.phases[p] for _, s in lst
                                        if p in s.phases])
        out[name.split(".")[1]] = kind
    return out


def profile_events(prof) -> Tuple[List[Interval], List[Tuple[str, int, int]]]:
    """A ``torch.profiler`` profile's device operations (start, end) and
    host events (name, start, end), in ns."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((s, t))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), s, t))
    return dev, host


def _union(ivs: Sequence[Interval]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, t in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """The length of the intersection of two unions of intervals."""
    ua, ub = _union(a), _union(b)
    i = j = 0
    total = 0.0
    while i < len(ua) and j < len(ub):
        total += max(0.0, min(ua[i][1], ub[j][1]) - max(ua[i][0], ub[j][0]))
        if ua[i][1] < ub[j][1]:
            i += 1
        else:
            j += 1
    return total


def profile_readings(dev: Sequence[Interval],
                     host: Sequence[Tuple[str, float, float]]
                     ) -> Dict[str, Any]:
    """The profile readings (module docstring); None where nothing is
    read."""
    merged = _union(dev)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    idle = sum(t - s for s, t in gaps)
    ranges = defaultdict(list)
    for n, s, t in host:
        ranges[n].append((s, t))
    call_rs = sorted(r for n in CALLS for r in ranges[n])
    launch_rs = sorted(ranges["launch"])
    out: Dict[str, Any] = {
        "idle_s": idle / 1e9,
        "idle_in_calls_pct": (100.0 * _overlap(gaps, call_rs) / idle
                              if idle else None),
        "graph_launches": len(ranges["cudaGraphLaunch"]),
        "launch_ranges": len(launch_rs),
        "graph_launches_in_launch": sum(
            any(l0 <= s and t <= l1 for l0, l1 in launch_rs)
            for s, t in ranges["cudaGraphLaunch"]),
    }
    ops = sorted(dev)
    starts = np.array([s for s, _ in ops], dtype=np.float64)
    graph_launches = sorted(ranges["cudaGraphLaunch"])
    span = {"graph_idle_pct": 0.0, "graph_idle_after_launch_pct": 0.0}
    covered = dict.fromkeys(span, 0.0)
    for c0, c1 in call_rs:
        opened = [(l0, l1) for l0, l1 in launch_rs if c0 <= l0 and l1 <= c1]
        if not opened:
            continue
        l0, l1 = opened[0]
        done = [t for s, t in graph_launches if l0 <= s and t <= l1]
        for key, since in (("graph_idle_pct", l0),
                           ("graph_idle_after_launch_pct",
                            done[0] if done else None)):
            if since is None:
                continue
            lo, hi = np.searchsorted(starts, [since, c1])
            inside = [(s, t) for s, t in ops[lo:hi] if t <= c1]
            if inside:
                span[key] += max(t for _, t in inside) - inside[0][0]
                covered[key] += sum(t - s for s, t in _union(inside))
    for key in span:
        out[key] = (100.0 * (1.0 - covered[key] / span[key]) if span[key]
                    else None)
    return out


def clock_agreement(spans: Sequence[Any],
                    host: Sequence[Tuple[str, float, float]]
                    ) -> Optional[Dict[str, Any]]:
    """The mirrored spans against their ranges in a profile.  Spans and
    ranges of one name pair up in order where their counts agree.  A range
    opens before its span's first clock reading and closes after its last,
    so where the two clocks tick at one rate (``rate_ppm``: a line fitted
    from the spans' starts to the ranges', then again without the starts
    more than five times the median distance, and 1 µs, from it) each
    reading disagrees with its range by at most the range's excess: its
    duration less its span's.  Returns the pairs, the names whose counts
    differ, the rate, and the median, p99 and max excess in µs, over all
    pairs and by name; None with no pair."""
    mine, theirs = defaultdict(list), defaultdict(list)
    for s in spans:
        if s.mirrored and s.end is not None:
            mine[s.name].append((s.start, s.end))
    for n, s, t in host:
        if n in mine:
            theirs[n].append((s, t))
    pairs, names, unequal = [], [], []
    for n in sorted(mine):
        if len(mine[n]) == len(theirs[n]):
            pairs += zip(sorted(mine[n]), sorted(theirs[n]))
            names += [n] * len(mine[n])
        else:
            unequal.append(n)
    if not pairs:
        return None
    ms = np.array([m[0] for m, _ in pairs]) * 1e9
    me = np.array([m[1] for m, _ in pairs]) * 1e9
    rs = np.array([r[0] for _, r in pairs], dtype=np.float64)
    re = np.array([r[1] for _, r in pairs], dtype=np.float64)
    x0, y0 = ms.min(), rs.min()
    a = np.stack([np.ones_like(ms), ms - x0], 1)
    keep = np.ones(len(ms), dtype=bool)
    for _ in range(2):          # the fit, then the fit without the stalls
        coef = np.linalg.lstsq(a[keep], rs[keep] - y0, rcond=None)[0]
        dist = np.abs(rs - y0 - a @ coef)
        keep = dist <= max(5.0 * float(np.median(dist)), 1e3)
    excess = ((re - rs) - (me - ms)) / 1e3
    names = np.array(names)

    def q(v):
        return [float(np.median(v)), float(np.quantile(v, 0.99)),
                float(v.max())]
    return {"pairs": len(pairs), "unequal": unequal,
            "rate_ppm": float((coef[1] - 1.0) * 1e6),
            "excess_us": q(excess),
            "excess_us_by_name": {n: q(excess[names == n])
                                  for n in sorted(set(names))}}
