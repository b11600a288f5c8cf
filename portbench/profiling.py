"""The traced run's profiled slice.

A whole window of replays would be millions of profiler events, so a
``--trace 1`` run profiles a slice of ``PROFILE_S`` seconds on the
system's clock from three tenths of the window (after the DAG's upload).
After CUDA graph capture the profiler at times records no device event
over a whole profile; a slice that recorded none is taken again from six
tenths of the window, and a run whose slices both stay empty fails: it
never reports an idle share or a roofline from an empty profile.

From the slice: the seconds some operation ran on the device (the union of
the device events' intervals), the slice's wall length, the device time of
each kernel by name, the ten operations that took the most device time and
the ten longest idle gaps, each named by what the host was doing
meanwhile (the shortest host operation covering the gap's middle, else
"host: no traced op").
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
from typing import Dict, List, Optional, Tuple

SLICE_STARTS = (0.3, 0.6)       # shares of the window
PROFILE_S = 2.0                 # system-clock seconds of one slice


@dataclasses.dataclass
class Slice:
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    profiled: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)   # host-clock spans of every slice opened


def _events(prof):
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        iv = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            dev.append(iv)
        elif e.device_type() == DeviceType.CPU:
            host.append(iv)
    return dev, host


def _union(dev):
    merged: List[List[int]] = []
    for s, t, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def summarize(prof, window_s: float) -> Optional[Slice]:
    """The slice's readings; None when the profile holds no device event."""
    dev, host = _events(prof)
    if not dev:
        return None
    merged = _union(dev)
    busy_ns = sum(t - s for s, t in merged)
    by_name: Dict[str, float] = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e9
    hs = np.array([h[0] for h in host], dtype=np.int64)
    ht = np.array([h[1] for h in host], dtype=np.int64)
    gaps = sorted(((s1 - t0, t0, s1) for (_, t0), (s1, _)
                   in zip(merged, merged[1:])), reverse=True)[:10]
    idle = []
    for length, t0, s1 in gaps:
        mid = (t0 + s1) // 2
        cover = np.flatnonzero((hs <= mid) & (ht >= mid))
        label = (host[cover[np.argmin(ht[cover] - hs[cover])]][2]
                 if len(cover) else "host: no traced op")
        idle.append([label, length / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Slice(busy_s=busy_ns / 1e9, window_s=window_s, kernel_s=by_name,
                 device_ops=[[n, v] for n, v in top],
                 idle_gaps=idle)


class Slicer:
    """Opens and closes the profiled slices from inside the event loop
    (``simulate``'s ``timed_calls``), flagging the executor's events that
    fall inside an open slice."""

    def __init__(self, executor, start: float, seconds: float,
                 profile_s: float = PROFILE_S):
        self.executor = executor
        self.starts = [start + f * seconds for f in SLICE_STARTS]
        self.profile_s = profile_s
        self.prof = None
        self.t0 = 0.0
        self.kept = None            # (prof, wall seconds) of the slice read
        self.tried = 0
        self.spans: List[Tuple[float, float]] = []

    def timed_calls(self):
        calls = []
        for t in self.starts:
            calls.append((t, self._start))
            calls.append((t + self.profile_s, self._stop))
        return calls

    def _start(self, env, stack) -> None:
        if self.kept is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.spans.append((time.perf_counter(), float("inf")))
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.tried += 1
        self.executor.in_slice = True
        self.t0 = time.perf_counter()

    def _stop(self, env, stack) -> None:
        if self.prof is None:
            return
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.executor.in_slice = False
        prof, self.prof = self.prof, None
        if any(e.device_type() == DeviceType.CUDA
               for e in prof.profiler.kineto_results.events()):
            self.kept = (prof, wall)
        else:
            # the slice's joins and steps are not the read slice's
            for e in self.executor.events:
                e.in_slice = False
        self.spans[-1] = (self.spans[-1][0], time.perf_counter())

    def result(self) -> Optional[Slice]:
        if self.kept is None:
            return None
        s = summarize(*self.kept)
        if s is not None:
            s.profiled = list(self.spans)
        return s
