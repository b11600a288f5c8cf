"""The profiled slice: its readings, and the guard on empty profiles."""
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import profiling
from portbench.system import Event


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._t = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def fake_profile(events):
    kin = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=kin))


CUDA, CPU = DeviceType.CUDA, DeviceType.CPU


def test_summarize_busy_kernels_and_gaps():
    prof = fake_profile([
        Ev("k1", CUDA, 0, 100), Ev("k2", CUDA, 50, 100),   # union 0..150
        Ev("k1", CUDA, 400, 100),                          # gap 150..400
        Ev("k3", CUDA, 1000, 50),                          # gap 500..1000
        Ev("cudaGraphLaunch", CPU, 200, 300),
        Ev("step", CPU, 100, 2000),
    ])
    s = profiling.summarize(prof, window_s=2e-6)
    assert s.busy_s == pytest.approx(300e-9)
    assert s.kernel_s == pytest.approx({"k1": 200e-9, "k2": 100e-9,
                                        "k3": 50e-9})
    assert s.device_ops[0][0] == "k1"
    # the longest gap first, named by the shortest host op covering it
    assert s.idle_gaps == [["step", pytest.approx(500e-9)],
                           ["cudaGraphLaunch", pytest.approx(250e-9)]]


def test_an_empty_profile_reads_nothing():
    assert profiling.summarize(fake_profile([Ev("x", CPU, 0, 5)]), 1.0) \
        is None


class Profiles:
    """Stands in for torch.profiler.profile: hands out scripted event
    lists, one per slice."""

    def __init__(self, scripts):
        self.scripts = list(scripts)

    def __call__(self, activities):
        evs = self.scripts.pop(0)
        p = fake_profile(evs)
        p.__enter__ = lambda: p
        p.__exit__ = lambda *a: None
        return _Ctx(p)


class _Ctx:
    def __init__(self, p):
        self.p = p
        self.profiler = p.profiler

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return None


def drive(monkeypatch, scripts):
    monkeypatch.setattr(torch.profiler, "profile", Profiles(scripts))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    ex = types.SimpleNamespace(in_slice=False, events=[])
    sl = profiling.Slicer(ex, start=5.0, seconds=10.0, profile_s=1.0)
    calls = sorted(sl.timed_calls(), key=lambda c: c[0])
    for t, fn in calls:
        fn(None, None)
        if ex.in_slice:
            ex.events.append(Event("step", t, (0,), (), 0.01, True))
    return sl, ex


def test_an_empty_slice_is_taken_again(monkeypatch):
    sl, ex = drive(monkeypatch, [[Ev("op", CPU, 0, 5)],
                                 [Ev("k", CUDA, 0, 5)]])
    assert sl.tried == 2
    s = sl.result()
    assert s is not None and s.kernel_s == {"k": pytest.approx(5e-9)}
    # only the second slice's events count as inside the slice read
    assert [e.in_slice for e in ex.events] == [False, True]


def test_two_empty_slices_read_nothing(monkeypatch):
    sl, _ = drive(monkeypatch, [[], []])
    assert sl.tried == 2 and sl.result() is None


def test_a_full_first_slice_is_kept(monkeypatch):
    sl, _ = drive(monkeypatch, [[Ev("k", CUDA, 0, 5)]])
    assert sl.tried == 1 and sl.result() is not None
