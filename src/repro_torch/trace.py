"""The port's tracer: spans on the host's clock, the device intervals of each
join and decode step, and the profiler's ranges.

Off by default (``ON``; :func:`enable` switches it).  Off, each call site
costs one test of ``ON`` and a graph captured then holds no node of the
tracer's.  Everything it records stays in memory (:func:`spans`) until
:func:`clear`; it writes no file.  On:

* **Spans** (:class:`Span`), on the clock of ``time.perf_counter`` (the
  clock of ``perf_counter_ns``, in seconds, as the executor reads it, so
  that a call's span lasts exactly the seconds the call returns):

  - ``executor.join`` / ``executor.step``: the interval the executor times
    (``admit`` / ``step``'s seconds), with the function, bucket and slots;
    a step's also with the bytes of slab rows it addressed in place and
    those it copied (fixed per function and bucket at set-up);
  - ``stage``, ``launch``, ``sync``, which tile their call: the prompt,
    the padding and ``Program.stage`` (the wait on the previous staged
    copies and the pinned host-to-device copies); ``Program.launch`` (the
    graph's replay, ``cudaGraphLaunch``; off the card the body's run);
    the wait for the device.

* **Device intervals.**  A join or step stamps the device before its
  staged copies and after its replay (``Span.device_s``).  A program's
  body marks the phases of its device work with :func:`mark`: on the card,
  a mark made while a graph is captured is an external timing event
  recorded into the graph, so that every replay records it again; off
  the card, where the body runs at every call, a mark takes the host's
  clock.  The executor reads both after the call's clock stops
  (``Span.phases``).  A step's marks are the executor's ``gather``,
  ``model``, ``scatter`` and ``end``, and inside ``model`` the decode
  step's: each layer group's start by its kind (``mamba``, ``attn``), then
  ``model`` again after the last group.

* **The profiler's clock.**  While a ``torch.profiler`` profile records,
  each span is also opened as a range of its name (``record_function``'s
  low-cost form), so that the profile holds the program's spans beside its
  runtime calls and kernels (``Span.mirrored``).  Each reading of the
  clock lies inside its span's range (a range opens before and closes
  after it; where one span ends as the next begins, the next range opens
  before the one reading and the first closes after it).  The profile's
  host clock is Unix time: compare the two by durations or by a linear
  fit.  What the records give is read in ``repro_torch.trace_readings``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

ON = False

_spans: List["Span"] = []
_open: List[Tuple[int, Any]] = []      # (index, its range), innermost last
_marks: Optional[List[Tuple[str, Any]]] = None     # the open collection


@dataclasses.dataclass
class Span:
    name: str
    start: float                       # s, time.perf_counter's clock
    end: Optional[float] = None
    parent: Optional[int] = None       # index in spans() of the enclosing one
    fn: str = ""
    bucket: int = 0
    slots: Tuple[int, ...] = ()
    device_s: Optional[float] = None   # joins and steps: the device interval
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    mirrored: bool = False             # opened as a profiler range too
    in_place_bytes: int = 0            # steps: slab rows addressed in place
    copied_bytes: int = 0              # steps: slab rows gathered, scattered


def enable(on: bool = True) -> None:
    """Switch the tracer; graphs capture its marks only while it is on."""
    global ON
    ON = on


def clear() -> None:
    """Drop every record (and any span left open)."""
    _spans.clear()
    _open.clear()


def spans() -> List[Span]:
    return list(_spans)


def begin(name: str, at: Optional[float] = None, **attrs: Any) -> Span:
    """Open a span inside the innermost open one, at ``at`` or, by default,
    now (read after its range opens, so that the two agree)."""
    rng = None
    if torch._C._autograd._profiler_enabled():
        # the profiler's low-cost range (no dispatcher op around it)
        rng = torch._C._profiler._RecordFunctionFast(name)
        rng.__enter__()
    span = Span(name, time.perf_counter() if at is None else at,
                parent=_open[-1][0] if _open else None,
                mirrored=rng is not None, **attrs)
    _open.append((len(_spans), rng))
    _spans.append(span)
    return span


def end(at: Optional[float] = None) -> Span:
    """Close the innermost open span at ``at`` or, by default, now (read
    before its range closes)."""
    i, rng = _open.pop()
    _spans[i].end = time.perf_counter() if at is None else at
    if rng is not None:
        rng.__exit__(None, None, None)
    return _spans[i]


def then(name: str) -> Span:
    """Close the innermost open span and open ``name``, both at one reading
    of the clock, taken after the new range opens and before the old one
    closes."""
    i, rng = _open.pop()
    span = begin(name)
    _spans[i].end = span.start
    if rng is not None:
        rng.__exit__(None, None, None)
    return span


def stamp(device: torch.device) -> Any:
    """Now on ``device``'s timeline: on the card a timing event recorded on
    the current stream (into the graph being captured, if one is); else the
    host's clock."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True,
                          external=torch.cuda.is_current_stream_capturing())
    ev.record()
    return ev


def between(a: Any, b: Any) -> float:
    """Seconds from stamp ``a`` to stamp ``b`` (both recorded and, on the
    card, completed)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


def mark(name: str, device: torch.device) -> None:
    """Begin the body's phase ``name`` (the next mark ends it), while a
    collection is open and the tracer is on."""
    if ON and _marks is not None:
        _marks.append((name, stamp(device)))


@contextlib.contextmanager
def collecting() -> Iterator[List[Tuple[str, Any]]]:
    """Gather the marks the block makes, in order."""
    global _marks
    outer, _marks = _marks, []
    try:
        yield _marks
    finally:
        _marks = outer


def phases(marks: List[Tuple[str, Any]]) -> Dict[str, float]:
    """Seconds from each mark to the next, by the first one's name, summed
    over the phases that share a name (a model's groups of one kind), in
    the order of each name's first phase; the last mark only closes the
    last phase."""
    out: Dict[str, float] = {}
    for (n, a), (_, b) in zip(marks, marks[1:]):
        out[n] = out.get(n, 0.0) + between(a, b)
    return out
