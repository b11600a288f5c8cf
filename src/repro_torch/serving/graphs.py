"""The compiled programs of a served model: one per bucket and call.

Port of the JAX package's executables per bucket: ``ModelInstance``'s
``jax.jit`` prefill and decode (``src/repro/serving/executor.py:80-91``)
and the continuous executor's join and step per bucket (``:337-375``),
which the reference compiles inside the sandbox's set-up clock.  On the
card a program is a CUDA graph captured at set-up and replayed on every
call: one device dispatch per join or decode step, as in the reference.
``train.CompiledTrainStep`` makes the training step one such program, the
counterpart of the reference launcher's ``jax.jit(make_train_step(...))``.

A :class:`Program` holds

* its body, a plain function on tensors, called with its static inputs;
* the static input buffers, whose addresses the graph holds, and pinned
  host staging for the inputs that come from the host (prompt tokens,
  slot ids);
* its outputs, kept alive from capture on (the graph writes them on every
  replay);
* on the card, the captured graph;
* the kernel launches one replay makes;
* the marks its body made while it was captured with the tracer on
  (``trace.mark``: timing events that every replay records again).

Off the card (the CPU, as the tests run) nothing is captured: a program
runs its body through the same static buffers on every call.  On the card
a capture or replay that fails raises; nothing falls back to the body.

Capture records the launches it sees and gives the host-side counters
(``kernels.ops.launch_counts``) back as they were; each replay then adds
the captured count, so a replayed join or step counts as the eager one
did.

The programs of one function form a :class:`ProgramSet`: one side stream,
on which they warm up and are captured (PyTorch's rule for capture), and
one memory pool (``torch.cuda.graph_pool_handle``) for every graph's
scratch.  Sharing the pool is safe here: every tensor that outlives a
call (weights, caches, slabs, static buffers) is allocated before
capture and outside the pool, each program keeps its outputs alive, and
replays never overlap (each call synchronises before the next starts).
"""
from __future__ import annotations

import contextlib
import gc
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from .. import trace
from ..kernels import ops


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` captured on ``stream`` into ``pool``.
    ``CudaGraph.replays`` counts the replays of every graph."""

    replays = 0

    def __init__(self, pool: Any, stream: "torch.cuda.Stream"):
        self.graph = torch.cuda.CUDAGraph()
        self.pool, self.stream = pool, stream

    def capture(self, body: Callable[[], Any]) -> Any:
        """Record ``body`` (nothing runs); returns its outputs, which the
        graph writes on every replay.  The cycle collector is off meanwhile:
        a collection inside the capture that destroys an unreachable graph
        (an executor let go of, in a reference cycle) frees device memory,
        which a capturing stream does not permit, and the capture fails."""
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  stream=self.stream):
                return body()
        finally:
            if collecting:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()
        CudaGraph.replays += 1


def graph_for(device: torch.device) -> Optional[type]:
    """The graph that captures a program on ``device``: a CUDA graph on the
    card; none elsewhere, where a program runs its body."""
    return CudaGraph if device.type == "cuda" else None


class Program:
    """One compiled program: ``body(**inputs)`` over static buffers (see
    the module docstring).  ``runs`` counts its calls after set-up."""

    def __init__(self, body: Callable[..., Any],
                 inputs: Dict[str, torch.Tensor], host: Iterable[str] = ()):
        self.body = body
        self.inputs = inputs
        pin = next(iter(inputs.values())).is_cuda if inputs else False
        self.staging = {name: torch.empty(inputs[name].shape,
                                          dtype=inputs[name].dtype,
                                          pin_memory=pin)
                        for name in host}
        # on the card, the event after the last staged copies: the pinned
        # staging is written again only once they have drained
        self.staged = torch.cuda.Event() if pin else None
        self.outputs: Any = None
        self.graph: Any = None
        self.launches: Dict[str, int] = {}
        self.marks: List[Any] = []
        self.runs = 0

    def stage(self, **host: Any) -> None:
        """Copy ``host`` values (arrays or lists shaped as their inputs)
        through the pinned staging into the static inputs, on the current
        stream; nothing waits for the device but the previous copies."""
        if self.staged is not None:
            self.staged.synchronize()
        for name, value in host.items():
            value = np.asarray(value)
            if value.shape != tuple(self.staging[name].shape):
                raise ValueError(f"{name}: shape {value.shape}, the "
                                 f"program's input is "
                                 f"{tuple(self.staging[name].shape)}")
            self.staging[name].numpy()[...] = value
            self.inputs[name].copy_(self.staging[name], non_blocking=True)
        if self.staged is not None and host:
            self.staged.record()

    def warm_up(self) -> Any:
        """Run the body eagerly (its kernels launch and count)."""
        self.outputs = self.body(**self.inputs)
        return self.outputs

    def capture(self, graph: Any) -> None:
        """Capture the body into ``graph``; the launches it makes become
        this program's count per replay, and the counters are restored."""
        before = ops.launch_counts()
        try:
            with trace.collecting() as self.marks:
                self.outputs = graph.capture(
                    lambda: self.body(**self.inputs))
        finally:
            seen = ops.launch_counts()
            ops.set_launch_counts(before)
        self.launches = {k: seen[k] - before[k] for k in before}
        self.graph = graph

    def __call__(self, **host: Any) -> Any:
        """Stage ``host`` values (arrays or lists shaped as their inputs)
        into the static inputs, then launch.  Returns the outputs; nothing
        waits for the device but the previous call's staged copies."""
        self.stage(**host)
        return self.launch()

    def launch(self) -> Any:
        """Replay the graph, or run the body off the card, on what is
        staged; returns the outputs without waiting for the device."""
        if self.graph is None:
            self.outputs = self.body(**self.inputs)
        else:
            self.graph.replay()
            counts = ops.launch_counts()
            ops.set_launch_counts({k: n + self.launches.get(k, 0)
                                   for k, n in counts.items()})
        self.runs += 1
        return self.outputs


class ProgramSet:
    """The programs of one function: one side stream and one memory pool
    on the card (see the module docstring)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = graph_for(device)
        on_card = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if on_card else None
        self.stream = torch.cuda.Stream(device) if on_card else None
        self.programs: List[Program] = []

    def add(self, body: Callable[..., Any], inputs: Dict[str, torch.Tensor],
            host: Iterable[str] = ()) -> Program:
        prog = Program(body, inputs, host)
        self.programs.append(prog)
        return prog

    @contextlib.contextmanager
    def side_stream(self) -> Iterator[None]:
        """Run the block (the warm-up) on the side stream that captures,
        ordered after and before the current stream's work."""
        if self.stream is None:
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            yield
        cur.wait_stream(self.stream)

    def capture(self) -> None:
        """Capture every program not captured yet (none off the card)."""
        if self.graph is None:
            return
        for prog in self.programs:
            if prog.graph is None:
                prog.capture(self.graph(self.pool, self.stream))
