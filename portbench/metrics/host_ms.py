"""Host milliseconds per join or step that no clock of the system sees:
from one executor call's start to the next one's, less the seconds the
first call measured (its replay plus synchronize), averaged over the
window's calls.  It holds the simulator's event loop, the control plane's
and the batcher's decisions, and the executor's work outside its timed
span.  The system's clock skips all of it, so the tails do not show it;
``tokens_per_s``, over the window's wall time, does.  Pairs of calls that a
profiled slice overlaps are left out (the profiler's own cost)."""
LAYER = "host"
MOVES = "tokens_per_s"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"


def read(run):
    spans = run.slice.profiled if run.slice is not None else ()
    ev = run.events
    gaps = [b.wall - a.wall - a.seconds for a, b in zip(ev, ev[1:])
            if not any(a.wall < t1 and b.wall > t0 for t0, t1 in spans)]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None
