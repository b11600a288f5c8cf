"""Mean seconds of a join (batched prefill into the slab) as the executor
measured and returned them, over the window's joins."""
LAYER = "executor"
MOVES = "latency_p95_ms"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    s = [e.seconds for e in run.events if e.kind == "join"]
    return sum(s) / len(s) * 1e3 if s else None
