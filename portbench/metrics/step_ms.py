"""Mean seconds of a decode step as the executor measured and returned
them (replay plus synchronize), over the window's steps."""
LAYER = "executor"
MOVES = "tokens_per_s"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    s = [e.seconds for e in run.events if e.kind == "step"]
    return sum(s) / len(s) * 1e3 if s else None
