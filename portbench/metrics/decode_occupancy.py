"""Mean active slots a decode tick steps: the batcher's ``n_step_slots /
n_decode_ticks`` over the window."""
LAYER = "batcher"
MOVES = "tokens_per_s"
UNIT = "slots/tick"
SOURCE = "program_counter"
BETTER = "higher"


def read(run):
    ticks = run.counters.get("n_decode_ticks", 0)
    if not ticks:
        return None
    return run.counters["n_step_slots"] / ticks
