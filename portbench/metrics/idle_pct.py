"""Share of the profiled slice in which no operation ran on the device."""
LAYER = "device"
MOVES = "tokens_per_s"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"


def read(run):
    if run.slice is None or run.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)
