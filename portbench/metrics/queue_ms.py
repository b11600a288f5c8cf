"""Mean queuing delay of a request in the scheduler, over all requests
(the metrics plane's per-request ``total_queuing_delay``)."""
import numpy as np

LAYER = "control plane"
MOVES = "latency_p95_ms"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    return float(np.mean(run.queuing)) * 1e3
