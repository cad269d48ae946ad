"""wait_ms.pool: The median host ms a step spends blocked in ``fear.pool.wait``, the wait for the
step's outputs to reach pinned host memory in ``PendingStep.result``."""

from portbench.program_trace import median_host_ms

NAME = "wait_ms.pool"
UNIT = "ms"
LAYER = "tracker.serving"
MOVES = "step_ms_p95"
SOURCE = "host_clock"


def read(rec):
    return median_host_ms(rec, "fear.pool.wait")
