"""launch_ms.pool: The median host ms a step of ``fear.step``, which in the pool runs only inside
``fear.pool.step_async``: the eager dispatch of the model's launches (and the refresh's, every
``update_interval`` steps)."""

from portbench.program_trace import median_host_ms

NAME = "launch_ms.pool"
UNIT = "ms"
LAYER = "tracker.serving"
MOVES = "step_ms_p95"
SOURCE = "host_clock"


def read(rec):
    return median_host_ms(rec, "fear.step")
