"""stage_ms.pool: The median host ms a step of ``fear.pool.stage``: the pinned buffer, the copy of the
host frames into it and the enqueue of its copy to the card."""

from portbench.program_trace import median_host_ms

NAME = "stage_ms.pool"
UNIT = "ms"
LAYER = "tracker.serving"
MOVES = "step_ms_p95"
SOURCE = "host_clock"


def read(rec):
    return median_host_ms(rec, "fear.pool.stage")
