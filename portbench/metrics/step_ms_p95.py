"""step_ms_p95: The 95th percentile, over every step of the window, of a live-pool step's latency: from
handing the step's host frames to ``StreamPool.step_async`` to the return of its
``PendingStep.result()``."""

NAME = "step_ms_p95"
UNIT = "ms"
LAYER = "tracker.serving"
MOVES = "step_ms_p95"
SOURCE = "host_clock"


def read(rec):
    lat = rec["window"].get("latencies_s")
    if not lat:
        return None
    import numpy as np

    return float(np.percentile(np.asarray(lat) * 1e3, 95))
