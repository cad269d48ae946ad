"""dispatch_ms.pool: The median host milliseconds of a ``StreamPool.step_async`` call (staging and the
eager dispatch), from the benchmark's own span round the call."""

NAME = "dispatch_ms.pool"
UNIT = "ms"
LAYER = "tracker.serving"
MOVES = "step_ms_p95"
SOURCE = "host_clock"


def read(rec):
    d = rec["window"].get("dispatch_s")
    if not d:
        return None
    import statistics

    return statistics.median(d) * 1e3
