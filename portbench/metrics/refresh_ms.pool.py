"""refresh_ms.pool: Device ms of the operations launched inside ``fear.refresh`` (the dual template's
candidate crop and encode, the gate and the blend), over the program's ``step.refreshes`` counter."""

NAME = "refresh_ms.pool"
UNIT = "ms"
LAYER = "tracker.runtime"
MOVES = "step_ms_p95"
SOURCE = "device_trace"


def read(rec):
    p = rec.get("program")
    got = p and p["span_device_s"].get("fear.refresh")
    n = p and p["counters"].get("step.refreshes")
    return sum(got) / n * 1e3 if got and n else None
