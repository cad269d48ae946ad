"""idle_pct.update: The share of the traced slice of sequential updates in which no kernel, copy or
memset ran on the card."""

NAME = "idle_pct.update"
UNIT = "%"
LAYER = "device"
MOVES = "step_ms_p95"
SOURCE = "device_trace"


def read(rec):
    tr = rec.get("trace")
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr else None
