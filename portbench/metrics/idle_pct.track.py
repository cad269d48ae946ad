"""idle_pct.track: The share of the traced slice in which no kernel, copy or memset ran on the card."""

NAME = "idle_pct.track"
UNIT = "%"
LAYER = "device"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    tr = rec.get("trace")
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr else None
