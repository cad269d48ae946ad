"""frames_per_s: Frames tracked per second: every frame of every stream of every ``track`` call made in
the window, over the window's seconds (closed by a device sync)."""

NAME = "frames_per_s"
UNIT = "frames/s"
LAYER = "tracker.runtime"
MOVES = "frames_per_s"
SOURCE = "host_clock"


def read(rec):
    w = rec["window"]
    return w["frames"] / w["seconds"] if "frames" in w else None
