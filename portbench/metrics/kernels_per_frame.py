"""kernels_per_frame: Device kernels in the traced slice over its frames, a frame being one time step
of all S streams."""

NAME = "kernels_per_frame"
UNIT = "kernels/frame"
LAYER = "tracker.runtime"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    tr = rec.get("trace")
    return len(tr["kernels"]) / tr["steps"] if tr and tr.get("steps") else None
