"""head_ms.track: Device ms a frame of the ``fear.head`` segments of the traced graph replays (the
BoxTower head against the template), a frame being one time step of the S streams."""

from portbench.program_trace import segment_ms_per_frame

NAME = "head_ms.track"
UNIT = "ms"
LAYER = "models.blocks"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return segment_ms_per_frame(rec, "fear.head")
