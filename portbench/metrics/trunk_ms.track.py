"""trunk_ms.track: Device ms a frame of the ``fear.trunk`` segments of the traced graph replays (the
folded trunk and neck: K2 and the blocks around it), a frame being one time step of the S streams."""

from portbench.program_trace import segment_ms_per_frame

NAME = "trunk_ms.track"
UNIT = "ms"
LAYER = "ops.fused_trunk"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return segment_ms_per_frame(rec, "fear.trunk")
