"""decode_ms.track: Device ms a frame of the ``fear.decode`` segments of the traced graph replays
(K1's one launch), a frame being one time step of the S streams."""

from portbench.program_trace import segment_ms_per_frame

NAME = "decode_ms.track"
UNIT = "ms"
LAYER = "ops.cuda.decode"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return segment_ms_per_frame(rec, "fear.decode")
