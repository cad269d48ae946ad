"""crop_ms.track: Device ms a frame of the ``fear.crop`` segments of the traced graph replays (the
context window, the mm crop with its f32 cast of the frames, the normalize), a frame being one time
step of the S streams; from the program's traced slice (``portbench/program_trace.py``)."""

from portbench.program_trace import segment_ms_per_frame

NAME = "crop_ms.track"
UNIT = "ms"
LAYER = "ops.crop"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return segment_ms_per_frame(rec, "fear.crop")
