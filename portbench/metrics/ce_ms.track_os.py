"""ce_ms.track_os: Device ms a frame of the ``fear.ce`` segments of the traced graph replays (at each CE
layer the centre query's softmax row, the sort and the gather of the kept tokens; then the scatter
back onto the grid), a frame being one time step of the S streams; from the program's traced slice,
which the driver's ``trace_slice`` attaches under ``"program"``."""

from portbench.program_trace import segment_ms_per_frame

NAME = "ce_ms.track_os"
UNIT = "ms"
LAYER = "models.ostrack"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return segment_ms_per_frame(rec.get("trace") or {}, "fear.ce")
