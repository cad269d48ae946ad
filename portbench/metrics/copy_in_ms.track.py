"""copy_in_ms.track: Device ms a frame of the operations launched inside ``fear.graph.copy_in``: the
state and the frames copied into a graph unit's static buffers before its replay."""

from portbench.program_trace import span_device_ms_per_frame

NAME = "copy_in_ms.track"
UNIT = "ms"
LAYER = "tracker.runtime"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return span_device_ms_per_frame(rec, "fear.graph.copy_in")
