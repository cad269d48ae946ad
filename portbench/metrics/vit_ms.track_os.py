"""vit_ms.track_os: Device ms a frame of the ``fear.vit`` segments of the traced graph replays (the
patch embedding and the joint ViT blocks between the CE layers, through the final LayerNorm), a frame
being one time step of the S streams; from the program's traced slice, which the driver's
``trace_slice`` attaches under ``"program"``."""

from portbench.program_trace import segment_ms_per_frame

NAME = "vit_ms.track_os"
UNIT = "ms"
LAYER = "models.ostrack"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    return segment_ms_per_frame(rec.get("trace") or {}, "fear.vit")
