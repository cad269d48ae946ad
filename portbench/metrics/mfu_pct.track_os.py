"""mfu_pct.track_os: The products a frame of one stream needs (``counts.onestream.frame_products``: the
reference's products at batch 1 at CE's token counts, and the crop's taps), times the frames of the
window, over its seconds and the H100's 989 TFLOP/s."""

NAME = "mfu_pct.track_os"
UNIT = "%"
LAYER = "whole step (tracker.runtime)"
MOVES = "frames_per_s"
SOURCE = "host_clock"


def read(rec):
    from portbench.counts.h100 import BF16_FLOPS

    w, c = rec["window"], rec.get("counts", {})
    if "frames" not in w or "products_per_frame" not in c:
        return None
    return 100.0 * c["products_per_frame"] * w["frames"] / w["seconds"] / BF16_FLOPS
