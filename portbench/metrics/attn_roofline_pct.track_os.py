"""attn_roofline_pct.track_os: The attention's least time over its device time in the traced slice. The
least time is the attention's products (``counts.onestream.attention_flops``: 4·N²·C a block at CE's
token counts) of the traced frames at the H100's 989 TFLOP/s; the device time is the sum of the
kernels that ``F.scaled_dot_product_attention`` launched, found by name (``ATTENTION``)."""

NAME = "attn_roofline_pct.track_os"
UNIT = "%"
LAYER = "kernels (attention)"
MOVES = "frames_per_s"
SOURCE = "device_trace"
# the names the H100's trace gives the attention's kernels: torch 2.11 routes
# bf16 SDPA to cuDNN's flash kernel ("cudnn_generated_fort_native_sdpa_sm90_
# flash_fprop_wgmma_f16_..."); FlashAttention's and the memory-efficient
# kernel's own names beside it
ATTENTION = ("_sdpa_", "flash_fwd", "fmha")


def read(rec):
    from portbench.counts.h100 import BF16_FLOPS

    tr = rec.get("trace")
    if not tr or not tr.get("attention_flops"):
        return None
    busy = sum(d for name, d in tr["kernels"] if any(a in name for a in ATTENTION))
    return 100.0 * tr["attention_flops"] / BF16_FLOPS / busy if busy > 0 else None
