"""k2_roofline_pct: K2's least time over its device time in the traced slice. The least time is the sum
over the trunk's blocks with expansion > 1 of ``counts.products.ir_block_bound`` at the cell's
shapes, times the frames traced; the device time is the sum of the kernels whose name holds
``ir_block``."""

NAME = "k2_roofline_pct"
UNIT = "%"
LAYER = "kernels (K2)"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    k2 = sum(d for name, d in tr["kernels"] if "ir_block" in name)
    return 100.0 * tr["k2_least_s"] / k2 if k2 > 0 else None
