"""setup_s: From the process's start to the start of the measured window: imports, the CUDA context,
loading or building the kernels, the model, the inputs and the warm-up."""

NAME = "setup_s"
UNIT = "s"
LAYER = "whole run"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(rec):
    return rec.get("setup_s")
