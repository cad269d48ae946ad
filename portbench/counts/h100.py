"""The NVIDIA H100 SXM's published peaks (NVIDIA's data sheet: dense rates
without sparsity, at the card's 700 W limit). Frozen here for the
benchmark; the program keeps its own copy in
``feartracker_tpu_torch/evaluate/profiling.py``."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores, dense
F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores (no TF32)
