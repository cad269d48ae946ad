"""PyTorch + CUDA port of the FEAR multi-stream tracker for NVIDIA Hopper.

Mirrors the layout of :mod:`feartracker_tpu` (the JAX reference) module for
module, and imports nothing from it, nor jax or flax. The two kernels of the
tracking path are CUDA C++ sources under ``csrc/``, built with ``nvcc`` at
first use (:mod:`feartracker_tpu_torch.ops.cuda.build`); each keeps a plain
PyTorch twin that runs for CPU tensors.
"""
