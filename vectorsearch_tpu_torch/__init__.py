"""PyTorch/CUDA port of vectorsearch_tpu for NVIDIA Hopper (H100).

The JAX package `vectorsearch_tpu` stays the reference; this package
mirrors its module names so each counterpart is easy to find. It imports
torch and never jax. The JAX-free host modules (quant, constants, native,
store, logger, config, utils.errors, embed) are reused by import.

Layers (bottom-up):
  device.py  device choice, memory budget, host conversion
  kernels/   cosine ops, the grouped bucket scan and its CUDA kernel
  csrc/      CUDA C++ sources, built with nvcc at first use
  index/     device-resident flat + IVF packed-bucket indexes
  build/     Lloyd's k-means centroid builder
  engine/    upload/search/delete orchestration
  convert.py index state carried across from the JAX package
  host.py    the shared host modules, re-exported for callers

Importing the package turns TF32 off for CUDA matmuls (device.pin_exact_f32).
"""
from .device import pin_exact_f32

pin_exact_f32()
