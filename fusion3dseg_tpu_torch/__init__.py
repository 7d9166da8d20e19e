"""fusion3dseg_tpu_torch: the PyTorch + CUDA port of fusion3dseg_tpu.

The JAX package `fusion3dseg_tpu` is the reference; this package keeps its
layout and function names (`geometry/`, `ops/`, `io/`, `models/`,
`pipeline/`, `utils/`) and runs on an
NVIDIA GPU, with each Pallas TPU kernel rewritten as a hand-written CUDA
kernel (`csrc/`). It imports torch and numpy only. Entry points run on
`device="cuda"` unless the caller passes `device="cpu"`.
"""
