"""PyTorch/CUDA port of the RT-NeRF reproduction (`src/repro/` is the JAX
reference it is held against).

The module layout mirrors `repro`: `configs`, `core` (codec, field,
renderer), `kernels` (hand-written CUDA kernels for Hopper, each beside
its plain PyTorch version), `models`, `serving`. Entry points take an
explicit `device=`; they run on `cuda` unless the caller asks for the CPU
(`device.resolve_device`).
"""
