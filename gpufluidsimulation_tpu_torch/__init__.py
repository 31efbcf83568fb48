"""PyTorch/CUDA port of the BiMocq smoke engine for NVIDIA Hopper.

The package mirrors ``gpufluidsimulation_tpu``'s module names so each
function can be found beside its JAX counterpart. Plain tensor code is
PyTorch; the four hot stencils and gathers of the 3D BiMocq step are
hand-written CUDA C++ kernels under ``csrc/``, built with nvcc on first use
(``ops/_build.py``). Every kernel wrapper keeps its plain PyTorch version
beside it: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.

Only the 3D BiMocq step with per-frame reinitialization, blend 1, no voxel
boundaries, the dual volume form and the spectral projection is ported;
other configurations raise ``NotImplementedError``.
"""
