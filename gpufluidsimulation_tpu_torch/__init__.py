"""PyTorch/CUDA port of the BiMocq smoke engine for NVIDIA Hopper.

The package mirrors ``gpufluidsimulation_tpu``'s module names so each
function can be found beside its JAX counterpart. Plain tensor code is
PyTorch; the hot stencils and gathers of the 3D steps are hand-written
CUDA C++ kernels under ``csrc/``, built with nvcc on first use
(``ops/_build.py``). Every kernel wrapper keeps its plain PyTorch version
beside it: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.

The 3D schemes BIMOCQ (every ``reinit_mode`` and blend; the dual, exact,
vol9 and prefilter volume forms), SEMILAG, MACCORMACK and MAC_REFLECTION
are ported, on the open box and with analytic moving obstacles; ``convert``
carries every volume form between the two packages. Voxel (``sdf_grid``)
boundaries and emitters and emitter ``trans``/``emit_velocity`` raise
``NotImplementedError``. The 2D solver, the CLI, I/O and the sharded step
are not ported.
"""
