"""PyTorch/CUDA port of the BiMocq smoke engine for NVIDIA Hopper.

The package mirrors ``gpufluidsimulation_tpu``'s module names so each
function can be found beside its JAX counterpart. Plain tensor code is
PyTorch; the hot stencils and gathers of the 3D steps are hand-written
CUDA C++ kernels under ``csrc/``, built with nvcc on first use
(``ops/_build.py``). Every kernel wrapper keeps its plain PyTorch version
beside it: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.

The 3D engine is ported whole: the schemes BIMOCQ (every
``reinit_mode`` and blend; the dual, exact, vol9 and prefilter volume
forms), SEMILAG, MACCORMACK and MAC_REFLECTION, on the open box and with
moving obstacles (analytic, or voxel level sets from ``io_utils.mesh``),
analytic and voxel emitters with ``trans`` and ``emit_velocity``, the
spectral and MG-PCG projections (red-black or, with
``EngineMode(rbgs=False)``, Jacobi-smoothed V-cycles), ``step_checked``,
checkpoints in the JAX package's format (``io_utils.checkpoint``), sparse
volume output (``io_utils.volume``, ``io_utils.vdb``, the native writer
in ``native/``) and the ``sim3d`` CLI (``python -m
gpufluidsimulation_tpu_torch.cli``); ``convert`` carries configurations
and states between the two packages.

The 2D solver (``solvers/smoke2d.py``) runs the grid schemes SEMILAG,
MACCORMACK, BFECC, MAC_REFLECTION and BIMOCQ, also in the level-set mode,
and the particle schemes FLIP, APIC and POLYPIC (``solvers/particles.py``),
with the spectral or MG-PCG projection, the five examples of
``scenes/scenes2d.py`` and the ``sim2d`` CLI; every 2D sample is a launch
of the ``bilerp_sample`` kernel, the particles' P2G a launch of the
gather-form ``p2g_splat`` kernel.

The sharded step (``parallel/``) runs in one process over a mesh of
devices in which one device may repeat: the BiMocq map marches and
lattice samples go slab by slab through the slab modes of
``trilerp_sample``, ``dmc_substep`` and ``rk3_substep``, the MG smoother
through a halo exchange; between those stages the state lives whole on
the mesh's home device. ``ops/pcg.py`` (MIC(0)-PCG on the host),
``forces.diffuse_2d`` and ``core/interp.sample3_cubic`` complete the JAX
package's modules. ``EngineMode(interp_bf16=True)``, the JAX package's
bf16 field windows, runs on the 3D single-device paths through bf16
modes of four kernels (and raises with vol9, a sharded mesh and the 2D
solver); only ``particles_dense``, TPU window geometry, has no
counterpart.
"""
