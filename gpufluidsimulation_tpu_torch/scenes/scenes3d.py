"""3D scenes: the vortex-ring collision and the moving obstacle.

Vortex collision: two counter-propagating sphere emitters (radius 0.015)
at (0.04, 0.2, 0.2) and (0.16, 0.201, 0.2) emitting density 1, temperature
50 and theta-modulated x-velocity +-0.06(1+0.01 cos 8 theta) for 10
frames. Moving obstacle: a sustained buoyant plume and a rigid sphere
that sweeps back and forth through it. Same defaults as
``gpufluidsimulation_tpu.scenes.scenes3d``.
"""

from __future__ import annotations

import numpy as np

from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from gpufluidsimulation_tpu_torch.solvers.smoke3d import (
    Boundary3D,
    Emitter3D,
    Smoke3D,
    Smoke3DConfig,
)


def vortex_collision_config(
    ni: int = 100,
    nj: int = 200,
    nk: int = 200,
    scheme: Scheme = Scheme.MAC_REFLECTION,
    dt: float = 0.08,
    **overrides,
) -> Smoke3DConfig:
    base = dict(
        ni=ni, nj=nj, nk=nk, L=0.2, dt=dt, scheme=scheme,
        viscosity=1e-6,
        blend_coeff=1.0,
        alpha=0.0, beta=0.0,
        emitters=(
            Emitter3D(center=(0.04, 0.2, 0.2), radius=0.015, density=1.0,
                      temperature=50.0, sign=1.0, emit_frames=10),
            Emitter3D(center=(0.16, 0.201, 0.2), radius=0.015, density=1.0,
                      temperature=50.0, sign=-1.0, emit_frames=10),
        ),
    )
    base.update(overrides)
    return Smoke3DConfig(**base)


def make_vortex_collision(scheme: Scheme = Scheme.MAC_REFLECTION,
                          device=None, **overrides):
    cfg = vortex_collision_config(scheme=scheme, **overrides)
    solver = Smoke3D(cfg, device=device)
    return solver, solver.init_state()


def sweep_trans(amplitude: float, period: float = 120.0):
    """trans(frame) of the moving-obstacle scene: a z offset
    amplitude*sin(2 pi frame/period) in the float32 arithmetic of the JAX
    scene's closure (frame arrives as ``np.float32``)."""
    f32 = np.float32

    def sweep(frame):
        angle = f32(f32(f32(2.0 * np.pi) * f32(frame)) / f32(period))
        return (0.0, 0.0, f32(f32(amplitude) * np.sin(angle)))

    return sweep


def moving_obstacle_config(
    ni: int = 64,
    nj: int = 128,
    nk: int = 128,
    scheme: Scheme = Scheme.BIMOCQ,
    dt: float | None = None,
    **overrides,
) -> Smoke3DConfig:
    """A plume emitter and a rigid sphere sweeping through it, period 120
    frames. dt defaults to 1.6/ni, which holds the developed buoyant
    plume at CFL ~1-3."""
    if dt is None:
        dt = 1.6 / ni
    L = 0.2
    h = L / ni
    ly = nj * h
    lz = nk * h
    base = dict(
        ni=ni, nj=nj, nk=nk, L=L, dt=dt, scheme=scheme,
        viscosity=1e-6, blend_coeff=1.0,
        alpha=0.1, beta=0.02,    # buoyant plume
        emitters=(
            Emitter3D(center=(0.5 * L, 0.12 * ly, 0.5 * lz), radius=0.1 * L,
                      density=1.0, temperature=50.0, sign=1.0,
                      emit_frames=10**9),
        ),
        boundaries=(
            Boundary3D(center=(0.5 * L, 0.5 * ly, 0.5 * lz), radius=0.12 * L,
                       trans=sweep_trans(0.125 * lz)),
        ),
    )
    base.update(overrides)
    return Smoke3DConfig(**base)


def make_moving_obstacle(scheme: Scheme = Scheme.BIMOCQ, device=None,
                         **overrides):
    cfg = moving_obstacle_config(scheme=scheme, **overrides)
    solver = Smoke3D(cfg, device=device)
    return solver, solver.init_state()


SCENES_3D = {0: make_vortex_collision, 1: make_moving_obstacle}


TOTAL_FRAMES = 300  # frames of the reference's 3D executable (main.cpp:34)
