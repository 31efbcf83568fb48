"""3D scenes — the vortex-ring collision example.

Two counter-propagating sphere emitters (radius 0.015) at (0.04, 0.2, 0.2)
and (0.16, 0.201, 0.2) emitting density 1, temperature 50 and
theta-modulated x-velocity +-0.06(1+0.01 cos 8 theta) for 10 frames; the
same defaults as ``gpufluidsimulation_tpu.scenes.scenes3d``.
"""

from __future__ import annotations

from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from gpufluidsimulation_tpu_torch.solvers.smoke3d import Emitter3D, Smoke3DConfig


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
