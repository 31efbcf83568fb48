"""Body forces and viscosity (3D).

Counterpart of ``gpufluidsimulation_tpu.ops.forces``: ``buoyancy_3d`` in
plain torch, ``diffuse_3d`` through the ``jacobi_diffuse`` kernel
(``ops/stencil_kernels.py``).
"""

from __future__ import annotations

from gpufluidsimulation_tpu_torch.ops import stencil_kernels


def buoyancy_3d(v, rho, temperature, alpha, beta, dt):
    """v(i,j,k) += 0.5*dt*(beta*(T0+T1) - alpha*(rho0+rho1)) on the
    interior v faces (j = 1 .. nj-1)."""
    f0 = beta * temperature - alpha * rho
    v = v.clone()
    v[:, 1:-1, :] += 0.5 * dt * (f0[:, 1:, :] + f0[:, :-1, :])
    return v


def diffuse_3d(field, iters, coef):
    """Damped-Jacobi viscosity solve (I + coef*L) x = field, interior
    only, the boundary ring held."""
    return stencil_kernels.jacobi_diffuse(field, field, int(iters),
                                          float(coef))
