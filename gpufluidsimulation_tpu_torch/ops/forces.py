"""Body forces, viscosity and the 2D vorticity.

Counterpart of ``gpufluidsimulation_tpu.ops.forces``: ``buoyancy_3d``,
``buoyancy_2d``, ``curl_2d`` and ``diffuse_2d`` in plain torch (the JAX
package computes them in XLA, with no Pallas kernel; ``diffuse_2d`` has no
caller there or here), ``diffuse_3d`` through the ``jacobi_diffuse``
kernel (``ops/stencil_kernels.py``).
"""

from __future__ import annotations

import numpy as np
import torch

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


def buoyancy_2d(v, rho, temperature, alpha, beta, dt):
    """f = 0.5*dt*(-alpha*rho - beta*T) added to the v faces from both
    adjacent cells: interior faces receive f of the cell below, then of
    the cell above; each wall face the one adjacent cell's. `dt` is taken
    in float32."""
    f = float(np.float32(0.5) * np.float32(dt)) * (-alpha * rho
                                                   - beta * temperature)
    v = v.clone()
    v[:, :-1] += f
    v[:, 1:] += f
    return v


def curl_2d(u, v, h):
    """Node vorticity curl(i, j) = (u(i,j) - u(i,j-1) + v(i-1,j) - v(i,j))/h
    on the (ni+1, nj+1) corner lattice; the boundary ring stays zero."""
    ni, nj = v.shape[0], u.shape[1]
    curl = torch.zeros((ni + 1, nj + 1), dtype=u.dtype, device=u.device)
    curl[1:ni, 1:nj] = (u[1:ni, 1:nj] - u[1:ni, 0:nj - 1]
                        + v[0:ni - 1, 1:nj] - v[1:ni, 1:nj]) / h
    return curl


def diffuse_2d(field, nu, dt, h, iters=20):
    """2D red-black Gauss-Seidel viscosity (diffuseField,
    BimocqSolver2D.cpp:1717-1757): each sweep updates the red cells ((i +
    j) even), then the black ones, to (b + coef * neighbour sum) / (1 +
    4 coef), coef = nu dt / h^2; out-of-domain neighbours contribute 0.
    The neighbours are summed in the JAX package's order (i-1, i+1, j-1,
    j+1)."""
    coef = nu * dt / (h * h)
    denom = 1.0 + 4.0 * coef
    ni, nj = field.shape
    ii = torch.arange(ni, device=field.device)[:, None]
    jj = torch.arange(nj, device=field.device)[None, :]
    red = (ii + jj) % 2 == 0
    b = field

    def nbr(x):
        px = torch.nn.functional.pad(x, (0, 0, 1, 1))
        py = torch.nn.functional.pad(x, (1, 1, 0, 0))
        return px[:-2, :] + px[2:, :] + py[:, :-2] + py[:, 2:]

    x = field
    for _ in range(int(iters)):
        x = torch.where(red, (b + coef * nbr(x)) / denom, x)
        x = torch.where(~red, (b + coef * nbr(x)) / denom, x)
    return x
