"""The five 2D examples of the reference's executable (bimocq2D/main.cpp),
parameter for parameter.

Counterpart of ``gpufluidsimulation_tpu.scenes.scenes2d``. The initial
fields are computed in numpy as there and carried to the solver's
device; the Taylor vortex and leapfrog inits solve for the stream
function with the port's MG-PCG (a Dirichlet 2D ``mgpcg`` to 1e-6 in at
most 400 iterations).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gpufluidsimulation_tpu_torch.core.grids import Grid2D
from gpufluidsimulation_tpu_torch.ops import poisson
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme
from gpufluidsimulation_tpu_torch.solvers.smoke2d import (
    Smoke2D, Smoke2DConfig, apply_velocity_boundary)
from gpufluidsimulation_tpu_torch.utils.tree import fresh_buffers

_PARTICLE_SCHEMES = (Scheme.FLIP, Scheme.APIC, Scheme.POLYPIC)


def _solve_stream_function(grid: Grid2D, curl_nodes, device=None):
    """(u, v) from node vorticity: solve the Dirichlet Poisson problem
    L psi = curl on the cell indices (unscaled L, so psi is the
    reference's psi / h^2), then u = d(psi)/dy, v = -d(psi)/dx as face
    differences times h."""
    ni, nj = grid.ni, grid.nj
    h = grid.h
    rhs = torch.as_tensor(np.asarray(curl_nodes, np.float32)[:ni, :nj],
                          device=device).contiguous()
    ctx = poisson.MGContext((ni, nj), "dirichlet", device)
    psi_unscaled, _, _, _ = poisson.mgpcg(rhs, ctx, tol=1e-6, max_iters=400)
    psi = torch.zeros((ni + 1, nj + 1), dtype=torch.float32, device=device)
    psi[:ni, :nj] = psi_unscaled
    u = (psi[:ni + 1, 1:nj + 1] - psi[:ni + 1, :nj]) * h
    v = -(psi[1:ni + 1, :nj + 1] - psi[:ni, :nj + 1]) * h
    return u, v


def _gaussian_vortex_pair_curl(grid, distance):
    """Taylor-vortex pair curl on the (ni+1, nj+1) node lattice."""
    ni, nj = grid.ni, grid.nj
    x = np.arange(ni + 1)[:, None] * grid.h - math.pi
    y = np.arange(nj + 1)[None, :] * grid.h - math.pi
    r0 = (x + 0.5 * distance) ** 2 + y**2
    r1 = (x - 0.5 * distance) ** 2 + y**2
    curl = (1.0 / 0.3) * (2.0 - r0 / 0.09) * np.exp(0.5 * (1.0 - r0 / 0.09))
    curl += (1.0 / 0.3) * (2.0 - r1 / 0.09) * np.exp(0.5 * (1.0 - r1 / 0.09))
    return curl.astype(np.float32)


def _on(solver, a):
    """A numpy array as a float32 tensor on the solver's device."""
    return torch.as_tensor(np.array(a, dtype=np.float32, order="C"),
                           device=solver.device)


def init_taylor_vortex(solver: Smoke2D, state, distance=0.81):
    """The Taylor vortex pair; returns (state, max |curl|)."""
    curl = _gaussian_vortex_pair_curl(solver.grid, distance)
    u, v = _solve_stream_function(solver.grid, curl, solver.device)
    return fresh_buffers(dataclasses.replace(
        state, u=u, v=v, u_init=u, v_init=v, u_origin=u, v_origin=v
    )), float(np.abs(curl).max())


def init_leapfrog(solver: Smoke2D, state, dist_a=1.5, dist_b=3.0,
                  rho_h=math.pi - 1.6, rho_w=0.3):
    """Four Gaussian vortices and a smoke strip; returns (state, max
    |curl|)."""
    grid = solver.grid
    ni, nj = grid.ni, grid.nj
    a = 0.02
    x = np.arange(ni + 1)[:, None] * grid.h - math.pi
    y = np.arange(nj + 1)[None, :] * grid.h - math.pi
    curl = np.zeros((ni + 1, nj + 1), np.float32)
    for cx, sgn in ((-0.5 * dist_a, 1.0), (0.5 * dist_a, -1.0),
                    (-0.5 * dist_b, 1.0), (0.5 * dist_b, -1.0)):
        r2 = (x - cx) ** 2 + (y + 2.0) ** 2
        curl += sgn * (1000.0 / (2.0 * math.pi)) * np.exp(-0.5 * r2 / (a * a))
    u, v = _solve_stream_function(grid, curl, solver.device)
    xc = (np.arange(ni)[:, None] + 0.5) * grid.h
    yc = (np.arange(nj)[None, :] + 0.5) * grid.h
    strip = ((yc > rho_h - rho_w) & (yc < rho_h + rho_w)
             & (xc > rho_w) & (xc < 2 * math.pi - rho_w))
    rho = _on(solver, np.broadcast_to(strip, (ni, nj)))
    return fresh_buffers(dataclasses.replace(
        state, u=u, v=v, u_init=u, v_init=v, u_origin=u, v_origin=v,
        rho=rho, rho_init=rho, rho_orig=rho,
    )), float(np.abs(curl).max())


def init_rayleigh_taylor(solver: Smoke2D, state, layer_height):
    """Heavy fluid (rho) above the perturbed interface, light (T) below."""
    grid = solver.grid
    ni, nj = grid.ni, grid.nj
    x = (np.arange(ni)[:, None] + 0.5) * grid.h
    y = (np.arange(nj)[None, :] + 0.5) * grid.h
    perturb = layer_height + 0.05 * np.cos(10 * math.pi * x)
    heavy = (y >= perturb).astype(np.float32)
    rho = _on(solver, np.broadcast_to(heavy, (ni, nj)))
    T = _on(solver, np.broadcast_to(1.0 - heavy, (ni, nj)))
    return fresh_buffers(dataclasses.replace(
        state, rho=rho, rho_init=rho, rho_orig=rho, T=T, T_init=T, T_orig=T))


def init_zalesak(solver: Smoke2D, state):
    """Slotted-disk level set in rho and a rigid rotation (period 628)."""
    grid = solver.grid
    ni, nj = grid.ni, grid.nj
    h = grid.h
    r = 0.1 * ni * h
    cx, cy = 0.5 * ni * h, 0.65 * ni * h
    width, height = 0.04 * ni * h, 0.20 * ni * h
    rx, ry = 0.5 * ni * h, 0.6 * ni * h

    x = (np.arange(ni)[:, None] + 0.5) * h
    y = (np.arange(nj)[None, :] + 0.5) * h
    circle = np.sqrt((x - cx) ** 2 + (y - cy) ** 2) - r
    px = np.abs(x - rx) - 0.5 * width
    py = np.abs(y - ry) - 0.5 * height
    outside = np.sqrt(np.maximum(px, 0) ** 2 + np.maximum(py, 0) ** 2)
    rect = outside + np.minimum(np.maximum(px, py), 0.0)
    sdf = np.maximum(circle, -rect).astype(np.float32)
    sdf = np.broadcast_to(sdf, (ni, nj)).astype(np.float32)

    yu = (np.arange(nj)[None, :] + 0.5) * h
    u = np.broadcast_to(math.pi * (0.5 * ni * h - yu) / 314.0, (ni + 1, nj))
    xv = (np.arange(ni)[:, None] + 0.5) * h
    v = np.broadcast_to(math.pi * (xv - 0.5 * ni * h) / 314.0, (ni, nj + 1))
    u, v = _on(solver, u), _on(solver, v)
    rho = _on(solver, sdf)
    return fresh_buffers(dataclasses.replace(
        state, rho=rho, rho_init=rho, rho_orig=rho,
        u=u, v=v, u_init=u, v_init=v, u_origin=u, v_origin=v))


def init_vortex_box(solver: Smoke2D, state):
    """Circle level set and a normalized single vortex."""
    grid = solver.grid
    ni, nj = grid.ni, grid.nj
    h = grid.h
    r = 0.15 * ni * h
    cx, cy = 0.5 * ni * h, 0.75 * ni * h
    x = (np.arange(ni)[:, None] + 0.5) * h
    y = (np.arange(nj)[None, :] + 0.5) * h
    sdf = (np.sqrt((x - cx) ** 2 + (y - cy) ** 2) - r).astype(np.float32)
    sdf = np.broadcast_to(sdf, (ni, nj)).astype(np.float32)
    xn = x / (ni * h)
    yn = y / (nj * h)
    tmp_x = (-2.0 * np.sin(math.pi * xn) ** 2 * np.sin(math.pi * yn)
             * np.cos(math.pi * yn))
    tmp_y = (2.0 * np.sin(math.pi * xn) * np.cos(math.pi * xn)
             * np.sin(math.pi * yn) ** 2)
    normalize = float(np.sqrt(tmp_x**2 + tmp_y**2).max())

    xu = np.arange(ni + 1)[:, None] * h / (ni * h)
    yu = (np.arange(nj)[None, :] + 0.5) * h / (nj * h)
    u = (-2.0 * np.sin(math.pi * xu) ** 2 * np.sin(math.pi * yu)
         * np.cos(math.pi * yu))
    u = np.broadcast_to(u / normalize, (ni + 1, nj)).astype(np.float32)
    xv = (np.arange(ni)[:, None] + 0.5) * h / (ni * h)
    yv = np.arange(nj + 1)[None, :] * h / (nj * h)
    v = (2.0 * np.sin(math.pi * xv) * np.cos(math.pi * xv)
         * np.sin(math.pi * yv) ** 2)
    v = np.broadcast_to(v / normalize, (ni, nj + 1)).astype(np.float32)
    rho = _on(solver, sdf)
    return fresh_buffers(dataclasses.replace(
        state, rho=rho, rho_init=rho, rho_orig=rho, u=_on(solver, u),
        v=_on(solver, v)))


# ---------------------------------------------------------------------------
# Scene registry: argv example id -> (config, init, frame policy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Scene2D:
    name: str
    cfg: Smoke2DConfig
    init: Callable             # (solver, state) -> state
    dt: Optional[float]        # fixed dt, or None for CFL-driven substepping
    cfl_number: Optional[float]
    frame_dt: Optional[float]  # outer frame duration for CFL-driven scenes
    total_frames: int
    output: str                # 'vorticity' | 'density' | 'levelset'


def _leapfrog_init(solver, state):
    state, _ = init_leapfrog(solver, state)
    u, v = apply_velocity_boundary(solver.grid, state.u, state.v)
    return dataclasses.replace(state, u=u, v=v)


def make_scene_2d(example: int, scheme: Scheme) -> Scene2D:
    """The example table of bimocq2D/main.cpp."""
    if example == 0:
        cfg = Smoke2DConfig(ni=256, nj=256, L=2 * math.pi, scheme=scheme,
                            blend_coeff=1.0, pure_neumann=False)
        return Scene2D("2D_Taylor_vortex", cfg,
                       lambda s, st: init_taylor_vortex(s, st, 0.81)[0],
                       dt=0.025, cfl_number=None, frame_dt=None,
                       total_frames=300, output="vorticity")
    if example == 1:
        cfg = Smoke2DConfig(ni=256, nj=256, L=2 * math.pi, scheme=scheme,
                            blend_coeff=1.0, pure_neumann=False)
        return Scene2D("2D_Leapfrog", cfg, _leapfrog_init, dt=0.025,
                       cfl_number=None, frame_dt=None, total_frames=2000,
                       output="vorticity")
    if example == 2:
        cfg = Smoke2DConfig(ni=256, nj=1280, L=0.2, scheme=scheme,
                            blend_coeff=1.0, pure_neumann=True,
                            alpha=0.2, beta=0.05)
        layer = 0.5 * 0.2 * 1280 / 256
        return Scene2D("2D_RayleighTaylor", cfg,
                       lambda s, st: init_rayleigh_taylor(s, st, layer),
                       dt=0.01, cfl_number=None, frame_dt=None,
                       total_frames=1000, output="density")
    if example == 3:
        cfg = Smoke2DConfig(ni=200, nj=200, L=1.0, scheme=scheme,
                            blend_coeff=1.0, pure_neumann=True,
                            advect_levelset=True)
        if scheme in _PARTICLE_SCHEMES:
            raise ValueError("Simulation scheme for levelset is not supported")
        return Scene2D("2D_Zalesak", cfg, init_zalesak, dt=None,
                       cfl_number=0.75, frame_dt=2.0, total_frames=315,
                       output="levelset")
    if example == 4:
        cfg = Smoke2DConfig(ni=512, nj=512, L=1.0, scheme=scheme,
                            blend_coeff=1.0, pure_neumann=True,
                            advect_levelset=True)
        if scheme in _PARTICLE_SCHEMES:
            raise ValueError("Simulation scheme for levelset is not supported")
        return Scene2D("2D_VortexBox", cfg, init_vortex_box, dt=None,
                       cfl_number=0.5, frame_dt=0.01, total_frames=500,
                       output="levelset")
    raise ValueError(f"unknown 2D example {example}")


SCENES_2D: Dict[int, str] = {
    0: "2D_Taylor_vortex",
    1: "2D_Leapfrog",
    2: "2D_RayleighTaylor",
    3: "2D_Zalesak",
    4: "2D_VortexBox",
}
