"""3D smoke solver, BiMocq main path.

Counterpart of ``gpufluidsimulation_tpu.solvers.smoke3d`` for the
configuration the benchmark runs: scheme BIMOCQ, ``reinit_mode='always'``,
``blend_coeff == 1``, no voxel boundaries, analytic sphere emitters, the
dual volume form and the spectral projection. Under that configuration the
two-level (prev) tier, the scalar advector's maps and the accumulates are
statically dead, so the state carries ``None`` for them, as the JAX
package's dieted state does. Any other configuration raises
``NotImplementedError``.

One step syncs the host once to read max|vel| (the CFL substep count is
decided on the host in float32, ops/advect.substeps) and once for the
spectral refinement branch.

TF32: building a ``Smoke3D`` sets ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` to False for the process. The JAX
transforms run at full float32 precision, and TF32 would miss the ~1e-6
relative residual of the direct spectral solve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gpufluidsimulation_tpu_torch import config
from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
from gpufluidsimulation_tpu_torch.core.grids import Grid3D
from gpufluidsimulation_tpu_torch.ops import forces, poisson
from gpufluidsimulation_tpu_torch.ops.advect import substeps
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme


@dataclasses.dataclass(frozen=True)
class Emitter3D:
    """Analytic sphere emitter: rho/T set inside `radius`, theta-modulated
    x-velocity sign*0.06*(1 + 0.01 cos 8 theta), v/w zeroed, for the first
    `emit_frames` frames. The JAX package's voxel-SDF emitters, `trans`
    and `emit_velocity` are not ported."""

    center: Tuple[float, float, float]
    radius: float = 0.015
    density: float = 1.0
    temperature: float = 50.0
    sign: float = 1.0
    emit_frames: int = 10


@dataclasses.dataclass(frozen=True)
class Smoke3DConfig:
    ni: int
    nj: int
    nk: int
    L: float                      # domain length in x (h = L/ni)
    dt: float = 0.08
    scheme: Scheme = Scheme.BIMOCQ
    viscosity: float = 1e-6
    blend_coeff: float = 1.0
    alpha: float = 0.0            # smoke drop (density weight)
    beta: float = 0.0             # smoke rise (temperature weight)
    emitters: Tuple[Emitter3D, ...] = ()
    boundaries: tuple = ()
    bc: str = "dirichlet"
    proj_tol: float = 1e-4
    proj_max_iters: int = 50
    reinit_mode: str = "always"
    vel_reinit_gap: int = 10
    scalar_reinit_gap: int = 30
    vel_distortion_limit: float = 1.0
    scalar_distortion_limit: float = 5.0

    @property
    def h(self) -> float:
        return self.L / self.ni

    @property
    def grid(self) -> Grid3D:
        return Grid3D(self.ni, self.nj, self.nk, self.h)


@dataclasses.dataclass
class Smoke3DState:
    """Fields are float32 tensors on the solver's device; counters are host
    ints. ``interp_overflow`` is always 0: the port's kernels gather
    exactly and have no displacement window to overflow. ``substeps`` is
    the port's own diagnostic: CFL substeps of the last step's marches."""

    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    u_init: torch.Tensor
    v_init: torch.Tensor
    w_init: torch.Tensor
    u_prev: Optional[torch.Tensor]
    v_prev: Optional[torch.Tensor]
    w_prev: Optional[torch.Tensor]
    rho: torch.Tensor
    rho_init: torch.Tensor
    rho_prev: Optional[torch.Tensor]
    T: torch.Tensor
    T_init: torch.Tensor
    T_prev: Optional[torch.Tensor]
    vel_map: mp.MappingState
    scalar_map: mp.MappingState
    frame: int
    vel_last_reinit: int
    scalar_last_reinit: int
    cfl: float
    proj_iters: int
    proj_res: torch.Tensor
    proj_res_hist: torch.Tensor
    interp_overflow: int = 0
    substeps: int = 0


def check_supported(cfg: Smoke3DConfig) -> None:
    """Raise NotImplementedError for any configuration the port lacks."""
    problems = []
    if cfg.scheme != Scheme.BIMOCQ:
        problems.append(f"scheme {Scheme(cfg.scheme).name} (only BIMOCQ)")
    if cfg.boundaries:
        problems.append("voxel boundaries")
    if cfg.reinit_mode != "always":
        problems.append(f"reinit_mode {cfg.reinit_mode!r} (only 'always')")
    if cfg.blend_coeff != 1.0:
        problems.append(f"blend_coeff {cfg.blend_coeff} (only 1.0)")
    if cfg.bc not in ("dirichlet", "neumann"):
        problems.append(f"bc {cfg.bc!r} (spectral projection: dirichlet "
                        "or neumann)")
    for em in cfg.emitters:
        if not isinstance(em, Emitter3D):
            problems.append(f"emitter {em!r} (analytic spheres only)")
    if problems:
        raise NotImplementedError(
            "the PyTorch port runs only the 3D BiMocq main path; "
            "unsupported: " + "; ".join(problems))


def init_state(cfg: Smoke3DConfig, device=None) -> Smoke3DState:
    g = cfg.grid

    def z(kind):
        return g.zeros(kind, device=device)

    return Smoke3DState(
        u=z("u"), v=z("v"), w=z("w"),
        u_init=z("u"), v_init=z("v"), w_init=z("w"),
        u_prev=None, v_prev=None, w_prev=None,
        rho=z("c"), rho_init=z("c"), rho_prev=None,
        T=z("c"), T_init=z("c"), T_prev=None,
        vel_map=mp.init_mapping(g, with_prev=False, device=device),
        scalar_map=mp.init_mapping(g, with_maps=False),
        # frame 0 triggers both reinit deadlines (vel -11, scalar -31)
        frame=0, vel_last_reinit=-11, scalar_last_reinit=-31,
        cfl=0.0, proj_iters=0,
        proj_res=torch.zeros((), dtype=torch.float32, device=device),
        proj_res_hist=torch.full((cfg.proj_max_iters,), -1.0,
                                 dtype=torch.float32, device=device),
    )


def _max_velocity(u, v, w) -> np.float32:
    """max |component| with the 1e-4 floor, read to the host."""
    m = torch.maximum(u.abs().max(), torch.maximum(v.abs().max(),
                                                   w.abs().max()))
    return np.float32(max(np.float32(m.item()), np.float32(1e-4)))


def _emit_smoke(cfg: Smoke3DConfig, g: Grid3D, u, v, w, rho, T, frame: int):
    """Analytic sphere emission, gated per emitter on frame < emit_frames
    (a host decision: `frame` is a host int)."""
    h = g.h
    dev = u.device
    for em in cfg.emitters:
        if not frame < em.emit_frames:
            continue
        cx, cy, cz = em.center

        def field_mask(shape, x_is_staggered):
            nx, ny, nz = shape
            ii = (torch.arange(nx, dtype=torch.float32, device=dev)
                  - (0.5 if x_is_staggered else 0.0))
            x = ii * h - cx
            y = torch.arange(ny, dtype=torch.float32, device=dev) * h - cy
            zc = torch.arange(nz, dtype=torch.float32, device=dev) * h - cz
            X = x[:, None, None]
            Y = y[None, :, None]
            Z = zc[None, None, :]
            r = torch.sqrt(X ** 2 + Y ** 2 + Z ** 2)
            band = mp._band3(shape, (1, 1, 1), (2, 2, 2), dev)
            return (r < em.radius) & band, Y, Z

        inside_u, Yu, Zu = field_mask(u.shape, True)
        hyp = torch.sqrt(Yu ** 2 + Zu ** 2)
        theta = torch.arccos(torch.clamp(
            Yu / torch.clamp(hyp, min=1e-12), -1.0, 1.0))
        vel_x = em.sign * 0.06 * (1.0 + 0.01 * torch.cos(8.0 * theta))
        u = torch.where(inside_u, vel_x + 0.0 * u, u)
        inside_v, _, _ = field_mask(v.shape, True)
        v = torch.where(inside_v, 0.0, v)
        inside_w, _, _ = field_mask(w.shape, True)
        w = torch.where(inside_w, 0.0, w)
        inside_c, _, _ = field_mask(rho.shape, False)
        rho = torch.where(inside_c, em.density, rho)
        T = torch.where(inside_c, em.temperature, T)
    return u, v, w, rho, T


def _forces_and_project(cfg, g, u, v, w, rho, T, frame, dt):
    """Emit + buoyancy + viscosity (the projection follows in the step)."""
    u, v, w, rho, T = _emit_smoke(cfg, g, u, v, w, rho, T, frame)
    v = forces.buoyancy_3d(v, rho, T, cfg.alpha, cfg.beta, dt)
    if cfg.viscosity:
        coef = cfg.viscosity * dt / (g.h * g.h)
        u = forces.diffuse_3d(u, 20, coef)
        v = forces.diffuse_3d(v, 20, coef)
        w = forces.diffuse_3d(w, 20, coef)
    return u, v, w, rho, T


def _step_bimocq(cfg: Smoke3DConfig, g: Grid3D, s: Smoke3DState) -> Smoke3DState:
    """advanceBimocq under per-frame reinitialization with blend 1."""
    dt = cfg.dt
    maxvel = _max_velocity(s.u, s.v, s.w)
    cfldt = np.float32(np.float32(g.h) / maxvel)

    # both maps are identity at step entry (reinitialized at the end of
    # every step): the backward march's first substep is the identity peel
    vel_map = mp.update_mapping_3d(s.vel_map, g, s.u, s.v, s.w, cfldt, dt,
                                   from_identity=True)
    # the scalar advector is a counter-only alias of the velocity maps
    scalar_map = s.scalar_map

    (u,) = mp.bimocq_advect_3d(g, "u", [s.u], [s.u_init], [s.u_prev],
                               vel_map.bwd, None, vel_map.fwd, None)
    (v,) = mp.bimocq_advect_3d(g, "v", [s.v], [s.v_init], [s.v_prev],
                               vel_map.bwd, None, vel_map.fwd, None)
    (w,) = mp.bimocq_advect_3d(g, "w", [s.w], [s.w_init], [s.w_prev],
                               vel_map.bwd, None, vel_map.fwd, None)
    rho, T = mp.bimocq_advect_3d(g, "c", [s.rho, s.T], [s.rho_init, s.T_init],
                                 [s.rho_prev, s.T_prev], vel_map.bwd, None,
                                 vel_map.fwd, None)

    u, v, w, rho, T = _forces_and_project(cfg, g, u, v, w, rho, T, s.frame,
                                          dt)

    u_t, v_t, w_t = u, v, w
    u, v, w, _, iters, res, hist = poisson.project_3d(
        u, v, w, cfg.bc, cfg.proj_tol, cfg.proj_max_iters)
    du_p, dv_p, dw_p = u - u_t, v - v_t, w - w_t

    vel_reinit = s.frame - s.vel_last_reinit > cfg.vel_reinit_gap
    scalar_reinit = s.frame - s.scalar_last_reinit > cfg.scalar_reinit_gap

    # reinitialize every frame; init <- current velocity plus one more
    # projection accumulate through the (identity) forward map
    vel_map = mp.reinitialize(vel_map, g)
    (u_init,) = mp.accumulate_multi_3d(g, "u", [(u, [(du_p, 1.0)])],
                                       vel_map.fwd, identity=True)
    (v_init,) = mp.accumulate_multi_3d(g, "v", [(v, [(dv_p, 1.0)])],
                                       vel_map.fwd, identity=True)
    (w_init,) = mp.accumulate_multi_3d(g, "w", [(w, [(dw_p, 1.0)])],
                                       vel_map.fwd, identity=True)
    scalar_map = mp.reinitialize(scalar_map, g)

    return dataclasses.replace(
        s, u=u, v=v, w=w, u_init=u_init, v_init=v_init, w_init=w_init,
        rho=rho, rho_init=rho, T=T, T_init=T,
        vel_map=vel_map, scalar_map=scalar_map,
        frame=s.frame + 1,
        vel_last_reinit=s.frame if vel_reinit else s.vel_last_reinit,
        scalar_last_reinit=s.frame if scalar_reinit else s.scalar_last_reinit,
        cfl=float(np.float32(maxvel * np.float32(dt)) / np.float32(g.h)),
        proj_iters=iters, proj_res=res, proj_res_hist=hist,
        interp_overflow=0, substeps=len(substeps(cfldt, dt)),
    )


class Smoke3D:
    """Driver object: the static config and its device.

    ``device=None`` runs on the card and raises when there is none; pass
    ``device="cpu"`` for the plain PyTorch versions of every kernel."""

    def __init__(self, cfg: Smoke3DConfig, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.grid = cfg.grid
        self.device = config.resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def init_state(self) -> Smoke3DState:
        return init_state(self.cfg, self.device)

    def step(self, state: Smoke3DState) -> Smoke3DState:
        return _step_bimocq(self.cfg, self.grid, state)
