"""2D MAC-grid smoke and level-set solver: all eight schemes.

Counterpart of ``gpufluidsimulation_tpu.solvers.smoke2d``: SEMILAG,
MACCORMACK, BFECC, MAC_REFLECTION and BIMOCQ (the two-level blended
pull-back with its velocity and scalar remaps and the reflection-style
average with the pre-advection field), each with the level-set mode
(``advect_levelset``: rho alone is advected, no projection), and the
particle schemes FLIP, APIC and POLYPIC (``solvers/particles.py``). The
projection is the direct spectral solve (the accelerator default) or,
with ``EngineMode(spectral_poisson=False)``, MG-PCG with the 2D V-cycle.
Every 2D sample goes through the ``bilerp_sample`` kernel
(``ops/interp_fast.py``); the particle schemes' P2G through the
``p2g_splat`` kernel and their calculateCp through ``bilerp_sample``'s cp
mode. The particle schemes compute the JAX package's flat, exact
transfer (its ``particle_dense`` accelerator path computes the same
function inside its slot contract), so their ``interp_overflow`` stays
as it came in, 0 from ``init_state``, as on the JAX flat path.

The time step is per call (``step(state, dt)``), as in the JAX package,
whose CFL-driven scenes vary it; it is taken in float32. Host syncs per
step: one to read the positive velocity max (its float32 CFL substep
decides every march's schedule on the host, ops/advect.substeps); the
projection's (one for the spectral refinement branch, one per CG
iteration of MG-PCG; MAC_REFLECTION projects twice); and for BIMOCQ one
more, which reads the two map distortions and the two velocity maxima
that decide the remaps (the JAX step's ``lax.cond`` branches become host
branches) and give the step's CFL number.

In 2D the external force changes v alone and nothing is emitted, so the
force deltas of u, rho and T are zero by construction: the JAX step's
accumulates of them add exact zeros and are not evaluated here.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch

from gpufluidsimulation_tpu_torch import config
from gpufluidsimulation_tpu_torch.bimocq import mapping as mp
from gpufluidsimulation_tpu_torch.core.grids import Grid2D
from gpufluidsimulation_tpu_torch.ops import advect, forces, interp_fast, poisson
from gpufluidsimulation_tpu_torch.ops.advect import substeps
from gpufluidsimulation_tpu_torch.solvers import particles as part
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme

_PARTICLE_SCHEMES = (Scheme.FLIP, Scheme.APIC, Scheme.POLYPIC)


@dataclasses.dataclass(frozen=True)
class Smoke2DConfig:
    ni: int
    nj: int
    L: float                     # domain length in x; h = L/ni
    scheme: Scheme = Scheme.BIMOCQ
    blend_coeff: float = 1.0
    particles_per_cell_axis: int = 4
    pure_neumann: bool = False
    alpha: float = 0.0           # smoke_rise
    beta: float = 0.0            # smoke_drop
    advect_levelset: bool = False
    proj_tol: float = 1e-6
    proj_max_iters: int = 500
    vel_remap_gap: int = 8
    rho_remap_gap: int = 20
    flip_ratio: float = 0.99
    engine_mode: Optional[config.EngineMode] = None

    @property
    def h(self) -> float:
        return self.L / self.ni

    @property
    def grid(self) -> Grid2D:
        return Grid2D(self.ni, self.nj, self.h)

    @property
    def bc(self) -> str:
        return "neumann" if self.pure_neumann else "dirichlet"


@dataclasses.dataclass
class Smoke2DState:
    """Fields are float32 tensors on the solver's device (the JAX state's
    field order); counters are host ints and ``cfl`` a host float.
    ``interp_overflow`` is always 0: the port's kernels gather exactly and
    its particle transfer has no slot cap.
    ``substeps`` is the port's own diagnostic: CFL substeps of the last
    step's traces."""

    u: torch.Tensor
    v: torch.Tensor
    u_temp: torch.Tensor          # reflection-blend memory (BIMOCQ)
    v_temp: torch.Tensor
    rho: torch.Tensor
    T: torch.Tensor
    u_init: torch.Tensor
    v_init: torch.Tensor
    u_origin: torch.Tensor
    v_origin: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor
    du_prev: torch.Tensor
    dv_prev: torch.Tensor
    rho_init: torch.Tensor
    rho_orig: torch.Tensor
    drho: torch.Tensor
    drho_prev: torch.Tensor
    T_init: torch.Tensor
    T_orig: torch.Tensor
    dT: torch.Tensor
    dT_prev: torch.Tensor
    vel_map: mp.MappingState
    scalar_map: mp.MappingState
    particles: part.ParticleState
    frame: int
    last_remeshing: int
    rho_last_remeshing: int
    total_resample_count: int
    total_scalar_resample: int
    cfl: float
    proj_iters: int
    proj_res: torch.Tensor
    interp_overflow: int = 0
    substeps: int = 0


def check_supported(cfg: Smoke2DConfig) -> None:
    """Raise NotImplementedError for a configuration the port lacks."""
    if cfg.engine_mode is not None and not isinstance(cfg.engine_mode,
                                                      config.EngineMode):
        raise NotImplementedError(f"engine_mode {cfg.engine_mode!r} (the "
                                  "port's config.EngineMode only)")
    if cfg.engine_mode is not None and cfg.engine_mode.interp_bf16:
        raise NotImplementedError(
            "interp_bf16=True in the 2D solver: the bf16 mode of "
            "bilerp_sample, whose samples the JAX package rounds, is not "
            "ported")


def init_state(cfg: Smoke2DConfig, device=None) -> Smoke2DState:
    """Zero fields, identity maps, and for the particle schemes the
    seeded particles (``particles_per_cell_axis`` squared a cell)."""
    g = cfg.grid

    def z(kind):
        return g.zeros(kind, device=device)

    return Smoke2DState(
        u=z("u"), v=z("v"), u_temp=z("u"), v_temp=z("v"),
        rho=z("c"), T=z("c"),
        u_init=z("u"), v_init=z("v"), u_origin=z("u"), v_origin=z("v"),
        du=z("u"), dv=z("v"), du_prev=z("u"), dv_prev=z("v"),
        rho_init=z("c"), rho_orig=z("c"), drho=z("c"), drho_prev=z("c"),
        T_init=z("c"), T_orig=z("c"), dT=z("c"), dT_prev=z("c"),
        vel_map=mp.init_mapping(g, device=device),
        scalar_map=mp.init_mapping(g, device=device),
        particles=(part.seed_particles(g, cfg.particles_per_cell_axis, device)
                   if cfg.scheme in _PARTICLE_SCHEMES
                   else part.ParticleState.empty(device)),
        frame=0, last_remeshing=0, rho_last_remeshing=0,
        total_resample_count=0, total_scalar_resample=0,
        cfl=0.0, proj_iters=0,
        proj_res=torch.zeros((), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def max_vel(u, v):
    """The positive max over the raw entries + 1e-5 (maxVel: NOT the
    absolute value), a 0-dim tensor."""
    return torch.maximum(u.max(), v.max()) + 1e-5


def _host_max_vel(u, v) -> np.float32:
    """``max_vel`` read to the host (one sync)."""
    return np.float32(max_vel(u, v).item())


def _cfl(maxvel, dt, h) -> float:
    return float(np.float32(np.float32(maxvel) * np.float32(dt))
                 / np.float32(h))


def apply_velocity_boundary(g: Grid2D, u, v):
    """Zero the two face columns at each wall."""
    u, v = u.clone(), v.clone()
    u[0:2] = 0.0
    u[g.ni - 1:g.ni + 1] = 0.0
    v[:, 0:2] = 0.0
    v[:, g.nj - 1:g.nj + 1] = 0.0
    return u, v


def _project(cfg, g, ctx, u, v):
    """applyVelocityBoundary + projection + re-apply."""
    u, v = apply_velocity_boundary(g, u, v)
    u, v, _, iters, res = poisson.project_2d(u, v, cfg.bc, cfg.proj_tol,
                                             cfg.proj_max_iters, ctx=ctx)
    u, v = apply_velocity_boundary(g, u, v)
    return u, v, iters, res


def _buoyancy_project(cfg, g, ctx, u, v, rho, T, dt):
    v = forces.buoyancy_2d(v, rho, T, cfg.alpha, cfg.beta, dt)
    return _project(cfg, g, ctx, u, v)


# ---------------------------------------------------------------------------
# Scheme steps (each: (cfg, g, ctx, state, dt) -> state)
# ---------------------------------------------------------------------------


def _step_highorder(cfg, g, ctx, s, dt, multi):
    """advanceMaccormack / advanceBFECC, and advanceSemilag through the
    same steps: `multi` advects same-kind fields sharing their traces
    (rho with T)."""
    mv = _host_max_vel(s.u, s.v)
    cfldt = np.float32(np.float32(g.h) / mv)
    subs = len(substeps(cfldt, dt))
    if cfg.advect_levelset:
        (rho,) = multi(g, "c", [s.rho], s.u, s.v, cfldt, dt)
        return dataclasses.replace(s, rho=rho, frame=s.frame + 1,
                                   substeps=subs)
    rho, T = multi(g, "c", [s.rho, s.T], s.u, s.v, cfldt, dt)
    (u,) = multi(g, "u", [s.u], s.u, s.v, cfldt, dt)
    (v,) = multi(g, "v", [s.v], s.u, s.v, cfldt, dt)
    u, v, iters, res = _buoyancy_project(cfg, g, ctx, u, v, rho, T, dt)
    return dataclasses.replace(
        s, u=u, v=v, rho=rho, T=T, frame=s.frame + 1, cfl=_cfl(mv, dt, g.h),
        proj_iters=iters, proj_res=res, substeps=subs)


def _step_semilag(cfg, g, ctx, s, dt):
    return _step_highorder(cfg, g, ctx, s, dt, advect.semilag_multi_2d)


def _step_reflection(cfg, g, ctx, s, dt):
    """advanceReflection: MacCormack scalars over dt; half-step velocity
    MacCormack, buoyancy and projection; reflect u* = 2u - u_hat; advect
    the reflected field another half step (traced in it), buoyancy and
    projection again."""
    mv = _host_max_vel(s.u, s.v)
    cfldt = np.float32(np.float32(g.h) / mv)
    subs = len(substeps(cfldt, dt))
    if cfg.advect_levelset:
        (rho,) = advect.maccormack_multi_2d(g, "c", [s.rho], s.u, s.v, cfldt,
                                            dt)
        return dataclasses.replace(s, rho=rho, frame=s.frame + 1,
                                   substeps=subs)
    rho, T = advect.maccormack_multi_2d(g, "c", [s.rho, s.T], s.u, s.v,
                                        cfldt, dt)
    half = np.float32(np.float32(0.5) * dt)
    u = advect.maccormack_2d(g, "u", s.u, s.u, s.v, cfldt, half)
    v = advect.maccormack_2d(g, "v", s.v, s.u, s.v, cfldt, half)
    v = forces.buoyancy_2d(v, rho, T, cfg.alpha, cfg.beta, half)
    u_save, v_save = u, v
    u, v, it1, res1 = _project(cfg, g, ctx, u, v)
    ru = 2.0 * u - u_save
    rv = 2.0 * v - v_save
    u = advect.maccormack_2d(g, "u", ru, ru, rv, cfldt, half)
    v = advect.maccormack_2d(g, "v", rv, ru, rv, cfldt, half)
    v = forces.buoyancy_2d(v, rho, T, cfg.alpha, cfg.beta, half)
    u, v, it2, res2 = _project(cfg, g, ctx, u, v)
    return dataclasses.replace(
        s, u=u, v=v, rho=rho, T=T, frame=s.frame + 1, cfl=_cfl(mv, dt, g.h),
        proj_iters=it1 + it2, proj_res=torch.maximum(res1, res2),
        substeps=subs)


def _step_bimocq(cfg, g, ctx, s, dt):
    """advanceBIMOCQ: both maps marched, the semi-Lagrangian fallbacks,
    the two-level pull-back and the correction, buoyancy and projection,
    the deltas accumulated through the forward maps, the remaps decided
    by distortion or frame gap, and the average with the pre-advection
    field (from frame 1 on)."""
    mv = _host_max_vel(s.u, s.v)
    cfldt = np.float32(np.float32(g.h) / mv)
    lvl = cfg.advect_levelset
    blend = cfg.blend_coeff

    # un-average the reflection blend of the previous frame
    u0, v0 = ((s.u_temp, s.v_temp) if not lvl and s.frame != 0
              else (s.u, s.v))
    vel_map = (s.vel_map if lvl
               else mp.update_mapping_2d(s.vel_map, g, u0, v0, cfldt, dt))
    scalar_map = mp.update_mapping_2d(s.scalar_map, g, u0, v0, cfldt, dt)

    semi_rho, semi_T = advect.semilag_multi_2d(g, "c", [s.rho, s.T], u0, v0,
                                               cfldt, dt)
    if not lvl:
        semi_u = advect.semilag_2d(g, "u", u0, u0, v0, None, cfldt, dt)
        semi_v = advect.semilag_2d(g, "v", v0, u0, v0, None, cfldt, dt)
        u = mp.advect_bimocq_2d(g, "u", semi_u, s.u_init, s.u_origin, s.du,
                                s.du_prev, vel_map.bwd, vel_map.bwd_prev,
                                blend)
        v = mp.advect_bimocq_2d(g, "v", semi_v, s.v_init, s.v_origin, s.dv,
                                s.dv_prev, vel_map.bwd, vel_map.bwd_prev,
                                blend)
        u = mp.correct_2d(g, "u", u, s.u_init, s.du, vel_map.fwd,
                          vel_map.bwd)
        v = mp.correct_2d(g, "v", v, s.v_init, s.dv, vel_map.fwd,
                          vel_map.bwd)
    else:
        u, v = u0, v0
    rho, T = mp.advect_bimocq_multi_2d(
        g, "c", [semi_rho, semi_T], [s.rho_init, s.T_init],
        [s.rho_orig, s.T_orig], [s.drho, s.dT], [s.drho_prev, s.dT_prev],
        scalar_map.bwd, scalar_map.bwd_prev, blend)
    if not lvl:
        rho, T = mp.correct_multi_2d(g, "c", [rho, T], [s.rho_init, s.T_init],
                                     [s.drho, s.dT], scalar_map.fwd,
                                     scalar_map.bwd)

    v_before = v
    v = forces.buoyancy_2d(v, rho, T, cfg.alpha, cfg.beta, dt)
    dv_temp = v - v_before
    u_save, v_save = u, v
    if not lvl:
        u, v, iters, res = _project(cfg, g, ctx, u, v)
    else:
        iters = 0
        res = torch.zeros((), dtype=torch.float32, device=u.device)

    # the reflection-style average with the pre-advection field; it does
    # not depend on the remaps, so its velocity max joins their one read
    u_out, v_out = u, v
    if not lvl and s.frame != 0:
        u_out, v_out = 0.5 * (u0 + u), 0.5 * (v0 + v)
    d_vel, d_scalar, vel, vel_out = (np.float32(x) for x in torch.stack([
        mp.estimate_distortion_2d(g, vel_map.bwd, vel_map.fwd),
        mp.estimate_distortion_2d(g, scalar_map.bwd, scalar_map.fwd),
        max_vel(u, v), max_vel(u_out, v_out)]).cpu().numpy())
    with np.errstate(divide="ignore", invalid="ignore"):
        vdt = np.float32(vel * dt)
        vel_remap = (bool(np.float32(d_vel / vdt) > 1.0)
                     or s.frame - s.last_remeshing >= cfg.vel_remap_gap)
        rho_remap = (bool(np.float32(d_scalar / vdt) > 1.0)
                     or s.frame - s.rho_last_remeshing >= cfg.rho_remap_gap)
    proj_coeff = 1.0 if vel_remap else 2.0

    du, dv, drho, dT = s.du, s.dv, s.drho, s.dT
    if not lvl:
        du_proj, dv_proj = u - u_save, v - v_save
        (du,) = mp.accumulate_multi_2d(
            g, "u", [(du, [(du_proj, proj_coeff)])], vel_map.fwd)
        (dv,) = mp.accumulate_multi_2d(
            g, "v", [(dv, [(dv_temp, 1.0), (dv_proj, proj_coeff)])],
            vel_map.fwd)

    # velocity remap (resampleVelBuffer)
    u_init, v_init, u_origin, v_origin = s.u_init, s.v_init, s.u_origin, \
        s.v_origin
    du_prev, dv_prev = s.du_prev, s.dv_prev
    total_resample = s.total_resample_count
    if vel_remap and not lvl:
        vel_map = mp.reinitialize(vel_map, g)
        u_origin, v_origin = s.u_init, s.v_init
        u_init, v_init = u, v
        du_prev, dv_prev = du, dv
        du = mp.accumulate_2d(g, "u", torch.zeros_like(du), du_proj,
                              vel_map.fwd, proj_coeff)
        dv = mp.accumulate_2d(g, "v", torch.zeros_like(dv), dv_proj,
                              vel_map.fwd, proj_coeff)
        total_resample += 1

    # scalar remap (resampleRhoBuffer)
    rho_init, T_init, rho_orig, T_orig = s.rho_init, s.T_init, s.rho_orig, \
        s.T_orig
    drho_prev, dT_prev = s.drho_prev, s.dT_prev
    total_scalar = s.total_scalar_resample
    if rho_remap:
        scalar_map = mp.reinitialize(scalar_map, g)
        rho_orig, T_orig = s.rho_init, s.T_init
        rho_init, T_init = rho, T
        drho_prev, dT_prev = drho, dT
        drho, dT = torch.zeros_like(drho), torch.zeros_like(dT)
        total_scalar += 1

    return dataclasses.replace(
        s, u=u_out, v=v_out, u_temp=u, v_temp=v, rho=rho, T=T,
        u_init=u_init, v_init=v_init, u_origin=u_origin, v_origin=v_origin,
        du=du, dv=dv, du_prev=du_prev, dv_prev=dv_prev,
        rho_init=rho_init, rho_orig=rho_orig, drho=drho, drho_prev=drho_prev,
        T_init=T_init, T_orig=T_orig, dT=dT, dT_prev=dT_prev,
        vel_map=vel_map, scalar_map=scalar_map, frame=s.frame + 1,
        last_remeshing=s.frame if vel_remap else s.last_remeshing,
        rho_last_remeshing=s.frame if rho_remap else s.rho_last_remeshing,
        total_resample_count=total_resample,
        total_scalar_resample=total_scalar,
        cfl=_cfl(vel_out, dt, g.h), proj_iters=iters, proj_res=res,
        interp_overflow=0, substeps=len(substeps(cfldt, dt)))


def _advect_particles(g, p, u, v, cfldt, dt):
    """Forward RK3 trace of the particles by dt, clamped to [h, (n-1)h]
    per axis, in one trace-mode launch that reads and writes the (P, 2)
    positions. Returns the new positions."""
    bounds = ((g.h, (g.ni - 1) * g.h), (g.h, (g.nj - 1) * g.h))
    return interp_fast.bilerp_trace(
        u, v, g.h, advect.trace_substeps(cfldt, dt),
        (p.pos[:, 0], p.pos[:, 1]), final_clamp=bounds, interleave=True).pos


def _particles_to_grid(g, s, dt, order):
    """The particle schemes' common start: the CFL substep from the
    velocity max (one sync), the trace and clamp, the bin sort and the
    P2G transfer. Returns (mv, particles sorted, (u, v, rho, T), substep
    count)."""
    mv = _host_max_vel(s.u, s.v)
    cfldt = np.float32(np.float32(g.h) / mv)
    p = dataclasses.replace(s.particles, pos=_advect_particles(
        g, s.particles, s.u, s.v, cfldt, dt))
    # one bin sort a frame: every splat is a sorted segment sum (on the
    # card one gather launch over the bins), and the sorted order persists
    # in the state
    p, keys = part.bin_sort(g, p, return_keys=True)
    if order == "flip":
        grid_vals = part.p2g_flip(g, p, sorted_bins=True, keys=keys)
    else:
        grid_vals = part.p2g_poly(g, p, order, sorted_bins=True, keys=keys)
    return mv, p, grid_vals, len(substeps(cfldt, dt))


def _step_flip(cfg, g, ctx, s, dt):
    """advanceFLIP: trace, bin sort, P2G, buoyancy and projection, then
    each particle takes flip*(old + grid change) + (1-flip)*grid value."""
    mv, p, (u, v, rho, T), subs = _particles_to_grid(g, s, dt, "flip")
    u_save, v_save, rho_save, T_save = u, v, rho, T
    u, v, iters, res = _buoyancy_project(cfg, g, ctx, u, v, rho, T, dt)
    (pu, pv, prho, pT), (d_u, d_v, d_rho, d_T) = part.g2p_sample_with_deltas(
        g, (u, v, rho, T),
        (u - u_save, v - v_save, rho - rho_save, T - T_save), p.pos)
    fl = cfg.flip_ratio
    new_vel = (fl * (p.vel + torch.stack([d_u, d_v], dim=-1))
               + (1 - fl) * torch.stack([pu, pv], dim=-1))
    p = dataclasses.replace(p, vel=new_vel,
                            rho=fl * (p.rho + d_rho) + (1 - fl) * prho,
                            T=fl * (p.T + d_T) + (1 - fl) * pT)
    return dataclasses.replace(
        s, u=u, v=v, rho=rho, T=T, particles=p, frame=s.frame + 1,
        cfl=_cfl(mv, dt, g.h), proj_iters=iters, proj_res=res,
        substeps=subs)


def _step_polypic(cfg, g, ctx, s, dt, order):
    """advancePolyPIC, and advanceAPIC with order "apic": trace, bin
    sort, polynomial P2G, buoyancy and projection, then each particle
    takes the grid's values and refits its polynomials (calculateCp)."""
    mv, p, (u, v, rho, T), subs = _particles_to_grid(g, s, dt, order)
    u, v, iters, res = _buoyancy_project(cfg, g, ctx, u, v, rho, T, dt)
    pu, pv, prho, pT = part.g2p_sample(g, u, v, rho, T, p.pos)
    p = dataclasses.replace(p, vel=torch.stack([pu, pv], dim=-1), rho=prho,
                            T=pT)
    p = part.update_cp_all(g, p, u, v, rho, T)
    return dataclasses.replace(
        s, u=u, v=v, rho=rho, T=T, particles=p, frame=s.frame + 1,
        cfl=_cfl(mv, dt, g.h), proj_iters=iters, proj_res=res,
        substeps=subs)


_STEPS = {
    Scheme.SEMILAG: _step_semilag,
    Scheme.MACCORMACK: partial(_step_highorder,
                               multi=advect.maccormack_multi_2d),
    Scheme.BFECC: partial(_step_highorder, multi=advect.bfecc_multi_2d),
    Scheme.MAC_REFLECTION: _step_reflection,
    Scheme.FLIP: _step_flip,
    Scheme.APIC: partial(_step_polypic, order="apic"),
    Scheme.POLYPIC: partial(_step_polypic, order="polypic"),
    Scheme.BIMOCQ: _step_bimocq,
}


class Smoke2D:
    """Solver object: the static config, its device and the MG context
    of an MG-PCG projection (``EngineMode(spectral_poisson=False)``).

    ``device=None`` runs on the card and raises when there is none; pass
    ``device="cpu"`` for the plain PyTorch versions of the kernel.
    Building one turns TF32 off for the process, as ``Smoke3D`` does."""

    def __init__(self, cfg: Smoke2DConfig, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.grid = cfg.grid
        self.device = config.resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mode = cfg.engine_mode
        spectral = mode is None or mode.spectral_poisson is not False
        self.ctx = (None if spectral else
                    poisson.MGContext(self.grid.shape_c, cfg.bc, self.device))
        self._step = _STEPS[cfg.scheme]

    def init_state(self) -> Smoke2DState:
        return init_state(self.cfg, self.device)

    def step(self, state: Smoke2DState, dt: float) -> Smoke2DState:
        return self._step(self.cfg, self.grid, self.ctx, state,
                          np.float32(dt))

    def step_checked(self, state: Smoke2DState, dt: float):
        """The JAX package's contract-enforcing step, returning (state,
        retried). There a frame whose windowed samplers (or dense particle
        bins) overflowed is recomputed on the exact engine. The port's
        kernels gather exactly and its particle transfer is the exact flat
        one, so nothing overflows and no frame is ever recomputed: this is
        ``(self.step(state, dt), False)``."""
        return self.step(state, dt), False

    def sample_particles_from_grid(self, state: Smoke2DState) -> Smoke2DState:
        """The particle schemes' bootstrap from the grid (the JAX CLI runs
        it after the scene init): every particle takes the grid's
        velocity, rho and T at its position and fits its polynomials."""
        g = self.grid
        p = state.particles
        pu, pv, prho, pT = part.g2p_sample(g, state.u, state.v, state.rho,
                                           state.T, p.pos)
        p = dataclasses.replace(p, vel=torch.stack([pu, pv], dim=-1),
                                rho=prho, T=pT)
        p = part.update_cp_all(g, p, state.u, state.v, state.rho, state.T)
        return dataclasses.replace(state, particles=p)
