"""3D smoke solver: the BiMocq, semi-Lagrangian, MacCormack and
reflection steps, moving obstacles.

Counterpart of ``gpufluidsimulation_tpu.solvers.smoke3d``: schemes BIMOCQ
(``reinit_mode`` 'always', 'counter' or 'adaptive', any ``blend_coeff``,
the four volume forms of the engine mode: dual by default, vol9 with
``volume_vol9=True``, prefilter with ``volume_dual=False``, exact with
``volume_exact=True``), SEMILAG, MACCORMACK and MAC_REFLECTION; analytic
sphere emitters; analytic sphere and box obstacles (``Boundary3D``) with
the masked MG-PCG projection; the spectral projection or, with
``EngineMode(spectral_poisson=False)``, MG-PCG, its V-cycles smoothed
with damped Jacobi under ``EngineMode(rbgs=False)``; voxel level-set
(``sdf_grid``) boundaries and emitters, emitter motion (``trans``) and
emission velocity (``emit_velocity``). Under BIMOCQ with always/blend 1
the two-level (prev) tier, the scalar advector's maps and the accumulates
are statically dead, so the state carries ``None`` for them, as the JAX
package's dieted state does (``_aux_dead``).

Host syncs per step: one to read max|vel| (the CFL substep count is
decided on the host in float32, ops/advect.substeps); one for the
spectral refinement branch or one per CG iteration of an MG-PCG
projection (the exit test), twice over for MAC_REFLECTION, which projects
twice; and under ``reinit_mode='adaptive'`` one more to read the two map
distortions that decide the reinitializations (the JAX step's
``lax.cond`` branches become host branches).

The obstacle pose is computed on the host in float32, as the JAX step
computes it on the device: in float64 a cell on the obstacle's surface
can land on the other side of ``sdf <= 0`` and the flags differ.

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
from gpufluidsimulation_tpu_torch.core.interp import sample3_separable
from gpufluidsimulation_tpu_torch.ops import (advect, forces, interp_fast,
                                          poisson)
from gpufluidsimulation_tpu_torch.ops.advect import substeps
from gpufluidsimulation_tpu_torch.parallel import sharded_interp
from gpufluidsimulation_tpu_torch.solvers.schemes import Scheme


def _f32_offset(trans, frame):
    """trans(frame) at ``np.float32(frame)`` as three ``np.float32``."""
    return tuple(np.float32(o) for o in trans(np.float32(frame)))


def _f32_add(center, offset):
    return tuple(np.float32(np.float32(c) + o)
                 for c, o in zip(center, offset))


@dataclasses.dataclass(frozen=True)
class Emitter3D:
    """Smoke emitter, for the first `emit_frames` frames.

    Analytic sphere (no `sdf_grid`): rho/T set inside `radius`,
    theta-modulated x-velocity sign*0.06*(1 + 0.01 cos 8 theta), v/w
    zeroed. Voxel level set (`sdf_grid`, on the cell lattice x = i*h with
    the simulation's h, placed at `center`): rho/T and each velocity
    component set where the SDF <= 0, the velocity from
    `emit_velocity(X, Y, Z) -> (u, v, w)` at the component's world node
    coordinates (zero without one; analytic emitters ignore it, as in the
    JAX package). `trans(frame) -> (dx, dy, dz)` moves either kind by a
    world offset; it receives the frame as ``np.float32`` and should
    compute in float32."""

    center: Tuple[float, float, float]
    radius: float = 0.015
    density: float = 1.0
    temperature: float = 50.0
    sign: float = 1.0
    emit_frames: int = 10
    sdf_grid: object = dataclasses.field(default=None, compare=False)
    trans: object = dataclasses.field(default=None, compare=False)
    emit_velocity: object = dataclasses.field(default=None, compare=False)

    def position_at(self, frame: int):
        """The centre at a frame, three ``np.float32``: `center` plus
        trans(frame) in float32, as the JAX step adds them."""
        if self.trans is None:
            return tuple(np.float32(c) for c in self.center)
        return _f32_add(self.center, _f32_offset(self.trans, frame))


@dataclasses.dataclass(frozen=True)
class Boundary3D:
    """Moving rigid obstacle: cells inside get flag 3 and the obstacle's
    rigid velocity; in a shell of `half_width` cells outside it the
    advected fields are replaced by their semi-Lagrangian fallback.

    Shapes: analytic 'sphere' (`radius`) or 'box' (`half_extents`), or a
    voxel level set (`sdf_grid`, kind 'voxel' or any kind with a grid: on
    the cell lattice x = i*h with the simulation's h, placed at `center`;
    ``io_utils.mesh.mesh_to_sdf`` converts OBJ meshes). Motion: constant
    `velocity`, or a closed-form `trans(frame)` world offset (dx, dy, dz)
    whose rigid velocity is the one-frame finite difference. `trans`
    receives the frame as ``np.float32`` and should compute in
    float32."""

    center: Tuple[float, float, float]
    radius: float = 0.02
    velocity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    half_width: float = 3.0
    kind: str = "sphere"
    half_extents: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sdf_grid: object = dataclasses.field(default=None, compare=False)
    trans: object = dataclasses.field(default=None, compare=False)

    @property
    def is_voxel(self) -> bool:
        return self.sdf_grid is not None or self.kind == "voxel"

    def sdf(self, x, y, z, pos, h=None):
        """Signed distance at world coordinates for the obstacle centred
        at `pos`; x, y and z are the axis views of ``Grid3D.axis_coords``
        (or full grids) and `h` the grid spacing of a voxel level set."""
        dx = x - float(pos[0])
        dy = y - float(pos[1])
        dz = z - float(pos[2])
        if self.is_voxel:
            grid = torch.as_tensor(self.sdf_grid, dtype=torch.float32,
                                   device=x.device)
            return sample3_separable(grid, dx, dy, dz, h)
        if self.kind == "sphere":
            return torch.sqrt(dx * dx + dy * dy + dz * dz) - self.radius
        ax = dx.abs() - self.half_extents[0]
        ay = dy.abs() - self.half_extents[1]
        az = dz.abs() - self.half_extents[2]
        outside = torch.sqrt(ax.clamp(min=0.0) ** 2 + ay.clamp(min=0.0) ** 2
                             + az.clamp(min=0.0) ** 2)
        return outside + torch.maximum(ax, torch.maximum(ay, az)).clamp(max=0.0)

    def pose_at(self, frame: int, dt: float):
        """(position, rigid velocity) at a frame, each three ``np.float32``
        values, in the float32 arithmetic of the JAX step."""
        f32 = np.float32
        f = f32(frame)
        if self.trans is not None:
            o0 = _f32_offset(self.trans, frame)
            o1 = _f32_offset(self.trans, f32(f + f32(1.0)))
            vel = tuple(f32(f32(b - a) / f32(dt)) for a, b in zip(o0, o1))
            return _f32_add(self.center, o0), vel
        t = f32(f * f32(dt))
        pos = tuple(f32(f32(c) + f32(f32(v) * t))
                    for c, v in zip(self.center, self.velocity))
        return pos, tuple(f32(v) for v in self.velocity)


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
    boundaries: Tuple[Boundary3D, ...] = ()
    bc: str = "dirichlet"
    proj_tol: float = 1e-4
    proj_max_iters: int = 50
    reinit_mode: str = "always"
    vel_reinit_gap: int = 10
    scalar_reinit_gap: int = 30
    vel_distortion_limit: float = 1.0
    scalar_distortion_limit: float = 5.0
    engine_mode: Optional[config.EngineMode] = None

    @property
    def h(self) -> float:
        return self.L / self.ni

    @property
    def grid(self) -> Grid3D:
        return Grid3D(self.ni, self.nj, self.nk, self.h)


@dataclasses.dataclass
class Smoke3DState:
    """Fields are float32 tensors on the solver's device; counters are host
    ints. ``interp_overflow`` is 0 on one device: the port's kernels
    gather exactly and have no displacement window to overflow. Under a
    mesh (``EngineMode.sharded_sampling``) it counts the step's samples
    past the halo contract, as the JAX package's sink does
    (``parallel/sharded_interp.py``). ``substeps`` and ``slab_clamped``
    are the port's own diagnostics: CFL substeps of the last step's
    marches, and under a mesh the march nodes that its slab kernels
    clamped to a slab's edge."""

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
    slab_clamped: int = 0


REINIT_MODES = ("always", "counter", "adaptive")


def check_supported(cfg: Smoke3DConfig) -> None:
    """Raise NotImplementedError for any configuration the port lacks."""
    problems = []
    if cfg.scheme not in _STEPS:
        problems.append(f"scheme {cfg.scheme!r}")
    for bd in cfg.boundaries:
        if not isinstance(bd, Boundary3D):
            problems.append(f"boundary {bd!r} (Boundary3D only)")
        elif bd.is_voxel:
            if bd.sdf_grid is None or np.ndim(bd.sdf_grid) != 3:
                problems.append(f"boundary kind {bd.kind!r} without a 3D "
                                "sdf_grid (a voxel level set needs one)")
        elif bd.kind not in ("sphere", "box"):
            problems.append(f"boundary kind {bd.kind!r} (sphere, box or "
                            "voxel)")
    if cfg.scheme == Scheme.BIMOCQ and cfg.reinit_mode not in REINIT_MODES:
        problems.append(f"reinit_mode {cfg.reinit_mode!r} (one of "
                        f"{REINIT_MODES})")
    if cfg.bc not in ("dirichlet", "neumann"):
        problems.append(f"bc {cfg.bc!r} (dirichlet or neumann)")
    for em in cfg.emitters:
        if not isinstance(em, Emitter3D):
            problems.append(f"emitter {em!r} (Emitter3D only)")
        elif em.sdf_grid is not None and np.ndim(em.sdf_grid) != 3:
            problems.append("emitter sdf_grid (a 3D voxel level set)")
    if cfg.engine_mode is not None and not isinstance(
            cfg.engine_mode, config.EngineMode):
        problems.append(f"engine_mode {cfg.engine_mode!r} (the port's "
                        "config.EngineMode only)")
    if problems:
        raise NotImplementedError(
            "the PyTorch port does not run this configuration; "
            "unsupported: " + "; ".join(problems))


def _aux_dead(cfg: Smoke3DConfig) -> bool:
    """True when the two-level blend tier is statically dead: BiMocq with
    per-frame reinitialization and blend 1. The *_prev fields, bwd_prev
    and the scalar advector's own maps are then None in the state."""
    return (cfg.scheme == Scheme.BIMOCQ and cfg.reinit_mode == "always"
            and cfg.blend_coeff == 1.0)


def _bf16(cfg: Smoke3DConfig) -> bool:
    """The bf16 mode of the single-device samplers (``EngineMode.bf16``;
    the slab paths read ``EngineMode.slab_bf16`` through their
    routing)."""
    return cfg.engine_mode is not None and cfg.engine_mode.bf16


def _window(cfg: Smoke3DConfig, u, v, w):
    """The faces the window samplers read this step: None in float32, in
    the bf16 mode their bfloat16 rounding, made once for every trace,
    march and MacCormack midpoint of this velocity (the JAX package packs
    them once a frame)."""
    return advect.window_faces(u, v, w, _bf16(cfg))


def _volume_mode(cfg: Smoke3DConfig) -> str:
    """The BiMocq volume form: 'exact', 'dual', 'vol9' or 'prefilter'."""
    return "dual" if cfg.engine_mode is None else cfg.engine_mode.volume_mode


def _uses_mgpcg(cfg: Smoke3DConfig) -> bool:
    """Solid boundaries always project with (masked) MG-PCG; the open box
    does when the engine mode turns the spectral solve off."""
    mode = cfg.engine_mode
    return bool(cfg.boundaries) or (mode is not None
                                    and mode.spectral_poisson is False)


def init_state(cfg: Smoke3DConfig, device=None) -> Smoke3DState:
    g = cfg.grid
    dead = _aux_dead(cfg)

    def z(kind):
        return g.zeros(kind, device=device)

    def zp(kind):
        return None if dead else z(kind)

    return Smoke3DState(
        u=z("u"), v=z("v"), w=z("w"),
        u_init=z("u"), v_init=z("v"), w_init=z("w"),
        u_prev=zp("u"), v_prev=zp("v"), w_prev=zp("w"),
        rho=z("c"), rho_init=z("c"), rho_prev=zp("c"),
        T=z("c"), T_init=z("c"), T_prev=zp("c"),
        vel_map=mp.init_mapping(g, with_prev=not dead, device=device),
        scalar_map=mp.init_mapping(g, with_maps=not dead, device=device),
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
    """Smoke emission, gated per emitter on frame < emit_frames (a host
    decision: `frame` is a host int). Analytic spheres use the
    theta-modulated sphere kernels (GPU_kernel.cu:736-802), voxel level
    sets the hybrid solver's wsSample loop (``_emit_voxel``)."""
    h = g.h
    dev = u.device
    for em in cfg.emitters:
        if not frame < em.emit_frames:
            continue
        if em.sdf_grid is not None:
            u, v, w, rho, T = _emit_voxel(em, g, u, v, w, rho, T, frame)
            continue
        cx, cy, cz = (float(c) for c in em.position_at(frame))

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


def _emit_voxel(em: Emitter3D, g: Grid3D, u, v, w, rho, T, frame: int):
    """Voxel-SDF emitter: the level set, moved to this frame's centre, is
    sampled on every field's lattice; where it is <= 0, rho/T take the
    emitter's values and each velocity component its `emit_velocity`."""
    dev = u.device
    grid_vals = torch.as_tensor(em.sdf_grid, dtype=torch.float32, device=dev)
    pos = [float(c) for c in em.position_at(frame)]

    def inside_at(kind):
        x, y, z = g.axis_coords(kind, device=dev)
        sd = sample3_separable(grid_vals, x - pos[0], y - pos[1],
                               z - pos[2], g.h)
        return sd <= 0.0

    def velocity(kind, axis, field):
        if em.emit_velocity is None:
            return 0.0
        vel = em.emit_velocity(*g.node_coords(kind, device=dev))[axis]
        return torch.as_tensor(vel, dtype=torch.float32,
                               device=dev).expand(field.shape)

    u = torch.where(inside_at("u"), velocity("u", 0, u), u)
    v = torch.where(inside_at("v"), velocity("v", 1, v), v)
    w = torch.where(inside_at("w"), velocity("w", 2, w), w)
    inside_c = inside_at("c")
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


def boundary_base_flags(g: Grid3D, device=None):
    """The static part of the cell flags: domain walls (SOLID) on the x
    and z faces and the floor, open top (AIR); uint8."""
    ni, nj, nk = g.shape_c
    ii = torch.arange(ni, device=device)[:, None, None]
    jj = torch.arange(nj, device=device)[None, :, None]
    kk = torch.arange(nk, device=device)[None, None, :]
    wall = (ii < 1) | (kk < 1) | (ii >= ni - 1) | (kk >= nk - 1) | (jj < 1)
    base = torch.where(wall, poisson.SOLID, poisson.FLUID)
    base = torch.where(jj >= nj - 1, poisson.AIR, base)
    return base.to(torch.uint8).contiguous()


def _update_boundary(cfg: Smoke3DConfig, g: Grid3D, frame: int, dt, base):
    """Per-frame boundary state: flags 0 fluid, 1 air (open top), 2 domain
    wall, 3 moving object; staggered solid velocities on the faces inside
    each object; per-kind shell masks (0 < sdf < half_width*h). `base` is
    ``boundary_base_flags``. Returns (flags, u_solid, v_solid, w_solid,
    shells)."""
    dev = base.device
    flags = base
    solid_vel = {k: g.zeros(k, device=dev) for k in ("u", "v", "w")}
    shells = {k: torch.zeros(g.shape_of(k), dtype=torch.bool, device=dev)
              for k in ("c", "u", "v", "w")}
    for bd in cfg.boundaries:
        pos, bvel = bd.pose_at(frame, dt)
        shell_w = bd.half_width * g.h
        for axis, kind in enumerate(("u", "v", "w", "c")):
            sd = bd.sdf(*g.axis_coords(kind, device=dev), pos, g.h)
            if kind == "c":
                flags = torch.where(sd <= 0.0, poisson.OBJECT, flags)
            else:
                solid_vel[kind] = torch.where(sd <= 0.0, float(bvel[axis]),
                                              solid_vel[kind])
            shells[kind] = shells[kind] | ((sd > 0.0) & (sd < shell_w))
    return (flags.to(torch.uint8), solid_vel["u"], solid_vel["v"],
            solid_vel["w"], shells)


def _project3(cfg, ctx, bnd, u, v, w):
    """Plain or boundary-aware projection depending on cfg.boundaries."""
    if cfg.boundaries:
        flags, us, vs, ws, _ = bnd
        return poisson.project_masked_3d(u, v, w, flags, us, vs, ws, ctx,
                                         cfg.proj_tol, cfg.proj_max_iters)
    return poisson.project_3d(u, v, w, cfg.bc, cfg.proj_tol,
                              cfg.proj_max_iters, ctx=ctx)


def _blend_boundary(bnd, kind, field, fallback):
    """Replace `field` with the semi-Lagrangian `fallback` in the shell
    just outside solid objects."""
    if bnd is None:
        return field
    return torch.where(bnd[4][kind], fallback, field)


def _clear_boundary(bnd, field):
    """Zero a cell field inside solid objects."""
    if bnd is None:
        return field
    return torch.where(bnd[0] == poisson.OBJECT, 0.0, field)


def _cfl(maxvel, dt, h) -> float:
    return float(np.float32(maxvel * np.float32(dt)) / np.float32(h))


def _finish_step(cfg, g, ctx, base, s, fields, maxvel, cfldt):
    """Forces, boundaries and projection after the advection of a
    semi-Lagrangian or MacCormack step; `fields` is (u, v, w, rho, T)."""
    dt = cfg.dt
    u, v, w, rho, T = _forces_and_project(cfg, g, *fields, s.frame, dt)
    bnd = (_update_boundary(cfg, g, s.frame, dt, base)
           if cfg.boundaries else None)
    rho = _clear_boundary(bnd, rho)
    u, v, w, _, iters, res, hist = _project3(cfg, ctx, bnd, u, v, w)
    return dataclasses.replace(
        s, u=u, v=v, w=w, rho=rho, T=T, frame=s.frame + 1,
        cfl=_cfl(maxvel, dt, g.h), proj_iters=iters, proj_res=res,
        proj_res_hist=hist, substeps=len(substeps(cfldt, dt)))


def _step_semilag(cfg: Smoke3DConfig, g: Grid3D, ctx, base,
                  s: Smoke3DState) -> Smoke3DState:
    maxvel = _max_velocity(s.u, s.v, s.w)
    cfldt = np.float32(np.float32(g.h) / maxvel)
    (rho, T), (u,), (v,), (w,) = advect.semilag_kinds_3d(
        g, [("c", [s.rho, s.T]), ("u", [s.u]), ("v", [s.v]), ("w", [s.w])],
        s.u, s.v, s.w, cfldt, -cfg.dt, _window(cfg, s.u, s.v, s.w))
    return _finish_step(cfg, g, ctx, base, s, (u, v, w, rho, T), maxvel,
                        cfldt)


def _maccormack_vel(g, u, v, w, au, av, aw, cfldt, dt, window=None):
    """MacCormack of the staggered triplet (au, av, aw) traced in
    (u, v, w), with the velocity (27-point neighbourhood) clamp; `window`:
    the bf16 mode's faces of (u, v, w)."""
    (cu,), (cv,), (cw,) = advect.maccormack_kinds_3d(
        g, [("u", [au], "neighborhood"), ("v", [av], "neighborhood"),
            ("w", [aw], "neighborhood")], u, v, w, cfldt, dt, window)
    return cu, cv, cw


def _step_maccormack(cfg: Smoke3DConfig, g: Grid3D, ctx, base,
                     s: Smoke3DState) -> Smoke3DState:
    maxvel = _max_velocity(s.u, s.v, s.w)
    cfldt = np.float32(np.float32(g.h) / maxvel)
    # scalars keep the trace clamp, velocities the neighbourhood clamp
    (rho, T), (u,), (v,), (w,) = advect.maccormack_kinds_3d(
        g, [("c", [s.rho, s.T], "trace"), ("u", [s.u], "neighborhood"),
            ("v", [s.v], "neighborhood"), ("w", [s.w], "neighborhood")],
        s.u, s.v, s.w, cfldt, cfg.dt, _window(cfg, s.u, s.v, s.w))
    return _finish_step(cfg, g, ctx, base, s, (u, v, w, rho, T), maxvel,
                        cfldt)


def _step_reflection(cfg: Smoke3DConfig, g: Grid3D, ctx, base,
                     s: Smoke3DState) -> Smoke3DState:
    """advanceReflection: MacCormack scalars over dt, half-step velocity
    MacCormack, forces and projection, reflect u* = 2u - u_hat, advect the
    reflected field another half step in the projected field, forces and
    projection again."""
    dt = cfg.dt
    half = 0.5 * dt
    maxvel = _max_velocity(s.u, s.v, s.w)
    cfldt = np.float32(np.float32(g.h) / maxvel)
    window = _window(cfg, s.u, s.v, s.w)
    rho, T = advect.maccormack_multi_3d(g, "c", [s.rho, s.T], s.u, s.v, s.w,
                                        cfldt, dt, window)
    u, v, w = _maccormack_vel(g, s.u, s.v, s.w, s.u, s.v, s.w, cfldt, half,
                              window)
    u, v, w, rho, T = _forces_and_project(cfg, g, u, v, w, rho, T, s.frame,
                                          half)
    bnd = (_update_boundary(cfg, g, s.frame, dt, base)
           if cfg.boundaries else None)
    rho = _clear_boundary(bnd, rho)
    u_save, v_save, w_save = u, v, w
    u, v, w, _, it1, res1, _ = _project3(cfg, ctx, bnd, u, v, w)
    ru, rv, rw = 2.0 * u - u_save, 2.0 * v - v_save, 2.0 * w - w_save
    u2, v2, w2 = _maccormack_vel(g, u, v, w, ru, rv, rw, cfldt, half,
                                 _window(cfg, u, v, w))
    v2 = forces.buoyancy_3d(v2, rho, T, cfg.alpha, cfg.beta, half)
    if cfg.viscosity:
        coef = cfg.viscosity * half / (g.h * g.h)
        u2 = forces.diffuse_3d(u2, 20, coef)
        v2 = forces.diffuse_3d(v2, 20, coef)
        w2 = forces.diffuse_3d(w2, 20, coef)
    u2, v2, w2, _, it2, res2, hist2 = _project3(cfg, ctx, bnd, u2, v2, w2)
    return dataclasses.replace(
        s, u=u2, v=v2, w=w2, rho=rho, T=T, frame=s.frame + 1,
        cfl=_cfl(maxvel, dt, g.h), proj_iters=it1 + it2,
        proj_res=torch.maximum(res1, res2), proj_res_hist=hist2,
        substeps=len(substeps(cfldt, half)))


def _step_bimocq(cfg: Smoke3DConfig, g: Grid3D, ctx, base,
                 s: Smoke3DState) -> Smoke3DState:
    """advanceBimocq with the hybrid solver's reinitialization policies:
    'always' reinitializes both maps every frame (the GPU solver),
    'counter' after a gap of frames, 'adaptive' also when a map's
    distortion passes its limit. A blend below 1 mixes in the level-2
    pull-back through bwd_prev once a map has been reinitialized."""
    dt = cfg.dt
    always = cfg.reinit_mode == "always"
    mode = _volume_mode(cfg)
    bf16 = _bf16(cfg)
    # the bf16 mode's faces: every trace and march of this velocity
    window = _window(cfg, s.u, s.v, s.w)
    # the z-slab routing of the marches and lattice samples under a mesh
    sharded = sharded_interp.Sampling.of(cfg.engine_mode, s.u.device)
    maxvel = _max_velocity(s.u, s.v, s.w)
    cfldt = np.float32(np.float32(g.h) / maxvel)

    bnd = (_update_boundary(cfg, g, s.frame, dt, base)
           if cfg.boundaries else None)

    # under 'always' both maps are identity at step entry (reinitialized
    # at the end of every step): the backward march's first substep is
    # the identity peel, and the scalar maps are the velocity maps
    vel_map = mp.update_mapping_3d(s.vel_map, g, s.u, s.v, s.w, cfldt, dt,
                                   from_identity=always, sharded=sharded,
                                   window=window)
    if not always:
        scalar_map = mp.update_mapping_3d(s.scalar_map, g, s.u, s.v, s.w,
                                          cfldt, dt, sharded=sharded,
                                          window=window)
    elif s.scalar_map.fwd is None:
        scalar_map = s.scalar_map          # counter-only alias
    else:
        scalar_map = dataclasses.replace(s.scalar_map, fwd=vel_map.fwd,
                                         bwd=vel_map.bwd)

    if cfg.boundaries:
        # semi-Lagrangian fallbacks for the boundary shell
        (sl_u,), (sl_v,), (sl_w,), (sl_rho, sl_T) = advect.semilag_kinds_3d(
            g, [("u", [s.u]), ("v", [s.v]), ("w", [s.w]),
                ("c", [s.rho, s.T])], s.u, s.v, s.w, cfldt, -dt, window)

    # the two-level blend is blend_coeff once a map has been reinitialized
    # and 1 before; at 1 the level-2 term has weight exactly 0 (None)
    def blend(mapping):
        live = cfg.blend_coeff != 1.0 and mapping.reinit_count != 0
        return cfg.blend_coeff if live else None

    # vol9 map statistics: once per map this step, shared by every stage,
    # kind and accumulate that samples through the map
    smaps = vel_map if scalar_map.fwd is None else scalar_map
    stats = {}
    if mode == "vol9":
        for m in (vel_map.bwd, vel_map.fwd, smaps.bwd, smaps.fwd):
            if id(m) not in stats:
                stats[id(m)] = interp_fast.vol9_map_stats(m, g.h,
                                                          g.shape_c)

    def pull_back(kind, cur, init, prev, maps, b):
        return mp.bimocq_advect_3d(
            g, kind, cur, init, prev, maps.bwd, maps.bwd_prev, maps.fwd, b,
            mode=mode, map_stats=(stats.get(id(maps.bwd)),
                                  stats.get(id(maps.fwd))), sharded=sharded,
            bf16=bf16)

    blend_v = blend(vel_map)
    (u,) = pull_back("u", [s.u], [s.u_init], [s.u_prev], vel_map, blend_v)
    (v,) = pull_back("v", [s.v], [s.v_init], [s.v_prev], vel_map, blend_v)
    (w,) = pull_back("w", [s.w], [s.w_init], [s.w_prev], vel_map, blend_v)
    rho, T = pull_back("c", [s.rho, s.T], [s.rho_init, s.T_init],
                       [s.rho_prev, s.T_prev], smaps, blend(scalar_map))

    if cfg.boundaries:
        u = _blend_boundary(bnd, "u", u, sl_u)
        v = _blend_boundary(bnd, "v", v, sl_v)
        w = _blend_boundary(bnd, "w", w, sl_w)
        rho = _blend_boundary(bnd, "c", rho, sl_rho)
        T = _blend_boundary(bnd, "c", T, sl_T)
        rho = _clear_boundary(bnd, rho)

    # external forces, kept as deltas for the accumulates; under
    # always/blend 1 the accumulated inits would only become the
    # zero-weighted prevs, so the accumulates are statically dead
    accumulate = not _aux_dead(cfg)
    before = (u, v, w, rho, T)
    u, v, w, rho, T = _forces_and_project(cfg, g, u, v, w, rho, T, s.frame,
                                          dt)
    if accumulate:
        du_ext, dv_ext, dw_ext, drho_ext, dT_ext = (
            a - b for a, b in zip((u, v, w, rho, T), before))

    u_t, v_t, w_t = u, v, w
    u, v, w, _, iters, res, hist = _project3(cfg, ctx, bnd, u, v, w)
    du_p, dv_p, dw_p = u - u_t, v - v_t, w - w_t

    # reinitialization decisions (host ints; 'adaptive' reads the two map
    # distortions in one host sync)
    vel_reinit = s.frame - s.vel_last_reinit > cfg.vel_reinit_gap
    scalar_reinit = s.frame - s.scalar_last_reinit > cfg.scalar_reinit_gap
    if cfg.reinit_mode == "adaptive":
        excl = (bnd[0] == poisson.OBJECT) if cfg.boundaries else None
        d = torch.stack([mp.estimate_distortion_3d(g, vel_map, excl),
                         mp.estimate_distortion_3d(g, scalar_map, excl)])
        d_vel, d_sc = (np.float32(x) / np.float32(maxvel * np.float32(dt))
                       for x in d.cpu().numpy())
        vel_reinit = (bool(d_vel > np.float32(cfg.vel_distortion_limit))
                      or vel_reinit)
        scalar_reinit = (bool(d_sc > np.float32(cfg.scalar_distortion_limit))
                         or scalar_reinit)
    proj_coeff = 1.0 if vel_reinit else 2.0

    # accumulate the deltas into the init buffers through the forward maps
    u_init, v_init, w_init = s.u_init, s.v_init, s.w_init
    rho_init, T_init = s.rho_init, s.T_init
    if accumulate:
        u_init, v_init, w_init = (
            mp.accumulate_multi_3d(g, kind, [(base, [(ext, 1.0),
                                                     (dp, proj_coeff)])],
                                   vel_map.fwd, mode=mode,
                                   fwd_stats=stats.get(id(vel_map.fwd)),
                                   sharded=sharded, bf16=bf16)[0]
            for kind, base, ext, dp in (("u", u_init, du_ext, du_p),
                                        ("v", v_init, dv_ext, dv_p),
                                        ("w", w_init, dw_ext, dw_p)))
        rho_init, T_init = mp.accumulate_multi_3d(
            g, "c", [(rho_init, [(drho_ext, 1.0)]), (T_init, [(dT_ext, 1.0)])],
            scalar_map.fwd, mode=mode,
            fwd_stats=stats.get(id(scalar_map.fwd)), sharded=sharded,
            bf16=bf16)

    u_prev, v_prev, w_prev = s.u_prev, s.v_prev, s.w_prev
    if always or vel_reinit:
        # init <- current velocity plus one more projection accumulate
        # through the (now identity) forward map
        vel_map = mp.reinitialize(vel_map, g)
        if s.u_prev is not None:
            u_prev, v_prev, w_prev = u_init, v_init, w_init
        u_init, v_init, w_init = (
            mp.accumulate_multi_3d(g, kind, [(f, [(dp, 1.0)])], vel_map.fwd,
                                   identity=True, mode=mode, bf16=bf16)[0]
            for kind, f, dp in (("u", u, du_p), ("v", v, dv_p),
                                ("w", w, dw_p)))
    rho_prev, T_prev = s.rho_prev, s.T_prev
    if always or scalar_reinit:
        scalar_map = mp.reinitialize(scalar_map, g)
        if s.rho_prev is not None:
            rho_prev, T_prev = rho_init, T_init
        rho_init, T_init = rho, T

    return dataclasses.replace(
        s, u=u, v=v, w=w, u_init=u_init, v_init=v_init, w_init=w_init,
        u_prev=u_prev, v_prev=v_prev, w_prev=w_prev,
        rho=rho, rho_init=rho_init, rho_prev=rho_prev,
        T=T, T_init=T_init, T_prev=T_prev,
        vel_map=vel_map, scalar_map=scalar_map,
        frame=s.frame + 1,
        vel_last_reinit=s.frame if vel_reinit else s.vel_last_reinit,
        scalar_last_reinit=s.frame if scalar_reinit else s.scalar_last_reinit,
        cfl=_cfl(maxvel, dt, g.h), proj_iters=iters, proj_res=res,
        proj_res_hist=hist,
        interp_overflow=0 if sharded is None else sharded.overflow(),
        substeps=len(substeps(cfldt, dt)),
        slab_clamped=0 if sharded is None else sharded.clamped_nodes(),
    )


_STEPS = {
    Scheme.SEMILAG: _step_semilag,
    Scheme.MACCORMACK: _step_maccormack,
    Scheme.MAC_REFLECTION: _step_reflection,
    Scheme.BIMOCQ: _step_bimocq,
}


class Smoke3D:
    """Solver object: the static config, its device, and what is built
    once per solver (the MG context and the static boundary flags).

    ``device=None`` runs on the card and raises when there is none; pass
    ``device="cpu"`` for the plain PyTorch versions of every kernel.
    ``EngineMode(rbgs=False)`` builds the MG context whose V-cycles
    smooth with damped Jacobi only."""

    def __init__(self, cfg: Smoke3DConfig, device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.grid = cfg.grid
        self.device = config.resolve_device(device)
        # a sharded mode's mesh must live on this device
        sharded_interp.Sampling.of(cfg.engine_mode, self.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        rbgs = cfg.engine_mode is None or cfg.engine_mode.rbgs is not False
        self.ctx = (poisson.MGContext(self.grid.shape_c, cfg.bc, self.device,
                                      rbgs=rbgs)
                    if _uses_mgpcg(cfg) else None)
        self._base_flags = (boundary_base_flags(self.grid, self.device)
                            if cfg.boundaries else None)
        self._step = _STEPS[cfg.scheme]

    def init_state(self) -> Smoke3DState:
        return init_state(self.cfg, self.device)

    def step(self, state: Smoke3DState) -> Smoke3DState:
        return self._step(self.cfg, self.grid, self.ctx, self._base_flags,
                          state)

    def step_checked(self, state: Smoke3DState):
        """The JAX package's contract-enforcing step, returning (state,
        retried). There a frame whose windowed samplers overflowed
        (``interp_overflow > 0``) is recomputed from a saved copy of the
        state on the exact-gather engine. On one device the port's
        kernels gather exactly, so ``interp_overflow`` is 0 and no frame
        is recomputed. Under a mesh (``EngineMode.sharded_sampling``) a
        frame that left the halo contract, or whose marches clamped a
        node to a slab's edge (``slab_clamped``), is recomputed from the
        same input state (the step writes none of its tensors) with
        sharded sampling off."""
        out = self.step(state)
        if out.interp_overflow == 0 and out.slab_clamped == 0:
            return out, False
        cfg = dataclasses.replace(self.cfg, engine_mode=dataclasses.replace(
            self.cfg.engine_mode, sharded_sampling=()))
        return self._step(cfg, self.grid, self.ctx, self._base_flags,
                          state), True
