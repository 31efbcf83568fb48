"""Map marches, semi-Lagrangian, MacCormack and BFECC transport and the
neighbourhood extrema clamps, 3D and 2D.

Counterpart of ``gpufluidsimulation_tpu.ops.advect``.
The CFL substep loops run on the host: ``cfldt`` arrives as a float32 host
value (one device sync per step, in the solver) and the substep schedule
repeats the JAX ``lax.while_loop`` arithmetic in ``np.float32`` — in
float64 the count of substeps can differ, and then the maps differ.

Positions inside a march are cell-lattice grid coordinates (p/h); each
substep is one launch of the ``rk3_substep`` or ``dmc_substep`` kernel
(``ops/interp_fast.py``).

The semi-Lagrangian family (``semilag_multi_3d``, ``semilag_3d``,
``semilag_kinds_3d``) backtraces each kind's node lattice with
``rk3_substep`` and samples with ``trilerp_sample`` (plain trilinear). The
JAX package's ``mac_at_nodes_3d``, ``_vel_pack``, ``_union_pack``,
``_concat_kind_positions``, ``gate_nx`` and ``node_off`` are window
geometry of the TPU kernels and have no counterpart:
``rk3_substep_lattice``, which starts from the exact lattice coordinate
(i - 0.5*dim), computes the same stage-1 velocity as their identity
peel.

MacCormack (``maccormack_kinds_3d``, ``maccormack_multi_3d``,
``maccormack_3d``) is a backward and a forward semilag stage, the
correction and one of two clamps: the 27-point neighbourhood clamp
(velocities) or the trace clamp (scalars): the min/max of the 8 trilinear
corners at a two-stage midpoint backtrace (``minmax_sample``) with the
trilinear sample there as fallback, as the JAX package's exact path
computes it.

The bf16 mode (``EngineMode.interp_bf16``): the 3D functions take a
`window`, the bfloat16 rounding of the faces (``window_faces``, made once
a step by the solver, as the JAX package packs its bf16 MAC triplet once
a frame). Every velocity sample of the traces, the DMC substeps and
MacCormack's second midpoint stage reads it, and the fields that the
semi-Lagrangian, MacCormack clamp and fallback samples read are rounded
to bfloat16 too; the identity peels (the first stage of
``rk3_substep_lattice``, ``dmc_substep_lattice``) and MacCormack's first
midpoint stage read the float32 faces, as in JAX. `window=None` is the
float32 mode.

The 2D half (``trace_rk3_2d`` .. ``update_forward_map_2d``) follows the
JAX package's 2D functions operation for operation on world positions.
A whole CFL-substepped trace is one launch of the ``bilerp_sample``
kernel's trace mode (``interp_fast.bilerp_trace``: the RK3 steps, the
clamps, and at the foot the semi-Lagrangian samples, MacCormack's corner
min/max and the foot itself), a substep of the backward-map march one of
its DMC mode (``interp_fast.bilerp_dmc``), and any other field sample one
of its sample mode, several fields at the same positions in one launch.
What the JAX package computes twice with the same inputs is computed once
here: the backtrace of MacCormack's and BFECC's clamp is the forward
stage's own (so is the clamp's fallback sample, the forward stage's
result).
"""

from __future__ import annotations

import numpy as np
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.ops import interp_fast

# a flow whose CFL substep count exceeds this is not a flow the step can
# follow (velocities have blown up); raise instead of looping for hours
MAX_SUBSTEPS = 10_000


def substeps(cfldt, total):
    """The float32 substep schedule of the JAX march loops: starting at
    t = 0, sub = min(cfldt, total - t) and t += sub while t < total."""
    total = np.float32(total)
    cfl = np.float32(max(np.float32(float(cfldt)), np.float32(1e-30)))
    if not np.isfinite(cfl):
        raise FloatingPointError(f"non-finite CFL substep {cfl}")
    t = np.float32(0.0)
    out = []
    while t < total:
        sub = np.float32(min(cfl, np.float32(total - t)))
        out.append(sub)
        t = np.float32(t + sub)
        if len(out) > MAX_SUBSTEPS:
            raise FloatingPointError(
                f"more than {MAX_SUBSTEPS} CFL substeps (cfldt={cfl})")
    return out


def _sh(sub, h, sign=1.0):
    """Signed substep over h in float32, as the JAX kernels receive it."""
    return np.float32(np.float32(sign) * np.float32(sub)) / np.float32(h)


# ---------------------------------------------------------------------------
# RK3 tracing (Ralston's third-order scheme)
# ---------------------------------------------------------------------------


def window_faces(u, v, w, bf16):
    """The faces the window samplers read: None (the float32 faces
    themselves) or, in the bf16 mode, their bfloat16 rounding."""
    if not bf16:
        return None
    return tuple(f.to(interp_fast.BF16) for f in (u, v, w))


def _values(fields, window):
    """Stacked field values as the samplers read them: rounded to bfloat16
    in the bf16 mode, as the JAX package pads its value windows."""
    stacked = torch.stack(list(fields))
    return stacked if window is None else stacked.to(interp_fast.BF16)


def _clamp_grid(grid, lo=1.0, hi=1.0):
    return (float(lo), float(grid.ni - hi), float(lo), float(grid.nj - hi),
            float(lo), float(grid.nk - hi))


def trace_rk3_3d(grid, u, v, w, dt, px, py, pz, lo=1.0, hi=1.0):
    """One RK3 step of world positions by `dt`, clamped to
    [lo*h, L - hi*h] per axis."""
    h = grid.h
    pos = torch.stack([interp.div_scalar(p, h) for p in (px, py, pz)])
    out = interp_fast.rk3_substep(u, v, w, pos, _sh(abs(dt), h,
                                                    1.0 if dt >= 0 else -1.0),
                                  _clamp_grid(grid, lo, hi))
    return out[0] * h, out[1] * h, out[2] * h


def _staggered_axis(grid, kind):
    """The axis along which `kind` is staggered; None for the cell kind."""
    dim = grid.dim_of(kind)
    return dim.index(1) if any(dim) else None


def _cropped_positions(grid, kind, device=None):
    """Exact grid coordinates (i - 0.5*dim per axis) of `kind`'s nodes
    cropped to the (ni, nj, nk) cell block, stacked (3, ni, nj, nk), and
    the staggered axis. The staggered axis's last face plane sits outside
    the semi-Lagrangian update band, so it is neither traced nor
    sampled."""
    return (interp_fast.lattice_positions(grid.shape_c, grid.dim_of(kind),
                                          device),
            _staggered_axis(grid, kind))


def trace_3d(grid, u, v, w, cfldt, dt, px, py, pz, from_identity=False,
             kind="c", window=None):
    """CFL-substepped RK3 trace of world positions by `dt` (signed).
    ``from_identity=True`` asserts the positions are `kind`'s node
    lattice cropped to the cell block (px, py, pz are then not read); the
    march starts from the exact lattice coordinates (the JAX package's
    identity peel, whose stage 1 is the staggered average there): its
    first substep is ``rk3_substep_lattice``, which on the card forms
    them in the kernel, so the lattice is never materialized there.
    `window`: the bf16 mode's faces (``window_faces``), which every stage
    samples but the identity peel's first."""
    h = grid.h
    sign = 1.0 if dt >= 0 else -1.0
    clamp = _clamp_grid(grid)
    subs = substeps(cfldt, abs(dt))
    faces = (u, v, w) if window is None else window
    if from_identity and subs:
        pos = interp_fast.rk3_substep_lattice(
            *faces, grid.dim_of(kind), _sh(subs[0], h, sign), clamp,
            stage1=None if window is None else (u, v, w))
        subs = subs[1:]
    elif from_identity:
        pos, _ = _cropped_positions(grid, kind, u.device)
    else:
        pos = torch.stack([interp.div_scalar(p, h) for p in (px, py, pz)])
    for sub in subs:
        pos = interp_fast.rk3_substep(*faces, pos, _sh(sub, h, sign), clamp)
    return pos[0] * h, pos[1] * h, pos[2] * h


def update_forward_map_3d(grid, u, v, w, map_xyz, cfldt, dt,
                          from_identity=False, window=None):
    """Forward-map march X <- trace(X, +dt); outside the interior band
    (interior_mask('c', 2, 3)) the old map is kept."""
    mx, my, mz = map_xyz
    ox, oy, oz = trace_3d(grid, u, v, w, cfldt, dt, mx, my, mz,
                          from_identity=from_identity, window=window)
    mask = grid.interior_mask("c", lo=2, hi=3, device=mx.device)
    return (torch.where(mask, ox, mx), torch.where(mask, oy, my),
            torch.where(mask, oz, mz))


# ---------------------------------------------------------------------------
# Semi-Lagrangian advection
# ---------------------------------------------------------------------------


def _pad_plane(out_crop, src, ax):
    """Re-expand a cropped-lattice result to the kind's lattice: the
    dropped face plane keeps `src` (it is outside the update band)."""
    if ax is None:
        return out_crop
    return torch.cat([out_crop, src.narrow(ax, src.shape[ax] - 1, 1)], dim=ax)


def semilag_multi_3d(grid, kind, fields, u, v, w, cfldt, dt, window=None):
    """Trace each node of `kind`'s lattice by `dt` (signed; pass -dt to
    backtrace) once and sample every field of `fields` there (plain
    trilinear). Nodes outside the update band
    interior_mask(kind, 2, 3, hi_add_dim=True) keep their values.
    `window`: the bf16 mode's faces (the fields are then sampled
    rounded)."""
    ax = _staggered_axis(grid, kind)
    bx, by, bz = trace_3d(grid, u, v, w, cfldt, dt, None, None, None,
                          from_identity=True, kind=kind, window=window)
    off = grid.off_of(kind)
    out = interp_fast.trilerp_sample(
        _values(fields, window), bx.contiguous(), by.contiguous(),
        bz.contiguous(), grid.h, (off,) * len(fields), dual=False)
    mask = grid.interior_mask(kind, lo=2, hi=3, device=u.device,
                              hi_add_dim=True)
    return [torch.where(mask, _pad_plane(out[i], f, ax), f)
            for i, f in enumerate(fields)]


def semilag_3d(grid, kind, field_src, u, v, w, cfldt, dt, window=None):
    return semilag_multi_3d(grid, kind, [field_src], u, v, w, cfldt, dt,
                            window)[0]


def semilag_kinds_3d(grid, groups, u, v, w, cfldt, dt, window=None):
    """semilag_multi_3d over several (kind, [fields]) groups; one field
    list per group."""
    return [semilag_multi_3d(grid, k, fs, u, v, w, cfldt, dt, window)
            for k, fs in groups]


# ---------------------------------------------------------------------------
# MacCormack
# ---------------------------------------------------------------------------


def _trace_clamp(grid, kind, srcs, fwds, backs, packed, dt, window=None):
    """The trace clamp of maccormack_multi_3d: the MacCormack corrections
    fwd + 0.5*(src - back) of every field, replaced by the trilinear
    sample of src at the two-stage midpoint backtrace wherever they leave
    the min/max of src's 8 corners there. `packed` is the MAC triplet
    (interp.mac_pack_3d); both midpoint stages sample it with one C=3
    ``trilerp_sample`` launch each (stage 1 at the lattice itself, the
    staggered average there), the second, in the bf16 mode, the pack of
    `window` instead. One ``minmax_sample`` launch in its sample mode
    gives the min/max and the fallback sample from the same 8 corners (of
    the rounded fields in the bf16 mode). The positions are not clamped
    into the domain: near walls the corner indices clamp instead."""
    h = grid.h
    pos, ax = _cropped_positions(grid, kind, srcs[0].device)
    px, py, pz = pos * h      # the kind's world lattice, as node_coords
    vel1 = interp_fast.trilerp_sample(packed, px, py, pz, h, interp.MAC_OFFS)
    mx_ = px - 0.5 * dt * vel1[0]
    my_ = py - 0.5 * dt * vel1[1]
    mz_ = pz - 0.5 * dt * vel1[2]
    vel2 = interp_fast.trilerp_sample(
        packed if window is None else interp.mac_pack_3d(*window), mx_,
        my_, mz_, h, interp.MAC_OFFS)
    bx, by, bz = px - dt * vel2[0], py - dt * vel2[1], pz - dt * vel2[2]
    stacked = _values(srcs, window)
    offs = (grid.off_of(kind),) * len(srcs)
    mn, mx, fallback = interp_fast.minmax_sample(stacked, bx, by, bz, h, offs,
                                                 sample=True)
    crop = tuple(slice(0, s) for s in px.shape)
    outs = []
    for c, (src, fwd, back) in enumerate(zip(srcs, fwds, backs)):
        dst = (fwd + 0.5 * (src - back))[crop]
        clamped = torch.where((dst < mn[c]) | (dst > mx[c]), fallback[c], dst)
        outs.append(_pad_plane(clamped, src, ax))
    return outs


def maccormack_kinds_3d(grid, groups, u, v, w, cfldt, dt, window=None):
    """MacCormack over several (kind, [fields], clamp) groups: a backward
    semilag stage (trace by -dt), a forward one (+dt) of its result, the
    correction fwd + 0.5*(src - back) and a clamp. `clamp` is 'trace'
    (the scalar clamp: corner min/max at the midpoint backtrace with the
    semilag fallback, clamp_extrema_kernel) or 'neighborhood' (the
    velocity clamp: the 27-point clamp of the unrounded fields,
    clampExtrema_kernel). `window`: the bf16 mode's faces."""
    packed = None
    outs = []
    for kind, fields, clamp in groups:
        fwds = semilag_multi_3d(grid, kind, fields, u, v, w, cfldt, -dt,
                                window)
        backs = semilag_multi_3d(grid, kind, fwds, u, v, w, cfldt, dt,
                                 window)
        if clamp == "trace":
            if packed is None:
                packed = interp.mac_pack_3d(u, v, w)
            outs.append(_trace_clamp(grid, kind, fields, fwds, backs, packed,
                                     dt, window))
        elif clamp == "neighborhood":
            outs.append([clamp_extrema_neighborhood(s, f + 0.5 * (s - b))
                         for s, f, b in zip(fields, fwds, backs)])
        else:
            raise ValueError(f"unknown clamp {clamp!r}")
    return outs


def maccormack_multi_3d(grid, kind, srcs, u, v, w, cfldt, dt, window=None):
    """MacCormack of several same-kind fields sharing every trace, with
    the trace clamp."""
    return maccormack_kinds_3d(grid, [(kind, srcs, "trace")], u, v, w,
                               cfldt, dt, window)[0]


def maccormack_3d(grid, kind, src, u, v, w, cfldt, dt, window=None):
    return maccormack_multi_3d(grid, kind, [src], u, v, w, cfldt, dt,
                               window)[0]


# ---------------------------------------------------------------------------
# DMC backward-map march
# ---------------------------------------------------------------------------


def dmc_displacements_3d(grid, u, v, w, substep):
    """Signed DMC exponential-step displacements (grid cells) at the cell
    lattice for one substep."""
    return interp_fast.dmc_displacements(
        u, v, w, float(_sh(substep, grid.h)),
        interp_fast.dmc_threshold(grid.h))


def dmc_backward_identity_3d(grid, u, v, w, substep):
    """One DMC substep applied to the identity backward map: sampling the
    identity at the new position is the position itself clamped to the
    lattice-value range [0, (n-1)h]. The lattice mode of ``dmc_substep``,
    which on the card forms the positions in the kernel."""
    out = interp_fast.dmc_substep_lattice(
        u, v, w, float(_sh(substep, grid.h)),
        interp_fast.dmc_threshold(grid.h), grid.h)
    return out[0], out[1], out[2]


def dmc_backward_step_3d(grid, u, v, w, map_x, map_y, map_z, substep):
    """One DMC substep of the 3D backward map (world coordinates)."""
    out = interp_fast.dmc_substep(
        u, v, w, torch.stack([map_x, map_y, map_z]),
        float(_sh(substep, grid.h)), interp_fast.dmc_threshold(grid.h))
    return out[0], out[1], out[2]


def update_backward_map_3d(grid, u, v, w, map_xyz, cfldt, dt,
                           from_identity=False, window=None):
    """CFL-substepped backward-map update, one ``dmc_substep`` launch a
    substep. ``from_identity=True`` asserts the incoming map is the
    identity: substep 1 is then the lattice mode
    ``dmc_substep_lattice``, which on the card forms the identity in the
    kernel, so no map, index or displacement tensor is built for it. It
    reads the float32 faces; the later substeps read `window` in the bf16
    mode (the JAX package's bf16 MAC pack)."""
    subs = substeps(cfldt, dt)
    h = grid.h
    thresh = interp_fast.dmc_threshold(h)
    if from_identity and subs:
        maps = interp_fast.dmc_substep_lattice(
            u, v, w, float(_sh(subs[0], h)), thresh, h)
        subs = subs[1:]
    else:
        maps = torch.stack(list(map_xyz))
    faces = (u, v, w) if window is None else window
    for sub in subs:
        maps = interp_fast.dmc_substep(*faces, maps, float(_sh(sub, h)),
                                       thresh)
    return maps[0], maps[1], maps[2]


# ---------------------------------------------------------------------------
# Extrema clamping
# ---------------------------------------------------------------------------


def clamp_extrema_neighborhood(before, after):
    """Neighbourhood clamp of `after` to the min/max of `before` over the
    SAME window: in 3D the 27 points, interior nodes only; in 2D the 9
    points, every node (the window padded with -inf/+inf)."""
    x = before[None, None]
    if before.dim() == 2:
        mx = torch.nn.functional.max_pool2d(x, 3, stride=1, padding=1)[0, 0]
        mn = -torch.nn.functional.max_pool2d(-x, 3, stride=1,
                                             padding=1)[0, 0]
        return torch.minimum(torch.maximum(after, mn), mx)
    if before.dim() != 3:
        raise ValueError(f"extrema clamp of a {before.dim()}-D field")
    mx = torch.nn.functional.max_pool3d(x, 3, stride=1, padding=1)[0, 0]
    mn = -torch.nn.functional.max_pool3d(-x, 3, stride=1, padding=1)[0, 0]
    clamped = torch.minimum(torch.maximum(after, mn), mx)
    out = after.clone()
    out[1:-1, 1:-1, 1:-1] = clamped[1:-1, 1:-1, 1:-1]
    return out


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------


def trace_rk3_2d(u, v, h, dt, px, py):
    """One Ralston RK3 step of world positions by the signed float32 `dt`
    through the 2D MAC velocity, clamped to [0.001h, L - 0.001h]: one
    launch of the ``bilerp_sample`` kernel's trace mode."""
    pos = interp_fast.bilerp_trace(u, v, h, [dt], (px, py)).pos
    return pos[0], pos[1]


def trace_substeps(cfldt, dt):
    """The signed float32 substeps of a CFL-substepped trace by `dt`
    (signed), on the float32 schedule of the JAX loop."""
    sign = np.float32(1.0 if dt >= 0 else -1.0)
    return [sign * sub for sub in substeps(cfldt, abs(np.float32(dt)))]


def trace_2d(u, v, h, cfldt, dt, px, py):
    """CFL-substepped RK3 trace of world positions by `dt` (signed), on
    the float32 substep schedule of the JAX loop: one trace-mode launch."""
    pos = interp_fast.bilerp_trace(u, v, h, trace_substeps(cfldt, dt),
                                   (px, py)).pos
    return pos[0], pos[1]


def _semilag_2d_at(grid, kind, fields, u, v, cfldt, dt, minmax=False,
                   foot=False):
    """Backtrace `kind`'s nodes by -dt and sample every field of `fields`
    there, in one trace-mode launch that forms the lattice itself; with
    `minmax` also each field's corner min/max there, with `foot` the
    foot positions. Returns the ``interp_fast.TraceOut``."""
    off = grid.off_of(kind)
    return interp_fast.bilerp_trace(
        u, v, grid.h, trace_substeps(cfldt, -np.float32(dt)),
        interp_fast.Lattice2D(grid.shape_of(kind), off), fields, off,
        minmax=minmax, write_pos=foot)


def semilag_multi_2d(grid, kind, fields, u, v, cfldt, dt):
    """2D semiLagAdvect of several same-kind fields sharing one trace:
    each node of `kind` is traced by -dt and the fields sampled there."""
    return list(_semilag_2d_at(grid, kind, fields, u, v, cfldt,
                               dt).samples)


def semilag_2d(grid, kind, field_src, u, v, w_unused, cfldt, dt):
    """2D semiLagAdvect: traces `kind`'s nodes with -dt."""
    del w_unused
    return semilag_multi_2d(grid, kind, [field_src], u, v, cfldt, dt)[0]


def _clamp_2d(dsts, mins, maxs, fallbacks):
    """The corner clamp of solveMaccormack: where a field's dst leaves the
    min/max of its src's 4 clamped bilinear corners at the backtrace
    (from the trace kernel), take the fallback sample there."""
    return [torch.where((dst < mn) | (dst > mx), fb, dst)
            for dst, mn, mx, fb in zip(dsts, mins, maxs, fallbacks)]


def _maccormack_clamp_2d(grid, kind, src, dst, u, v, cfldt, dt):
    """Corner min/max fallback clamp of solveMaccormack, standalone: its
    own backtrace by -dt, fallback sample of src and min/max there."""
    fwd = _semilag_2d_at(grid, kind, [src], u, v, cfldt, dt, minmax=True)
    return _clamp_2d([dst], fwd.min, fwd.max, fwd.samples)[0]


def maccormack_multi_2d(grid, kind, srcs, u, v, cfldt, dt):
    """solveMaccormack of several same-kind fields sharing every trace:
    fwd = SL(src, dt), back = SL(fwd, -dt), dst = fwd + 0.5*(src - back),
    clamped at fwd's backtrace with fwd as the fallback."""
    fwd = _semilag_2d_at(grid, kind, srcs, u, v, cfldt, dt, minmax=True)
    fwds = list(fwd.samples)
    backs = semilag_multi_2d(grid, kind, fwds, u, v, cfldt, -np.float32(dt))
    dsts = [f + 0.5 * (s - b) for s, f, b in zip(srcs, fwds, backs)]
    return _clamp_2d(dsts, fwd.min, fwd.max, fwds)


def maccormack_2d(grid, kind, src, u, v, cfldt, dt):
    return maccormack_multi_2d(grid, kind, [src], u, v, cfldt, dt)[0]


def bfecc_multi_2d(grid, kind, srcs, u, v, cfldt, dt):
    """solveBFECC of several same-kind fields sharing every trace: fwd =
    SL(src, dt), back = SL(fwd, -dt), dst = SL(0.5*(3 src - back), dt)
    (sampled at fwd's backtrace), clamped there with fwd as fallback."""
    fwd = _semilag_2d_at(grid, kind, srcs, u, v, cfldt, dt, minmax=True,
                         foot=True)
    fwds = list(fwd.samples)
    backs = semilag_multi_2d(grid, kind, fwds, u, v, cfldt, -np.float32(dt))
    mids = [0.5 * (3.0 * s - b) for s, b in zip(srcs, backs)]
    off = grid.off_of(kind)
    dsts = interp.sample2_lattice_multi(mids, fwd.pos[0], fwd.pos[1], grid.h,
                                        (off,) * len(mids))
    return _clamp_2d(list(dsts), fwd.min, fwd.max, fwds)


def bfecc_2d(grid, kind, src, u, v, cfldt, dt):
    return bfecc_multi_2d(grid, kind, [src], u, v, cfldt, dt)[0]


def _sample_map_2d(grid, maps, px, py):
    """The stacked (2, ni, nj) map sampled at world positions (one C=2
    launch), not clamped."""
    return interp_fast.bilerp_sample(maps, px, py, grid.h,
                                     (grid.OFF_C, grid.OFF_C))


def dmc_backward_step_2d(grid, u, v, map_x, map_y, substep):
    """One 2D DMC substep (semiLagAdvectDMC): the cell-centre map sampled
    at the DMC-traced position, clamped to [h, L - h]: one launch of the
    ``bilerp_sample`` kernel's DMC mode."""
    out = interp_fast.bilerp_dmc(u, v, map_x, map_y, grid.h, [substep])
    return out[0], out[1]


def backward_map_2d(grid, u, v, map_xy, cfldt, dt):
    """CFL-substepped 2D backward-map update, one DMC-mode launch a
    substep: the stacked (2, ni, nj) map."""
    return interp_fast.bilerp_dmc(u, v, map_xy[0], map_xy[1], grid.h,
                                  substeps(cfldt, dt))


def update_backward_map_2d(grid, u, v, map_xy, cfldt, dt):
    """``backward_map_2d``'s x and y."""
    maps = backward_map_2d(grid, u, v, map_xy, cfldt, dt)
    return maps[0], maps[1]


def forward_map_2d(grid, u, v, map_xy, cfldt, dt):
    """2D forward-map march X <- trace(X, +dt), clamped to [h, L - h], in
    one trace-mode launch: the stacked (2, ni, nj) map."""
    return interp_fast.bilerp_trace(
        u, v, grid.h, trace_substeps(cfldt, dt), tuple(map_xy),
        final_clamp=interp.clamp_bounds_2d(grid.h, grid.ni, grid.nj)).pos


def update_forward_map_2d(grid, u, v, map_xy, cfldt, dt):
    """``forward_map_2d``'s x and y."""
    pos = forward_map_2d(grid, u, v, map_xy, cfldt, dt)
    return pos[0], pos[1]
