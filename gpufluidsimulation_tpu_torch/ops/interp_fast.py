"""Sampler, corner min/max, RK3-substep and DMC-substep kernels with their
plain versions.

Counterpart of ``gpufluidsimulation_tpu.ops.interp_fast``. Each wrapper
takes the plain PyTorch version for a CPU tensor and launches its CUDA
kernel (``csrc/``) for a CUDA tensor; anything else raises. A wrapper adds
one to its ``launches`` count for every kernel launch and nowhere else.

The kernels gather exactly with clamped indices, as
``gpufluidsimulation_tpu.core.interp.sample3`` does. The TPU kernels'
windows, reach contract and coverage renormalization have no counterpart
here, so nothing is ever truncated and the port's ``interp_overflow`` is
always 0.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.core.grids import band_mask
from gpufluidsimulation_tpu_torch.ops import _build

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p
_LL = ctypes.c_longlong

# _VOL3 corner order of gpufluidsimulation_tpu.bimocq.mapping
_VOL3 = (
    (0.25, 0.25, 0.25), (0.25, 0.25, -0.25), (0.25, -0.25, 0.25),
    (0.25, -0.25, -0.25), (-0.25, 0.25, 0.25), (-0.25, 0.25, -0.25),
    (-0.25, -0.25, 0.25), (-0.25, -0.25, -0.25),
)
MAX_CHANNELS = 4


def _check_sample_args(name, fields, offs, px, py, pz):
    C = fields.shape[0]
    if not 1 <= C <= MAX_CHANNELS or len(offs) != C:
        raise ValueError(f"{name}: need 1..{MAX_CHANNELS} channels with one "
                         f"offset each, got {C} and {len(offs)}")
    _build.require(fields, "fields", ndim=4)
    for pname, p in (("px", px), ("py", py), ("pz", pz)):
        _build.require(p, pname, shape=px.shape)
        if p.device != fields.device:
            raise ValueError(f"{name}: {pname} on {p.device}, fields on "
                             f"{fields.device}")
    return C


# ---------------------------------------------------------------------------
# trilerp_sample
# ---------------------------------------------------------------------------


def trilerp_sample_plain(fields, px, py, pz, h, offs, dual=False):
    """Plain version: (C, *px.shape) samples of the C stacked fields."""
    x, y, z = (interp.div_scalar(p, h) for p in (px, py, pz))
    outs = []
    for c in range(fields.shape[0]):
        f = fields[c]
        gx, gy, gz = x - offs[c][0], y - offs[c][1], z - offs[c][2]
        center = interp.trilerp_grid(f, gx, gy, gz)
        if dual:
            acc = None
            for dx, dy, dz in _VOL3:
                t = interp.trilerp_grid(f, gx + dx, gy + dy, gz + dz)
                acc = t if acc is None else acc + t
            center = 0.5 * (acc / 8.0) + 0.5 * center
        outs.append(center)
    return torch.stack(outs)


def trilerp_sample(fields, px, py, pz, h, offs, dual=False):
    """Sample C stacked same-shape fields (C, nx, ny, nz) at world
    positions (px, py, pz), channel c on the lattice (i + offs[c])*h.
    ``dual=True`` gives the 9-point volume blend 0.5*mean of the 8
    (+-h/4)^3 corner samples + 0.5*centre sample. Returns (C, *px.shape).
    """
    if not _build.on_card(fields, "trilerp_sample"):
        return trilerp_sample_plain(fields, px, py, pz, h, offs, dual)
    C = _check_sample_args("trilerp_sample", fields, offs, px, py, pz)
    out = torch.empty((C,) + tuple(px.shape), dtype=torch.float32,
                      device=fields.device)
    offs_host = (_F * (3 * C))(*[float(o) for off in offs for o in off])
    fn = _build.function(
        "trilerp_sample", "gfs_trilerp_sample",
        [_P, _I, _I, _I, _I, _P, _P, _P, _LL, _F,
         ctypes.POINTER(_F), _I, _P, _P])
    with torch.cuda.device(fields.device):
        err = fn(_build.ptr(fields), C, *fields.shape[1:], _build.ptr(px),
                 _build.ptr(py), _build.ptr(pz), px.numel(), float(h),
                 offs_host, int(bool(dual)), _build.ptr(out),
                 _build.stream(fields))
    _build.check(err, "trilerp_sample")
    trilerp_sample.launches += 1
    return out


trilerp_sample.launches = 0


# ---------------------------------------------------------------------------
# minmax_sample
# ---------------------------------------------------------------------------


def minmax_sample_plain(fields, px, py, pz, h, offs):
    """Plain version: (mn, mx), each (C, *px.shape), the min and max of
    the 8 clamped trilinear corner values of each field."""
    x, y, z = (interp.div_scalar(p, h) for p in (px, py, pz))
    mns, mxs = [], []
    for c in range(fields.shape[0]):
        vals, _ = interp.corners_grid(fields[c], x - offs[c][0],
                                      y - offs[c][1], z - offs[c][2])
        mn = mx = vals[0]
        for val in vals[1:]:
            mn = torch.minimum(mn, val)
            mx = torch.maximum(mx, val)
        mns.append(mn)
        mxs.append(mx)
    return torch.stack(mns), torch.stack(mxs)


def minmax_sample(fields, px, py, pz, h, offs):
    """Min and max over the 8 trilinear corners of C stacked same-shape
    fields (C, nx, ny, nz) at world positions (px, py, pz), channel c on
    the lattice (i + offs[c])*h; corner indices are clamped to the field,
    so positions outside the domain are taken as they come. Returns
    (mn, mx), each (C, *px.shape)."""
    if not _build.on_card(fields, "minmax_sample"):
        return minmax_sample_plain(fields, px, py, pz, h, offs)
    C = _check_sample_args("minmax_sample", fields, offs, px, py, pz)
    out = torch.empty((2, C) + tuple(px.shape), dtype=torch.float32,
                      device=fields.device)
    offs_host = (_F * (3 * C))(*[float(o) for off in offs for o in off])
    fn = _build.function(
        "minmax_sample", "gfs_minmax_sample",
        [_P, _I, _I, _I, _I, _P, _P, _P, _LL, _F,
         ctypes.POINTER(_F), _P, _P, _P])
    with torch.cuda.device(fields.device):
        err = fn(_build.ptr(fields), C, *fields.shape[1:], _build.ptr(px),
                 _build.ptr(py), _build.ptr(pz), px.numel(), float(h),
                 offs_host, _build.ptr(out[0]), _build.ptr(out[1]),
                 _build.stream(fields))
    _build.check(err, "minmax_sample")
    minmax_sample.launches += 1
    return out[0], out[1]


minmax_sample.launches = 0


# ---------------------------------------------------------------------------
# rk3_substep
# ---------------------------------------------------------------------------


def rk3_coefficients(sh):
    """float32 stage coefficients (a, b, c1, c2, c3) of one substep with
    signed substep-over-h `sh` (a float32 value), rounded as the JAX
    kernel rounds them."""
    sh = np.float32(sh)
    return tuple(float(np.float32(k) * sh) for k in
                 (0.5, 0.75, 2.0 / 9.0, 3.0 / 9.0, 4.0 / 9.0))


def rk3_substep_plain(u, v, w, pos, sh, clamp):
    """Plain version: one RK3 substep of stacked grid-coordinate positions
    (3, ...) through the MAC velocity, clamped to clamp = (lo_x, hi_x,
    lo_y, hi_y, lo_z, hi_z) in grid units."""
    a, b, c1, c2, c3 = rk3_coefficients(sh)
    gx, gy, gz = pos[0], pos[1], pos[2]
    u1, v1, w1 = interp.mac_velocity_grid(u, v, w, gx, gy, gz)
    u2, v2, w2 = interp.mac_velocity_grid(u, v, w, gx + a * u1, gy + a * v1,
                                          gz + a * w1)
    u3, v3, w3 = interp.mac_velocity_grid(u, v, w, gx + b * u2, gy + b * v2,
                                          gz + b * w2)
    ox = gx + c1 * u1 + c2 * u2 + c3 * u3
    oy = gy + c1 * v1 + c2 * v2 + c3 * v3
    oz = gz + c1 * w1 + c2 * w2 + c3 * w3
    return torch.stack([ox.clamp(clamp[0], clamp[1]),
                        oy.clamp(clamp[2], clamp[3]),
                        oz.clamp(clamp[4], clamp[5])])


def rk3_substep(u, v, w, pos, sh, clamp):
    """One Ralston RK3 substep of the characteristic trace: `pos` is
    stacked (3, ...) cell-lattice grid coordinates (p/h), `sh` the signed
    substep over h, `clamp` the per-axis bounds in grid units. u, v, w are
    the MAC faces of an (ni, nj, nk) grid."""
    if not _build.on_card(pos, "rk3_substep"):
        return rk3_substep_plain(u, v, w, pos, sh, clamp)
    ni, nj, nk = v.shape[0], u.shape[1], u.shape[2]
    _build.require(u, "u", shape=(ni + 1, nj, nk))
    _build.require(v, "v", shape=(ni, nj + 1, nk))
    _build.require(w, "w", shape=(ni, nj, nk + 1))
    _build.require(pos, "pos")
    if pos.dim() < 2 or pos.shape[0] != 3:
        raise ValueError(f"rk3_substep: pos must be (3, ...), got "
                         f"{tuple(pos.shape)}")
    if not (u.device == v.device == w.device == pos.device):
        raise ValueError("rk3_substep: tensors on different devices")
    out = torch.empty_like(pos)
    a, b, c1, c2, c3 = rk3_coefficients(sh)
    clamp_host = (_F * 6)(*[float(c) for c in clamp])
    fn = _build.function(
        "rk3_substep", "gfs_rk3_substep",
        [_P, _P, _P, _I, _I, _I, _P, _LL, _F, _F, _F, _F, _F,
         ctypes.POINTER(_F), _P, _P])
    with torch.cuda.device(pos.device):
        err = fn(_build.ptr(u), _build.ptr(v), _build.ptr(w), ni, nj, nk,
                 _build.ptr(pos), pos[0].numel(), a, b, c1, c2, c3,
                 clamp_host, _build.ptr(out), _build.stream(pos))
    _build.check(err, "rk3_substep")
    rk3_substep.launches += 1
    return out


rk3_substep.launches = 0


# ---------------------------------------------------------------------------
# dmc_substep
# ---------------------------------------------------------------------------


def dmc_threshold(h):
    """The |du| > 1e-4*h exponential-step guard, as a float32 value."""
    return float(np.float32(1e-4 * h))


def _upwind_corner(f, sx, sy, sz):
    """f at the diagonal upwind neighbour of each cell (i-1 where the
    sign mask is set, else i+1, per axis), edge-clamped."""
    nx, ny, nz = f.shape
    dev = f.device
    ii = torch.arange(nx, device=dev)[:, None, None]
    jj = torch.arange(ny, device=dev)[None, :, None]
    kk = torch.arange(nz, device=dev)[None, None, :]
    ti = torch.where(sx, ii - 1, ii + 1).clamp(0, nx - 1)
    tj = torch.where(sy, jj - 1, jj + 1).clamp(0, ny - 1)
    tk = torch.where(sz, kk - 1, kk + 1).clamp(0, nz - 1)
    return f.reshape(-1)[(ti * ny + tj) * nz + tk]


def dmc_displacements(u, v, w, sh, thresh):
    """Signed exponential DMC displacements (cells) at the cell lattice for
    one substep (advect.dmc_displacements_3d, the kernel's arithmetic)."""
    vel = interp.mac_velocity_at_c_3d(u, v, w)
    signs = [c > 0 for c in vel]
    outs = []
    for velc, s_ in zip(vel, signs):
        t = _upwind_corner(velc, *signs)
        sgn = torch.where(s_, 1.0, -1.0)
        du = velc - t
        q = du * sgn * sh
        safe = du.abs() > thresh
        denom = torch.where(safe, du * sgn, 1.0)
        outs.append(torch.where(safe, (1.0 - torch.exp(-q)) * velc / denom,
                                velc * sh))
    return tuple(outs)


def dmc_substep_plain(u, v, w, maps, sh, thresh):
    """Plain version: the backward map (3, ni, nj, nk) after one DMC
    substep; cells outside the interior band keep the old map."""
    dx, dy, dz = dmc_displacements(u, v, w, sh, thresh)
    shape = maps.shape[1:]
    dev = maps.device
    gx = torch.arange(shape[0], dtype=maps.dtype, device=dev)[:, None, None] - dx
    gy = torch.arange(shape[1], dtype=maps.dtype, device=dev)[None, :, None] - dy
    gz = torch.arange(shape[2], dtype=maps.dtype, device=dev)[None, None, :] - dz
    band = band_mask(shape, (2, 2, 2), (3, 3, 3), dev)   # interior_mask('c')
    return torch.stack([
        torch.where(band, interp.trilerp_grid(maps[c], gx, gy, gz), maps[c])
        for c in range(3)])


def dmc_substep(u, v, w, maps, sh, thresh):
    """One fused DMC backward-map substep: `maps` is the stacked (3, ni,
    nj, nk) backward map in world coordinates, `sh` the substep over h,
    `thresh` the float32 1e-4*h guard (dmc_threshold)."""
    if not _build.on_card(maps, "dmc_substep"):
        return dmc_substep_plain(u, v, w, maps, sh, thresh)
    ni, nj, nk = v.shape[0], u.shape[1], u.shape[2]
    _build.require(u, "u", shape=(ni + 1, nj, nk))
    _build.require(v, "v", shape=(ni, nj + 1, nk))
    _build.require(w, "w", shape=(ni, nj, nk + 1))
    _build.require(maps, "maps", shape=(3, ni, nj, nk))
    if not (u.device == v.device == w.device == maps.device):
        raise ValueError("dmc_substep: tensors on different devices")
    out = torch.empty_like(maps)
    fn = _build.function(
        "dmc_substep", "gfs_dmc_substep",
        [_P, _P, _P, _I, _I, _I, _P, _F, _F, _P, _P])
    with torch.cuda.device(maps.device):
        err = fn(_build.ptr(u), _build.ptr(v), _build.ptr(w), ni, nj, nk,
                 _build.ptr(maps), float(sh), float(thresh),
                 _build.ptr(out), _build.stream(maps))
    _build.check(err, "dmc_substep")
    dmc_substep.launches += 1
    return out


dmc_substep.launches = 0
