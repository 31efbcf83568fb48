"""Sampler, corner min/max, RK3-substep, DMC-substep, volume-prefilter,
vol9-fixup and fused multi-kind pull-back kernels with their plain
versions: every TPU kernel of the JAX module has its counterpart here.
The 2D solver's samples (the JAX package's ``sample2_fast`` and
``mac2_fast``, its 3D window sampler lifted onto a singleton axis) go
through a 2D kernel of their own, ``bilerp_sample``: its mac mode
``bilerp_sample_mac``, its cp mode ``bilerp_sample_cp``, its trace mode
``bilerp_trace`` (a whole CFL-substepped 2D RK3 trace with its foot
samples and MacCormack corner min/max in one launch) and its DMC mode
``bilerp_dmc`` (one launch a substep of the 2D backward-map march).

Counterpart of ``gpufluidsimulation_tpu.ops.interp_fast``. Each wrapper
takes the plain PyTorch version for a CPU tensor and launches its CUDA
kernel (``csrc/``) for a CUDA tensor; anything else raises. A wrapper adds
one to its ``launches`` count for every kernel launch and nowhere else;
the wrappers with a slab mode also add one to their ``slab_launches`` for
each launch in that mode, and those with a bf16 mode to their
``bf16_launches`` for each launch in it.

The slab modes of ``trilerp_sample``, ``rk3_substep`` and ``dmc_substep``
(and their lattice modes) serve the sharded path
(``parallel/sharded_interp.py``): given a ``Slab``, the kernel runs on a
z-slab of the grid with its global coordinates, clamps each z node to the
global bounds and only then subtracts the slab's integer origin to
address it; a node outside the slab is clamped to its edge and counted
into an ``overflow`` tensor.

The kernels gather exactly with clamped indices, as
``gpufluidsimulation_tpu.core.interp.sample3`` does. The TPU kernels'
windows, reach contract and coverage renormalization have no counterpart
here, so nothing is ever truncated and the port's ``interp_overflow`` is
always 0.

The bf16 mode (``EngineMode.interp_bf16``, the JAX package's bf16 field
windows): ``trilerp_sample``, ``minmax_sample``, ``rk3_substep`` (and its
lattice mode) and ``dmc_substep`` take their field values (the sampled
fields, the MAC faces) as bfloat16 and widen each to float32 at its load;
positions, maps, bounds and outputs stay float32. Their plain versions
are the float32 ones on the widened values, so a bfloat16 launch equals
its plain version bit for bit. The slab modes, ``dmc_substep_lattice``
(the identity peel reads the unrounded faces, as in JAX) and the other
kernels take float32 only.

The vol9 fixup keeps the JAX package's adaptive decision: per block of
16 x 16 x (256 or 128) cell-lattice nodes and per channel, the dual
volume form is replaced by the exact 9-position composition wherever it
is not provably within ``tol * max|f|`` of it (``vol9_flags``, plain
torch on both devices, no host sync). The blocks are a decision
granularity, not the kernel's thread blocks.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import struct

import numpy as np
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.core.grids import band_mask, lattice_coords
from gpufluidsimulation_tpu_torch.ops import _build

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# a bytes object passed as the address of its buffer: packed arrays
_B = ctypes.c_char_p

# _VOL3 corner order of gpufluidsimulation_tpu.bimocq.mapping
_VOL3 = (
    (0.25, 0.25, 0.25), (0.25, 0.25, -0.25), (0.25, -0.25, 0.25),
    (0.25, -0.25, -0.25), (-0.25, 0.25, 0.25), (-0.25, 0.25, -0.25),
    (-0.25, -0.25, 0.25), (-0.25, -0.25, -0.25),
)
MAX_CHANNELS = 4
# the kernels index with 32-bit offsets
INT32_LIMIT = 2 ** 31


def check_int32(name, **counts):
    """Raise unless every count (of field values, positions or outputs) is
    below 2^31, so that a kernel's 32-bit offsets cannot overflow."""
    big = [f"{k} {v}" for k, v in counts.items() if v >= INT32_LIMIT]
    if big:
        raise ValueError(f"{name}: 32-bit offsets need fewer than 2^31 "
                         f"values, got {', '.join(big)}")


@dataclasses.dataclass(frozen=True)
class Slab:
    """Where a launch's arrays sit along z in a grid of `nz` cells, as
    integer global plane indices: `src` is plane 0 of the sampled array
    (the field, or the velocity faces' cell planes), `out` plane 0 of the
    output lattice and `out_nz` its planes (the lattice modes and
    ``dmc_substep``), `map` plane 0 of ``dmc_substep``'s map slab."""

    nz: int
    src: int = 0
    out: int = 0
    out_nz: int = 0
    map: int = 0


def _overflow_arg(slab, overflow, device):
    """The pointer a slab launch counts into (None on the whole grid, or
    where no count is asked for)."""
    if slab is None or overflow is None:
        return None
    if (overflow.dtype != torch.int32 or overflow.numel() != 1
            or overflow.device != device):
        raise ValueError("a slab launch counts into a one-element int32 "
                         f"tensor on {device}")
    return _build.ptr(overflow)


def _count(overflow, outside):
    """The plain versions' count: one per output node that used a node
    outside its slab."""
    if overflow is not None:
        overflow += outside.sum(dtype=torch.int32)


# the storage of field values in the bf16 mode (EngineMode.interp_bf16)
BF16 = torch.bfloat16


def is_bf16(name, *values):
    """True when the field values `values` are all bfloat16 (the bf16
    mode), False when none is (the kernels then take float32); a mix
    raises."""
    dtypes = {t.dtype for t in values}
    if BF16 not in dtypes:
        return False
    if dtypes == {BF16}:
        return True
    raise ValueError(f"{name}: field values must be all bfloat16 or none, "
                     f"got {sorted(str(d) for d in dtypes)}")


def widen(t):
    """The float32 values of a float32 or bfloat16 tensor (exact)."""
    return t if t.dtype == torch.float32 else t.float()


def _no_slab_bf16(name, bf16, slab):
    if bf16 and slab is not None:
        raise NotImplementedError(
            f"{name}: the bf16 mode (interp_bf16) of the slab mode, which "
            "the sharded step runs, is not ported")


def _check_sample_args(name, fields, offs, px, py, pz):
    C = fields.shape[0]
    if not 1 <= C <= MAX_CHANNELS or len(offs) != C:
        raise ValueError(f"{name}: need 1..{MAX_CHANNELS} channels with one "
                         f"offset each, got {C} and {len(offs)}")
    _build.require(fields, "fields", ndim=4, dtype=fields.dtype
                   if fields.dtype == BF16 else None)
    for pname, p in (("px", px), ("py", py), ("pz", pz)):
        _build.require(p, pname, shape=px.shape)
        if p.device != fields.device:
            raise ValueError(f"{name}: {pname} on {p.device}, fields on "
                             f"{fields.device}")
    return C


# ---------------------------------------------------------------------------
# trilerp_sample
# ---------------------------------------------------------------------------


def trilerp_sample_plain(fields, px, py, pz, h, offs, dual=False,
                         slab=None, overflow=None):
    """Plain version: (C, *px.shape) samples of the C stacked fields; on a
    slab (``Slab``: the fields hold planes slab.src .. of a grid of slab.nz)
    each output node that used a plane outside it adds 1 to `overflow`."""
    fields = widen(fields)
    x, y, z = (interp.div_scalar(p, h) for p in (px, py, pz))
    outside = []

    def lerp(f, gx, gy, gz):
        if slab is None:
            return interp.trilerp_grid(f, gx, gy, gz)
        val, out = interp.trilerp_grid_slab(f, gx, gy, gz, slab.src, slab.nz)
        outside.append(out)
        return val

    outs = []
    for c in range(fields.shape[0]):
        f = fields[c]
        gx, gy, gz = x - offs[c][0], y - offs[c][1], z - offs[c][2]
        center = lerp(f, gx, gy, gz)
        if dual:
            acc = None
            for dx, dy, dz in _VOL3:
                t = lerp(f, gx + dx, gy + dy, gz + dz)
                acc = t if acc is None else acc + t
            center = 0.5 * (acc / 8.0) + 0.5 * center
        outs.append(center)
    if outside:
        _count(overflow, torch.stack(outside).any(0))
    return torch.stack(outs)


def trilerp_sample(fields, px, py, pz, h, offs, dual=False, slab=None,
                   overflow=None):
    """Sample C stacked same-shape fields (C, nx, ny, nz) at world
    positions (px, py, pz), channel c on the lattice (i + offs[c])*h.
    ``dual=True`` gives the 9-point volume blend 0.5*mean of the 8
    (+-h/4)^3 corner samples + 0.5*centre sample. Returns (C, *px.shape).
    With a ``Slab`` the fields hold planes slab.src .. slab.src + nz - 1
    of a grid of slab.nz planes (the slab mode); positions stay global,
    and each output node that used a plane outside the slab adds 1 to the
    one-element int32 tensor `overflow`, when one is given. The fields
    may be bfloat16 (the bf16 mode, not on a slab).
    """
    bf16 = is_bf16("trilerp_sample", fields)
    _no_slab_bf16("trilerp_sample", bf16, slab)
    if not _build.on_card(fields, "trilerp_sample"):
        return trilerp_sample_plain(fields, px, py, pz, h, offs, dual, slab,
                                    overflow)
    C = _check_sample_args("trilerp_sample", fields, offs, px, py, pz)
    ov = _overflow_arg(slab, overflow, fields.device)
    check_int32("trilerp_sample", fields=fields.numel(),
                outputs=C * px.numel())
    out = torch.empty((C,) + tuple(px.shape), dtype=torch.float32,
                      device=fields.device)
    offs_host = (_F * (3 * C))(*[float(o) for off in offs for o in off])
    fn = _build.function(
        "trilerp_sample", "gfs_trilerp_sample",
        [_P, _I, _I, _I, _I, _I, _P, _P, _P, _LL, _I, _I, _F,
         ctypes.POINTER(_F), _I, _I, _I, _P, _P, _P])
    # the kernel tiles the output lattice by its last two extents
    d1, d2 = ((1,) * 2 + tuple(px.shape))[-2:]
    with _build.current(fields):
        err = fn(_build.ptr(fields), int(bf16), C, *fields.shape[1:],
                 _build.ptr(px),
                 _build.ptr(py), _build.ptr(pz), px.numel(), d1, d2,
                 float(h), offs_host, int(bool(dual)),
                 0 if slab is None else slab.nz,
                 0 if slab is None else slab.src, ov, _build.ptr(out),
                 _build.stream(fields))
    _build.check(err, "trilerp_sample")
    trilerp_sample.launches += 1
    trilerp_sample.slab_launches += slab is not None
    trilerp_sample.bf16_launches += bf16
    return out


trilerp_sample.launches = 0
trilerp_sample.slab_launches = 0
trilerp_sample.bf16_launches = 0


# ---------------------------------------------------------------------------
# minmax_sample
# ---------------------------------------------------------------------------


def minmax_sample_plain(fields, px, py, pz, h, offs, sample=False):
    """Plain version: (mn, mx), each (C, *px.shape), the min and max of
    the 8 clamped trilinear corner values of each field; with `sample`
    also ``trilerp_sample_plain``'s samples at the same positions."""
    fields = widen(fields)
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
    if sample:
        return (torch.stack(mns), torch.stack(mxs),
                trilerp_sample_plain(fields, px, py, pz, h, offs))
    return torch.stack(mns), torch.stack(mxs)


def minmax_check_sizes(field_shape, C, n_out):
    """Raise unless C fields of `field_shape` and `n_out` positions fit the
    minmax_sample kernel: at least 2 nodes along z (it loads the z corners
    in pairs) and 32-bit offsets."""
    if field_shape[2] < 2:
        raise ValueError(f"minmax_sample: the kernel needs 2 or more nodes "
                         f"along z, got {field_shape[2]}")
    check_int32("minmax_sample", fields=C * int(np.prod(field_shape)),
                outputs=C * n_out)


def minmax_sample(fields, px, py, pz, h, offs, sample=False):
    """Min and max over the 8 trilinear corners of C stacked same-shape
    fields (C, nx, ny, nz) at world positions (px, py, pz), channel c on
    the lattice (i + offs[c])*h; corner indices are clamped to the field,
    so positions outside the domain are taken as they come. Returns
    (mn, mx), each (C, *px.shape); with `sample` also the clamped
    trilinear samples there, which ``trilerp_sample`` (dual=False) gives,
    blended from the same corners in the same launch. The fields may be
    bfloat16 (the bf16 mode)."""
    bf16 = is_bf16("minmax_sample", fields)
    if not _build.on_card(fields, "minmax_sample"):
        return minmax_sample_plain(fields, px, py, pz, h, offs, sample)
    C = _check_sample_args("minmax_sample", fields, offs, px, py, pz)
    minmax_check_sizes(fields.shape[1:], C, px.numel())
    out = torch.empty((3 if sample else 2, C) + tuple(px.shape),
                      dtype=torch.float32, device=fields.device)
    offs_host = (_F * (3 * C))(*[float(o) for off in offs for o in off])
    fn = _build.function(
        "minmax_sample", "gfs_minmax_sample",
        [_P, _I, _I, _I, _I, _I, _P, _P, _P, _LL, _I, _I, _F,
         ctypes.POINTER(_F), _P, _P, _P, _P])
    # the kernel tiles the output lattice by its last two extents
    d1, d2 = ((1,) * 2 + tuple(px.shape))[-2:]
    with _build.current(fields):
        err = fn(_build.ptr(fields), int(bf16), C, *fields.shape[1:],
                 _build.ptr(px),
                 _build.ptr(py), _build.ptr(pz), px.numel(), d1, d2,
                 float(h), offs_host, _build.ptr(out[0]), _build.ptr(out[1]),
                 _build.ptr(out[2]) if sample else None,
                 _build.stream(fields))
    _build.check(err, "minmax_sample")
    minmax_sample.launches += 1
    minmax_sample.bf16_launches += bf16
    return tuple(out)


minmax_sample.launches = 0
minmax_sample.bf16_launches = 0


# ---------------------------------------------------------------------------
# rk3_substep
# ---------------------------------------------------------------------------


def rk3_coefficients(sh):
    """float32 stage coefficients (a, b, c1, c2, c3) of one substep with
    signed substep-over-h `sh` (a float32 value), rounded as the JAX
    kernel rounds them; of a 2D RK3 step with the signed substep itself
    (``advect.trace_rk3_2d``)."""
    return _rk3_coefficients(float(np.float32(sh)))


@functools.lru_cache(maxsize=1024)
def _rk3_coefficients(sh):
    # a march repeats its substeps: each set is made once
    sh = np.float32(sh)
    return tuple(float(np.float32(k) * sh) for k in
                 (0.5, 0.75, 2.0 / 9.0, 3.0 / 9.0, 4.0 / 9.0))


def _mac_velocity_slab(u, v, w, gx, gy, gz, slab, outside):
    """``interp.mac_velocity_grid``; on a slab (the faces hold the cell
    planes slab.src .. of a grid of slab.nz cells) each component's z
    corners are taken to the slab, and where one left it is appended to
    `outside`."""
    if slab is None:
        return interp.mac_velocity_grid(u, v, w, gx, gy, gz)
    vals = []
    for f, g, nz in ((u, (gx + 0.5, gy, gz), slab.nz),
                     (v, (gx, gy + 0.5, gz), slab.nz),
                     (w, (gx, gy, gz + 0.5), slab.nz + 1)):
        val, out = interp.trilerp_grid_slab(f, *g, slab.src, nz)
        vals.append(val)
        outside.append(out)
    return vals


def rk3_substep_plain(u, v, w, pos, sh, clamp, slab=None, overflow=None,
                      stage1=None):
    """Plain version: one RK3 substep of stacked grid-coordinate positions
    (3, ...) through the MAC velocity, clamped to clamp = (lo_x, hi_x,
    lo_y, hi_y, lo_z, hi_z) in grid units. On a slab (``Slab``: the faces
    hold the cell planes slab.src .. of a grid of slab.nz cells) each
    position that used a plane outside it adds 1 to `overflow`. The faces
    are widened to float32; `stage1`, when given, is the triplet the first
    stage samples instead (``rk3_substep_lattice``)."""
    a, b, c1, c2, c3 = rk3_coefficients(sh)
    u, v, w = widen(u), widen(v), widen(w)
    gx, gy, gz = pos[0], pos[1], pos[2]
    outside = []
    u1, v1, w1 = _mac_velocity_slab(*(stage1 or (u, v, w)), gx, gy, gz, slab,
                                    outside)
    u2, v2, w2 = _mac_velocity_slab(u, v, w, gx + a * u1, gy + a * v1,
                                    gz + a * w1, slab, outside)
    u3, v3, w3 = _mac_velocity_slab(u, v, w, gx + b * u2, gy + b * v2,
                                    gz + b * w2, slab, outside)
    ox = gx + c1 * u1 + c2 * u2 + c3 * u3
    oy = gy + c1 * v1 + c2 * v2 + c3 * v3
    oz = gz + c1 * w1 + c2 * w2 + c3 * w3
    if outside:
        _count(overflow, torch.stack(outside).any(0))
    return torch.stack([ox.clamp(clamp[0], clamp[1]),
                        oy.clamp(clamp[2], clamp[3]),
                        oz.clamp(clamp[4], clamp[5])])


def lattice_positions(shape, dim, device=None, z0=0):
    """Grid coordinates (i - 0.5*dim per axis) of the nodes of an (n0, n1,
    n2) block, stacked (3, n0, n1, n2): exact in float32. With the cell
    block's shape and a kind's face vector, that kind's nodes cropped to
    the cell block (``advect._cropped_positions``). `z0` is the block's
    first global plane (a slab of the lattice)."""
    ar = [torch.arange(o, o + n, dtype=torch.float32, device=device)
          - 0.5 * d for n, d, o in zip(shape, dim, (0, 0, z0))]
    return torch.stack([ar[0][:, None, None].expand(shape),
                        ar[1][None, :, None].expand(shape),
                        ar[2][None, None, :].expand(shape)])


def _faces(name, u, v, w, bf16=False):
    """The (ni, nj, nk) cell block of a MAC triplet on the card, checked
    (bfloat16 faces with `bf16`, else float32)."""
    ni, nj, nk = v.shape[0], u.shape[1], u.shape[2]
    dt = BF16 if bf16 else None
    _build.require(u, "u", shape=(ni + 1, nj, nk), dtype=dt)
    _build.require(v, "v", shape=(ni, nj + 1, nk), dtype=dt)
    _build.require(w, "w", shape=(ni, nj, nk + 1), dtype=dt)
    if not u.device == v.device == w.device:
        raise ValueError(f"{name}: tensors on different devices")
    return ni, nj, nk


def rk3_check_sizes(cell_shape, n):
    """Raise unless the MAC faces of an (ni, nj, nk) grid and `n`
    positions fit the rk3_substep kernel: nk >= 2 (it loads the z corners
    in pairs) and 32-bit offsets."""
    ni, nj, nk = cell_shape
    if nk < 2:
        raise ValueError(f"rk3_substep: the kernel needs nk >= 2, got {nk}")
    check_int32("rk3_substep", u=(ni + 1) * nj * nk, v=ni * (nj + 1) * nk,
                w=ni * nj * (nk + 1), positions=n)


def _rk3_launch(u, v, w, pos, shape, dim, sh, clamp, out, slab=None,
                overflow=None, stage1=None):
    """One rk3_substep kernel launch: from `pos` (3, *shape), or from the
    lattice of face vector `dim` where `pos` is None; on a ``Slab`` the
    faces hold the cell planes slab.src .. and the lattice starts at
    global plane slab.out. bfloat16 faces launch the bf16 mode, whose
    lattice mode samples stage 1 from the float32 triplet `stage1`."""
    ni, nj, nk = v.shape[0], u.shape[1], u.shape[2]
    n = out[0].numel()
    rk3_check_sizes((ni, nj, nk), n)
    ov = _overflow_arg(slab, overflow, out.device)
    # the kernel tiles the node lattice by its last two extents
    d1, d2 = ((1,) * 2 + tuple(shape))[-2:]
    fn = _build.function(
        "rk3_substep", "gfs_rk3_substep",
        [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I,
         ctypes.POINTER(_F), _F, _F, _F, _F, _F, ctypes.POINTER(_F), _I, _I,
         _I, _P, _P, _P])
    dim_host = (_F * 3)(*[float(d) for d in dim])
    clamp_host = (_F * 6)(*[float(c) for c in clamp])
    zs = (0, 0, 0) if slab is None else (slab.nz, slab.src, slab.out)
    s1 = (None,) * 3 if stage1 is None else [_build.ptr(f) for f in stage1]
    with _build.current(out):
        err = fn(_build.ptr(u), _build.ptr(v), _build.ptr(w),
                 int(u.dtype == BF16), *s1, ni, nj, nk,
                 None if pos is None else _build.ptr(pos), n // (d1 * d2),
                 d1, d2, dim_host, *rk3_coefficients(sh), clamp_host, *zs,
                 ov, _build.ptr(out), _build.stream(out))
    _build.check(err, "rk3_substep")


def _check_velocity_slab(name, slab, nk):
    """Raise unless a ``Slab``'s faces (nk cell planes from slab.src) lie
    inside the grid of slab.nz cells and hold at least 2 planes."""
    if not (nk >= 2 and 0 <= slab.src and slab.src + nk <= slab.nz):
        raise ValueError(f"{name}: faces of {nk} cell planes from plane "
                         f"{slab.src} do not fit a grid of {slab.nz}")


def rk3_substep(u, v, w, pos, sh, clamp, slab=None, overflow=None):
    """One Ralston RK3 substep of the characteristic trace: `pos` is
    stacked (3, ...) cell-lattice grid coordinates (p/h), `sh` the signed
    substep over h, `clamp` the per-axis bounds in grid units. u, v, w are
    the MAC faces of an (ni, nj, nk) grid; with a ``Slab`` (the slab
    mode), the cell planes slab.src .. slab.src + nk - 1 of a grid of
    slab.nz cells, the positions staying global, and each position that
    used a plane outside the faces adds 1 to `overflow`, when given. The
    faces may be bfloat16 (the bf16 mode, not on a slab)."""
    bf16 = is_bf16("rk3_substep", u, v, w)
    _no_slab_bf16("rk3_substep", bf16, slab)
    if slab is not None:
        _check_velocity_slab("rk3_substep", slab, u.shape[2])
    if not _build.on_card(pos, "rk3_substep"):
        return rk3_substep_plain(u, v, w, pos, sh, clamp, slab, overflow)
    _faces("rk3_substep", u, v, w, bf16)
    _build.require(pos, "pos")
    if pos.dim() < 2 or pos.shape[0] != 3:
        raise ValueError(f"rk3_substep: pos must be (3, ...), got "
                         f"{tuple(pos.shape)}")
    if pos.device != u.device:
        raise ValueError("rk3_substep: tensors on different devices")
    out = torch.empty_like(pos)
    _rk3_launch(u, v, w, pos, pos.shape[1:], (0, 0, 0), sh, clamp, out,
                slab, overflow)
    rk3_substep.launches += 1
    rk3_substep.slab_launches += slab is not None
    rk3_substep.bf16_launches += bf16
    return out


rk3_substep.launches = 0
rk3_substep.slab_launches = 0
rk3_substep.bf16_launches = 0


def rk3_substep_lattice(u, v, w, kind_dim, sh, clamp, slab=None,
                        overflow=None, stage1=None):
    """``rk3_substep`` from the lattice of the kind with face vector
    `kind_dim`, cropped to the (ni, nj, nk) cell block: node (i, j, k)
    starts at (i - 0.5*dim_x, j - 0.5*dim_y, k - 0.5*dim_z). On the card
    the kernel forms those coordinates itself and reads no positions.
    Returns (3, ni, nj, nk). With a ``Slab`` the faces are a slab as in
    ``rk3_substep`` and the block is the slab.out_nz planes from global
    plane slab.out: (3, ni, nj, slab.out_nz).

    The bf16 mode (bfloat16 faces, no slab) needs `stage1`, the float32
    faces: the JAX identity peel takes its stage-1 velocity from the
    unrounded faces and only stages 2 and 3 from the bf16 pack."""
    bf16 = is_bf16("rk3_substep_lattice", u, v, w)
    _no_slab_bf16("rk3_substep_lattice", bf16, slab)
    if bf16 != (stage1 is not None) or (
            bf16 and is_bf16("rk3_substep_lattice", *stage1)):
        raise ValueError("rk3_substep_lattice: bfloat16 faces need the "
                         "float32 faces of stage 1 (stage1), float32 faces "
                         "take none")
    ni, nj = v.shape[0], u.shape[1]
    if slab is None:
        shape, z0 = (ni, nj, u.shape[2]), 0
    else:
        _check_velocity_slab("rk3_substep_lattice", slab, u.shape[2])
        if not (slab.out_nz >= 1 and 0 <= slab.out
                and slab.out + slab.out_nz <= slab.nz):
            raise ValueError(f"rk3_substep_lattice: {slab.out_nz} planes "
                             f"from {slab.out} outside {slab.nz}")
        shape, z0 = (ni, nj, slab.out_nz), slab.out
    if not _build.on_card(u, "rk3_substep_lattice"):
        return rk3_substep_plain(
            u, v, w, lattice_positions(shape, kind_dim, u.device, z0), sh,
            clamp, slab, overflow, stage1)
    _faces("rk3_substep_lattice", u, v, w, bf16)
    if bf16:
        _faces("rk3_substep_lattice", *stage1)
        if tuple(f.shape for f in stage1) != (u.shape, v.shape, w.shape):
            raise ValueError("rk3_substep_lattice: stage1 faces of another "
                             "grid")
    out = torch.empty((3,) + shape, dtype=torch.float32, device=u.device)
    _rk3_launch(u, v, w, None, shape, kind_dim, sh, clamp, out, slab,
                overflow, stage1)
    rk3_substep_lattice.launches += 1
    rk3_substep_lattice.slab_launches += slab is not None
    rk3_substep_lattice.bf16_launches += bf16
    return out


rk3_substep_lattice.launches = 0
rk3_substep_lattice.slab_launches = 0
rk3_substep_lattice.bf16_launches = 0


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
    one substep (advect.dmc_displacements_3d, the kernel's arithmetic), of
    the faces widened to float32."""
    vel = interp.mac_velocity_at_c_3d(widen(u), widen(v), widen(w))
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


def _dmc_slab_planes(name, slab, nkv, nkm=None):
    """Check a ``dmc_substep`` slab (the faces hold nkv cell planes, the
    map nkm) and return the output's global plane indices' range: the
    faces must hold every output plane and the planes beside them (those
    the band's upwind cells read), the map every output plane."""
    lo, hi = slab.out, slab.out + slab.out_nz
    ok = (slab.out_nz >= 1 and 0 <= lo and hi <= slab.nz
          and slab.src <= max(lo - 1, 0)
          and slab.src + nkv >= min(hi + 1, slab.nz)
          and slab.src + nkv <= slab.nz)
    if nkm is not None:
        ok = ok and nkm >= 2 and slab.map <= lo and slab.map + nkm >= hi
    if not ok:
        raise ValueError(f"{name}: slab {slab} does not fit faces of {nkv} "
                         f"planes and a map of {nkm}")
    return lo, hi


def _dmc_slab_displacements(u, v, w, sh, thresh, slab):
    """dmc_displacements of the faces' cell planes, cut to the output
    planes of `slab`."""
    lo = slab.out - slab.src
    return [d[..., lo:lo + slab.out_nz]
            for d in dmc_displacements(u, v, w, sh, thresh)]


def dmc_substep_plain(u, v, w, maps, sh, thresh, slab=None, overflow=None):
    """Plain version: the backward map (3, ni, nj, nk) after one DMC
    substep; cells outside the interior band keep the old map. On a
    ``Slab`` see ``dmc_substep``."""
    if slab is not None:
        lo, hi = _dmc_slab_planes("dmc_substep", slab, u.shape[2],
                                  maps.shape[3])
        dx, dy, dz = _dmc_slab_displacements(u, v, w, sh, thresh, slab)
        dev = maps.device
        ni, nj = maps.shape[1], maps.shape[2]
        band = band_mask((ni, nj, slab.nz), (2, 2, 2), (3, 3, 3),
                         dev)[..., lo:hi]
        gx = torch.arange(ni, dtype=maps.dtype, device=dev)[:, None, None] - dx
        gy = torch.arange(nj, dtype=maps.dtype, device=dev)[None, :, None] - dy
        gz = torch.arange(lo, hi, dtype=maps.dtype, device=dev) - dz
        own = maps[..., lo - slab.map:hi - slab.map]
        outs, outside = [], []
        for c in range(3):
            val, out = interp.trilerp_grid_slab(maps[c], gx, gy, gz,
                                                slab.map, slab.nz)
            outs.append(torch.where(band, val, own[c]))
            outside.append(out)
        _count(overflow, band & torch.stack(outside).any(0))
        return torch.stack(outs)
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


def dmc_substep_lattice_plain(u, v, w, sh, thresh, h, slab=None):
    """Plain version of the lattice mode: the identity backward map
    (3, ni, nj, nk) after one DMC substep (the identity peel of
    ``advect.dmc_backward_identity_3d``). Sampling the identity at the new
    position is the position itself clamped to the lattice-value range:
    inside the band clamp(p - disp*h, 0, (n-1)h), outside it p, with p the
    cell lattice formed as ``Grid3D.axis_coords('c')`` forms it. On a
    ``Slab`` see ``dmc_substep_lattice``."""
    ni, nj = v.shape[0], u.shape[1]
    if slab is None:
        disp = dmc_displacements(u, v, w, sh, thresh)
        lo, hi, nz = 0, u.shape[2], u.shape[2]
    else:
        lo, hi = _dmc_slab_planes("dmc_substep_lattice", slab, u.shape[2])
        disp = _dmc_slab_displacements(u, v, w, sh, thresh, slab)
        nz = slab.nz
    dev = u.device
    band = band_mask((ni, nj, nz), (2, 2, 2), (3, 3, 3), dev)[..., lo:hi]
    outs = []
    for ax, (d, n) in enumerate(zip(disp, (ni, nj, nz))):
        p = torch.arange(n, dtype=torch.float32, device=dev) * h
        if ax == 2:
            p = p[lo:hi]
        p = p.reshape([-1 if a == ax else 1 for a in range(3)])
        outs.append(torch.where(band, (p - d * h).clamp(0.0, (n - 1) * h),
                                p))
    return torch.stack(outs)


def dmc_check_sizes(cell_shape):
    """Raise unless the MAC faces and the (3, ni, nj, nk) map of an (ni,
    nj, nk) grid fit the dmc_substep kernel: nk >= 2 (it loads the z
    corners in pairs) and 32-bit offsets."""
    ni, nj, nk = cell_shape
    if nk < 2:
        raise ValueError(f"dmc_substep: the kernel needs nk >= 2, got {nk}")
    check_int32("dmc_substep", u=(ni + 1) * nj * nk, v=ni * (nj + 1) * nk,
                w=ni * nj * (nk + 1), maps=3 * ni * nj * nk)


def _dmc_launch(u, v, w, maps, sh, thresh, h, out, slab=None,
                overflow=None):
    """One dmc_substep kernel launch: the substep of `maps`, or of the
    identity map of cell size `h` (the lattice mode) where `maps` is
    None; on a ``Slab`` of the grid as ``dmc_substep`` says; bfloat16
    faces launch the bf16 mode."""
    shape = (v.shape[0], u.shape[1], u.shape[2])
    dmc_check_sizes(shape)
    ov = _overflow_arg(slab, overflow, out.device)
    fn = _build.function(
        "dmc_substep", "gfs_dmc_substep",
        [_P, _P, _P, _I, _I, _I, _I, _P, _F, _F, _F, ctypes.POINTER(_F),
         ctypes.POINTER(_I), _P, _P, _P])
    # the lattice mode's clamp, (n - 1)*h rounded to float32 as
    # torch.clamp rounds its bound
    extent = shape if slab is None else shape[:2] + (slab.nz,)
    hi = (_F * 3)(*[float((n - 1) * h) for n in extent])
    zs = None
    if slab is not None:
        nkm = slab.out_nz if maps is None else maps.shape[3]
        zs = (_I * 6)(slab.nz, slab.out, slab.out_nz, slab.src, slab.map,
                      nkm)
    with _build.current(out):
        err = fn(_build.ptr(u), _build.ptr(v), _build.ptr(w),
                 int(u.dtype == BF16), *shape,
                 None if maps is None else _build.ptr(maps), float(sh),
                 float(thresh), float(h), hi, zs, ov, _build.ptr(out),
                 _build.stream(out))
    _build.check(err, "dmc_substep")


def dmc_substep(u, v, w, maps, sh, thresh, slab=None, overflow=None):
    """One fused DMC backward-map substep: `maps` is the stacked (3, ni,
    nj, nk) backward map in world coordinates, `sh` the substep over h,
    `thresh` the float32 1e-4*h guard (dmc_threshold).

    The slab mode (a ``Slab``): the faces hold the cell planes slab.src ..
    slab.src + nk - 1 of a grid of slab.nz cells, `maps` the planes
    slab.map .. (the output planes and their halo), and the result is
    (3, ni, nj, slab.out_nz), the planes from global plane slab.out. The
    band, the lattice and the map coordinate are global; a map corner
    outside the map's planes is clamped to its edge, and each cell that
    used one adds 1 to `overflow`, when given. The faces must hold every
    output plane and the planes beside them, the map every output plane.

    The faces may be bfloat16 (the bf16 mode, not on a slab): the JAX
    package's DMC substeps read its bf16 MAC pack; the map stays
    float32."""
    bf16 = is_bf16("dmc_substep", u, v, w)
    _no_slab_bf16("dmc_substep", bf16, slab)
    if slab is not None:
        _dmc_slab_planes("dmc_substep", slab, u.shape[2], maps.shape[3])
    if not _build.on_card(maps, "dmc_substep"):
        return dmc_substep_plain(u, v, w, maps, sh, thresh, slab, overflow)
    shape = _faces("dmc_substep", u, v, w, bf16)
    if slab is None:
        _build.require(maps, "maps", shape=(3,) + shape)
        out = torch.empty_like(maps)
    else:
        _build.require(maps, "maps", ndim=4)
        if maps.shape[:3] != (3,) + shape[:2]:
            raise ValueError(f"dmc_substep: maps {tuple(maps.shape)} on "
                             f"faces of {shape}")
        out = torch.empty((3,) + shape[:2] + (slab.out_nz,),
                          dtype=torch.float32, device=maps.device)
    if maps.device != u.device:
        raise ValueError("dmc_substep: tensors on different devices")
    _dmc_launch(u, v, w, maps, sh, thresh, 0.0, out, slab, overflow)
    dmc_substep.launches += 1
    dmc_substep.slab_launches += slab is not None
    dmc_substep.bf16_launches += bf16
    return out


dmc_substep.launches = 0
dmc_substep.slab_launches = 0
dmc_substep.bf16_launches = 0


def dmc_substep_lattice(u, v, w, sh, thresh, h, slab=None):
    """``dmc_substep`` of the identity backward map of cell size `h` (the
    first substep of a march from the identity): on the card the kernel
    forms each cell's position itself and reads no map. Returns (3, ni,
    nj, nk); with a ``Slab`` (the faces as in ``dmc_substep``) the
    slab.out_nz planes from global plane slab.out. It reads no map, so it
    has nothing to count. It stands for the JAX identity peel, which reads
    the unrounded faces in the bf16 mode too: the faces are float32."""
    if is_bf16("dmc_substep_lattice", u, v, w):
        raise ValueError("dmc_substep_lattice: the identity peel reads the "
                         "float32 faces, in the bf16 mode too")
    if slab is not None:
        _dmc_slab_planes("dmc_substep_lattice", slab, u.shape[2])
    if not _build.on_card(u, "dmc_substep_lattice"):
        return dmc_substep_lattice_plain(u, v, w, sh, thresh, h, slab)
    shape = _faces("dmc_substep_lattice", u, v, w)
    nko = shape[2] if slab is None else slab.out_nz
    out = torch.empty((3,) + shape[:2] + (nko,), dtype=torch.float32,
                      device=u.device)
    _dmc_launch(u, v, w, None, sh, thresh, h, out, slab)
    dmc_substep_lattice.launches += 1
    dmc_substep_lattice.slab_launches += slab is not None
    return out


dmc_substep_lattice.launches = 0
dmc_substep_lattice.slab_launches = 0


# ---------------------------------------------------------------------------
# volume_prefilter
# ---------------------------------------------------------------------------


def _edge_shifts(x, axis):
    """(x[i-1], x[i+1]) along `axis`, indices clamped to the edges."""
    n = x.shape[axis]
    xp = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)],
                   dim=axis)
    return xp.narrow(axis, 0, n), xp.narrow(axis, 2, n)


def _smooth_axis(x, axis):
    """(0.125*lo + 0.75*x) + 0.125*hi along `axis`, edge-clamped."""
    lo, hi = _edge_shifts(x, axis)
    return 0.125 * lo + 0.75 * x + 0.125 * hi


def volume_prefilter_plain(fields):
    """Plain version: 0.5*f + 0.5*(S_x S_y S_z f) of C stacked same-shape
    fields (C, nx, ny, nz), S = [1/8, 3/4, 1/8] with edge-clamped indices;
    the z pass first, then y, then x (the JAX composition order)."""
    return 0.5 * fields + 0.5 * _smooth_axis(
        _smooth_axis(_smooth_axis(fields, 3), 2), 1)


def prefilter_check_int32(shape):
    """Raise unless C stacked (C, nx, ny, nz) fields fit the
    volume_prefilter kernel's 32-bit offsets."""
    C, nx, ny, nz = shape
    check_int32("volume_prefilter", fields=C * nx * ny * nz)


def volume_prefilter(fields):
    """The separable volume prefilter 0.5*delta + 0.5*S^3 of C stacked
    same-shape fields (C, nx, ny, nz), edge-clamped. Returns a new
    (C, nx, ny, nz) tensor."""
    if not _build.on_card(fields, "volume_prefilter"):
        return volume_prefilter_plain(fields)
    _build.require(fields, "fields", ndim=4)
    prefilter_check_int32(fields.shape)
    out = torch.empty_like(fields)
    fn = _build.function("volume_prefilter", "gfs_volume_prefilter",
                         [_P, _I, _I, _I, _I, _P, _P])
    with _build.current(fields):
        err = fn(_build.ptr(fields), *fields.shape, _build.ptr(out),
                 _build.stream(fields))
    _build.check(err, "volume_prefilter")
    volume_prefilter.launches += 1
    return out


volume_prefilter.launches = 0


# ---------------------------------------------------------------------------
# vol9_fixup
# ---------------------------------------------------------------------------

# a block channel goes exact when dev * roughness > VOL9_TOL * max|f| (the
# JAX package's GFS_VOL9_TOL default)
VOL9_TOL = 2e-3
_ZERO3 = ((0.0, 0.0, 0.0),) * 3
# _VOL3 corner offsets (units of h) and the centre, the 9-point stencil
_VOL9 = _VOL3 + ((0.0, 0.0, 0.0),)


def _ceil_to(a, b):
    return -(-a // b) * b


def vol9_blocks(grid_n):
    """(padded cell-lattice shape, decision block, blocks per axis) of the
    vol9 decision: blocks of x 16, y 16 and z 256 when the padded z extent
    (a multiple of 128) is a multiple of 256, else 128."""
    ni, nj, nk = grid_n
    out_shape = (_ceil_to(ni, 16), _ceil_to(nj, 16), _ceil_to(nk, 128))
    block = (16, 16, 256 if out_shape[2] % 256 == 0 else 128)
    return out_shape, block, tuple(o // b for o, b in zip(out_shape, block))


def _block_max(d, block):
    """Max over each block of a 3D tensor whose shape `block` divides."""
    (nx, ny, nz), (b0, b1, b2) = d.shape, block
    return d.reshape(nx // b0, b0, ny // b1, b1, nz // b2, b2).amax(
        dim=(1, 3, 5))


def _dilate_blocks(r):
    """Each block's max with its edge-clamped neighbours, axis by axis."""
    for ax in range(3):
        r = torch.maximum(r, torch.maximum(*_edge_shifts(r, ax)))
    return r


def vol9_map_stats(maps, h, grid_n):
    """Per-block corner-deviation bound of a (3, ni, nj, nk) world map:
    from the six one-sided differences of maps/h minus the identity, the
    largest 0.25*|sum| over the 8 sign combinations, on the interior
    cells, zero on the padded cell lattice's rim, block max, dilated one
    block. Computed once per map and step; every stage and kind that
    samples through the map shares it."""
    out_shape, block, _ = vol9_blocks(grid_n)
    g = interp.div_scalar(maps, h)
    dev_e = None
    for ch in range(3):
        m = g[ch]
        mid = m[1:-1, 1:-1, 1:-1]
        dpos, dneg = [], []
        for b in range(3):
            lo, hi = [slice(1, -1)] * 3, [slice(1, -1)] * 3
            lo[b], hi[b] = slice(0, -2), slice(2, None)
            one = 1.0 if b == ch else 0.0
            dpos.append(m[tuple(hi)] - mid - one)
            dneg.append(-(mid - m[tuple(lo)]) + one)
        for sx in (dneg[0], dpos[0]):
            for sy in (dneg[1], dpos[1]):
                for sz in (dneg[2], dpos[2]):
                    t = 0.25 * ((sx + sy) + sz).abs()
                    dev_e = t if dev_e is None else torch.maximum(dev_e, t)
    pad = []
    for ax in (2, 1, 0):
        pad += [1, out_shape[ax] - dev_e.shape[ax] - 1]
    return _dilate_blocks(_block_max(torch.nn.functional.pad(dev_e, pad),
                                     block))


def _edge_pad_to(x, shape):
    """`x` edge-padded at the upper end of each axis out to `shape`."""
    for ax in range(3):
        if shape[ax] > x.shape[ax]:
            idx = torch.arange(shape[ax], device=x.device).clamp(
                max=x.shape[ax] - 1)
            x = x.index_select(ax, idx)
    return x


def vol9_flags(fields, p1, map_stats, grid_n, h, dim, clamp_lo, clamp_hi,
               band=None, tol=None):
    """The vol9 decision: a bool (C, nbx, nby, nbz) tensor over the
    ``vol9_blocks`` lattice, True where channel c of a block takes the
    exact composition: dev * rough_c > tol * max|f_c| (``tol <= 0`` flags
    every block). dev is `map_stats` plus the block's largest clamp
    deviation of the centre positions `p1` (world, on the kind's lattice;
    corners near a clamped face deviate by up to h/4); rough_c is the
    block's largest neighbour difference of f_c, dilated one block. The
    statistics cover the nodes of `band` = (lo_x, lo_y, lo_z, hi),
    lo < idx < n + dim - hi per axis, or with ``band=None`` every node of
    the padded lattice, positions past the field's last node continued
    with the node spacing. Plain torch on every device, no host sync."""
    tol = VOL9_TOL if tol is None else float(tol)
    out_shape, block, nb = vol9_blocks(grid_n)
    C, dev = fields.shape[0], fields.device
    if tol <= 0.0:
        return torch.ones((C,) + nb, dtype=torch.bool, device=dev)
    kind_shape = tuple(fields.shape[1:])
    bmask = None
    for ax in range(3 if band is not None else 0):
        i = torch.arange(out_shape[ax], device=dev)
        m = ((i > band[ax]) & (i < grid_n[ax] + dim[ax] - band[3])).reshape(
            [-1 if a == ax else 1 for a in range(3)])
        bmask = m if bmask is None else bmask & m

    def bmax(d, fill=0.0):
        d = d[:out_shape[0], :out_shape[1], :out_shape[2]]
        pad = []
        for ax in (2, 1, 0):
            pad += [0, out_shape[ax] - d.shape[ax]]
        if any(pad):
            d = torch.nn.functional.pad(d, pad, value=fill)
        if bmask is not None:
            d = torch.where(bmask, d, fill)
        return _block_max(d, block)

    sl = tuple(slice(0, min(o, k)) for o, k in zip(out_shape, kind_shape))
    clampdev = None
    for ax in range(3):
        g = _edge_pad_to(interp.div_scalar(p1[ax][sl], h), out_shape)
        n = min(out_shape[ax], kind_shape[ax])
        if out_shape[ax] > n:
            over = (torch.arange(out_shape[ax], device=dev) - (n - 1)).clamp(
                min=0).to(g.dtype)
            g = g + over.reshape([-1 if a == ax else 1 for a in range(3)])
        d = torch.maximum((clamp_lo - (g - 0.25)).clamp(min=0.0),
                          ((g + 0.25) - (grid_n[ax] - clamp_hi)).clamp(
                              min=0.0)).clamp(max=0.25)
        clampdev = d if clampdev is None else torch.maximum(clampdev, d)
    dev_full = map_stats + bmax(clampdev)
    flags = []
    for c in range(C):
        f = fields[c]
        rough = None
        for ax in range(3):
            n = f.shape[ax]
            dm = bmax((f.narrow(ax, 1, n - 1) - f.narrow(ax, 0, n - 1)).abs())
            rough = dm if rough is None else torch.maximum(rough, dm)
        flags.append(dev_full * _dilate_blocks(rough)
                     > tol * f.abs().max())
    return torch.stack(flags)


def volume_eval_3d(grid, kind, eval_fn, device):
    """0.5*(sum of the 8 corner evals)/8 + 0.5*centre eval at each node of
    `kind`, the corners added one by one in _VOL3 order. The 9 stencil
    points p + d*h are stacked on a leading axis of the positions, so each
    sample in `eval_fn` is one call; ``eval_fn(px, py, pz)[q]`` is the
    value at point q."""
    px, py, pz = grid.node_coords(kind, device=device)
    offs = torch.tensor(_VOL9, dtype=px.dtype, device=device) * grid.h
    sh = (9,) + (1,) * px.dim()
    vals = eval_fn(px[None] + offs[:, 0].reshape(sh),
                   py[None] + offs[:, 1].reshape(sh),
                   pz[None] + offs[:, 2].reshape(sh))
    acc = vals[0]
    for q in range(1, 8):
        acc = acc + vals[q]
    return 0.5 * (acc / 8.0) + 0.5 * vals[8]


def clamp_bounds(grid, clamp_lo, clamp_hi):
    """The per-axis world clamp [lo*h, n*h - hi*h] of mapped positions."""
    h = grid.h
    return ((clamp_lo * h,) * 3,
            tuple(n * h - clamp_hi * h for n in grid.shape_c))


def vol9_exact_plain(fields, maps, grid, kind, clamp_lo, clamp_hi):
    """The exact 9-position volume composition of C stacked fields of
    `kind` (the reference's advect_kernel): at each node p, the volume
    average of f(clamp(M(p + d*h))) over d in _VOL3 and the centre, M the
    trilinear sample of the (3, ni, nj, nk) world map `maps`. Plain
    samplers throughout."""
    lo, hi = clamp_bounds(grid, clamp_lo, clamp_hi)
    offs = (grid.off_of(kind),) * fields.shape[0]

    def ev(px, py, pz):
        m = trilerp_sample_plain(maps, px, py, pz, grid.h, _ZERO3)
        m = [m[a].clamp(lo[a], hi[a]) for a in range(3)]
        return trilerp_sample_plain(fields, *m, grid.h, offs).transpose(0, 1)

    return volume_eval_3d(grid, kind, ev, fields.device)


def _expand_flags(flags, kind_shape, block):
    """Per-node view of (C, nbx, nby, nbz) block flags on a kind's lattice;
    nodes past the block lattice (a staggered kind's last face plane when
    the blocks end at the cell count) are unflagged."""
    nb = flags.shape[1:]
    idx, valid = [], []
    for ax in range(3):
        i = torch.arange(kind_shape[ax], device=flags.device) // block[ax]
        shape = [-1 if a == ax else 1 for a in range(3)]
        valid.append((i < nb[ax]).reshape(shape))
        idx.append(i.clamp(max=nb[ax] - 1).reshape(shape))
    return flags[:, idx[0], idx[1], idx[2]] & valid[0] & valid[1] & valid[2]


def _vol9_merge_plain(dual_outs, fields, maps, flags, grid, kind, clamp_lo,
                      clamp_hi):
    _, block, _ = vol9_blocks(grid.shape_c)
    exact = vol9_exact_plain(fields, maps, grid, kind, clamp_lo, clamp_hi)
    return torch.where(_expand_flags(flags, fields.shape[1:], block), exact,
                       dual_outs)


def vol9_fixup_plain(dual_outs, fields, map_stats, maps, p1, grid, kind,
                     clamp_lo, clamp_hi, band=None, tol=None):
    """Plain version: ``torch.where(flag, exact, dual)`` with the flags of
    ``vol9_flags`` and the composition of ``vol9_exact_plain``."""
    flags = vol9_flags(fields, p1, map_stats, grid.shape_c, grid.h,
                       grid.dim_of(kind), clamp_lo, clamp_hi, band=band,
                       tol=tol)
    return _vol9_merge_plain(dual_outs, fields, maps, flags, grid, kind,
                             clamp_lo, clamp_hi)


def vol9_fixup(dual_outs, fields, map_stats, maps, p1, grid, kind, clamp_lo,
               clamp_hi, band=None, tol=None):
    """Replace the dual volume form `dual_outs` (C, kind shape) of the C
    stacked source `fields` of `kind` by the exact 9-position composition
    through `maps` (clamped to [lo*h, n*h - hi*h]) on every block channel
    that ``vol9_flags`` flags; `map_stats` is ``vol9_map_stats(maps)`` and
    `p1` the dual form's centre positions. On the card the kernel
    overwrites the flagged nodes of `dual_outs` in place and returns it;
    on the CPU a new tensor is returned. Adds the call's flagged and total
    block channels to ``vol9_block_counts``."""
    flags = vol9_flags(fields, p1, map_stats, grid.shape_c, grid.h,
                       grid.dim_of(kind), clamp_lo, clamp_hi, band=band,
                       tol=tol)
    key = str(flags.device)
    prev = vol9_fixup.exact_blocks.get(key)
    n_flagged = flags.sum()
    vol9_fixup.exact_blocks[key] = (n_flagged if prev is None
                                    else prev + n_flagged)
    vol9_fixup.total_blocks += flags.numel()
    if not _build.on_card(fields, "vol9_fixup"):
        return _vol9_merge_plain(dual_outs, fields, maps, flags, grid, kind,
                                 clamp_lo, clamp_hi)
    return vol9_launch(dual_outs, fields, maps, flags, grid, kind, clamp_lo,
                       clamp_hi)


# the vol9_fixup kernel's thread tile (i, j, k), which must divide the
# decision block so that a tile lies inside one (csrc/vol9_fixup.cu)
VOL9_TILE = (1, 4, 32)


def vol9_check_sizes(grid_n, kind_shape, C):
    """Raise unless C fields of `kind_shape` and the (3, ni, nj, nk) map
    fit the vol9_fixup kernel: 32-bit offsets, at least 2 nodes along z
    (it loads the field's z corners in pairs), and a decision block that
    the kernel's tile divides."""
    _, block, nb = vol9_blocks(grid_n)
    if kind_shape[2] < 2:
        raise ValueError(f"vol9_fixup: the kernel needs 2 or more nodes "
                         f"along z, got {kind_shape[2]}")
    if any(b % t for b, t in zip(block, VOL9_TILE)):
        raise ValueError(f"vol9_fixup: the tile {VOL9_TILE} does not divide "
                         f"the decision block {block}")
    check_int32("vol9_fixup", maps=3 * int(np.prod(grid_n)),
                fields=C * int(np.prod(kind_shape)),
                flags=C * int(np.prod(nb)))


def vol9_launch(dual_outs, fields, maps, flags, grid, kind, clamp_lo,
                clamp_hi):
    """The ``vol9_fixup`` kernel launch alone, with the block flags of
    ``vol9_flags`` given: overwrites the flagged nodes of `dual_outs` in
    place and returns it."""
    C = fields.shape[0]
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"vol9_fixup: need 1..{MAX_CHANNELS} channels, "
                         f"got {C}")
    _build.require(fields, "fields", shape=(C,) + grid.shape_of(kind))
    _build.require(dual_outs, "dual_outs", shape=fields.shape)
    _build.require(maps, "maps", shape=(3,) + grid.shape_c)
    _, block, nb = vol9_blocks(grid.shape_c)
    if tuple(flags.shape) != (C,) + nb:
        raise ValueError(f"vol9_fixup: flags of shape {tuple(flags.shape)}, "
                         f"expected {(C,) + nb}")
    if not (dual_outs.device == maps.device == fields.device
            == flags.device):
        raise ValueError("vol9_fixup: tensors on different devices")
    vol9_check_sizes(grid.shape_c, fields.shape[1:], C)
    flags = flags.to(torch.uint8).contiguous()
    lo, hi = clamp_bounds(grid, clamp_lo, clamp_hi)
    params = (_F * 9)(*grid.off_of(kind), *lo, *hi)
    fn = _build.function(
        "vol9_fixup", "gfs_vol9_fixup",
        [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _F,
         ctypes.POINTER(_F), _P, _P])
    with _build.current(fields):
        err = fn(_build.ptr(maps), *grid.shape_c, _build.ptr(fields), C,
                 *fields.shape[1:], _build.ptr(flags), *nb, *block,
                 float(grid.h), params, _build.ptr(dual_outs),
                 _build.stream(fields))
    _build.check(err, "vol9_fixup")
    vol9_fixup.launches += 1
    return dual_outs


vol9_fixup.launches = 0
vol9_fixup.exact_blocks = {}     # device -> flagged block channels (tensor)
vol9_fixup.total_blocks = 0


def vol9_block_counts():
    """(exact, total) block channels of every ``vol9_fixup`` call since
    the last ``reset_vol9_block_counts``: the exact count is kept on each
    device and read here (a host sync), never per step."""
    return (sum(int(t) for t in vol9_fixup.exact_blocks.values()),
            vol9_fixup.total_blocks)


def reset_vol9_block_counts():
    vol9_fixup.exact_blocks = {}
    vol9_fixup.total_blocks = 0


# ---------------------------------------------------------------------------
# pullback_sample
# ---------------------------------------------------------------------------


def _pullback_extent(maps, fields, dims, grid_n):
    """Check the arguments of the fused pull-back and return its output
    extent: the JAX package's cell-lattice block grid (``vol9_blocks``,
    multiples of 16 x 16 x 128) cut to the fields' largest extent. A
    staggered kind's last face plane lies outside it wherever the block
    grid ends at the cell count."""
    C = len(fields)
    if not 1 <= C <= MAX_CHANNELS or len(dims) != C:
        raise ValueError(f"pullback_sample: need 1..{MAX_CHANNELS} fields "
                         f"with one staggering each, got {C} and {len(dims)}")
    grid_n = tuple(grid_n)
    if tuple(maps.shape) != (3,) + grid_n:
        raise ValueError(f"pullback_sample: maps of shape {tuple(maps.shape)}"
                         f", expected {(3,) + grid_n}")
    for c, (f, d) in enumerate(zip(fields, dims)):
        if tuple(d) not in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)):
            raise ValueError(f"pullback_sample: dims[{c}] = {d} is not the "
                             "staggering of a lattice kind")
        want = tuple(n + s for n, s in zip(grid_n, d))
        if tuple(f.shape) != want:
            raise ValueError(f"pullback_sample: fields[{c}] of shape "
                             f"{tuple(f.shape)}, expected {want}")
        if f.device != maps.device:
            raise ValueError(f"pullback_sample: fields[{c}] on {f.device}, "
                             f"maps on {maps.device}")
    padded, _, _ = vol9_blocks(grid_n)
    return tuple(min(p, max(f.shape[ax] for f in fields))
                 for ax, p in enumerate(padded))


def pullback_positions(maps, d, h, grid_n, extent):
    """The map in grid units (maps / h) at the nodes of staggering `d` over
    `extent`, unclipped: averaged 0.5*(m[n-1] + m[n]) along each staggered
    axis, map indices clamped to the map."""
    g = interp.div_scalar(maps, h)
    out = []
    for ch in range(3):
        m = _edge_pad_to(g[ch], extent)
        for axis in range(3):
            if d[axis]:
                m = 0.5 * (_edge_shifts(m, axis)[0] + m)
        out.append(m)
    return out


def pullback_sample_plain(maps, fields, dims, h, grid_n, clamp_lo, clamp_hi):
    """Plain version: (C, *extent) samples, field c (of staggering
    dims[c]) at the clipped map position of its node plus 0.5*dims[c]."""
    extent = _pullback_extent(maps, fields, dims, grid_n)
    outs = []
    for f, d in zip(fields, dims):
        pos = pullback_positions(maps, d, h, grid_n, extent)
        outs.append(interp.trilerp_grid(f, *(
            p.clamp(float(clamp_lo), float(n - clamp_hi)) + 0.5 * s
            for p, n, s in zip(pos, grid_n, d))))
    return torch.stack(outs)


def pullback_kind_order(dims):
    """The pull-back kernel's channel order: the channels of one kind
    adjacent, kinds in the order they first appear, channels of a kind in
    their own order, so that a kind forms its sample coordinates once."""
    kinds = list(dict.fromkeys(tuple(d) for d in dims))
    return sorted(range(len(dims)), key=lambda c: kinds.index(tuple(dims[c])))


def pullback_check_sizes(grid_n, field_shapes, extent):
    """Raise unless the (3, ni, nj, nk) map, fields of `field_shapes` and
    the (C, *extent) output fit the pullback_sample kernel: at least 2
    nodes along z in every field (it loads the z corners in pairs) and
    32-bit offsets."""
    for c, shape in enumerate(field_shapes):
        if shape[2] < 2:
            raise ValueError(f"pullback_sample: the kernel needs 2 or more "
                             f"nodes along z, fields[{c}] has {shape[2]}")
    check_int32("pullback_sample", maps=3 * int(np.prod(grid_n)),
                fields=max(int(np.prod(s)) for s in field_shapes),
                outputs=len(field_shapes) * int(np.prod(extent)))


def pullback_sample(maps, fields, dims, h, grid_n, clamp_lo, clamp_hi):
    """Pull C <= 4 fields of mixed lattice kinds back through one world
    map (3, ni, nj, nk) in one launch: channel c is fields[c] (its kind's
    shape, staggering dims[c]) sampled at its nodes' map positions, taken
    in grid units, averaged along the staggered axis and clipped to
    [clamp_lo, n - clamp_hi]. Returns (C, *extent) over the extent of
    ``_pullback_extent``; callers cut each kind out."""
    if not _build.on_card(maps, "pullback_sample"):
        return pullback_sample_plain(maps, fields, dims, h, grid_n, clamp_lo,
                                     clamp_hi)
    extent = _pullback_extent(maps, fields, dims, grid_n)
    _build.require(maps, "maps")
    for c, f in enumerate(fields):
        _build.require(f, f"fields[{c}]")
    pullback_check_sizes(grid_n, [f.shape for f in fields], extent)
    C = len(fields)
    out = torch.empty((C,) + extent, dtype=torch.float32, device=maps.device)
    order = pullback_kind_order(dims)
    ptrs = (_P * C)(*[fields[c].data_ptr() for c in order])
    shapes = (_I * (3 * C))(*[n for c in order for n in fields[c].shape])
    stag = (_I * C)(*[list(dims[c]).index(1) if any(dims[c]) else -1
                      for c in order])
    slot = (_I * C)(*order)
    hi = (_F * 3)(*[float(n - clamp_hi) for n in grid_n])
    fn = _build.function(
        "pullback_sample", "gfs_pullback_sample",
        [_P, _I, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_I),
         ctypes.POINTER(_I), ctypes.POINTER(_I), _I, _I, _I, _I, _F, _F,
         ctypes.POINTER(_F), _P, _P])
    with _build.current(maps):
        err = fn(_build.ptr(maps), *grid_n, ptrs, shapes, stag, slot, C,
                 *extent, float(h), float(clamp_lo), hi, _build.ptr(out),
                 _build.stream(maps))
    _build.check(err, "pullback_sample")
    pullback_sample.launches += 1
    return out


pullback_sample.launches = 0
# the JAX package's name for the fused pull-back
sample3_pullback = pullback_sample


# ---------------------------------------------------------------------------
# bilerp_sample (2D)
# ---------------------------------------------------------------------------


def bilerp_sample_plain(fields, px, py, h, offs):
    """Plain version: (C, *px.shape) clamped bilinear samples of the C
    2D fields (stacked (C, nx, ny) or a sequence of same-shape fields),
    channel c on the lattice (i + offs[c])*h (``interp.sample2`` channel
    by channel)."""
    x, y = interp.div_scalar(px, h), interp.div_scalar(py, h)
    return torch.stack([interp.bilerp_grid(fields[c], x - offs[c][0],
                                           y - offs[c][1])
                        for c in range(len(fields))])


def bilerp_sample_mac_plain(u, v, px, py, h, du=None, dv=None):
    """Plain version of the mac mode: (2, *px.shape), the 2D MAC velocity
    of ``interp.mac_velocity_2d`` (zero outside its bands); with a second
    pair (du, dv) on the same lattices, (4, *px.shape)."""
    pairs = [(u, v)] + ([] if du is None else [(du, dv)])
    return torch.stack([c for a, b in pairs
                        for c in interp.mac_velocity_2d(a, b, px, py, h)])


def calculate_cp_plain(field, px, py, h, off, band):
    """calculateCp of one 2D field at world positions (px, py): (*px.shape,
    4), the bilinear polynomial [c0, c1, c2, c3] of the clamped cell
    around each position, zero where the cell's floors leave [0, band[0]]
    x [0, band[1]]. Operand for operand as
    ``gpufluidsimulation_tpu.solvers.particles.calculate_cp``."""
    gx = interp.div_scalar(px, h) - off[0]
    gy = interp.div_scalar(py, h) - off[1]
    i0, j0 = torch.floor(gx), torch.floor(gy)
    fx, fy = (gx - i0) * h, (gy - j0) * h
    valid = (i0 >= 0) & (i0 <= band[0]) & (j0 >= 0) & (j0 <= band[1])
    nx, ny = field.shape
    ia, ib = i0.long().clamp(0, nx - 1), (i0.long() + 1).clamp(0, nx - 1)
    ja, jb = j0.long().clamp(0, ny - 1), (j0.long() + 1).clamp(0, ny - 1)
    flat = field.reshape(-1)
    f00, f10 = flat[ia * ny + ja], flat[ib * ny + ja]
    f01, f11 = flat[ia * ny + jb], flat[ib * ny + jb]
    hh = h * h
    a, b = h - fx, h - fy
    c0 = a * b * f00 + fx * b * f10 + fx * fy * f11 + a * fy * f01
    c1 = -b * f00 + b * f10 + fy * f11 - fy * f01
    c2 = -a * f00 - fx * f10 + fx * f11 + a * f01
    c3 = f00 - f10 + f11 - f01
    cp = torch.stack([interp.div_scalar(c, hh) for c in (c0, c1, c2, c3)],
                     dim=-1)
    return torch.where(valid[..., None], cp, 0.0)


def bilerp_sample_cp_plain(fields, px, py, h, offs, bands):
    """Plain version of the cp mode: (C, *px.shape, 4), calculateCp of
    each field (its own shape, offset and band) at the same positions."""
    return torch.stack([calculate_cp_plain(f, px, py, h, off, band)
                        for f, off, band in zip(fields, offs, bands)])


_BILERP_MODES = {"sample": 0, "mac": 1, "cp": 2}


def _bilerp_launch(name, fields, offs, bands, px, py, h, mode="sample"):
    """One bilerp_sample kernel launch over the 2D float32 CUDA tensors
    `fields` (each its own shape) at positions (px, py): (C, *px.shape)
    samples, or (C, *px.shape, 4) coefficients in the cp mode."""
    C = len(fields)
    if not 1 <= C <= MAX_CHANNELS or len(offs) != C:
        raise ValueError(f"{name}: need 1..{MAX_CHANNELS} fields with one "
                         f"offset each, got {C} and {len(offs)}")
    for c, f in enumerate(fields):
        _build.require(f, f"fields[{c}]", ndim=2)
    for pname, p in (("px", px), ("py", py)):
        _build.require(p, pname, shape=px.shape)
        if p.device != fields[0].device:
            raise ValueError(f"{name}: {pname} on {p.device}, fields on "
                             f"{fields[0].device}")
    per = 4 if mode == "cp" else 1
    check_int32(name, fields=max(f.numel() for f in fields),
                outputs=C * px.numel() * per)
    out = torch.empty((C,) + tuple(px.shape) + ((4,) if per == 4 else ()),
                      dtype=torch.float32, device=px.device)
    if px.numel() == 0:
        return out
    fn = _build.function(
        "bilerp_sample", "gfs_bilerp_sample",
        [_B, _B, _B, _B, _I, _I, _P, _P, _LL, _F, _F, _P, _P])
    # the arrays the C function reads, packed into bytes (ctypes arrays
    # cost the host several times as much)
    ptrs = struct.pack(f"{C}Q", *[f.data_ptr() for f in fields])
    dims = struct.pack(f"{2 * C}i", *[n for f in fields for n in f.shape])
    offs_host = struct.pack(f"{2 * C}f", *[o for off in offs for o in off])
    bands_host = (None if bands is None else struct.pack(
        f"{2 * C}f", *[b for band in bands for b in band]))
    with _build.current(px):
        err = fn(ptrs, dims, offs_host, bands_host, C, _BILERP_MODES[mode],
                 px.data_ptr(), py.data_ptr(), px.numel(), float(h),
                 float(h * h), out.data_ptr(), _build.stream(px))
    _build.check(err, name)
    return out


def bilerp_sample(fields, px, py, h, offs):
    """Clamped bilinear samples of C <= 4 same-shape 2D fields (stacked
    (C, nx, ny), or a sequence, which the kernel reads in place) at world
    positions (px, py) of any shape, channel c on the lattice (i +
    offs[c])*h: ``interp.sample2`` of each channel, in one launch.
    Returns (C, *px.shape)."""
    if not _build.on_card(px, "bilerp_sample"):
        return bilerp_sample_plain(fields, px, py, h, offs)
    fields = list(fields)
    if any(f.shape != fields[0].shape for f in fields):
        raise ValueError("bilerp_sample: fields of different shapes")
    out = _bilerp_launch("bilerp_sample", fields, offs, None, px, py, h)
    bilerp_sample.launches += 1
    return out


bilerp_sample.launches = 0


def _mac_bands(u, v):
    ni, nj = v.shape[0], u.shape[1]
    _build.require(u, "u", shape=(ni + 1, nj))
    _build.require(v, "v", shape=(ni, nj + 1))
    return ((ni - 1, nj - 2), (ni - 2, nj - 1))


def bilerp_sample_mac(u, v, px, py, h, du=None, dv=None):
    """The 2D MAC velocity at world positions (px, py), u (ni+1, nj) and
    v (ni, nj+1): ``interp.mac_velocity_2d`` in one launch of the
    bilerp_sample kernel in its mac mode, the band test on the float
    floors and the zero outside it in the kernel. Returns (2,
    *px.shape); with a second pair (du, dv) on the same lattices (FLIP's
    grid change) both pairs in the one launch, (4, *px.shape)."""
    if not _build.on_card(px, "bilerp_sample_mac"):
        return bilerp_sample_mac_plain(u, v, px, py, h, du, dv)
    pairs = [(u, v)] + ([] if du is None else [(du, dv)])
    bands = [b for a, c in pairs for b in _mac_bands(a, c)]
    if len(set(map(tuple, bands))) != 2:
        raise ValueError("bilerp_sample_mac: (du, dv) on other lattices "
                         "than (u, v)")
    out = _bilerp_launch("bilerp_sample_mac", [f for p in pairs for f in p],
                         interp.MAC_OFFS_2D * len(pairs), bands, px, py, h,
                         mode="mac")
    bilerp_sample_mac.launches += 1
    return out


bilerp_sample_mac.launches = 0


def bilerp_sample_cp(fields, px, py, h, offs, bands):
    """calculateCp of C <= 4 2D fields of their own shapes at the same
    world positions in one launch of the bilerp_sample kernel in its cp
    mode: field c on the lattice (i + offs[c])*h, its coefficients zero
    where the cell's float floors leave [0, bands[c][0]] x [0,
    bands[c][1]]. Returns (C, *px.shape, 4), [c0, c1, c2, c3] in
    ``calculate_cp_plain``'s operand order (APIC/PolyPIC's G2P)."""
    if not _build.on_card(px, "bilerp_sample_cp"):
        return bilerp_sample_cp_plain(fields, px, py, h, offs, bands)
    if len(bands) != len(fields):
        raise ValueError("bilerp_sample_cp: need one band a field")
    out = _bilerp_launch("bilerp_sample_cp", list(fields), offs, bands, px,
                         py, h, mode="cp")
    bilerp_sample_cp.launches += 1
    return out


bilerp_sample_cp.launches = 0


# ---------------------------------------------------------------------------
# bilerp_sample's trace and DMC modes (the 2D marches)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Lattice2D:
    """A trace's start on a 2D node lattice: (nx, ny) nodes at ((i +
    off[0])*h, (j + off[1])*h), as ``Grid2D.node_coords`` of the kind of
    that shape and offset."""

    shape: tuple
    off: tuple


def rk3_step_2d_plain(u, v, h, dt, px, py):
    """One Ralston RK3 step of world positions by the signed float32 `dt`
    through the 2D MAC velocity u (ni+1, nj), v (ni, nj+1), clamped to
    [0.001h, L - 0.001h] (the JAX package's ``trace_rk3_2d``)."""
    ni, nj = v.shape[0], u.shape[1]
    a, b, c1, c2, c3 = rk3_coefficients(dt)
    u1, v1 = interp.mac_velocity_2d(u, v, px, py, h)
    u2, v2 = interp.mac_velocity_2d(u, v, px + a * u1, py + a * v1, h)
    u3, v3 = interp.mac_velocity_2d(u, v, px + b * u2, py + b * v2, h)
    ox = px + c1 * u1 + c2 * u2 + c3 * u3
    oy = py + c1 * v1 + c2 * v2 + c3 * v3
    return interp.clamp_pos_2d(ox, oy, h, ni, nj, eps=0.001)


def bilerp_minmax_plain(fields, px, py, h, off):
    """The min and max of each same-shape field's 4 clamped bilinear
    corners at world positions (px, py) on the lattice (i + off)*h, each
    (C, *px.shape): the corner clamp of the JAX package's solveMaccormack
    (torch.minimum and torch.maximum, a NaN corner giving NaN), NaN where
    the position is NaN."""
    gx = interp.div_scalar(px, h) - off[0]
    gy = interp.div_scalar(py, h) - off[1]
    nx, ny = fields[0].shape
    ia, ib, _ = interp._axis_corners(gx, nx)
    ja, jb, _ = interp._axis_corners(gy, ny)
    idx = (ia * ny + ja, ib * ny + ja, ia * ny + jb, ib * ny + jb)
    nan_foot = gx.isnan() | gy.isnan()
    mns, mxs = [], []
    for f in fields:
        flat = f.reshape(-1)
        v00, v10, v01, v11 = (flat[k] for k in idx)
        mn = torch.minimum(torch.minimum(v00, v10), torch.minimum(v01, v11))
        mx = torch.maximum(torch.maximum(v00, v10), torch.maximum(v01, v11))
        mns.append(torch.where(nan_foot, float("nan"), mn))
        mxs.append(torch.where(nan_foot, float("nan"), mx))
    return torch.stack(mns), torch.stack(mxs)


# What a trace returns: the foot `pos` ((2, *shape), or (*shape, 2)
# interleaved), the foot `samples` (C, *shape) and the corner `min` and
# `max` (C, *shape); None where not asked for.
TraceOut = collections.namedtuple("TraceOut", "pos samples min max")


def bilerp_trace_plain(u, v, h, subs, start, fields=(), off=(0.0, 0.0),
                       minmax=False, write_pos=True, final_clamp=None,
                       interleave=False):
    """Plain version of the trace mode: the RK3 steps of ``start`` (a
    pair (px, py) of world positions, or a ``Lattice2D``) by each signed
    float32 substep of `subs` in turn (``rk3_step_2d_plain``), then
    ``final_clamp`` ((lo, hi) per axis, host doubles, as torch.clamp
    takes them), then at the foot the samples of `fields` (same shape, on
    the lattice (i + off)*h; ``bilerp_sample_plain``) and with `minmax`
    their corner min/max (``bilerp_minmax_plain``)."""
    if isinstance(start, Lattice2D):
        px, py = lattice_coords(start.shape, start.off, h, u.device)
    else:
        px, py = start
    for dt in subs:
        px, py = rk3_step_2d_plain(u, v, h, dt, px, py)
    if final_clamp is not None:
        (lx, hx), (ly, hy) = final_clamp
        px, py = px.clamp(lx, hx), py.clamp(ly, hy)
    pos = torch.stack([px, py], dim=-1 if interleave else 0) if write_pos \
        else None
    samples = mn = mx = None
    if fields:
        samples = bilerp_sample_plain(fields, px, py, h,
                                      (off,) * len(fields))
        if minmax:
            mn, mx = bilerp_minmax_plain(fields, px, py, h, off)
    return TraceOut(pos, samples, mn, mx)


def trace_schedule(subs):
    """A trace's signed float32 substeps as the kernel takes them: their
    count and the Ralston coefficients (``rk3_coefficients``) of the
    first and of the last; every substep before the last must be the
    first's (the CFL schedule of ``advect.substeps``)."""
    subs = [float(np.float32(s)) for s in subs]
    if any(s != subs[0] for s in subs[:-1]):
        raise ValueError("bilerp_trace: every substep but the last must be "
                         "the same")
    if not subs:
        return 0, (0.0,) * 5, (0.0,) * 5
    return (len(subs), _rk3_coefficients(subs[0]),
            _rk3_coefficients(subs[-1]))


_TRACE_ARGS = [_P, _P, _I, _I, _B, _B, _P, _P, _P, _P, _B, _P, _P, _P, _P]
_TRACE_FP, _TRACE_IP = struct.Struct("23f"), struct.Struct("10i")


def _trace_start(start):
    """The start's shape, count, lattice nodes along y (0 for read
    positions) and element stride."""
    if isinstance(start, Lattice2D):
        nx, ny = start.shape
        return (nx, ny), nx * ny, ny, 1
    px, py = start
    if px.shape != py.shape or px.stride() != py.stride():
        raise ValueError("bilerp_trace: px and py of different shapes or "
                         "strides")
    if px.is_contiguous():
        stride = 1
    elif px.dim() == 1 and px.stride(0) > 0:
        stride = px.stride(0)
    else:
        raise ValueError("bilerp_trace: positions must be contiguous, or "
                         "1-D with any element stride")
    return tuple(px.shape), px.numel(), 0, stride


def trace_plan(u, v, h, subs, start, fields=(), off=(0.0, 0.0),
               minmax=False, write_pos=True, final_clamp=None,
               interleave=False):
    """What one launch of the trace mode takes, from shapes alone: the 23
    floats `fp` of gfs_bilerp_trace (h, the two coefficient sets, the
    substep clamp, the final clamp, the lattice offset, the fields'
    offset; the kernel rounds each to float32 as torch.clamp and ctypes
    do), its 10 ints `ip` (substeps, final clamp on, positions, lattice
    nodes along y or 0, input and output element strides, C, the fields'
    extents, min/max on) and the output's shape. Raises where the
    kernel's 32-bit offsets or channel count would not hold."""
    ni, nj = v.shape[0], u.shape[1]
    if tuple(u.shape) != (ni + 1, nj) or ni < 2 or nj < 2:
        raise ValueError(f"bilerp_trace: u {tuple(u.shape)}, v "
                         f"{tuple(v.shape)}: not a MAC pair of 2x2 or more")
    C = len(fields)
    if C > MAX_CHANNELS or (minmax and not C):
        raise ValueError(f"bilerp_trace: {C} fields (at most "
                         f"{MAX_CHANNELS}; the min/max needs one)")
    if any(f.shape != fields[0].shape or f.dim() != 2 for f in fields):
        raise ValueError("bilerp_trace: the fields must be 2D, of one shape")
    shape, n, lny, stride = _trace_start(start)
    count, first, last = trace_schedule(subs)
    check_int32("bilerp_trace", fields=max([(ni + 1) * (nj + 1)]
                                           + [f.numel() for f in fields]),
                positions=n * stride, outputs=max(2, C) * n)
    fin = final_clamp is not None
    (flx, fhx), (fly, fhy) = final_clamp if fin else ((0.0, 0.0),) * 2
    (elx, ehx), (ely, ehy) = interp.clamp_bounds_2d(h, ni, nj, eps=0.001)
    fp = [h, *first, *last, elx, ehx, ely, ehy, flx, fhx, fly, fhy,
          *(start.off if lny else (0.0, 0.0)), *off]
    fnx, fny = fields[0].shape if C else (0, 0)
    ip = [count, int(fin), n, lny, stride, 2 if interleave else 1, C,
          fnx, fny, int(minmax)]
    return fp, ip, shape


def bilerp_trace(u, v, h, subs, start, fields=(), off=(0.0, 0.0),
                 minmax=False, write_pos=True, final_clamp=None,
                 interleave=False):
    """A whole CFL-substepped 2D RK3 trace in one launch of the
    bilerp_sample kernel's trace mode: the positions `start` (a pair
    (px, py) of world positions, contiguous or 1-D with a common element
    stride, such as a (P, 2) tensor's columns; or a ``Lattice2D``, which
    the kernel forms itself) traced through the MAC velocity u (ni+1, nj),
    v (ni, nj+1) by each signed float32 substep of `subs` (every one but
    the last equal: ``advect.substeps``), each step clamped to [0.001h,
    L - 0.001h]; then ``final_clamp`` ((lo, hi) per axis, host doubles);
    at the foot the samples of C <= 4 same-shape `fields` on the lattice
    (i + off)*h and, with `minmax`, the min and max of their 4 clamped
    corners. Returns a ``TraceOut``: the foot ((2, *shape), or (*shape, 2)
    with `interleave`; None without `write_pos`), the samples and the
    min/max ((C, *shape) each, or None). ``bilerp_trace_plain`` is the
    same, operation for operation."""
    if not _build.on_card(u, "bilerp_trace"):
        return bilerp_trace_plain(u, v, h, subs, start, fields, off, minmax,
                                  write_pos, final_clamp, interleave)
    fields = list(fields)
    fp, ip, shape = trace_plan(u, v, h, subs, start, fields, off, minmax,
                               write_pos, final_clamp, interleave)
    lattice = isinstance(start, Lattice2D)
    px, py = (None, None) if lattice else start
    for name, t in [("u", u), ("v", v)] + [
            (f"fields[{c}]", f) for c, f in enumerate(fields)]:
        _build.require(t, name)
    # the positions may be strided: device and type only
    for t in [v] + fields + ([] if lattice else [px, py]):
        if t.device != u.device or t.dtype != torch.float32:
            raise ValueError(f"bilerp_trace: every tensor must be float32 on "
                             f"{u.device}, got {t.dtype} on {t.device}")
    n, C = ip[2], len(fields)
    out = trace_outputs(shape, C, minmax, write_pos, interleave, u.device)
    if n == 0:
        return out
    ptr = trace_pointers(out, n, interleave)
    fn = _build.function("bilerp_sample", "gfs_bilerp_trace", _TRACE_ARGS)
    with _build.current(u):
        err = fn(u.data_ptr(), v.data_ptr(), v.shape[0], u.shape[1],
                 _TRACE_FP.pack(*fp), _TRACE_IP.pack(*ip),
                 None if lattice else px.data_ptr(),
                 None if lattice else py.data_ptr(), ptr[0], ptr[1],
                 struct.pack(f"{C}Q", *[f.data_ptr() for f in fields])
                 if C else None, *ptr[2:], _build.stream(u))
    _build.check(err, "bilerp_trace")
    bilerp_trace.launches += 1
    return out


bilerp_trace.launches = 0


def trace_outputs(shape, C, minmax, write_pos, interleave, device):
    """The trace mode's outputs, each a tensor of its own: the foot
    (planar (2, *shape), or (*shape, 2) interleaved), the samples and the
    min and max, (C, *shape) each; None where not asked for."""
    def new(*dims):
        return torch.empty(dims, dtype=torch.float32, device=device)

    pos = None
    if write_pos:
        pos = new(*shape, 2) if interleave else new(2, *shape)
    fields = [new(C, *shape) for _ in range(3 if minmax else 1)] if C else []
    return TraceOut(pos, *(fields + [None] * (3 - len(fields))))


def trace_pointers(out, n, interleave):
    """What the kernel writes, as addresses: the foot's x and its y (the
    next element interleaved, the next plane planar), the samples, the
    min and the max (None where not written)."""
    at = [None] * 5
    if out.pos is not None:
        at[0] = out.pos.data_ptr()
        at[1] = at[0] + 4 * (1 if interleave else n)
    for k, t in enumerate(out[1:]):
        if t is not None:
            at[2 + k] = t.data_ptr()
    return at


def dmc_slopes_2d_plain(u, v, h):
    """What a 2D DMC substep takes from the velocity alone: the cell
    lattice (px, py), the MAC velocity there, and the upwind slopes a =
    (vel - vel(upwind)) / (p - p_upwind) per axis."""
    ni, nj = v.shape[0], u.shape[1]
    px, py = lattice_coords((ni, nj), (0.5, 0.5), h, u.device)
    vel_u, vel_v = interp.mac_velocity_2d(u, v, px, py, h)
    tx = torch.where(vel_u > 0, px - h, px + h)
    ty = torch.where(vel_v > 0, py - h, py + h)
    tu, tv = interp.mac_velocity_2d(u, v, tx, ty, h)
    return (px, py, vel_u, vel_v, (vel_u - tu) / (px - tx),
            (vel_v - tv) / (py - ty))


def dmc_newpos_plain(pos, vel, a, substep):
    """The DMC position update: the exponential step where |a| > 1e-4,
    explicit Euler elsewhere."""
    big = a.abs() > 1e-4
    safe_a = torch.where(big, a, 1.0)
    exp_step = pos - (1.0 - torch.exp(-safe_a * substep)) * vel / safe_a
    return torch.where(big, exp_step, pos - vel * substep)


def dmc_positions_2d_plain(slopes, substep, h, ni, nj):
    """The DMC-traced positions of one substep, clamped to [h, L - h]."""
    px, py, vel_u, vel_v, ax, ay = slopes
    return interp.clamp_pos_2d(dmc_newpos_plain(px, vel_u, ax, substep),
                               dmc_newpos_plain(py, vel_v, ay, substep), h,
                               ni, nj)


def bilerp_dmc_plain(u, v, map_x, map_y, h, subs):
    """Plain version of the DMC mode: the 2D backward map (map_x, map_y)
    after one DMC substep (semiLagAdvectDMC) of each `subs` in turn, the
    map's cell-centre lattice sampled at the DMC-traced node, (2, ni,
    nj). The slopes are taken once, the positions once for each distinct
    substep: they depend on nothing else."""
    maps = torch.stack([map_x, map_y])
    if not subs:
        return maps
    ni, nj = v.shape[0], u.shape[1]
    slopes = dmc_slopes_2d_plain(u, v, h)
    positions = {}
    for sub in subs:
        if sub not in positions:
            positions[sub] = dmc_positions_2d_plain(slopes, sub, h, ni, nj)
        maps = bilerp_sample_plain(maps, *positions[sub], h,
                                   ((0.5, 0.5),) * 2)
    return maps


def dmc_plan(h, sub, ni, nj):
    """The 5 floats of one gfs_bilerp_dmc launch: h, the signed substep
    and the clamp [h, L - h] (lo, hi x, hi y), which the kernel rounds to
    float32 as torch.clamp does."""
    (lo, hx), (_, hy) = interp.clamp_bounds_2d(h, ni, nj)
    return [h, sub, lo, hx, hy]


def bilerp_dmc(u, v, map_x, map_y, h, subs):
    """The 2D backward-map DMC march, one launch of the bilerp_sample
    kernel's DMC mode a substep: each cell node forms its MAC velocity and
    the upwind one, the slopes, the exponential step by the signed
    substep (IEEE expf), the clamp to [h, L - h] and the C=2 sample of the
    map (map_x, map_y), (ni, nj) each, there. Returns the map, (2, ni,
    nj); ``bilerp_dmc_plain`` is the same, bit for bit."""
    if not _build.on_card(map_x, "bilerp_dmc"):
        return bilerp_dmc_plain(u, v, map_x, map_y, h, subs)
    ni, nj = v.shape[0], u.shape[1]
    _build.require(u, "u", shape=(ni + 1, nj))
    _build.require(v, "v", shape=(ni, nj + 1))
    _build.require(map_x, "map_x", shape=(ni, nj))
    _build.require(map_y, "map_y", shape=(ni, nj))
    if ni < 2 or nj < 2:
        raise ValueError(f"bilerp_dmc: a {ni}x{nj} grid")
    if len({t.device for t in (u, v, map_x, map_y)}) != 1:
        raise ValueError("bilerp_dmc: u, v and the map on different devices")
    check_int32("bilerp_dmc", fields=(ni + 1) * (nj + 1), outputs=2 * ni * nj)
    if not subs:
        return torch.stack([map_x, map_y])
    fn = _build.function(
        "bilerp_sample", "gfs_bilerp_dmc",
        [_P, _P, _I, _I, _P, _P, _B, _P, _P])
    # two buffers, in turns: a substep reads the last one's output
    bufs = [torch.empty((2, ni, nj), dtype=torch.float32,
                        device=map_x.device)
            for _ in range(min(len(subs), 2))]
    maps = (map_x, map_y)
    with _build.current(u):
        stream = _build.stream(u)
        for k, sub in enumerate(subs):
            out = bufs[k % 2]
            err = fn(u.data_ptr(), v.data_ptr(), ni, nj, maps[0].data_ptr(),
                     maps[1].data_ptr(),
                     struct.pack("5f", *dmc_plan(h, sub, ni, nj)),
                     out.data_ptr(), stream)
            _build.check(err, "bilerp_dmc")
            bilerp_dmc.launches += 1
            maps = out
    return maps


bilerp_dmc.launches = 0


# ---------------------------------------------------------------------------
# p2g_splat (2D particles to the grid)
# ---------------------------------------------------------------------------

P2G_ORDERS = {"flip": 0, "apic": 1, "polypic": 2}


def p2g_bin_width(nj):
    """The y extent of bin_sort's key, sx*(2nj+4) + ky (the JAX key's)."""
    return 2 * nj + 4


# the keys 0 .. n-1 that p2g_bin_starts looks up, by device: made once a
# grid, not once a step (a fresh arange costs the step a launch and an
# allocation)
_BIN_QUERIES = {}


def p2g_bin_starts(keys, ni, nj):
    """The first particle of every key sx*(2nj+4) + ky, sx in [0, ni), of
    the sorted int64 `keys`: ni*(2nj+4) + 1 int32 offsets, one
    searchsorted."""
    n = ni * p2g_bin_width(nj) + 1
    queries = _BIN_QUERIES.get(keys.device)
    if queries is None or queries.shape[0] != n or queries.dtype != keys.dtype:
        queries = _BIN_QUERIES[keys.device] = torch.arange(
            n, dtype=keys.dtype, device=keys.device)
    return torch.searchsorted(keys, queries, out_int32=True)


def p2g_splat_plain(pos, cols, h, ni, nj, order="flip"):
    """Plain version: (u, v, rho, T) of the bin-sorted particles, each
    lattice's weighted sums divided by its weight + 1e-4: the per-tap
    sorted segment sums (index_add_) of ``particles._splat_multi_sorted``
    (FLIP; cols = (vel_x, vel_y, rho, T)) or ``_splat_poly_multi_sorted``
    (cols = (C_x, C_y, C_rho, C_T), (P, 4) each), term for term as the
    JAX package's."""
    from gpufluidsimulation_tpu_torch.core.grids import Grid2D
    from gpufluidsimulation_tpu_torch.solvers import particles

    g = Grid2D(ni, nj, h)
    lattices = ((g.shape_u, g.OFF_U, cols[:1]),
                (g.shape_v, g.OFF_V, cols[1:2]),
                (g.shape_c, g.OFF_C, cols[2:]))
    out = []
    for shape, off, vals in lattices:
        if order == "flip":
            fields, weight = particles._splat_multi_sorted(shape, pos, vals,
                                                           h, off)
        else:
            fields, weight = particles._splat_poly_multi_sorted(
                shape, pos, vals, h, off, order)
        out.extend(f / weight for f in fields)
    return tuple(out)


def p2g_check_sizes(P, ni, nj):
    """Raise unless the particles, the bin starts and the output fit the
    p2g_splat kernel's 32-bit offsets."""
    check_int32("p2g_splat", positions=2 * P,
                starts=ni * p2g_bin_width(nj) + 1,
                outputs=(ni + 1) * nj + ni * (nj + 1) + 2 * ni * nj)


def p2g_splat(pos, cols, h, ni, nj, keys, order="flip"):
    """Particle-to-grid transfer of bin-sorted particles onto the u, v and
    cell lattices of an ni x nj grid in one launch of the gather-form
    p2g_splat kernel: (u, v, rho, T), each lattice's hat-weighted sums of
    the channel values (``order`` "flip": cols = (vel_x, vel_y, rho, T),
    columns of any element stride) or of the polynomials (``order``
    "apic" or "polypic": cols = (C_x, C_y, C_rho, C_T), (P, 4) rows)
    divided by its weight + 1e-4. `pos` (P, 2) must be in bin_sort's
    order, whose sorted int64 `keys` give the bins' bounds, and within
    [h, (n-1)h] (the step's clamp). The kernel sums every tap's run in
    order and the taps in the JAX package's order: the same bits from
    run to run, and those of ``p2g_splat_plain`` where that sums in
    order (on the CPU)."""
    if not _build.on_card(pos, "p2g_splat"):
        return p2g_splat_plain(pos, cols, h, ni, nj, order)
    if order not in P2G_ORDERS:
        raise ValueError(f"p2g_splat: order {order!r}, expected one of "
                         f"{sorted(P2G_ORDERS)}")
    P = pos.shape[0]
    _build.require(pos, "pos", shape=(P, 2))
    if len(cols) != 4:
        raise ValueError("p2g_splat: need 4 columns (u, v and the cell "
                         "lattice's two)")
    strides = []
    for c, col in enumerate(cols):
        if not col.is_cuda or col.dtype != torch.float32:
            raise ValueError(f"p2g_splat: cols[{c}] must be a float32 CUDA "
                             "tensor")
        if order == "flip":
            if col.dim() != 1 or col.shape[0] != P:
                raise ValueError(f"p2g_splat: cols[{c}] of shape "
                                 f"{tuple(col.shape)}, expected ({P},)")
            strides.append(col.stride(0))
        else:
            _build.require(col, f"cols[{c}]", shape=(P, 4))
            strides.append(4)
    if keys.shape != (P,) or keys.device != pos.device:
        raise ValueError("p2g_splat: one sorted key a particle, on the "
                         "particles' device")
    p2g_check_sizes(P, ni, nj)
    nu, nv, nc = (ni + 1) * nj, ni * (nj + 1), ni * nj
    out = torch.empty(nu + nv + 2 * nc, dtype=torch.float32,
                      device=pos.device)
    if P == 0:
        out.fill_(0.0)
    else:
        starts = p2g_bin_starts(keys, ni, nj)
        fn = _build.function(
            "p2g_splat", "gfs_p2g_splat",
            [_P, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P, _I, _I, _F,
             _LL, _P, _P])
        ptrs = (_P * 4)(*[c.data_ptr() for c in cols])
        stride_host = (_I * 4)(*strides)
        with _build.current(pos):
            err = fn(_build.ptr(pos), ptrs, stride_host, P2G_ORDERS[order],
                     _build.ptr(starts), ni, nj, float(h), P,
                     _build.ptr(out), _build.stream(pos))
        _build.check(err, "p2g_splat")
        p2g_splat.launches += 1
    u, v, rho, T = out.split((nu, nv, nc, nc))
    return (u.view(ni + 1, nj), v.view(ni, nj + 1), rho.view(ni, nj),
            T.view(ni, nj))


p2g_splat.launches = 0
