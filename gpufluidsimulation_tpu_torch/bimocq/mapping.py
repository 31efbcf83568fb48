"""BiMocq characteristic-mapping engine, 3D dual-volume subset.

Counterpart of ``gpufluidsimulation_tpu.bimocq.mapping`` for the main
path: per-frame reinitialization, blend 1 (the level-2 tier statically
dead), the dual volume form. Map positions at each kind's lattice are a
static stencil (``map_at_lattice_3d``, plain torch); the field samples at
mapped positions go through the ``trilerp_sample`` kernel in dual mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gpufluidsimulation_tpu_torch.core.grids import band_mask
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast


@dataclasses.dataclass
class MappingState:
    """Forward/backward/backward-prev maps, stacked (3, ni, nj, nk) world
    coordinates. ``None`` maps mark a counter-only alias (see
    init_mapping); ``reinit_count`` is a host int."""

    fwd: Optional[torch.Tensor]
    bwd: Optional[torch.Tensor]
    bwd_prev: Optional[torch.Tensor]
    reinit_count: int = 0


def identity_map_3d(grid, device=None) -> torch.Tensor:
    return torch.stack(grid.node_coords("c", device=device))


def init_mapping(grid, with_prev: bool = True, with_maps: bool = True,
                 device=None) -> MappingState:
    """with_prev=False drops the level-2 bwd_prev map (dead at blend 1);
    with_maps=False keeps only the counter."""
    if not with_maps:
        return MappingState(fwd=None, bwd=None, bwd_prev=None)
    ident = identity_map_3d(grid, device)
    return MappingState(fwd=ident, bwd=ident.clone(),
                        bwd_prev=ident.clone() if with_prev else None)


def reinitialize(mapping: MappingState, grid) -> MappingState:
    if mapping.fwd is None:
        return dataclasses.replace(mapping,
                                   reinit_count=mapping.reinit_count + 1)
    ident = identity_map_3d(grid, mapping.fwd.device)
    return MappingState(
        fwd=ident, bwd=ident.clone(),
        bwd_prev=mapping.bwd if mapping.bwd_prev is not None else None,
        reinit_count=mapping.reinit_count + 1)


def update_mapping_3d(mapping: MappingState, grid, u, v, w, cfldt, dt,
                      from_identity=False) -> MappingState:
    """Backward (DMC substepped) then forward (RK3) march of both maps.
    `cfldt` is the float32 host substep."""
    bx, by, bz = advect.update_backward_map_3d(
        grid, u, v, w, (mapping.bwd[0], mapping.bwd[1], mapping.bwd[2]),
        cfldt, dt, from_identity=from_identity)
    fx, fy, fz = advect.update_forward_map_3d(
        grid, u, v, w, (mapping.fwd[0], mapping.fwd[1], mapping.fwd[2]),
        cfldt, dt, from_identity=from_identity)
    return dataclasses.replace(mapping, bwd=torch.stack([bx, by, bz]),
                               fwd=torch.stack([fx, fy, fz]))


def _band3(shape, a: Tuple[int, int, int], b: Tuple[int, int, int],
           device=None):
    """Mask for the guard `a[d] < idx_d < n_d - b[d]` per axis."""
    return band_mask(shape, [x + 1 for x in a], [x + 1 for x in b], device)


def map_at_lattice_3d(grid, maps, kind, clamp_lo, clamp_hi):
    """Map values at `kind`'s node lattice: the identity stencil for cell
    kinds, a clamped 0.5/0.5 face average along each staggered axis; the
    result is clamped into [lo*h, L - hi*h]."""
    dim = grid.dim_of(kind)
    h = grid.h
    out = []
    for ch in range(3):
        m = maps[ch]
        for axis in range(3):
            if dim[axis]:
                lo = m.narrow(axis, 0, 1)
                hi = m.narrow(axis, m.shape[axis] - 1, 1)
                q = torch.cat([lo, m, hi], dim=axis)
                n = q.shape[axis]
                m = 0.5 * (q.narrow(axis, 0, n - 1) + q.narrow(axis, 1, n - 1))
        out.append(m)
    return (
        out[0].clamp(clamp_lo * h, grid.ni * h - clamp_hi * h),
        out[1].clamp(clamp_lo * h, grid.nj * h - clamp_hi * h),
        out[2].clamp(clamp_lo * h, grid.nk * h - clamp_hi * h),
    )


def volume_prefilter_3d(f):
    """0.5*f + 0.5*(S_x S_y S_z f) with S = [1/8, 3/4, 1/8], edge-padded;
    axis z first, then y, then x (the JAX composition order)."""

    def s(x, axis):
        n = x.shape[axis]
        xp = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)],
                       dim=axis)
        return (0.125 * xp.narrow(axis, 0, n) + 0.75 * x
                + 0.125 * xp.narrow(axis, 2, n))

    return 0.5 * f + 0.5 * s(s(s(f, 2), 1), 0)


def _sample_fields_at(grid, kind, fields, positions, dual=False):
    """Sample N same-shape fields of `kind` at shared world positions:
    one ``trilerp_sample`` launch for all N (dual = the 9-point volume
    blend evaluated in the kernel)."""
    mx, my, mz = positions
    off = grid.off_of(kind)
    out = interp_fast.trilerp_sample(
        torch.stack(fields), mx.contiguous(), my.contiguous(),
        mz.contiguous(), grid.h, (off,) * len(fields), dual=dual)
    return [out[i] for i in range(len(fields))]


def bimocq_advect_3d(grid, kind, fields_cur, fields_init, fields_prev,
                     bwd, bwd_prev, fwd, blend_coeff):
    """Advect + BFECC compensation over N fields of one lattice kind in
    the dual volume form: three ``trilerp_sample`` launches (advect,
    error, correction), each stage ending in the band masks, then the
    27-point clamp. ``blend_coeff=None`` (statically 1) is the only
    supported blend: the level-2 pull-back has weight 0."""
    if blend_coeff is not None:
        raise NotImplementedError(
            "bimocq_advect_3d: only blend_coeff=None (blend 1) is ported")
    del fields_prev, bwd_prev
    dim = grid.dim_of(kind)
    shape = fields_cur[0].shape
    dev = fields_cur[0].device
    band_adv = _band3(shape, (2 + dim[0], 2 + dim[1], 2 + dim[2]), (3, 3, 3),
                      dev)
    band_c = _band3(shape, (1 + dim[0], 1 + dim[1], 1 + dim[2]), (2, 2, 2),
                    dev)

    # advect: pull init back through the backward map
    p1 = map_at_lattice_3d(grid, bwd, kind, 1.0, 1.0)
    advs = _sample_fields_at(grid, kind, list(fields_init), p1, dual=True)
    advs = [torch.where(band_adv, a, cur) for a, cur in zip(advs, fields_cur)]

    # compensate: BFECC error correction + 27-point clamp
    p3 = map_at_lattice_3d(grid, fwd, kind, 0.0, 0.0)
    errs = _sample_fields_at(grid, kind, advs, p3, dual=True)
    errs = [torch.where(band_c, e - init, 0.0)
            for e, init in zip(errs, fields_init)]
    p4 = map_at_lattice_3d(grid, bwd, kind, 0.0, 0.0)
    corrs = _sample_fields_at(grid, kind, errs, p4, dual=True)
    return [advect.clamp_extrema_neighborhood(
                a, torch.where(band_c, a - 0.5 * c, a))
            for a, c in zip(advs, corrs)]


def accumulate_multi_3d(grid, kind, groups, fwd, identity=False):
    """Push coeff-weighted changes through the forward map into their
    bases: `groups` is a list of (base, [(change, coeff), ...]). Only the
    identity forward map is ported, where the 9-point volume average is
    exactly the separable prefilter."""
    if not identity:
        raise NotImplementedError(
            "accumulate_multi_3d: only identity=True is ported")
    del fwd
    dim = grid.dim_of(kind)
    shape = groups[0][0].shape
    band = _band3(shape, (1 + dim[0], 1 + dim[1], 1 + dim[2]), (2, 2, 2),
                  groups[0][0].device)
    outs = []
    for base, pairs in groups:
        if not pairs:
            outs.append(base)
            continue
        tot = pairs[0][1] * pairs[0][0]
        for change, coeff in pairs[1:]:
            tot = tot + coeff * change
        outs.append(torch.where(band, base + volume_prefilter_3d(tot), base))
    return outs
