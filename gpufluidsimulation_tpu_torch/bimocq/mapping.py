"""BiMocq characteristic-mapping engine, 3D and 2D.

Counterpart of ``gpufluidsimulation_tpu.bimocq.mapping``. In 3D:
the map state and its marches, the pull-back with BFECC compensation and
the two-level (``bwd_prev``) blend, the accumulates through the forward
map, the distortion estimate and reinitialization. Four volume forms,
chosen by ``mode`` as the JAX package's ``mapping._volume_mode`` chooses:

* ``"dual"`` (the default, the JAX package's accelerator mode): map
  positions at each kind's lattice are a static stencil
  (``map_at_lattice_3d``, plain torch) and the field samples at mapped
  positions go through the ``trilerp_sample`` kernel in dual mode; the
  non-identity accumulate is the source prefilter (``volume_prefilter``
  kernel) + a plain trilinear sample;
* ``"vol9"``: each dual stage is followed by the ``vol9_fixup`` kernel,
  which takes the exact 9-position composition on every block where the
  dual form is not provably within tolerance of it; the non-identity
  accumulates go the same way, the level-2 blend stage stays dual;
* ``"prefilter"``: every source is prefiltered (``volume_prefilter``)
  and sampled with plain trilinear;
* ``"exact"`` (the JAX package's exact-gather mode): the reference's
  9-point composition field(M(p + d)), every map and field sample one
  ``trilerp_sample(dual=False)`` launch over the 9 stacked stencil points.

The 2D half (``update_mapping_2d`` .. ``estimate_distortion_2d``) is the
JAX package's 2D pull-back, correction, accumulate and distortion on the
5-point volume stencil (4 corners at +-h/4 weighted 1/8, the centre 1/2),
the stencil's 5 positions batched on a leading axis. Every map and field
sample goes through the ``bilerp_sample`` kernel; fields sampled at the
same positions (a map's x and y; rho's and T's terms; a delta's two
changes) share one launch. ``init_mapping`` and ``reinitialize`` take a
``Grid2D`` as they take a ``Grid3D``.

The identity accumulate after a reinitialization is the prefilter itself
in every form but the exact one.

The bf16 mode (``EngineMode.interp_bf16``): the marches read the bf16
faces of ``update_mapping_3d``'s `window`, and with ``bf16=True`` every
field that the pull-backs and accumulates sample (after its prefilter,
where it has one) is rounded to bfloat16 first, as the JAX package pads
its value windows: the vol9 fixup's composition too, whose decision reads
the float32 fields. Under a mesh the slab samplers round and the
z-staggered kind's whole samples do not (JAX gathers it exactly), and the
sharded marches read the window's faces forward and the float32 faces
backward. Maps and the identity accumulate stay float32. In 2D
(``bf16=True`` of the pull-back, correction and accumulate) every field
sample rounds and the map samples do not. The multi-kind pull-back
(``bimocq_advect_multi_3d``, each sampling stage one ``pullback_sample``
launch across all kinds) is parked, as in the JAX package: no solver path
calls it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.core.grids import band_mask
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from gpufluidsimulation_tpu_torch.parallel import sharded_interp

_ZERO3 = interp_fast._ZERO3
VOLUME_MODES = ("dual", "vol9", "prefilter", "exact")


@dataclasses.dataclass
class MappingState:
    """Forward/backward/backward-prev maps, stacked (3, ni, nj, nk) world
    coordinates ((2, ni, nj) on a ``Grid2D``). ``None`` maps mark a
    counter-only alias (see init_mapping); ``reinit_count`` is a host
    int."""

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
                      from_identity=False, sharded=None,
                      window=None) -> MappingState:
    """Backward (DMC substepped) then forward (RK3) march of both maps.
    `cfldt` is the float32 host substep. With a ``sharded_interp.Sampling``
    whose mesh divides nk (with the halo inside a slab) the marches run
    z-sharded (``update_mapping_3d_sharded``), as the JAX package routes
    them. `window`: the bf16 mode's faces (``advect.window_faces``)."""
    if sharded is not None and sharded.divides(grid.nk):
        if window is None:
            window = advect.window_faces(u, v, w, sharded.bf16)
        return sharded_interp.update_mapping_3d_sharded(
            mapping, grid, u, v, w, cfldt, dt, sharded.mesh, sharded.halo,
            from_identity=from_identity, counts=sharded.clamped,
            window=window)
    bx, by, bz = advect.update_backward_map_3d(
        grid, u, v, w, (mapping.bwd[0], mapping.bwd[1], mapping.bwd[2]),
        cfldt, dt, from_identity=from_identity, window=window)
    fx, fy, fz = advect.update_forward_map_3d(
        grid, u, v, w, (mapping.fwd[0], mapping.fwd[1], mapping.fwd[2]),
        cfldt, dt, from_identity=from_identity, window=window)
    return dataclasses.replace(mapping, bwd=torch.stack([bx, by, bz]),
                               fwd=torch.stack([fx, fy, fz]))


def _band3(shape, a: Tuple[int, int, int], b: Tuple[int, int, int],
           device=None):
    """Mask for the guard `a[d] < idx_d < n_d - b[d]` per axis."""
    return band_mask(shape, [x + 1 for x in a], [x + 1 for x in b], device)


def _bands(kind_dim, shape, device):
    """The advect band (2+dim < idx < n-3) and the compensate/accumulate
    band (1+dim < idx < n-2)."""
    d = kind_dim
    return (_band3(shape, (2 + d[0], 2 + d[1], 2 + d[2]), (3, 3, 3), device),
            _band3(shape, (1 + d[0], 1 + d[1], 1 + d[2]), (2, 2, 2), device))


def _blend_weights(blend_coeff):
    """(b, 1 - b) as float32 values, as the JAX step computes them from
    its float32 blend scalar."""
    b = np.float32(blend_coeff)
    return float(b), float(np.float32(1.0) - b)


def _clamp_world(grid, mx, my, mz, clamp_lo, clamp_hi):
    lo, hi = interp_fast.clamp_bounds(grid, clamp_lo, clamp_hi)
    return tuple(m.clamp(a, b) for m, a, b in zip((mx, my, mz), lo, hi))


def _map_sample_3d(grid, maps, px, py, pz, clamp_lo, clamp_hi):
    """Sample a (3, ni, nj, nk) map at world positions of any shape (one
    C=3 ``trilerp_sample`` launch) and clamp the result into
    [lo*h, L - hi*h]."""
    out = interp_fast.trilerp_sample(maps, px.contiguous(), py.contiguous(),
                                     pz.contiguous(), grid.h, _ZERO3)
    return _clamp_world(grid, out[0], out[1], out[2], clamp_lo, clamp_hi)


def map_at_lattice_3d(grid, maps, kind, clamp_lo, clamp_hi):
    """Map values at `kind`'s node lattice: the identity stencil for cell
    kinds, a clamped 0.5/0.5 face average along each staggered axis; the
    result is clamped into [lo*h, L - hi*h]."""
    dim = grid.dim_of(kind)
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
    return _clamp_world(grid, *out, clamp_lo, clamp_hi)


def volume_prefilter_3d(f):
    """0.5*f + 0.5*(S_x S_y S_z f) with S = [1/8, 3/4, 1/8], edge-padded;
    axis z first, then y, then x (the JAX composition order): one
    ``volume_prefilter`` call."""
    return interp_fast.volume_prefilter(f[None].contiguous())[0]


def _sample_fields_at(grid, kind, fields, positions, dual=False,
                      sharded=None, bf16=False):
    """Sample N same-shape fields of `kind` (a list, or stacked (N, ...))
    at shared world positions: one ``trilerp_sample`` launch for all N
    (dual = the 9-point volume blend evaluated in the kernel). With a
    ``sharded_interp.Sampling``, 3-D positions of the fields' own shape
    whose z extent the mesh divides take one slab-mode launch a slab
    (``sample3_multi_sharded``), as the JAX package routes them; the
    z-staggered kind (nk + 1 planes) is sampled whole. `bf16` samples the
    fields rounded to bfloat16 (the bf16 mode) on one device; under a mesh
    the slab samples round where the routing says (``Sampling.bf16``) and
    the whole samples read the float32 fields, which the JAX package
    gathers exactly."""
    mx, my, mz = positions
    src = fields if torch.is_tensor(fields) else torch.stack(fields)
    slabs = (sharded is not None and mx.dim() == 3
             and tuple(src.shape[1:]) == tuple(mx.shape)
             and sharded.divides(mx.shape[2]))
    rounded = sharded.bf16 if slabs else (bf16 and sharded is None)
    if rounded:
        src = src.to(interp_fast.BF16)
    if slabs:
        out = sharded_interp.sample3_multi_sharded(
            src, mx, my, mz, grid.h, (grid.off_of(kind),) * src.shape[0],
            sharded.mesh, halo=sharded.halo, dual=dual,
            counts=sharded.counts)
        return [out[i] for i in range(src.shape[0])]
    out = interp_fast.trilerp_sample(
        src, mx.contiguous(), my.contiguous(), mz.contiguous(), grid.h,
        (grid.off_of(kind),) * src.shape[0], dual=dual)
    return [out[i] for i in range(src.shape[0])]


def _vol9_sample(grid, kind, fields, map_stats, maps, clamp_lo, clamp_hi,
                 band_lo, band_hi, bf16=False):
    """One vol9 stage over N same-shape fields: the dual ``trilerp_sample``
    launch at the map's lattice values, then ``vol9_fixup`` deciding on
    the stage's band (band_lo + dim < idx < n - band_hi). `bf16`: both
    sample the fields' one bfloat16 rounding, the decision reads the
    float32 fields (the JAX package's vol9 in its bf16 mode)."""
    dim = grid.dim_of(kind)
    src = torch.stack(fields)
    window = src.to(interp_fast.BF16) if bf16 else None
    p1 = map_at_lattice_3d(grid, maps, kind, clamp_lo, clamp_hi)
    duals = interp_fast.trilerp_sample(
        src if window is None else window, *(p.contiguous() for p in p1),
        grid.h, (grid.off_of(kind),) * src.shape[0], dual=True)
    out = interp_fast.vol9_fixup(
        duals, src, map_stats, maps, p1, grid, kind, clamp_lo, clamp_hi,
        band=(band_lo + dim[0], band_lo + dim[1], band_lo + dim[2], band_hi),
        window=window)
    return [out[i] for i in range(src.shape[0])]


# ---------------------------------------------------------------------------
# The exact volume form: single-field ops (advect_kernel, doubleAdvect_kernel,
# cumulate_kernel, gpu_compensate_*), as the JAX package evaluates them off
# its fast path
# ---------------------------------------------------------------------------


def advect_with_map_3d(grid, kind, field_cur, field_init, bwd, bf16=False):
    """Pull field_init back through the backward map (advect_kernel);
    outside the band 2+dim < idx < n-3 the current field is kept. `bf16`
    (here and in the other exact-form ops): the field is sampled rounded
    to bfloat16."""

    def ev(px, py, pz):
        m = _map_sample_3d(grid, bwd, px, py, pz, 1.0, 1.0)
        return _sample_fields_at(grid, kind, [field_init], m, bf16=bf16)[0]

    out = interp_fast.volume_eval_3d(grid, kind, ev, field_cur.device)
    band, _ = _bands(grid.dim_of(kind), field_cur.shape, field_cur.device)
    return torch.where(band, out, field_cur)


def double_advect_3d(grid, kind, field, field_prev, bwd, bwd_prev,
                     blend_coeff, bf16=False):
    """Two-level pull-back through bwd_prev o bwd, blended with `field`
    (doubleAdvect_kernel): field <- blend*field + (1-blend)*prev_value."""

    def ev(px, py, pz):
        m = _map_sample_3d(grid, bwd, px, py, pz, 1.0, 1.0)
        o = _map_sample_3d(grid, bwd_prev, *m, 1.0, 1.0)
        return _sample_fields_at(grid, kind, [field_prev], o, bf16=bf16)[0]

    prev_value = interp_fast.volume_eval_3d(grid, kind, ev, field.device)
    b, one_minus_b = _blend_weights(blend_coeff)
    band, _ = _bands(grid.dim_of(kind), field.shape, field.device)
    return torch.where(band, field * b + one_minus_b * prev_value, field)


def accumulate_3d(grid, kind, dfield_init, field_change, fwd, coeff=1.0,
                  bf16=False):
    """Push a change through the forward map into the init buffer
    (cumulate_kernel): dfield_init += volume<coeff * change(fwd(x))> on
    the band 1+dim < idx < n-2."""

    def ev(px, py, pz):
        m = _map_sample_3d(grid, fwd, px, py, pz, 0.0, 0.0)
        return coeff * _sample_fields_at(grid, kind, [field_change], m,
                                         bf16=bf16)[0]

    delta = interp_fast.volume_eval_3d(grid, kind, ev, dfield_init.device)
    _, band = _bands(grid.dim_of(kind), dfield_init.shape, dfield_init.device)
    return torch.where(band, dfield_init + delta, dfield_init)


def compensate_3d(grid, kind, field_adv, field_init, fwd, bwd, bf16=False):
    """BFECC error compensation (gpu_compensate_velocity/field):
    err = volume<field_adv(fwd(x))> - field_init, out = field_adv -
    0.5*volume<err(bwd(x))>, then the 27-point clamp around field_adv."""
    dev = field_adv.device
    _, band = _bands(grid.dim_of(kind), field_adv.shape, dev)

    def ev_fwd(px, py, pz):
        m = _map_sample_3d(grid, fwd, px, py, pz, 0.0, 0.0)
        return _sample_fields_at(grid, kind, [field_adv], m, bf16=bf16)[0]

    err = interp_fast.volume_eval_3d(grid, kind, ev_fwd, dev) - field_init
    err = torch.where(band, err, 0.0)

    def ev_bwd(px, py, pz):
        m = _map_sample_3d(grid, bwd, px, py, pz, 0.0, 0.0)
        return _sample_fields_at(grid, kind, [err], m, bf16=bf16)[0]

    correction = interp_fast.volume_eval_3d(grid, kind, ev_bwd, dev)
    out = torch.where(band, field_adv - 0.5 * correction, field_adv)
    return advect.clamp_extrema_neighborhood(field_adv, out)


# ---------------------------------------------------------------------------
# Fused per-kind entry points
# ---------------------------------------------------------------------------


def bimocq_advect_3d(grid, kind, fields_cur, fields_init, fields_prev,
                     bwd, bwd_prev, fwd, blend_coeff, mode="dual",
                     map_stats=None, sharded=None, bf16=False):
    """Advect + BFECC compensation + two-level blend over N fields of one
    lattice kind in the volume form `mode` (one of VOLUME_MODES).
    ``blend_coeff=None`` marks the blend as 1: the level-2 pull-back
    through bwd_prev has weight 0 and is skipped.

    Three sampling stages (advect, error, correction), each ending in the
    band masks, then the 27-point clamp; with a blend, one C=3 map sample
    of bwd_prev at the advect positions and one sample of the prev fields
    there. Per stage, "dual" is one ``trilerp_sample`` launch in dual
    mode; "vol9" that launch and ``vol9_fixup`` (`map_stats`: the
    ``interp_fast.vol9_map_stats`` of bwd and of fwd, computed once per
    map and step by the caller), the blend stage staying dual;
    "prefilter" one ``volume_prefilter`` call of the stage's sources and
    a plain trilinear launch. "exact" delegates to the single-field ops.
    `sharded` (a ``sharded_interp.Sampling``) routes the lattice samples
    of "dual" and "prefilter" through the slab kernels. `bf16`: every
    sampled field is rounded to bfloat16 first (the bf16 mode; "vol9"
    decides on the float32 fields)."""
    if mode not in VOLUME_MODES:
        raise ValueError(f"bimocq_advect_3d: unknown volume mode {mode!r}")
    if blend_coeff is not None and (bwd_prev is None
                                    or any(f is None for f in fields_prev)):
        raise ValueError("bimocq_advect_3d: a blend needs bwd_prev and the "
                         "prev fields")
    if mode == "exact":
        outs = []
        for cur, init, prev in zip(fields_cur, fields_init, fields_prev):
            x = advect_with_map_3d(grid, kind, cur, init, bwd, bf16)
            x = compensate_3d(grid, kind, x, init, fwd, bwd, bf16)
            if blend_coeff is not None:
                x = double_advect_3d(grid, kind, x, prev, bwd, bwd_prev,
                                     blend_coeff, bf16)
            outs.append(x)
        return outs

    band_adv, band_c = _bands(grid.dim_of(kind), fields_cur[0].shape,
                              fields_cur[0].device)
    dual = mode != "prefilter"
    if mode == "vol9" and map_stats is None:
        raise ValueError("bimocq_advect_3d: vol9 needs the map statistics")

    def sample(fields, positions):
        src = fields if dual else interp_fast.volume_prefilter(
            torch.stack(fields))
        return _sample_fields_at(grid, kind, src, positions, dual=dual,
                                 sharded=sharded, bf16=bf16)

    def stage(fields, maps, clamp, band_lo):
        """Sample `fields` through `maps` at the kind's lattice; band_lo is
        the stage's band (band_lo + dim < idx < n - band_lo - 1)."""
        if mode == "vol9":
            stats = map_stats[0] if maps is bwd else map_stats[1]
            return _vol9_sample(grid, kind, fields, stats, maps, clamp, clamp,
                                band_lo, band_lo + 1, bf16)
        return sample(fields, map_at_lattice_3d(grid, maps, kind, clamp,
                                                clamp))

    # advect: pull init back through the backward map
    advs = stage(list(fields_init), bwd, 1.0, 2)
    advs = [torch.where(band_adv, a, cur) for a, cur in zip(advs, fields_cur)]

    # compensate: BFECC error correction + 27-point clamp
    errs = stage(advs, fwd, 0.0, 1)
    errs = [torch.where(band_c, e - init, 0.0)
            for e, init in zip(errs, fields_init)]
    corrs = stage(errs, bwd, 0.0, 1)
    comps = [advect.clamp_extrema_neighborhood(
                 a, torch.where(band_c, a - 0.5 * c, a))
             for a, c in zip(advs, corrs)]
    if blend_coeff is None:
        return comps

    # double advect: two-level pull-back through bwd_prev o bwd
    p1 = map_at_lattice_3d(grid, bwd, kind, 1.0, 1.0)
    p2 = _map_sample_3d(grid, bwd_prev, *p1, 1.0, 1.0)
    prevs = sample(list(fields_prev), p2)
    b, one_minus_b = _blend_weights(blend_coeff)
    return [torch.where(band_adv, x * b + one_minus_b * pv, x)
            for x, pv in zip(comps, prevs)]


def _pullback_stage(grid, maps, fields, kinds, clamp_lo, clamp_hi):
    """One fused pull-back of several kinds' fields through `maps` (one
    ``pullback_sample`` launch), each result cut to its kind's shape. A
    face plane outside the evaluated extent (a staggered kind's last plane
    where the JAX block grid ends at the cell count) is zero, as in the
    JAX package; no band guard reads it."""
    dims = tuple(grid.dim_of(k) for k in kinds)
    out = interp_fast.pullback_sample(maps, fields, dims, grid.h,
                                      grid.shape_c, clamp_lo, clamp_hi)
    outs = []
    for i, f in enumerate(fields):
        o = out[i, :f.shape[0], :f.shape[1], :f.shape[2]]
        pad = []
        for ax in (2, 1, 0):
            pad += [0, f.shape[ax] - o.shape[ax]]
        outs.append(torch.nn.functional.pad(o, pad) if any(pad) else o)
    return outs


def bimocq_advect_multi_3d(grid, kinds, fields_cur, fields_init, fields_prev,
                           bwd, bwd_prev, fwd, blend_coeff, mode="prefilter"):
    """Advect + BFECC compensation + two-level blend over several lattice
    kinds at once (the velocity triplet, or rho+T), one field per kind.

    Parked, as in the JAX package: no solver path calls it (there it
    measured 501 -> 568 ms/step at 256^3 against the per-kind path on the
    TPU). With ``mode="exact"`` it delegates per kind to the exact form of
    ``bimocq_advect_3d``; every other mode of VOLUME_MODES takes the fused
    prefilter form, as the JAX function does on its fast path whatever its
    volume mode: each of the advect, error and correction stages
    prefilters its sources and is one ``pullback_sample`` launch across
    all kinds (``_pullback_stage``), then the 27-point clamp, and the
    level-2 blend per kind (map at the lattice, bwd_prev sampled there, a
    plain trilinear sample of the prefiltered prev fields). The blend is
    required: ``blend_coeff=None`` raises, as it fails in JAX."""
    if mode not in VOLUME_MODES:
        raise ValueError(f"bimocq_advect_multi_3d: unknown volume mode "
                         f"{mode!r}")
    if blend_coeff is None or bwd_prev is None:
        raise ValueError("bimocq_advect_multi_3d: needs a blend coefficient "
                         "and bwd_prev")
    if not (len(kinds) == len(fields_cur) == len(fields_init)
            == len(fields_prev)):
        raise ValueError("bimocq_advect_multi_3d: one field of each list per "
                         "kind")
    if mode == "exact":
        return [bimocq_advect_3d(grid, kind, [cur], [init], [prev], bwd,
                                 bwd_prev, fwd, blend_coeff, mode="exact")[0]
                for kind, cur, init, prev in zip(kinds, fields_cur,
                                                 fields_init, fields_prev)]

    bands = [_bands(grid.dim_of(k), f.shape, f.device)
             for k, f in zip(kinds, fields_cur)]

    def pre(fs):
        return [volume_prefilter_3d(f) for f in fs]

    # advect: pull init back through the backward map
    advs = _pullback_stage(grid, bwd, pre(fields_init), kinds, 1.0, 1.0)
    advs = [torch.where(ba, a, cur)
            for (ba, _), a, cur in zip(bands, advs, fields_cur)]

    # compensate: BFECC error correction + 27-point clamp
    errs = _pullback_stage(grid, fwd, pre(advs), kinds, 0.0, 0.0)
    errs = [torch.where(bc, e - init, 0.0)
            for (_, bc), e, init in zip(bands, errs, fields_init)]
    corrs = _pullback_stage(grid, bwd, pre(errs), kinds, 0.0, 0.0)
    comps = [advect.clamp_extrema_neighborhood(
                 a, torch.where(bc, a - 0.5 * c, a))
             for (_, bc), a, c in zip(bands, advs, corrs)]

    # double advect: the positions compose through bwd_prev at
    # data-dependent points, so this stage stays per kind
    prevs = [None] * len(kinds)
    for kind in dict.fromkeys(kinds):
        idxs = [i for i, k in enumerate(kinds) if k == kind]
        p1 = map_at_lattice_3d(grid, bwd, kind, 1.0, 1.0)
        p2 = _map_sample_3d(grid, bwd_prev, *p1, 1.0, 1.0)
        src = interp_fast.volume_prefilter(
            torch.stack([fields_prev[i] for i in idxs]))
        for i, v in zip(idxs, _sample_fields_at(grid, kind, src, p2)):
            prevs[i] = v
    b, one_minus_b = _blend_weights(blend_coeff)
    return [torch.where(ba, x * b + one_minus_b * pv, x)
            for (ba, _), x, pv in zip(bands, comps, prevs)]


def accumulate_multi_3d(grid, kind, groups, fwd, identity=False,
                        mode="dual", fwd_stats=None, sharded=None,
                        bf16=False):
    """Push coeff-weighted changes through the forward map into their
    bases: `groups` is a list of (base, [(change, coeff), ...]).

    Each group's changes are summed into one field first (the pull-back
    is linear). With ``identity=True`` (the map is the identity) the
    deltas are the prefiltered sums, one ``volume_prefilter`` call for
    all groups. Otherwise "vol9" runs the sums through one vol9 stage at
    the forward map's lattice values (`fwd_stats`:
    ``interp_fast.vol9_map_stats`` of fwd), and "dual" and "prefilter"
    sample the prefiltered sums with plain trilinear there (one launch
    for all groups), through the slab kernels with `sharded`. "exact"
    applies ``accumulate_3d`` change by change and ignores `identity`, as
    the JAX package's exact path does. `bf16`: the sampled sums (the
    changes in "exact") are rounded to bfloat16 first; the identity
    accumulate samples nothing."""
    if mode == "exact":
        outs = []
        for base, pairs in groups:
            for change, coeff in pairs:
                base = accumulate_3d(grid, kind, base, change, fwd, coeff,
                                     bf16)
            outs.append(base)
        return outs
    _, band = _bands(grid.dim_of(kind), groups[0][0].shape,
                     groups[0][0].device)
    combined = []
    for base, pairs in groups:
        if not pairs:
            combined.append(torch.zeros_like(base))
            continue
        tot = pairs[0][1] * pairs[0][0]
        for change, coeff in pairs[1:]:
            tot = tot + coeff * change
        combined.append(tot)
    if identity:
        deltas = interp_fast.volume_prefilter(torch.stack(combined))
    elif mode == "vol9":
        if fwd_stats is None:
            raise ValueError("accumulate_multi_3d: vol9 needs the map "
                             "statistics")
        deltas = _vol9_sample(grid, kind, combined, fwd_stats, fwd, 0.0, 0.0,
                              1, 2, bf16)
    else:
        p3 = map_at_lattice_3d(grid, fwd, kind, 0.0, 0.0)
        deltas = _sample_fields_at(
            grid, kind, interp_fast.volume_prefilter(torch.stack(combined)),
            p3, sharded=sharded, bf16=bf16)
    return [torch.where(band, base + delta, base)
            for (base, _), delta in zip(groups, deltas)]


def estimate_distortion_3d(grid, mapping: MappingState, exclude_mask=None):
    """sqrt(max over interior cells of max(|x - F(B(x))|^2,
    |x - B(F(x))|^2)) as a 0-dim tensor on the maps' device
    (estimate_kernel + the host reduction of the reference). Each map
    sample is one C=3 ``trilerp_sample`` launch; `exclude_mask` zeroes
    the cells it marks (solid objects)."""
    px, py, pz = grid.node_coords("c", device=mapping.bwd.device)
    bwd, fwd = mapping.bwd, mapping.fwd

    def sample(maps, qx, qy, qz):
        return interp_fast.trilerp_sample(maps, qx.contiguous(),
                                          qy.contiguous(), qz.contiguous(),
                                          grid.h, _ZERO3)

    b = sample(bwd, px, py, pz)
    f = sample(fwd, b[0], b[1], b[2])
    d_bf = (px - f[0]) ** 2 + (py - f[1]) ** 2 + (pz - f[2]) ** 2
    f = sample(fwd, px, py, pz)
    b = sample(bwd, f[0], f[1], f[2])
    d_fb = (px - b[0]) ** 2 + (py - b[1]) ** 2 + (pz - b[2]) ** 2
    d = torch.maximum(d_bf, d_fb)
    d = torch.where(_band3(d.shape, (1, 1, 1), (2, 2, 2), d.device), d, 0.0)
    if exclude_mask is not None:
        d = torch.where(exclude_mask, 0.0, d)
    return torch.sqrt(d.max())


# ---------------------------------------------------------------------------
# 2D pull-back / correction / push-forward
# ---------------------------------------------------------------------------

# the 5-point stencil's corners (units of h): weight 1/8 each, the centre 1/2
_VOL2 = ((-0.25, -0.25), (0.25, -0.25), (-0.25, 0.25), (0.25, 0.25))

# Guard tables in _band2(shape, a, b) form: a[d] < idx < n_d - b[d], n_d
# the buffer extent (u = (ni+1, nj), v = (ni, nj+1)), as the JAX package
# derives them from the reference's loops
_BANDS_2D_ADVECT = {"u": ((1, 1), (2, 2)), "v": ((1, 1), (2, 2)),
                    "c": ((0, 1), (1, 1))}
_BANDS_2D_CORRECT = {"u": ((1, 0), (2, 1)), "v": ((0, 1), (1, 2)),
                     "c": ((1, 0), (1, 1))}
_BANDS_2D_ACCUM = {"u": ((1, 0), (2, 1)), "v": ((0, 1), (1, 2)),
                   "c": ((1, 0), (1, 1))}


def identity_map_2d(grid, device=None) -> torch.Tensor:
    return torch.stack(grid.node_coords("c", device))


def update_mapping_2d(mapping: MappingState, grid, u, v, cfldt,
                      dt) -> MappingState:
    """Backward (DMC substepped) then forward (RK3) march of both 2D
    maps; `cfldt` is the float32 host substep."""
    bwd = advect.backward_map_2d(grid, u, v,
                                 (mapping.bwd[0], mapping.bwd[1]), cfldt, dt)
    fwd = advect.forward_map_2d(grid, u, v, (mapping.fwd[0], mapping.fwd[1]),
                                cfldt, dt)
    return dataclasses.replace(mapping, bwd=bwd, fwd=fwd)


def _band2(shape, a, b, device=None):
    """Mask for the guard `a[d] < idx_d < n_d - b[d]` on both axes."""
    nx, ny = shape
    ii = torch.arange(nx, device=device)[:, None]
    jj = torch.arange(ny, device=device)[None, :]
    return (ii > a[0]) & (ii < nx - b[0]) & (jj > a[1]) & (jj < ny - b[1])


def _map_sample_2d(grid, maps, px, py):
    """A (2, ni, nj) map sampled at world positions (one C=2 launch), the
    result clamped into [h, L - h]."""
    out = advect._sample_map_2d(grid, maps, px, py)
    return interp.clamp_pos_2d(out[0], out[1], grid.h, grid.ni, grid.nj)


def _volume_positions_2d(grid, kind, device):
    """The 5 stencil positions of every node of `kind`, (5, nx, ny) each:
    the 4 corners p + d*h in _VOL2 order, then the node itself."""
    px, py = grid.node_coords(kind, device)
    h = np.float32(grid.h)
    # each offset d*h rounded to float32, as the JAX package scales its
    # float32 offset table by h
    offs = [(float(np.float32(dx) * h), float(np.float32(dy) * h))
            for dx, dy in _VOL2 + ((0.0, 0.0),)]
    return (torch.stack([px + dx for dx, _ in offs]),
            torch.stack([py + dy for _, dy in offs]))


def _volume_sum_2d(vals):
    """0.125 * (the 4 corner values) + 0.5 * the centre, over a leading
    axis of 5."""
    return (0.125 * (((vals[0] + vals[1]) + vals[2]) + vals[3])
            + 0.5 * vals[4])


def _volume_eval_2d(grid, kind, eval_fn, device=None):
    """The 5-point volume average of eval_fn(px, py), the stencil batched
    on a leading axis of 5."""
    return _volume_sum_2d(eval_fn(*_volume_positions_2d(grid, kind,
                                                        device)))


def _sample_at(grid, kind, fields, px, py, bf16=False):
    """Same-kind fields (their bfloat16 rounding with `bf16`) sampled at
    shared world positions, one launch: (C, *px.shape)."""
    return interp.sample2_lattice_multi(fields, px, py, grid.h,
                                        (grid.off_of(kind),) * len(fields),
                                        bf16)


def advect_bimocq_multi_2d(grid, kind, semis, inits, origins, dfields,
                           dfield_prevs, bwd, bwd_prev, blend_coeff,
                           bf16=False):
    """Two-level blended pull-back of one or two same-kind fields through
    the same maps (advectVelocity/advectScalars):

      out = (1-b) * vol< origin(B_prev(B(x))) + d(B(x)) + d_prev(B_prev(B(x))) >
          +  b    * vol< init(B(x)) + d(B(x)) >

    with the semi-Lagrangian result kept outside the band. At b = 1 the
    level-2 term has weight 0 and is not evaluated. `bf16` (here and in
    the correction and the accumulate): the fields are sampled rounded to
    bfloat16, the maps in float32."""
    dev = semis[0].device
    bx, by = _volume_positions_2d(grid, kind, dev)
    p1 = _map_sample_2d(grid, bwd, bx, by)
    s1 = _sample_at(grid, kind, [f for pair in zip(inits, dfields)
                                 for f in pair], *p1, bf16)
    vals = [s1[2 * k] + s1[2 * k + 1] for k in range(len(semis))]
    if blend_coeff != 1.0:
        p2 = _map_sample_2d(grid, bwd_prev, *p1)
        s2 = _sample_at(grid, kind, [f for pair in zip(origins, dfield_prevs)
                                     for f in pair], *p2, bf16)
        b = float(np.float32(blend_coeff))
        omb = float(np.float32(1.0 - blend_coeff))
        vals = [b * one + omb * ((s2[2 * k] + s1[2 * k + 1]) + s2[2 * k + 1])
                for k, one in enumerate(vals)]
    a, bb = _BANDS_2D_ADVECT[kind]
    band = _band2(semis[0].shape, a, bb, dev)
    return [torch.where(band, _volume_sum_2d(val), semi)
            for val, semi in zip(vals, semis)]


def advect_bimocq_2d(grid, kind, semi_field, init_field, origin_field,
                     dfield, dfield_prev, bwd, bwd_prev, blend_coeff,
                     bf16=False):
    return advect_bimocq_multi_2d(
        grid, kind, [semi_field], [init_field], [origin_field], [dfield],
        [dfield_prev], bwd, bwd_prev, blend_coeff, bf16)[0]


def correct_multi_2d(grid, kind, fields, field_inits, dfields, fwd, bwd,
                     bf16=False):
    """Back-and-forth error correction of same-kind fields through the
    same maps (correctVelocity/correctScalars):

      tmp  = vol< field(F(x)) > - d(x), 0 outside the band;
      tmp  = 0.5*(tmp - field_init)
      out  = field - vol< tmp(B(x)) > in the band
      final= the 9-point clamp of out around field."""
    dev = fields[0].device
    a, b = _BANDS_2D_CORRECT[kind]
    band = _band2(fields[0].shape, a, b, dev)
    bx, by = _volume_positions_2d(grid, kind, dev)
    s = _sample_at(grid, kind, fields, *_map_sample_2d(grid, fwd, bx, by),
                   bf16)
    tmps = []
    for k, (d, init) in enumerate(zip(dfields, field_inits)):
        tmp = torch.where(band, _volume_sum_2d(s[k]) - d, 0.0)
        tmps.append(0.5 * (tmp - init))
    c = _sample_at(grid, kind, tmps, *_map_sample_2d(grid, bwd, bx, by),
                   bf16)
    return [advect.clamp_extrema_neighborhood(
        f, torch.where(band, f - _volume_sum_2d(c[k]), f))
        for k, f in enumerate(fields)]


def correct_2d(grid, kind, field, field_init, dfield, fwd, bwd,
               bf16=False):
    return correct_multi_2d(grid, kind, [field], [field_init], [dfield],
                            fwd, bwd, bf16)[0]


def accumulate_multi_2d(grid, kind, groups, fwd, bf16=False):
    """dfield += vol< coeff * change(F(x)) > change by change, in order,
    for `groups` = [(dfield, [(change, coeff), ...]), ...] of one kind
    (accumulateVelocity/Scalars without error correction): every change
    sampled at the forward map's stencil positions in one launch."""
    dev = groups[0][0].device
    changes = [c for _, pairs in groups for c, _ in pairs]
    bx, by = _volume_positions_2d(grid, kind, dev)
    s = _sample_at(grid, kind, changes, *_map_sample_2d(grid, fwd, bx, by),
                   bf16)
    a, b = _BANDS_2D_ACCUM[kind]
    band = _band2(groups[0][0].shape, a, b, dev)
    outs, q = [], 0
    for base, pairs in groups:
        for _, coeff in pairs:
            base = torch.where(band, base + _volume_sum_2d(coeff * s[q]),
                               base)
            q += 1
        outs.append(base)
    return outs


def accumulate_2d(grid, kind, dfield, change, fwd, coeff=1.0, bf16=False):
    return accumulate_multi_2d(grid, kind, [(dfield, [(change, coeff)])],
                               fwd, bf16)[0]


def estimate_distortion_2d(grid, bwd, fwd):
    """max over the band i, j in [3, n-4] of max(|x - B(F(x))|,
    |x - F(B(x))|) (not squared), a 0-dim tensor on the maps' device."""
    px, py = grid.node_coords("c", bwd.device)
    b = advect._sample_map_2d(grid, bwd, fwd[0], fwd[1])
    d1 = torch.sqrt((b[0] - px) ** 2 + (b[1] - py) ** 2)
    f = advect._sample_map_2d(grid, fwd, bwd[0], bwd[1])
    d2 = torch.sqrt((f[0] - px) ** 2 + (f[1] - py) ** 2)
    band = _band2(px.shape, (2, 2), (3, 3), bwd.device)
    return torch.where(band, torch.maximum(d1, d2), 0.0).max()
