"""The sharded samplers and map marches: each z-slab of the mesh runs the
port's kernels in their slab modes on its own piece of the grid.

Counterpart of ``gpufluidsimulation_tpu.parallel.sharded_interp``. The
fields and position lattices are split into the mesh's z-slabs
(``halo.split_z``), each slab on its device; a field slab is extended by
`halo` planes from its neighbours (``halo_exchange_z_slab``: between
cards a peer copy, on one card a plain copy; at the global edges the edge
plane replicated). Each slab then makes one launch of the kernel in its
slab mode (``interp_fast.Slab``): positions and map values stay global,
the kernel clamps each z node to the global bounds and only then
subtracts the slab's integer origin to address its planes. Nothing is
rebased in float, as the JAX package does (it shifts pz by -(z0 - halo)*h
and lets its window kernels absorb the shift): z/h - s rounds otherwise
than (z - s*h)/h. So a slab launch whose nodes stay inside its planes
gives the bits of the whole-grid launch, and the sharded marches and
samplers equal the single-device ones bit for bit.

The displacement contract: a sample's z displacement from its lattice
site stays within `halo` cells (less 0.25 for the dual form's wider
support). ``_halo_contract_count`` counts the samples past it into the
step's ``interp_overflow``, as the JAX package's sink does. The marches'
kernels count the nodes they clamped to a slab's edge into the port's
own ``Smoke3DState.slab_clamped`` (the JAX package's sharded march
reports nothing to its sink).

The bf16 mode (``EngineMode.interp_bf16``): the samplers take the fields
rounded to bfloat16 (the slab launches read them as the JAX package's
per-shard bf16 windows); the forward march reads the rounded faces in
every stage, its first substep from the identity too (the JAX sharded
march samples its bf16 MAC pack and has no identity peel), and the
backward march reads the float32 faces (JAX forms its DMC velocities in
XLA from the float32 slabs).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from gpufluidsimulation_tpu_torch.parallel import sharding
from gpufluidsimulation_tpu_torch.parallel.halo import gather_z, split_z

# the map halo of a DMC substep: one cell of CFL displacement and one tap
MAP_HALO = 2


class Sampling:
    """The sharded routing of one step: the mesh, the halo, whether the
    slab paths round to bfloat16 (``bf16``: ``EngineMode.slab_bf16``) and
    the step's counts (device tensors): ``counts`` of the samples past the
    halo contract (JAX's sink, summed by ``overflow``), ``clamped`` of the
    march nodes clamped to a slab's edge (the port's own, summed by
    ``clamped_nodes``)."""

    def __init__(self, mesh, halo, bf16=False):
        self.mesh, self.halo, self.bf16 = mesh, int(halo), bool(bf16)
        self.counts, self.clamped = [], []

    @classmethod
    def of(cls, engine_mode, device):
        """The routing an ``EngineMode`` asks for on `device` (the
        state's), or None. An int mesh is that many slabs on `device`; a
        mesh that does not live on `device` raises
        (``sharding.check_placement``)."""
        ss = None if engine_mode is None else engine_mode.sharded
        if ss is None:
            return None
        mesh, halo = ss
        if isinstance(mesh, (int, np.integer)):
            mesh = sharding.make_mesh(int(mesh),
                                      devices=[device] * int(mesh))
        sharding.check_placement(mesh, device, "EngineMode.sharded_sampling")
        return cls(mesh, halo, engine_mode.slab_bf16)

    def divides(self, nz):
        """True when a z extent splits into the mesh's slabs with the halo
        inside each (JAX's routing condition)."""
        D = self.mesh.size
        return nz % D == 0 and self.halo <= nz // D

    def _total(self, counts) -> int:
        if not counts:
            return 0
        home = self.mesh.home
        return int(torch.stack([c.to(home) for c in counts]).sum())

    def overflow(self) -> int:
        """The step's halo-contract count, read on the host (one sync)."""
        return self._total(self.counts)

    def clamped_nodes(self) -> int:
        """The step's march nodes clamped to a slab's edge (one sync)."""
        return self._total(self.clamped)


def halo_exchange_z_slab(slabs, halo):
    """(left, right) halo slabs of `halo` z-planes from each slab's
    neighbours, on the slab's device. At the global edges the edge plane
    is replicated, as the single-device sampler's clamp reads it."""
    D = len(slabs)
    out = []
    for d, s in enumerate(slabs):
        left = (s[..., :1].expand(*s.shape[:-1], halo) if d == 0
                else slabs[d - 1][..., -halo:].to(s.device))
        right = (s[..., -1:].expand(*s.shape[:-1], halo) if d == D - 1
                 else slabs[d + 1][..., :halo].to(s.device))
        out.append((left, right))
    return out


def _extended(slabs, halo):
    """Each slab with its exchanged halo planes, contiguous."""
    return [torch.cat([lo, s, hi], dim=-1).contiguous()
            for s, (lo, hi) in zip(slabs, halo_exchange_z_slab(slabs, halo))]


def _check_geometry(nz: int, mesh, halo: int, what: str):
    d = mesh.size
    if nz % d:
        raise ValueError(
            f"{what}: z extent {nz} does not divide the {d}-device mesh")
    if halo > nz // d:
        raise ValueError(
            f"{what}: halo {halo} exceeds the local slab {nz // d} — "
            "ppermute exchanges immediate neighbors only")


def _halo_contract_count(pz, h, off_zs, halo, dual):
    """The samples whose z displacement from their lattice site exceeds
    the halo (less the dual form's 0.25-cell support), as an int32 count
    on pz's device: |pz/h - off_z - k| > halo - 0.25*dual for the worst
    of the offsets, in float32 as the JAX package counts it."""
    k = torch.arange(pz.shape[2], dtype=torch.float32, device=pz.device)
    zl = interp.div_scalar(pz, h)
    worst = None
    for oz in off_zs:
        d = (zl - float(np.float32(oz)) - k).abs()
        worst = d if worst is None else torch.maximum(worst, d)
    margin = float(np.float32(halo - (0.25 if dual else 0.0)))
    return (worst > margin).sum(dtype=torch.int32)


def sample3_multi_sharded(fields, px, py, pz, h, offs, mesh, *, halo=8,
                          dual=False, counts=None):
    """``interp_fast.trilerp_sample`` of C stacked fields (C, nx, ny, nz)
    at position lattices of the same (nx, ny, nz), z-sharded over `mesh`:
    one slab-mode launch a slab on its halo-extended field slab. Returns
    (C, nx, ny, nz) on px's device; appends the halo-contract count to
    `counts` when given."""
    nz = px.shape[2]
    _check_geometry(nz, mesh, halo, "sample3_multi_sharded")
    if tuple(fields.shape[1:]) != tuple(px.shape):
        raise ValueError(f"sample3_multi_sharded: fields "
                         f"{tuple(fields.shape)} on positions "
                         f"{tuple(px.shape)}")
    if counts is not None:
        counts.append(_halo_contract_count(pz, h, [o[2] for o in offs], halo,
                                           dual))
    nzl = nz // mesh.size
    exts = _extended(split_z(fields, mesh), halo)
    pos = [split_z(p, mesh, contiguous=True) for p in (px, py, pz)]
    outs = [interp_fast.trilerp_sample(
                f, x, y, z, h, offs, dual=dual,
                slab=interp_fast.Slab(nz=nz, src=d * nzl - halo))
            for d, (f, x, y, z) in enumerate(zip(exts, *pos))]
    return gather_z(outs, px.device)


def sample3_fast_sharded(field, px, py, pz, h, off, mesh, *, halo=8,
                         dual=False, counts=None):
    """``sample3_multi_sharded`` of one field."""
    return sample3_multi_sharded(field[None], px, py, pz, h, (off,), mesh,
                                 halo=halo, dual=dual, counts=counts)[0]


def _velocity_slabs(u, v, w, mesh, halo):
    """Each slab's faces: the L = nzl + 2*halo cell planes (at most nk)
    from s0 = clip(z0 - halo, 0, nk - L), w one face plane more, on the
    slab's device; and the slab's (z0, s0)."""
    nk = u.shape[2]
    nzl = nk // mesh.size
    L = min(nzl + 2 * halo, nk)
    out = []
    for d, dev in enumerate(mesh.devices):
        z0 = d * nzl
        s0 = min(max(z0 - halo, 0), nk - L)
        faces = [f[..., s0:s0 + n].to(dev).contiguous()
                 for f, n in ((u, L), (v, L), (w, L + 1))]
        out.append((faces, z0, s0))
    return out


def update_mapping_3d_sharded(mapping, grid, u, v, w, cfldt, dt, mesh,
                              halo=8, from_identity=False, counts=None,
                              window=None):
    """The backward (DMC) then forward (RK3) march with z-sharded maps:
    the counterpart of ``bimocq.mapping.update_mapping_3d``.

    Each slab takes its velocity slab of L = nzl + 2*halo planes from
    s0 = clip(z0 - halo, 0, nk - L). The backward map's slabs exchange a
    halo of ``MAP_HALO`` planes before every DMC substep; each substep is
    one ``dmc_substep`` launch a slab in the slab mode, the band 2 <= idx
    <= n-3 global. The forward positions march slab by slab, one
    ``rk3_substep`` launch a substep, clamped to the global bounds. The
    marches use the kernels in the modes of the single-device march
    (``ops/advect.py``), the identity peel included (the lattice modes,
    with `from_identity`), so the result equals the port's single-device
    march bit for bit while no node leaves its slab. (The JAX package's
    sharded march takes its generic path instead and agrees with its
    single-device march to 1e-5.) Nodes clamped to a slab's edge are
    counted into `counts` when given.

    `window` (the bf16 mode): the bfloat16 faces (``advect.window_faces``)
    that the forward march reads in all three stages of every substep;
    its lattice-mode first substep from the identity samples stage 1 from
    them too, widened to float32. The backward march reads the float32
    faces."""
    ni, nj, nk = grid.shape_c
    h = grid.h
    _check_geometry(nk, mesh, halo, "update_mapping_3d_sharded")
    nzl = nk // mesh.size
    if nzl < MAP_HALO:
        raise ValueError(f"update_mapping_3d_sharded: slabs of {nzl} planes "
                         f"cannot hold the map halo of {MAP_HALO}")
    home = mapping.bwd.device
    vel = _velocity_slabs(u, v, w, mesh, halo)
    ovs = [torch.zeros(1, dtype=torch.int32, device=dev)
           for dev in mesh.devices]

    def slab(s0, z0, **kw):
        return interp_fast.Slab(nz=nk, src=s0, out=z0, out_nz=nzl, **kw)

    # backward map: DMC substeps with an exchanged map halo
    subs = advect.substeps(cfldt, dt)
    thresh = interp_fast.dmc_threshold(h)
    if from_identity and subs:
        sh = float(advect._sh(subs[0], h))
        maps = [interp_fast.dmc_substep_lattice(*f, sh, thresh, h,
                                                slab(s0, z0))
                for f, z0, s0 in vel]
        subs = subs[1:]
    else:
        maps = split_z(mapping.bwd, mesh)
    for sub in subs:
        sh = float(advect._sh(sub, h))
        maps = [interp_fast.dmc_substep(*f, m, sh, thresh,
                                        slab(s0, z0, map=z0 - MAP_HALO), ov)
                for (f, z0, s0), m, ov in zip(vel, _extended(maps, MAP_HALO),
                                              ovs)]
    bwd = gather_z(maps, home)

    # forward map: RK3 substeps of the positions, slab by slab
    if window is not None:
        vel = _velocity_slabs(*window, mesh, halo)
    sign = 1.0 if dt >= 0 else -1.0
    clamp = advect._clamp_grid(grid)
    subs = advect.substeps(cfldt, abs(dt))
    if from_identity and subs:
        sh = advect._sh(subs[0], h, sign)
        pos = [interp_fast.rk3_substep_lattice(
                   *f, (0, 0, 0), sh, clamp, slab(s0, z0), ov,
                   stage1=None if window is None else [
                       interp_fast.widen(x) for x in f])
               for (f, z0, s0), ov in zip(vel, ovs)]
        subs = subs[1:]
    elif from_identity:
        pos = split_z(interp_fast.lattice_positions(grid.shape_c, (0, 0, 0),
                                                    home), mesh, True)
    else:
        pos = split_z(torch.stack([interp.div_scalar(p, h)
                                   for p in mapping.fwd]), mesh, True)
    for sub in subs:
        sh = advect._sh(sub, h, sign)
        pos = [interp_fast.rk3_substep(*f, p, sh, clamp,
                                       interp_fast.Slab(nz=nk, src=s0), ov)
               for (f, _, s0), p, ov in zip(vel, pos, ovs)]
    pos = gather_z(pos, home)
    mask = grid.interior_mask("c", lo=2, hi=3, device=home)
    fwd = torch.stack([torch.where(mask, pos[a] * h, mapping.fwd[a])
                       for a in range(3)])
    if counts is not None:
        counts.append(torch.stack([ov.to(home) for ov in ovs]).sum())
    return dataclasses.replace(mapping, bwd=bwd, fwd=fwd)
