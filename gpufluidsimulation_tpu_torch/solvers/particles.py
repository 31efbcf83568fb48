"""Particle transfer schemes (FLIP / APIC / PolyPIC) for the 2D solver.

Counterpart of ``gpufluidsimulation_tpu.solvers.particles``: the particle
state (eight per-particle columns; the grid schemes hold them empty),
seeding, the bin sort, particle-to-grid (P2G) splats and grid-to-particle
(G2P) samples with the bilinear polynomial fit (calculateCp). Kernel:
the tent hat w(r) = max(0, 1 - |r|) per axis; PolyPIC carries the
bilinear polynomial c0 + c1 dx + c2 dy + c3 dx dy, APIC drops the dx*dy
term; every splat is weight-normalized (weight + 1e-4), as in the JAX
package.

On the card the in-step transfers are hand-written kernels: P2G of the
bin-sorted particles is one launch of the gather-form ``p2g_splat``
(``ops/interp_fast.py``, ``csrc/p2g_splat.cu``; deterministic, no
atomics), G2P one mac-mode and one sample-mode ``bilerp_sample`` launch
and calculateCp one launch of its cp mode. The sorted segment sums below
(``_sorted_taps``, ``_splat_multi_sorted``, ``_splat_poly_multi_sorted``)
are the P2G kernel's plain version, tap for tap as the JAX package sums
them; the unsorted splats (``_splat_multi``, ``_splat``,
``_splat_poly_multi``, ``_splat_poly``) are plain torch only, as the JAX
package keeps them for ``sorted_bins=False`` and its oracles.

The JAX package's dense-binned transfer (``particles_dense.py``) has no
counterpart: it is TPU window geometry that computes this module's
function inside its slot and window contract and counts what falls
outside it; the port computes the exact flat transfer with no slot cap.
"""

from __future__ import annotations

import dataclasses

import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.ops import interp_fast

_COLUMNS = ("pos", "vel", "rho", "T", "C_x", "C_y", "C_rho", "C_T")


@dataclasses.dataclass
class ParticleState:
    pos: torch.Tensor   # (P, 2) world positions
    vel: torch.Tensor   # (P, 2)
    rho: torch.Tensor   # (P,)
    T: torch.Tensor     # (P,)
    C_x: torch.Tensor   # (P, 4) bilinear poly coeffs for u
    C_y: torch.Tensor   # (P, 4)
    C_rho: torch.Tensor
    C_T: torch.Tensor

    @classmethod
    def empty(cls, device=None) -> "ParticleState":
        """No particles: every column with P = 0."""
        return cls.zeros(0, device)

    @classmethod
    def zeros(cls, P, device=None, pos=None) -> "ParticleState":
        """P particles with every column zero (at `pos` if given)."""
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return cls(pos=z(P, 2) if pos is None else pos, vel=z(P, 2),
                   rho=z(P), T=z(P), C_x=z(P, 4), C_y=z(P, 4), C_rho=z(P, 4),
                   C_T=z(P, 4))


def seed_particles(grid, N: int, device=None) -> ParticleState:
    """N x N particles per cell on a regular sub-lattice, (i + sub_a,
    j + sub_b) * h with sub = arange(N)/N + 1/(2N), cell-major as the JAX
    package orders them."""
    h, ni, nj = grid.h, grid.ni, grid.nj
    i = torch.arange(ni, dtype=torch.float32, device=device)
    j = torch.arange(nj, dtype=torch.float32, device=device)
    sub = interp.div_scalar(torch.arange(N, dtype=torch.float32,
                                         device=device), N) + 1.0 / (2 * N)
    X = (i[:, None, None, None] + sub[None, None, :, None]) * h
    Y = (j[None, :, None, None] + sub[None, None, None, :]) * h
    shape = (ni, nj, N, N)
    pos = torch.stack([X.expand(shape).reshape(-1),
                       Y.expand(shape).reshape(-1)], dim=-1)
    return ParticleState.zeros(pos.shape[0], device, pos=pos)


def _hat(r):
    return torch.clamp(1.0 - r.abs(), min=0.0)


def _xy(pos, h):
    """pos / h per axis in IEEE division."""
    return interp.div_scalar(pos[:, 0], h), interp.div_scalar(pos[:, 1], h)


# ---------------------------------------------------------------------------
# Binned-sort transfer path: one particle sort a frame makes the flat tap
# index of every lattice (c, u, v) non-decreasing within each tap (the JAX
# module's monotonicity argument), so every splat is a sorted segment sum;
# on the card the sort's bins are what the gather-form P2G kernel walks.
# Key: (sx, ky) with sx = floor(x/h - 0.5) and ky = floor(2y/h), as
# sx*(2nj+4) + ky. Contract: positions in [h, (n-1)h] (the step's clamp).
# ---------------------------------------------------------------------------


def bin_keys(grid, pos):
    """bin_sort's int64 key of each position (P, 2)."""
    x, _ = _xy(pos, grid.h)
    sx = torch.floor(x - 0.5).long()
    ky = torch.floor(interp.div_scalar(2.0 * pos[:, 1], grid.h)).long()
    return sx * interp_fast.p2g_bin_width(grid.nj) + ky


def bin_sort(grid, p: ParticleState, return_keys=False):
    """Sort the particle state by the half-cell bin key (one stable sort,
    as ``jnp.argsort``, and a take of each column); the sorted order is
    written back into the state. With `return_keys` also the sorted keys,
    which bound the bins the P2G kernel reads."""
    keys, order = torch.sort(bin_keys(grid, p.pos), stable=True)
    out = ParticleState(**{name: _take_rows(getattr(p, name), order)
                           for name in _COLUMNS})
    return (out, keys) if return_keys else out


def _take_rows(col, order):
    """col[order] along the particle axis. A (P, 4) column is moved as P
    16-byte complex128 elements (bits only, no arithmetic): on the card
    every row gather of (P, 4) float32 rows (index_select, indexing,
    gather) takes a vectorized per-row kernel made for long rows, far
    slower on these 16-byte rows than an element gather (PERF.md §5)."""
    if col.dim() == 2 and col.shape[1] == 4 and col.is_contiguous():
        return col.view(torch.complex128).view(-1)[order].view(
            torch.float32).view(-1, 4)
    return col[order]


def _sorted_taps(shape, pos, h, off):
    """Yield (flat_ids, wx*wy, ii, jj) per tap for the sorted splat: x taps
    ride the common base sx (3 taps for off_x=0 lattices), y taps the
    per-particle floor."""
    nx, ny = shape
    x, y = _xy(pos, h)
    gx, gy = x - off[0], y - off[1]
    base = torch.floor(x - 0.5).long()
    j0 = torch.floor(gy).long()
    ndi = 2 if off[0] == 0.5 else 3
    for di in range(ndi):
        ii = base + di
        wx = _hat(gx - ii.float())
        for dj in (0, 1):
            jj = j0 + dj
            wy = _hat(gy - jj.float())
            yield ii * ny + jj, wx * wy, ii, jj


def _segment_sum(payload, flat, n):
    """(n, C) sums of the payload rows by flat id, ids outside [0, n)
    dropped (``jax.ops.segment_sum``); index_add_ sums each id's rows in
    order on the CPU."""
    keep = (flat >= 0) & (flat < n)
    payload = torch.where(keep[:, None], payload, 0.0)
    out = torch.zeros((n, payload.shape[1]), dtype=payload.dtype,
                      device=payload.device)
    return out.index_add_(0, flat.clamp(0, n - 1), payload)


def _splat_multi_sorted(shape, pos, vals, h, off):
    """Splat C same-lattice channels over bin-sorted particles: one sorted
    segment sum per tap, 4 taps for the c/v lattices, 6 for u. Returns
    ([field_c...], weight_sum + 1e-4)."""
    nx, ny = shape
    C = len(vals)
    ones = torch.ones(pos.shape[0], dtype=torch.float32, device=pos.device)
    acc = torch.zeros((nx * ny, C + 1), dtype=torch.float32,
                      device=pos.device)
    for flat, w, _, _ in _sorted_taps(shape, pos, h, off):
        payload = torch.stack([w * v for v in vals] + [w * ones], dim=-1)
        acc = acc + _segment_sum(payload, flat, nx * ny)
    acc = acc.reshape(nx, ny, C + 1)
    weight = acc[..., C] + 1e-4
    return [acc[..., c] for c in range(C)], weight


def _poly_value(Cf, dx, dy, order):
    val = Cf[:, 0] + Cf[:, 1] * dx + Cf[:, 2] * dy
    if order == "polypic":
        val = val + Cf[:, 3] * dx * dy
    return val


def _splat_poly_multi_sorted(shape, pos, Cs, h, off, order):
    """The polynomial splat over bin-sorted particles (see
    _splat_multi_sorted): node value c0 + c1 dx + c2 dy (+ c3 dx dy),
    dx = (node - particle) in world units."""
    nx, ny = shape
    nch = len(Cs)
    x, y = _xy(pos, h)
    gx, gy = x - off[0], y - off[1]
    ones = torch.ones(pos.shape[0], dtype=torch.float32, device=pos.device)
    acc = torch.zeros((nx * ny, nch + 1), dtype=torch.float32,
                      device=pos.device)
    for flat, w, ii, jj in _sorted_taps(shape, pos, h, off):
        dx = (ii.float() - gx) * h
        dy = (jj.float() - gy) * h
        vals = [w * _poly_value(Cf, dx, dy, order) for Cf in Cs]
        acc = acc + _segment_sum(torch.stack(vals + [w * ones], dim=-1),
                                 flat, nx * ny)
    acc = acc.reshape(nx, ny, nch + 1)
    weight = acc[..., nch] + 1e-4
    return [acc[..., c] for c in range(nch)], weight


def _unsorted_taps(shape, pos, h, off):
    """Yield (flat ids clipped to the lattice, di, dj float offsets
    (node - g), weight) per tap of the unsorted splat."""
    nx, ny = shape
    x, y = _xy(pos, h)
    gx, gy = x - off[0], y - off[1]
    i0, j0 = torch.floor(gx).long(), torch.floor(gy).long()
    for di in (0, 1):
        for dj in (0, 1):
            ii = (i0 + di).clamp(0, nx - 1)
            jj = (j0 + dj).clamp(0, ny - 1)
            dxg = (i0 + di).float() - gx
            dyg = (j0 + dj).float() - gy
            yield ii * ny + jj, dxg, dyg, _hat(dxg) * _hat(dyg)


def _splat_multi(shape, pos, vals, h, off):
    """Scatter-add C same-lattice channels (plus the shared weight) onto
    the 2x2 hat stencil of each particle's own floors, indices clipped to
    the lattice; one multi-channel scatter per tap into the running sums.
    Returns ([field_c...], weight_sum + 1e-4)."""
    nx, ny = shape
    C = len(vals)
    ones = torch.ones(pos.shape[0], dtype=torch.float32, device=pos.device)
    acc = torch.zeros((nx * ny, C + 1), dtype=torch.float32,
                      device=pos.device)
    for flat, _, _, w in _unsorted_taps(shape, pos, h, off):
        acc.index_add_(0, flat, torch.stack([w * v for v in vals]
                                            + [w * ones], dim=-1))
    acc = acc.reshape(nx, ny, C + 1)
    weight = acc[..., C] + 1e-4
    return [acc[..., c] for c in range(C)], weight


def _splat(shape, pos, val, h, off):
    """Single-channel _splat_multi."""
    fields, weight = _splat_multi(shape, pos, [val], h, off)
    return fields[0], weight


def _splat_poly_multi(shape, pos, Cs, h, off, order):
    """The unsorted polynomial splat of several same-lattice fields (see
    _splat_multi)."""
    nx, ny = shape
    nch = len(Cs)
    ones = torch.ones(pos.shape[0], dtype=torch.float32, device=pos.device)
    acc = torch.zeros((nx * ny, nch + 1), dtype=torch.float32,
                      device=pos.device)
    for flat, dxg, dyg, w in _unsorted_taps(shape, pos, h, off):
        dx, dy = dxg * h, dyg * h
        vals = [w * _poly_value(Cf, dx, dy, order) for Cf in Cs]
        acc.index_add_(0, flat, torch.stack(vals + [w * ones], dim=-1))
    acc = acc.reshape(nx, ny, nch + 1)
    weight = acc[..., nch] + 1e-4
    return [acc[..., c] for c in range(nch)], weight


def _splat_poly(shape, pos, C, h, off, order):
    """Single-channel _splat_poly_multi."""
    fields, weight = _splat_poly_multi(shape, pos, [C], h, off, order)
    return fields[0], weight


def _p2g_unsorted(grid, pos, cols, order):
    out = []
    for (shape, off), vals in zip(
            ((grid.shape_u, grid.OFF_U), (grid.shape_v, grid.OFF_V),
             (grid.shape_c, grid.OFF_C)), (cols[:1], cols[1:2], cols[2:])):
        if order == "flip":
            fields, weight = _splat_multi(shape, pos, vals, grid.h, off)
        else:
            fields, weight = _splat_poly_multi(shape, pos, vals, grid.h, off,
                                               order)
        out.extend(f / weight for f in fields)
    return tuple(out)


def p2g_flip(grid, p: ParticleState, sorted_bins=False, keys=None):
    """FLIP particle->grid transfer of (u, v, rho, T); rho and T share the
    cell lattice's splat. With `sorted_bins=True` the particles were
    bin_sort'ed (`keys`: their sorted keys, recomputed if None) and the
    transfer is one ``p2g_splat`` launch on the card."""
    cols = (p.vel[:, 0], p.vel[:, 1], p.rho, p.T)
    if not sorted_bins:
        return _p2g_unsorted(grid, p.pos, cols, "flip")
    return interp_fast.p2g_splat(p.pos, cols, grid.h, grid.ni, grid.nj,
                                 _keys(grid, p, keys), "flip")


def p2g_poly(grid, p: ParticleState, order, sorted_bins=False, keys=None):
    """APIC/PolyPIC particle->grid transfer; `sorted_bins` and `keys` as
    in p2g_flip."""
    cols = (p.C_x, p.C_y, p.C_rho, p.C_T)
    if not sorted_bins:
        return _p2g_unsorted(grid, p.pos, cols, order)
    return interp_fast.p2g_splat(p.pos, cols, grid.h, grid.ni, grid.nj,
                                 _keys(grid, p, keys), order)


def _keys(grid, p, keys):
    """The sorted keys the card's P2G kernel needs (the CPU's plain
    version needs none)."""
    if keys is None and p.pos.is_cuda:
        keys = bin_keys(grid, p.pos)
    return keys


def calculate_cp(field, pos, h, off, valid_hi_i, valid_hi_j):
    """Bilinear polynomial coefficients of `field` around each particle
    (calculateCp). Returns (P, 4) [c0, c1, c2, c3]; zero outside the valid
    index band."""
    return interp_fast.calculate_cp_plain(field, pos[:, 0], pos[:, 1], h,
                                          off, (valid_hi_i, valid_hi_j))


def columns(pos):
    """The contiguous x and y columns of positions (P, 2)."""
    return pos[:, 0].contiguous(), pos[:, 1].contiguous()


def g2p_sample(grid, u, v, rho, T, pos):
    """Gather grid fields at particle positions
    (sampleParticlesFromGrid): the MAC velocity in one mac-mode launch,
    rho and T in one sample launch."""
    px, py = columns(pos)
    us, vs = interp_fast.bilerp_sample_mac(u, v, px, py, grid.h)
    rs, Ts = interp_fast.bilerp_sample([rho, T], px, py, grid.h,
                                       (grid.OFF_C, grid.OFF_C))
    return us, vs, rs, Ts


def g2p_sample_with_deltas(grid, fields, deltas, pos):
    """``g2p_sample`` of (u, v, rho, T) and of their grid changes (du, dv,
    drho, dT) at the same positions, in two launches: both MAC pairs in
    one mac-mode launch, the four cell fields in one sample launch.
    Returns (samples, delta samples), 4 each."""
    px, py = columns(pos)
    (u, v, rho, T), (du, dv, drho, dT) = fields, deltas
    mac = interp_fast.bilerp_sample_mac(u, v, px, py, grid.h, du, dv)
    cells = interp_fast.bilerp_sample([rho, T, drho, dT], px, py, grid.h,
                                      (grid.OFF_C,) * 4)
    return (mac[0], mac[1], cells[0], cells[1]), (mac[2], mac[3], cells[2],
                                                   cells[3])


def cp_bands(grid):
    """calculateCp's validity bands of u, v, rho and T: the offy > 0 /
    else branches with each field's (ni, nj) arguments."""
    ni, nj = grid.ni, grid.nj
    return ((ni, nj - 2), (ni - 2, nj), (ni - 1, nj - 2), (ni - 1, nj - 2))


def update_cp_all(grid, p: ParticleState, u, v, rho, T) -> ParticleState:
    """C_x, C_y, C_rho and C_T of every particle: calculateCp of u, v, rho
    and T, each in its own band, in one cp-mode launch."""
    px, py = columns(p.pos)
    cp = interp_fast.bilerp_sample_cp(
        [u, v, rho, T], px, py, grid.h,
        (grid.OFF_U, grid.OFF_V, grid.OFF_C, grid.OFF_C), cp_bands(grid))
    return dataclasses.replace(p, C_x=cp[0], C_y=cp[1], C_rho=cp[2],
                               C_T=cp[3])
