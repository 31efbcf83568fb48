"""The schedules of the dmc_substep and vol9_fixup kernels, emulated op
for op on the CPU against the port's plain versions (no JAX involved).

``csrc/dmc_substep.cu`` runs one thread per cell, forms every face offset
from the cell's own 32-bit offset and the strides, takes the upwind cell
i -+ 1 without the plain version's clamp (inside the band it lies in
[1, n-2]), floors the map position once and samples the three map
channels from that one weight set, the z corners loaded as a pair. Its
lattice mode forms the cell's position as (float)i * h and writes
clamp(p - disp*h, 0, (n-1)h) inside the band, p outside. Both must equal
``dmc_substep_plain`` and the identity peel bit for bit, with
displacements past one cell (positions clamped on every face and outside
the lattice), |du| on both sides of the exponential step's guard, zero
velocities and both signs of the substep.

``csrc/vol9_fixup.cu`` covers the kind's lattice with 32 x 4 x 1 (k, j, i)
tiles, each inside one decision block, divides the three distinct
coordinates (x0 + d h)/h of each axis once, takes the 9 map samples from
each map channel's clamped 3 x 3 x 3 neighbourhood (the floors of the
three coordinates span at most two adjacent integers), and samples the
flagged fields once a mapped point with one weight set. The whole kernel
is emulated and must equal the plain merge bit for bit, with mapped
positions clamped on every face, unflagged blocks and channels, and the
staggered kinds' last face plane.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.core.grids import Grid3D, band_mask
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from tests.test_torch_rk3_prefilter_layout import _coord, _trilerp, _zpair
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

CSRC = Path(interp_fast.__file__).resolve().parent.parent / "csrc"


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_bitwise(got, want):
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# dmc_substep
# ---------------------------------------------------------------------------

NI, NJ, NK = 12, 14, 16
H = 0.1


def _faces(kind, seed):
    """MAC faces of an NI x NJ x NK grid. "random": normal values of size
    1.5 (displacements past a cell at |sh| >= 1). "guard": values on a
    coarse lattice with a patch of zeros and jitter of the size of the
    exponential step's guard 1e-4 h, so that du is 0, just below and just
    above the guard in many cells, and vel is 0 where the sign test is
    false."""
    rng = np.random.default_rng(seed)
    shapes = ((NI + 1, NJ, NK), (NI, NJ + 1, NK), (NI, NJ, NK + 1))
    out = []
    for s in shapes:
        if kind == "random":
            a = 1.5 * rng.standard_normal(s)
        else:
            a = rng.integers(-2, 3, s) * 0.5
            a[:, :, : s[2] // 3] = 0.0
            jitter = rng.choice([0.0, 0.5e-4, 0.99e-4, 1.01e-4, 2e-4], s)
            a = a + jitter * H * rng.choice([-1.0, 1.0], s)
        out.append(torch.from_numpy(a.astype(np.float32)))
    return out


def _maps(seed, amp):
    """A world map: the cell lattice plus a random displacement."""
    rng = np.random.default_rng(seed)
    g = Grid3D(NI, NJ, NK, H)
    return torch.stack([p + torch.from_numpy(
        (amp * H * rng.standard_normal(p.shape)).astype(np.float32))
        for p in g.node_coords("c")])


def _dmc_disp(vel, t, pos, sh, thresh):
    """The kernel's dmc_disp."""
    sgn = torch.where(pos, 1.0, -1.0)
    du = vel - t
    q = du * sgn * sh
    safe = du.abs() > thresh
    denom = torch.where(safe, du * sgn, 1.0)
    exp_disp = (1.0 - torch.exp(-q)) * vel / denom
    return torch.where(safe, exp_disp, vel * sh)


def _cells(shape):
    ni, nj, nk = shape
    i, j, k = torch.meshgrid(torch.arange(ni), torch.arange(nj),
                             torch.arange(nk), indexing="ij")
    return i, j, k


def _dmc_displacements_by_offsets(u, v, w, sh, thresh):
    """The kernel's face offsets: centre faces at idx, idx + su (u), ov,
    ov + nk (v), ow, ow + 1 (w), with ov = idx + i nk and ow = idx + i nj +
    j; the upwind cell's faces at those offsets moved by -+ one stride per
    axis, unclamped. Cells outside the band read offset 0 instead (their
    values are not used). Returns the three displacements and the band."""
    ni, nj, nk = v.shape[0], u.shape[1], u.shape[2]
    i, j, k = _cells((ni, nj, nk))
    band = band_mask((ni, nj, nk), (2, 2, 2), (3, 3, 3))
    idx = (i * nj + j) * nk + k
    su, sv, sw = nj * nk, (nj + 1) * nk, nj * (nk + 1)
    ov, ow = idx + i * nk, idx + i * nj + j
    uf, vf, wf = u.reshape(-1), v.reshape(-1), w.reshape(-1)

    def at(f, o):
        return f[torch.where(band, o, 0)]

    vu = 0.5 * (at(uf, idx) + at(uf, idx + su))
    vv = 0.5 * (at(vf, ov) + at(vf, ov + nk))
    vw = 0.5 * (at(wf, ow) + at(wf, ow + 1))
    sx, sy, sz = vu > 0.0, vv > 0.0, vw > 0.0
    dy = torch.where(sy, -nk, nk)
    dyw = torch.where(sy, -(nk + 1), nk + 1)
    dz = torch.where(sz, -1, 1)
    tu1 = torch.where(sx, idx - su, idx + su) + dy + dz
    tv1 = torch.where(sx, ov - sv, ov + sv) + dy + dz
    tw1 = torch.where(sx, ow - sw, ow + sw) + dyw + dz
    tu_ = 0.5 * (at(uf, tu1) + at(uf, tu1 + su))
    tv_ = 0.5 * (at(vf, tv1) + at(vf, tv1 + nk))
    tw_ = 0.5 * (at(wf, tw1) + at(wf, tw1 + 1))
    return (_dmc_disp(vu, tu_, sx, sh, thresh),
            _dmc_disp(vv, tv_, sy, sh, thresh),
            _dmc_disp(vw, tw_, sz, sh, thresh)), band


def _dmc_kernel(u, v, w, maps, sh, thresh):
    """The displaced mode: one weight set for the three map channels."""
    (dx, dy, dz), band = _dmc_displacements_by_offsets(u, v, w, sh, thresh)
    ni, nj, nk = maps.shape[1:]
    i, j, k = (c.to(torch.float32) for c in _cells((ni, nj, nk)))
    x, y = _coord(i - dx, ni), _coord(j - dy, nj)
    z = _zpair(k - dz, nk)
    return torch.stack([torch.where(band, _trilerp(maps[c], x, y, z),
                                    maps[c]) for c in range(3)])


def _clamp_pos(x, hi):
    """torch.clamp(x, 0, hi) as the card computes it: a NaN stays."""
    return torch.where(torch.isnan(x), x, torch.minimum(
        torch.maximum(x, torch.tensor(0.0)), torch.tensor(hi)))


def _dmc_lattice_kernel(u, v, w, sh, thresh, h):
    """The lattice mode: p = (float)i * h, clamp(p - disp*h, 0, (n-1)h)
    inside the band, p outside."""
    (dx, dy, dz), band = _dmc_displacements_by_offsets(u, v, w, sh, thresh)
    shape = (v.shape[0], u.shape[1], u.shape[2])
    hf = float(np.float32(h))
    hi = [float(np.float32((n - 1) * h)) for n in shape]
    out = []
    for c, d in zip(_cells(shape), (dx, dy, dz)):
        p = c.to(torch.int32).to(torch.float32) * hf
        out.append(torch.where(band, _clamp_pos(p - d * hf, hi[len(out)]), p))
    return torch.stack(out)


def _old_identity_peel(u, v, w, sh, thresh, grid):
    """The identity peel as ``advect.dmc_backward_identity_3d`` computed it
    in plain torch before the lattice mode: node_coords, the displacements,
    clamp and the interior mask."""
    h = grid.h
    du, dv, dw = interp_fast.dmc_displacements(u, v, w, sh, thresh)
    px, py, pz = grid.node_coords("c")
    nx_ = (px - du * h).clamp(0.0, (grid.ni - 1) * h)
    ny_ = (py - dv * h).clamp(0.0, (grid.nj - 1) * h)
    nz_ = (pz - dw * h).clamp(0.0, (grid.nk - 1) * h)
    mask = grid.interior_mask("c", lo=2, hi=3)
    return torch.stack([torch.where(mask, nx_, px), torch.where(mask, ny_, py),
                        torch.where(mask, nz_, pz)])


@pytest.mark.parametrize("faces", ["random", "guard"])
@pytest.mark.parametrize("sh", [0.4, -0.4, 2.5, -3.0])
def test_dmc_kernel_schedule_matches_plain(faces, sh):
    u, v, w = _faces(faces, 3)
    thresh = interp_fast.dmc_threshold(H)
    maps = _maps(4, 0.7)
    want = interp_fast.dmc_substep_plain(u, v, w, maps, sh, thresh)
    _assert_bitwise(_dmc_kernel(u, v, w, maps, sh, thresh), want)
    # the CPU wrapper is the plain version
    _assert_bitwise(interp_fast.dmc_substep(u, v, w, maps, sh, thresh), want)


def test_dmc_cases_are_hit():
    """The inputs reach what the kernel's shortcuts rest on: map positions
    past one cell, clamped on every face (and outside the lattice, so that
    both z pair edges are taken); |du| on both sides of the guard; zero
    cell-centre velocities; upwind cells on both sides."""
    thresh = interp_fast.dmc_threshold(H)
    band = band_mask((NI, NJ, NK), (2, 2, 2), (3, 3, 3))
    u, v, w = _faces("random", 3)
    (dx, dy, dz), _ = _dmc_displacements_by_offsets(u, v, w, 3.0, thresh)
    k = torch.arange(NK, dtype=torch.float32)
    gz = k - dz
    assert bool((dx.abs()[band] > 1.0).any())
    assert bool((gz[band] < 0).any()) and bool((gz[band] >= NK - 1).any())
    gx = torch.arange(NI, dtype=torch.float32)[:, None, None] - dx
    assert bool((gx[band] < 0).any()) and bool((gx[band] > NI - 1).any())
    u, v, w = _faces("guard", 3)
    vel = interp.mac_velocity_at_c_3d(u, v, w)
    ti = interp_fast._upwind_corner(vel[0], *[c > 0 for c in vel])
    du = (vel[0] - ti)[band].abs()
    assert bool((du > thresh).any()) and bool(((du <= thresh)
                                               & (du > 0)).any())
    assert bool((du == 0).any())
    assert bool((vel[0][band] == 0).any()) and bool((vel[0][band] > 0).any())


@pytest.mark.parametrize("faces", ["random", "guard"])
@pytest.mark.parametrize("sh", [0.4, -0.4, 2.5, -3.0])
def test_dmc_lattice_mode_matches_the_identity_peel(faces, sh):
    grid = Grid3D(NI, NJ, NK, H)
    u, v, w = _faces(faces, 5)
    thresh = interp_fast.dmc_threshold(H)
    want = _old_identity_peel(u, v, w, sh, thresh, grid)
    _assert_bitwise(interp_fast.dmc_substep_lattice_plain(u, v, w, sh, thresh,
                                                          H), want)
    _assert_bitwise(_dmc_lattice_kernel(u, v, w, sh, thresh, H), want)
    # on CPU tensors the lattice entry is the plain version and launches
    # nothing
    before = interp_fast.dmc_substep_lattice.launches
    _assert_bitwise(interp_fast.dmc_substep_lattice(u, v, w, sh, thresh, H),
                    want)
    assert interp_fast.dmc_substep_lattice.launches == before


def test_lattice_position_matches_axis_coords():
    """(float)i * h, as the kernel forms it, is Grid3D.axis_coords('c')."""
    for n, h in ((256, 0.2 / 256), (200, 0.2 / 100), (37, 0.2 / 37),
                 (1024, 0.1)):
        g = Grid3D(n, 3, 4, h)
        want = g.axis_coords("c")[0].reshape(-1)
        got = (torch.arange(n, dtype=torch.int32).to(torch.float32)
               * float(np.float32(h)))
        _assert_bitwise(got, want)


@pytest.mark.parametrize("dt", [0.35, 0.0])
def test_backward_march_from_identity_is_lattice_then_displaced(dt):
    """update_backward_map_3d(from_identity=True) is the lattice mode for
    its first substep and dmc_substep for the others; the lattice mode is
    the identity map's substep up to the rounding of the trilinear blend
    of the identity's node values."""
    grid = Grid3D(NI, NJ, NK, H)
    u, v, w = (0.2 * f for f in _faces("random", 7))
    cfldt = 0.1
    ident = grid.node_coords("c")
    got = advect.update_backward_map_3d(grid, u, v, w, ident, cfldt, dt,
                                        from_identity=True)
    subs = advect.substeps(cfldt, dt)
    assert len(subs) == (4 if dt else 0)
    thresh = interp_fast.dmc_threshold(H)
    maps = torch.stack(ident)
    for n, sub in enumerate(subs):
        sh = float(advect._sh(sub, H))
        if n == 0:
            blend = interp_fast.dmc_substep_plain(u, v, w, maps, sh, thresh)
            maps = interp_fast.dmc_substep_lattice_plain(u, v, w, sh, thresh,
                                                         H)
            assert float((blend - maps).abs().max()) < 1e-6
        else:
            maps = interp_fast.dmc_substep(u, v, w, maps, sh, thresh)
    for a, b in zip(got, maps):
        _assert_bitwise(a, b)


@pytest.mark.parametrize("cells", [
    (1290, 1290, 1290), (1280, 1280, 1280), (700, 1000, 1000),
    (2 ** 29 - 1, 1, 2), (1, 1, 2 ** 29), (1, 2 ** 30, 2), (16, 16, 2),
    (16, 16, 1)])
def test_dmc_size_check(cells):
    """nk >= 2 (the z corner pairs), and every face and the stacked map
    (3 ni nj nk) below 2^31 values."""
    ni, nj, nk = cells
    ok = nk >= 2 and max((ni + 1) * nj * nk, ni * (nj + 1) * nk,
                         ni * nj * (nk + 1), 3 * ni * nj * nk) < 2 ** 31
    if ok:
        interp_fast.dmc_check_sizes(cells)
    else:
        with pytest.raises(ValueError):
            interp_fast.dmc_check_sizes(cells)


# ---------------------------------------------------------------------------
# vol9_fixup: the floors of the map stencil
# ---------------------------------------------------------------------------


def _map_coords(i, off, h):
    """The kernel's map_axis coordinates in float32: x0 = (i + off) h and
    (x0 + d h)/h for d = -1/4, 0, 1/4."""
    h = np.float32(h)
    x0 = (i.astype(np.float32) + np.float32(off)) * h
    return [(x0 + np.float32(d) * h) / h for d in (-0.25, 0.0, 0.25)]


@pytest.mark.parametrize("length", [0.2, 1.0, 12.8, 100.0])
def test_map_stencil_floors_span_two_nodes(length):
    """For every node of grids up to 4096 cells, both node offsets and
    many float32 cell sizes (down to 2^-20, up to 2^7), the three
    coordinates are ordered and their floors lie within B and B + 1 with
    B = floor(c0): the property the 27-node selection rests on."""
    rng = np.random.default_rng(int(length * 10))
    sizes = [16, 37, 100, 128, 200, 255, 256, 257, 512, 1000, 1024, 4096]
    hs = [np.float32(length / n) for n in sizes]
    hs += list(rng.uniform(2.0 ** -20, 2.0 ** 7, 40).astype(np.float32))
    hs += [np.float32(2.0 ** e) for e in range(-20, 8)]
    hs += [np.nextafter(h, np.float32(np.inf)) for h in hs[:12]]
    i = np.arange(0, 4098)
    for h in hs:
        for off in (0.0, -0.5):
            c0, c1, c2 = _map_coords(i, off, h)
            assert c0.dtype == np.float32
            assert ((c0 <= c1) & (c1 <= c2)).all()
            b = np.floor(c0)
            assert ((np.floor(c2) - b <= 1)).all()
            # on the cell lattice (off 0) the stencil splits the nodes
            # B, B + 1 at every node, on a face lattice (off -1/2) it
            # does not
            split = np.floor(c2) > b
            assert (split.all() if off == 0.0 else (~split).all())


# ---------------------------------------------------------------------------
# vol9_fixup: the whole kernel
# ---------------------------------------------------------------------------

# a grid whose vol9 decision lattice is 2 x 2 x 1 blocks of 16 x 16 x 128
VI, VJ, VK = 20, 18, 12


def _vol9_tile():
    src = (CSRC / "vol9_fixup.cu").read_text()
    m = re.search(r"constexpr int kBlockK = (\d+), kBlockJ = (\d+), "
                  r"kBlockI = (\d+);", src)
    k, j, i = (int(x) for x in m.groups())
    return i, j, k


def _tile_flags(flags, kind_shape, block, tile):
    """Per-node flags as the kernel reads them: the kind's lattice cut into
    tiles (i, j, k), each tile's decision block from its first node, a
    tile past the block lattice unflagged as a whole."""
    nb = flags.shape[1:]
    idx, valid = [], []
    for ax in range(3):
        tile_start = (torch.arange(kind_shape[ax]) // tile[ax]) * tile[ax]
        b = tile_start // block[ax]
        shape = [-1 if a == ax else 1 for a in range(3)]
        valid.append((b < nb[ax]).reshape(shape))
        idx.append(b.clamp(max=nb[ax] - 1).reshape(shape))
    return flags[:, idx[0], idx[1], idx[2]] & valid[0] & valid[1] & valid[2]


def _axis3(c, n):
    """The kernel's gfs::axis3 from the three coordinates."""
    base = torch.floor(c[0])
    f = [cq - torch.floor(cq) for cq in c]
    up = [torch.floor(cq) != base for cq in c]
    node = [(base + q).clamp(0, n - 1).long() for q in range(3)]
    return f, up, node


def _lerp(f, lo, hi):
    return (1.0 - f) * lo + f * hi


def _stencil9(field, ax, ay, az):
    """gfs::stencil9: the 9 samples from the clamped 27-node
    neighbourhood, corners in _VOL3 order, then the centre."""
    (fx, ux, ix), (fy, uy, iy), (fz, uz, iz) = ax, ay, az
    _, ny, nz = field.shape
    flat = field.reshape(-1)

    def pick(up, nodes):
        return (torch.where(up, nodes[1], nodes[0]),
                torch.where(up, nodes[2], nodes[1]))

    pairs = ((0, 0), (0, 2), (2, 0), (2, 2), (1, 1))
    Y = [[None] * 3 for _ in pairs]
    for c in range(3):
        vals = [[flat[(ix[a] * ny + iy[b]) * nz + iz[c]] for b in range(3)]
                for a in range(3)]
        X = [[_lerp(fx[q], *pick(ux[q], [vals[a][b] for a in range(3)]))
              for b in range(3)] for q in range(3)]
        for p, (qx, qy) in enumerate(pairs):
            Y[p][c] = _lerp(fy[qy], *pick(uy[qy], X[qx]))

    def zl(p, qz):
        return _lerp(fz[qz], *pick(uz[qz], Y[p]))

    return [zl(3, 2), zl(3, 0), zl(2, 2), zl(2, 0), zl(1, 2), zl(1, 0),
            zl(0, 2), zl(0, 0), zl(4, 1)]


def _vol9_kernel(dual_outs, fields, maps, flags, grid, kind, clamp_lo,
                 clamp_hi, tile):
    """The vol9_fixup kernel over the whole kind lattice."""
    C = fields.shape[0]
    kind_shape = tuple(fields.shape[1:])
    _, block, _ = interp_fast.vol9_blocks(grid.shape_c)
    node_flags = _tile_flags(flags, kind_shape, block, tile)
    h = grid.h
    off = grid.off_of(kind)
    lo, hi = interp_fast.clamp_bounds(grid, clamp_lo, clamp_hi)
    lo = [float(np.float32(x)) for x in lo]
    hi = [float(np.float32(x)) for x in hi]
    nodes = torch.meshgrid(*[torch.arange(n, dtype=torch.int32).to(
        torch.float32) for n in kind_shape], indexing="ij")
    hf = float(np.float32(h))
    axes = []
    for a, n in enumerate(grid.shape_c):
        x0 = (nodes[a] + off[a]) * hf
        c = [interp.div_scalar(x0 + float(np.float32(d) * np.float32(h)), h)
             for d in (-0.25, 0.0, 0.25)]
        axes.append(_axis3(c, n))
    m = [[torch.minimum(torch.maximum(s, torch.tensor(lo[a])),
                        torch.tensor(hi[a]))
          for s in _stencil9(maps[a], *axes)] for a in range(3)]
    acc = centre = None
    for q in range(9):
        X = _coord(interp.div_scalar(m[0][q], h) - off[0], kind_shape[0])
        Y = _coord(interp.div_scalar(m[1][q], h) - off[1], kind_shape[1])
        Z = _zpair(interp.div_scalar(m[2][q], h) - off[2], kind_shape[2])
        vals = torch.stack([_trilerp(fields[c], X, Y, Z) for c in range(C)])
        if q == 0:
            acc = vals
        elif q < 8:
            acc = acc + vals
        else:
            centre = vals
    exact = 0.5 * (acc / 8.0) + 0.5 * centre
    return torch.where(node_flags, exact, dual_outs)


def _vol9_inputs(kind, C, seed, amp):
    """Fields of `kind`, a map displaced by up to `amp` cells (so that
    mapped positions clamp on every face), dual values, and flags set on
    some blocks and channels only."""
    rng = np.random.default_rng(seed)
    grid = Grid3D(VI, VJ, VK, H)
    fields = torch.from_numpy(rng.standard_normal(
        (C,) + grid.shape_of(kind)).astype(np.float32))
    maps = torch.stack([p + torch.from_numpy(
        (amp * H * rng.uniform(-1, 1, p.shape)).astype(np.float32))
        for p in grid.node_coords("c")])
    duals = torch.from_numpy(rng.standard_normal(fields.shape).astype(
        np.float32))
    _, _, nb = interp_fast.vol9_blocks(grid.shape_c)
    flags = torch.from_numpy(rng.random((C,) + nb) < 0.6)
    flags[0].view(-1)[0] = True
    flags[-1].view(-1)[-1] = False
    return grid, fields, maps, duals, flags


@pytest.mark.parametrize("kind,C,clamp", [("c", 2, 1.0), ("u", 1, 0.0),
                                          ("v", 1, 0.0), ("w", 3, 1.0)])
@pytest.mark.parametrize("tile", ["shipped", "2x8x4"])
def test_vol9_kernel_schedule_matches_plain(kind, C, clamp, tile):
    grid, fields, maps, duals, flags = _vol9_inputs(kind, C, len(kind) + C,
                                                    3.0)
    want = interp_fast._vol9_merge_plain(duals, fields, maps, flags, grid,
                                         kind, clamp, clamp)
    t = _vol9_tile() if tile == "shipped" else (2, 8, 4)
    got = _vol9_kernel(duals, fields, maps, flags, grid, kind, clamp, clamp,
                       t)
    _assert_bitwise(got, want)
    # some nodes keep their dual value, some are replaced
    changed = got != duals
    assert bool(changed.any()) and bool((~changed).any())


def test_vol9_mapped_positions_clamp_on_every_face():
    grid, _, maps, _, _ = _vol9_inputs("c", 1, 0, 3.0)
    lo, hi = interp_fast.clamp_bounds(grid, 1.0, 1.0)
    g = interp_fast.trilerp_sample_plain(
        maps, *grid.node_coords("c"), grid.h, interp_fast._ZERO3)
    for a in range(3):
        assert bool((g[a] < lo[a]).any()) and bool((g[a] > hi[a]).any())


@pytest.mark.parametrize("kind_shape,grid_n", [
    ((257, 256, 256), (256, 256, 256)), ((101, 200, 200), (100, 200, 200)),
    ((37, 30, 45), (37, 29, 45)), ((16, 16, 129), (16, 16, 128)),
    ((33, 20, 300), (33, 20, 300))])
def test_vol9_tiles_lie_inside_decision_blocks(kind_shape, grid_n):
    """The shipped tile divides the decision block, so the tile mapping
    flags exactly the nodes of ``_expand_flags``, the last face plane
    past the block lattice included."""
    tile = _vol9_tile()
    assert tile == interp_fast.VOL9_TILE
    _, block, nb = interp_fast.vol9_blocks(grid_n)
    assert all(b % t == 0 for b, t in zip(block, tile))
    rng = np.random.default_rng(sum(kind_shape))
    flags = torch.from_numpy(rng.random((2,) + nb) < 0.5)
    want = interp_fast._expand_flags(flags, kind_shape, block)
    _assert_bitwise(_tile_flags(flags, kind_shape, block, tile).to(
        torch.int32), want.to(torch.int32))


@pytest.mark.parametrize("grid_n,kind_shape,C,ok", [
    ((256, 256, 256), (257, 256, 256), 2, True),
    ((700, 1000, 1000), (700, 1000, 1000), 3, True),
    ((700, 1000, 1000), (700, 1000, 1001), 4, False),
    ((1000, 1000, 1000), (1000, 1000, 1000), 1, False),
    ((16, 16, 1), (16, 16, 1), 1, False),
    ((16, 16, 1), (16, 16, 2), 1, True)])
def test_vol9_size_check(grid_n, kind_shape, C, ok):
    """3 ni nj nk map values and C nx ny nz field values below 2^31, and 2
    or more nodes along z (the field's z corner pairs)."""
    if ok:
        interp_fast.vol9_check_sizes(grid_n, kind_shape, C)
    else:
        with pytest.raises(ValueError):
            interp_fast.vol9_check_sizes(grid_n, kind_shape, C)
