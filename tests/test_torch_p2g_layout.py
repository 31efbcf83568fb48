"""The gather schedule of the ``p2g_splat`` kernel and the cp mode of
``bilerp_sample``, emulated on the CPU against their plain versions (no
JAX).

``p2g_splat`` (csrc/p2g_splat.cu) gives a CTA a tile of nodes, one x
column ii of one lattice by a span [J0, J1) of jj, one owner thread a
node. A node reads the bins sx = ii - di (di < 2, or 3 on the u
lattice) between the bounds that one searchsorted over the sorted keys
gives, split at the first key of the particles whose y tap is their own
floor into two runs; the tile's owners' runs of one tap are one slice of
the sorted particles, which the CTA stages in chunks: every staged
particle's terms at the tile's column go to shared-memory slots (dj = 0
at node floor(gy), dj = 1 at the node above), and each owner adds its runs' terms out of the slots in order onto
its two run sums, carried from chunk to chunk and added to its total in
the JAX package's tap order. The emulation below walks the same tiles,
chunks and slots in the same order, vectorized over the tiles, and must
equal ``p2g_splat_plain`` (index_add_, which sums in order on the CPU)
bit for bit, for FLIP, APIC and PolyPIC: with the kernel's tile and
chunk (read from its source) on particles on the clamp ring and pile-ups
of 500 and 1,500 in one bin, and with smaller tiles and chunks on a pile
past one chunk, runs that start mid-chunk, tiles without particles,
fewer particles than a chunk and RT's aspect (16x80). The bin bounds are
checked as sets: every node's runs hold exactly the particles whose taps
reach it, every tile's slice is exactly the span of its owners' runs,
the launch's CTAs own every node once, and the (node, particle, tap)
triples the owners add out of the chunks are the plain version's taps.
The kernel's premise, that a particle's y floor follows from its bin key
alone, is checked over float32 positions on and around every bin edge.

The cp mode computes calculateCp with the sampler's float floors, its
float corner clamp and the band test on the floors; emulated op for op,
it must equal ``calculate_cp_plain`` bit for bit, at positions inside,
on and 3 cells outside every band and far outside the grid.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core.grids import Grid2D
from gpufluidsimulation_tpu_torch.core.interp import div_scalar
from gpufluidsimulation_tpu_torch.ops import interp_fast
from gpufluidsimulation_tpu_torch.solvers import particles as part

F32 = torch.float32
ORDERS = ("flip", "apic", "polypic")
CSRC = Path(interp_fast.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _particles(ni, nj, pile, seed, P=None, x_cells=None):
    """Sorted particles in [h, (n-1)h]: random ones (16 a cell, or P of
    them; with x up to x_cells cells if given), rows on the clamp ring
    and `pile` at one ring position (x = h, y = (nj-1)h)."""
    h = 1.0 / ni
    rng = np.random.default_rng(seed)
    P = P or ni * nj * 16
    pos = np.stack([rng.uniform(h, (x_cells or ni - 1) * h, P),
                    rng.uniform(h, (nj - 1) * h, P)], -1).astype(np.float32)
    ring = (np.float32(h), np.float32((ni - 1) * h), np.float32((nj - 1) * h))
    pos[:40, 0], pos[40:80, 0] = ring[0], ring[1]
    pos[80:120, 1], pos[120:160, 1] = ring[0], ring[2]
    pos[160:160 + pile] = (ring[0], ring[2])
    p = part.ParticleState(
        pos=torch.from_numpy(pos),
        vel=torch.from_numpy(rng.normal(0, 1, (P, 2)).astype(np.float32)),
        rho=torch.from_numpy(rng.uniform(0, 2, P).astype(np.float32)),
        T=torch.from_numpy(rng.normal(0, 1, P).astype(np.float32)),
        **{k: torch.from_numpy(rng.normal(0, 1, (P, 4)).astype(np.float32))
           for k in ("C_x", "C_y", "C_rho", "C_T")})
    g = Grid2D(ni, nj, h)
    p, keys = part.bin_sort(g, p, return_keys=True)
    return g, p, keys


def _cols(p, order):
    if order == "flip":
        return (p.vel[:, 0], p.vel[:, 1], p.rho, p.T)
    return (p.C_x, p.C_y, p.C_rho, p.C_T)


# the kernel's lattices: (shape, offset, x bins read, columns)
def _lattices(g):
    return ((g.shape_u, g.OFF_U, 3, (0,)), (g.shape_v, g.OFF_V, 2, (1,)),
            (g.shape_c, g.OFF_C, 2, (2, 3)))


def _runs(g, starts, shape, off, di):
    """Per node of the lattice (flattened, jj fastest): its sx bin and the
    bounds b0 <= bm <= b1 of the two runs (dj = 1: [b0, bm), dj = 0:
    [bm, b1)); empty where sx leaves [0, ni)."""
    nx, ny = shape
    W = interp_fast.p2g_bin_width(g.nj)
    ii = torch.arange(nx).repeat_interleave(ny)
    jj = torch.arange(ny).repeat(nx)
    split = 2 * jj + int(2 * off[1])
    klo, kmid, khi = ((split - 2).clamp(min=0), split.clamp(max=W),
                      (split + 2).clamp(max=W))
    sx = ii - di
    ok = (sx >= 0) & (sx < g.ni)
    base = sx.clamp(0, g.ni - 1) * W
    starts = starts.long()
    b0, bm, b1 = (torch.where(ok, starts[base + k], 0)
                  for k in (klo, kmid, khi))
    return ii, jj, b0, bm, b1


def _shipped():
    """The kernel's tile (nodes jj a CTA, one owner thread each) and chunk
    (particles staged at a time), read from its source."""
    src = (CSRC / "p2g_splat.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", src)[1])
    assert "constexpr int kTile = kThreads;" in src
    assert "sl[dj * kChunk + k] = make_slot(" in src
    return threads, chunk


def _tiles(shape, tile):
    """A lattice's tiles in the kernel's order: the column ii and the node
    span [J0, J1) of each."""
    nx, ny = shape
    ntj = -(-ny // tile)
    t = torch.arange(nx * ntj)
    ii = t // ntj
    J0 = (t - ii * ntj) * tile
    return ii, J0, (J0 + tile).clamp(max=ny)


def _hat(r):
    return torch.clamp(1.0 - r.abs(), min=0.0)


def _poly(Cf, dx, dy, order):
    val = Cf[..., 0] + Cf[..., 1] * dx + Cf[..., 2] * dy
    if order == "polypic":
        val = val + Cf[..., 3] * dx * dy
    return val


def _emulate(g, p, keys, order, tile=None, chunk=None, seen=None):
    """The kernel's schedule on the CPU, all tiles of a lattice at once:
    (u, v, rho, T) and counts of what the walk met. Per tile and x tap
    the slice of the tap's column, in chunks: every staged particle's
    terms for dj = 0 at node floor(gy) and dj = 1 at the node above, in
    its slot (the others NaN, so that a wrong read shows); then each
    owner's adds of its runs within the chunk, in order, onto its two
    run sums, which go onto its total (dj = 0 first) where the tile's
    tap changes and at the end. `seen`, a list, collects the (node,
    particle, tap) triples the owners added, by lattice."""
    tile, chunk = (tile or _shipped()[0]), (chunk or _shipped()[1])
    h = g.h
    W = interp_fast.p2g_bin_width(g.nj)
    starts = interp_fast.p2g_bin_starts(keys, g.ni, g.nj).long()
    cols = _cols(p, order)
    P = p.pos.shape[0]
    px, py = p.pos[:, 0], p.pos[:, 1]
    k = torch.arange(chunk)
    met = dict(chunks=0, longest_run=0, mid_chunk=0, empty_tiles=0)
    out = []
    for shape, off, ndi, chans in _lattices(g):
        ny = shape[1]
        o = int(2 * off[1])
        nch = len(chans)
        ii, J0, J1 = _tiles(shape, tile)
        T = ii.numel()
        fi = ii.to(F32)[:, None]
        jj = J0[:, None] + torch.arange(tile)[None, :]
        owner = jj < J1[:, None]
        split = 2 * jj + o
        klo, kmid, khi = ((split - 2).clamp(min=0), split.clamp(max=W),
                          (split + 2).clamp(max=W))
        tlo = (2 * J0 + o - 2).clamp(min=0)
        thi = (2 * (J1 - 1) + o + 2).clamp(max=W)
        acc = torch.zeros((T, tile, nch + 1), dtype=F32)
        s = torch.zeros((2, T, tile, nch + 1), dtype=F32)     # dj = 0, 1
        odi = torch.zeros(T, dtype=torch.long)
        empty = torch.ones(T, dtype=torch.bool)
        if seen is not None:
            seen.append([])
        for di in range(ndi):
            sx = ii - di
            ok = (sx >= 0) & (sx < g.ni)
            base = sx.clamp(0, g.ni - 1) * W
            lo = torch.where(ok, starts[base + tlo], 0)
            hi = torch.where(ok, starts[base + thi], 0)
            empty &= lo >= hi
            okn = ok[:, None] & owner
            b0, bm, b1 = (torch.where(okn, starts[(base[:, None] + key).clamp(
                max=starts.shape[0] - 1)], 0) for key in (klo, kmid, khi))
            runs = ((1, b0, bm), (0, bm, b1))
            for _, rlo, rhi in runs:
                met["longest_run"] = max(met["longest_run"],
                                         int((rhi - rlo).max()))
            n_chunks = int(((hi - lo).clamp(min=0) + chunk - 1).max()) // chunk
            for c in range(n_chunks):
                first = lo + c * chunk
                end = torch.minimum(first + chunk, hi)
                live = first < end
                met["chunks"] += int(live.sum())
                gi = (first[:, None] + k).clamp(0, P - 1)
                staged = first[:, None] + k < end[:, None]
                gx = div_scalar(px[gi], h) - off[0]
                gy = div_scalar(py[gi], h) - off[1]
                wx = _hat(gx - fi)
                dx = (fi - gx) * h
                slots = torch.full((2, T, chunk, nch + 1), float("nan"))
                for dj in (0, 1):
                    fj = torch.floor(gy) + dj
                    w = wx * _hat(gy - fj)
                    if order == "flip":
                        vals = [cols[ch][gi] for ch in chans]
                    else:
                        dy = (fj - gy) * h
                        vals = [_poly(cols[ch][gi], dx, dy, order)
                                for ch in chans]
                    terms = torch.stack([w * v for v in vals] + [w], -1)
                    slots[dj][:, k] = torch.where(
                        staged[..., None], terms, float("nan"))
                # a tile's first chunk of a new tap: the last tap's runs
                # go onto the total
                new = (live & (odi != di))[:, None, None]
                acc = torch.where(new, acc + s[0], acc)
                acc = torch.where(new, acc + s[1], acc)
                s = torch.where(new[None], 0.0, s)
                odi = torch.where(live, di, odi)
                for dj, rlo, rhi in runs:
                    a = torch.maximum(rlo, first[:, None])
                    e = torch.minimum(rhi, end[:, None])
                    n = (e - a).clamp(min=0)
                    met["mid_chunk"] += int(((rlo > first[:, None])
                                             & (rlo < end[:, None])
                                             & (rhi > rlo)).sum())
                    sd = s[dj]
                    for m in range(int(n.max())):
                        at = (a + m - first[:, None]).clamp(0, chunk - 1)
                        term = slots[dj].gather(
                            1, at[..., None].expand(-1, -1, nch + 1))
                        sd = torch.where((m < n)[..., None], sd + term, sd)
                        if seen is not None:
                            add = m < n
                            seen[-1].append(torch.stack([
                                (ii[:, None] * ny + jj)[add], (a + m)[add],
                                torch.full_like(a[add], 2 * di + dj)], 1))
                    s[dj] = sd
        acc = acc + s[0]
        acc = acc + s[1]
        met["empty_tiles"] += int(empty.sum())
        weight = acc[..., -1] + 1e-4
        node = (ii[:, None] * ny + jj)[owner]
        for ch in range(nch):
            f = torch.full((shape[0] * ny,), float("nan"))
            f[node] = (acc[..., ch] / weight)[owner]
            out.append(f.reshape(shape))
    return out, met


def _check_against_plain(g, p, keys, order, **kw):
    got, met = _emulate(g, p, keys, order, **kw)
    want = interp_fast.p2g_splat_plain(p.pos, _cols(p, order), g.h, g.ni,
                                       g.nj, order)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a, b), float((a - b).abs().max())
    return got, met


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("ni,nj,pile", [(24, 40, 500), (13, 9, 1500)])
def test_gather_schedule_matches_the_plain_splat(order, ni, nj, pile):
    g, p, keys = _particles(ni, nj, pile, seed=ni + pile)
    got, met = _check_against_plain(g, p, keys, order)
    assert interp_fast.p2g_splat(p.pos, _cols(p, order), g.h, ni, nj, keys,
                                 order)[0].shape == got[0].shape
    # the pile-up's nodes took thousands of terms; they are finite
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert met["longest_run"] >= pile


# (ni, nj, pile, particles, x extent in cells, tile, chunk): the schedule
# with smaller tiles and chunks than the kernel's (None: the kernel's) on
# the edge cases of its walk, each asserted to occur
SCHEDULE_CASES = {
    "pile_past_one_chunk": (13, 9, 1500, None, None, None, None),
    "runs_from_mid_chunk": (24, 40, 300, None, None, 8, 16),
    "tiles_without_particles": (24, 40, 0, None, 9, 8, 64),
    "fewer_particles_than_a_chunk": (24, 40, 0, 200, None, None, None),
    "rt_aspect_16x80": (16, 80, 200, None, None, 16, 64),
}


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_tiled_schedule_edge_cases(order, case):
    ni, nj, pile, P, x_cells, tile, chunk = SCHEDULE_CASES[case]
    g, p, keys = _particles(ni, nj, pile, seed=len(case), P=P,
                            x_cells=x_cells)
    got, met = _check_against_plain(g, p, keys, order, tile=tile,
                                    chunk=chunk)
    chunk = chunk or _shipped()[1]
    assert all(bool(torch.isfinite(a).all()) for a in got)
    if case == "pile_past_one_chunk":
        assert met["longest_run"] > 2 * chunk, met
    if case == "runs_from_mid_chunk":
        assert met["mid_chunk"] > 0 and met["longest_run"] > chunk, met
    if case == "tiles_without_particles":
        assert met["empty_tiles"] > 0, met
    if case == "fewer_particles_than_a_chunk":
        assert p.pos.shape[0] < chunk and met["chunks"] > 0, met


@pytest.mark.parametrize("ni,nj,pile,tile,chunk", [
    (24, 40, 500, None, None), (13, 9, 300, 4, 16), (16, 80, 100, 16, 64)])
def test_tile_slices_cover_each_nodes_runs_exactly(ni, nj, pile, tile,
                                                   chunk):
    """The launch's CTAs own every node of the three lattices once; each
    tile's slice of a tap's column is exactly the span of its owners' runs
    ([b0 of its first node, b1 of its last]); and the (node, particle,
    tap) triples the owners add out of the chunks are the plain version's
    taps, lattice by lattice."""
    threads, _ = _shipped()
    g, p, keys = _particles(ni, nj, pile, seed=2)
    for kt in {threads, tile or threads}:
        shapes = (g.shape_u, g.shape_v, g.shape_c)
        tu = (ni + 1) * -(-nj // kt)
        tv = ni * ((nj + kt) // kt)
        owned = [torch.zeros(s[0] * s[1], dtype=torch.long) for s in shapes]
        for b in range(3 * max(tu, tv)):
            lat, t = b % 3, b // 3
            nx, ny = shapes[lat]
            ntj = -(-ny // kt)
            if t >= nx * ntj:
                continue
            ii, J0 = t // ntj, (t % ntj) * kt
            owned[lat][ii * ny + J0:ii * ny + min(J0 + kt, ny)] += 1
        assert all(bool((o == 1).all()) for o in owned)
    starts = interp_fast.p2g_bin_starts(keys, ni, nj)
    W = interp_fast.p2g_bin_width(nj)
    seen = []
    _emulate(g, p, keys, "flip", tile=tile, chunk=chunk, seen=seen)
    for (shape, off, ndi, _), got in zip(_lattices(g), seen):
        o = int(2 * off[1])
        ii, J0, J1 = _tiles(shape, tile or threads)
        for di in range(ndi):
            _, _, b0, _, b1 = _runs(g, starts, shape, off, di)
            b0, b1 = b0.reshape(shape), b1.reshape(shape)
            sx = ii - di
            ok = (sx >= 0) & (sx < ni)
            base = sx.clamp(0, ni - 1) * W
            lo = starts.long()[base + (2 * J0 + o - 2).clamp(min=0)]
            hi = starts.long()[base + (2 * (J1 - 1) + o + 2).clamp(max=W)]
            assert torch.equal(lo[ok], b0[ii, J0][ok])
            assert torch.equal(hi[ok], b1[ii, J1 - 1][ok])
        want = torch.cat([torch.stack([flat, torch.arange(p.pos.shape[0]),
                                       torch.full_like(flat, t)], 1)
                          for t, (flat, _, _, _) in enumerate(
                              part._sorted_taps(shape, p.pos, g.h, off))])
        got = torch.cat(got)

        def rows(x):
            return sorted(map(tuple, x.tolist()))

        assert rows(got) == rows(want), shape


def test_owner_map_spreads_neighbouring_nodes_over_warps():
    """The kernel's thread-to-node map, read from its source and evaluated
    for every thread of a CTA: each node of the tile has one owner, and
    two neighbouring nodes (the two y taps of one particle, so the two
    chains of a pile) are owned by threads of two different warps."""
    src = (CSRC / "p2g_splat.cu").read_text()
    expr = re.search(r"const int jj = J0 \+ (.*);", src)[1]
    threads, _ = _shipped()
    node = [eval(expr, {"t": t}) for t in range(threads)]
    assert sorted(node) == list(range(threads))
    warp = {n: t // 32 for t, n in enumerate(node)}
    assert all(warp[n] != warp[n + 1] for n in range(threads - 1))


@pytest.mark.parametrize("ni,nj,pile", [(24, 40, 500), (13, 9, 1500)])
def test_runs_hold_exactly_the_taps_of_each_node(ni, nj, pile):
    """The multiset of (node, particle, tap) that the runs visit equals
    the plain version's taps, lattice by lattice."""
    g, p, keys = _particles(ni, nj, pile, seed=1)
    starts = interp_fast.p2g_bin_starts(keys, ni, nj)
    W = interp_fast.p2g_bin_width(nj)
    assert starts.dtype == torch.int32 and starts.shape == (ni * W + 1,)
    assert bool((starts[1:] >= starts[:-1]).all())
    assert int(starts[0]) == 0 and int(starts[-1]) == p.pos.shape[0]
    for shape, off, ndi, _ in _lattices(g):
        ny = shape[1]
        seen = []
        for di in range(ndi):
            ii, jj, b0, bm, b1 = _runs(g, starts, shape, off, di)
            for dj, (lo, hi) in enumerate(((bm, b1), (b0, bm))):
                n = (hi - lo).clamp(min=0)
                node = (ii * ny + jj).repeat_interleave(n)
                first = torch.repeat_interleave(lo, n)
                offs = torch.arange(int(n.sum())) - torch.repeat_interleave(
                    torch.cumsum(n, 0) - n, n)
                tap = torch.full_like(node, 2 * di + dj)
                seen.append(torch.stack([node, first + offs, tap], 1))
        want = [torch.stack([flat, torch.arange(p.pos.shape[0]),
                             torch.full_like(flat, t)], 1)
                for t, (flat, _, _, _) in enumerate(
                    part._sorted_taps(shape, p.pos, g.h, off))]
        got, want = torch.cat(seen), torch.cat(want)

        def rows(x):
            return sorted(map(tuple, x.tolist()))

        assert rows(got) == rows(want), shape


@pytest.mark.parametrize("h", [1.0 / 24, 2 * np.pi / 256, 0.2 / 256,
                               1.0 / 37])
def test_y_floor_follows_from_the_bin_key(h):
    """floor(y/h - oy) == floor((ky - 2 oy) / 2) with ky = floor(2y/h),
    for oy in {0, 0.5}, at float32 positions within 64 ulps of every half
    cell edge of [0, 64h] and at 10^6 random ones: the kernel's runs
    split at 2(jj + oy) need no widening."""
    edges = torch.arange(0, 129, dtype=torch.float64) * (h / 2)
    base = edges.to(F32)
    steps = torch.arange(-64, 65, dtype=torch.int32)
    bits = base.view(torch.int32)[:, None] + steps[None, :]
    near = bits.reshape(-1).view(F32)
    rand = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 64 * h, 10 ** 6).astype(np.float32))
    y = torch.cat([near[near >= 0], rand])
    ky = torch.floor(div_scalar(2.0 * y, h))
    for oy in (0.0, 0.5):
        j0 = torch.floor(div_scalar(y, h) - oy)
        assert torch.equal(j0, torch.floor((ky - 2 * oy) / 2)), oy


def _cp_emulated(field, px, py, h, off, band):
    """The cp mode op for op: float floors, the float corner clamp of the
    sampler (clamp_node), the band test on the floors."""
    nx, ny = field.shape
    x, y = div_scalar(px, h), div_scalar(py, h)
    gx, gy = x - off[0], y - off[1]
    i0f, j0f = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - i0f, gy - j0f

    def node(i, n):
        return torch.clamp(i, 0.0, float(n - 1)).long()

    ia, ib = node(i0f, nx), node(i0f + 1.0, nx)
    ja, jb = node(j0f, ny), node(j0f + 1.0, ny)
    f = field.reshape(-1)
    v00, v10, v01, v11 = (f[a * ny + b] for a, b in ((ia, ja), (ib, ja),
                                                     (ia, jb), (ib, jb)))
    valid = (i0f >= 0) & (i0f <= band[0]) & (j0f >= 0) & (j0f <= band[1])
    qx, qy = fx * h, fy * h
    a, b = h - qx, h - qy
    hh = torch.tensor(h * h, dtype=F32)
    c = torch.stack([(a * b * v00 + qx * b * v10 + qx * qy * v11
                      + a * qy * v01) / hh,
                     (-b * v00 + b * v10 + qy * v11 - qy * v01) / hh,
                     (-a * v00 - qx * v10 + qx * v11 + a * v01) / hh,
                     (v00 - v10 + v11 - v01) / hh], -1)
    return torch.where(valid[..., None], c, 0.0)


@pytest.mark.parametrize("ni,nj", [(24, 40), (37, 29)])
def test_cp_mode_selection_matches_calculate_cp(ni, nj):
    g = Grid2D(ni, nj, 1.0 / ni)
    h = g.h
    rng = np.random.default_rng(ni)
    n = 20000
    px = rng.uniform(-3 * h, (ni + 3) * h, n).astype(np.float32)
    py = rng.uniform(-3 * h, (nj + 3) * h, n).astype(np.float32)
    # on the lattice lines, the band edges and far outside
    lines = np.arange(200).astype(np.float32)
    px[:200] = (lines % (ni + 1)) * np.float32(h)
    py[200:400] = (lines % (nj + 1)) * np.float32(h)
    px[400:410], py[410:420] = 1e6, -1e6
    px, py = torch.from_numpy(px), torch.from_numpy(py)
    fields = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
              for s in (g.shape_u, g.shape_v, g.shape_c, g.shape_c)]
    offs = (g.OFF_U, g.OFF_V, g.OFF_C, g.OFF_C)
    bands = part.cp_bands(g)
    want = interp_fast.bilerp_sample_cp(fields, px, py, h, offs, bands)
    assert want.shape == (4, n, 4)
    for c, (f, off, band) in enumerate(zip(fields, offs, bands)):
        got = _cp_emulated(f, px, py, h, off, band)
        assert torch.equal(got, want[c]), c
        inside = (want[c] != 0).any(-1)
        assert 0 < int(inside.sum()) < n       # both sides of the band
    assert interp_fast.bilerp_sample_cp.launches == 0


def test_p2g_wrapper_checks():
    with pytest.raises(ValueError):
        interp_fast.p2g_check_sizes(2 ** 30, 24, 40)
    with pytest.raises(ValueError):
        interp_fast.p2g_check_sizes(100, 2 ** 16, 2 ** 15)
    interp_fast.p2g_check_sizes(5 * 2 ** 20, 256, 1280)
    with pytest.raises(ValueError):
        interp_fast.p2g_splat(torch.empty(4, 2, device="meta"), [], 1.0, 4,
                              4, None)
    assert interp_fast.p2g_splat.launches == 0
