"""The gather schedule of the ``p2g_splat`` kernel and the cp mode of
``bilerp_sample``, emulated on the CPU against their plain versions (no
JAX).

``p2g_splat`` (csrc/p2g_splat.cu) gives one thread a node: it reads the
bins sx = ii - di (di < 2, or 3 on the u lattice) between the bounds
that one searchsorted over the sorted keys gives, splits each sx group's
run at the first key of the particles whose y tap is their own floor,
sums each of the two runs in order from 0 and adds them to the node's
total in the JAX package's tap order. The emulation below walks the same
runs in the same order, vectorized over the nodes, and must equal
``p2g_splat_plain`` (index_add_, which sums in order on the CPU) bit for
bit, for FLIP, APIC and PolyPIC, with particles on the clamp ring and
pile-ups of 500 and 1,500 in one bin. The bin bounds are checked as
sets: every node's runs hold exactly the particles whose taps reach it.
The kernel's premise, that a particle's y floor follows from its bin key
alone, is checked over float32 positions on and around every bin edge.

The cp mode computes calculateCp with the sampler's float floors, its
float corner clamp and the band test on the floors; emulated op for op,
it must equal ``calculate_cp_plain`` bit for bit, at positions inside,
on and 3 cells outside every band and far outside the grid.
"""

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core.grids import Grid2D
from gpufluidsimulation_tpu_torch.core.interp import div_scalar
from gpufluidsimulation_tpu_torch.ops import interp_fast
from gpufluidsimulation_tpu_torch.solvers import particles as part

F32 = torch.float32
ORDERS = ("flip", "apic", "polypic")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _particles(ni, nj, pile, seed):
    """Sorted particles in [h, (n-1)h]: random ones, rows on the clamp
    ring and `pile` at one ring position (x = h, y = (nj-1)h)."""
    h = 1.0 / ni
    rng = np.random.default_rng(seed)
    P = ni * nj * 16
    pos = np.stack([rng.uniform(h, (ni - 1) * h, P),
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


def _emulate(g, p, keys, order):
    """The kernel's schedule on the CPU: (u, v, rho, T)."""
    h = g.h
    starts = interp_fast.p2g_bin_starts(keys, g.ni, g.nj)
    cols = _cols(p, order)
    px, py = p.pos[:, 0], p.pos[:, 1]
    out = []
    for shape, off, ndi, chans in _lattices(g):
        n = shape[0] * shape[1]
        acc = torch.zeros((len(chans) + 1, n), dtype=F32)
        for di in range(ndi):
            ii, jj, b0, bm, b1 = _runs(g, starts, shape, off, di)
            fi, fj = ii.to(F32), jj.to(F32)
            for lo, hi in ((bm, b1), (b0, bm)):     # dj = 0, then dj = 1
                s = torch.zeros((len(chans) + 1, n), dtype=F32)
                for t in range(int((hi - lo).max().clamp(min=0))):
                    k = (lo + t).clamp(max=p.pos.shape[0] - 1)
                    live = lo + t < hi
                    gx = div_scalar(px[k], h) - off[0]
                    gy = div_scalar(py[k], h) - off[1]
                    w = (torch.clamp(1.0 - (gx - fi).abs(), min=0.0)
                         * torch.clamp(1.0 - (gy - fj).abs(), min=0.0))
                    if order == "flip":
                        vals = [cols[c][k] for c in chans]
                    else:
                        dx, dy = (fi - gx) * h, (fj - gy) * h
                        vals = [part._poly_value(cols[c][k], dx, dy, order)
                                for c in chans]
                    terms = torch.stack([w * v for v in vals] + [w])
                    s = torch.where(live, s + terms, s)
                acc = acc + s
        weight = acc[-1] + 1e-4
        out.extend((acc[c] / weight).reshape(shape)
                   for c in range(len(chans)))
    return out


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("ni,nj,pile", [(24, 40, 500), (13, 9, 1500)])
def test_gather_schedule_matches_the_plain_splat(order, ni, nj, pile):
    g, p, keys = _particles(ni, nj, pile, seed=ni + pile)
    got = _emulate(g, p, keys, order)
    want = interp_fast.p2g_splat_plain(p.pos, _cols(p, order), g.h, ni, nj,
                                       order)
    assert interp_fast.p2g_splat(p.pos, _cols(p, order), g.h, ni, nj, keys,
                                 order)[0].shape == want[0].shape
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a, b), float((a - b).abs().max())
    # the pile-up's nodes took thousands of terms; they are finite
    assert all(bool(torch.isfinite(a).all()) for a in got)


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
