"""The schedules of the pullback_sample and minmax_sample kernels, emulated
op for op on the CPU against the port's plain versions (no JAX involved).

``csrc/pullback_sample.cu`` runs one thread per node of the output extent
on (k, j, i) blocks, over all channels: it loads and divides the node's
three map values by h once, and for each kind (the wrapper puts the
channels of one kind next to each other) the three values one node lower
along its staggered axis, clamped to the map, averages and clips them
once, forms one floor/weight set with the z corners as a pair on that
kind's field extent, and samples each of the kind's channels from it. It
must equal ``pullback_sample_plain`` bit for bit for the kind sets (u, v,
w), (c, c), (u, c, c), (u, v, w, c) and (c, u, c), clamps (1, 1) and
(0, 0), maps displaced so that the clip is hit and missed, positions on
lattice planes and outside every face, and extents that the blocks do
not divide.

``csrc/minmax_sample.cu`` runs one thread per output node on (k, j, i)
blocks, divides p / h once, forms one floor/weight set for all channels
where their offsets agree (else one a channel), loads the z corners as a
pair, takes the min and max over the pair's lower or upper four values
where both clamped z corners fall on one node, and in its sample mode
blends the same corners. It must equal ``minmax_sample_plain`` and
``trilerp_sample_plain`` bit for bit, at C = 1 and 2, with equal and with
differing offsets, positions up to 3 cells outside every face, displaced
by up to 2.5 cells, and on lattice planes.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.core.grids import Grid3D
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from tests.test_torch_rk3_prefilter_layout import _coord, _trilerp, _zpair
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

CSRC = Path(interp_fast.__file__).resolve().parent.parent / "csrc"
SHAPES = ((13, 9, 11), (20, 17, 24))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_bitwise(got, want):
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _block(name):
    """The (k, j, i) thread block shipped in csrc/<name>.cu."""
    src = (CSRC / f"{name}.cu").read_text()
    m = re.search(r"constexpr int kBlockK = (\d+), kBlockJ = (\d+), "
                  r"kBlockI = (\d+);", src)
    return tuple(int(v) for v in m.groups())


def _threads(extent, block):
    """The (i, j, k) node of every thread that passes the kernel's bounds
    check, with its flat output offset, over the kernel's grid of blocks
    (k, j, i) on `extent`."""
    bk, bj, bi = block
    d0, d1, d2 = extent
    nodes = [torch.arange(-(-d // b) * b) for d, b in ((d0, bi), (d1, bj),
                                                        (d2, bk))]
    i, j, k = (t.reshape(-1) for t in torch.meshgrid(*nodes, indexing="ij"))
    inside = (i < d0) & (j < d1) & (k < d2)
    i, j, k = i[inside], j[inside], k[inside]
    return i, j, k, (i * d1 + j) * d2 + k


def _scatter(values, idx, extent):
    out = torch.full((int(np.prod(extent)),), float("nan"))
    out[idx] = values
    return out.reshape(extent)


# ---------------------------------------------------------------------------
# pullback_sample
# ---------------------------------------------------------------------------


def _pullback_kernel(maps, fields, dims, h, grid_n, clamp_lo, clamp_hi):
    """The kernel's schedule: one thread a node over all channels."""
    extent = interp_fast._pullback_extent(maps, fields, dims, grid_n)
    ni, nj, nk = grid_n
    i, j, k, idx = _threads(extent, _block("pullback_sample"))
    flat = maps.reshape(3, -1)

    def map_values(ci, cj, ck):
        at = (ci * nj + cj) * nk + ck
        return [flat[a][at] / h for a in range(3)]

    ci, cj, ck = i.clamp(max=ni - 1), j.clamp(max=nj - 1), k.clamp(max=nk - 1)
    m = map_values(ci, cj, ck)      # loaded and divided once a node
    his = [float(n - clamp_hi) for n in grid_n]
    order = interp_fast.pullback_kind_order(dims)
    stag = [list(d).index(1) if any(d) else -1 for d in dims]
    out = [None] * len(fields)
    prev = None
    formed = 0
    for c in order:
        s = stag[c]
        if s != prev:               # a kind's first channel
            formed += 1
            g = list(m)
            if s >= 0:
                below = map_values(*[(q - int(s == a)).clamp(0, n - 1)
                                     for a, (q, n) in enumerate(zip(
                                         (i, j, k), grid_n))])
                g = [0.5 * (b + a) for b, a in zip(below, g)]
            g = [torch.minimum(torch.maximum(v, torch.tensor(float(clamp_lo))),
                               torch.tensor(hi)) + (0.5 if s == a else 0.0)
                 for a, (v, hi) in enumerate(zip(g, his))]
            nx, ny, nz = fields[c].shape
            x, y, z = _coord(g[0], nx), _coord(g[1], ny), _zpair(g[2], nz)
            prev = s
        out[c] = _scatter(_trilerp(fields[c], x, y, z), idx, extent)
    assert formed == len(set(stag))
    return torch.stack(out)


def _pullback_inputs(shape, kinds, seed, how):
    """Maps and fields on an h = 1/4 grid. "wobble": the identity map plus
    a random displacement of up to 3 cells, so that the clip is hit near
    the faces and missed inside. "planes": the identity plus whole and
    half cells from -4 to 4, so that the averaged, clipped positions lie
    on lattice planes and outside every face."""
    rng = np.random.default_rng(seed)
    g = Grid3D(*shape, 0.25)
    lattice = torch.stack(g.node_coords("c"))
    if how == "wobble":
        disp = rng.uniform(-3.0, 3.0, lattice.shape)
    else:
        disp = rng.integers(-8, 9, lattice.shape) / 2.0
    maps = (lattice + torch.from_numpy((disp * g.h).astype(np.float32)))
    fields = [torch.from_numpy(rng.standard_normal(g.shape_of(kd)).astype(
        np.float32)) for kd in kinds]
    return g, maps.contiguous(), fields, [g.dim_of(kd) for kd in kinds]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kinds", ["uvw", "cc", "ucc", "uvwc", "cuc"])
@pytest.mark.parametrize("clamp", [1.0, 0.0])
@pytest.mark.parametrize("how", ["wobble", "planes"])
def test_pullback_schedule_matches_plain(shape, kinds, clamp, how):
    g, maps, fields, dims = _pullback_inputs(shape, kinds, len(kinds), how)
    args = (maps, fields, dims, g.h, g.shape_c, clamp, clamp)
    _assert_bitwise(_pullback_kernel(*args),
                    interp_fast.pullback_sample_plain(*args))


@pytest.mark.parametrize("how", ["wobble", "planes"])
def test_pullback_inputs_hit_and_miss_the_clip(how):
    """The positions clip on some nodes and not on others, leave the domain
    on every face before the clip, and (planes) lie on lattice planes."""
    g, maps, fields, dims = _pullback_inputs(SHAPES[0], "uvw", 3, how)
    extent = interp_fast._pullback_extent(maps, fields, dims, g.shape_c)
    for d in dims:
        pos = interp_fast.pullback_positions(maps, d, g.h, g.shape_c, extent)
        for p, n in zip(pos, g.shape_c):
            hit = (p < 1.0) | (p > n - 1.0)
            assert 0.0 < float(hit.float().mean()) < 1.0
            assert bool((p < 0).any()) and bool((p > n).any())
            if how == "planes":
                assert bool(((p * 4) == torch.floor(p * 4)).all())
                assert float((p == torch.floor(p)).float().mean()) > 0.1


def test_pullback_kind_order_groups_kinds():
    dims = [(0, 0, 0), (1, 0, 0), (0, 0, 0), (0, 0, 1)]
    assert interp_fast.pullback_kind_order(dims) == [0, 2, 1, 3]
    assert interp_fast.pullback_kind_order(dims[1:]) == [0, 1, 2]


@pytest.mark.parametrize("grid_n,shapes,ok", [
    ((256, 256, 256), [(257, 256, 256)] * 3 + [(256, 256, 256)], True),
    ((512, 512, 512), [(512, 512, 512)], True),
    ((1024, 1024, 1024), [(1024, 1024, 1024)], False),   # the map
    ((8, 8, 1), [(8, 8, 2)], True),                     # w: 2 along z
    ((8, 8, 1), [(8, 8, 1)], False),                    # 1 along z
])
def test_pullback_size_check(grid_n, shapes, ok):
    extent = tuple(max(s[a] for s in shapes) for a in range(3))
    if ok:
        interp_fast.pullback_check_sizes(grid_n, shapes, extent)
    else:
        with pytest.raises(ValueError):
            interp_fast.pullback_check_sizes(grid_n, shapes, extent)


def test_pullback_output_size_check():
    """830^3 fits the map and each field, but not 4 channels' output."""
    with pytest.raises(ValueError, match="outputs"):
        interp_fast.pullback_check_sizes((830,) * 3, [(831, 830, 830)] * 4,
                                         (831, 830, 830))


# ---------------------------------------------------------------------------
# minmax_sample
# ---------------------------------------------------------------------------


def _minmax_kernel(fields, px, py, pz, h, offs):
    """The kernel's schedule in its sample mode: (mn, mx, sample)."""
    extent = tuple(px.shape)
    _, nx, ny, nz = fields.shape
    i, j, k, idx = _threads(extent, _block("minmax_sample"))
    x, y, z = (p.reshape(-1)[idx] / h for p in (px, py, pz))
    shared = all(o == offs[0] for o in offs)
    outs = [[], [], []]
    for c in range(fields.shape[0]):
        if c == 0 or not shared:
            cx = _coord(x - offs[c][0], nx)
            cy = _coord(y - offs[c][1], ny)
            cz = _zpair(z - offs[c][2], nz)
        flat = fields[c].reshape(-1)
        (_, _, xa, xb), (_, _, ya, yb), (_, _, zl, top, bottom) = cx, cy, cz
        rows = [(xa * ny + ya) * nz + zl, (xb * ny + ya) * nz + zl,
                (xa * ny + yb) * nz + zl, (xb * ny + yb) * nz + zl]
        pair = [[flat[r + p] for r in rows] for p in (0, 1)]
        lo = [torch.minimum(torch.minimum(v[0], v[1]),
                            torch.minimum(v[2], v[3])) for v in pair]
        hi = [torch.maximum(torch.maximum(v[0], v[1]),
                            torch.maximum(v[2], v[3])) for v in pair]
        mn = torch.where(top, lo[1], torch.where(bottom, lo[0],
                                                 torch.minimum(*lo)))
        mx = torch.where(top, hi[1], torch.where(bottom, hi[0],
                                                 torch.maximum(*hi)))
        for q, v in enumerate((mn, mx, _trilerp(fields[c], cx, cy, cz))):
            outs[q].append(_scatter(v, idx, extent))
    return tuple(torch.stack(o) for o in outs)


def _minmax_inputs(shape, C, how, seed):
    """C smooth-free random fields on an h = 1/4 grid and positions on the
    cell lattice: "displaced" by up to 2.5 cells, "outside" stretched to
    reach 3 cells past every face, "planes" moved by whole and quarter
    cells from -3 to 3, so that g and floor(g) are exact lattice planes
    (also the last node and beyond)."""
    rng = np.random.default_rng(seed)
    h = 0.25
    fields = torch.from_numpy(rng.standard_normal((C,) + shape).astype(
        np.float32))
    lat = torch.meshgrid(*[torch.arange(n, dtype=torch.float32)
                           for n in shape], indexing="ij")
    if how == "displaced":
        pos = [(q + torch.from_numpy(rng.uniform(-2.5, 2.5, shape).astype(
            np.float32))) * h for q in lat]
    elif how == "outside":
        pos = [(q * ((n + 5.0) / (n - 1.0)) - 3.0) * h
               for q, n in zip(lat, shape)]
    else:
        pos = [(q + torch.from_numpy(rng.integers(-12, 13, shape) / 4.0)
                .float()) * h for q in lat]
    return fields, [p.contiguous() for p in pos], h


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("offs", [
    ((0.0, 0.0, 0.0),),
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
    ((-0.5, 0.0, 0.0), (-0.5, 0.0, 0.0)),
    ((0.0, 0.0, 0.0), (0.0, 0.0, -0.5)),
])
@pytest.mark.parametrize("how", ["displaced", "outside", "planes"])
def test_minmax_schedule_matches_plain(shape, offs, how):
    fields, pos, h = _minmax_inputs(shape, len(offs), how, len(offs))
    mn, mx, smp = _minmax_kernel(fields, *pos, h, offs)
    want = interp_fast.minmax_sample_plain(fields, *pos, h, offs,
                                           sample=True)
    _assert_bitwise(mn, want[0])
    _assert_bitwise(mx, want[1])
    _assert_bitwise(smp, want[2])
    _assert_bitwise(smp, interp_fast.trilerp_sample_plain(fields, *pos, h,
                                                          offs))


@pytest.mark.parametrize("how", ["outside", "planes"])
def test_minmax_inputs_reach_the_z_faces(how):
    """Both z face cases of the corner pair occur (floor(g) <= -1 and
    >= n - 1), beside the interior."""
    shape = SHAPES[0]
    _, pos, h = _minmax_inputs(shape, 1, how, 1)
    fl = torch.floor(pos[2] / h)
    assert bool((fl <= -1).any()) and bool((fl >= shape[2] - 1).any())
    assert bool(((fl >= 0) & (fl < shape[2] - 1)).any())


def test_minmax_sample_mode_on_cpu_is_plain():
    fields, pos, h = _minmax_inputs(SHAPES[0], 2, "displaced", 0)
    offs = ((0.0, 0.0, 0.0),) * 2
    before = interp_fast.minmax_sample.launches
    got = interp_fast.minmax_sample(fields, *pos, h, offs, sample=True)
    want = interp_fast.minmax_sample_plain(fields, *pos, h, offs, sample=True)
    assert len(got) == 3
    for a, b in zip(got, want):
        _assert_bitwise(a, b)
    assert len(interp_fast.minmax_sample(fields, *pos, h, offs)) == 2
    assert interp_fast.minmax_sample.launches == before


@pytest.mark.parametrize("field_shape,C,n_out,ok", [
    ((256, 256, 256), 2, 256 ** 3, True),
    ((512, 512, 512), 4, 2 ** 29, False),
    ((1024, 1024, 1024), 1, 8, True),
    ((1024, 1024, 1024), 2, 8, False),
    ((8, 8, 1), 1, 8, False),
])
def test_minmax_size_check(field_shape, C, n_out, ok):
    if ok:
        interp_fast.minmax_check_sizes(field_shape, C, n_out)
    else:
        with pytest.raises(ValueError):
            interp_fast.minmax_check_sizes(field_shape, C, n_out)


# ---------------------------------------------------------------------------
# the trace clamp: one minmax_sample call in its sample mode
# ---------------------------------------------------------------------------


def _trace_clamp_two_calls(grid, kind, srcs, fwds, backs, packed, dt):
    """The trace clamp as two calls: the min/max, then trilerp_sample of
    the same fields at the same positions for the fallback."""
    h = grid.h
    pos, ax = advect._cropped_positions(grid, kind)
    px, py, pz = pos * h
    vel1 = interp_fast.trilerp_sample_plain(packed, px, py, pz, h,
                                            interp.MAC_OFFS)
    mx_, my_, mz_ = (p - 0.5 * dt * v for p, v in zip((px, py, pz), vel1))
    vel2 = interp_fast.trilerp_sample_plain(packed, mx_, my_, mz_, h,
                                            interp.MAC_OFFS)
    bx, by, bz = (p - dt * v for p, v in zip((px, py, pz), vel2))
    stacked = torch.stack(list(srcs))
    offs = (grid.off_of(kind),) * len(srcs)
    mn, mx = interp_fast.minmax_sample_plain(stacked, bx, by, bz, h, offs)
    fallback = interp_fast.trilerp_sample_plain(stacked, bx, by, bz, h, offs)
    crop = tuple(slice(0, s) for s in px.shape)
    outs, fired = [], 0
    for c, (src, fwd, back) in enumerate(zip(srcs, fwds, backs)):
        dst = (fwd + 0.5 * (src - back))[crop]
        out = (dst < mn[c]) | (dst > mx[c])
        fired += int(out.sum())
        clamped = torch.where(out, fallback[c], dst)
        outs.append(advect._pad_plane(clamped, src, ax))
    return outs, fired


@pytest.mark.parametrize("kind", ["c", "w"])
def test_trace_clamp_is_the_two_call_composition(kind):
    rng = np.random.default_rng(3)
    g = Grid3D(*SHAPES[0], 0.25)

    def field(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32))

    u, v, w = (field(g.shape_of(kd), 1.5) for kd in "uvw")
    packed = interp.mac_pack_3d(u, v, w)
    shape = g.shape_of(kind)
    srcs = [field(shape, 1.0), field(shape, 50.0)]
    fwds = [s + field(shape, 0.3 * float(s.abs().max())) for s in srcs]
    backs = [s + field(shape, 0.3 * float(s.abs().max())) for s in srcs]
    got = advect._trace_clamp(g, kind, srcs, fwds, backs, packed, 0.35)
    want, fired = _trace_clamp_two_calls(g, kind, srcs, fwds, backs, packed,
                                         0.35)
    assert 0 < fired < len(srcs) * int(np.prod(g.shape_c))
    for a, b in zip(got, want):
        _assert_bitwise(a, b)
