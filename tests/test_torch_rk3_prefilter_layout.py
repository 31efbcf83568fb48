"""The schedules of the rk3_substep and volume_prefilter kernels, emulated
op for op on the CPU against the port's plain versions (no JAX involved).

``csrc/rk3_substep.cu`` floors, per stage and axis, the two coordinates g
and g + 1/2 once and lets u, v and w take their corners from those six
sets (u at (gx+1/2, gy, gz), v at (gx, gy+1/2, gz), w at (gx, gy, gz+1/2)),
clamping each to its own face's extent. Along z it loads the corner pair
(lo, lo + 1), lo = clamp(floor(g), 0, n - 2), and where the plain
version's two clamped corners coincide takes that node's lerped value for
both after the x and y lerps. Its lattice mode forms each node's start
coordinate as (float)i - 0.5f*dim. Both are emulated here and must equal
``rk3_substep_plain`` and ``advect._cropped_positions`` bit for bit, on
positions on cell faces and half-integers, at the clamp bounds and up to 3
cells outside the domain.

``csrc/volume_prefilter.cu`` marches a (k, j) tile with a one-cell halo
along i over segments of planes, z pass on the halo rows, y pass per node,
a 3-deep register ring for the x pass, prefetching the next plane. Its
schedule (with the shipped tile and segment read from the source, and
small ones) must equal ``volume_prefilter_plain`` bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core.grids import Grid3D
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from tests import torch_threads  # noqa: F401 (one CPU torch thread)

CSRC = Path(interp_fast.__file__).resolve().parent.parent / "csrc"
NI, NJ, NK = 12, 20, 16


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_bitwise(got, want):
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _faces(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((scale * rng.standard_normal(s)).astype(
        np.float32)) for s in ((NI + 1, NJ, NK), (NI, NJ + 1, NK),
                               (NI, NJ, NK + 1))]


# ---------------------------------------------------------------------------
# rk3_substep: six shared floor/weight sets a stage
# ---------------------------------------------------------------------------


def _coord(g, n):
    """The kernel's coord() (x and y): fraction, 1 - f, and the corner
    nodes floor(g) and floor(g) + 1 clamped in float to [0, n - 1]."""
    fl = torch.floor(g)
    f = g - fl
    return (f, 1.0 - f, fl.clamp(0.0, float(n - 1)).long(),
            (fl + 1.0).clamp(0.0, float(n - 1)).long())


def _zpair(g, n):
    """The kernel's zpair(): fraction, 1 - f, the pair's first node
    clamp(floor(g), 0, n - 2), and whether both clamped corners sit at the
    pair's top node or at its bottom node."""
    fl = torch.floor(g)
    f = g - fl
    return (f, 1.0 - f, fl.clamp(0.0, float(n - 2)).long(), fl >= n - 1,
            ~(fl >= 0))


def _trilerp(field, x, y, z):
    """The kernel's trilerp() from per-axis coordinate sets."""
    _, ny, nz = field.shape
    flat = field.reshape(-1)
    (fx, wx, xa, xb), (fy, wy, ya, yb), (fz, wz, zl, top, bottom) = x, y, z
    sx, sy = ny * nz, nz

    def at(i, j, k):
        return flat[i * sx + j * sy + k]

    c00 = wx * at(xa, ya, zl) + fx * at(xb, ya, zl)
    c10 = wx * at(xa, yb, zl) + fx * at(xb, yb, zl)
    c01 = wx * at(xa, ya, zl + 1) + fx * at(xb, ya, zl + 1)
    c11 = wx * at(xa, yb, zl + 1) + fx * at(xb, yb, zl + 1)
    l0 = wy * c00 + fy * c10
    l1 = wy * c01 + fy * c11
    c0 = torch.where(top, l1, l0)
    c1 = torch.where(bottom, l0, l1)
    return wz * c0 + fz * c1


def _mac_shared(u, v, w, gx, gy, gz):
    ni, nj, nk = v.shape[0], u.shape[1], u.shape[2]
    x0, x1 = _coord(gx, ni), _coord(gx + 0.5, ni + 1)
    y0, y1 = _coord(gy, nj), _coord(gy + 0.5, nj + 1)
    z0, z1 = _zpair(gz, nk), _zpair(gz + 0.5, nk + 1)
    return (_trilerp(u, x1, y0, z0), _trilerp(v, x0, y1, z0),
            _trilerp(w, x0, y0, z1))


def _rk3_shared(u, v, w, pos, sh, clamp):
    a, b, c1, c2, c3 = interp_fast.rk3_coefficients(sh)
    gx, gy, gz = pos[0], pos[1], pos[2]
    u1, v1, w1 = _mac_shared(u, v, w, gx, gy, gz)
    u2, v2, w2 = _mac_shared(u, v, w, gx + a * u1, gy + a * v1, gz + a * w1)
    u3, v3, w3 = _mac_shared(u, v, w, gx + b * u2, gy + b * v2, gz + b * w2)
    out = [gx + c1 * u1 + c2 * u2 + c3 * u3, gy + c1 * v1 + c2 * v2 + c3 * v3,
           gz + c1 * w1 + c2 * w2 + c3 * w3]
    return torch.stack([torch.minimum(torch.maximum(o, torch.tensor(lo)),
                                      torch.tensor(hi))
                        for o, lo, hi in zip(out, clamp[0::2], clamp[1::2])])


def _adversarial_axis(n, rng, size):
    """float32 coordinates on one axis: half-integers from -3 to n + 3
    (cell centres and faces), the clamp bounds 1 and n - 1, one ulp either
    side of each, and random values in [-3, n + 3]."""
    half = (np.arange(-6, 2 * (n + 3) + 1) / 2).astype(np.float32)
    bounds = np.array([1.0, n - 1.0, 0.0, n, n - 0.5], dtype=np.float32)
    base = np.concatenate([half, bounds])
    pool = np.concatenate([base, np.nextafter(base, np.float32(-np.inf)),
                           np.nextafter(base, np.float32(np.inf)),
                           rng.uniform(-3.0, n + 3.0, 256)]).astype(np.float32)
    return torch.from_numpy(rng.choice(pool, size))


def _adversarial_positions(seed, size=6000):
    rng = np.random.default_rng(seed)
    return torch.stack([_adversarial_axis(n, rng, size)
                        for n in (NI, NJ, NK)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_mac_velocity_matches_plain(seed):
    """One stage: the six shared sets against three independent trilerps,
    on adversarial coordinates where floor(g) and floor(g + 1/2) differ."""
    u, v, w = _faces(10 + seed)
    pos = _adversarial_positions(seed)
    got = _mac_shared(u, v, w, *pos)
    want = interp_fast.interp.mac_velocity_grid(u, v, w, *pos)
    for g_, w_ in zip(got, want):
        _assert_bitwise(g_, w_)
    # the coordinates do split: g and g + 1/2 floor apart on some of them,
    # and along z both pair edges are taken
    x, z = pos[0], pos[2]
    assert bool((torch.floor(x) != torch.floor(x + 0.5)).any())
    assert bool((torch.floor(x) == torch.floor(x + 0.5)).any())
    assert bool((torch.floor(z) >= NK - 1).any())
    assert bool((torch.floor(z + 0.5) >= NK).any())
    assert bool((torch.floor(z) < 0).any())


@pytest.mark.parametrize("sh", [0.9, -0.9, 2.5, -3.0])
@pytest.mark.parametrize("velocity", ["random", "half-integers"])
def test_shared_rk3_substep_matches_plain(sh, velocity):
    """A whole substep: stage positions g + a*k1 and g + b*k2 from
    adversarial starts; with half-integer faces and |sh| a multiple of 1/2
    many stage positions land on half-integers themselves."""
    if velocity == "random":
        u, v, w = _faces(20, scale=1.5)
    else:
        rng = np.random.default_rng(21)
        u, v, w = [torch.from_numpy(rng.integers(-4, 5, f.shape).astype(
            np.float32) / 2) for f in _faces(0)]
    pos = _adversarial_positions(int(abs(sh) * 10))
    clamp = (1.0, NI - 1.0, 1.0, NJ - 1.0, 1.0, NK - 1.0)
    want = interp_fast.rk3_substep_plain(u, v, w, pos, sh, clamp)
    _assert_bitwise(_rk3_shared(u, v, w, pos, sh, clamp), want)
    # the CPU wrapper is the plain version
    _assert_bitwise(interp_fast.rk3_substep(u, v, w, pos, sh, clamp), want)


# ---------------------------------------------------------------------------
# rk3_substep: the lattice start
# ---------------------------------------------------------------------------


def _lattice_in_kernel(shape, dim):
    """(float)i - 0.5f * dim for each node index, as the kernel forms it."""
    half = torch.tensor(0.5, dtype=torch.float32)
    axes = [torch.arange(n, dtype=torch.int32).to(torch.float32)
            - half * torch.tensor(float(d), dtype=torch.float32)
            for n, d in zip(shape, dim)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


@pytest.mark.parametrize("kind", ["c", "u", "v", "w"])
def test_lattice_start_matches_cropped_positions(kind):
    g = Grid3D(NI, NJ, NK, 0.1)
    want, _ = advect._cropped_positions(g, kind)
    _assert_bitwise(_lattice_in_kernel(g.shape_c, g.dim_of(kind)), want)
    _assert_bitwise(interp_fast.lattice_positions(g.shape_c, g.dim_of(kind)),
                    want)


@pytest.mark.parametrize("kind", ["c", "u", "v", "w"])
def test_rk3_substep_lattice_matches_plain(kind):
    g = Grid3D(NI, NJ, NK, 0.1)
    u, v, w = _faces(30, scale=2.0)
    clamp = advect._clamp_grid(g)
    pos, _ = advect._cropped_positions(g, kind)
    for sh in (0.7, -1.3):
        want = interp_fast.rk3_substep_plain(u, v, w, pos, sh, clamp)
        _assert_bitwise(interp_fast.rk3_substep_lattice(
            u, v, w, g.dim_of(kind), sh, clamp), want)
        _assert_bitwise(_rk3_shared(u, v, w, _lattice_in_kernel(
            g.shape_c, g.dim_of(kind)), sh, clamp), want)


def test_rk3_substep_lattice_cpu_takes_the_plain_path():
    """On CPU tensors the lattice entry computes the plain version and
    launches nothing."""
    u, v, w = _faces(50)
    before = interp_fast.rk3_substep_lattice.launches
    out = interp_fast.rk3_substep_lattice(u, v, w, (0, 1, 0), 0.5,
                                          (1.0, NI - 1.0, 1.0, NJ - 1.0,
                                           1.0, NK - 1.0))
    assert out.shape == (3, NI, NJ, NK) and out.device.type == "cpu"
    assert interp_fast.rk3_substep_lattice.launches == before


@pytest.mark.parametrize("kind", ["c", "u"])
@pytest.mark.parametrize("dt", [0.35, -0.35, 0.0])
def test_trace_from_identity_matches_lattice_march(kind, dt):
    """trace_3d(from_identity=True) equals the march of rk3_substep from
    the materialized lattice, substep for substep (dt = 0: no substep)."""
    g = Grid3D(NI, NJ, NK, 0.1)
    u, v, w = _faces(40, scale=0.2)
    cfldt = 0.1
    got = advect.trace_3d(g, u, v, w, cfldt, dt, None, None, None,
                          from_identity=True, kind=kind)
    pos, _ = advect._cropped_positions(g, kind)
    sign = 1.0 if dt >= 0 else -1.0
    subs = advect.substeps(cfldt, abs(dt))
    assert len(subs) == (0 if dt == 0 else 4)
    for sub in subs:
        pos = interp_fast.rk3_substep(u, v, w, pos, advect._sh(sub, g.h, sign),
                                      advect._clamp_grid(g))
    for a, b in zip(got, (pos[0] * g.h, pos[1] * g.h, pos[2] * g.h)):
        _assert_bitwise(a, b)


# ---------------------------------------------------------------------------
# 32-bit offsets: the wrappers' checks
# ---------------------------------------------------------------------------


def test_check_int32():
    interp_fast.check_int32("k", a=2 ** 31 - 1, b=0)
    with pytest.raises(ValueError, match="2\\^31"):
        interp_fast.check_int32("k", a=5, b=2 ** 31)


@pytest.mark.parametrize("cells,n", [
    ((1280, 1280, 1280), 2 ** 31 - 1), ((1280, 1280, 1280), 2 ** 31),
    ((1290, 1290, 1290), 1000), ((1, 1, 2 ** 30 - 1), 1000),
    ((1, 1, 2 ** 30), 1000), ((2 ** 30 - 1, 1, 2), 1000),
    ((2 ** 30, 1, 2), 1000), ((1, 2 ** 30, 2), 1000), ((16, 16, 2), 1000),
    ((16, 16, 1), 1000)])
def test_rk3_size_check(cells, n):
    """nk >= 2 (the z corner pairs), and every face (u: ni+1, v: nj+1, w:
    nk+1 along its axis) and the positions each below 2^31 values."""
    ni, nj, nk = cells
    ok = nk >= 2 and max((ni + 1) * nj * nk, ni * (nj + 1) * nk,
                         ni * nj * (nk + 1), n) < 2 ** 31
    if ok:
        interp_fast.rk3_check_sizes(cells, n)
    else:
        with pytest.raises(ValueError):
            interp_fast.rk3_check_sizes(cells, n)


@pytest.mark.parametrize("shape,ok", [
    ((1, 1024, 1024, 2047), True), ((2, 1024, 1024, 1024), False),
    ((4, 512, 512, 2047), True), ((4, 513, 512, 2048), False)])
def test_prefilter_int32_check(shape, ok):
    if ok:
        interp_fast.prefilter_check_int32(shape)
    else:
        with pytest.raises(ValueError):
            interp_fast.prefilter_check_int32(shape)


# ---------------------------------------------------------------------------
# volume_prefilter: the 2.5D march
# ---------------------------------------------------------------------------


def _shipped_schedule():
    src = (CSRC / "volume_prefilter.cu").read_text()
    m = re.search(r"constexpr int kTileK = (\d+), kTileJ = (\d+), "
                  r"kSeg = (\d+);", src)
    return tuple(int(x) for x in m.groups())


def _smooth3(lo, mid, hi):
    return (0.125 * lo + 0.75 * mid) + 0.125 * hi


def _march(fields, tile_k, tile_j, seg):
    """The kernel's schedule: per channel, i segment and (j, k) tile, the
    clamped slab of each visited plane taken from the buffer the previous
    plane prefetched, z pass on the slab's rows, y pass per node, the ring
    of the last three y values and two centre values, an output per plane
    once the ring holds its two neighbours."""
    C, nx, ny, nz = fields.shape
    out = torch.full_like(fields, float("nan"))
    for c in range(C):
        f = fields[c]
        for i0 in range(0, nx, seg):
            i1 = min(i0 + seg, nx)
            last_plane = min(i1, nx - 1)
            for j0 in range(0, ny, tile_j):
                for k0 in range(0, nz, tile_k):
                    jj = (j0 - 1 + torch.arange(tile_j + 2)).clamp(0, ny - 1)
                    kk = (k0 - 1 + torch.arange(tile_k + 2)).clamp(0, nz - 1)
                    nj_out = min(tile_j, ny - j0)
                    nk_out = min(tile_k, nz - k0)
                    buf = max(i0 - 1, 0)            # the plane in flight
                    ring = [None, None, None]
                    cen = [None, None]
                    last, t, centre = -1, None, None
                    for p in range(i0 - 1, i1 + 1):
                        cur = min(max(p, 0), nx - 1)
                        if cur != last:
                            slab = f[buf][jj][:, kk]
                            if cur < last_plane:
                                buf = cur + 1
                            zp = _smooth3(slab[:, :-2], slab[:, 1:-1],
                                          slab[:, 2:])
                            centre = slab[1:-1, 1:-1]
                            t = _smooth3(zp[:-2], zp[1:-1], zp[2:])
                            last = cur
                        ring = ring[1:] + [t]
                        cen = cen[1:] + [centre]
                        if p > i0:
                            val = 0.5 * cen[0] + 0.5 * _smooth3(*ring)
                            out[c, p - 1, j0:j0 + nj_out,
                                k0:k0 + nk_out] = val[:nj_out, :nk_out]
    return out


@pytest.mark.parametrize("shape", [
    (2, 13, 10, 17), (1, 1, 10, 17), (1, 2, 10, 17), (1, 13, 1, 17),
    (1, 13, 2, 17), (1, 13, 10, 1), (1, 13, 10, 2), (2, 1, 2, 1)])
@pytest.mark.parametrize("schedule", ["5x4 tile, 3 planes", "shipped"])
def test_prefilter_march_matches_plain(shape, schedule):
    rng = np.random.default_rng(sum(shape))
    fields = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    tile_k, tile_j, seg = ((5, 4, 3) if schedule != "shipped"
                           else _shipped_schedule())
    got = _march(fields, tile_k, tile_j, seg)
    _assert_bitwise(got, interp_fast.volume_prefilter_plain(fields))


def test_prefilter_march_segments_and_tiles_split():
    """The 5x4 tile and 3-plane segments split 13x10x17 into ragged
    segments and tiles, so the halo reload and the edge planes are both
    exercised; the shipped tile fills the card with many blocks at 256^3."""
    assert 13 % 3 and 17 % 5 and 10 % 4
    tile_k, tile_j, seg = _shipped_schedule()
    assert tile_k % 32 == 0 and tile_k * tile_j <= 1024 and seg >= 2
