"""The slab modes of the trilerp_sample, rk3_substep and dmc_substep
kernels (the sharded path), their index arithmetic emulated op for op on
the CPU against the port's plain versions, bit for bit (no JAX involved).

In the slab mode an array holds the planes z0 .. z0 + n - 1 of a grid of
N planes; coordinates stay global. ``gfs::slab_node`` clamps a z node to
[0, N - 1] and only then subtracts the integer origin z0, clamping to the
slab and flagging a node that left it; ``gfs::zpair_slab`` loads the two
clamped corners as a pair of the slab (the pair's top or bottom node for
both where they coincide); ``gfs::axis3_slab`` takes the dual stencil's
nodes B, B + 1, B + 2 to the slab and flags B + 2 only where a coordinate
uses it. The DMC kernel addresses its output, face and map slabs with
three origins; the lattice modes form the global plane k + z0. Each is
emulated here on 13x9x11 and 20x17x24 with origin 0 and others, from
positions up to 3 cells outside the domain (so that corners leave the
slab on both sides), and must equal the plain version, value and count;
where no corner left the slab, the whole-grid plain version too.
"""

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core.grids import Grid3D
from gpufluidsimulation_tpu_torch.ops import interp_fast
from tests.test_torch_dmc_vol9_layout import _axis3, _dmc_disp, _stencil9
from tests.test_torch_rk3_prefilter_layout import (_assert_bitwise, _coord,
                                                   _trilerp, _zpair)

SHAPES = ((13, 9, 11), (20, 17, 24))
# (z0, planes) of a slab of each grid's z extent: origin 0 with the whole
# extent, origin 0 with a part, and slabs inside and at the top
SLABS = {11: ((0, 11), (0, 5), (3, 5), (6, 5)),
         24: ((0, 24), (0, 8), (5, 7), (16, 8))}
CASES = [(shape, slab) for shape in SHAPES for slab in SLABS[shape[2]]]
IDS = [f"{'x'.join(map(str, s))}-z0={z}-n={n}" for s, (z, n) in CASES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
        np.float32))


def _global_coords(shape, count, seed):
    """Grid coordinates up to 3 cells outside the domain on every axis,
    with half-integers and their neighbouring floats among them."""
    rng = np.random.default_rng(seed)
    axes = []
    for n in shape:
        half = (np.arange(-6, 2 * (n + 3) + 1) / 2).astype(np.float32)
        pool = np.concatenate([half, np.nextafter(half, np.float32(-1e9)),
                               np.nextafter(half, np.float32(1e9)),
                               rng.uniform(-3.0, n + 3.0, 256)])
        axes.append(torch.from_numpy(rng.choice(pool, count).astype(
            np.float32)))
    return torch.stack(axes)


# ---------------------------------------------------------------------------
# the kernels' slab helpers
# ---------------------------------------------------------------------------


def _clamp_node(fl, n):
    """gfs::clamp_node: the clamped node of an integral float."""
    return fl.clamp(0.0, float(n - 1)).long()


def _slab_node(node, z0, n):
    """gfs::slab_node: node - z0 clamped to the slab, and whether it
    moved."""
    loc = node - z0
    c = loc.clamp(0, n - 1)
    return c, c != loc


def _zpair_slab(g, N, z0, n):
    """gfs::zpair_slab, as _zpair's tuple, and the outside flag."""
    fl = torch.floor(g)
    f = g - fl
    la, oa = _slab_node(_clamp_node(fl, N), z0, n)
    lb, ob = _slab_node(_clamp_node(fl + 1.0, N), z0, n)
    top = la >= n - 1
    bottom = (la == lb) & ~top
    lo = torch.where(top, n - 2, la)
    return (f, 1.0 - f, lo, top, bottom), oa | ob


def _axis3_slab(c, N, z0, n):
    """gfs::axis3_slab: _axis3's sets with the nodes taken to the slab."""
    base = torch.floor(c[0])
    f = [cq - torch.floor(cq) for cq in c]
    up = [torch.floor(cq) != base for cq in c]
    node, past = zip(*[_slab_node(_clamp_node(base + q, N), z0, n)
                       for q in range(3)])
    out = past[0] | past[1] | (past[2] & (up[1] | up[2]))
    return (f, up, list(node)), out


# ---------------------------------------------------------------------------
# trilerp_sample
# ---------------------------------------------------------------------------


def _trilerp32_slab(f, gx, gy, gz, z0, N):
    """trilerp32<kSlab>: eight loads of clamped corners, z taken to the
    slab."""
    nx, ny, nz = f.shape
    i0f, j0f, k0f = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    fx, fy, fz = gx - i0f, gy - j0f, gz - k0f
    ia, ib = _clamp_node(i0f, nx), _clamp_node(i0f + 1.0, nx)
    ja, jb = _clamp_node(j0f, ny), _clamp_node(j0f + 1.0, ny)
    ka, oa = _slab_node(_clamp_node(k0f, N), z0, nz)
    kb, ob = _slab_node(_clamp_node(k0f + 1.0, N), z0, nz)
    flat = f.reshape(-1)

    def at(i, j, k):
        return flat[(i * ny + j) * nz + k]

    c00 = (1.0 - fx) * at(ia, ja, ka) + fx * at(ib, ja, ka)
    c10 = (1.0 - fx) * at(ia, jb, ka) + fx * at(ib, jb, ka)
    c01 = (1.0 - fx) * at(ia, ja, kb) + fx * at(ib, ja, kb)
    c11 = (1.0 - fx) * at(ia, jb, kb) + fx * at(ib, jb, kb)
    c0 = (1.0 - fy) * c00 + fy * c10
    c1 = (1.0 - fy) * c01 + fy * c11
    return (1.0 - fz) * c0 + fz * c1, oa | ob


def _trilerp_slab_kernel(fields, g, offs, dual, z0, N):
    """The slab mode of the trilerp_sample kernel over C channels; the
    outside flag is or-ed over the channels."""
    outs, outside = [], torch.zeros(g.shape[1:], dtype=torch.bool)
    nx, ny, nz = fields.shape[1:]
    for c in range(fields.shape[0]):
        gx, gy, gz = (g[a] - offs[c][a] for a in range(3))
        if dual:
            ax = _axis3([gx - 0.25, gx, gx + 0.25], nx)
            ay = _axis3([gy - 0.25, gy, gy + 0.25], ny)
            az, out = _axis3_slab([gz - 0.25, gz, gz + 0.25], N, z0, nz)
            s = _stencil9(fields[c], ax, ay, az)
            acc = s[0]
            for q in range(1, 8):
                acc = acc + s[q]
            val = 0.5 * (acc / 8.0) + 0.5 * s[8]
        else:
            val, out = _trilerp32_slab(fields[c], gx, gy, gz, z0, N)
        outs.append(val)
        outside = outside | out
    return torch.stack(outs), outside


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "plain"])
@pytest.mark.parametrize("shape,slab", CASES, ids=IDS)
def test_trilerp_slab_matches_plain(shape, slab, dual):
    z0, n = slab
    h = 0.05
    whole = _rand((2,) + shape, 1)
    fields = whole[..., z0:z0 + n].contiguous()
    offs = ((0.0, 0.0, 0.0), (0.5, 0.0, -0.5))
    g = _global_coords(shape, 4000, 2)
    pos = [(g[a] * h) for a in range(3)]
    x = torch.stack([interp_fast.interp.div_scalar(p, h) for p in pos])
    want_val, want_out = _trilerp_slab_kernel(fields, x, offs, dual, z0,
                                              shape[2])
    count = torch.zeros(1, dtype=torch.int32)
    got = interp_fast.trilerp_sample(
        fields, *pos, h, offs, dual=dual,
        slab=interp_fast.Slab(nz=shape[2], src=z0), overflow=count)
    _assert_bitwise(got, want_val)
    assert int(count) == int(want_out.sum())
    # corners left the slab on both sides, except with the whole extent
    assert bool(want_out.any()) == (n < shape[2])
    # where none did, the slab gives the whole grid's bits
    full = interp_fast.trilerp_sample(whole, *pos, h, offs, dual=dual)
    inside = ~want_out
    _assert_bitwise(got[:, inside], full[:, inside])


def test_zpair_slab_with_the_whole_extent_is_zpair():
    for n in (2, 11, 24):
        g = _global_coords((n,), 3000, n)[0]
        (f, w, lo, top, bottom), out = _zpair_slab(g, n, 0, n)
        f2, w2, lo2, top2, bottom2 = _zpair(g, n)
        assert not bool(out.any())
        for a, b in ((f, f2), (w, w2)):
            _assert_bitwise(a, b)
        assert torch.equal(lo, lo2) and torch.equal(top, top2)
        assert torch.equal(bottom, bottom2)


# ---------------------------------------------------------------------------
# rk3_substep
# ---------------------------------------------------------------------------


def _faces(shape, seed, scale=0.3):
    ni, nj, nk = shape
    return [_rand(s, seed + q, scale) for q, s in enumerate(
        ((ni + 1, nj, nk), (ni, nj + 1, nk), (ni, nj, nk + 1)))]


def _face_slabs(u, v, w, z0, n):
    return (u[..., z0:z0 + n].contiguous(), v[..., z0:z0 + n].contiguous(),
            w[..., z0:z0 + n + 1].contiguous())


def _mac_slab(u, v, w, gx, gy, gz, N, z0):
    """rk3's mac_velocity<kSlab>: x and y sets as on the whole grid, the z
    pairs of the slab, u and v against N cells, w against N + 1 faces."""
    ni, nj, nk = v.shape[0], u.shape[1], u.shape[2]
    x0, x1 = _coord(gx, ni), _coord(gx + 0.5, ni + 1)
    y0, y1 = _coord(gy, nj), _coord(gy + 0.5, nj + 1)
    z0_, o0 = _zpair_slab(gz, N, z0, nk)
    z1_, o1 = _zpair_slab(gz + 0.5, N + 1, z0, nk + 1)
    return (_trilerp(u, x1, y0, z0_), _trilerp(v, x0, y1, z0_),
            _trilerp(w, x0, y0, z1_)), o0 | o1


def _rk3_slab_kernel(u, v, w, pos, sh, clamp, N, z0):
    a, b, c1, c2, c3 = interp_fast.rk3_coefficients(sh)
    gx, gy, gz = pos[0], pos[1], pos[2]
    (u1, v1, w1), o1 = _mac_slab(u, v, w, gx, gy, gz, N, z0)
    (u2, v2, w2), o2 = _mac_slab(u, v, w, gx + a * u1, gy + a * v1,
                                 gz + a * w1, N, z0)
    (u3, v3, w3), o3 = _mac_slab(u, v, w, gx + b * u2, gy + b * v2,
                                 gz + b * w2, N, z0)
    out = [gx + c1 * u1 + c2 * u2 + c3 * u3, gy + c1 * v1 + c2 * v2 + c3 * v3,
           gz + c1 * w1 + c2 * w2 + c3 * w3]
    return torch.stack([torch.minimum(torch.maximum(o, torch.tensor(lo)),
                                      torch.tensor(hi))
                        for o, lo, hi in zip(out, clamp[0::2], clamp[1::2])]
                       ), o1 | o2 | o3


@pytest.mark.parametrize("shape,slab", CASES, ids=IDS)
def test_rk3_slab_matches_plain(shape, slab):
    z0, n = slab
    if n < 2:
        pytest.skip("the kernel loads z pairs")
    u, v, w = _faces(shape, 3)
    fu, fv, fw = _face_slabs(u, v, w, z0, n)
    pos = _global_coords(shape, 4000, 4)
    clamp = (1.0, shape[0] - 1.0, 1.0, shape[1] - 1.0, 1.0, shape[2] - 1.0)
    sh = 2.5
    want, out = _rk3_slab_kernel(fu, fv, fw, pos, sh, clamp, shape[2], z0)
    count = torch.zeros(1, dtype=torch.int32)
    got = interp_fast.rk3_substep(fu, fv, fw, pos, sh, clamp,
                                  interp_fast.Slab(nz=shape[2], src=z0),
                                  count)
    _assert_bitwise(got, want)
    assert int(count) == int(out.sum())
    assert bool(out.any()) == (n < shape[2])
    full = interp_fast.rk3_substep(u, v, w, pos, sh, clamp)
    _assert_bitwise(got[:, ~out], full[:, ~out])


@pytest.mark.parametrize("kind_dim", [(0, 0, 0), (1, 0, 0), (0, 0, 1)],
                         ids=["c", "u", "w"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rk3_lattice_slab_is_the_whole_lattice(shape, kind_dim):
    """The lattice mode's block from global plane z0 (the output slab)
    with faces slabs holding it and 3 planes beside: the kernel's start
    coordinate (float)(k + z0) - dim/2 and the slab's z pairs, against
    the plain version and the whole-grid lattice mode's planes."""
    u, v, w = _faces(shape, 5, 0.1)
    nk = shape[2]
    clamp = (1.0, shape[0] - 1.0, 1.0, shape[1] - 1.0, 1.0, nk - 1.0)
    sh = 1.5
    full = interp_fast.rk3_substep_lattice(u, v, w, kind_dim, sh, clamp)
    for oz, nz_out in ((0, 4), (4, 3), (nk - 4, 4)):
        src = max(oz - 3, 0)
        n = min(oz + nz_out + 3, nk) - src
        fu, fv, fw = _face_slabs(u, v, w, src, n)
        ar = [torch.arange(m, dtype=torch.float32) for m in shape[:2]]
        kz = torch.arange(oz, oz + nz_out).to(torch.float32)
        start = torch.stack(torch.meshgrid(
            ar[0] - 0.5 * kind_dim[0], ar[1] - 0.5 * kind_dim[1],
            kz - 0.5 * kind_dim[2], indexing="ij"))
        want, out = _rk3_slab_kernel(fu, fv, fw, start, sh, clamp, nk, src)
        count = torch.zeros(1, dtype=torch.int32)
        got = interp_fast.rk3_substep_lattice(
            fu, fv, fw, kind_dim, sh, clamp,
            interp_fast.Slab(nz=nk, src=src, out=oz, out_nz=nz_out), count)
        _assert_bitwise(got, want)
        assert int(count) == int(out.sum()) == 0
        _assert_bitwise(got, full[..., oz:oz + nz_out])


# ---------------------------------------------------------------------------
# dmc_substep
# ---------------------------------------------------------------------------


def _dmc_slab_kernel(u, v, w, maps, sh, thresh, N, oz, nko, vz, mz, h=None):
    """dmc_substep_kernel<kLattice, true>: cell (i, j, k) of the output is
    global plane kg = k + oz; the band test uses kg; the faces are read at
    iv = (i nj + j) nkv + kg - vz and the strides' offsets, unclamped;
    the map (displaced mode) at kg - disp through the slab z pair with
    origin mz, outside the band copied from plane kg - mz. With `h` the
    lattice mode: (float)kg * h."""
    ni, nj, nkv = v.shape[0], u.shape[1], u.shape[2]
    i, j, k = torch.meshgrid(torch.arange(ni), torch.arange(nj),
                             torch.arange(nko), indexing="ij")
    kg = k + oz
    band = ((i >= 2) & (i <= ni - 3) & (j >= 2) & (j <= nj - 3)
            & (kg >= 2) & (kg <= N - 3))
    iv = (i * nj + j) * nkv + (kg - vz)
    su, sv, sw = nj * nkv, (nj + 1) * nkv, nj * (nkv + 1)
    ov, ow = iv + i * nkv, iv + i * nj + j
    uf, vf, wf = u.reshape(-1), v.reshape(-1), w.reshape(-1)

    def at(f, o):
        return f[torch.where(band, o, 0)]

    vu = 0.5 * (at(uf, iv) + at(uf, iv + su))
    vv = 0.5 * (at(vf, ov) + at(vf, ov + nkv))
    vw = 0.5 * (at(wf, ow) + at(wf, ow + 1))
    sx, sy, sz = vu > 0.0, vv > 0.0, vw > 0.0
    dy = torch.where(sy, -nkv, nkv)
    dyw = torch.where(sy, -(nkv + 1), nkv + 1)
    dz = torch.where(sz, -1, 1)
    tu1 = torch.where(sx, iv - su, iv + su) + dy + dz
    tv1 = torch.where(sx, ov - sv, ov + sv) + dy + dz
    tw1 = torch.where(sx, ow - sw, ow + sw) + dyw + dz
    disp = (_dmc_disp(vu, 0.5 * (at(uf, tu1) + at(uf, tu1 + su)), sx, sh,
                      thresh),
            _dmc_disp(vv, 0.5 * (at(vf, tv1) + at(vf, tv1 + nkv)), sy, sh,
                      thresh),
            _dmc_disp(vw, 0.5 * (at(wf, tw1) + at(wf, tw1 + 1)), sz, sh,
                      thresh))
    if h is not None:
        hf = float(np.float32(h))
        out = []
        for ax, (c, d, n) in enumerate(zip((i, j, kg), disp, (ni, nj, N))):
            p = c.to(torch.int32).to(torch.float32) * hf
            hi = float(np.float32((n - 1) * h))
            out.append(torch.where(band, (p - d * hf).clamp(0.0, hi), p))
        return torch.stack(out), torch.zeros_like(band)
    nkm = maps.shape[3]
    x = _coord(i.to(torch.float32) - disp[0], ni)
    y = _coord(j.to(torch.float32) - disp[1], nj)
    z, outside = _zpair_slab(kg.to(torch.float32) - disp[2], N, mz, nkm)
    own = maps[:, i, j, kg - mz]
    out = torch.stack([torch.where(band, _trilerp(maps[c], x, y, z), own[c])
                       for c in range(3)])
    return out, band & outside


def _dmc_slabs(nk):
    """(output origin, output planes): the bottom, a middle and the top."""
    return ((0, 4), (nk // 2 - 2, 5), (nk - 4, 4))


@pytest.mark.parametrize("sh", [0.8, -0.8, 3.0, -3.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dmc_slab_matches_plain(shape, sh):
    """The displaced mode on the output slabs of ``_dmc_slabs``: faces
    holding the output planes and one beside (clipped to the grid), the
    map the output planes and 2 beside (the sharded march's halo); at 3
    cells a substep backward map corners leave the map slab and are
    counted."""
    h = 0.05
    u, v, w = _faces(shape, 7)
    nk = shape[2]
    g = Grid3D(*shape, h)
    lat = torch.stack(g.node_coords("c"))
    maps = lat + _rand((3,) + shape, 9, 0.5 * h)
    thresh = interp_fast.dmc_threshold(h)
    full = interp_fast.dmc_substep(u, v, w, maps, sh, thresh)
    counted = 0
    for oz, nko in _dmc_slabs(nk):
        vz = max(oz - 1, 0)
        fu, fv, fw = _face_slabs(u, v, w, vz, min(oz + nko + 1, nk) - vz)
        mz = oz - 2
        idx = torch.arange(mz, oz + nko + 2).clamp(0, nk - 1)
        mslab = maps[..., idx].contiguous()
        want, out = _dmc_slab_kernel(fu, fv, fw, mslab, sh, thresh, nk, oz,
                                     nko, vz, mz)
        count = torch.zeros(1, dtype=torch.int32)
        slab = interp_fast.Slab(nz=nk, src=vz, out=oz, out_nz=nko, map=mz)
        got = interp_fast.dmc_substep(fu, fv, fw, mslab, sh, thresh, slab,
                                      count)
        _assert_bitwise(got, want)
        assert int(count) == int(out.sum())
        counted += int(count)
        keep = ~out
        _assert_bitwise(got[:, keep], full[..., oz:oz + nko][:, keep])
        # the lattice mode of the same slab
        want, _ = _dmc_slab_kernel(fu, fv, fw, None, sh, thresh, nk, oz, nko,
                                   vz, None, h)
        got = interp_fast.dmc_substep_lattice(fu, fv, fw, sh, thresh, h,
                                              slab)
        _assert_bitwise(got, want)
        _assert_bitwise(got, interp_fast.dmc_substep_lattice(
            u, v, w, sh, thresh, h)[..., oz:oz + nko])
    # one cell a substep stays inside the map slab; 3 cells backward
    # (the exponential step grows with a negative substep) leave it
    if abs(sh) < 1.0:
        assert counted == 0
    if sh < -2.0:
        assert counted > 0


def test_slab_coverage_is_checked():
    """A DMC slab whose faces miss a plane beside the output, or whose map
    misses an output plane, and a lattice block outside the grid raise."""
    shape = (13, 9, 11)
    u, v, w = _faces(shape, 11)
    maps = torch.zeros((3,) + shape)
    good = interp_fast.Slab(nz=11, src=2, out=3, out_nz=4, map=1)
    fu, fv, fw = _face_slabs(u, v, w, 2, 6)
    interp_fast.dmc_substep(fu, fv, fw, maps[..., 1:9].contiguous(), 0.5,
                            1e-6, good)
    for slab, nkv, nkm in (
            (interp_fast.Slab(nz=11, src=3, out=3, out_nz=4, map=1), 6, 8),
            (interp_fast.Slab(nz=11, src=2, out=3, out_nz=4, map=1), 5, 8),
            (interp_fast.Slab(nz=11, src=2, out=3, out_nz=4, map=4), 6, 6)):
        fu, fv, fw = _face_slabs(u, v, w, slab.src, nkv)
        with pytest.raises(ValueError):
            interp_fast.dmc_substep(
                fu, fv, fw, maps[..., :nkm].contiguous(), 0.5, 1e-6, slab)
    fu, fv, fw = _face_slabs(u, v, w, 5, 6)
    with pytest.raises(ValueError):
        interp_fast.rk3_substep_lattice(
            fu, fv, fw, (0, 0, 0), 0.5, (1.0, 12.0) * 3,
            interp_fast.Slab(nz=11, src=5, out=9, out_nz=4))
    with pytest.raises(ValueError):
        interp_fast.rk3_substep(fu, fv, fw, torch.zeros(3, 4), 0.5,
                                (1.0, 12.0) * 3,
                                interp_fast.Slab(nz=10, src=5))
