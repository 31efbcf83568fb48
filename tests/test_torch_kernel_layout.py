"""The assumptions the two temporally and spatially blocked kernels rest on,
checked on the CPU with the port's plain versions (no JAX involved).

``csrc/trilerp_sample.cu`` evaluates the dual volume form from one clamped
3 x 3 x 3 neighbourhood per channel: per axis the coordinates g - 1/4, g
and g + 1/4 (float32 adds) floor to B = floor(g - 1/4) or B + 1. Its
selection of corners and its shared lerps are emulated here op for op on
adversarial positions and must equal ``trilerp_sample_plain`` bit for bit.

``csrc/jacobi_diffuse.cu`` runs s sweeps per launch on 32 x 32 (j, k)
regions marching along i: a region's central (32 - 2s)^2 columns are exact
after s sweeps because each sweep widens the dependence by one cell, and
the launches of a solve follow ``stencil_kernels.sweep_chunks``. Both the
halo-depth argument and the kernel's wavefront schedule (a small region,
segments of i, the region-edge hold) are emulated here and must equal
``jacobi_diffuse_plain`` bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.ops import interp_fast, stencil_kernels

NX, NY, NZ = 13, 10, 17


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _adversarial_g(n, seed):
    """float32 grid coordinates in [-3, n+3]: random, integral, integral
    +- 1/4, one ulp either side of those, and values near 256."""
    rng = np.random.default_rng(seed)
    ints = np.arange(-3, n + 4, dtype=np.float32)
    quarter = (np.arange(-12, 4 * (n + 3) + 1) / 4).astype(np.float32)
    near = np.concatenate([quarter, ints + np.float32(0.25),
                           ints - np.float32(0.25)]).astype(np.float32)
    ulps = np.concatenate([np.nextafter(near, np.float32(-np.inf)),
                           np.nextafter(near, np.float32(np.inf))])
    big = (np.float32(256) + (np.arange(-64, 65) / 64).astype(np.float32))
    big = np.concatenate([big, np.nextafter(big, np.float32(np.inf)),
                          np.nextafter(big, np.float32(-np.inf))])
    rand = rng.uniform(-3.0, n + 3.0, 4096).astype(np.float32)
    return np.concatenate([rand, ints, near, ulps, big]).astype(np.float32)


@pytest.mark.parametrize("n", [16, 256, 512])
def test_dual_stencil_floors_span_two_nodes(n):
    g = _adversarial_g(n, n)
    assert g.dtype == np.float32
    lo = np.floor(g + np.float32(-0.25))
    hi = np.floor(g + np.float32(0.25))
    mid = np.floor(g)
    assert lo.dtype == hi.dtype == np.float32
    assert ((hi - lo >= 0) & (hi - lo <= 1)).all()
    assert ((mid == lo) | (mid == lo + 1)).all()


# ---------------------------------------------------------------------------
# trilerp_sample: the 27-node neighbourhood against the plain version
# ---------------------------------------------------------------------------


def _axis(g, n):
    """The kernel's make_axis: fractions, 1 - f, clamped nodes B..B+2 and
    whether each coordinate takes its corners one node up."""
    coords = (g + (-0.25), g, g + 0.25)
    base = torch.floor(coords[0])
    f = [c - torch.floor(c) for c in coords]
    w = [1 - fq for fq in f]
    up = [torch.floor(c) != base for c in coords]
    node = [(base + q).clamp(0, n - 1).long() for q in range(3)]
    return f, w, up, node


def _dual_by_neighbourhood(field, gx, gy, gz):
    """The kernel's dual_sample, op for op: 27 loads, x lerps of every
    (j, k) node pair per x coordinate, y lerps per (x, y) pair used, one z
    lerp per sample, _VOL3 sum and blend."""
    nx, ny, nz = field.shape
    fx, wx, ux, ix = _axis(gx, nx)
    fy, wy, uy, iy = _axis(gy, ny)
    fz, wz, uz, iz = _axis(gz, nz)
    flat = field.reshape(-1)
    v = [[[flat[(ix[a] * ny + iy[b]) * nz + iz[c]] for c in range(3)]
          for b in range(3)] for a in range(3)]

    def pick(up, nodes):
        return (torch.where(up, nodes[1], nodes[0]),
                torch.where(up, nodes[2], nodes[1]))

    X = [[[None] * 3 for _ in range(3)] for _ in range(3)]
    for q in range(3):
        for b in range(3):
            for c in range(3):
                lo, hi = pick(ux[q], [v[a][b][c] for a in range(3)])
                X[q][b][c] = wx[q] * lo + fx[q] * hi
    pairs = ((0, 0), (0, 2), (2, 0), (2, 2), (1, 1))
    Y = []
    for qx, qy in pairs:
        row = []
        for c in range(3):
            lo, hi = pick(uy[qy], [X[qx][b][c] for b in range(3)])
            row.append(wy[qy] * lo + fy[qy] * hi)
        Y.append(row)

    def zl(p, qz):
        lo, hi = pick(uz[qz], Y[p])
        return wz[qz] * lo + fz[qz] * hi

    acc = zl(3, 2)
    for p, qz in ((3, 0), (2, 2), (2, 0), (1, 2), (1, 0), (0, 2), (0, 0)):
        acc = acc + zl(p, qz)
    return 0.5 * (acc / 8.0) + 0.5 * zl(4, 1)


def _positions(kind, shape, seed):
    """World positions (h = 1/4, so that p / h is exact) of grid
    coordinates on the quarter-cell lattice or random, up to 3 cells
    outside the field on every axis."""
    rng = np.random.default_rng(seed)
    n_pts = 6000
    out = []
    for n in shape:
        if kind == "quarter":
            g = rng.integers(-12, 4 * (n + 2) + 1, n_pts) / 4
        else:
            g = rng.uniform(-3.0, n + 2.0, n_pts)
        out.append(torch.from_numpy(g.astype(np.float32) * np.float32(0.25)))
    return out


@pytest.mark.parametrize("kind", ["quarter", "outside"])
@pytest.mark.parametrize("off", [(0.0, 0.0, 0.0), (-0.5, 0.0, 0.0),
                                 (0.0, 0.0, -0.5)])
def test_dual_neighbourhood_matches_plain(kind, off):
    field = _rand((NX, NY, NZ), 3)
    px, py, pz = _positions(kind, field.shape, 7)
    h = 0.25
    want = interp_fast.trilerp_sample_plain(field[None], px, py, pz, h,
                                            (off,), dual=True)[0]
    gx, gy, gz = (interp.div_scalar(p, h) - o for p, o in zip((px, py, pz),
                                                              off))
    got = _dual_by_neighbourhood(field, gx, gy, gz)
    assert torch.equal(got, want)
    g = torch.stack([gx, gy, gz])
    if kind == "quarter":
        # both the g - 1/4 and the g lattice are hit
        assert bool((g == torch.floor(g)).any())
        assert bool(((g - 0.25) == torch.floor(g - 0.25)).any())
    else:
        assert bool((g < -2.0).any()) and bool((gx > NX + 1.0).any())


# ---------------------------------------------------------------------------
# jacobi_diffuse: the halo depth and the wavefront schedule
# ---------------------------------------------------------------------------

COEF = 0.37


def _sub_box(face, core, shape):
    """A core box of edge `core` touching `face` ("x-", "x+", ...; "none"
    for one inside the array), as (lo, hi) per axis."""
    box = []
    for a, n in enumerate(shape):
        lo = (n - core) // 2
        if face[0] == "xyz"[a]:
            lo = 0 if face[1] == "-" else n - core
        box.append((lo, lo + core))
    return box


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("face", ["x-", "x+", "y-", "y+", "z-", "z+", "none"])
def test_jacobi_halo_depth(face, s):
    """s sweeps of a sub-box cut out with an s-cell halo (clipped to the
    array) equal the full array's s sweeps on the sub-box's core."""
    x = _rand((NX, NY, NZ), 11)
    b = _rand((NX, NY, NZ), 12)
    full = stencil_kernels.jacobi_diffuse_plain(x, b, s, COEF)
    core = _sub_box(face, 4, x.shape)
    cut = tuple(slice(max(lo - s, 0), min(hi + s, n))
                for (lo, hi), n in zip(core, x.shape))
    part = stencil_kernels.jacobi_diffuse_plain(x[cut], b[cut], s, COEF)
    inner = tuple(slice(lo - c.start, hi - c.start)
                  for (lo, hi), c in zip(core, cut))
    outer = tuple(slice(lo, hi) for lo, hi in core)
    assert torch.equal(part[inner], full[outer])
    if face != "none":
        axis = "xyz".index(face[0])
        edge = 0 if face[1] == "-" else x.shape[axis]
        assert edge in (core[axis][0], core[axis][1])


def _wavefront(x, b, s, coef, region, seg_len):
    """The kernel's schedule for one launch of s sweeps: per (j, k) region
    and i segment, level 0 loaded plane by plane, level t at plane m - t
    from level t-1's planes m-t-1 (register), m-t (shared plane, with the
    j and k neighbours) and m-t+1 (this step's), rows within t of the
    region's edge and its edge columns held, level s written on the
    central columns of the segment's planes."""
    nx, ny, nz = x.shape
    coef_f, denom_f = stencil_kernels._coefs(coef)
    coef_t = torch.tensor(coef_f, dtype=torch.float32)
    denom_t = torch.tensor(denom_f, dtype=torch.float32)
    R, T = region, region - 2 * s
    out = torch.full_like(x, float("nan"))
    rr = torch.arange(R)
    for i0 in range(0, nx, seg_len):
        i1 = min(i0 + seg_len, nx)
        for j0 in range(-s, ny - s, T):
            for k0 in range(-s, nz - s, T):
                j, k = j0 + rr, k0 + rr
                jc, kc = j.clamp(0, ny - 1), k.clamp(0, nz - 1)
                inside = (((j >= 0) & (j < ny))[:, None]
                          & ((k >= 0) & (k < nz))[None, :])
                upd_jk = (((j > 0) & (j < ny - 1) & (rr > 0) & (rr < R - 1))
                          [:, None]
                          & ((k > 0) & (k < nz - 1) & (rr > 0)
                             & (rr < R - 1))[None, :])
                plane = torch.zeros(s, R, R)
                prev = torch.zeros(s, R, R)
                for m in range(i0 - s, i1 + s):
                    nw = [torch.where(
                        inside & (0 <= m < nx),
                        x[min(max(m, 0), nx - 1)][jc][:, kc], 0.0)]
                    for t in range(1, s + 1):
                        i = m - t
                        cur = plane[t - 1]
                        pad = torch.nn.functional.pad(cur, (1, 1, 1, 1))
                        nb = (prev[t - 1] + nw[t - 1]
                              + pad[0:R, 1:R + 1] + pad[2:R + 2, 1:R + 1]
                              + pad[1:R + 1, 0:R] + pad[1:R + 1, 2:R + 2])
                        bi = b[min(max(i, 0), nx - 1)][jc][:, kc]
                        upd = (upd_jk & (0 < i < nx - 1)
                               & ((rr >= t) & (rr < R - t))[:, None])
                        nw.append(torch.where(
                            upd, (bi + coef_t * nb) / denom_t, cur))
                    prev = plane
                    plane = torch.stack(nw[:s])
                    io = m - s
                    if io >= i0:
                        jo = slice(s, s + min(T, ny - (j0 + s)))
                        ko = slice(s, s + min(T, nz - (k0 + s)))
                        out[io, j0 + s:j0 + s + (jo.stop - s),
                            k0 + s:k0 + s + (ko.stop - s)] = nw[s][jo, ko]
    return out


@pytest.mark.parametrize("s,region,seg_len", [(1, 6, 5), (2, 7, 4),
                                              (3, 9, 6), (4, 12, 13)])
def test_jacobi_wavefront_matches_plain(s, region, seg_len):
    x = _rand((NX, NY, NZ), 21)
    b = _rand((NX, NY, NZ), 22)
    want = stencil_kernels.jacobi_diffuse_plain(x, b, s, COEF)
    got = _wavefront(x, b, s, COEF, region, seg_len)
    assert torch.equal(got, want)


def test_jacobi_chunked_solve_matches_plain():
    """A 7-sweep solve in the launches sweep_chunks gives for 3 sweeps a
    launch (3 + 3 + 1), each through the wavefront, ping-ponged."""
    x = _rand((NX, NY, NZ), 31)
    b = _rand((NX, NY, NZ), 32)
    src = x
    for sweeps in stencil_kernels.sweep_chunks(7, 3):
        src = _wavefront(src, b, sweeps, COEF, 2 * sweeps + 4, 5)
    assert torch.equal(src, stencil_kernels.jacobi_diffuse_plain(x, b, 7,
                                                                 COEF))


@pytest.mark.parametrize("per_launch", range(1, 9))
def test_sweep_chunks(per_launch):
    for iters in range(0, 41):
        chunks = stencil_kernels.sweep_chunks(iters, per_launch)
        assert sum(chunks) == iters
        assert all(1 <= c <= per_launch for c in chunks)
        assert len(chunks) == math.ceil(iters / per_launch)
        assert all(c == per_launch for c in chunks[:-1])
    default = stencil_kernels.SWEEPS_PER_LAUNCH
    assert stencil_kernels.sweep_chunks(20) == stencil_kernels.sweep_chunks(
        20, default)
    assert 1 <= default <= 8


def test_jacobi_kernel_builds_the_wrappers_chunks():
    """csrc/jacobi_diffuse.cu instantiates its sweeps a launch (kSweeps)
    and 1 only: kSweeps is SWEEPS_PER_LAUNCH, and every launch the wrapper
    makes for a solve of 0 to 40 sweeps asks for one of those two."""
    import re
    from pathlib import Path

    src = (Path(stencil_kernels.__file__).resolve().parent.parent / "csrc"
           / "jacobi_diffuse.cu").read_text()
    k_sweeps = int(re.search(r"constexpr int kSweeps = (\d+);", src)[1])
    built = {k_sweeps if n == "kSweeps" else int(n)
             for n in re.findall(r"return launch<(\w+)>\(", src)}
    assert k_sweeps == stencil_kernels.SWEEPS_PER_LAUNCH
    assert built == {1, k_sweeps}
    for iters in range(0, 41):
        assert set(stencil_kernels.sweep_chunks(iters)) <= built
