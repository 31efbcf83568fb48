"""The schedule of the red-black Gauss-Seidel kernels, checked on the CPU
with the port's plain versions (no JAX involved).

``csrc/gs_wavefront.cuh`` runs L colour levels a launch: a block owns a
(j, k) region (k fastest, an even number of columns, a lane owning a
column pair) and marches a segment of i, loading level 0 from L planes
before the segment to L planes after it; level t at plane m - t is computed
at step m from level t-1's planes m-t+1, m-t-1 and, for the j and k
neighbours, m-t; rows within t of the region's edge are skipped at level t,
the region's edge columns and every cell outside the array are held, and
only the central (RJ - 2L) x (RK - 2L) columns are written; the steps run
in fours, and those past the segment's end write nothing. The cells a
step updates are the pair element ((m + j) & 1) ^ first ^ 1 (k0 even). The
masked operator forms its fluid bits and open-neighbour counts once per
plane, counts from the open bits of the plane before held in one shared
byte plane. ``_launch`` below emulates that schedule plane by plane, with
the kernel's registers and shared planes as tensors over all regions at
once, on region and segment sizes small enough to put region edges,
segment starts and array faces inside 13x9x11 and 20x17x24 fields; whole
calls follow ``stencil_kernels.level_chunks`` with two ping-pong buffers.
Every result must equal ``rbgs_smooth_plain`` / ``masked_rbgs_smooth_plain``
bit for bit. Both divide by the diagonal with a true division; the
kernel's is held against the plain a / diag on the card, for every
diagonal, by chip_smoke.py.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

CSRC = Path(sk.__file__).resolve().parent.parent / "csrc"
SHAPES = [(13, 9, 11), (20, 17, 24)]
# (rows, columns, segment length) of the emulated regions: both leave
# written columns at 4 and at 2 levels a launch
REGIONS = [(11, 12, 5), (9, 10, 3)]
SOLID = 2


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small tensor operations: one thread each, so that the suite's
    parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _flags(shape, seed):
    """Solid walls on three faces, air on another, a solid box, and
    random air and solid cells (so region edges meet every kind)."""
    rng = np.random.default_rng(seed)
    f = np.zeros(shape, np.uint8)
    f[0] = f[:, 0] = f[:, :, -1] = SOLID
    f[:, -1] = sk.AIR
    c = [n // 2 for n in shape]
    f[c[0] - 2:c[0] + 1, c[1] - 1:c[1] + 2, c[2] - 3:c[2] + 1] = 3
    r = rng.random(shape)
    f[r < 0.08] = sk.AIR
    f[r > 0.9] = SOLID
    return torch.from_numpy(f)


def _regions(n, written, L):
    """Region starts along one axis: written columns from 0, L before each."""
    return torch.arange(0, math.ceil(n / written)) * written - L


def _launch(x, b, flags, neumann, first, L, RJ, RK, seg_len):
    """One launch of L colour levels as gs_wavefront.cuh schedules it, from
    `x` (None: zero, never read) on the plain (`flags` None) or the masked
    operator. Returns the written output."""
    nx, ny, nz = b.shape
    TJ, TK = RJ - 2 * L, RK - 2 * L
    assert L % 2 == 0 and TJ > 0 and TK > 0 and TK % 2 == 0
    masked = flags is not None
    j0 = _regions(ny, TJ, L)
    k0 = _regions(nz, TK, L)
    assert bool((k0 % 2 == 0).all())
    jr = torch.arange(RJ)
    kc = torch.arange(RK)
    # (regions, RJ, RK) coordinates, regions j-major
    J = (j0[:, None] + jr[None, :])[:, None, :, None].expand(
        len(j0), len(k0), RJ, RK).reshape(-1, RJ, RK)
    K = (k0[:, None] + kc[None, :])[None, :, None, :].expand(
        len(j0), len(k0), RJ, RK).reshape(-1, RJ, RK)
    R = J.shape[0]
    JR = jr[None, :, None].expand(R, RJ, RK)
    KC = kc[None, None, :].expand(R, RJ, RK)
    inside = (J >= 0) & (J < ny) & (K >= 0) & (K < nz)
    Jc, Kc = J.clamp(0, ny - 1), K.clamp(0, nz - 1)
    upd_cols = inside & (KC > 0) & (KC < RK - 1)
    wr = ((JR >= L) & (JR < L + TJ) & (J < ny) & (KC >= L) & (KC < L + TK)
          & (K < nz))
    cjk = ((J > 0).int() + (J < ny - 1).int() + (K > 0).int()
           + (K < nz - 1).int())
    zero = torch.zeros(R, RJ, RK)
    six = torch.full((R, RJ, RK), 6.0)

    def gather(a, i):
        if a is None or not 0 <= i < nx:
            return zero
        return torch.where(inside, a[i][Jc, Kc], 0.0)

    def gather_flags(i):
        if not 0 <= i < nx:
            return torch.full((R, RJ, RK), SOLID, dtype=torch.uint8)
        return torch.where(inside, flags[i][Jc, Kc], SOLID)

    def shifted(p, dj, dk):
        """p[j + dj, k + dk] within each region, 0 beyond it (the shared
        plane's pad rows; the edge columns that would read past a row are
        held)."""
        pp = torch.nn.functional.pad(p, (1, 1, 1, 1))
        return pp[:, 1 + dj:RJ + 1 + dj, 1 + dk:RK + 1 + dk]

    out = torch.full_like(b, float("nan"))
    for i0 in range(0, nx, seg_len):
        i1 = min(i0 + seg_len, nx)
        cur = [zero] * L            # level t at plane m-t-1
        prv = [zero] * L            # level t at plane m-t-2
        bq = [zero] * L             # b at plane m-t-1
        xn, bn = gather(x, i0 - L), gather(b, i0 - L - 1)
        if masked:
            fn = gather_flags(i0 - L)
            fl = [torch.zeros(R, RJ, RK, dtype=torch.bool)] * (L + 1)
            opn = [torch.zeros(R, RJ, RK, dtype=torch.int32)] * 3
            cnt = [torch.zeros(R, RJ, RK, dtype=torch.int32)] * L
        # steps in fours: those past i1 + L write nothing
        for m in range(i0 - L, i0 - L + 4 * math.ceil((i1 - i0 + 2 * L) / 4)):
            # the pair element that updates at this step, every level
            active = (KC % 2) == ((((m + J) % 2) ^ first ^ 1))
            if masked:
                fluid, opened = fn == 0, (fn <= 1).int()
                fl = [fluid] + fl[:L]               # planes m .. m-L
                opn = [opened] + opn[:2]            # planes m, m-1, m-2
                fn = gather_flags(m + 1)
                nw = [torch.where(fluid, xn, 0.0)]
                # plane m-1's counts: planes m and m-2 on the own column,
                # plane m-1's j and k neighbours
                o = opn[1]
                count = (opn[0] + opn[2] + shifted(o, 1, 0) + shifted(o, -1, 0)
                         + shifted(o, 0, 1) + shifted(o, 0, -1))
                assert int(count.max()) <= 6
                cnt = [count] + cnt[:L - 1]         # planes m-1 .. m-L
            else:
                nw = [xn]
            bq = [bn] + bq[:L - 1]
            xn, bn = gather(x, m + 1), gather(b, m)
            for t in range(1, L + 1):
                i = m - t
                v = cur[t - 1]
                if 0 <= i < nx:
                    u = (JR >= t) & (JR < RJ - t) & active & upd_cols
                    if masked:
                        u = u & fl[t]
                        d = torch.clamp(cnt[t - 1].float(), min=1.0)
                    elif neumann:
                        ci = int(i > 0) + int(i < nx - 1)
                        d = (cjk + ci).float()
                    else:
                        d = six
                    c = cur[t - 1]          # the shared plane of level t-1
                    nb = zero + nw[t - 1]                      # x[i+1]
                    nb = nb + prv[t - 1]                       # x[i-1]
                    nb = nb + shifted(c, 1, 0)                 # x[j+1]
                    nb = nb + shifted(c, -1, 0)                # x[j-1]
                    nb = nb + shifted(c, 0, 1)                 # x[k+1]
                    nb = nb + shifted(c, 0, -1)                # x[k-1]
                    v = torch.where(u, (nb + bq[t - 1]) / d, v)
                nw.append(v)
            prv, cur = cur, nw[:L]
            io = m - L
            if i0 <= io < i1:
                out[io][J[wr], K[wr]] = nw[L][wr]
    assert not bool(out.isnan().any())
    return out


def _call(x, b, flags, bc, iters, reverse, region, per_launch):
    """A whole smoother call: the wrapper's launches, ping-ponged."""
    RJ, RK, seg_len = region
    src = x
    for levels in sk.level_chunks(iters, per_launch):
        src = _launch(src, b, flags, bc == "neumann", int(reverse), levels,
                      RJ, RK, seg_len)
    return src


@pytest.mark.parametrize("shape,region", [(SHAPES[0], REGIONS[0]),
                                          (SHAPES[1], REGIONS[1])])
@pytest.mark.parametrize("iters", [1, 2, 3, 4])
@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
@pytest.mark.parametrize("reverse,from_zero", [(False, False), (True, True)])
def test_rbgs_wavefront_matches_plain(shape, region, iters, bc, reverse,
                                      from_zero):
    b = _rand(shape, 1)
    x = None if from_zero else _rand(shape, 2)
    want = sk.rbgs_smooth_plain(x, b, bc, iters, reverse)
    got = _call(x, b, None, bc, iters, reverse, region,
                sk.LEVELS_PER_LAUNCH)
    assert torch.equal(got, want)
    if from_zero:
        zeros = _call(torch.zeros_like(b), b, None, bc, iters, reverse,
                      region, sk.LEVELS_PER_LAUNCH)
        assert torch.equal(got, zeros)


@pytest.mark.parametrize("shape,region", [(SHAPES[0], REGIONS[1]),
                                          (SHAPES[1], REGIONS[0])])
@pytest.mark.parametrize("iters", [1, 2, 3, 4])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("from_zero", [False, True])
def test_masked_rbgs_wavefront_matches_plain(shape, region, iters, reverse,
                                             from_zero):
    """x is nonzero on the non-fluid cells: level 0 must mask it."""
    b = _rand(shape, 3)
    flags = _flags(shape, 4)
    assert bool((flags != 0).any()) and bool((flags == sk.AIR).any())
    x = None if from_zero else _rand(shape, 5)
    want = sk.masked_rbgs_smooth_plain(x, b, flags, iters, reverse)
    got = _call(x, b, flags, None, iters, reverse, region,
                sk.LEVELS_PER_LAUNCH)
    assert torch.equal(got, want)
    assert bool((got[flags != 0] == 0).all())


@pytest.mark.parametrize("per_launch", [2, 4])
def test_rbgs_call_splits_match_plain(per_launch):
    """A 3-sweep call at 2 and at 4 levels a launch (3 launches, or 4 + 2)
    on the ragged shape: the ping-pong between launches keeps the bits."""
    shape = SHAPES[1]
    b, x = _rand(shape, 6), _rand(shape, 7)
    flags = _flags(shape, 8)
    for bc in ("dirichlet", "neumann"):
        want = sk.rbgs_smooth_plain(x, b, bc, 3, True)
        got = _call(x, b, None, bc, 3, True, REGIONS[0], per_launch)
        assert torch.equal(got, want)
    want = sk.masked_rbgs_smooth_plain(x, b, flags, 3, False)
    got = _call(x, b, flags, None, 3, False, REGIONS[0], per_launch)
    assert torch.equal(got, want)


@pytest.mark.parametrize("first", [0, 1])
def test_step_parity_is_the_global_colour(first):
    """Level t at plane i = m - t updates colour first ^ ((t-1) & 1) of the
    global (i + j + k) & 1: at every level of step m that is the pair
    element ((m + j) & 1) ^ first ^ 1, for negative indices too (planes
    and rows before the array). Element e of a pair has k's parity, since
    k0 is even."""
    for L in (2, 4):
        for m in range(-L - 3, 9):
            for j in range(-L, 7):
                for k in range(-L, 9):
                    e = ((m + j) & 1) ^ first ^ 1
                    for t in range(1, L + 1):
                        colour = first ^ ((t - 1) & 1)
                        updates = ((m - t + j + k) & 1) == colour
                        assert updates == ((k & 1) == e)


def _constants():
    src = (CSRC / "gs_wavefront.cuh").read_text()
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}


def test_rbgs_kernels_build_the_wrappers_chunks():
    """csrc/gs_wavefront.cuh's kLevels is LEVELS_PER_LAUNCH; both kernels
    build kLevels and 2 only, and every launch the wrappers make for a call
    of 1 to 12 sweeps asks for one of those (a call of at most 2 sweeps is
    one launch); the region leaves written columns at both counts, and a
    row's packed masked state fits its 32-bit registers."""
    const = _constants()
    k_levels = const["kLevels"]
    assert k_levels == sk.LEVELS_PER_LAUNCH
    for name in ("rbgs_smooth", "masked_rbgs_smooth"):
        src = (CSRC / f"{name}.cu").read_text()
        built = {k_levels if n == "gs::kLevels" else int(n)
                 for n in re.findall(r"gs::launch<([\w:]+), gs::k\w+>\(",
                                     src)}
        assert built == {2, k_levels}, name
        assert '#include "gs_wavefront.cuh"' in src
    for iters in range(1, 13):
        chunks = sk.level_chunks(iters)
        assert set(chunks) <= {2, k_levels}
        assert sum(chunks) == 2 * iters
        assert len(chunks) == math.ceil(2 * iters / k_levels)
        assert all(c % 2 == 0 for c in chunks)
        if iters <= 2:
            assert len(chunks) == 1
    region_k = 2 * const["kPairs"]
    assert const["kRegionJ"] % const["kWarpsJ"] == 0
    for L in (2, k_levels):
        assert region_k - 2 * L > 0 and const["kRegionJ"] - 2 * L > 0
        assert (region_k - 2 * L) % 2 == 0 and L % 2 == 0   # k0 even
        assert 6 * L <= 32 and 2 * (L + 1) <= 32     # counts, fluid bits
