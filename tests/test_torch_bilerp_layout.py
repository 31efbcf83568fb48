"""The trace and DMC modes of the ``bilerp_sample`` kernel, emulated on the
CPU against the plain versions and the composition they stand for (no
JAX).

The trace mode (csrc/bilerp_sample.cu, ``bilerp_trace_kernel``) runs a
whole CFL-substepped 2D RK3 trace in one thread a position: the start is
read at an element stride or formed from a kind's lattice as ((float)i +
off) * h with (i, j) from the thread's flat index; each substep takes
three MAC velocity samples with the band test on the float floors, the
stage updates, the combination summed left to right and the 0.001h clamp
by compare-and-select, with the coefficient set of the full substeps or of
the last one; then the final clamp, and at the foot the samples of C
fields, the min and max of their 4 clamped corners (NaN at a NaN foot)
and the foot itself, written into one buffer at the wrapper's offsets.
The DMC mode recomputes the node's velocity, the upwind velocity and the
slopes in every substep, takes the exponential step, clamps to [h, L - h]
and samples the map. The emulations below do exactly those operations,
in float32, from the very parameters the wrappers pack for the kernel
(``trace_plan``, ``dmc_plan``, ``trace_views``), and must equal the plain
versions (``bilerp_trace_plain``, ``bilerp_dmc_plain``) and the
composition of the first port (three MAC samples a substep and the torch
glue around them; the slopes once a march; the clamp's gathers) bit for
bit, NaN for NaN, on 24x40, 37x29 and 16x80 (the Rayleigh-Taylor
aspect): from every kind's lattice, wandering and outside positions, a
map and the (P, 2) particle columns, 1, 2 and 3 substeps (the last
partial), both signs, C = 0-4, with and without the min/max and the final
clamps, and a NaN in the velocity.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpufluidsimulation_tpu_torch.core import interp
from gpufluidsimulation_tpu_torch.core.grids import Grid2D
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast

F32 = torch.float32
NAN = float("nan")
CSRC = Path(interp_fast.__file__).resolve().parent.parent / "csrc"
GRIDS = [(24, 40), (37, 29), (16, 80)]


def T(x):
    """A float32 scalar, as the kernel holds its parameters."""
    return torch.tensor(np.float32(x), dtype=F32)


# ---------------------------------------------------------------------------
# The kernel's operations, vectorized over its threads
# ---------------------------------------------------------------------------


def _frac(gx, gy):
    i0, j0 = torch.floor(gx), torch.floor(gy)
    fx, fy = gx - i0, gy - j0
    return dict(i0=i0, j0=j0, fx=fx, fy=fy, wx=1.0 - fx, wy=1.0 - fy)


def _node(i, n):
    """clamp_node: fminf(fmaxf(i, 0), n - 1), a NaN at node 0."""
    c = torch.minimum(torch.maximum(i, T(0.0)), T(n - 1))
    return torch.where(torch.isnan(i), 0.0, c).long()


def _corners(f, w):
    nx, ny = f.shape
    ia, ib = _node(w["i0"], nx) * ny, _node(w["i0"] + 1.0, nx) * ny
    ja, jb = _node(w["j0"], ny), _node(w["j0"] + 1.0, ny)
    flat = f.reshape(-1)
    return flat[ia + ja], flat[ib + ja], flat[ia + jb], flat[ib + jb]


def _blend(q, w):
    v00, v10, v01, v11 = q
    return (w["wy"] * (w["wx"] * v00 + w["fx"] * v10)
            + w["fy"] * (w["wx"] * v01 + w["fx"] * v11))


def _mac(u, v, px, py, h):
    """mac_velocity: x = p / h, each component's frac, corners, blend and
    band test on the float floors."""
    ni, nj = v.shape[0], u.shape[1]
    x, y = px / h, py / h
    out = []
    for f, (ox, oy), (bx, by) in ((u, (0.0, 0.5), (ni - 1, nj - 2)),
                                  (v, (0.5, 0.0), (ni - 2, nj - 1))):
        w = _frac(x - T(ox), y - T(oy))
        r = _blend(_corners(f, w), w)
        valid = ((w["i0"] >= 0.0) & (w["i0"] <= T(bx)) & (w["j0"] >= 0.0)
                 & (w["j0"] <= T(by)))
        out.append(torch.where(valid, r, 0.0))
    return out


def _clampf(x, lo, hi):
    """x < lo ? lo : (x > hi ? hi : x)."""
    return torch.where(x < lo, lo, torch.where(x > hi, hi, x))


def _nan_pair(op, a, b):
    return torch.where(torch.isnan(a) | torch.isnan(b), NAN, op(a, b))


def run_emulated(u, v, h, subs, start, fields=(), off=(0.0, 0.0),
                 minmax=False, write_pos=True, final_clamp=None,
                 interleave=False):
    """The wrapper's packing (trace_plan, trace_outputs, trace_pointers)
    around the emulated kernel, whose writes land at the packed
    addresses: what bilerp_trace returns on the card. Every output
    starts filled with -7."""
    fields = list(fields)
    fp, ip, shape = interp_fast.trace_plan(
        u, v, h, subs, start, fields, off, minmax, write_pos, final_clamp,
        interleave)
    n_sub, fin, n, lny, in_stride, out_stride, C, fnx, fny, mm = ip
    assert mm == int(minmax) and C == len(fields)
    out = interp_fast.trace_outputs(shape, C, minmax, write_pos, interleave,
                                    "cpu")
    for t in out:
        if t is not None:
            t.fill_(-7.0)
    at = interp_fast.trace_pointers(out, n, interleave)
    x, y = _trace_positions(u, v, fp, ip, start)
    idx = torch.arange(n)
    if at[0] is not None:
        flat = out.pos.view(-1)
        assert at[0] == flat.data_ptr()
        flat[idx * out_stride] = x
        flat[(at[1] - at[0]) // 4 + idx * out_stride] = y
    if C:
        hh, fox, foy = T(fp[0]), T(fp[21]), T(fp[22])
        gx, gy = x / hh - fox, y / hh - foy
        w = _frac(gx, gy)
        nan_foot = torch.isnan(gx) | torch.isnan(gy)
        planes = [out.samples] + ([out.min, out.max] if minmax else [])
        assert at[2:2 + len(planes)] == [t.data_ptr() for t in planes]
        flat = [t.view(-1) for t in planes]
        for c, f in enumerate(fields):
            assert f.shape == (fnx, fny)
            q = _corners(f, w)
            flat[0][c * n + idx] = _blend(q, w)
            if minmax:
                lo = _nan_pair(torch.fmin, _nan_pair(torch.fmin, q[0], q[1]),
                               _nan_pair(torch.fmin, q[2], q[3]))
                hi = _nan_pair(torch.fmax, _nan_pair(torch.fmax, q[0], q[1]),
                               _nan_pair(torch.fmax, q[2], q[3]))
                flat[1][c * n + idx] = torch.where(nan_foot, NAN, lo)
                flat[2][c * n + idx] = torch.where(nan_foot, NAN, hi)
    return out


def _trace_positions(u, v, fp, ip, start):
    """The thread's march: the start (read at the element stride, or the
    lattice node of its flat index), the substeps and the final clamp."""
    h = T(fp[0])
    k0, k1 = [T(c) for c in fp[1:6]], [T(c) for c in fp[6:11]]
    elx, ehx, ely, ehy = (T(c) for c in fp[11:15])
    flx, fhx, fly, fhy = (T(c) for c in fp[15:19])
    lox, loy = T(fp[19]), T(fp[20])
    n_sub, fin, n, lny, in_stride = ip[:5]
    idx = torch.arange(n)
    if lny:
        i = idx // lny
        j = idx - i * lny
        x = (i.to(F32) + lox) * h
        y = (j.to(F32) + loy) * h
    else:
        # element idx * in_stride from each column's first element
        px, py = start
        x = torch.as_strided(px, (n,), (in_stride,))
        y = torch.as_strided(py, (n,), (in_stride,))
    for s in range(n_sub):
        a, b, c1, c2, c3 = k1 if s == n_sub - 1 else k0
        u1, v1 = _mac(u, v, x, y, h)
        u2, v2 = _mac(u, v, x + a * u1, y + a * v1, h)
        u3, v3 = _mac(u, v, x + b * u2, y + b * v2, h)
        x = _clampf(x + c1 * u1 + c2 * u2 + c3 * u3, elx, ehx)
        y = _clampf(y + c1 * v1 + c2 * v2 + c3 * v3, ely, ehy)
    if fin:
        x, y = _clampf(x, flx, fhx), _clampf(y, fly, fhy)
    return x, y


def emulate_dmc(u, v, map_x, map_y, h, subs):
    """gfs_bilerp_dmc's kernel, one launch a substep from dmc_plan's
    parameters: every node forms its position from its flat index, both
    MAC velocities and the slopes anew, the step, the clamp and the C=2
    sample of the last launch's map."""
    ni, nj = v.shape[0], u.shape[1]
    idx = torch.arange(ni * nj)
    i = idx // nj
    j = idx - i * nj
    maps = (map_x, map_y)
    for sub in subs:
        hh, s, lo, hix, hiy = (T(c) for c in interp_fast.dmc_plan(h, sub, ni,
                                                                  nj))
        x = (i.to(F32) + 0.5) * hh
        y = (j.to(F32) + 0.5) * hh
        vu, vv = _mac(u, v, x, y, hh)
        tx = torch.where(vu > 0.0, x - hh, x + hh)
        ty = torch.where(vv > 0.0, y - hh, y + hh)
        tu, tv = _mac(u, v, tx, ty, hh)
        ax, ay = (vu - tu) / (x - tx), (vv - tv) / (y - ty)

        def newpos(p, vel, a):
            big = torch.abs(a) > T(1e-4)
            sa = torch.where(big, a, 1.0)
            e = p - (1.0 - torch.exp(-sa * s)) * vel / sa
            return torch.where(big, e, p - vel * s)

        nx = _clampf(newpos(x, vu, ax), lo, hix)
        ny = _clampf(newpos(y, vv, ay), lo, hiy)
        w = _frac(nx / hh - 0.5, ny / hh - 0.5)
        out = torch.stack([_blend(_corners(m, w), w).view(ni, nj)
                           for m in maps])
        maps = (out[0], out[1])
    return torch.stack(maps)


# ---------------------------------------------------------------------------
# The first port's composition (three MAC launches a substep, torch glue)
# ---------------------------------------------------------------------------


def first_port_trace(g, u, v, subs, start, fields, off, final_clamp):
    """The first port's trace: the start from Grid2D.node_coords, each
    substep advect.trace_rk3_2d's three mac-mode samples and glue, then
    the caller's clamp, the sample launch and _clamp_2d_at's gathers.
    Returns the foot, the samples and the corner min/max."""
    h = g.h
    if isinstance(start, interp_fast.Lattice2D):
        kind = {g.OFF_C: "c", g.OFF_U: "u", g.OFF_V: "v"}[start.off]
        px, py = g.node_coords(kind)
    else:
        px, py = (p.contiguous() for p in start)
    ni, nj = v.shape[0], u.shape[1]
    for dt in subs:
        a, b, c1, c2, c3 = interp_fast.rk3_coefficients(dt)
        u1, v1 = interp.mac_velocity_2d_lattice(u, v, px, py, h)
        u2, v2 = interp.mac_velocity_2d_lattice(u, v, px + a * u1,
                                                py + a * v1, h)
        u3, v3 = interp.mac_velocity_2d_lattice(u, v, px + b * u2,
                                                py + b * v2, h)
        px, py = interp.clamp_pos_2d(px + c1 * u1 + c2 * u2 + c3 * u3,
                                     py + c1 * v1 + c2 * v2 + c3 * v3, h, ni,
                                     nj, eps=0.001)
    if final_clamp is not None:
        (lx, hx), (ly, hy) = final_clamp
        px, py = px.clamp(lx, hx), py.clamp(ly, hy)
    if not fields:
        return (px, py), None, None
    samples = torch.stack(list(interp.sample2_lattice_multi(
        torch.stack(fields), px, py, h, (off,) * len(fields))))
    gx = interp.div_scalar(px, h) - off[0]
    gy = interp.div_scalar(py, h) - off[1]
    mns, mxs = [], []
    for src in fields:
        nx, ny = src.shape
        ia, ib, _ = interp._axis_corners(gx, nx)
        ja, jb, _ = interp._axis_corners(gy, ny)
        flat = src.reshape(-1)
        v00, v10 = flat[ia * ny + ja], flat[ib * ny + ja]
        v01, v11 = flat[ia * ny + jb], flat[ib * ny + jb]
        mns.append(torch.minimum(torch.minimum(v00, v10),
                                 torch.minimum(v01, v11)))
        mxs.append(torch.maximum(torch.maximum(v00, v10),
                                 torch.maximum(v01, v11)))
    return (px, py), samples, (torch.stack(mns), torch.stack(mxs))


def first_port_march(g, u, v, map_x, map_y, subs):
    """The first port's backward march: the slopes once (two mac-mode
    samples on the cell lattice), the positions once a distinct substep,
    one C=2 map sample a substep."""
    h = g.h
    px, py = g.node_coords("c")
    vel_u, vel_v = interp.mac_velocity_2d_lattice(u, v, px, py, h)
    tx = torch.where(vel_u > 0, px - h, px + h)
    ty = torch.where(vel_v > 0, py - h, py + h)
    tu, tv = interp.mac_velocity_2d_lattice(u, v, tx, ty, h)
    ax, ay = (vel_u - tu) / (px - tx), (vel_v - tv) / (py - ty)

    def newpos(pos, vel, a, sub):
        big = a.abs() > 1e-4
        safe_a = torch.where(big, a, 1.0)
        e = pos - (1.0 - torch.exp(-safe_a * sub)) * vel / safe_a
        return torch.where(big, e, pos - vel * sub)

    maps = torch.stack([map_x, map_y])
    for sub in subs:
        nx, ny = interp.clamp_pos_2d(newpos(px, vel_u, ax, sub),
                                     newpos(py, vel_v, ay, sub), h, g.ni,
                                     g.nj)
        maps = interp_fast.bilerp_sample(maps, nx, ny, h, (g.OFF_C,) * 2)
    return maps


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _smooth(shape, rng, amp):
    idx = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(2):
        k = rng.uniform(0.5, 3.0, 2) * 2 * np.pi / np.array(shape)
        f += np.sin(k[0] * idx[0] + k[1] * idx[1] + rng.uniform(0, 6.3))
    return torch.from_numpy((amp * f / 2).astype(np.float32))


def _state(ni, nj, nan=False, seed=0):
    g = Grid2D(ni, nj, 1.0 / ni)
    rng = np.random.default_rng(seed + 7 * ni + nj)
    u, v = _smooth(g.shape_u, rng, 2.0), _smooth(g.shape_v, rng, 2.0)
    if nan:
        u[ni // 2:ni // 2 + 2, nj // 2:nj // 2 + 2] = NAN
    cells = [_smooth(g.shape_c, rng, a) for a in (1.0, 50.0, 3.0, 0.5)]
    wander = [(q + _smooth(q.shape, rng, 4.0 * g.h)).contiguous()
              for q in g.node_coords("c")]
    pos = torch.stack([q.reshape(-1).repeat(4) for q in g.node_coords("c")],
                      -1)
    pos = (pos + torch.from_numpy(rng.uniform(-0.5, 0.5, pos.shape)
                                  .astype(np.float32)) * g.h)
    pos = torch.stack([pos[:, 0].clamp(g.h, (ni - 1) * g.h),
                       pos[:, 1].clamp(g.h, (nj - 1) * g.h)], -1)
    return g, u, v, cells, wander, pos


def _subs(count, h):
    """`count` signed substeps of 1.5h (the last of 3 at 0.37 of it)."""
    s = np.float32(1.5 * h) * np.float32(1 if count > 0 else -1)
    n = abs(count)
    return [s] * (n - 1) + ([s * np.float32(0.37) if n == 3 else s]
                            if n else [])


# (start, substeps, C, minmax, foot, final clamp, NaN velocity)
TRACE_CASES = {
    "lattice-c-2-C2-minmax": ("c", 2, 2, True, False, None, False),
    "lattice-u-3partial-C1-minmax": ("u", 3, 1, True, False, None, False),
    "lattice-v-back1-C1": ("v", -1, 1, False, False, None, False),
    "lattice-c-back2-C4-minmax-foot": ("c", -2, 4, True, True, None, False),
    "lattice-c-3partial-C3-foot": ("c", 3, 3, False, True, None, False),
    "lattice-c-0-C1": ("c", 0, 1, False, True, None, False),
    "outside-2-C2-minmax-foot": ("out", 2, 2, True, True, None, False),
    "map-3partial-clamp": ("map", 3, 0, False, True, "map", False),
    "particles-2-clamp": ("particles", 2, 0, False, True, "particles",
                          False),
    "particles-back3partial-clamp": ("particles", -3, 0, False, True,
                                     "particles", False),
    "nan-lattice-c-2-C2-minmax-foot": ("c", 2, 2, True, True, None, True),
    "nan-particles-2-clamp": ("particles", 2, 0, False, True, "particles",
                              True),
}


def _trace_case(ni, nj, case):
    start, count, C, minmax, foot, clamp, nan = TRACE_CASES[case]
    g, u, v, cells, wander, pos = _state(ni, nj, nan)
    h = g.h
    off = g.OFF_C
    fields = cells[:C]
    if start in ("c", "u", "v"):
        origin = interp_fast.Lattice2D(g.shape_of(start), g.off_of(start))
        off = g.off_of(start)
        if start != "c":
            f = u if start == "u" else v
            fields = [f, 2.0 * f, f + 1.0, -f][:C]
    elif start == "particles":
        origin = (pos[:, 0], pos[:, 1])
    elif start == "out":
        origin = tuple((p * ((m + 6.0) / m) - 3.0 * h).contiguous()
                       for p, m in zip(wander, (ni, nj)))
    else:
        origin = tuple(wander)
    final = {"map": interp.clamp_bounds_2d(h, ni, nj),
             "particles": ((h, (ni - 1) * h),
                           (h, (nj - 1) * h))}.get(clamp)
    kw = dict(fields=fields, off=off, minmax=minmax, write_pos=foot,
              final_clamp=final, interleave=start == "particles")
    return g, u, v, _subs(count, h), origin, kw


def _same(a, b):
    """Equal bits, NaN where the other is NaN."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    return torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
@pytest.mark.parametrize("ni,nj", GRIDS)
def test_trace_mode_matches_the_plain_trace(ni, nj, case):
    g, u, v, subs, origin, kw = _trace_case(ni, nj, case)
    got = run_emulated(u, v, g.h, subs, origin, **kw)
    want = interp_fast.bilerp_trace_plain(u, v, g.h, subs, origin, **kw)
    # the kernel writes every element of every output
    assert not any(bool((t == -7.0).any()) for t in got if t is not None)
    for part, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), part
        if a is None:
            continue
        assert a.shape == b.shape, part
        if part < 2:
            assert _same(a, b), part
        else:
            # the min/max by value: +0 and -0 corners may give either
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    if TRACE_CASES[case][-1]:
        assert bool(torch.isnan(want.pos).any())
    assert interp_fast.bilerp_trace.launches == 0


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
@pytest.mark.parametrize("ni,nj", GRIDS)
def test_plain_trace_matches_the_first_ports_composition(ni, nj, case):
    g, u, v, subs, origin, kw = _trace_case(ni, nj, case)
    want = interp_fast.bilerp_trace_plain(u, v, g.h, subs, origin, **kw)
    (px, py), samples, minmax = first_port_trace(
        g, u, v, subs, origin, kw["fields"], kw["off"], kw["final_clamp"])
    if want.pos is not None:
        dim = -1 if kw["interleave"] else 0
        assert _same(want.pos, torch.stack([px, py], dim))
    if samples is not None:
        assert _same(want.samples, samples)
    if kw["minmax"]:
        # at a NaN foot the sample is NaN, so the clamp keeps NaN whatever
        # the min/max; the first port took it from corner nodes that the
        # NaN-to-integer conversion picks, the kernel gives NaN
        foot = ~torch.isnan(samples)
        assert bool(torch.isnan(samples[~foot]).all())
        for a, b in zip((want.min, want.max), minmax):
            assert torch.equal(a[foot], b[foot])
            assert bool(torch.isnan(a[~foot]).all())


@pytest.mark.parametrize("scheme", ["semilag", "maccormack", "bfecc"])
@pytest.mark.parametrize("ni,nj", [(24, 40), (16, 80)])
def test_semilag_family_matches_the_first_port(ni, nj, scheme):
    """The schemes on the trace mode's plain version against the first
    port's composition of them: the semi-Lagrangian samples, the
    backtrace, the corner clamp's gathers and its select."""
    g, u, v, cells, _, _ = _state(ni, nj)
    srcs, cfldt, dt = cells[:2], np.float32(0.8 * g.h), np.float32(2.1 * g.h)
    multi = {"semilag": advect.semilag_multi_2d,
             "maccormack": advect.maccormack_multi_2d,
             "bfecc": advect.bfecc_multi_2d}[scheme]
    got = multi(g, "c", srcs, u, v, cfldt, dt)
    back = advect.trace_substeps(cfldt, -dt)
    start = interp_fast.Lattice2D(g.shape_c, g.OFF_C)
    (bx, by), fwds, (mn, mx) = first_port_trace(g, u, v, back, start, srcs,
                                                g.OFF_C, None)
    if scheme == "semilag":
        want = list(fwds)
    else:
        _, backs, _ = first_port_trace(g, u, v, advect.trace_substeps(
            cfldt, dt), start, list(fwds), g.OFF_C, None)
        if scheme == "maccormack":
            dsts = [f + 0.5 * (s - b) for s, f, b in zip(srcs, fwds, backs)]
        else:
            mids = [0.5 * (3.0 * s - b) for s, b in zip(srcs, backs)]
            dsts = interp.sample2_lattice_multi(mids, bx, by, g.h,
                                                (g.OFF_C,) * 2)
        want = [torch.where((d < lo) | (d > hi), f, d)
                for d, lo, hi, f in zip(dsts, mn, mx, fwds)]
    for a, b in zip(got, want):
        assert _same(a, b)


# (substeps, sign, NaN velocity)
DMC_CASES = {"1": (1, 1, False), "3partial": (3, 1, False),
             "negative": (1, -1, False), "nan-3partial": (3, 1, True)}


@pytest.mark.parametrize("case", sorted(DMC_CASES))
@pytest.mark.parametrize("ni,nj", GRIDS)
def test_dmc_mode_matches_the_plain_march(ni, nj, case):
    count, sign, nan = DMC_CASES[case]
    g, u, v, _, wander, _ = _state(ni, nj, nan)
    subs = [s * np.float32(sign) for s in _subs(count, g.h)]
    got = emulate_dmc(u, v, *wander, g.h, subs)
    want = interp_fast.bilerp_dmc_plain(u, v, *wander, g.h, subs)
    assert _same(got, want)
    assert _same(want, first_port_march(g, u, v, *wander, subs))
    if sign > 0:
        # the solver's march: its substep schedule from (cfldt, dt)
        cfldt, dt = subs[0], np.float32(sum(subs))
        march = advect.update_backward_map_2d(g, u, v, wander, cfldt, dt)
        assert _same(emulate_dmc(u, v, *wander, g.h,
                                 advect.substeps(cfldt, dt)),
                     torch.stack(march))
    assert bool(torch.isnan(want).any()) == nan
    assert interp_fast.bilerp_dmc.launches == 0


def _source_constant(name):
    src = (CSRC / "bilerp_sample.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("n", [1, 37, 127, 128, 129, 24 * 41, 16 * 80 * 4])
def test_trace_threads_cover_each_position_once(n):
    """The trace mode's thread map: block b and thread t take idx =
    b*threads + t; every idx < n is written once and a thread past the
    end returns; in the lattice mode idx -> (idx // ny, idx % ny), so a
    warp's 32 threads take a contiguous j-run (stores coalesce)."""
    threads = _source_constant("kTraceThreads")
    blocks = -(-n // threads)
    b, t = np.meshgrid(np.arange(blocks), np.arange(threads), indexing="ij")
    idx = (b * threads + t).ravel()
    written = idx[idx < n]
    assert np.array_equal(np.sort(written), np.arange(n))
    assert blocks * threads - n < threads
    ny = 40
    warp = np.arange(32) + 32 * 5
    i, j = warp // ny, warp % ny
    assert np.all((np.diff(j) == 1) | ((np.diff(j) == 1 - ny)
                                       & (np.diff(i) == 1)))


def test_trace_plan_packs_the_launch():
    g = Grid2D(37, 29, 1.0 / 37)
    h = g.h
    u, v = torch.zeros(g.shape_u), torch.zeros(g.shape_v)
    subs = _subs(3, h)
    rho = torch.zeros(g.shape_c)
    fp, ip, shape = interp_fast.trace_plan(
        u, v, h, subs, interp_fast.Lattice2D(g.shape_u, g.OFF_U),
        [rho, rho], g.OFF_C, minmax=True, write_pos=True,
        final_clamp=interp.clamp_bounds_2d(h, 37, 29))
    assert fp[0] == h
    assert tuple(fp[1:6]) == interp_fast.rk3_coefficients(subs[0])
    assert tuple(fp[6:11]) == interp_fast.rk3_coefficients(subs[-1])
    assert fp[1:6] != fp[6:11]
    (elx, ehx), (ely, ehy) = interp.clamp_bounds_2d(h, 37, 29, eps=0.001)
    assert fp[11:15] == [elx, ehx, ely, ehy]
    assert fp[15:19] == [h, 37 * h - h, h, 29 * h - h]
    assert fp[19:23] == [*g.OFF_U, *g.OFF_C]
    assert ip == [3, 1, 38 * 29, 29, 1, 1, 2, 37, 29, 1]
    assert shape == (38, 29)
    # a bound rounded to float32 once, as torch.clamp rounds it: the
    # kernel's compare-and-select with T(bound) equals torch.clamp on
    # float32 values on and around each bound
    for lo, hi in ((elx, ehx), (ely, ehy), (h, 37 * h - h)):
        for bound in (lo, hi):
            b32 = np.float32(bound)
            xs = torch.tensor([np.nextafter(b32, np.float32(-1)), b32,
                               np.nextafter(b32, np.float32(2)), NAN],
                              dtype=F32)
            assert _same(_clampf(xs, T(lo), T(hi)), xs.clamp(lo, hi))
    pos = torch.zeros(100, 2)
    fp, ip, shape = interp_fast.trace_plan(
        u, v, h, subs[:1], (pos[:, 0], pos[:, 1]), interleave=True)
    assert ip == [1, 0, 100, 0, 2, 2, 0, 0, 0, 0]
    assert fp[6:11] == fp[1:6] and fp[19:21] == [0.0, 0.0]
    assert shape == (100,)
    out = interp_fast.trace_outputs(shape, 0, False, True, True, "cpu")
    at = interp_fast.trace_pointers(out, 100, True)
    assert out.pos.shape == (100, 2) and at[1] == at[0] + 4
    assert at[2:] == [None] * 3
    out = interp_fast.trace_outputs((7, 5), 2, True, True, False, "cpu")
    at = interp_fast.trace_pointers(out, 35, False)
    assert out.pos.shape == (2, 7, 5) and at[1] == at[0] + 4 * 35
    assert [t.shape for t in out[1:]] == [(2, 7, 5)] * 3
    assert interp_fast.dmc_plan(h, np.float32(0.5), 37, 29) == [
        h, np.float32(0.5), h, 37 * h - h, 29 * h - h]


def test_trace_and_dmc_wrapper_checks():
    g = Grid2D(24, 40, 1.0 / 24)
    u, v = torch.zeros(g.shape_u), torch.zeros(g.shape_v)
    lat = interp_fast.Lattice2D(g.shape_c, g.OFF_C)
    rho = torch.zeros(g.shape_c)
    with pytest.raises(ValueError):      # substeps before the last differ
        interp_fast.trace_schedule([np.float32(0.1), np.float32(0.2),
                                    np.float32(0.1)])
    assert interp_fast.trace_schedule([])[0] == 0
    for bad in (dict(fields=[rho] * 5), dict(minmax=True),
                dict(fields=[rho, torch.zeros(3, 3)])):
        with pytest.raises(ValueError):
            interp_fast.trace_plan(u, v, g.h, [0.1], lat, **bad)
    with pytest.raises(ValueError):      # not a MAC pair
        interp_fast.trace_plan(v, u, g.h, [0.1], lat)
    with pytest.raises(ValueError):      # 2-D positions, not contiguous
        p = torch.zeros(8, 8).t()
        interp_fast.trace_plan(u, v, g.h, [0.1], (p, p))
    with pytest.raises(ValueError):      # px and py of other strides
        p = torch.zeros(16, 2)
        interp_fast.trace_plan(u, v, g.h, [0.1], (p[:, 0], p[:8, 0] * 1))
    # the 32-bit offsets: positions, outputs and fields below 2^31
    big = torch.empty(2 ** 30, 2, device="meta")
    with pytest.raises(ValueError):
        interp_fast.trace_plan(u, v, g.h, [0.1], (big[:, 0], big[:, 1]))
    interp_fast.trace_plan(u, v, g.h, [0.1], (big[:2 ** 29, 0],
                                              big[:2 ** 29, 1]))
    with pytest.raises(ValueError):
        interp_fast.trace_plan(u, v, g.h, [0.1],
                               interp_fast.Lattice2D((2 ** 15, 2 ** 15),
                                                     (0.5, 0.5)),
                               [torch.empty(2 ** 15, 2 ** 15,
                                            device="meta")], minmax=True)
    meta = torch.empty(g.shape_u, device="meta")
    with pytest.raises(ValueError):
        interp_fast.bilerp_trace(meta, v, g.h, [0.1], lat)
    with pytest.raises(ValueError):
        interp_fast.bilerp_dmc(u, v, torch.empty(24, 40, device="meta"),
                               rho, g.h, [0.1])
    assert interp_fast.bilerp_trace.launches == 0
    assert interp_fast.bilerp_dmc.launches == 0
