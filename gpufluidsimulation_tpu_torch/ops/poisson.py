"""Pressure projection: spectral, MG-PCG and voxel-boundary (masked).

Counterpart of ``gpufluidsimulation_tpu.ops.poisson``: MAC divergence and
gradient in grid units, the unscaled Laplacian L p = 6p - sum(nbrs), the
direct spectral solve with at most one refinement pass, the geometric
multigrid V-cycle and the CG it preconditions (``MGContext``, ``mgpcg``),
the small solvers ``cg``/``pcg``/``jacobi_solve``, the boundary-aware
projection on cell flags (``project_masked_3d``), and the 2D open-box
projection (``project_2d``: 5-point stencil, the same spectral solve and
the same ndim-generic MG context, whose 2D V-cycles smooth with damped
Jacobi on every level, as the JAX package's do).

The V-cycles smooth with the red-black Gauss-Seidel kernels of
``ops/stencil_kernels.py`` on every level with at most 4 sweeps and at
least 16 cells an axis; coarser levels and the 40-sweep coarse solve are
damped Jacobi in plain torch. An ``MGContext`` built with ``rbgs=False``
smooths every level with damped Jacobi (the JAX package's V-cycle with
``use_rbgs`` off). The transfer operators are per-axis float32
matrices applied with ``tensordot`` (TF32 must be off, as ``Smoke3D``
sets it); the prolongation matrix equals a half-pixel-centre linear
resize, so the masked cycle uses the same matrices.

The JAX package runs its CG loops as device-side ``while_loop``s. Here the
loop is on the host and reads ONE scalar per iteration (the exit test);
the dots, ``max|r|`` and the residual history stay on the device. ``iters``
comes back as a host int; ``res`` and ``hist`` as device tensors, entries
of ``hist`` past ``iters`` staying -1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gpufluidsimulation_tpu_torch.ops import spectral, stencil_kernels


def divergence_2d(u, v):
    return (u[1:] - u[:-1]) + (v[:, 1:] - v[:, :-1])


def subtract_gradient_2d(u, v, p, bc):
    if bc == "neumann":
        u, v = u.clone(), v.clone()
        u[1:-1] += -(p[1:] - p[:-1])
        v[:, 1:-1] += -(p[:, 1:] - p[:, :-1])
        return u, v
    gp = F.pad(p, (0, 0, 1, 1))
    u = u - (gp[1:] - gp[:-1])
    gp = F.pad(p, (1, 1, 0, 0))
    v = v - (gp[:, 1:] - gp[:, :-1])
    return u, v


def divergence_3d(u, v, w):
    return ((u[1:] - u[:-1]) + (v[:, 1:] - v[:, :-1])
            + (w[:, :, 1:] - w[:, :, :-1]))


def subtract_gradient_3d(u, v, w, p, bc):
    if bc == "neumann":
        u, v, w = u.clone(), v.clone(), w.clone()
        u[1:-1] += -(p[1:] - p[:-1])
        v[:, 1:-1] += -(p[:, 1:] - p[:, :-1])
        w[:, :, 1:-1] += -(p[:, :, 1:] - p[:, :, :-1])
        return u, v, w
    gp = F.pad(p, (0, 0, 0, 0, 1, 1))
    u = u - (gp[1:] - gp[:-1])
    gp = F.pad(p, (0, 0, 1, 1, 0, 0))
    v = v - (gp[:, 1:] - gp[:, :-1])
    gp = F.pad(p, (1, 1, 0, 0, 0, 0))
    w = w - (gp[:, :, 1:] - gp[:, :, :-1])
    return u, v, w


def _neighbor_sum(p, bc):
    """Sum of the axis neighbours: edge replication encodes Neumann, zero
    padding Dirichlet ghosts."""
    total = torch.zeros_like(p)
    for axis in range(p.dim()):
        n = p.shape[axis]
        if bc == "neumann":
            lo = p.narrow(axis, 0, 1)
            hi = p.narrow(axis, n - 1, 1)
        else:
            lo = torch.zeros_like(p.narrow(axis, 0, 1))
            hi = lo
        pp = torch.cat([lo, p, hi], dim=axis)
        total = total + pp.narrow(axis, 0, n) + pp.narrow(axis, 2, n)
    return total


def laplacian(p, bc):
    """L p = (2*ndim) p - neighbour sum."""
    return (2 * p.dim()) * p - _neighbor_sum(p, bc)


# ---------------------------------------------------------------------------
# Jacobi smoothing and the geometric multigrid
# ---------------------------------------------------------------------------


def _diag(shape, bc):
    """Diagonal of L as a numpy array (neighbour count for Neumann,
    2*ndim for Dirichlet)."""
    ndim = len(shape)
    if bc == "dirichlet":
        return np.float32(2 * ndim) * np.ones(shape, np.float32)
    d = np.zeros(shape, np.float32)
    for axis in range(ndim):
        cnt = np.full(shape[axis], 2.0, np.float32)
        cnt[0] = 1.0
        cnt[-1] = 1.0
        bshape = [1] * ndim
        bshape[axis] = shape[axis]
        d = d + cnt.reshape(bshape)
    return d


def jacobi_smooth(x, b, bc, diag, iters, omega=0.8):
    """Damped Jacobi x <- x + omega D^-1 (b - L x)."""
    for _ in range(int(iters)):
        x = x + omega * (b - laplacian(x, bc)) / diag
    return x


def _coarse_shape(shape):
    return tuple(max((n + 1) // 2, 2) for n in shape)


def mg_shapes(shape, min_size=8, max_levels=8):
    """Level list, coarsened until every axis <= min_size."""
    shapes = [tuple(shape)]
    while len(shapes) < max_levels and max(shapes[-1]) > min_size:
        nxt = _coarse_shape(shapes[-1])
        if nxt == shapes[-1]:
            break
        shapes.append(nxt)
    return shapes


def _restrict_matrix(fn, cn):
    """Per-axis mean-pool-2x restriction as a (cn, fn) matrix, edge-padded
    for odd sizes."""
    m = np.zeros((cn, fn), np.float32)
    for c in range(cn):
        m[c, min(2 * c, fn - 1)] += 0.5
        m[c, min(2 * c + 1, fn - 1)] += 0.5
    return m


def _prolong_matrix(cn, fn):
    """Per-axis linear-interpolation prolongation as a (fn, cn) matrix
    with half-pixel centres (what a 'linear' image resize computes)."""
    m = np.zeros((fn, cn), np.float32)
    for i in range(fn):
        x = (i + 0.5) * cn / fn - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        a = min(max(x0, 0), cn - 1)
        b_ = min(max(x0 + 1, 0), cn - 1)
        m[i, a] += 1.0 - f
        m[i, b_] += f
    return m


def _apply_axis_mats(x, mats):
    """Contract x's three axes with three (out_n, in_n) matrices."""
    for axis, m in enumerate(mats):
        x = spectral._apply_axis(m, x, axis)
    return x.contiguous()


def _restrict_mats(fine, coarse, device):
    return tuple(torch.from_numpy(_restrict_matrix(f, c)).to(device)
                 for f, c in zip(fine, coarse))


def _prolong_mats(coarse, fine, device):
    return tuple(torch.from_numpy(_prolong_matrix(c, f)).to(device)
                 for c, f in zip(coarse, fine))


def restrict_full(r, coarse_shape):
    """Mean-pool 2x restriction with edge padding for odd sizes."""
    return _apply_axis_mats(r, _restrict_mats(r.shape, coarse_shape,
                                              r.device))


def prolong_linear(e, fine_shape):
    """Half-pixel-centre linear resize of `e` to `fine_shape`."""
    return _apply_axis_mats(e, _prolong_mats(e.shape, fine_shape, e.device))


def _use_rbgs(shape, iters, rbgs=True):
    """The levels that smooth with the red-black Gauss-Seidel kernels:
    none when `rbgs` is False."""
    return rbgs and iters <= 4 and len(shape) == 3 and min(shape) >= 16


class MGContext:
    """Per-(shape, bc, device) level shapes, Jacobi diagonals and per-axis
    restriction/prolongation matrices, for a 3D or a 2D grid. ``rbgs=False``
    smooths every level of its V-cycles (plain and masked) with damped
    Jacobi; 2D levels always do (``_use_rbgs``)."""

    def __init__(self, shape, bc, device=None, rbgs=True):
        if bc not in ("dirichlet", "neumann"):
            raise NotImplementedError(f"MGContext: unsupported bc {bc!r}")
        if len(shape) not in (2, 3):
            raise NotImplementedError(f"MGContext: a 2D or 3D shape, got "
                                      f"{tuple(shape)}")
        self.bc = bc
        self.rbgs = bool(rbgs)
        self.shapes = mg_shapes(shape)
        self.diags = [torch.from_numpy(_diag(s, bc)).to(device)
                      for s in self.shapes]
        pairs = list(zip(self.shapes[:-1], self.shapes[1:]))
        self.rmats = [_restrict_mats(fs, cs, device) for fs, cs in pairs]
        self.pmats = [_prolong_mats(cs, fs, device) for fs, cs in pairs]

    def _smooth(self, x, b, level, iters, omega, reverse=False):
        """Per-level smoother; ``x=None`` is an exactly-zero guess."""
        if _use_rbgs(self.shapes[level], iters, self.rbgs):
            return stencil_kernels.rbgs_smooth(x, b, self.bc, iters,
                                               reverse=reverse)
        if x is None:
            x = torch.zeros_like(b)
        return jacobi_smooth(x, b, self.bc, self.diags[level], iters, omega)

    def v_cycle(self, r, level=0, n_pre=2, n_post=2, n_coarse=40, omega=0.8):
        """Approximately solve L e = r; returns e. The residual is scaled
        by 4 per level for the unscaled stencil under 2x coarsening."""
        bc = self.bc
        if level == len(self.shapes) - 1:
            return self._smooth(None, r, level, n_coarse, omega)
        e = self._smooth(None, r, level, n_pre, omega)
        rr = r - laplacian(e, bc)
        rc = 4.0 * _apply_axis_mats(rr, self.rmats[level])
        ec = self.v_cycle(rc, level + 1, n_pre, n_post, n_coarse, omega)
        e = e + _apply_axis_mats(ec, self.pmats[level])
        # black-then-red post sweeps: the cycle equals its own transpose,
        # as the outer CG assumes of its preconditioner
        return self._smooth(e, r, level, n_post, omega, reverse=True)


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def _dot(a, b):
    return torch.sum(a * b, dtype=torch.float32)


def _scalar(value, like):
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def _pcg_loop(b, apply_A, precond, tol, max_iters, project=None):
    """Preconditioned CG on A p = b from p = 0 with the exit test
    max|r| > tol * max|b| read on the host once per iteration. `project`
    (the Neumann mean subtraction) is applied to r after each update.
    Returns (p, iters, res, hist)."""
    max_iters = int(max_iters)
    tiny = _scalar(1e-30, b)
    b_inf = torch.maximum(b.abs().max(), tiny)
    thresh = _scalar(tol, b) * b_inf
    p = torch.zeros_like(b)
    r = b
    z = precond(r)
    s = z
    rz = _dot(r, z)
    hist = torch.full((max_iters,), -1.0, dtype=torch.float32,
                      device=b.device)
    k = 0
    while k < max_iters and bool(r.abs().max() > thresh):
        As = apply_A(s)
        alpha = rz / torch.maximum(_dot(s, As), tiny)
        p = p + alpha * s
        r = r - alpha * As
        if project is not None:
            r = project(r)
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.maximum(rz, tiny)
        s = z + beta * s
        rz = rz_new
        hist[k] = r.abs().max() / b_inf
        k += 1
    return p, k, r.abs().max() / b_inf, hist


def _mean_free(x):
    return x - torch.mean(x)


def mgpcg(b, ctx: MGContext, tol=1e-6, max_iters=100):
    """MG-preconditioned CG on L p = b. Returns (p, iters, rel_res_inf,
    hist); hist[k] is the relative residual after iteration k+1."""
    if ctx.bc != "neumann":
        return _pcg_loop(b, lambda s: laplacian(s, ctx.bc), ctx.v_cycle, tol,
                         max_iters)
    return _pcg_loop(_mean_free(b), lambda s: laplacian(s, ctx.bc),
                     lambda r: _mean_free(ctx.v_cycle(r)), tol, max_iters,
                     project=_mean_free)


def cg(b, bc, tol=1e-6, max_iters=400):
    """Plain CG. Returns (p, iters, rel_res_inf)."""
    if bc == "neumann":
        b = _mean_free(b)
    p, iters, res, _ = _pcg_loop(b, lambda s: laplacian(s, bc), lambda r: r,
                                 tol, max_iters)
    return p, iters, res


def pcg(b, bc, tol=1e-6, max_iters=400, order=3, omega=0.8):
    """PCG with the truncated-Neumann (k-step damped-Jacobi) polynomial
    preconditioner. Returns (p, iters, rel_res_inf)."""
    neumann = bc == "neumann"
    if neumann:
        b = _mean_free(b)
    diag = torch.from_numpy(_diag(tuple(b.shape), bc)).to(b.device)

    def precond(r):
        x = omega * r / diag
        for _ in range(order - 1):
            x = x + omega * (r - laplacian(x, bc)) / diag
        return _mean_free(x) if neumann else x

    p, iters, res, _ = _pcg_loop(
        b, lambda s: laplacian(s, bc), precond, tol, max_iters,
        project=_mean_free if neumann else None)
    return p, iters, res


def jacobi_solve(b, bc, iters=100):
    """Plain Jacobi projection solver from a zero guess."""
    diag = torch.from_numpy(_diag(tuple(b.shape), bc)).to(b.device)
    return jacobi_smooth(torch.zeros_like(b), b, bc, diag, iters, omega=1.0)


def _spectral_solve(b, bc, tol, max_iters):
    """Direct eigenbasis solve with the (p, iters, res, hist) contract of
    the JAX package. The relative residual is measured against the stencil
    operator; if it exceeds `tol`, ONE refinement pass p += solve(r) runs.
    The branch is taken on the host (one sync); `iters` is a host int."""
    sctx = spectral.get_context(tuple(b.shape), bc, b.device)
    if bc == "neumann":
        b = b - torch.mean(b)
    b_inf = torch.clamp(b.abs().max(), min=1e-30)
    p = sctx.solve(b)
    r = b - laplacian(p, bc)
    res0 = r.abs().max() / b_inf
    refine = bool(res0 > tol)
    if refine:
        p = p + sctx.solve(r)
        r = b - laplacian(p, bc)
    res = r.abs().max() / b_inf
    hist = torch.full((int(max_iters),), -1.0, dtype=torch.float32,
                      device=b.device)
    hist[0] = res0
    if refine and int(max_iters) > 1:
        hist[1] = res
    return p, 1 + int(refine), res, hist


def _solve(b, bc, tol, max_iters, ctx):
    """The spectral solve without an ``MGContext``, MG-PCG with one."""
    if ctx is None:
        return _spectral_solve(b, bc, tol, max_iters)
    if ctx.bc != bc:
        raise ValueError(f"ctx is for bc {ctx.bc!r}, asked for {bc!r}")
    return mgpcg(b, ctx, tol, max_iters)


def project_2d(u, v, bc="dirichlet", tol=1e-6, max_iters=200, ctx=None):
    """Solve L p = -div (5-point stencil) and subtract the face gradients;
    the spectral solve, or MG-PCG with an ``MGContext`` as `ctx`. Returns
    (u, v, p, iters, res)."""
    p, iters, res, _ = _solve(-divergence_2d(u, v), bc, tol, max_iters, ctx)
    u, v = subtract_gradient_2d(u, v, p, bc)
    return u, v, p, iters, res


def project_3d(u, v, w, bc="dirichlet", tol=1e-4, max_iters=100, ctx=None):
    """Solve L p = -div and subtract the face gradients. With an
    ``MGContext`` as `ctx` the solve is MG-PCG; without one it is the
    direct spectral solve. Returns (u, v, w, p, iters, res, hist)."""
    p, iters, res, hist = _solve(-divergence_3d(u, v, w), bc, tol,
                                 max_iters, ctx)
    u, v, w = subtract_gradient_3d(u, v, w, p, bc)
    return u, v, w, p, iters, res, hist


# ---------------------------------------------------------------------------
# Boundary-aware (masked) projection on cell flags: 0 fluid, 1 air
# (Dirichlet p = 0), 2 domain solid, 3 moving solid object. Flags are
# integer tensors; the projection carries them as uint8 (one byte a cell
# for the smoother kernel).
# ---------------------------------------------------------------------------

FLUID, AIR = stencil_kernels.FLUID, stencil_kernels.AIR
SOLID, OBJECT = 2, 3
_open_neighbours = stencil_kernels.open_neighbours


def masked_laplacian(p, flags, count=None):
    """L p on fluid rows: sum over neighbours of (p_c - p_n) for fluid
    neighbours, + p_c for air neighbours (ghost p = 0), + 0 for solid
    neighbours, evaluated as (#fluid-or-air neighbours) p_c - sum of fluid
    p_n. Non-fluid rows return p (identity), so the operator stays SPD on
    the full lattice. `count` is ``_open_neighbours(flags)`` when the
    caller has it."""
    fluid = flags == FLUID
    if count is None:
        count = _open_neighbours(flags)
    nb = stencil_kernels.neighbour_sum(torch.where(fluid, p, 0.0))
    return torch.where(fluid, count * p - nb, p)


def masked_divergence_3d(u, v, w, flags, u_solid, v_solid, w_solid):
    """MAC divergence with solid-face velocities overridden by the boundary
    velocity; zero on non-fluid cells. Returns (div, ue, ve, we)."""
    solid = (flags == SOLID) | (flags == OBJECT)

    def face_sub(vel, vel_solid, axis):
        # the face between cells c-1 and c is solid if either side is;
        # outside the field is solid
        face_solid = _face_or(solid, axis, True)
        return torch.where(face_solid, vel_solid, vel)

    ue = face_sub(u, u_solid, 0)
    ve = face_sub(v, v_solid, 1)
    we = face_sub(w, w_solid, 2)
    div = divergence_3d(ue, ve, we)
    return torch.where(flags == FLUID, div, 0.0), ue, ve, we


def _face_sides(cell, axis, fill):
    """(lower-side, upper-side) cell values at every face along `axis`,
    with `fill` outside the field."""
    edge = list(cell.shape)
    edge[axis] = 1
    pad = torch.full(edge, fill, dtype=cell.dtype, device=cell.device)
    return (torch.cat([pad, cell], dim=axis), torch.cat([cell, pad], dim=axis))


def _face_or(cell_mask, axis, fill):
    lo, hi = _face_sides(cell_mask, axis, fill)
    return lo | hi


def coarsen_flags(flags, coarse_shape):
    """2x coarsening of the cell flags for the masked hierarchy: a coarse
    cell is AIR if any child is air (Dirichlet dominates), else FLUID if
    any child is fluid, else solid. Odd sizes are edge-padded."""
    fp = flags
    for axis, (n, cn) in enumerate(zip(flags.shape, coarse_shape)):
        if 2 * cn > n:
            last = fp.narrow(axis, n - 1, 1)
            fp = torch.cat([fp] + [last] * (2 * cn - n), dim=axis)
    newshape = []
    for cn in coarse_shape:
        newshape.extend([cn, 2])
    fp = fp.reshape(newshape)
    any_air = (fp == AIR).to(torch.uint8).amax(dim=(1, 3, 5)).bool()
    any_fluid = (fp == FLUID).to(torch.uint8).amax(dim=(1, 3, 5)).bool()
    out = torch.where(any_air, AIR, torch.where(any_fluid, FLUID, SOLID))
    return out.to(flags.dtype)


def _masked_diag(flags, count=None):
    """Row diagonal of masked_laplacian: (# fluid or air neighbours), at
    least 1, on fluid rows; 1 on identity (non-fluid) rows."""
    if count is None:
        count = _open_neighbours(flags)
    return torch.where(flags == FLUID, torch.clamp(count, min=1.0), 1.0)


def masked_jacobi_smooth(x, b, flags, diag, iters, omega=0.8, count=None):
    """Damped Jacobi on the masked operator; `diag` is ``_masked_diag``."""
    if count is None:
        count = _open_neighbours(flags)
    for _ in range(int(iters)):
        x = x + omega * (b - masked_laplacian(x, flags, count)) / diag
    return x


def _masked_smooth(x, r, flags, diag, iters, omega, shape, reverse=False,
                   count=None, rbgs=True):
    """Per-level masked smoother: the masked red-black Gauss-Seidel kernel
    on the fine levels (unless `rbgs` is False), masked damped Jacobi
    elsewhere. ``x=None`` is an exactly-zero guess."""
    if _use_rbgs(shape, iters, rbgs):
        return stencil_kernels.masked_rbgs_smooth(x, r, flags, iters,
                                                  reverse=reverse)
    if x is None:
        x = torch.zeros_like(r)
    return masked_jacobi_smooth(x, r, flags, diag, iters, omega, count)


def build_masked_hierarchy(flags, shapes):
    """Per-level (flags, diagonals, open-neighbour counts) of the masked
    operator, coarsened from `flags`; the boundary moves every frame, so
    this is rebuilt per projection."""
    flag_levels = [flags]
    for s in shapes[1:]:
        flag_levels.append(coarsen_flags(flag_levels[-1], s))
    count_levels = [_open_neighbours(f) for f in flag_levels]
    diag_levels = [_masked_diag(f, c)
                   for f, c in zip(flag_levels, count_levels)]
    return flag_levels, diag_levels, count_levels


def masked_v_cycle(r, hierarchy, ctx: MGContext, level=0, n_pre=2, n_post=2,
                   n_coarse=40, omega=0.8):
    """Boundary-aware V-cycle on the masked operator; `hierarchy` is
    ``build_masked_hierarchy``'s result for ``ctx.shapes``. r and e are
    masked to the fluid cells around every smoother call."""
    flags = hierarchy[0][level]
    diag = hierarchy[1][level]
    count = hierarchy[2][level]
    shapes = ctx.shapes
    fluid = flags == FLUID
    r = torch.where(fluid, r, 0.0)
    if level == len(shapes) - 1:
        e = masked_jacobi_smooth(torch.zeros_like(r), r, flags, diag,
                                 n_coarse, omega, count)
        return torch.where(fluid, e, 0.0)
    e = _masked_smooth(None, r, flags, diag, n_pre, omega, shapes[level],
                       count=count, rbgs=ctx.rbgs)
    rr = torch.where(fluid, r - masked_laplacian(e, flags, count), 0.0)
    rc = 4.0 * _apply_axis_mats(rr, ctx.rmats[level])
    ec = masked_v_cycle(rc, hierarchy, ctx, level + 1, n_pre, n_post,
                        n_coarse, omega)
    e = e + _apply_axis_mats(ec, ctx.pmats[level])
    e = _masked_smooth(e, r, flags, diag, n_post, omega, shapes[level],
                       reverse=True, count=count, rbgs=ctx.rbgs)
    return torch.where(fluid, e, 0.0)


def project_masked_3d(u, v, w, flags, u_solid, v_solid, w_solid,
                      ctx: MGContext, tol=1e-4, max_iters=100):
    """Pressure projection with voxel boundary conditions: CG on the
    masked operator, preconditioned by the masked V-cycle. After the
    solve the gradient is subtracted on faces with a fluid side and no
    solid side, and solid-adjacent faces take the boundary velocity.
    Returns (u, v, w, p, iters, res, hist)."""
    flags = flags.to(torch.uint8).contiguous()
    div, ue, ve, we = masked_divergence_3d(u, v, w, flags, u_solid, v_solid,
                                           w_solid)
    hierarchy = build_masked_hierarchy(flags, ctx.shapes)
    count = hierarchy[2][0]
    p, iters, res, hist = _pcg_loop(
        -div, lambda s: masked_laplacian(s, flags, count),
        lambda r: masked_v_cycle(r, hierarchy, ctx), tol, max_iters)
    fluid = flags == FLUID
    solid = (flags == SOLID) | (flags == OBJECT)
    p = torch.where(fluid, p, 0.0)

    def update_faces(vel, vel_solid, axis):
        p_m, p_p = _face_sides(p, axis, 0.0)
        any_fluid = _face_or(fluid, axis, False)
        any_solid = _face_or(solid, axis, True)
        vel = torch.where(any_fluid & ~any_solid, vel - (p_p - p_m), vel)
        return torch.where(any_solid, vel_solid, vel)

    return (update_faces(ue, u_solid, 0), update_faces(ve, v_solid, 1),
            update_faces(we, w_solid, 2), p, iters, res, hist)
