"""Pressure projection, spectral branch (3D).

Counterpart of ``gpufluidsimulation_tpu.ops.poisson``: MAC divergence and
gradient in grid units, the unscaled Laplacian L p = 6p - sum(nbrs), and
``project_3d`` through the direct spectral solve with at most one
refinement pass. The MG-PCG branch is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpufluidsimulation_tpu_torch.ops import spectral


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


def project_3d(u, v, w, bc="dirichlet", tol=1e-4, max_iters=100):
    """Solve L p = -div and subtract the face gradients. Returns
    (u, v, w, p, iters, res, hist)."""
    div = divergence_3d(u, v, w)
    p, iters, res, hist = _spectral_solve(-div, bc, tol, max_iters)
    u, v, w = subtract_gradient_3d(u, v, w, p, bc)
    return u, v, w, p, iters, res, hist
