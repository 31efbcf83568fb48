"""MIC(0)-preconditioned conjugate gradient on the host: the PCGSolver
role.

Counterpart of ``gpufluidsimulation_tpu.ops.pcg``, and like it host code:
numpy in float64 (the reference's double path), taking numpy arrays or
tensors on the CPU and returning numpy. The reference declares an
incomplete-Cholesky PCG (``PCGSolver<T>`` with
``factor_modified_incomplete_cholesky0``) that its solvers never call;
the solvers project with MG-PCG (``ops.poisson.mgpcg``). MIC(0)'s
triangular solves are sequential over lexicographic wavefronts, so this
preconditioner is not a kernel of the card. The same knobs as the
reference (``set_solver_parameters(tolerance_factor, max_iterations,
mic_parameter, min_diagonal_ratio)``) and the same relative-residual
stopping rule (tol = tolerance_factor * |r|_inf). The recurrence is the
standard published MIC(0) for the MAC Poisson system (Bridson, "Fluid
Simulation for Computer Graphics", ch. 5).

The 7-point operator is matrix-free, given by cell `flags` (FLUID /
SOLID / AIR / OBJECT as in ``ops.poisson``): diag = the number of
non-solid neighbours, off-diagonal -1 toward each FLUID neighbour, the
zero-ghost form of ``ops.poisson.masked_laplacian``.
"""

from __future__ import annotations

import numpy as np
import torch

from gpufluidsimulation_tpu_torch.ops.poisson import FLUID, OBJECT, SOLID


def _host(a):
    """A numpy array of `a` (numpy, or a tensor on the CPU; a tensor on
    the card raises: this solver is host code)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"PCGSolver runs on the host; got a tensor on "
                             f"{a.device}")
        return a.numpy()
    return np.asarray(a)


def _neighbor_arrays(flags):
    """Per-cell diagonal and +axis off-diagonal entries of the Poisson
    operator (off[d][cell] = -1 iff cell and cell+e_d are both FLUID);
    SOLID walls and OBJECT obstacles are both Neumann."""
    fluid = flags == FLUID
    notsolid = (flags != SOLID) & (flags != OBJECT)
    diag = np.zeros(flags.shape, np.float64)
    offs = []
    for ax in range(flags.ndim):
        lo = [slice(None)] * flags.ndim
        hi = [slice(None)] * flags.ndim
        lo[ax] = slice(None, -1)
        hi[ax] = slice(1, None)
        lo, hi = tuple(lo), tuple(hi)
        # diagonal counts non-solid neighbors on both sides
        diag[lo] += notsolid[hi]
        diag[hi] += notsolid[lo]
        off = np.zeros(flags.shape, np.float64)
        off[lo] = np.where(fluid[lo] & fluid[hi], -1.0, 0.0)
        offs.append(off)
    diag[~fluid] = 1.0
    return diag, offs


def apply_poisson(x, flags):
    """y = A x for the flags-defined 7-point operator (FLUID rows only)."""
    diag, offs = _neighbor_arrays(flags)
    fluid = flags == FLUID
    y = diag * x
    for ax, off in enumerate(offs):
        lo = [slice(None)] * flags.ndim
        hi = [slice(None)] * flags.ndim
        lo[ax] = slice(None, -1)
        hi[ax] = slice(1, None)
        lo, hi = tuple(lo), tuple(hi)
        y[lo] += off[lo] * x[hi]
        y[hi] += off[lo] * x[lo]
    y[~fluid] = 0.0
    return y


def form_mic0(flags, mic_parameter=0.97, min_diagonal_ratio=0.25):
    """MIC(0) diagonal `precon` (1/sqrt of the modified pivot) for the
    flags-defined Poisson operator. Standard recurrence: each pivot is the
    operator diagonal minus the squared scaled entries of already-factored
    backward neighbors, minus `mic_parameter` times their fill-in row sums;
    pivots below `min_diagonal_ratio` * diag are reset to diag (the safety
    fallback the reference exposes through the same two knobs)."""
    diag, offs = _neighbor_arrays(flags)
    fluid = flags == FLUID
    shape = flags.shape
    nd = flags.ndim
    precon = np.zeros(shape, np.float64)
    tau, sigma = float(mic_parameter), float(min_diagonal_ratio)

    def back(idx, ax):
        j = list(idx)
        j[ax] -= 1
        return tuple(j) if j[ax] >= 0 else None

    for idx in np.ndindex(*shape):
        if not fluid[idx]:
            continue
        e = diag[idx]
        for ax in range(nd):
            b = back(idx, ax)
            if b is None or not fluid[b]:
                continue
            a = offs[ax][b]  # entry linking b -> idx
            pe = precon[b]
            e -= (a * pe) ** 2
            # modified IC: subtract tau * (row fill-in) — the other
            # off-diagonals of the backward neighbor's row
            others = 0.0
            for ax2 in range(nd):
                if ax2 != ax:
                    others += offs[ax2][b]
            e -= tau * (a * others * pe * pe)
        if e < sigma * diag[idx]:
            e = diag[idx]
        precon[idx] = 1.0 / np.sqrt(e + 1e-30)
    return precon


def apply_mic0(r, flags, precon, offs=None):
    """z = M^-1 r: forward substitution L q = r then backward L^T z = q,
    with L's rows scaled by `precon` (solve_lower /
    solve_lower_transpose_in_place roles, pcg_solver.h:193-228)."""
    if offs is None:
        _, offs = _neighbor_arrays(flags)
    fluid = flags == FLUID
    shape = flags.shape
    nd = flags.ndim
    q = np.zeros(shape, np.float64)
    for idx in np.ndindex(*shape):
        if not fluid[idx]:
            continue
        t = r[idx]
        for ax in range(nd):
            j = list(idx)
            j[ax] -= 1
            if j[ax] < 0:
                continue
            b = tuple(j)
            if fluid[b]:
                t -= offs[ax][b] * precon[b] * q[b]
        q[idx] = t * precon[idx]
    z = np.zeros(shape, np.float64)
    for idx in reversed(list(np.ndindex(*shape))):
        if not fluid[idx]:
            continue
        t = q[idx]
        for ax in range(nd):
            j = list(idx)
            j[ax] += 1
            if j[ax] >= shape[ax]:
                continue
            f = tuple(j)
            if fluid[f]:
                t -= offs[ax][idx] * precon[idx] * z[f]
        z[idx] = t * precon[idx]
    return z


class PCGSolver:
    """Host-side MIC(0)-PCG with the reference's parameter surface
    (pcg_solver.h:229-298). `solve(flags, rhs)` returns
    (x, residual, iterations, success)."""

    def __init__(self):
        self.set_solver_parameters()

    def set_solver_parameters(self, tolerance_factor=1e-12,
                              max_iterations=100,
                              modified_incomplete_cholesky_parameter=0.97,
                              min_diagonal_ratio=0.25):
        self.tolerance_factor = tolerance_factor
        self.max_iterations = max_iterations
        self.mic_parameter = modified_incomplete_cholesky_parameter
        self.min_diagonal_ratio = min_diagonal_ratio

    def solve(self, flags, rhs):
        flags = _host(flags)
        rhs = _host(rhs)
        fluid = flags == FLUID
        r = np.where(fluid, np.asarray(rhs, np.float64), 0.0)
        x = np.zeros_like(r)
        res0 = np.max(np.abs(r)) if r.size else 0.0
        if res0 == 0.0:
            return x, 0.0, 0, True
        tol = self.tolerance_factor * res0
        precon = form_mic0(flags, self.mic_parameter,
                           self.min_diagonal_ratio)
        _, offs = _neighbor_arrays(flags)
        z = apply_mic0(r, flags, precon, offs)
        s = z.copy()
        rho = float(np.sum(z * r))
        residual = res0
        for it in range(1, self.max_iterations + 1):
            az = apply_poisson(s, flags)
            denom = float(np.sum(s * az))
            if denom == 0.0:
                return x, residual, it, False
            alpha = rho / denom
            x += alpha * s
            r -= alpha * az
            residual = float(np.max(np.abs(r)))
            if residual <= tol:
                return x, residual, it, True
            z = apply_mic0(r, flags, precon, offs)
            rho_new = float(np.sum(z * r))
            beta = rho_new / rho
            s = z + beta * s
            rho = rho_new
        return x, residual, self.max_iterations, False
