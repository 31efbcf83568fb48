"""Stencil kernels and their plain versions: the Jacobi viscosity sweep
and the two red-black Gauss-Seidel smoothers of the multigrid V-cycles.

Counterpart of ``gpufluidsimulation_tpu.ops.pallas_kernels``.

``jacobi_diffuse`` runs ``iters`` damped-Jacobi sweeps of
(I + coef*L) x = b with the boundary ring held; on a CUDA tensor the sweeps
go in launches of ``SWEEPS_PER_LAUNCH`` and one of the remainder
(``sweep_chunks``), each of ``csrc/jacobi_diffuse.cu`` into a ping-pong
buffer.

``rbgs_smooth`` and ``masked_rbgs_smooth`` run ``iters`` red+black
Gauss-Seidel sweeps of L x = b (``ops.poisson.laplacian`` and
``ops.poisson.masked_laplacian``); on a CUDA tensor the 2*iters colour
half-sweeps go in launches of ``LEVELS_PER_LAUNCH`` and one of the
remainder (``level_chunks``), each of ``csrc/rbgs_smooth.cu`` or
``csrc/masked_rbgs_smooth.cu`` out of place into a ping-pong buffer: the
V-cycle's 2-sweep call is one launch.

On a CPU tensor every wrapper takes its plain version. ``<wrapper>.launches``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gpufluidsimulation_tpu_torch.core.grids import band_mask
from gpufluidsimulation_tpu_torch.ops import _build


def _coefs(coef):
    """float32 (coef, denom) with denom = 1 + 6*coef rounded once, as the
    JAX code's Python-float constants are."""
    return float(np.float32(coef)), float(np.float32(1.0 + 6.0 * coef))


def jacobi_diffuse_plain(x, b, iters, coef):
    """Plain version: the neighbour sum in forces.diffuse_3d's order
    (x-, x+, y-, y+, z-, z+)."""
    coef_f, denom_f = _coefs(coef)
    coef_t = torch.full((), coef_f, dtype=x.dtype, device=x.device)
    denom_t = torch.full((), denom_f, dtype=x.dtype, device=x.device)
    interior = band_mask(x.shape, (1, 1, 1), (2, 2, 2), x.device)
    nx, ny, nz = x.shape
    for _ in range(int(iters)):
        xp = torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 1))
        nb = (xp[0:nx, 1:ny + 1, 1:nz + 1] + xp[2:nx + 2, 1:ny + 1, 1:nz + 1]
              + xp[1:nx + 1, 0:ny, 1:nz + 1] + xp[1:nx + 1, 2:ny + 2, 1:nz + 1]
              + xp[1:nx + 1, 1:ny + 1, 0:nz] + xp[1:nx + 1, 1:ny + 1, 2:nz + 2])
        x = torch.where(interior, (b + coef_t * nb) / denom_t, x)
    return x


# sweeps per launch of the temporally blocked kernel (kSweeps in
# csrc/jacobi_diffuse.cu, which builds only this count and 1), chosen by
# measurement at 257x256x256 among 2, 4 and 8 (PERF.md, row 11)
SWEEPS_PER_LAUNCH = 2


def sweep_chunks(iters, per_launch=SWEEPS_PER_LAUNCH):
    """The sweeps of each launch of an `iters`-sweep solve: full chunks of
    `per_launch`, then the remainder as one shorter launch."""
    full, rest = divmod(int(iters), int(per_launch))
    return [int(per_launch)] * full + ([rest] if rest else [])


def jacobi_diffuse(x, b, iters, coef):
    """`iters` damped-Jacobi sweeps for (I + coef*L) x = b, interior only;
    on the card ``SWEEPS_PER_LAUNCH`` sweeps a launch (``sweep_chunks``)."""
    if not _build.on_card(x, "jacobi_diffuse"):
        return jacobi_diffuse_plain(x, b, iters, coef)
    _build.require(x, "x", ndim=3)
    _build.require(b, "b", shape=x.shape)
    if b.device != x.device:
        raise ValueError("jacobi_diffuse: x and b on different devices")
    if x.numel() >= 2 ** 31:
        raise ValueError("jacobi_diffuse: int32 indexing needs fewer than "
                         f"2^31 cells, got {x.numel()}")
    coef_f, denom_f = _coefs(coef)
    if not 1.0 <= denom_f <= 2.0 ** 20:
        raise ValueError("jacobi_diffuse: the kernel takes 0 <= coef with "
                         f"1 + 6*coef <= 2^20, got coef {coef}")
    fn = _build.function(
        "jacobi_diffuse", "gfs_jacobi_diffuse",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p])
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    src = x
    with torch.cuda.device(x.device):
        for n, sweeps in enumerate(sweep_chunks(iters)):
            dst = bufs[n % 2]
            err = fn(_build.ptr(src), _build.ptr(b), *x.shape, coef_f,
                     denom_f, sweeps, _build.ptr(dst), _build.stream(x))
            _build.check(err, "jacobi_diffuse")
            jacobi_diffuse.launches += 1
            src = dst
    return src


jacobi_diffuse.launches = 0


# ---------------------------------------------------------------------------
# Red-black Gauss-Seidel smoothers
# ---------------------------------------------------------------------------


def _red_mask(shape, device):
    """(i + j + k) even, in global indices."""
    nx, ny, nz = shape
    ii = torch.arange(nx, device=device)[:, None, None]
    jj = torch.arange(ny, device=device)[None, :, None]
    kk = torch.arange(nz, device=device)[None, None, :]
    return (ii + jj + kk) % 2 == 0


def neighbour_sum(x):
    """((((((0 + x[i+1]) + x[i-1]) + x[j+1]) + x[j-1]) + x[k+1]) + x[k-1])
    with zero ghosts: the order of the JAX smoothers and of the kernels."""
    nx, ny, nz = x.shape
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1, 1, 1))
    c = (slice(1, nx + 1), slice(1, ny + 1), slice(1, nz + 1))
    total = torch.zeros_like(x)
    total = total + xp[2:nx + 2, c[1], c[2]]
    total = total + xp[0:nx, c[1], c[2]]
    total = total + xp[c[0], 2:ny + 2, c[2]]
    total = total + xp[c[0], 0:ny, c[2]]
    total = total + xp[c[0], c[1], 2:nz + 2]
    total = total + xp[c[0], c[1], 0:nz]
    return total


def _structural_diag(shape, bc, device):
    """Diagonal of L: 6 for Dirichlet (a 0-dim tensor, so that the division
    is a true division on the card too), the count of in-domain neighbours
    for Neumann."""
    if bc != "neumann":
        return torch.full((), 6.0, dtype=torch.float32, device=device)
    d = torch.zeros(shape, dtype=torch.float32, device=device)
    for axis, n in enumerate(shape):
        cnt = torch.full((n,), 2.0, dtype=torch.float32, device=device)
        cnt[0] -= 1.0
        cnt[-1] -= 1.0
        bshape = [1, 1, 1]
        bshape[axis] = n
        d = d + cnt.reshape(bshape)
    return d


def _gs_sweeps(x, b, diag, update, iters, reverse):
    """`iters` sweeps; `update` restricts the cells that change (None =
    all). Red first, or black first when `reverse`."""
    red = _red_mask(b.shape, b.device)
    colours = (~red, red) if reverse else (red, ~red)
    if update is not None:
        colours = tuple(c & update for c in colours)
    for _ in range(int(iters)):
        for colour in colours:
            x = torch.where(colour, (neighbour_sum(x) + b) / diag, x)
    return x


def rbgs_smooth_plain(x, b, bc, iters, reverse=False):
    """Plain version of ``rbgs_smooth``."""
    if x is None:
        x = torch.zeros_like(b)
    return _gs_sweeps(x, b, _structural_diag(b.shape, bc, b.device), None,
                      iters, reverse)


# colour levels (half-sweeps) per launch of the two smoothers (kLevels in
# csrc/gs_wavefront.cuh, whose kernels build only this count and 2): the
# V-cycle's 2-sweep call in one launch (PERF.md, rows 10 and 12)
LEVELS_PER_LAUNCH = 4


def level_chunks(iters, per_launch=LEVELS_PER_LAUNCH):
    """The colour levels of each launch of an `iters`-sweep smoother call:
    2*iters levels in full launches of `per_launch`, then the remainder as
    one shorter launch. Every chunk is even, so each launch starts with the
    call's first colour."""
    return sweep_chunks(2 * int(iters), per_launch)


def _launch_levels(wrapper, name, fn, x, b, extra, iters, reverse):
    """The launches of one smoother call: the first from `x` (None =
    exactly zero), each out of place into one of two buffers. `extra` are
    the arguments between b and the colour (the shape and the bc flag, or
    the flags pointer and the shape)."""
    chunks = level_chunks(iters)
    bufs = [torch.empty_like(b) for _ in range(min(2, len(chunks)))]
    src = None if x is None else _build.ptr(x)
    with torch.cuda.device(b.device):
        stream = _build.stream(b)
        for n, levels in enumerate(chunks):
            dst = bufs[n % 2]
            err = fn(src, _build.ptr(b), *extra, int(bool(reverse)), levels,
                     _build.ptr(dst), stream)
            _build.check(err, name)
            wrapper.launches += 1
            src = _build.ptr(dst)
    return bufs[(len(chunks) - 1) % 2]


def _require_pair(name, x, b):
    _build.require(b, "b", ndim=3)
    if b.numel() >= 2 ** 31:
        raise ValueError(f"{name}: 32-bit offsets need fewer than 2^31 "
                         f"cells, got {b.numel()}")
    if x is not None:
        _build.require(x, "x", shape=b.shape)
        if x.device != b.device:
            raise ValueError(f"{name}: x and b on different devices")


def rbgs_smooth(x, b, bc, iters, reverse=False):
    """`iters` red+black Gauss-Seidel sweeps of L x = b, L as in
    ``ops.poisson.laplacian`` for `bc` ('dirichlet' or 'neumann'):
    x <- (neighbour sum + b) / diag on one colour at a time, red =
    (i+j+k) even first, or black first when ``reverse`` (the V-cycle's
    post-smoother, which keeps the cycle a symmetric preconditioner).
    ``x=None`` is an exactly-zero initial guess and gives bit for bit the
    result of smoothing an explicit zeros tensor. Returns a new tensor."""
    if bc not in ("dirichlet", "neumann"):
        raise ValueError(f"rbgs_smooth: unsupported bc {bc!r}")
    if int(iters) < 1:
        raise ValueError("rbgs_smooth: iters must be at least 1")
    if not _build.on_card(b, "rbgs_smooth"):
        return rbgs_smooth_plain(x, b, bc, iters, reverse)
    _require_pair("rbgs_smooth", x, b)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("rbgs_smooth", "gfs_rbgs_smooth",
                         [P, P, I, I, I, I, I, I, P, P])
    extra = (*b.shape, int(bc == "neumann"))
    return _launch_levels(rbgs_smooth, "rbgs_smooth", fn, x, b, extra, iters,
                          reverse)


rbgs_smooth.launches = 0

FLUID, AIR = 0, 1


def open_neighbours(flags):
    """float32 count of fluid-or-air axis neighbours of every cell;
    outside the field counts as solid."""
    return neighbour_sum((flags <= AIR).to(torch.float32))


def masked_diag(flags):
    """Row diagonal of the masked operator on fluid rows: the number of
    fluid-or-air neighbours, at least 1."""
    return torch.clamp(open_neighbours(flags), min=1.0)


def masked_rbgs_smooth_plain(x, b, flags, iters, reverse=False):
    """Plain version of ``masked_rbgs_smooth``."""
    fluid = flags == FLUID
    x = torch.zeros_like(b) if x is None else torch.where(fluid, x, 0.0)
    return _gs_sweeps(x, b, masked_diag(flags), fluid, iters, reverse)


def masked_rbgs_smooth(x, b, flags, iters, reverse=False):
    """`iters` red+black Gauss-Seidel sweeps on the masked operator
    (``ops.poisson.masked_laplacian``): only fluid cells (flag 0) update,
    x <- (neighbour sum + b) / max(#fluid-or-air neighbours, 1); every
    other cell holds 0, whatever `x` held there. ``x=None`` is an
    exactly-zero initial guess. On the card `flags` is a uint8 tensor (one
    byte a cell). Returns a new tensor."""
    if int(iters) < 1:
        raise ValueError("masked_rbgs_smooth: iters must be at least 1")
    if not _build.on_card(b, "masked_rbgs_smooth"):
        return masked_rbgs_smooth_plain(x, b, flags, iters, reverse)
    _require_pair("masked_rbgs_smooth", x, b)
    if (flags.dtype != torch.uint8 or flags.device != b.device
            or tuple(flags.shape) != tuple(b.shape)
            or not flags.is_contiguous()):
        raise ValueError(
            "masked_rbgs_smooth: flags must be a contiguous uint8 tensor of "
            f"b's shape on b's device, got {flags.dtype} "
            f"{tuple(flags.shape)} on {flags.device}")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("masked_rbgs_smooth", "gfs_masked_rbgs_smooth",
                         [P, P, P, I, I, I, I, I, P, P])
    extra = (_build.ptr(flags), *b.shape)
    return _launch_levels(masked_rbgs_smooth, "masked_rbgs_smooth", fn, x, b,
                          extra, iters, reverse)


masked_rbgs_smooth.launches = 0
