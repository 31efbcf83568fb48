"""Jacobi viscosity kernel and its plain version.

Counterpart of ``gpufluidsimulation_tpu.ops.pallas_kernels`` (the
``jacobi_diffuse`` entry). ``jacobi_diffuse`` runs ``iters`` damped-Jacobi
sweeps of (I + coef*L) x = b with the boundary ring held; on a CUDA tensor
each sweep is one launch of ``csrc/jacobi_diffuse.cu`` into a ping-pong
buffer, on a CPU tensor the plain version runs. ``jacobi_diffuse.launches``
counts kernel launches (one per sweep).
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


def jacobi_diffuse(x, b, iters, coef):
    """`iters` damped-Jacobi sweeps for (I + coef*L) x = b, interior only."""
    if not _build.on_card(x, "jacobi_diffuse"):
        return jacobi_diffuse_plain(x, b, iters, coef)
    _build.require(x, "x", ndim=3)
    _build.require(b, "b", shape=x.shape)
    if b.device != x.device:
        raise ValueError("jacobi_diffuse: x and b on different devices")
    coef_f, denom_f = _coefs(coef)
    fn = _build.function(
        "jacobi_diffuse", "gfs_jacobi_diffuse",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
         ctypes.c_void_p])
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    src = x
    with torch.cuda.device(x.device):
        for s in range(int(iters)):
            dst = bufs[s % 2]
            err = fn(_build.ptr(src), _build.ptr(b), *x.shape, coef_f,
                     denom_f, _build.ptr(dst), _build.stream(x))
            _build.check(err, "jacobi_diffuse")
            jacobi_diffuse.launches += 1
            src = dst
    return src


jacobi_diffuse.launches = 0
