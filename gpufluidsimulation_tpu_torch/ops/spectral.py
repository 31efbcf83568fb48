"""Direct spectral Poisson solver: per-axis DST-I (Dirichlet) or DCT-II
(Neumann) eigenbases, six dense (n, n) contractions for a 3D volume.

Counterpart of ``gpufluidsimulation_tpu.ops.spectral``. The transform
matrices are built in numpy float64 and cast to float32 exactly as the JAX
package builds them. The contractions are plain float32 ``tensordot``s;
the solver requires TF32 off (``solvers/smoke3d.Smoke3D`` turns it off),
since TF32 would miss the ~1e-6 relative residual of the direct solve.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _dst1(n: int):
    """fwd[k, i] = sin(pi (i+1)(k+1)/(n+1)); inv = S^T 2/(n+1);
    lam[k] = 2 - 2 cos(pi (k+1)/(n+1))."""
    i = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    S = np.sin(np.pi * np.outer(k + 1, i + 1) / (n + 1))
    lam = 2.0 - 2.0 * np.cos(np.pi * (k + 1) / (n + 1))
    fwd = S.astype(np.float32)
    inv = (S.T * (2.0 / (n + 1))).astype(np.float32)
    return fwd, inv, lam.astype(np.float32)


def _dct2(n: int):
    """fwd[k, i] = cos(pi k (i+0.5)/n); inverse weights 1/n, 2/n;
    lam[k] = 2 - 2 cos(pi k/n), lam[0] = 0 the nullspace."""
    i = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    C = np.cos(np.pi * np.outer(k, i + 0.5) / n)
    lam = 2.0 - 2.0 * np.cos(np.pi * k / n)
    w = np.full(n, 2.0 / n)
    w[0] = 1.0 / n
    fwd = C.astype(np.float32)
    inv = (C.T * w[None, :]).astype(np.float32)
    return fwd, inv, lam.astype(np.float32)


def _apply_axis(m, x, axis):
    """Contract matrix m (out, in) against x's `axis`."""
    return torch.movedim(torch.tensordot(m, x, dims=([1], [axis])), 0, axis)


class SpectralContext:
    """Per-(shape, bc, device) transform matrices and eigenvalues."""

    def __init__(self, shape, bc: str, device=None):
        if bc not in ("dirichlet", "neumann"):
            raise NotImplementedError(f"spectral solver: unsupported bc {bc!r}")
        self.shape = tuple(int(n) for n in shape)
        self.bc = bc
        make = _dst1 if bc == "dirichlet" else _dct2
        mats = [make(n) for n in self.shape]
        self.fwd = [torch.from_numpy(m[0]).to(device) for m in mats]
        self.inv = [torch.from_numpy(m[1]).to(device) for m in mats]
        nd = len(self.shape)
        lam = torch.zeros((), dtype=torch.float32, device=device)
        for ax, m in enumerate(mats):
            bshape = [1] * nd
            bshape[ax] = len(m[2])
            lam = lam + torch.from_numpy(m[2]).to(device).reshape(bshape)
        self.lam = lam

    def solve(self, b):
        """Direct solve of L p = b (ops.poisson.laplacian's L); for
        'neumann' the nullspace (mean) component is projected out."""
        t = b
        for ax in range(b.dim()):
            t = _apply_axis(self.fwd[ax], t, ax)
        lam = self.lam
        t = torch.where(lam > 1e-12, t / torch.clamp(lam, min=1e-30), 0.0)
        for ax in range(b.dim()):
            t = _apply_axis(self.inv[ax], t, ax)
        return t.contiguous()


@functools.lru_cache(maxsize=16)
def get_context(shape, bc: str, device=None) -> SpectralContext:
    """Cached per-(shape, bc, device) context."""
    return SpectralContext(shape, bc, device)
