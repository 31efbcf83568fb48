"""MAC-grid descriptors (the 3D and 2D conventions of
``gpufluidsimulation_tpu``).

3D: cell centers sit at world position ``i*h``; a staggered field's own
nodes sit at ``(i - 0.5*dim)*h`` per axis (u at -0.5h in x, v in y, w in
z). Fields are float32 tensors of shape (ni[+1], nj[+1], nk[+1]), k
fastest.

2D (``Grid2D``, the 2D reference's conventions): a field's nodes sit at
``(i + off)*h`` with off (0.5, 0.5) for cells, (0, 0.5) for u and
(0.5, 0) for v; u is (ni+1, nj), v (ni, nj+1), c (ni, nj).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from gpufluidsimulation_tpu_torch.config import DTYPE

Offset3 = Tuple[float, float, float]

_DIMS = {"c": (0, 0, 0), "u": (1, 0, 0), "v": (0, 1, 0), "w": (0, 0, 1)}


def band_mask(shape, lo, hi, device=None):
    """Nodes with lo[d] <= idx_d <= n_d - hi[d] on every axis d of a 3D
    `shape`; `lo` and `hi` are per-axis triples."""
    nx, ny, nz = shape
    ii = torch.arange(nx, device=device)[:, None, None]
    jj = torch.arange(ny, device=device)[None, :, None]
    kk = torch.arange(nz, device=device)[None, None, :]
    return ((ii >= lo[0]) & (ii <= nx - hi[0])
            & (jj >= lo[1]) & (jj <= ny - hi[1])
            & (kk >= lo[2]) & (kk <= nz - hi[2]))


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """ni x nj x nk cells of size h (domain [0, ni*h] x ...)."""

    ni: int
    nj: int
    nk: int
    h: float

    OFF_C: Offset3 = (0.0, 0.0, 0.0)
    OFF_U: Offset3 = (-0.5, 0.0, 0.0)
    OFF_V: Offset3 = (0.0, -0.5, 0.0)
    OFF_W: Offset3 = (0.0, 0.0, -0.5)

    @property
    def shape_c(self) -> Tuple[int, int, int]:
        return (self.ni, self.nj, self.nk)

    @property
    def shape_u(self) -> Tuple[int, int, int]:
        return (self.ni + 1, self.nj, self.nk)

    @property
    def shape_v(self) -> Tuple[int, int, int]:
        return (self.ni, self.nj + 1, self.nk)

    @property
    def shape_w(self) -> Tuple[int, int, int]:
        return (self.ni, self.nj, self.nk + 1)

    def shape_of(self, kind: str) -> Tuple[int, int, int]:
        d = self.dim_of(kind)
        return (self.ni + d[0], self.nj + d[1], self.nk + d[2])

    def dim_of(self, kind: str) -> Tuple[int, int, int]:
        """Face-extension vector 'dim' of a field kind."""
        return _DIMS[kind]

    def off_of(self, kind: str) -> Offset3:
        return {"c": self.OFF_C, "u": self.OFF_U, "v": self.OFF_V,
                "w": self.OFF_W}[kind]

    def axis_coords(self, kind: str, device=None):
        """World coordinates of `kind`'s nodes as three broadcastable
        views (nx,1,1), (1,ny,1), (1,1,nz): x = (i - 0.5*dim_x)*h in
        float32."""
        dim = self.dim_of(kind)
        nx, ny, nz = self.shape_of(kind)
        x = (torch.arange(nx, dtype=DTYPE, device=device) - 0.5 * dim[0]) * self.h
        y = (torch.arange(ny, dtype=DTYPE, device=device) - 0.5 * dim[1]) * self.h
        z = (torch.arange(nz, dtype=DTYPE, device=device) - 0.5 * dim[2]) * self.h
        return x[:, None, None], y[None, :, None], z[None, None, :]

    def node_coords(self, kind: str, device=None):
        """World coordinates (X, Y, Z) of every node of `kind`, full-size
        tensors."""
        shape = self.shape_of(kind)
        return tuple(c.expand(shape).contiguous()
                     for c in self.axis_coords(kind, device))

    def zeros(self, kind: str, device=None):
        return torch.zeros(self.shape_of(kind), dtype=DTYPE, device=device)

    def interior_mask(self, kind: str, lo: int = 2, hi: int = 3,
                      device=None, hi_add_dim: bool = False):
        """Nodes with lo <= idx <= n - hi on every axis (n = the field's
        extent along that axis). With ``hi_add_dim`` the upper margin
        grows by the kind's staggering per axis (the semi-Lagrangian
        update band, which keeps one more face plane)."""
        dim = self.dim_of(kind) if hi_add_dim else (0, 0, 0)
        return band_mask(self.shape_of(kind), (lo,) * 3,
                         tuple(hi + d for d in dim), device)


Offset2 = Tuple[float, float]


def lattice_coords(shape, off, h, device=None):
    """World coordinates (X, Y) of an (nx, ny) node lattice at offset
    `off` (units of h), x = (i + off)*h in float32, as broadcast views.
    The one place that rounds a 2D lattice: the trace kernel of
    ``bilerp_sample`` forms ((float)i + off) * h the same way."""
    nx, ny = shape
    x = (torch.arange(nx, dtype=DTYPE, device=device) + off[0]) * h
    y = (torch.arange(ny, dtype=DTYPE, device=device) + off[1]) * h
    return x[:, None].expand(nx, ny), y[None, :].expand(nx, ny)


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """2D MAC grid: ni x nj cells of size h; 2D reference conventions."""

    ni: int
    nj: int
    h: float

    OFF_C: Offset2 = (0.5, 0.5)
    OFF_U: Offset2 = (0.0, 0.5)
    OFF_V: Offset2 = (0.5, 0.0)

    @property
    def shape_c(self) -> Tuple[int, int]:
        return (self.ni, self.nj)

    @property
    def shape_u(self) -> Tuple[int, int]:
        return (self.ni + 1, self.nj)

    @property
    def shape_v(self) -> Tuple[int, int]:
        return (self.ni, self.nj + 1)

    @property
    def shape_curl(self) -> Tuple[int, int]:
        return (self.ni + 1, self.nj + 1)

    def shape_of(self, kind: str) -> Tuple[int, int]:
        return {"c": self.shape_c, "u": self.shape_u, "v": self.shape_v}[kind]

    def off_of(self, kind: str) -> Offset2:
        return {"c": self.OFF_C, "u": self.OFF_U, "v": self.OFF_V}[kind]

    def node_coords(self, kind: str, device=None):
        """World coordinates (X, Y) of every node of `kind`, x = (i +
        off)*h in float32, full-size contiguous tensors."""
        x, y = lattice_coords(self.shape_of(kind), self.off_of(kind),
                              self.h, device)
        return x.contiguous(), y.contiguous()

    def zeros(self, kind: str, device=None):
        return torch.zeros(self.shape_of(kind), dtype=DTYPE, device=device)
