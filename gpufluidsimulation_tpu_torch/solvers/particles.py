"""The 2D particle state of the FLIP / APIC / PolyPIC schemes.

Counterpart of ``gpufluidsimulation_tpu.solvers.particles.ParticleState``:
the eight per-particle columns, so that the 2D solver's state has the JAX
package's field set. The grid schemes hold them empty (``empty``); the
particle transfers themselves (seeding, P2G, G2P) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ParticleState:
    pos: torch.Tensor   # (P, 2) world positions
    vel: torch.Tensor   # (P, 2)
    rho: torch.Tensor   # (P,)
    T: torch.Tensor     # (P,)
    C_x: torch.Tensor   # (P, 4) bilinear poly coeffs for u
    C_y: torch.Tensor   # (P, 4)
    C_rho: torch.Tensor
    C_T: torch.Tensor

    @classmethod
    def empty(cls, device=None) -> "ParticleState":
        """No particles: every column with P = 0."""
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return cls(pos=z(0, 2), vel=z(0, 2), rho=z(0), T=z(0), C_x=z(0, 4),
                   C_y=z(0, 4), C_rho=z(0, 4), C_T=z(0, 4))
