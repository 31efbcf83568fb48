"""Device and dtype resolution for the port, and its one engine mode.

There are no process-wide engine modes and no environment switches: the
port runs the accelerator defaults of the JAX package (exact gathers in
the kernels, dual volume form, red-black Gauss-Seidel smoothing), every
entry point takes an explicit ``device``, and the choices a solver can
make are carried by its configuration's ``EngineMode``.
"""

from __future__ import annotations

import dataclasses

import torch

DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class EngineMode:
    """Per-solver engine mode. ``spectral_poisson``: None or True solves
    the unmasked full-box pressure system directly in the DST/DCT
    eigenbasis (the accelerator default), False with MG-PCG. Projections
    with solid boundaries always use MG-PCG. ``volume_exact``: True
    evaluates the BiMocq volume average as the reference's exact 9-point
    composition field(M(p + d)) (the JAX package's exact-gather mode);
    None or False uses the dual form (its accelerator default)."""

    spectral_poisson: bool | None = None
    volume_exact: bool | None = None


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: it raises when no CUDA device exists and
    never falls back to the CPU. Pass ``"cpu"`` to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
