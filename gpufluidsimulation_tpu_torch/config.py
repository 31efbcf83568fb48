"""Device and dtype resolution for the port.

There are no process-wide engine modes: the port runs one configuration
(the accelerator defaults of the JAX package) and every entry point takes
an explicit ``device``.
"""

from __future__ import annotations

import torch

DTYPE = torch.float32


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
