"""The vorticity colormap of the 2D CLI, that of
``gpufluidsimulation_tpu.io_utils.colormap``: an 11-stop blue-green-red
ramp sampled at val/10 clamped to [0, 0.99]."""

from __future__ import annotations

import numpy as np
import torch

_STOPS = np.array(
    [
        [0.0, 0.007195, 0.2590],
        [0.0, 0.0, 0.5],
        [0.0, 0.3375, 0.9],
        [0.0, 0.57, 0.9],
        [0.0032514, 0.735, 0.181],
        [0.0065028, 0.9, 0.100473],
        [0.228251, 0.9, 0.0502],
        [0.45, 0.9, 0.0],
        [0.9, 0.45, 0.0],
        [0.9, 0.0, 0.0],
        [0.3, 0.0, 0.0],
    ],
    np.float32,
)


def vorticity_to_rgb(val) -> np.ndarray:
    """val: any-shape array of |vorticity|; returns uint8 RGB (..., 3)."""
    x = np.clip(np.asarray(val, np.float32) / 10.0, 0.0, 0.99)
    xi = x * 10.0
    i = xi.astype(np.int32)
    fx = (xi - i)[..., None]
    color = (1.0 - fx) * _STOPS[i] + fx * _STOPS[i + 1]
    return (color * 255.0).astype(np.uint8)


def render_vorticity(curl, ni, nj) -> np.ndarray:
    """Cell-averaged |vorticity| image: the mean of the 4 surrounding
    nodes of the (ni+1, nj+1) curl (a numpy array or a tensor)."""
    if torch.is_tensor(curl):
        curl = curl.detach().cpu().numpy()
    c = np.asarray(curl, np.float32)
    vort = 0.25 * (c[:ni, :nj] + c[1:ni + 1, :nj] + c[:ni, 1:nj + 1]
                   + c[1:ni + 1, 1:nj + 1])
    return vorticity_to_rgb(np.abs(vort))
