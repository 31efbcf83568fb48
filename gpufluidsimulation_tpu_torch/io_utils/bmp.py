"""BMP frame writers of the 2D CLI, byte for byte those of
``gpufluidsimulation_tpu.io_utils.bmp``.

write_bmp       grayscale density, value*255 clamped
write_bmp_color two scalar fields -> the R and G channels
write_bmp_rgb   raw RGB bytes (the vorticity colormap)

Pixel (i, j) is field(i, j) with j the scanline; BMP files store their
rows bottom-up, which is kept. Fields may be numpy arrays or tensors on
any device.
"""

from __future__ import annotations

import struct

import numpy as np
import torch


def _host(a, dtype):
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _bmp_header(width: int, height: int):
    row_size = (3 * width + 3) & ~3
    image_size = row_size * height
    file_size = 54 + image_size
    header = struct.pack(
        "<2sIHHI", b"BM", file_size, 0, 0, 54
    ) + struct.pack(
        "<IiiHHIIiiII", 40, width, height, 1, 24, 0, image_size, 2835, 2835,
        0, 0)
    return header, row_size


def _write(path, width, height, rgb_rows):
    """rgb_rows: (height, width, 3) uint8, row 0 = bottom scanline."""
    header, row_size = _bmp_header(width, height)
    with open(path, "wb") as f:
        f.write(header)
        buf = np.zeros((height, row_size), np.uint8)
        # BMP stores BGR
        buf[:, : 3 * width] = rgb_rows[:, :, ::-1].reshape(height, 3 * width)
        f.write(buf.tobytes())


def write_bmp(path: str, field) -> None:
    """Grayscale: v in [0, 1] -> 255*v."""
    a = _host(field, np.float32)
    ni, nj = a.shape
    g = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    rgb = np.repeat(g.T[:, :, None], 3, axis=2)  # rows = j scanlines
    _write(path, ni, nj, rgb)


def write_bmp_color(path: str, field_r, field_g) -> None:
    a = _host(field_r, np.float32)
    b = _host(field_g, np.float32)
    ni, nj = a.shape
    rgb = np.zeros((nj, ni, 3), np.uint8)
    rgb[:, :, 0] = np.clip(a.T * 255.0, 0, 255).astype(np.uint8)
    rgb[:, :, 1] = np.clip(b.T * 255.0, 0, 255).astype(np.uint8)
    _write(path, ni, nj, rgb)


def write_bmp_rgb(path: str, rgb) -> None:
    """rgb: (ni, nj, 3) uint8 in field layout."""
    a = _host(rgb, np.uint8)
    ni, nj, _ = a.shape
    _write(path, ni, nj, a.transpose(1, 0, 2))
