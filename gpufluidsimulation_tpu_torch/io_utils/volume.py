"""Sparse volume export: dense density -> sparse voxels above 1e-4, one
file per frame (the reference's writeVDB, utils/volumeMeshTools.h:33-60).

A copy of ``gpufluidsimulation_tpu.io_utils.volume`` for the port. The
default container is a real OpenVDB ``.vdb`` file written by the
dependency-free serializer in ``io_utils/vdb.py`` and handed to the native
writer thread (``native/gfs_io.c``), so the frame loop does not wait on
the disk; ``flush_volumes()`` drains it. ``GFS_VOLUME_FORMAT`` (or `fmt`)
selects ``vdb``, ``gfsvol`` (the native single-pass sparse COO packer) or
``npz``. The native module is built on first use, and a failed build
raises; ``npz`` is the one format that needs no native code. The
``pyopenvdb`` branch of the JAX package is not carried over.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from gpufluidsimulation_tpu_torch import native
from gpufluidsimulation_tpu_torch.io_utils import vdb as _vdb

DENSITY_THRESHOLD = 1e-4  # volumeMeshTools.h:46


def _host(density) -> np.ndarray:
    """float32 numpy array of `density`; a tensor on the card costs one
    device-to-host copy."""
    if isinstance(density, torch.Tensor):
        return density.detach().to("cpu", torch.float32).numpy()
    return np.asarray(density, np.float32)


def write_volume(frame: int, filepath: str, voxel_size: float, density,
                 name: str = "density", fmt: str | None = None) -> str:
    """Write `density` (a tensor on any device, or an array) as
    ``<filepath>/%04d.<ext>``; returns the file name. The vdb and gfsvol
    files are written by the native writer thread: call
    ``flush_volumes()`` before reading them."""
    fmt = fmt or os.environ.get("GFS_VOLUME_FORMAT", "auto")
    if fmt not in ("auto", "vdb", "gfsvol", "npz"):
        raise ValueError(f"unknown volume format {fmt!r}")
    os.makedirs(filepath, exist_ok=True)
    dense = _host(density)
    if fmt in ("auto", "vdb"):
        payload = _vdb.pack_vdb(dense, voxel_size, name=name,
                                threshold=DENSITY_THRESHOLD)
        out = os.path.join(filepath, f"{frame:04d}.vdb")
        native.load().async_write(out, payload)
        return out
    if fmt == "gfsvol":
        payload = native.load().pack_sparse(
            np.ascontiguousarray(dense).tobytes(), dense.shape,
            float(voxel_size), DENSITY_THRESHOLD)
        out = os.path.join(filepath, f"{frame:04d}.gfsvol")
        native.load().async_write(out, payload)
        return out
    mask = dense > DENSITY_THRESHOLD
    idx = np.argwhere(mask).astype(np.int32)
    vals = dense[mask]
    out = os.path.join(filepath, f"{frame:04d}.npz")
    np.savez_compressed(
        out,
        indices=idx,
        values=vals,
        shape=np.asarray(dense.shape, np.int32),
        voxel_size=np.float32(voxel_size),
        name=name,
        active_count=np.int64(vals.size),
    )
    return out


def flush_volumes() -> int:
    """Wait for every queued write; returns the number of writes that
    failed in this process so far (0 = ok)."""
    mod = native.loaded()
    return 0 if mod is None else int(mod.flush())


def read_volume(path: str):
    """Load a sparse volume back to (dense float32 array, voxel size)."""
    if path.endswith(".vdb"):
        return _vdb.read_vdb(path)
    if path.endswith(".gfsvol"):
        with open(path, "rb") as f:
            raw = f.read()
        magic, ver, nx, ny, nz, vox, count = struct.unpack("<4sIIIIfQ",
                                                           raw[:32])
        if magic != b"GFSV" or ver != 1:
            raise ValueError(f"bad gfsvol header in {path}")
        off = 32
        idx = np.frombuffer(raw, np.uint32, count, off)
        vals = np.frombuffer(raw, np.float32, count, off + 4 * count)
        dense = np.zeros(nx * ny * nz, np.float32)
        dense[idx] = vals
        return dense.reshape(nx, ny, nz), float(vox)
    with np.load(path, allow_pickle=False) as z:
        dense = np.zeros(tuple(z["shape"]), np.float32)
        idx = z["indices"]
        dense[idx[:, 0], idx[:, 1], idx[:, 2]] = z["values"]
        return dense, float(z["voxel_size"])


def write_levelset_txt(path: str, frame: int, sdf) -> str:
    """outputLevelset parity (BimocqSolver2D.cpp:2369-2386): rows = i, cols
    = j, space-separated."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"levelset_{frame:04d}.txt")
    a = _host(sdf)
    with open(out, "w") as f:
        lines = [" ".join(f"{v:g}" for v in row) + " " for row in a]
        f.write("\n".join(lines))
    return out
