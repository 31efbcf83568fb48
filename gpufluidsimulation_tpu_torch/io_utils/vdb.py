"""Dependency-free OpenVDB `.vdb` file writer/reader (single FloatGrid).

A copy of ``gpufluidsimulation_tpu.io_utils.vdb`` for the port: the same
bytes for the same input.

Closes the writeVDB format-parity gap (utils/volumeMeshTools.h:33-60): the
reference exports each frame's density as an OpenVDB FOG volume; this
module emits genuine `.vdb` files — OpenVDB archive format 224, one
`Tree_float_5_4_3` FloatGrid — with no OpenVDB/pyopenvdb dependency, so
the output drops straight into DCC pipelines (Blender/Houdini import).

Format notes (mirrors openvdb::io::Archive/File serialization):
  header   : int64 magic 0x56444220 (" BDV"), uint32 file version 224,
             uint32 library (major, minor), 1-byte has-grid-offsets flag,
             36-char ASCII UUID
  archive  : MetaMap (uint32 count, entries), uint32 grid count
  per grid : GridDescriptor = unique name, grid type, instance-parent
             (all length-prefixed strings) + 3 int64 stream offsets
             (grid/blocks/end); then the grid itself:
             uint32 compression flags (0 none, 1 zip), grid MetaMap,
             transform (map type name + AffineMap 4x4 doubles),
             topology (int32 buffer count = 1, then the node tree),
             leaf buffers.
  tree     : Root:  float background, uint32 tile count, uint32 child
                    count, per child: int32x3 origin + recursion.
             Internal (Log2Dim 5 then 4): child bitmask, value bitmask
             (raw little-endian words), tile values (1 metadata byte +
             value array, zipped when compression=1), then children in
             ascending-offset order; offset = (x >> cl << 2L)|(y >> cl
             << L)|(z >> cl) for Log2Dim L, child span 2^cl.
             Leaf (8^3): 64-byte value bitmask; its buffer section entry
             re-writes the mask then 1 metadata byte + 512 float values.
  metadata byte: 6 = NO_MASK_AND_ALL_VALS (all values stored; the
             active-mask compaction codes 0-5 are never emitted).
  zip      : int64 byte count then zlib data (negative count = raw).

The writer is vectorized (one pass of numpy reshapes; no per-voxel Python)
so packing a 256^3 frame is milliseconds and can feed the native async
writer thread. Coordinates are non-negative and bounded by 4096 per axis
(one level-2 internal node under the root) — always true for simulation
grids here. Written files are round-trip tested against `read_vdb`; the
format constants follow the openvdb 8.x serialization exactly, but the
environment ships no OpenVDB to cross-check against — if an external
reader rejects a file, compare against a library-written sample first.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

MAGIC = 0x56444220          # int64 " BDV"
FILE_VERSION = 224          # OPENVDB_FILE_VERSION_MULTIPASS_IO
LIBRARY_VERSION = (8, 1)
GRID_TYPE = "Tree_float_5_4_3"
COMPRESS_NONE = 0
COMPRESS_ZIP = 1
META_NO_MASK_AND_ALL_VALS = 6

_UUID = "9c2d1a4e-0f3b-47a8-9b1d-5e6f7a8b9c0d"  # fixed: deterministic files


def _wstring(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _meta_entry(name: str, typename: str, value: bytes) -> bytes:
    return (_wstring(name) + _wstring(typename)
            + struct.pack("<I", len(value)) + value)


def _pack_values(vals_f32: np.ndarray, compress: int) -> bytes:
    """One value-array record: metadata byte + (raw | zipped) payload."""
    raw = vals_f32.astype("<f4", copy=False).tobytes()
    out = bytes([META_NO_MASK_AND_ALL_VALS])
    if compress == COMPRESS_ZIP:
        z = zlib.compress(raw)
        if len(z) < len(raw):
            return out + struct.pack("<q", len(z)) + z
        return out + struct.pack("<q", -len(raw)) + raw
    return out + raw


def _bitmask(on_bits: np.ndarray, nbits: int) -> bytes:
    """NodeMask serialization: little-endian bit order over nbits bits."""
    bits = np.zeros(nbits, np.uint8)
    bits[on_bits] = 1
    return np.packbits(bits, bitorder="little").tobytes()


def pack_vdb(dense, voxel_size: float, name: str = "density",
             threshold: float = 0.0, compress: int = COMPRESS_ZIP,
             grid_class: str = "fog volume") -> bytes:
    """Serialize a dense (nx, ny, nz) float array as a .vdb byte string.

    Voxels with value > threshold are active; inactive voxels hold the
    background (0). Matches the reference's writeVDB semantics of
    setValue-above-threshold (volumeMeshTools.h:44-48)."""
    dense = np.asarray(dense, np.float32)
    if dense.ndim != 3:
        raise ValueError(f"expected 3D array, got shape {dense.shape}")
    nx, ny, nz = dense.shape
    if max(nx, ny, nz) > 4096:
        raise ValueError("grids beyond 4096^3 need multiple root children")
    active = dense > threshold
    vals = np.where(active, dense, np.float32(0.0))

    # --- leaf decomposition (vectorized) ----------------------------------
    # pad to 8-multiples, regroup to (leafgrid, 8,8,8), then order leaves by
    # the tree traversal order: internal1 blocks (16-leaf span) ascending,
    # leaves ascending within each block — i.e. lexicographic
    # (bx,by,bz,lx,ly,lz), NOT plain (x,y,z) leaf order.
    L = [-(-d // 8) for d in dense.shape]          # leaves per axis
    pad = [(0, 8 * l - d) for l, d in zip(L, dense.shape)]
    vals8 = np.pad(vals, pad)
    act8 = np.pad(active, pad)

    def leafview(a):
        a = a.reshape(L[0], 8, L[1], 8, L[2], 8).transpose(0, 2, 4, 1, 3, 5)
        return a.reshape(L[0], L[1], L[2], 512)

    lv = leafview(vals8)
    la = leafview(act8)
    B = [-(-l // 16) for l in L]                    # internal1 nodes per axis
    lpad = [(0, 16 * b - l) for b, l in zip(B, L)]

    def blockview(a):  # (LX,LY,LZ,512) -> (BX,BY,BZ,16,16,16,512)
        a = np.pad(a, lpad + [(0, 0)])
        a = a.reshape(B[0], 16, B[1], 16, B[2], 16, 512)
        return a.transpose(0, 2, 4, 1, 3, 5, 6)

    bv = blockview(lv).reshape(-1, 16, 16, 16, 512)
    ba = blockview(la).reshape(-1, 16, 16, 16, 512)
    leaf_on = ba.any(axis=4)                        # (NB,16,16,16)
    node_on = leaf_on.any(axis=(1, 2, 3))           # (NB,)

    # --- tree sections ----------------------------------------------------
    topo = bytearray()
    bufs = bytearray()
    n_leaves = 0
    n_active = int(active.sum())
    zeros_i2 = _pack_values(np.zeros(32768, np.float32), compress)
    zeros_i1 = _pack_values(np.zeros(4096, np.float32), compress)
    if n_active:
        # level-2 internal node (Log2Dim=5, 32^3 children of 128-voxel span).
        # lex order over (bx,by,bz) == ascending child offset order.
        i2_flat = np.flatnonzero(node_on)
        bx, by, bz = np.unravel_index(i2_flat, tuple(B))
        i2_off = (bx << 10) | (by << 5) | bz
        topo += _bitmask(i2_off, 32768)
        topo += bytes(4096)                         # value mask: all off
        topo += zeros_i2
        for b in i2_flat:
            # level-1 internal node (Log2Dim=4, 16^3 children of 8-voxel span)
            lon = leaf_on[b]
            lidx = np.argwhere(lon)
            i1_off = (lidx[:, 0] << 8) | (lidx[:, 1] << 4) | lidx[:, 2]
            topo += _bitmask(i1_off, 4096)
            topo += bytes(512)
            topo += zeros_i1
            lmask_bytes = np.packbits(
                ba[b][lon].astype(np.uint8), axis=-1, bitorder="little")
            for m in lmask_bytes:                   # leaf topology: mask only
                topo += m.tobytes()
            for m, v in zip(lmask_bytes, bv[b][lon]):
                bufs += m.tobytes()
                bufs += _pack_values(v, compress)
            n_leaves += len(i1_off)

    root = struct.pack("<f", 0.0)                   # background
    if n_active:
        root += struct.pack("<II", 0, 1)            # tiles, children
        root += struct.pack("<iii", 0, 0, 0)        # child origin
    else:
        root += struct.pack("<II", 0, 0)
    topology = struct.pack("<i", 1) + root + bytes(topo)

    # --- grid metadata / transform ----------------------------------------
    if n_active:
        ijk = np.argwhere(active)
        bmin, bmax = ijk.min(axis=0), ijk.max(axis=0)
    else:
        bmin = bmax = np.zeros(3, np.int64)
    meta = b"".join([
        _meta_entry("class", "string", grid_class.encode()),
        _meta_entry("file_bbox_max", "vec3i",
                    struct.pack("<iii", *map(int, bmax))),
        _meta_entry("file_bbox_min", "vec3i",
                    struct.pack("<iii", *map(int, bmin))),
        _meta_entry("file_voxel_count", "int64", struct.pack("<q", n_active)),
        _meta_entry("is_saved_as_half_float", "bool", b"\x00"),
        _meta_entry("name", "string", name.encode()),
    ])
    grid_meta = struct.pack("<I", 6) + meta
    h = float(voxel_size)
    mat = np.diag([h, h, h, 1.0]).astype("<f8")
    transform = _wstring("AffineMap") + mat.tobytes()

    # --- archive assembly -------------------------------------------------
    header = struct.pack("<q", MAGIC)
    header += struct.pack("<I", FILE_VERSION)
    header += struct.pack("<II", *LIBRARY_VERSION)
    header += b"\x01"                               # has grid offsets
    header += _UUID.encode()
    header += struct.pack("<I", 0)                  # empty file MetaMap
    header += struct.pack("<I", 1)                  # grid count
    desc_head = _wstring(name) + _wstring(GRID_TYPE) + _wstring("")
    grid_pos = len(header) + len(desc_head) + 24    # after the 3 offsets
    grid_body = struct.pack("<I", compress) + grid_meta + transform + topology
    block_pos = grid_pos + len(grid_body)
    end_pos = block_pos + len(bufs)
    return b"".join([header, desc_head,
                     struct.pack("<qqq", grid_pos, block_pos, end_pos),
                     grid_body, bytes(bufs)])


def write_vdb(path: str, dense, voxel_size: float, name: str = "density",
              threshold: float = 0.0, compress: int = COMPRESS_ZIP) -> str:
    with open(path, "wb") as f:
        f.write(pack_vdb(dense, voxel_size, name=name, threshold=threshold,
                         compress=compress))
    return path


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class _R:
    def __init__(self, buf):
        self.b = buf
        self.o = 0

    def take(self, n):
        v = self.b[self.o:self.o + n]
        if len(v) != n:
            raise ValueError("truncated .vdb stream")
        self.o += n
        return v

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i64(self):
        return struct.unpack("<q", self.take(8))[0]

    def string(self):
        return self.take(self.u32()).decode()


def _read_values(r: _R, count: int, compress: int) -> np.ndarray:
    meta = r.take(1)[0]
    if meta != META_NO_MASK_AND_ALL_VALS:
        raise ValueError(f"unsupported value-array metadata code {meta} "
                         "(active-mask compaction not handled)")
    if compress == COMPRESS_ZIP:
        n = r.i64()
        if n <= 0:
            return np.frombuffer(r.take(-n), "<f4").copy()
        return np.frombuffer(zlib.decompress(r.take(n)), "<f4").copy()
    return np.frombuffer(r.take(4 * count), "<f4").copy()


def _read_mask(r: _R, nbits: int) -> np.ndarray:
    return np.unpackbits(
        np.frombuffer(r.take(nbits // 8), np.uint8), bitorder="little")


def read_vdb(path_or_bytes):
    """Read a single-FloatGrid .vdb (the subset this module writes: formats
    >= 222, compression none/zip, no active-mask compaction, no tiles).
    Returns (dense, voxel_size)."""
    buf = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
           else open(path_or_bytes, "rb").read())
    r = _R(buf)
    if r.i64() != MAGIC:
        raise ValueError("not a .vdb file (bad magic)")
    version = r.u32()
    if version < 222:
        raise ValueError(f"unsupported .vdb file version {version}")
    r.take(8)                                       # library version
    r.take(1)                                       # has-grid-offsets
    r.take(36)                                      # uuid
    if version < 223:
        r.take(1)                                   # legacy zip flag
    n_meta = r.u32()
    for _ in range(n_meta):
        r.string(), r.string(), r.take(r.u32())
    n_grids = r.u32()
    if n_grids < 1:
        raise ValueError("no grids in file")
    r.string()                                      # unique name
    gtype = r.string()
    if gtype != GRID_TYPE:
        raise ValueError(f"unsupported grid type {gtype!r}")
    r.string()                                      # instance parent
    r.take(24)                                      # stream offsets
    compress = r.u32()
    if compress & ~COMPRESS_ZIP:
        raise ValueError(f"unsupported compression flags {compress:#x}")
    n_meta = r.u32()
    for _ in range(n_meta):
        r.string(), r.string(), r.take(r.u32())
    map_type = r.string()
    if map_type == "AffineMap":
        mat = np.frombuffer(r.take(128), "<f8").reshape(4, 4)
        voxel = float(mat[0, 0])
    elif map_type in ("UniformScaleMap", "ScaleMap"):
        voxel = float(np.frombuffer(r.take(24), "<f8")[0])
        r.take(24 * 4)                              # cached inverse vectors
    else:
        raise ValueError(f"unsupported transform map {map_type!r}")
    if struct.unpack("<i", r.take(4))[0] != 1:      # TreeBase buffer count
        raise ValueError("multi-buffer trees unsupported")
    background = struct.unpack("<f", r.take(4))[0]
    n_tiles, n_children = struct.unpack("<II", r.take(8))
    if n_tiles:
        raise ValueError("root tiles unsupported")

    leaves = []                                     # (origin, mask) in order
    for _ in range(n_children):
        ox, oy, oz = struct.unpack("<iii", r.take(12))
        i2_child = np.flatnonzero(_read_mask(r, 32768))
        _read_mask(r, 32768)
        _read_values(r, 32768, compress)
        for off2 in i2_child:
            bx = ox + ((off2 >> 10) << 7)
            by = oy + (((off2 >> 5) & 31) << 7)
            bz = oz + ((off2 & 31) << 7)
            i1_child = np.flatnonzero(_read_mask(r, 4096))
            _read_mask(r, 4096)
            _read_values(r, 4096, compress)
            for off1 in i1_child:
                lx = bx + ((off1 >> 8) << 3)
                ly = by + (((off1 >> 4) & 15) << 3)
                lz = bz + ((off1 & 15) << 3)
                mask = _read_mask(r, 512)
                leaves.append(((lx, ly, lz), mask))
    if leaves:
        org = np.array([o for o, _ in leaves])
        hi = org.max(axis=0) + 8
    else:
        hi = np.zeros(3, np.int64)
    dense = np.full(tuple(hi), background, np.float32)
    for (lx, ly, lz), mask in leaves:               # buffer section
        bmask = _read_mask(r, 512)
        if not np.array_equal(bmask, mask):
            raise ValueError("leaf mask mismatch between topology and buffer")
        v = _read_values(r, 512, compress)
        v = np.where(mask.astype(bool), v, background)
        dense[lx:lx + 8, ly:ly + 8, lz:lz + 8] = v.reshape(8, 8, 8)
    return dense, voxel
