#!/usr/bin/env python3
"""Time design variants of the port's redesigned kernels on one GPU.

    python3 scripts/kernel_variants.py            # 256^3 shapes, all ten
    python3 scripts/kernel_variants.py --n 64     # a quick check
    python3 scripts/kernel_variants.py --kernels dmc_substep,vol9_fixup
    python3 scripts/kernel_variants.py --kernels vol9_fixup --only shipped,tile
    python3 scripts/kernel_variants.py --kernels minmax_sample,pullback_sample \
        --parent _archive/parent     # also that tree's designs, same rounds

Each variant is the kernel's source in ``gpufluidsimulation_tpu_torch/csrc``
with textual edits (block or tile shape, rows per thread, the division,
the offset arithmetic, register caps, segment length, prefetching, a
shared-memory velocity tile, the map neighbourhood); an edit whose text is
not in the kernel's source applies to the variant's own copy of
``common.cuh``. This is the one place where such alternatives are built:
the port ships only the chosen design. A variant that does not build is
reported and skipped. Every variant is built with nvcc for sm_90a with
the port's flags and ``-Xptxas -v`` (registers and spills are printed),
run on the inputs of ``chip_smoke.py``'s kernel phase, held against the
plain PyTorch version (its max abs error is printed; the shipped design
must show 0) and timed with CUDA events. ``jacobi_diffuse`` variants are
timed per 20-sweep solve at 1, 2, 4 and 8 sweeps a launch (the shipped
source builds 2 and 1; every variant here adds 4 and 8), on a smooth
field, an all-zero field and one zero on half its k range.
``rk3_substep`` variants run from positions displaced by up to 2 cells
and in the lattice mode (cell kind); ``dmc_substep`` variants from a map
displaced by up to 2 cells and in the lattice mode; ``volume_prefilter``
variants at C=1 on the u lattice and C=2 on the cell lattice;
``vol9_fixup`` variants at tol = 0 (every block flagged) for u (C=1) and
rho+T (C=2) through a map displaced by up to 2 cells; ``rbgs_smooth`` and
``masked_rbgs_smooth`` variants (region shapes, rows a thread, the segment
rule, a register cap, the division, the masked diagonal recounted at every
level) per 2-sweep call at
n^3 and 32^3, at 4 and at 2 colour levels a launch; ``minmax_sample``
variants (per-channel floors, eight corner loads, a block shape) at C=2
with and without the sample mode and at C=1, beside the two launches the
sample mode replaces; ``pullback_sample`` variants (the k below-node by a
warp shuffle, a thread a (channel, node), block shapes) for u, v, w and
rho+T. The smoother, minmax and pull-back builds are all made before any
is timed, each in its own namespace, then timed in interleaved rounds
(medians); ``--parent DIR`` adds that tree's minmax_sample and
pullback_sample, through its own C interface. Each build prints
its registers, spills and, where the toolkit has cuobjdump, each kernel's
static SASS instruction count. Builds go to the port's build directory
(``gpufluidsimulation_tpu_torch/_build/variants/``).
Needs a GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "gpufluidsimulation_tpu_torch" / "csrc"

_TRILERP_BLOCK = "constexpr int kBlockK = 32, kBlockJ = 2, kBlockI = 2;"
_TRILERP_KERNEL = ("template <bool kDual>\n__global__ void "
                   "trilerp_sample_kernel(")
TRILERP = {
    "shipped (32x2x2 block)": [],
    "32x1x1 block": [(_TRILERP_BLOCK, "constexpr int kBlockK = 32, "
                      "kBlockJ = 1, kBlockI = 1;")],
    "32x4x1 block": [(_TRILERP_BLOCK, "constexpr int kBlockK = 32, "
                      "kBlockJ = 4, kBlockI = 1;")],
    "32x4x2 block (256 threads)": [(_TRILERP_BLOCK, "constexpr int kBlockK "
                                    "= 32, kBlockJ = 4, kBlockI = 2;")],
    "offsets added to the pointer one by one": [
        ("__ldg(f + (ax.node[a] + ay.node[b] + az.node[c]))",
         "__ldg(f + ax.node[a] + ay.node[b] + az.node[c])")],
    "at most 64 registers": [
        (_TRILERP_KERNEL, "template <bool kDual>\n__global__ void "
         "__launch_bounds__(128, 8) trilerp_sample_kernel(")],
}

# every Jacobi variant also builds 4 and 8 sweeps a launch, beside the
# shipped kSweeps and 1, so that a 20-sweep solve can be timed at each
_JACOBI_ONE = ("  if (sweeps == 1) return launch<1>(xp, bp, nx, ny, nz, coef, "
               "denom, op, s);\n")
_JACOBI_MORE = "".join(
    _JACOBI_ONE.replace("== 1", f"== {s}").replace("<1>", f"<{s}>")
    for s in (1, 4, 8))

JACOBI = {
    "shipped (32x32 region, 2 rows a thread)": [],
    "1 row a thread (32 warps)": [("constexpr int kWarpsJ = 16;",
                                   "constexpr int kWarpsJ = 32;")],
    "4 rows a thread (8 warps)": [("constexpr int kWarpsJ = 16;",
                                   "constexpr int kWarpsJ = 8;")],
    "nvcc's full division (a / denom)": [
        ("divide(bq[t - 1][q] + coef * nb, denom, rcp)",
         "(bq[t - 1][q] + coef * nb) / denom")],
}


_RK3_BLOCK = "constexpr int kBlockK = 32, kBlockJ = 4, kBlockI = 1;"
_RK3_MIN = "constexpr int kMinBlocks = 8;"
_RK3_BOUNDS = ("__global__ void __launch_bounds__(kBlockK * kBlockJ * "
               "kBlockI, kMinBlocks)\n")


def _rk3_block(k, j, i):
    """Block (k, j, i); the blocks an SM are capped at 1024 threads."""
    return [(_RK3_BLOCK, f"constexpr int kBlockK = {k}, kBlockJ = {j}, "
             f"kBlockI = {i};"),
            (_RK3_MIN, f"constexpr int kMinBlocks = {1024 // (k * j * i)};")]


# the z corners clamped one by one, as the plain version does (this
# design's first step: 8 addresses a sample)
_PER_CORNER = """__device__ __forceinline__ float trilerp(
    const float* __restrict__ f, const Coord& x, const Coord& y,
    const Coord& z, unsigned sx, unsigned sy) {
  const unsigned xa = x.lo * sx, xb = x.hi * sx;
  const unsigned ya = y.lo * sy, yb = y.hi * sy;
  const unsigned aa = xa + ya, ba = xb + ya, ab = xa + yb, bb = xb + yb;
  const float c00 =
      x.w * __ldg(f + (aa + z.lo)) + x.f * __ldg(f + (ba + z.lo));
  const float c10 =
      x.w * __ldg(f + (ab + z.lo)) + x.f * __ldg(f + (bb + z.lo));
  const float c01 =
      x.w * __ldg(f + (aa + z.hi)) + x.f * __ldg(f + (ba + z.hi));
  const float c11 =
      x.w * __ldg(f + (ab + z.hi)) + x.f * __ldg(f + (bb + z.hi));
  const float c0 = y.w * c00 + y.f * c10;
  const float c1 = y.w * c01 + y.f * c11;
  return z.w * c0 + z.f * c1;
}

"""
_RK3_PER_CORNER = _PER_CORNER + "// The MAC faces of an (ni, nj, nk) grid"

# the velocity triplet's tile (the block's nodes and a 2-cell halo, one
# more node on each axis for the staggered faces) staged in shared memory
# by the whole block before any node is traced; a corner set inside the
# tile is read from it, any other from global memory
_RK3_TILE_DEFS = """constexpr int kR = 2;
constexpr int kTX = kBlockI + 2 * kR + 1, kTY = kBlockJ + 2 * kR + 1,
              kTZ = kBlockK + 2 * kR + 1, kTV = kTX * kTY * kTZ;
__shared__ float tile[3][kTV];

template <int kQ>
__device__ __forceinline__ float trilerp_tile(
    const float* __restrict__ f, const Coord& x, const Coord& y,
    const ZPair& z, unsigned sx, unsigned sy) {
  const int bx = (int)(blockIdx.z * kBlockI) - kR;
  const int by = (int)(blockIdx.y * kBlockJ) - kR;
  const int bz = (int)(blockIdx.x * kBlockK) - kR;
  const int xa = (int)x.lo - bx, xb = (int)x.hi - bx;
  const int ya = (int)y.lo - by, yb = (int)y.hi - by;
  const int za = (int)z.lo - bz;
  if (xa >= 0 && xb < kTX && ya >= 0 && yb < kTY && za >= 0 &&
      za + 1 < kTZ) {
    const float* s = tile[kQ];
    const int aa = (xa * kTY + ya) * kTZ + za, ba = (xb * kTY + ya) * kTZ + za;
    const int ab = (xa * kTY + yb) * kTZ + za, bb = (xb * kTY + yb) * kTZ + za;
    const float c00 = x.w * s[aa] + x.f * s[ba];
    const float c10 = x.w * s[ab] + x.f * s[bb];
    const float c01 = x.w * s[aa + 1] + x.f * s[ba + 1];
    const float c11 = x.w * s[ab + 1] + x.f * s[bb + 1];
    const float l0 = y.w * c00 + y.f * c10;
    const float l1 = y.w * c01 + y.f * c11;
    const float c0 = z.top ? l1 : l0;
    const float c1 = z.bottom ? l0 : l1;
    return z.w * c0 + z.f * c1;
  }
  return trilerp_zpair(f, x, y, z, sx, sy);
}

// The MAC faces of an (ni, nj, nk) grid"""
_RK3_TILE_LOAD = """  const int i = blockIdx.z * kBlockI + threadIdx.z;
  {
    const int tid =
        (threadIdx.z * kBlockJ + threadIdx.y) * kBlockK + threadIdx.x;
    const int bx = (int)(blockIdx.z * kBlockI) - kR;
    const int by = (int)(blockIdx.y * kBlockJ) - kR;
    const int bz = (int)(blockIdx.x * kBlockK) - kR;
    for (int e = tid; e < 3 * kTV; e += kBlockK * kBlockJ * kBlockI) {
      const int q = e / kTV, r = e - q * kTV;
      const int tx = r / (kTY * kTZ), r2 = r - tx * (kTY * kTZ);
      const int ty = r2 / kTZ, tz = r2 - ty * kTZ;
      const float* f = q == 0 ? F.u : (q == 1 ? F.v : F.w);
      const int nx = F.ni + (q == 0), ny = F.nj + (q == 1);
      const int nz = F.nk + (q == 2);
      tile[q][r] = __ldg(f + (gfs::clampi(bx + tx, 0, nx - 1) * ny +
                              gfs::clampi(by + ty, 0, ny - 1)) * nz +
                         gfs::clampi(bz + tz, 0, nz - 1));
    }
    __syncthreads();
  }
  if (k >= d2 || j >= d1 || i >= d0) return;"""

_RK3_Z_PER_CORNER = [
    ("  const ZPair z0 = zpair(gz, F.nk), z1 = zpair(gz + 0.5f, F.nk + 1);",
     "  const Coord z0 = coord(gz, F.nk), z1 = coord(gz + 0.5f, F.nk + 1);"),
    ("  *ou = trilerp_zpair(F.u,", "  *ou = trilerp(F.u,"),
    ("  *ov = trilerp_zpair(F.v,", "  *ov = trilerp(F.v,"),
    ("  *ow = trilerp_zpair(F.w,", "  *ow = trilerp(F.w,")]

RK3 = {
    "shipped (32x4x1 block, z pairs, at most 64 registers)": [],
    "no register cap": [(_RK3_BOUNDS, "__global__ void\n")],
    "z corners clamped one by one (8 addresses a sample)": [
        ("// The MAC faces of an (ni, nj, nk) grid", _RK3_PER_CORNER),
        *_RK3_Z_PER_CORNER],
    "z corners clamped one by one, no register cap": [
        ("// The MAC faces of an (ni, nj, nk) grid", _RK3_PER_CORNER),
        *_RK3_Z_PER_CORNER, (_RK3_BOUNDS, "__global__ void\n")],
    "per-component floors (gfs::trilerp_clamped, 64-bit offsets)": [(
        "  const Coord x0 = coord(gx, F.ni), x1 = coord(gx + 0.5f, F.ni + 1);",
        "  *ou = gfs::trilerp_clamped(F.u, F.ni + 1, F.nj, F.nk, gx + 0.5f, "
        "gy, gz);\n"
        "  *ov = gfs::trilerp_clamped(F.v, F.ni, F.nj + 1, F.nk, gx, "
        "gy + 0.5f, gz);\n"
        "  *ow = gfs::trilerp_clamped(F.w, F.ni, F.nj, F.nk + 1, gx, gy, "
        "gz + 0.5f);\n  return;\n"
        "  const Coord x0 = coord(gx, F.ni), x1 = coord(gx + 0.5f, F.ni + 1);"),
        (_RK3_BOUNDS, "__global__ void\n")],
    "32x1x1 block": _rk3_block(32, 1, 1),
    "32x2x2 block": _rk3_block(32, 2, 2),
    "32x8x1 block (256 threads)": _rk3_block(32, 8, 1),
    "64x2x1 block": _rk3_block(64, 2, 1),
    "velocity tile in shared memory (32x4x2 block, 2-cell halo)": [
        *_rk3_block(32, 4, 2),
        ("// The MAC faces of an (ni, nj, nk) grid", _RK3_TILE_DEFS),
        ("  *ou = trilerp_zpair(F.u,", "  *ou = trilerp_tile<0>(F.u,"),
        ("  *ov = trilerp_zpair(F.v,", "  *ov = trilerp_tile<1>(F.v,"),
        ("  *ow = trilerp_zpair(F.w,", "  *ow = trilerp_tile<2>(F.w,"),
        ("  const int i = blockIdx.z * kBlockI + threadIdx.z;\n"
         "  if (k >= d2 || j >= d1 || i >= d0) return;", _RK3_TILE_LOAD)],
}

_PF = "constexpr int kTileK = 32, kTileJ = 4, kSeg = 32;"


def _pf(k, j, seg):
    return (_PF, f"constexpr int kTileK = {k}, kTileJ = {j}, kSeg = {seg};")


PREFILTER = {
    "shipped (32x4 tile, 32-plane segments)": [],
    "32x8 tile, 16-plane segments (the first tiling)": [_pf(32, 8, 16)],
    "32x4 tile, 8-plane segments": [_pf(32, 4, 8)],
    "32x4 tile, 16-plane segments": [_pf(32, 4, 16)],
    "32x4 tile, 64-plane segments": [_pf(32, 4, 64)],
    "32x2 tile, 32-plane segments": [_pf(32, 2, 32)],
    "32x8 tile, 32-plane segments": [_pf(32, 8, 32)],
    "32x16 tile, 32-plane segments": [_pf(32, 16, 32)],
    "64x4 tile, 32-plane segments": [_pf(64, 4, 32)],
    "no prefetch (each plane loaded when it is staged)": [
        ("      if (cur < last_plane) load(cur + 1);\n", ""),
        ("    if (cur != last) {      // uniform over the block\n",
         "    if (cur != last) {      // uniform over the block\n"
         "      load(cur);\n")],
}


_DMC_SRC = (CSRC / "dmc_substep.cu").read_text()
_DMC_BLOCK = "constexpr int kBlockK = 32, kBlockJ = 4, kBlockI = 1;"
# the shipped kernel's face loads, from the centre faces to the upwind ones
_DMC_FACES = _DMC_SRC[_DMC_SRC.index("  // the faces of cell (i, j, k): u"):
                      _DMC_SRC.index("  const float disp_x = dmc_disp(")]
_DMC_RETURN = "  if (k >= nk || j >= nj || i >= ni) return;\n"

# the velocity triplet of the block's cells with a one-cell halo and the
# upper face (kBlock + 3 nodes an axis, origin one cell below the block)
# staged in shared memory by the whole block before any cell reads it;
# every face is then read from the tile
_DMC_TILE_LOAD = """  constexpr int kTX = kBlockI + 3, kTY = kBlockJ + 3, kTZ = kBlockK + 3;
  constexpr int kTV = kTX * kTY * kTZ;
  __shared__ float tile[3][kTV];
  {
    const int tid =
        (threadIdx.z * kBlockJ + threadIdx.y) * kBlockK + threadIdx.x;
    const int bx = (int)(blockIdx.z * kBlockI) - 1;
    const int by = (int)(blockIdx.y * kBlockJ) - 1;
    const int bz = (int)(blockIdx.x * kBlockK) - 1;
    for (int e = tid; e < 3 * kTV; e += kBlockK * kBlockJ * kBlockI) {
      const int q = e / kTV, r = e - q * kTV;
      const int tx = r / (kTY * kTZ), r2 = r - tx * (kTY * kTZ);
      const int ty = r2 / kTZ, tz = r2 - ty * kTZ;
      const float* f = q == 0 ? u : (q == 1 ? v : w);
      const int nx = ni + (q == 0), ny = nj + (q == 1), nz = nk + (q == 2);
      tile[q][r] = __ldg(f + (gfs::clampi(bx + tx, 0, nx - 1) * ny +
                              gfs::clampi(by + ty, 0, ny - 1)) * nz +
                         gfs::clampi(bz + tz, 0, nz - 1));
    }
    __syncthreads();
  }
""" + _DMC_RETURN
_DMC_TILE_FACES = """  const unsigned su = (unsigned)nj * nk;
  const int a = i - (int)(blockIdx.z * kBlockI) + 1;
  const int b = j - (int)(blockIdx.y * kBlockJ) + 1;
  const int c = k - (int)(blockIdx.x * kBlockK) + 1;
  auto at = [&](int q, int x, int y, int z) {
    return tile[q][(x * kTY + y) * kTZ + z];
  };
  const float vu = 0.5f * (at(0, a, b, c) + at(0, a + 1, b, c));
  const float vv = 0.5f * (at(1, a, b, c) + at(1, a, b + 1, c));
  const float vw = 0.5f * (at(2, a, b, c) + at(2, a, b, c + 1));
  const bool sx = vu > 0.0f, sy = vv > 0.0f, sz = vw > 0.0f;
  const int ua = sx ? a - 1 : a + 1, ub = sy ? b - 1 : b + 1,
            uc = sz ? c - 1 : c + 1;
  const float tu_ = 0.5f * (at(0, ua, ub, uc) + at(0, ua + 1, ub, uc));
  const float tv_ = 0.5f * (at(1, ua, ub, uc) + at(1, ua, ub + 1, uc));
  const float tw_ = 0.5f * (at(2, ua, ub, uc) + at(2, ua, ub, uc + 1));
"""


def _dmc_block(k, j, i):
    return [(_DMC_BLOCK, f"constexpr int kBlockK = {k}, kBlockJ = {j}, "
             f"kBlockI = {i};")]


DMC = {
    "shipped (32x4x1 block, shared weight set, z pairs)": [],
    "32x1x1 block": _dmc_block(32, 1, 1),
    "32x2x2 block": _dmc_block(32, 2, 2),
    "32x8x1 block (256 threads)": _dmc_block(32, 8, 1),
    "64x2x1 block": _dmc_block(64, 2, 1),
    "z corners clamped one by one (8 addresses a sample)": [
        ("struct Params {", _PER_CORNER + "struct Params {"),
        ("    const ZPair z = zpair((float)k - disp_z, nk);",
         "    const Coord z = coord((float)k - disp_z, nk);"),
        ("    out[idx] = trilerp_zpair(maps,", "    out[idx] = trilerp(maps,"),
        ("    out[n + idx] = trilerp_zpair(maps + n,",
         "    out[n + idx] = trilerp(maps + n,"),
        ("    out[2 * n + idx] = trilerp_zpair(maps + 2 * n,",
         "    out[2 * n + idx] = trilerp(maps + 2 * n,")],
    "at most 64 registers": [
        ("__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI)",
         "__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI, 8)")],
    "velocity tile in shared memory (1-cell halo)": [
        (_DMC_RETURN, _DMC_TILE_LOAD), (_DMC_FACES, _DMC_TILE_FACES)],
}

_VOL9_TILE = "constexpr int kBlockK = 32, kBlockJ = 4, kBlockI = 1;"
_VOL9_BOUNDS = ("__global__ void __launch_bounds__(kBlockK * kBlockJ * "
                "kBlockI)\n")
# the division of jacobi_diffuse.cu: the hoisted reciprocal refined with
# the exact remainder, the full division outside its range
_DIVIDE = """__device__ __forceinline__ float divide(float a, float d, float r) {
  const float m = fabsf(a);
  if (m >= 0x1p-64f && m <= 0x1p100f) {
    const float q = __fmul_rn(a, r);
    return __fmaf_rn(r, __fmaf_rn(q, -d, a), q);
  }
  return a == 0.0f ? a : a / d;
}

struct Params {"""
# the 9 map samples each from its own floor set, the 3 map channels
# sharing it (27 divisions, 9 weight sets and 216 loads a node)
_VOL9_PER_POINT = """  float m[3][9];
  const float dh[3] = {-0.25f * h, 0.0f * h, 0.25f * h};
  constexpr int kQ[9][3] = {{2, 2, 2}, {2, 2, 0}, {2, 0, 2}, {2, 0, 0},
                            {0, 2, 2}, {0, 2, 0}, {0, 0, 2}, {0, 0, 0},
                            {1, 1, 1}};
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const Coord X = coord((x0 + dh[kQ[q][0]]) / h, ni);
    const Coord Y = coord((y0 + dh[kQ[q][1]]) / h, nj);
    const ZPair Z = zpair((z0 + dh[kQ[q][2]]) / h, nk);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      m[a][q] = fminf(fmaxf(trilerp_zpair(maps + a * map_size, X, Y, Z,
                                          (unsigned)nj * nk, (unsigned)nk),
                            p.lo[a]), p.hi[a]);
  }
"""
# the 27 clamped map samples of each thread kept in shared memory, not in
# registers, between the map and the field stage
_VOL9_SHARED_M = """  constexpr int kT = kBlockK * kBlockJ * kBlockI;
  __shared__ float ms[3][9][kT];
  const int tid = (threadIdx.z * kBlockJ + threadIdx.y) * kBlockK +
                  threadIdx.x;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float s[9];
    gfs::stencil9(maps + a * map_size, ax, ay, az, s);
#pragma unroll
    for (int q = 0; q < 9; ++q)
      ms[a][q][tid] = fminf(fmaxf(s[q], p.lo[a]), p.hi[a]);
  }

"""
_VOL9_SRC = (CSRC / "vol9_fixup.cu").read_text()
_VOL9_MAP_STAGE = _VOL9_SRC[_VOL9_SRC.index("  float m[3][9];\n"):
                            _VOL9_SRC.index("  // field stage:")]


def _vol9_tile(k, j, i):
    return [(_VOL9_TILE, f"constexpr int kBlockK = {k}, kBlockJ = {j}, "
             f"kBlockI = {i};")]


VOL9 = {
    "shipped (32x4x1 tile, 27-node map neighbourhood, IEEE division)": [],
    "32x2x1 tile": _vol9_tile(32, 2, 1),
    "32x8x1 tile (256 threads)": _vol9_tile(32, 8, 1),
    "64x4x1 tile (256 threads)": _vol9_tile(64, 4, 1),
    "32x4x2 tile (256 threads)": _vol9_tile(32, 4, 2),
    "at most 96 registers": [(_VOL9_BOUNDS, _VOL9_BOUNDS.replace(
        "kBlockI)", "kBlockI, 5)"))],
    "at most 80 registers": [(_VOL9_BOUNDS, _VOL9_BOUNDS.replace(
        "kBlockI)", "kBlockI, 6)"))],
    "at most 64 registers": [(_VOL9_BOUNDS, _VOL9_BOUNDS.replace(
        "kBlockI)", "kBlockI, 8)"))],
    "hoisted reciprocal and exact-remainder division": [
        ("struct Params {", _DIVIDE),
        ("  const float c[3] = {(x0 + -0.25f * h) / h, (x0 + 0.0f * h) / h,\n"
         "                      (x0 + 0.25f * h) / h};",
         "  const float r = 1.0f / h;\n"
         "  const float c[3] = {divide(x0 + -0.25f * h, h, r),\n"
         "                      divide(x0 + 0.0f * h, h, r),\n"
         "                      divide(x0 + 0.25f * h, h, r)};"),
        ("  const unsigned sx = (unsigned)ny * nz, sy = (unsigned)nz;",
         "  const unsigned sx = (unsigned)ny * nz, sy = (unsigned)nz;\n"
         "  const float rcp = 1.0f / h;"),
        ("coord(m[0][q] / h - p.off[0], nx)",
         "coord(divide(m[0][q], h, rcp) - p.off[0], nx)"),
        ("coord(m[1][q] / h - p.off[1], ny)",
         "coord(divide(m[1][q], h, rcp) - p.off[1], ny)"),
        ("zpair(m[2][q] / h - p.off[2], nz)",
         "zpair(divide(m[2][q], h, rcp) - p.off[2], nz)")],
    "map sampled per stencil point (one weight set a point, no "
    "neighbourhood)": [(_VOL9_MAP_STAGE, _VOL9_PER_POINT)],
    "map sampled per stencil point, at most 64 registers": [
        (_VOL9_MAP_STAGE, _VOL9_PER_POINT),
        (_VOL9_BOUNDS, _VOL9_BOUNDS.replace("kBlockI)", "kBlockI, 8)"))],
    "coordinate 0's up flag computed (its lerps select)": [
        ("    a.up[q] = q > 0 && fl != base;", "    a.up[q] = fl != base;")],
    "1 - f kept per map coordinate (9 registers, 153 subtractions fewer)": [
        ("  float f[3];\n  unsigned node[3];", "  float f[3], w[3];\n  unsigned node[3];"),
        ("    a.f[q] = c[q] - fl;\n", "    a.f[q] = c[q] - fl;\n    a.w[q] = 1.0f - a.f[q];\n"),
        ("        X[q][b] = lerp(ax.f[q], lo, hi);",
         "        X[q][b] = ax.w[q] * lo + ax.f[q] * hi;"),
        ("      Y[p][c] = lerp(ay.f[qy], lo, hi);",
         "      Y[p][c] = ay.w[qy] * lo + ay.f[qy] * hi;"),
        ("    return lerp(az.f[qz], lo, hi);",
         "    return az.w[qz] * lo + az.f[qz] * hi;")],
    "mapped positions staged in shared memory (27 registers fewer)": [
        (_VOL9_MAP_STAGE, _VOL9_SHARED_M),
        ("coord(m[0][q] / h", "coord(ms[0][q][tid] / h"),
        ("coord(m[1][q] / h", "coord(ms[1][q][tid] / h"),
        ("zpair(m[2][q] / h", "zpair(ms[2][q][tid] / h")],
}


# the two smoothers share csrc/gs_wavefront.cuh: region shapes, rows a
# thread and the segment rule are its constants
_GS_KERNEL = ("template <int L, Op kOp>\n__global__ void "
              "__launch_bounds__(kThreads, kMinBlocks)")
# a / d from RN(1/d) for the integral diagonals and one correction by the
# exact remainder (Markstein), zero and out-of-range numerators by a / d
_GS_QUOTIENT = """__constant__ float kReciprocal[8] = {0.0f, 1.0f, 0x1p-1f, 0x1.555556p-2f,
                                     0x1p-2f, 0x1.99999ap-3f, 0x1.555556p-3f,
                                     0x1.24924ap-3f};

__device__ __forceinline__ float quotient(float a, int d) {
  const float df = (float)d, m = fabsf(a);
  if (d >= 1 && m >= 0x1p-64f && m <= 0x1p100f) {
    const float r = kReciprocal[d & 7];
    const float q = __fmul_rn(a, r);
    return __fmaf_rn(r, __fmaf_rn(q, -df, a), q);
  }
  return d >= 1 && a == 0.0f ? a : a / df;
}

"""
_GS_WARPS = "constexpr int kWarpsJ = 16;"
_GS_ROWS = "constexpr int kRegionJ = 32;"
RBGS = {
    "shipped (32x64 region, 16 warps, 2 rows a thread)": [],
    "32x64 region, 8 warps, 4 rows a thread": [
        (_GS_WARPS, "constexpr int kWarpsJ = 8;")],
    "16x64 region (8 warps)": [
        (_GS_ROWS, "constexpr int kRegionJ = 16;"),
        (_GS_WARPS, "constexpr int kWarpsJ = 8;")],
    "blocks fill the card twice over (two waves)": [
        ("constexpr int kWaves = 1;", "constexpr int kWaves = 2;")],
    "segments of at least 2L planes (fewer blocks on small grids)": [
        ("segs = min(segs, max(1, nx / L));",
         "segs = min(segs, max(1, nx / (2 * L)));")],
    "registers for 2 blocks an SM (at most 64)": [
        ("constexpr int kMinBlocks = 1;", "constexpr int kMinBlocks = 2;")],
    "update computed on every row and cell, kept where it applies": [
        ("""        float2 v = cur[t - 1][q];
        if (u) {""", """        float2 v = cur[t - 1][q];
        {"""),
        ("""          if (e)
            v.y = res;
          else
            v.x = res;""", """          if (u && e)
            v.y = res;
          else if (u)
            v.x = res;""")],
    "remainder division (RN(1/d) from a table, one correction)": [
        (_GS_KERNEL, _GS_QUOTIENT + _GS_KERNEL),
        ("(nb + (e ? bq[t - 1][q].y : bq[t - 1][q].x)) / (float)d;",
         "quotient(nb + (e ? bq[t - 1][q].y : bq[t - 1][q].x), d);")],
}
# the masked operator's diagonal recounted at every level from the flags
# (6 byte loads an update through L1, as the first port did) instead of
# formed once per plane at load
_GS_RECOUNT = """__device__ __forceinline__ unsigned opened(
    const uint8_t* __restrict__ f, unsigned off) {
  return __ldg(f + off) <= 1u ? 1u : 0u;
}

__device__ __forceinline__ unsigned recount(const uint8_t* __restrict__ f,
                                            unsigned off, int i, int j,
                                            int k, int nx, int ny, int nz,
                                            unsigned ps) {
  return (i < nx - 1 ? opened(f, off + ps) : 0u) +
         (i > 0 ? opened(f, off - ps) : 0u) +
         (j < ny - 1 ? opened(f, off + (unsigned)nz) : 0u) +
         (j > 0 ? opened(f, off - (unsigned)nz) : 0u) +
         (k < nz - 1 ? opened(f, off + 1u) : 0u) +
         (k > 0 ? opened(f, off - 1u) : 0u);
}

"""
MASKED_RBGS = dict(RBGS)
MASKED_RBGS["diagonal recounted at every level from the flags"] = [
    (_GS_KERNEL, _GS_RECOUNT + _GS_KERNEL),
    ("""            d = max((int)((cnt[q] >> (6 * (t - 1) + 3 * e)) & 7u), 1);""",
     """            d = max((int)recount(flags, col[q] + e + (unsigned)i * ps, i,
                                 j0 + jr[q], k0 + 2 * lp + e, nx, ny, nz,
                                 ps), 1);""")]


_MM_BODY = """    const Corners v =
        gfs::corners_zpair(fields + c * field_size, cx, cy, cz, sx, sy);
    float lo[2], hi[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      lo[p] = fminf(fminf(v.v[0][p], v.v[1][p]), fminf(v.v[2][p], v.v[3][p]));
      hi[p] = fmaxf(fmaxf(v.v[0][p], v.v[1][p]), fmaxf(v.v[2][p], v.v[3][p]));
    }
    const unsigned o = c * n_out + idx;
    mn_out[o] = cz.top ? lo[1] : (cz.bottom ? lo[0] : fminf(lo[0], lo[1]));
    mx_out[o] = cz.top ? hi[1] : (cz.bottom ? hi[0] : fmaxf(hi[0], hi[1]));
    if (kSample) sample_out[o] = gfs::blend_zpair(v, cx, cy, cz);"""
# the first port's corners: both z corners clamped one by one, eight
# addresses, the min and max over all eight, the plain blend
_MM_EIGHT = """    const float* f = fields + c * field_size;
    const unsigned xa = cx.lo * sx, xb = cx.hi * sx;
    const unsigned ya = cy.lo * sy, yb = cy.hi * sy;
    float v[2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const unsigned zz = p ? cz.hi : cz.lo;
      v[p][0] = __ldg(f + (xa + ya + zz));
      v[p][1] = __ldg(f + (xb + ya + zz));
      v[p][2] = __ldg(f + (xa + yb + zz));
      v[p][3] = __ldg(f + (xb + yb + zz));
    }
    float lo = v[0][0], hi = v[0][0];
#pragma unroll
    for (int q = 1; q < 8; ++q) {
      lo = fminf(lo, v[q / 4][q % 4]);
      hi = fmaxf(hi, v[q / 4][q % 4]);
    }
    const unsigned o = c * n_out + idx;
    mn_out[o] = lo;
    mx_out[o] = hi;
    if (kSample) {
      const float c00 = cx.w * v[0][0] + cx.f * v[0][1];
      const float c10 = cx.w * v[0][2] + cx.f * v[0][3];
      const float c01 = cx.w * v[1][0] + cx.f * v[1][1];
      const float c11 = cx.w * v[1][2] + cx.f * v[1][3];
      const float l0 = cy.w * c00 + cy.f * c10;
      const float l1 = cy.w * c01 + cy.f * c11;
      sample_out[o] = cz.w * l0 + cz.f * l1;
    }"""
MINMAX = {
    "shipped (32x4x1 block, shared floors, z pairs)": [],
    "per-channel floors": [
        ("shared = shared && offs.o[c][a] == offs.o[0][a];",
         "shared = false;")],
    "eight loads (z corners clamped one by one)": [
        ("  ZPair cz;\n", "  Coord cz;\n"),
        ("cz = zpair(z - offs.o[c][2], nz);", "cz = coord(z - offs.o[c][2], "
         "nz);"),
        (_MM_BODY, _MM_EIGHT)],
    "32x2x2 block": [("kBlockK = 32, kBlockJ = 4, kBlockI = 1;",
                      "kBlockK = 32, kBlockJ = 2, kBlockI = 2;")],
}

_PB_BLOCK = "constexpr int kBlockK = 32, kBlockJ = 2, kBlockI = 2;"
_PB_BELOW = """        const unsigned below = bi * si + bj * sj + bk;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          g[a] = 0.5f * (__ldg(maps + (a * map_size + below)) / h + g[a]);"""
# the node one lower along k is the neighbouring lane's node: its divided
# map values come by a shuffle (lane 0 of each warp loads its own), so no
# thread may leave before the shuffle
_PB_SHUFFLE = [
    ("  if (k >= ez || j >= ey || i >= ex) return;\n",
     "  const bool inside = k < ez && j < ey && i < ex;\n"),
    ("    out[ch.slot[c] * n_node + idx] =\n",
     "    if (inside) out[ch.slot[c] * n_node + idx] =\n"),
    (_PB_BELOW, """        const unsigned below = bi * si + bj * sj + bk;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float b;
          if (s == 2) {
            b = __shfl_up_sync(0xffffffffu, m[a], 1);
            if (threadIdx.x == 0)
              b = __ldg(maps + (a * map_size + below)) / h;
          } else {
            b = __ldg(maps + (a * map_size + below)) / h;
          }
          g[a] = 0.5f * (b + g[a]);
        }""")]
_PB_SRC = (CSRC / "pullback_sample.cu").read_text()
_PB_KERNEL = _PB_SRC[_PB_SRC.index("__global__ void __launch_bounds__"):
                     _PB_SRC.index("}  // namespace")]
# one thread a (channel, node): blockIdx.z runs over the channels' block
# rows, each thread loads the map values its channel needs and samples it
_PB_PER_CHANNEL = """__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI)
    pullback_sample_kernel(const float* __restrict__ maps, int ni, int nj,
                           int nk, Channels ch, int C, int ex, int ey, int ez,
                           float h, float lo, float hx, float hy, float hz,
                           float* __restrict__ out) {
  const int nbi = (ex + kBlockI - 1) / kBlockI;
  const int c = blockIdx.z / nbi;
  const int k = blockIdx.x * kBlockK + threadIdx.x;
  const int j = blockIdx.y * kBlockJ + threadIdx.y;
  const int i = (blockIdx.z - c * nbi) * kBlockI + threadIdx.z;
  if (k >= ez || j >= ey || i >= ex) return;
  const float* f = ch.f[0];
  int nx = ch.n[0][0], ny = ch.n[0][1], nz = ch.n[0][2];
  int s = ch.stag[0], slot = ch.slot[0];
#pragma unroll
  for (int q = 1; q < kMaxC; ++q)
    if (c == q) {
      f = ch.f[q];
      nx = ch.n[q][0];
      ny = ch.n[q][1];
      nz = ch.n[q][2];
      s = ch.stag[q];
      slot = ch.slot[q];
    }
  const unsigned n_node = (unsigned)ex * ey * ez;
  const unsigned idx = ((unsigned)i * ey + j) * ez + k;
  const unsigned sj = nk, si = (unsigned)nj * nk, map_size = si * ni;
  const int ci = min(i, ni - 1), cj = min(j, nj - 1), ck = min(k, nk - 1);
  const unsigned at = ci * si + cj * sj + ck;
  float g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) g[a] = __ldg(maps + (a * map_size + at)) / h;
  if (s >= 0) {
    const int bi = max(min(i - (s == 0), ni - 1), 0);
    const int bj = max(min(j - (s == 1), nj - 1), 0);
    const int bk = max(min(k - (s == 2), nk - 1), 0);
    const unsigned below = bi * si + bj * sj + bk;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      g[a] = 0.5f * (__ldg(maps + (a * map_size + below)) / h + g[a]);
  }
  const float hi[3] = {hx, hy, hz};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    g[a] = fminf(fmaxf(g[a], lo), hi[a]) + (s == a ? 0.5f : 0.0f);
  const Coord cx = coord(g[0], nx), cy = coord(g[1], ny);
  const ZPair cz = zpair(g[2], nz);
  out[slot * n_node + idx] =
      gfs::trilerp_zpair(f, cx, cy, cz, (unsigned)ny * nz, nz);
}

"""
# the block's map values in grid units staged in shared memory with the
# face one node lower along each staggered axis: each value divided once a
# block, the below-nodes read from the tile
_PB_TILE = """__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI)
    pullback_sample_kernel(const float* __restrict__ maps, int ni, int nj,
                           int nk, Channels ch, int C, int ex, int ey, int ez,
                           float h, float lo, float hx, float hy, float hz,
                           float* __restrict__ out) {
  __shared__ float tile[3][kBlockI + 1][kBlockJ + 1][kBlockK + 1];
  const int tk = threadIdx.x, tj = threadIdx.y, ti = threadIdx.z;
  const int k = blockIdx.x * kBlockK + tk;
  const int j = blockIdx.y * kBlockJ + tj;
  const int i = blockIdx.z * kBlockI + ti;
  const bool inside = k < ez && j < ey && i < ex;
  const unsigned n_node = (unsigned)ex * ey * ez;
  const unsigned idx = ((unsigned)i * ey + j) * ez + k;
  const unsigned sj = nk, si = (unsigned)nj * nk, map_size = si * ni;
  const int ci = min(i, ni - 1), cj = min(j, nj - 1), ck = min(k, nk - 1);
  const unsigned at = ci * si + cj * sj + ck;
  float m[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    m[a] = __ldg(maps + (a * map_size + at)) / h;
    tile[a][ti + 1][tj + 1][tk + 1] = m[a];
  }
  int mask = 0;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C && ch.stag[c] >= 0) mask |= 1 << ch.stag[c];
  if ((mask & 1) && ti == 0) {
    const unsigned b = max(min(i - 1, ni - 1), 0) * si + cj * sj + ck;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      tile[a][0][tj + 1][tk + 1] = __ldg(maps + (a * map_size + b)) / h;
  }
  if ((mask & 2) && tj == 0) {
    const unsigned b = ci * si + max(min(j - 1, nj - 1), 0) * sj + ck;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      tile[a][ti + 1][0][tk + 1] = __ldg(maps + (a * map_size + b)) / h;
  }
  if ((mask & 4) && tk == 0) {
    const unsigned b = ci * si + cj * sj + max(min(k - 1, nk - 1), 0);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      tile[a][ti + 1][tj + 1][0] = __ldg(maps + (a * map_size + b)) / h;
  }
  __syncthreads();
  if (!inside) return;
  const float hi[3] = {hx, hy, hz};
  Coord cx, cy;
  ZPair cz;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= C) break;
    const int s = ch.stag[c];
    if (c == 0 || s != ch.stag[c - 1]) {
      float g[3] = {m[0], m[1], m[2]};
      if (s >= 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          g[a] = 0.5f * (tile[a][ti + 1 - (s == 0)][tj + 1 - (s == 1)]
                             [tk + 1 - (s == 2)] + g[a]);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
        g[a] = fminf(fmaxf(g[a], lo), hi[a]) + (s == a ? 0.5f : 0.0f);
      cx = coord(g[0], ch.n[c][0]);
      cy = coord(g[1], ch.n[c][1]);
      cz = zpair(g[2], ch.n[c][2]);
    }
    const unsigned sz = ch.n[c][2], sy = (unsigned)ch.n[c][1] * sz;
    out[ch.slot[c] * n_node + idx] =
        gfs::trilerp_zpair(ch.f[c], cx, cy, cz, sy, sz);
  }
}

"""
# a cost probe, not an exact design: the divisions by h as products with
# 1/h (the results differ in the last bits)
_PB_PRODUCT = [
    ("  for (int a = 0; a < 3; ++a) m[a] = __ldg(maps + (a * map_size + at)) / h;",
     "  const float rh = 1.0f / h;\n"
     "  for (int a = 0; a < 3; ++a) m[a] = __ldg(maps + (a * map_size + at)) * rh;"),
    ("          g[a] = 0.5f * (__ldg(maps + (a * map_size + below)) / h + g[a]);",
     "          g[a] = 0.5f * (__ldg(maps + (a * map_size + below)) * rh + g[a]);")]
_PB_GRID = "                  (ex + kBlockI - 1) / kBlockI);"


def _pb_block(k, j, i):
    return [(_PB_BLOCK, f"constexpr int kBlockK = {k}, kBlockJ = {j}, "
             f"kBlockI = {i};")]


PULLBACK = {
    "shipped (32x2x2 block, a thread a node, below-nodes loaded)": [],
    "below node along k from the warp (shuffle)": _PB_SHUFFLE,
    "a thread a (channel, node), 32x2x2 block": [
        (_PB_KERNEL, _PB_PER_CHANNEL),
        (_PB_GRID, "                  C * ((ex + kBlockI - 1) / kBlockI));")],
    "map tile in shared memory (each value divided once a block)": [
        (_PB_KERNEL, _PB_TILE)],
    "probe, inexact: products with 1/h for the divisions": _PB_PRODUCT,
    "32x4x1 block": _pb_block(32, 4, 1),
    "32x8x1 block (256 threads)": _pb_block(32, 8, 1),
}


def build(out_dir, tag, source, edits, csrc=CSRC):
    """nvcc the edited source; returns the library and the ptxas lines
    (None and nvcc's errors if it does not build). An edit applies to the
    kernel's source or, where its text is not there, to the variant's own
    copy of the header that holds it. `csrc`: the kernel sources' folder
    (another tree's, for its design)."""
    from gpufluidsimulation_tpu_torch.ops import _build

    text = (csrc / f"{source}.cu").read_text()
    headers = {h.name: h.read_text() for h in sorted(csrc.glob("*.cuh"))}
    for old, new in edits:
        if old in text:
            text = text.replace(old, new)
            continue
        name = next((h for h, body in headers.items() if old in body), None)
        if name is None:
            raise SystemExit(f"{tag}: edit does not apply: {old[:60]!r}")
        headers[name] = headers[name].replace(old, new)
    src_dir = out_dir / tag
    src_dir.mkdir(parents=True, exist_ok=True)
    for name, body in headers.items():
        (src_dir / name).write_text(body)
    cu = src_dir / f"{source}.cu"
    cu.write_text(text)
    lib = out_dir / f"{tag}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(lib), str(cu)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        return None, [f"nvcc failed: {res.stdout}{res.stderr}"]
    ptxas = [line.strip().replace("ptxas info    : ", "")
             for line in (res.stdout + res.stderr).splitlines()
             if "registers" in line or "spill" in line]
    return ctypes.CDLL(str(lib)), ptxas + sass_counts(lib)


def sass_counts(lib):
    """Static SASS instructions of each kernel in `lib` (cuobjdump), in the
    order the library lists them; [] without cuobjdump."""
    from gpufluidsimulation_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return []
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True)
    counts, name = [], None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts.append([name, 0])
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[-1][1] += 1
    return [f"SASS {n[:60]}: {c} instructions" for n, c in counts]


def trilerp_variants(n, out_dir):
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    h = g.h

    def positions(kind):
        px, py, pz = g.node_coords(kind, device=dev)
        return [(p + cs.smooth(px.shape, rng, 2.0 * h, dev)).contiguous()
                for p in (px, py, pz)]

    fu = cs.smooth(g.shape_u, rng, 0.06, dev)[None].contiguous()
    fc = torch.stack([cs.smooth(g.shape_c, rng, 1.0, dev),
                      cs.smooth(g.shape_c, rng, 50.0, dev)]).contiguous()
    pu, pc = positions("u"), positions("c")
    cases = [("C=1 dual", fu, pu, g.OFF_U, True),
             ("C=2 dual", fc, pc, g.OFF_C, True),
             ("C=1 plain", fu, pu, g.OFF_U, False)]
    wants = [interp_fast.trilerp_sample_plain(f, *p, h, (o,) * len(f), d)
             for _, f, p, o, d in cases]
    F, I, P, LL = ctypes.c_float, ctypes.c_int, ctypes.c_void_p, \
        ctypes.c_longlong
    for i, (name, edits) in enumerate(TRILERP.items()):
        lib, ptxas = build(out_dir, f"trilerp_{i}", "trilerp_sample", edits)
        if lib is None:
            cs.log(f"[trilerp_sample] {name}: " + "; ".join(ptxas))
            continue
        fn = lib.gfs_trilerp_sample
        fn.argtypes = [P, I, I, I, I, P, P, P, LL, I, I, F,
                       ctypes.POINTER(F), I, P, P]
        fn.restype = I
        cs.log(f"[trilerp_sample] {name}: " + "; ".join(ptxas))
        for (label, f, p, off, dual), want in zip(cases, wants):
            C = f.shape[0]
            out = torch.empty((C,) + tuple(p[0].shape), device=dev)
            offs = (F * (3 * C))(*[float(x) for x in off * C])

            def run():
                err = fn(_build.ptr(f), C, *f.shape[1:],
                         *[_build.ptr(q) for q in p], p[0].numel(),
                         p[0].shape[-2], p[0].shape[-1], float(h), offs,
                         int(dual), _build.ptr(out), _build.stream(f))
                _build.check(err, name)

            run()
            err = float((out - want).abs().max())
            ms = cs.cuda_time(run, 30)
            cs.log(f"[trilerp_sample] {name}: {label} {ms:.4f} ms, "
                   f"max_abs_err {err:.3e}")


def jacobi_variants(n, out_dir):
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build
    from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    coef = 1e-6 * (8.0 / n) / (g.h * g.h)        # the main path's
    coef_f, denom_f = sk._coefs(coef)
    smooth = cs.smooth(g.shape_u, rng, 0.06, dev)
    half = smooth.clone()
    half[:, :, : half.shape[2] // 2] = 0.0
    fields = [("smooth", smooth), ("zero", torch.zeros_like(smooth)),
              ("half zero", half)]
    wants = [sk.jacobi_diffuse_plain(x, x, 20, coef) for _, x in fields]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for i, (name, edits) in enumerate(JACOBI.items()):
        lib, ptxas = build(out_dir, f"jacobi_{i}", "jacobi_diffuse",
                           [*edits, (_JACOBI_ONE, _JACOBI_MORE)])
        if lib is None:
            cs.log(f"[jacobi_diffuse] {name}: " + "; ".join(ptxas))
            continue
        fn = lib.gfs_jacobi_diffuse
        fn.argtypes = [P, P, I, I, I, F, F, I, P, P]
        fn.restype = I
        regs = [line.split(",")[0] for line in ptxas if "registers" in line]
        cs.log(f"[jacobi_diffuse] {name}: {regs} (sweeps a launch in the "
               "order ptxas builds them)")
        for (label, x), want in zip(fields, wants):
            times = []
            for per in (1, 2, 4, 8):
                bufs = [torch.empty_like(x), torch.empty_like(x)]

                def run():
                    src = x
                    for k, s in enumerate(sk.sweep_chunks(20, per)):
                        err = fn(_build.ptr(src), _build.ptr(x), *x.shape,
                                 coef_f, denom_f, s,
                                 _build.ptr(bufs[k % 2]), _build.stream(x))
                        _build.check(err, name)
                        src = bufs[k % 2]
                    return src

                err = float((run() - want).abs().max())
                times.append(f"{per} a launch {cs.cuda_time(run, 10):.4f} "
                             f"ms (max_abs_err {err:.3e})")
            cs.log(f"[jacobi_diffuse] {name}: {label} field, 20-sweep "
                   "solve: " + ", ".join(times))


def rk3_variants(n, out_dir):
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build, advect, interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    u, v, w = (cs.smooth(s, rng, 0.06, dev)
               for s in (g.shape_u, g.shape_v, g.shape_w))
    top = max(float(t.abs().max()) for t in (u, v, w))
    sh = float(np.float32(np.float32(g.h) / np.float32(top))
               / np.float32(g.h))
    clamp = advect._clamp_grid(g)
    lat, _ = advect._cropped_positions(g, "c", dev)
    pos = (lat + torch.stack([cs.smooth(g.shape_c, rng, 2.0, dev)
                              for _ in range(3)])).contiguous()
    cases = [("displaced", pos, interp_fast.rk3_substep_plain(
        u, v, w, pos, sh, clamp)),
             ("lattice", None, interp_fast.rk3_substep_plain(
                 u, v, w, lat.contiguous(), sh, clamp))]
    F, I, P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    coefs = interp_fast.rk3_coefficients(sh)
    dim = (F * 3)(0.0, 0.0, 0.0)
    clamp_host = (F * 6)(*clamp)
    for i, (name, edits) in enumerate(RK3.items()):
        lib, ptxas = build(out_dir, f"rk3_{i}", "rk3_substep", edits)
        cs.log(f"[rk3_substep] {name}: " + "; ".join(ptxas))
        if lib is None:
            continue
        fn = lib.gfs_rk3_substep
        fn.argtypes = [P, P, P, I, I, I, P, I, I, I, ctypes.POINTER(F),
                       F, F, F, F, F, ctypes.POINTER(F), P, P]
        fn.restype = I
        for label, p, want in cases:
            out = torch.empty_like(want)

            def run():
                err = fn(_build.ptr(u), _build.ptr(v), _build.ptr(w), n, n,
                         n, None if p is None else _build.ptr(p), n, n, n,
                         dim, *coefs, clamp_host, _build.ptr(out),
                         _build.stream(u))
                _build.check(err, name)

            run()
            err = float((out - want).abs().max())
            ms = cs.cuda_time(run, 30)
            cs.log(f"[rk3_substep] {name}: {label} {ms:.4f} ms, "
                   f"max_abs_err {err:.3e}")


def prefilter_variants(n, out_dir):
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    cases = [("C=1 u", cs.smooth(g.shape_u, rng, 0.06, dev)[None]
              .contiguous()),
             ("C=2 c", torch.stack([cs.smooth(g.shape_c, rng, 1.0, dev),
                                    cs.smooth(g.shape_c, rng, 50.0, dev)])
              .contiguous())]
    wants = [interp_fast.volume_prefilter_plain(f) for _, f in cases]
    P, I = ctypes.c_void_p, ctypes.c_int
    for i, (name, edits) in enumerate(PREFILTER.items()):
        lib, ptxas = build(out_dir, f"prefilter_{i}", "volume_prefilter",
                           edits)
        cs.log(f"[volume_prefilter] {name}: " + "; ".join(ptxas))
        if lib is None:
            continue
        fn = lib.gfs_volume_prefilter
        fn.argtypes = [P, I, I, I, I, P, P]
        fn.restype = I
        for (label, f), want in zip(cases, wants):
            out = torch.empty_like(f)

            def run():
                err = fn(_build.ptr(f), *f.shape, _build.ptr(out),
                         _build.stream(f))
                _build.check(err, name)

            run()
            err = float((out - want).abs().max())
            ms = cs.cuda_time(run, 50)
            cs.log(f"[volume_prefilter] {name}: {label} {ms:.4f} ms, "
                   f"max_abs_err {err:.3e}")


def dmc_variants(n, out_dir):
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    u, v, w = (cs.smooth(s, rng, 0.06, dev)
               for s in (g.shape_u, g.shape_v, g.shape_w))
    top = max(float(t.abs().max()) for t in (u, v, w))
    sh = float(np.float32(np.float32(g.h) / np.float32(top))
               / np.float32(g.h))
    thresh = interp_fast.dmc_threshold(g.h)
    maps = (torch.stack(g.node_coords("c", device=dev)) + torch.stack(
        [cs.smooth(g.shape_c, rng, 2.0 * g.h, dev) for _ in range(3)]))
    maps = maps.contiguous()
    cases = [("displaced", maps,
              interp_fast.dmc_substep_plain(u, v, w, maps, sh, thresh)),
             ("lattice", None, interp_fast.dmc_substep_lattice_plain(
                 u, v, w, sh, thresh, g.h))]
    F, I, P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    hi = (F * 3)(*[float((m - 1) * g.h) for m in g.shape_c])
    for i, (name, edits) in enumerate(DMC.items()):
        lib, ptxas = build(out_dir, f"dmc_{i}", "dmc_substep", edits)
        cs.log(f"[dmc_substep] {name}: " + "; ".join(ptxas))
        if lib is None:
            continue
        fn = lib.gfs_dmc_substep
        fn.argtypes = [P, P, P, I, I, I, P, F, F, F, ctypes.POINTER(F), P, P]
        fn.restype = I
        for label, m, want in cases:
            out = torch.empty_like(want)

            def run():
                err = fn(_build.ptr(u), _build.ptr(v), _build.ptr(w), n, n,
                         n, None if m is None else _build.ptr(m), sh, thresh,
                         float(g.h), hi, _build.ptr(out), _build.stream(u))
                _build.check(err, name)

            run()
            err = float((out - want).abs().max())
            ms = cs.cuda_time(run, 30)
            cs.log(f"[dmc_substep] {name}: {label} {ms:.4f} ms, "
                   f"max_abs_err {err:.3e}")


def vol9_variants(n, out_dir):
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    maps = (torch.stack(g.node_coords("c", device=dev)) + torch.stack(
        [cs.smooth(g.shape_c, rng, 2.0 * g.h, dev) for _ in range(3)]))
    maps = maps.contiguous()
    _, block, nb = interp_fast.vol9_blocks(g.shape_c)
    cases = []
    for label, kind, C, clamp in (("C=1 u", "u", 1, 0.0),
                                  ("C=2 c", "c", 2, 1.0)):
        f = torch.stack([cs.smooth(g.shape_of(kind), rng, 1.0, dev)
                         for _ in range(C)]).contiguous()
        duals = torch.zeros_like(f)
        # every block flagged: the work of tol = 0
        flags = torch.ones((C,) + nb, dtype=torch.bool, device=dev)
        want = interp_fast._vol9_merge_plain(duals, f, maps, flags, g, kind,
                                             clamp, clamp)
        lo, hi = interp_fast.clamp_bounds(g, clamp, clamp)
        params = (ctypes.c_float * 9)(*g.off_of(kind), *lo, *hi)
        cases.append((label, f, flags.to(torch.uint8), params, want))
    F, I, P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    for i, (name, edits) in enumerate(VOL9.items()):
        lib, ptxas = build(out_dir, f"vol9_{i}", "vol9_fixup", edits)
        cs.log(f"[vol9_fixup] {name}: " + "; ".join(ptxas))
        if lib is None:
            continue
        fn = lib.gfs_vol9_fixup
        fn.argtypes = [P, I, I, I, P, I, I, I, I, P, I, I, I, I, I, I, F,
                       ctypes.POINTER(F), P, P]
        fn.restype = I
        for label, f, flags, params, want in cases:
            out = torch.zeros_like(f)

            def run():
                err = fn(_build.ptr(maps), *g.shape_c, _build.ptr(f),
                         f.shape[0], *f.shape[1:], _build.ptr(flags), *nb,
                         *block, float(g.h), params, _build.ptr(out),
                         _build.stream(f))
                _build.check(err, name)

            run()
            err = float((out - want).abs().max())
            ms = cs.cuda_time(run, 10)
            cs.log(f"[vol9_fixup] {name}: {label} tol=0 {ms:.4f} ms, "
                   f"max_abs_err {err:.3e}")


def smoother_variants(name, table, n, out_dir, rounds=4):
    """Each build's 2-sweep call (the V-cycle's post-smoother form: from x,
    reverse) at n^3 and 32^3, at 4 colour levels a launch (one launch) and
    at 2 (two launches, ping-ponged), against the plain version, timed on
    the card by torch.profiler (the 32^3 call is host-bound under CUDA
    events); the masked kernel on the obstacle scene's flags coarsened to
    each grid. Every variant is built first; after a second of load that
    brings the card's clocks up, the variants are timed in `rounds`
    rounds, forward and backward in turn, and each reports its median, so
    that no variant gains from its place in the order."""
    import time

    import torch

    from gpufluidsimulation_tpu_torch.ops import _build
    from gpufluidsimulation_tpu_torch.ops import stencil_kernels as sk

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    masked = name == "masked_rbgs_smooth"
    levels = cs.obstacle_flag_levels((n, n, n), dev)
    cases = []
    for shape in dict.fromkeys([(n, n, n), (32, 32, 32)]):
        b = cs.smooth(shape, rng, 1.0, dev)
        x = cs.smooth(shape, rng, 1.0, dev)
        flags = levels.get(shape)
        if flags is None:
            flags = cs.obstacle_flag_levels(shape, dev)[shape]
        want = (sk.masked_rbgs_smooth_plain(x, b, flags, 2, True) if masked
                else sk.rbgs_smooth_plain(x, b, "neumann", 2, True))
        cases.append(("x".join(map(str, shape)), x, b, flags, want))
    P, I = ctypes.c_void_p, ctypes.c_int
    symbol = "gfs_masked_rbgs_smooth" if masked else "gfs_rbgs_smooth"
    built = []
    for i, (label, edits) in enumerate(table.items()):
        # each build in its own namespace: libraries whose kernels share a
        # mangled name must not meet in one process
        unique = [("namespace gs {", f"namespace gs{i} {{"),
                  ("gs::", f"gs{i}::")]
        lib, ptxas = build(out_dir, f"{name}_{i}", name, edits + unique)
        cs.log(f"[{name}] {label}: " + "; ".join(ptxas))
        if lib is None:
            continue
        fn = getattr(lib, symbol)
        fn.argtypes = [P, P] + ([P, I, I, I] if masked else [I] * 4) + [
            I, I, P, P]
        fn.restype = I
        built.append((label, fn))

    def call(fn, label, x, b, flags, per, bufs):
        src = x
        for k, levels_ in enumerate(sk.level_chunks(2, per)):
            extra = ([_build.ptr(flags)] if masked else [])
            err = fn(_build.ptr(src), _build.ptr(b), *extra, *b.shape,
                     *([] if masked else [1]), 1, levels_,
                     _build.ptr(bufs[k % 2]), _build.stream(b))
            _build.check(err, label)
            src = bufs[k % 2]
        return src

    for shape, x, b, flags, want in cases:
        bufs = [torch.empty_like(b), torch.empty_like(b)]
        errs, times = {}, {}
        for label, fn in built:
            for per in (4, 2):
                try:
                    got = call(fn, label, x, b, flags, per, bufs)
                    errs[label, per] = float((got - want).abs().max())
                except RuntimeError as exc:
                    errs[label, per] = str(exc)
        runnable = [(label, fn) for label, fn in built
                    if not isinstance(errs[label, 4], str)]
        t0 = time.time()
        while time.time() - t0 < 1.0:
            for label, fn in runnable:
                call(fn, label, x, b, flags, 4, bufs)
            torch.cuda.synchronize()
        for r in range(rounds):
            for label, fn in (runnable if r % 2 == 0 else runnable[::-1]):
                for per in (4, 2):
                    if isinstance(errs[label, per], str):
                        continue
                    times.setdefault((label, per), []).append(cs.device_ms(
                        lambda: call(fn, label, x, b, flags, per, bufs), 20,
                        "levels_kernel"))
        for label, _ in built:
            parts = []
            for per in (4, 2):
                if isinstance(errs[label, per], str):
                    parts.append(f"{per} levels a launch: {errs[label, per]}")
                    continue
                ms = times[label, per]
                parts.append(f"{per} levels a launch {np.median(ms):.4f} ms "
                             f"on the card (median of {len(ms)}, "
                             f"{min(ms):.4f}-{max(ms):.4f}; max_abs_err "
                             f"{errs[label, per]:.3e})")
            cs.log(f"[{name}] {label}: {shape} 2-sweep call: "
                   + ", ".join(parts))


def _own_namespace(i):
    """Edits that put a build's kernels in namespace v<i>: libraries whose
    kernels share a mangled name must not meet in one process."""
    return [("namespace {", f"namespace v{i} {{"),
            ("}  // namespace", f"}}  // namespace\nusing namespace v{i};")]


def _interleaved(entries, rounds, reps=20):
    """Median ms of each (key, fn) in `entries` over `rounds` rounds, the
    order reversed every other round, after a second of load that brings
    the card's clocks up; (median, min, max) by key."""
    import time

    import torch

    t0 = time.time()
    while time.time() - t0 < 1.0:
        for _, fn in entries:
            fn()
        torch.cuda.synchronize()
    times = {}
    for r in range(rounds):
        for key, fn in (entries if r % 2 == 0 else entries[::-1]):
            times.setdefault(key, []).append(cs.cuda_time(fn, reps))
    return {k: (float(np.median(v)), min(v), max(v)) for k, v in times.items()}


def _parent_csrc(parent):
    return Path(parent) / "gpufluidsimulation_tpu_torch" / "csrc"


def minmax_variants(n, out_dir, parent=None, rounds=4):
    """Each build's C=2 rho+T min/max and sample mode and its C=1 min/max
    at n^3, from the trace clamp's kind of positions (the cell lattice
    displaced by up to 2.5 cells, some outside the domain), held against
    the plain version; beside them the two launches that the sample mode
    replaces (the port's min/max and trilerp_sample). With `parent`, that
    tree's minmax_sample is built too (its design, its C interface: no
    sample mode). All built first, each in its own namespace, then timed
    in interleaved rounds."""
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    h = g.h
    pos = [(p + cs.smooth(g.shape_c, rng, 2.5 * h, dev)).contiguous()
           for p in g.node_coords("c", device=dev)]
    fc = torch.stack([cs.smooth(g.shape_c, rng, 1.0, dev),
                      cs.smooth(g.shape_c, rng, 50.0, dev)]).contiguous()
    cases = [("C=2", fc), ("C=1", fc[:1])]
    wants = {label: interp_fast.minmax_sample_plain(
        f, *pos, h, (g.OFF_C,) * len(f), sample=True) for label, f in cases}
    F, I, P, LL = ctypes.c_float, ctypes.c_int, ctypes.c_void_p, \
        ctypes.c_longlong
    table = list(MINMAX.items())
    if parent:
        table.append(("parent (first port)", None))
    entries, errs = [], {}
    for i, (label, edits) in enumerate(table):
        lib, ptxas = build(out_dir, f"minmax_{i}", "minmax_sample",
                           (edits or []) + _own_namespace(i),
                           CSRC if edits is not None else _parent_csrc(parent))
        cs.log(f"[minmax_sample] {label}: " + "; ".join(ptxas))
        if lib is None:
            continue
        fn = lib.gfs_minmax_sample
        fn.restype = I
        first = edits is None
        fn.argtypes = ([P, I, I, I, I, P, P, P, LL, F, ctypes.POINTER(F), P,
                        P, P] if first else
                       [P, I, I, I, I, P, P, P, LL, I, I, F,
                        ctypes.POINTER(F), P, P, P, P])
        for case, f in cases:
            C = f.shape[0]
            out = torch.empty((3, C) + g.shape_c, device=dev)
            offs = (F * (3 * C))(*[float(x) for x in g.OFF_C * C])
            for sample in ((False,) if first else (False, True)):
                if case == "C=1" and sample:
                    continue

                def run(fn=fn, f=f, C=C, out=out, offs=offs, sample=sample,
                        first=first):
                    p3 = [_build.ptr(q) for q in pos]
                    size = (pos[0].numel(),) if first else (
                        pos[0].numel(), n, n)
                    err = fn(_build.ptr(f), C, *f.shape[1:], *p3, *size,
                             float(h), offs, _build.ptr(out[0]),
                             _build.ptr(out[1]),
                             *(() if first else (
                                 _build.ptr(out[2]) if sample else None,)),
                             _build.stream(f))
                    _build.check(err, label)

                run()
                want = wants[case]
                q = 3 if sample else 2
                key = (label, f"{case} {'sample mode' if sample else 'min/max'}")
                errs[key] = max(float((out[a] - want[a]).abs().max())
                                for a in range(q))
                entries.append((key, run))
    offs2 = (g.OFF_C,) * 2
    entries.append((("port", "C=2 min/max and trilerp_sample (two "
                     "launches)"), lambda: (
        interp_fast.minmax_sample(fc, *pos, h, offs2),
        interp_fast.trilerp_sample(fc, *pos, h, offs2))))
    times = _interleaved(entries, rounds)
    for key, (med, lo, hi) in times.items():
        cs.log(f"[minmax_sample] {key[0]}: {key[1]} {med:.4f} ms (median "
               f"of {rounds}, {lo:.4f}-{hi:.4f}; max_abs_err "
               f"{errs.get(key, 'not compared')})")


def pullback_variants(n, out_dir, parent=None, rounds=4):
    """Each build's fused pull-back of the velocity triplet and of rho+T at
    n^3, clamp (1, 1), through a map displaced by a smooth wobble of up to
    3 cells (chip_smoke.py's inputs), held against the plain version. With
    `parent`, that tree's pullback_sample is built too (its design, its C
    interface: the channels in their own order). All built first, each in
    its own namespace, then timed in interleaved rounds."""
    import torch

    from gpufluidsimulation_tpu_torch.core.grids import Grid3D
    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    g = Grid3D(n, n, n, 0.2 / n)
    maps = cs.wobbled_map(g, rng, 3.0, dev)
    cases = []
    for kinds in cs.PULLBACK_KINDS:
        fields = cs.pullback_fields(g, kinds, rng, dev)
        dims = [g.dim_of(k) for k in kinds]
        args = (maps, fields, dims, g.h, g.shape_c, 1.0, 1.0)
        want = interp_fast.pullback_sample_plain(*args)
        cases.append(("".join(kinds), fields, dims, want))
    F, I, P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    IP = ctypes.POINTER(I)
    hi = (F * 3)(*[float(m - 1.0) for m in g.shape_c])
    table = list(PULLBACK.items())
    if parent:
        table.append(("parent (first port)", None))
    entries, errs = [], {}
    for i, (label, edits) in enumerate(table):
        lib, ptxas = build(out_dir, f"pullback_{i}", "pullback_sample",
                           (edits or []) + _own_namespace(i),
                           CSRC if edits is not None else _parent_csrc(parent))
        cs.log(f"[pullback_sample] {label}: " + "; ".join(ptxas))
        if lib is None:
            continue
        fn = lib.gfs_pullback_sample
        fn.restype = I
        first = edits is None
        fn.argtypes = ([P, I, I, I, ctypes.POINTER(P), IP, IP] + ([] if first
                                                                 else [IP])
                       + [I, I, I, I, F, F, ctypes.POINTER(F), P, P])
        for case, fields, dims, want in cases:
            C = len(fields)
            order = (list(range(C)) if first
                     else interp_fast.pullback_kind_order(dims))
            ptrs = (P * C)(*[fields[c].data_ptr() for c in order])
            shapes = (I * (3 * C))(*[m for c in order
                                     for m in fields[c].shape])
            stag = (I * C)(*[list(dims[c]).index(1) if any(dims[c]) else -1
                             for c in order])
            slot = (I * C)(*order)
            out = torch.empty_like(want)

            def run(fn=fn, ptrs=ptrs, shapes=shapes, stag=stag, slot=slot,
                    C=C, out=out, first=first):
                err = fn(_build.ptr(maps), *g.shape_c, ptrs, shapes, stag,
                         *(() if first else (slot,)), C, *out.shape[1:],
                         float(g.h), 1.0, hi, _build.ptr(out),
                         _build.stream(maps))
                _build.check(err, label)

            run()
            key = (label, case)
            errs[key] = float((out - want).abs().max())
            entries.append((key, run))
    times = _interleaved(entries, rounds)
    for key, (med, lo, hi_) in times.items():
        cs.log(f"[pullback_sample] {key[0]}: {key[1]} {med:.4f} ms (median "
               f"of {rounds}, {lo:.4f}-{hi_:.4f}; max_abs_err "
               f"{errs[key]:.3e})")


RUNNERS = {"trilerp_sample": trilerp_variants,
           "jacobi_diffuse": jacobi_variants,
           "rk3_substep": rk3_variants,
           "volume_prefilter": prefilter_variants,
           "dmc_substep": dmc_variants,
           "vol9_fixup": vol9_variants,
           "rbgs_smooth": lambda n, out: smoother_variants(
               "rbgs_smooth", RBGS, n, out),
           "masked_rbgs_smooth": lambda n, out: smoother_variants(
               "masked_rbgs_smooth", MASKED_RBGS, n, out),
           "minmax_sample": minmax_variants,
           "pullback_sample": pullback_variants}
# the runners that also build a parent tree's design (--parent)
WITH_PARENT = ("minmax_sample", "pullback_sample")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--kernels", default=",".join(RUNNERS),
                    help="comma-separated kernels whose variants to run")
    ap.add_argument("--only", default="",
                    help="comma-separated parts of variant names: run only "
                    "the variants whose name holds one of them")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of another tree (git archive): "
                    "minmax_sample and pullback_sample also build its "
                    "design and time it in the same rounds")
    ap.add_argument("--out", default=str(ROOT / "gpufluidsimulation_tpu_torch"
                                        / "_build" / "variants"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no GPU", file=sys.stderr)
        return 2
    out_dir = Path(args.out)
    os.makedirs(out_dir, exist_ok=True)
    cs.log(cs.nvidia_smi_line())
    if args.only:
        parts = args.only.split(",")
        for table in (TRILERP, JACOBI, RK3, PREFILTER, DMC, VOL9, RBGS,
                      MASKED_RBGS, MINMAX, PULLBACK):
            for name in [k for k in table if not any(s in k for s in parts)]:
                del table[name]
    for name in args.kernels.split(","):
        if name in WITH_PARENT:
            RUNNERS[name](args.n, out_dir, args.parent)
        else:
            RUNNERS[name](args.n, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
