#!/usr/bin/env python3
"""Time design variants of the port's redesigned kernels on one GPU.

    python3 scripts/kernel_variants.py            # 256^3 shapes, all twelve
    python3 scripts/kernel_variants.py --n 64     # a quick check
    python3 scripts/kernel_variants.py --kernels dmc_substep,vol9_fixup
    python3 scripts/kernel_variants.py --kernels vol9_fixup --only shipped,tile
    python3 scripts/kernel_variants.py --kernels minmax_sample,pullback_sample \
        --parent _archive/parent     # also that tree's designs, same rounds
    python3 scripts/kernel_variants.py --kernels p2g_splat \
        --parent _archive/parent     # the P2G cases, the first form beside
    python3 scripts/kernel_variants.py --kernels bilerp_sample \
        --parent _archive/parent     # the 2D modes and marches, both trees

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
rho+T; ``p2g_splat`` variants (the bounds in registers; the next chunk by
cp.async; chunk length, threads and tile; the owner's unrolling or
batches; register caps) on ``chip_smoke.py``'s P2G cases in FLIP, APIC and PolyPIC,
against the plain version on the CPU, then where a call's time goes
beside the kernel's (CUDA events and torch.profiler); ``bilerp_sample``
variants (threads a CTA) of its trace and DMC modes
on the 2D paths' shapes, its sample, mac and cp modes, grid_sample, an
empty launch, and each tree's own 2D marches in a process of its own.
The smoother, minmax, pull-back, P2G and bilerp builds are all made
before any is timed, each in its own namespace, then timed in
interleaved rounds (medians); ``--parent DIR`` adds that tree's
minmax_sample, pullback_sample, p2g_splat and bilerp_sample, through its
own C interface. Each build prints
its registers, spills and, where the toolkit has cuobjdump, each kernel's
static SASS instruction count. Builds go to the port's build directory
(``gpufluidsimulation_tpu_torch/_build/variants/``).
Needs a GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import struct
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


_P2G_CHUNK = "constexpr int kChunk = 512;"
_P2G_THREADS = "constexpr int kThreads = 128;"
_P2G_UNROLL = "#pragma unroll 4\n  for (int k = from; k < to; ++k) add(s, sl[k]);"
_P2G_BLOCKS = "constexpr int kBlocksPerSM = 5;"
_P2G_JJ = ("  const int jj = J0 + (((t & 31) << 1) | ((t >> 5) & 1)) + "
           "(t & ~63);\n")
_P2G_ADDS_END = ("        add_run(sl, max(bm, hfirst) - hfirst, min(b1, hend) - "
                 "hfirst, s0);\n      }\n")
_P2G_LOADS = """          p[r] = __ldg(pos + g);
          ca[r] = load_coef<kOrder>(colA, strA, g);
          if (kNch == 2) cb[r] = load_coef<kOrder>(colB, strB, g);
"""
# the next chunk copied by cp.async into shared memory past the slots
# while the owners add (no registers), each thread waiting for its own
# copies before its terms
_P2G_CP_ASYNC = [
    ("// the slots sl[from, to) added in order onto s", """\
// cp.async of N bytes from device memory into shared memory
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src), "n"(N)
      : "memory");
}

// the slots sl[from, to) added in order onto s"""),
    ("constexpr int kSmem = 2 * 2 * kChunk * (int)sizeof(float4);",
     "constexpr int kSmem = 2 * 2 * kChunk * (int)sizeof(float4) + "
     "kChunk * (8 + 2 * 16);"),
    ("  float2 p[kPer];\n  Coef<kOrder> ca[kPer], cb[kPer];\n", """\
  float2* const rp = reinterpret_cast<float2*>(smem + 4 * kChunk);
  Coef<kOrder>* const ra = reinterpret_cast<Coef<kOrder>*>(rp + kChunk);
  Coef<kOrder>* const rb = ra + kChunk;
"""),
    ("    if (staged) {\n      // the staged particles' terms",
     '    if (staged) {\n      asm volatile("cp.async.wait_all;\\n" ::: '
     '"memory");\n      // the staged particles\' terms'),
    ("const float gx = p[r].x / h - ox;", "const float gx = rp[k].x / h - ox;"),
    ("const float gy = p[r].y / h - oy;", "const float gy = rp[k].y / h - oy;"),
    ("value<kOrder>(ca[r], dx, dy)", "value<kOrder>(ra[k], dx, dy)"),
    ("value<kOrder>(cb[r], dx, dy)", "value<kOrder>(rb[k], dx, dy)"),
    (_P2G_LOADS, """\
          const int k = r * kThreads + t;
          copy_async<8>(rp + k, pos + g);
          if constexpr (kOrder == kFlip) {
            copy_async<4>(ra + k, colA + (unsigned)g * (unsigned)strA);
            if (kNch == 2)
              copy_async<4>(rb + k, colB + (unsigned)g * (unsigned)strB);
          } else {
            copy_async<16>(ra + k, colA + 4 * (size_t)g);
            if (kNch == 2) copy_async<16>(rb + k, colB + 4 * (size_t)g);
          }
""")]
# the slice and run bounds in registers, picked by selects
_P2G_BOUNDS_IN_REGISTERS = [
    ("""    if (t < 2) slice[d][t] = ok ? __ldg(st + (t == 0 ? tlo : thi)) : 0;
    runs[d][0][t] = ok && owner ? __ldg(st + klo) : 0;
    runs[d][1][t] = ok && owner ? __ldg(st + kmid) : 0;
    runs[d][2][t] = ok && owner ? __ldg(st + khi) : 0;
  }
  __syncthreads();
""", """    LO[d] = ok ? __ldg(st + tlo) : 0;
    HI[d] = ok ? __ldg(st + thi) : 0;
    B0[d] = ok && owner ? __ldg(st + klo) : 0;
    BM[d] = ok && owner ? __ldg(st + kmid) : 0;
    B1[d] = ok && owner ? __ldg(st + khi) : 0;
  }
"""),
    ("#pragma unroll\n  for (int d = 0; d < kMaxTaps; ++d) {\n    const int sx",
     "  int LO[kMaxTaps], HI[kMaxTaps], B0[kMaxTaps], BM[kMaxTaps], "
     "B1[kMaxTaps];\n  auto pick = [](const int (&a)[kMaxTaps], int d) {\n"
     "    return d == 0 ? a[0] : (d == 1 ? a[1] : a[2]);\n  };\n"
     "#pragma unroll\n  for (int d = 0; d < kMaxTaps; ++d) {\n    const int sx"),
    ("  int di = 0, begin = slice[0][0];", "  int di = 0, begin = LO[0];"),
    ("begin >= slice[di][1]", "begin >= pick(HI, di)"),
    ("begin = di < ndi ? slice[di][0] : 0;",
     "begin = di < ndi ? pick(LO, di) : 0;"),
    ("end = min(begin + kChunk, slice[di][1]);",
     "end = min(begin + kChunk, pick(HI, di));"),
    ("""        const int b0 = runs[hd][0][t], bm = runs[hd][1][t];
        const int b1 = runs[hd][2][t];
""", """        const int b0 = pick(B0, hd), bm = pick(BM, hd);
        const int b1 = pick(B1, hd);
""")]


def _p2g_unroll(n):
    return [(_P2G_UNROLL, _P2G_UNROLL.replace("unroll 4", f"unroll {n}"))]


def _p2g_blocks(blocks):
    return [(_P2G_BLOCKS, _P2G_BLOCKS.replace("5", str(blocks)))]


# the owner's adds in explicit batches: batch b + 1's slots are loaded
# while batch b is added
_P2G_BATCHED = [(_P2G_UNROLL, """int k = from;
  if (k + 8 <= to) {
    S cur[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) cur[b] = sl[k + b];
    for (k += 8; k + 8 <= to; k += 8) {
      S next[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) next[b] = sl[k + b];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        add(s, cur[b]);
        cur[b] = next[b];
      }
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) add(s, cur[b]);
  }
  for (; k < to; ++k) add(s, sl[k]);""")]
P2G = {
    "shipped (128 threads, a tile of 128 nodes, chunks of 512, adds "
    "unrolled by 4, at least 5 blocks an SM)": [],
    "the slice and run bounds in registers": _P2G_BOUNDS_IN_REGISTERS,
    "the next chunk copied by cp.async during the adds (52 KB)":
        _P2G_CP_ASYNC,
    "adds unrolled by 8": _p2g_unroll(8),
    "adds unrolled by 16": _p2g_unroll(16),
    "adds in explicit batches of 8, the next in flight": _P2G_BATCHED,
    "at least 4 blocks an SM (128 registers)": _p2g_blocks(4),
    "at least 6 blocks an SM (85 registers)": _p2g_blocks(6),
    "no register budget (ptxas's own choice)": [
        ("__launch_bounds__(kThreads, kBlocksPerSM)",
         "__launch_bounds__(kThreads)")],
    "chunks of 256": [(_P2G_CHUNK, "constexpr int kChunk = 256;")],
    "chunks of 1024 (64 KB of dynamic shared memory)": [
        (_P2G_CHUNK, "constexpr int kChunk = 1024;")],
    "64 threads, tiles of 64": [
        (_P2G_THREADS, "constexpr int kThreads = 64;")],
    "256 threads, tiles of 256": [
        (_P2G_THREADS, "constexpr int kThreads = 256;")],
    "neighbouring nodes on one warp (jj = J0 + t)": [
        (_P2G_JJ, "  const int jj = J0 + t;\n")],
    "owners' warps reconverge before the barrier (__syncwarp)": [
        (_P2G_ADDS_END, _P2G_ADDS_END + "      __syncwarp();\n")],
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
        # the first port's signature, or the shipped one (its bf16 flag 0)
        fn.argtypes = ([P, I, I, I, I, P, P, P, LL, F, ctypes.POINTER(F), P,
                        P, P] if first else
                       [P, I, I, I, I, I, P, P, P, LL, I, I, F,
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
                    err = fn(_build.ptr(f), *(() if first else (0,)), C,
                             *f.shape[1:], *p3, *size,
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


def sm_clock():
    """The card's SM clock in MHz, as nvidia-smi reads it now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


P2G_CALLS = 20   # launches a timed CUDA graph holds


def p2g_variants(n, out_dir, parent=None, rounds=4):
    """Each build's launch on chip_smoke.py's P2G cases (p2g_cases: the
    ring pile, no pile and the interior pile on 256^2, RT's 256x1280) in
    FLIP, APIC and PolyPIC, held against the plain version on the CPU
    (max abs error; the shipped design must show 0). With `parent`, that
    tree's p2g_splat is built too (the same C interface). All built
    first, each in its own namespace, then timed in interleaved rounds,
    the launch alone on the bin starts made beforehand, as CUDA graphs
    of 20 launches (the host's ctypes launch would time itself on the
    shorter cases). Then, for the
    shipped design and the parent's on the ring pile in FLIP, where a
    call's time goes: the wrapper's whole call (the bin starts'
    searchsorted, the output's torch.empty, the ctypes launch) and its
    parts by CUDA events, the kernel by torch.profiler, and the call's
    ops traced (chip_smoke.p2g_call_trace). `n` is not used: the cases
    are the main path's shapes."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    F, I, P, LL = ctypes.c_float, ctypes.c_int, ctypes.c_void_p, \
        ctypes.c_longlong
    cases = []
    for label, g, pile, at in cs.p2g_cases():
        state, keys, _ = cs.p2g_particles(g, rng, dev, pile, at)
        cpu = state.__class__(**{k: getattr(state, k).cpu()
                                 for k in ("pos", "vel", "rho", "T", "C_x",
                                           "C_y", "C_rho", "C_T")})
        starts = interp_fast.p2g_bin_starts(keys, g.ni, g.nj)
        for order in ("flip", "apic", "polypic"):
            cols = cs.p2g_cols(state, order)
            want = torch.cat([w.reshape(-1) for w in
                              interp_fast.p2g_splat_plain(
                                  cpu.pos, cs.p2g_cols(cpu, order), g.h,
                                  g.ni, g.nj, order)])
            cases.append((f"{order} {label}", g, state, keys, starts, cols,
                          order, want))
    table = list(P2G.items())
    if parent:
        table.append(("parent (first form)", None))
    entries, errs, launches = [], {}, {}
    for i, (label, edits) in enumerate(table):
        lib, ptxas = build(out_dir, f"p2g_{i}", "p2g_splat",
                           (edits or []) + _own_namespace(i),
                           CSRC if edits is not None else _parent_csrc(parent))
        cs.log(f"[p2g_splat] {label}: " + "; ".join(ptxas))
        if lib is None:
            continue
        fn = lib.gfs_p2g_splat
        fn.restype = I
        fn.argtypes = [P, ctypes.POINTER(P), ctypes.POINTER(I), I, P, I, I,
                       F, LL, P, P]
        for case, g, state, keys, starts, cols, order, want in cases:
            out = torch.empty_like(want, device=dev)
            ptrs = (P * 4)(*[c.data_ptr() for c in cols])
            strides = (I * 4)(*[c.stride(0) if order == "flip" else 4
                                for c in cols])

            def run(fn=fn, g=g, state=state, starts=starts, ptrs=ptrs,
                    strides=strides, order=order, out=out, label=label):
                err = fn(_build.ptr(state.pos), ptrs, strides,
                         interp_fast.P2G_ORDERS[order], _build.ptr(starts),
                         g.ni, g.nj, float(g.h), state.pos.shape[0],
                         _build.ptr(out), _build.stream(out))
                _build.check(err, label)

            run()
            errs[(label, case)] = float((out.cpu() - want).abs().max())
            # timed as a CUDA graph of launches: a launch through ctypes
            # costs the host more than the shorter cases cost the card
            entries.append(((label, case),
                            cs.launch_graph(run, P2G_CALLS).replay))
            launches[(label, case)] = (run, g, state, keys, cols, order,
                                       out)
    times = _interleaved(entries, rounds)
    for key, (med, lo, hi) in times.items():
        med, lo, hi = (x / P2G_CALLS for x in (med, lo, hi))
        cs.log(f"[p2g_splat] {key[0]}: {key[1]} {med:.4f} ms (median of "
               f"{rounds}, {lo:.4f}-{hi:.4f}; max_abs_err {errs[key]:.3e})")
    gap_case = cases[0][0]
    for label in (table[0][0], "parent (first form)"):
        if (label, gap_case) not in launches:
            continue
        run, g, state, keys, cols, order, out = launches[(label, gap_case)]
        ni, nj = g.ni, g.nj
        bin_starts = lambda: interp_fast.p2g_bin_starts(keys, ni, nj)

        def call(run=run):
            # the wrapper's work around the launch: the bin starts, the
            # output and the launch (which reuses its starts and output)
            bin_starts()
            torch.empty(out.numel(), dtype=torch.float32, device=dev)
            run()

        # each measure with the SM clock nvidia-smi reads right after it
        parts = {}
        for key, measure in (
                ("kernel_profiler_ms",
                 lambda: cs.device_ms(run, 10, "p2g_splat_kernel")),
                ("kernel_graph_ms", lambda: cs.graph_ms(run)),
                ("launch_ms", lambda: cs.cuda_time(run, 20)),
                ("call_ms", lambda: cs.cuda_time(call, 20)),
                ("bin_starts_ms", lambda: cs.cuda_time(bin_starts, 20)),
                ("kernel_profiler_again_ms",
                 lambda: cs.device_ms(run, 10, "p2g_splat_kernel"))):
            parts[key] = measure()
            parts[key.replace("_ms", "_sm_mhz")] = sm_clock()
        cs.log(f"[p2g_splat] {label}: {gap_case}, a call's parts "
               f"{json.dumps(parts)}; traced "
               f"{json.dumps(cs.p2g_call_trace(call))}")
    # the wrapper's own cost where a call is host-bound (the Taylor path's
    # shape, no pile): the port's wrapper as it is (the bin queries kept)
    # and with a fresh arange of them each call, as before, in turns
    _, g, state, keys, _, cols, order, _ = next(
        c for c in cases if c[0] == "flip 256x256")

    def wrapper():
        interp_fast.p2g_splat(state.pos, cols, g.h, g.ni, g.nj, keys, order)

    def wrapper_fresh():
        interp_fast._BIN_QUERIES.clear()
        wrapper()

    calls = {"kernel_profiler_ms": cs.device_ms(wrapper, 10,
                                                "p2g_splat_kernel"),
             "call_graph_ms": cs.graph_ms(wrapper)}
    for key, fn in (("call_fresh_queries_ms", wrapper_fresh),
                    ("call_ms", wrapper), ("call_ms", wrapper),
                    ("call_fresh_queries_ms", wrapper_fresh)):
        calls.setdefault(key, []).append(cs.cuda_time(fn, 50))
    cs.log(f"[p2g_splat] the wrapper, flip 256x256: {json.dumps(calls)}")


_BT_THREADS = "constexpr int kTraceThreads = 128;"
_BT_LOOP = "#pragma unroll 2"
BILERP = {
    "shipped (128 threads, a position a thread, substeps unrolled by 2)": [],
    "64 threads": [(_BT_THREADS, "constexpr int kTraceThreads = 64;")],
    "256 threads": [(_BT_THREADS, "constexpr int kTraceThreads = 256;")],
    "substep loop unrolled by 4": [(_BT_LOOP, "#pragma unroll 4")],
    "substep loop not unrolled": [(_BT_LOOP, "#pragma unroll 1")],
    "substep loop as the compiler leaves it": [(_BT_LOOP, "")],
}
BILERP_CALLS = 20   # launches a timed CUDA graph holds

_EMPTY_SRC = """__global__ void empty_kernel() {}

extern "C" int gfs_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""

# a tree's 2D marches and samples through its own wrappers, in a process
# of its own (two trees' packages share a name): each call's CUDA-graph
# time, host microseconds and kernel launches (torch.profiler), as JSON
_TREE_CALLS = r"""
import json, sys, time, types
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from gpufluidsimulation_tpu_torch.core.grids import Grid2D
from gpufluidsimulation_tpu_torch.ops import advect, interp_fast
from gpufluidsimulation_tpu_torch.solvers import smoke2d
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

def graph_ms(fn, calls=20, replays=10):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / replays / calls

def host_us(fn, calls=300):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6

def kernels(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)

def smooth(shape, rng, amp):
    idx = np.meshgrid(*[np.arange(n, dtype=np.float64) for n in shape],
                      indexing="ij")
    f = np.zeros(shape)
    for _ in range(2):
        k = rng.uniform(0.5, 3.0, 2) * 2 * np.pi / np.array(shape)
        f += np.sin(k[0] * idx[0] + k[1] * idx[1] + rng.uniform(0, 6.3))
    return torch.from_numpy((amp * f / 2).astype(np.float32)).cuda()

rng = np.random.default_rng(0)
out = {}
for (ni, nj), subs, P in (((256, 256), 2, 1048576),
                          ((256, 1280), 1, 5242880)):
    g = Grid2D(ni, nj, 1.0 / ni)
    h = g.h
    u, v = smooth(g.shape_u, rng, 2.0), smooth(g.shape_v, rng, 2.0)
    rho, T = smooth(g.shape_c, rng, 1.0), smooth(g.shape_c, rng, 50.0)
    cfldt = np.float32(1.5 * h)
    dt = np.float32(cfldt * np.float32(subs - 0.3))
    px, py = g.node_coords("c", "cuda")
    pos = torch.stack([torch.rand(P, device="cuda") * (ni - 2) * h + h,
                       torch.rand(P, device="cuda") * (nj - 2) * h + h], -1)
    p = types.SimpleNamespace(pos=pos)
    calls = {
        "mac-mode call at the cell lattice": lambda: interp_fast.
            bilerp_sample_mac(u, v, px, py, h),
        "sample-mode call C=1 at the cell lattice": lambda: interp_fast.
            bilerp_sample(rho[None], px, py, h, (g.OFF_C,)),
        "semilag_multi_2d c, rho and T": lambda: advect.semilag_multi_2d(
            g, "c", [rho, T], u, v, cfldt, dt),
        "semilag_2d u": lambda: advect.semilag_2d(g, "u", u, u, v, None,
                                                  cfldt, dt),
        "maccormack_multi_2d c, rho and T": lambda: advect.
            maccormack_multi_2d(g, "c", [rho, T], u, v, cfldt, dt),
        "bfecc_multi_2d c, rho and T": lambda: advect.bfecc_multi_2d(
            g, "c", [rho, T], u, v, cfldt, dt),
        "update_forward_map_2d": lambda: advect.update_forward_map_2d(
            g, u, v, (px, py), cfldt, dt),
        "update_backward_map_2d (DMC)": lambda: advect.
            update_backward_map_2d(g, u, v, (px, py), cfldt, dt),
        f"particle trace, {P} particles": lambda: smoke2d._advect_particles(
            g, p, u, v, cfldt, dt),
    }
    for name, fn in calls.items():
        out[f"{name} {ni}x{nj}, {len(advect.substeps(cfldt, dt))} "
            "substeps"] = dict(graph_ms=graph_ms(fn), host_us=host_us(fn),
                               kernels=kernels(fn))
print("TREE_CALLS " + json.dumps(out))
"""


def _tree_calls(root):
    """Run _TREE_CALLS in its own process on the tree at `root`."""
    res = subprocess.run([sys.executable, "-c", _TREE_CALLS, str(root)],
                         capture_output=True, text=True, cwd=str(root))
    line = [x for x in res.stdout.splitlines() if x.startswith("TREE_CALLS")]
    if res.returncode or not line:
        raise SystemExit(f"tree calls in {root} failed:\n{res.stdout}"
                         f"{res.stderr}")
    return json.loads(line[0].split(" ", 1)[1])


def _trace_call(fn, u, v, h, subs, start, fields=(), off=(0.0, 0.0),
                minmax=False, write_pos=True, final_clamp=None,
                interleave=False):
    """bilerp_trace's launch through a build's own gfs_bilerp_trace."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    fields = list(fields)
    fp, ip, shape = interp_fast.trace_plan(
        u, v, h, subs, start, fields, off, minmax, write_pos, final_clamp,
        interleave)
    n, C = ip[2], len(fields)
    out = interp_fast.trace_outputs(shape, C, minmax, write_pos, interleave,
                                    u.device)
    ptr = interp_fast.trace_pointers(out, n, interleave)
    lattice = isinstance(start, interp_fast.Lattice2D)
    err = fn(u.data_ptr(), v.data_ptr(), v.shape[0], u.shape[1],
             interp_fast._TRACE_FP.pack(*fp), interp_fast._TRACE_IP.pack(*ip),
             None if lattice else start[0].data_ptr(),
             None if lattice else start[1].data_ptr(), ptr[0], ptr[1],
             struct.pack(f"{C}Q", *[f.data_ptr() for f in fields])
             if C else None, *ptr[2:], _build.stream(u))
    _build.check(err, "gfs_bilerp_trace")
    return out


def _dmc_call(fn, u, v, mx, my, h, subs):
    """bilerp_dmc's launches through a build's own gfs_bilerp_dmc."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast

    ni, nj = mx.shape
    maps = (mx, my)
    for sub in subs:
        out = torch.empty((2, ni, nj), device=mx.device)
        err = fn(u.data_ptr(), v.data_ptr(), ni, nj, maps[0].data_ptr(),
                 maps[1].data_ptr(),
                 struct.pack("5f", *interp_fast.dmc_plan(h, sub, ni, nj)),
                 out.data_ptr(), _build.stream(u))
        _build.check(err, "gfs_bilerp_dmc")
        maps = out
    return maps


def _sample_call(fn, fields, offs, bands, px, py, h, mode):
    """bilerp_sample's launch (modes sample 0, mac 1, cp 2) through a
    build's own gfs_bilerp_sample: the same C interface in this tree and
    its parent."""
    import torch

    from gpufluidsimulation_tpu_torch.ops import _build

    F, I, P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    C = len(fields)
    out = torch.empty((C,) + tuple(px.shape) + ((4,) if mode == 2 else ()),
                      device=px.device)
    err = fn((P * C)(*[f.data_ptr() for f in fields]),
             (I * (2 * C))(*[n for f in fields for n in f.shape]),
             (F * (2 * C))(*[o for off in offs for o in off]),
             None if bands is None else
             (F * (2 * C))(*[b for band in bands for b in band]), C, mode,
             px.data_ptr(), py.data_ptr(), px.numel(), float(h),
             float(h * h), out.data_ptr(), _build.stream(px))
    _build.check(err, "gfs_bilerp_sample")
    return out


def bilerp_variants(n, out_dir, parent=None, rounds=4):
    """bilerp_sample's modes on the 2D paths' shapes. The sample, mac and
    cp modes (C=1, C=2 on the 5-point stencil, C=2 on two offsets; the
    mac mode with one pair and two; the cp mode of u, v, rho and T with
    the L2 flushed before each launch) at 256^2 and 256x1280 and at the
    G2P shapes (1,048,576 and 5,242,880 particles); the trace mode (a
    semi-Lagrangian trace of rho and T from the cell lattice, a
    MacCormack trace of u with its min/max, the forward map, the
    particles) and the DMC mode on the same grids; beside them
    grid_sample on the same samples and an empty kernel launched through
    ctypes (the launch floor). Each build is held against the plain
    version (same bits) and timed as CUDA graphs of 20 launches in
    interleaved rounds. With `parent`, that tree's bilerp_sample is built
    too (the sample, mac and cp modes: the same C interface), and each
    tree's own wrappers and 2D marches (this tree's trace and DMC modes,
    the parent's composition of mac-mode launches and torch glue) are
    timed in a process of its own, in the order parent, this, this,
    parent: CUDA-graph ms, host us a call (wall time of calls made
    without a sync) and kernels a call. `n` is not used."""
    import torch
    import torch.nn.functional as F_

    from gpufluidsimulation_tpu_torch.core import interp
    from gpufluidsimulation_tpu_torch.core.grids import Grid2D
    from gpufluidsimulation_tpu_torch.ops import _build, interp_fast
    from gpufluidsimulation_tpu_torch.solvers import particles

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    F, I, P, LL = ctypes.c_float, ctypes.c_int, ctypes.c_void_p, \
        ctypes.c_longlong
    flush = torch.empty(2 ** 24, device=dev)
    sample_cases, trace_cases = [], []
    for (ni, nj), count, npart in (((256, 256), 2, 1048576),
                                   ((256, 1280), 1, 5242880)):
        g = Grid2D(ni, nj, 1.0 / ni)
        h = g.h
        u, v = cs.smooth(g.shape_u, rng, 2.0, dev), cs.smooth(g.shape_v, rng,
                                                              2.0, dev)
        du, dv = cs.smooth(g.shape_u, rng, 0.1, dev), cs.smooth(
            g.shape_v, rng, 0.1, dev)
        rho, T = cs.smooth(g.shape_c, rng, 1.0, dev), cs.smooth(
            g.shape_c, rng, 50.0, dev)
        cells = [(q + cs.smooth(q.shape, rng, 2.0 * h, dev)).contiguous()
                 for q in g.node_coords("c", dev)]
        stencil = [torch.stack([q + cs.smooth(q.shape, rng, 0.3 * h, dev)
                                for _ in range(5)]).contiguous()
                   for q in g.node_coords("c", dev)]
        parts = [torch.rand(npart, device=dev) * (m - 2) * h + h
                 for m in (ni, nj)]
        pos = torch.stack(parts, -1)
        rt = torch.stack([rho, T])
        uv = torch.stack([u[:ni], v[:, :nj]]).contiguous()
        tag = f"{ni}x{nj}"
        bands = particles.cp_bands(g)
        mac_bands = [(ni - 1, nj - 2), (ni - 2, nj - 1)]
        sample_cases += [
            (f"sample C=1 {tag}", [rho], (g.OFF_C,), None, cells, 0),
            (f"sample C=2 5-point stencil {tag}", [rho, T], (g.OFF_C,) * 2,
             None, stencil, 0),
            (f"sample C=2 u, v offsets {tag}", [uv[0], uv[1]],
             (g.OFF_U, g.OFF_V), None, cells, 0),
            (f"mac one pair {tag}", [u, v], interp.MAC_OFFS_2D, mac_bands,
             cells, 1),
            (f"mac two pairs {tag}", [u, v, du, dv], interp.MAC_OFFS_2D * 2,
             mac_bands * 2, cells, 1),
            (f"G2P mac two pairs, {npart} particles", [u, v, du, dv],
             interp.MAC_OFFS_2D * 2, mac_bands * 2, parts, 1),
            (f"G2P sample C=2, {npart} particles", [rho, T],
             (g.OFF_C,) * 2, None, parts, 0),
            (f"G2P cp C=4, {npart} particles, L2 flushed", [u, v, rho, T],
             (g.OFF_U, g.OFF_V, g.OFF_C, g.OFF_C), bands, parts, 2)]
        subs = [np.float32(1.5 * h)] * (count - 1) + [np.float32(1.1 * h)]
        back = [-s for s in subs]
        maps = [c.clone() for c in cells]
        trace_cases += [
            (f"trace semilag c, rho and T, {count} substeps {tag}",
             (u, v, h, back, interp_fast.Lattice2D(g.shape_c, g.OFF_C)),
             dict(fields=[rho, T], off=g.OFF_C, write_pos=False)),
            (f"trace maccormack u with min/max, {count} substeps {tag}",
             (u, v, h, back, interp_fast.Lattice2D(g.shape_u, g.OFF_U)),
             dict(fields=[u], off=g.OFF_U, minmax=True, write_pos=False)),
            (f"trace forward map, {count} substeps {tag}",
             (u, v, h, subs, tuple(maps)),
             dict(final_clamp=interp.clamp_bounds_2d(h, ni, nj))),
            (f"trace {npart} particles, {count} substeps {tag}",
             (u, v, h, subs, (pos[:, 0], pos[:, 1])),
             dict(final_clamp=((h, (ni - 1) * h), (h, (nj - 1) * h)),
                  interleave=True)),
            (f"DMC {count} substeps {tag}", (u, v, maps[0], maps[1], h, subs),
             None)]
    table = list(BILERP.items())
    if parent:
        table.append(("parent (first form)", None))
    entries, errs = [], {}
    for i, (label, edits) in enumerate(table):
        lib, ptxas = build(out_dir, f"bilerp_{i}", "bilerp_sample",
                           (edits or []) + _own_namespace(i),
                           CSRC if edits is not None else _parent_csrc(parent))
        cs.log(f"[bilerp_sample] {label}: " + "; ".join(ptxas))
        if lib is None:
            continue
        fs = lib.gfs_bilerp_sample
        fs.restype = I
        fs.argtypes = [ctypes.POINTER(P), ctypes.POINTER(I),
                       ctypes.POINTER(F), ctypes.POINTER(F), I, I, P, P, LL,
                       F, F, P, P]
        if edits is None or not edits:
            # the sample, mac and cp modes: the shipped build and the
            # parent's (the variants change only the trace and DMC modes)
            for case, fields, offs, bands, pxy, mode in sample_cases:
                want = {0: interp_fast.bilerp_sample_plain,
                        1: lambda f, x, y, hh, o: interp_fast.
                        bilerp_sample_mac_plain(f[0], f[1], x, y, hh,
                                                *f[2:]),
                        2: lambda f, x, y, hh, o: interp_fast.
                        bilerp_sample_cp_plain(f, x, y, hh, o, bands)}[mode]
                # every case's grid has ni = 256 cells along x
                hh = 1.0 / 256
                run = (lambda fs=fs, fields=fields, offs=offs, bands=bands,
                       pxy=pxy, mode=mode, hh=hh: _sample_call(
                           fs, fields, offs, bands, *pxy, hh, mode))
                got = run()
                ref = want(fields, *pxy, hh, offs)
                errs[(label, case)] = cs.same_bits(got, ref)
                if mode == 2:
                    entries.append(((label, case), cs.launch_graph(
                        lambda run=run: (flush.zero_(), run()),
                        BILERP_CALLS).replay))
                else:
                    entries.append(((label, case), cs.launch_graph(
                        run, BILERP_CALLS).replay))
        if edits is None:
            continue
        ft = lib.gfs_bilerp_trace
        ft.restype = I
        ft.argtypes = interp_fast._TRACE_ARGS
        fd = lib.gfs_bilerp_dmc
        fd.restype = I
        fd.argtypes = [P, P, I, I, P, P, ctypes.c_char_p, P, P]
        for case, args, kw in trace_cases:
            if kw is None:
                run = (lambda fd=fd, args=args: _dmc_call(fd, *args))
                ref = interp_fast.bilerp_dmc_plain(*args)
                got = run()
                errs[(label, case)] = cs.same_bits(got, ref)
            else:
                run = (lambda ft=ft, args=args, kw=kw: _trace_call(
                    ft, *args, **kw))
                ref = interp_fast.bilerp_trace_plain(*args, **kw)
                got = run()
                errs[(label, case)] = [
                    cs.same_bits(a, b, values=k >= 2)
                    for k, (a, b) in enumerate(zip(got, ref))
                    if a is not None]
            entries.append(((label, case), cs.launch_graph(
                run, BILERP_CALLS).replay))
    # each graph replayed once more, alone, before the rounds: a fault
    # names its case
    for key, fn in entries:
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            raise SystemExit(f"[bilerp_sample] {key}: {e}") from e
    times = _interleaved(entries, rounds, reps=5)
    for key, (med, lo, hi) in times.items():
        med, lo, hi = (x / BILERP_CALLS for x in (med, lo, hi))
        cs.log(f"[bilerp_sample] {key[0]}: {key[1]} {med:.5f} ms (median "
               f"of {rounds}, {lo:.5f}-{hi:.5f}; differing elements, "
               f"max_abs_err {errs.get(key, 'not compared')})")
    # the references, each timed as soon as its graph is made (as
    # chip_smoke.graph_ms times them): the L2 flush alone, grid_sample on
    # the sample cases' samples, an empty kernel through ctypes
    cs.log(f"[bilerp_sample] reference: L2 flush (64 MiB zero_) "
           f"{cs.graph_ms(flush.zero_):.5f} ms (CUDA graph)")
    for case, fields, offs, bands, pxy, mode in sample_cases:
        if mode != 0:
            continue
        nx, ny = fields[0].shape
        hh = 1.0 / 256
        flat = [q.reshape(1, -1, q.shape[-1]) for q in pxy]
        grids = [torch.stack([
            (flat[1] / hh - off[1]) * (2.0 / (ny - 1)) - 1.0,
            (flat[0] / hh - off[0]) * (2.0 / (nx - 1)) - 1.0], dim=-1)
            for off in offs]
        stack = [f[None, None] for f in fields]

        def lib_call(stack=stack, grids=grids):
            return [F_.grid_sample(f, gr, mode="bilinear",
                                   padding_mode="border", align_corners=True)
                    for f, gr in zip(stack, grids)]

        cs.log(f"[bilerp_sample] grid_sample: {case} "
               f"{cs.graph_ms(lib_call):.5f} ms (CUDA graph)")
    src = out_dir / "empty_launch.cu"
    src.write_text(_EMPTY_SRC)
    elib = out_dir / "empty_launch.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(elib),
                    str(src)], check=True)
    fe = ctypes.CDLL(str(elib)).gfs_empty
    fe.restype = I
    fe.argtypes = [P]

    def empty():
        _build.check(fe(_build.stream(flush)), "gfs_empty")

    cs.log(f"[bilerp_sample] reference: an empty kernel through ctypes (the "
           f"launch floor) {cs.graph_ms(empty):.5f} ms (CUDA graph), "
           f"{cs.host_us(empty):.2f} us of host a call")
    trees = ([("parent", parent), ("this", ROOT), ("this", ROOT),
              ("parent", parent)] if parent else [("this", ROOT)])
    for name, root in trees:
        for case, r in _tree_calls(root).items():
            cs.log(f"[bilerp_sample] {name} tree: {case}: "
                   f"{r['graph_ms']:.5f} ms (CUDA graph), "
                   f"{r['host_us']:.1f} us of host a call, "
                   f"{r['kernels']} kernels a call")


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
           "pullback_sample": pullback_variants,
           "p2g_splat": p2g_variants,
           "bilerp_sample": bilerp_variants}
# the runners that also build a parent tree's design (--parent)
WITH_PARENT = ("minmax_sample", "pullback_sample", "p2g_splat",
               "bilerp_sample")


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
                    "minmax_sample, pullback_sample and p2g_splat also "
                    "build its design and time it in the same rounds")
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
                      MASKED_RBGS, MINMAX, PULLBACK, P2G, BILERP):
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
