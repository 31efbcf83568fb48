// vol9_fixup: the exact 9-position volume composition on flagged blocks.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel_vol9fix (pallas_call in _vol9_fixup_padded; entries vol9_fixup
// and sample3_vol9). For every node of a kind's lattice whose decision
// block is flagged for some channel (flags: uint8 (C, nbx, nby, nbz) over
// blocks of bx x by x bz nodes, computed by the plain-torch prepass
// ops/interp_fast.vol9_flags), it overwrites the dual-form value in `out`
// with
//   0.5 * (sum_{d in _VOL3} f(clamp(M(p + d h))) / 8) + 0.5 * f(clamp(M(p)))
// where p = (idx + off) h is the node, M the trilinear sample of the
// (3, ni, nj, nk) world map on the cell lattice (grid coordinate
// (p + d h)/h), clamp the per-axis world bounds [lo, hi], and f the
// channel's field sampled on its own lattice (grid coordinate M/h - off).
// The corners are added one by one in _VOL3 order and every operation is
// the plain version's (vol9_exact_plain and core/interp.trilerp_grid), so
// the two agree to the bit under -fmad=false. Unflagged nodes and
// channels keep their dual value.
//
// What bounds it on the H100: at tol = 0 (every block flagged) the
// operations, per node 9 map samples of 3 channels from shared floors,
// weights and lerps, and 9 x C field samples (~14 GFLOP at 257x256x256,
// C=1, ~0.21 ms at 67 TFLOP/s) against ~0.34 GB of map and field reads
// and output writes (~0.10 ms). The TPU kernel fetched a ring-1 map window and a
// union-origin field window per flagged block, with branch codes for
// windows that do not fit; here there is no window to fit. The first
// design ran one thread per output node on a grid-stride loop over an
// int64 index (64-bit divisions and modulos a node), read the flags per
// thread, and at each of the 9 stencil points divided (x0 + d h)/h anew
// (27 divisions a node where 9 are distinct), sampled the map with three
// gfs::trilerp_clamped calls (27 floor sets and 216 gathers with 64-bit
// offsets a node) and each flagged channel's field with one more call
// each: 8.7x its bound, held by instruction issue.
//
// The design here: one thread per output node on 32 x 4 x 1 (k, j, i)
// tiles of the kind's lattice, each inside one decision block (the
// wrapper raises unless the tile divides the block), so a CTA reads its C
// flags once and returns as a whole when none is set; nodes past the
// block lattice (a staggered kind's last face plane where the blocks end
// at the cell count) stay unflagged. Map stage: per axis the three
// distinct coordinates (x0 - h/4)/h, x0/h, (x0 + h/4)/h are divided once
// (9 divisions a node) and floored once; their floors lie within B and
// B + 1 (monotone rounding keeps them ordered, and their spread, about
// 1/2, stays below 1), so each map channel's clamped 3 x 3 x 3
// neighbourhood is loaded once (81 loads a node, not 216) and the 9
// samples are taken from it by gfs::stencil9, as the dual trilerp_sample
// does. Field stage: at each mapped point the grid coordinates M/h - off
// are floored once and their weight set and corner offsets serve every
// flagged channel, the z corners loaded as a pair (gfs::zpair: the wrapper
// raises for a lattice under 2 nodes along z). Offsets are unsigned 32-bit
// (the wrapper raises unless 3 ni nj nk and C nx ny nz are below 2^31).
//
// Measured (chip_smoke.py and scripts/kernel_variants.py, H100, 257x256x256
// u at tol 0): 2.76 -> 1.67 ms at C=1, 3.66 -> 2.13 at C=2. Its C=1
// instance is 2472 SASS instructions with no loop, run once a node, at 128
// registers: ~1.4 ms of issue at 4 instructions a clock on 132 SMs, so it
// is held by instruction issue. Tiles of 64 to 256 threads within 5%; capping registers at 96 or
// 80 spills (at 96: 3% faster, not shipped); the map sampled point by
// point from one weight set (216 loads, 27 divisions, 72 registers) within
// 2-5%; the hoisted-reciprocal division of jacobi_diffuse +2-6%; 1 - f
// kept per map coordinate or the mapped positions staged in shared memory
// no faster (PERF.md, row 8).
//
// The bf16 mode (EngineMode.interp_bf16, the JAX package's bf16 field
// windows): the JAX fixup pads its field windows in bfloat16
// (pad_fields(..., dtype) in vol9_fixup) while its decision reads the
// unrounded fields. Here the fields are bfloat16, each value widened to
// float32 at its load (gfs::load) and every operation after it the
// float32 kernel's, so the result is the float32 kernel's on the rounded
// fields, bit for bit; the map and the flags (vol9_flags of the float32
// fields) stay float32 and uint8. Compiled apart (T = __nv_bfloat16); the
// float32 instantiations stay as they were.
#include "common.cuh"

namespace {

constexpr int kMaxC = 4;
// A tile covers 32 x 4 x 1 nodes (k, j, i): 128 threads
constexpr int kBlockK = 32, kBlockJ = 4, kBlockI = 1;

using gfs::Axis;
using gfs::Coord;
using gfs::coord;
using gfs::trilerp_zpair;
using gfs::ZPair;
using gfs::zpair;

struct Params {
  float off[3];  // node and field lattice offset of the kind (units of h)
  float lo[3];   // world clamp of the mapped positions, per axis
  float hi[3];
};

// One axis of the map stage at node coordinate x0 (world): the stencil's
// coordinates (x0 - h/4)/h, x0/h, (x0 + h/4)/h, each the plain version's
// (x0 + d*h)/h with d*h = (-0.25, 0, 0.25)*h.
__device__ __forceinline__ Axis map_axis(float x0, float h, int n,
                                         unsigned stride) {
  const float c[3] = {(x0 + -0.25f * h) / h, (x0 + 0.0f * h) / h,
                      (x0 + 0.25f * h) / h};
  return gfs::axis3(c, n, stride);
}

// C channels: a template parameter, so that the field stage's loops over
// the channels unroll with no code for channels that are not there. T:
// the fields' storage.
template <int C, typename T>
__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI)
    vol9_fixup_kernel(const float* __restrict__ maps, int ni, int nj, int nk,
                      const T* __restrict__ fields, int nx,
                      int ny, int nz, const uint8_t* __restrict__ flags,
                      int nb0, int nb1, int nb2, int bx, int by, int bz,
                      float h, Params p, float* __restrict__ out) {
  // the tile's decision block: the tile lies inside one
  const int bi = (int)(blockIdx.z * kBlockI) / bx;
  const int bj = (int)(blockIdx.y * kBlockJ) / by;
  const int bk = (int)(blockIdx.x * kBlockK) / bz;
  if (bi >= nb0 || bj >= nb1 || bk >= nb2) return;
  const unsigned n_blocks = (unsigned)nb0 * nb1 * nb2;
  const unsigned blk = ((unsigned)bi * nb1 + bj) * nb2 + bk;
  unsigned mask = 0;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (__ldg(flags + (c * n_blocks + blk))) mask |= 1u << c;
  if (mask == 0) return;
  const int k = blockIdx.x * kBlockK + threadIdx.x;
  const int j = blockIdx.y * kBlockJ + threadIdx.y;
  const int i = blockIdx.z * kBlockI + threadIdx.z;
  if (k >= nz || j >= ny || i >= nx) return;
  const unsigned n_out = (unsigned)nx * ny * nz;
  const unsigned idx = ((unsigned)i * ny + j) * nz + k;

  // map stage: the 9 mapped positions of the node, clamped, m[a][q]
  const float x0 = ((float)i + p.off[0]) * h;
  const float y0 = ((float)j + p.off[1]) * h;
  const float z0 = ((float)k + p.off[2]) * h;
  const Axis ax = map_axis(x0, h, ni, (unsigned)nj * nk);
  const Axis ay = map_axis(y0, h, nj, (unsigned)nk);
  const Axis az = map_axis(z0, h, nk, 1u);
  const unsigned map_size = (unsigned)ni * nj * nk;
  float m[3][9];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    gfs::stencil9(maps + a * map_size, ax, ay, az, m[a]);
#pragma unroll
    for (int q = 0; q < 9; ++q)
      m[a][q] = fminf(fmaxf(m[a][q], p.lo[a]), p.hi[a]);
  }

  // field stage: one weight set a mapped point for the flagged channels
  const unsigned sx = (unsigned)ny * nz, sy = (unsigned)nz;
  float acc[C], centre[C];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const Coord X = coord(m[0][q] / h - p.off[0], nx);
    const Coord Y = coord(m[1][q] / h - p.off[1], ny);
    const ZPair Z = zpair(m[2][q] / h - p.off[2], nz);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!(mask & (1u << c))) continue;
      const float v = trilerp_zpair(fields + c * n_out, X, Y, Z, sx, sy);
      if (q == 0) {
        acc[c] = v;
      } else if (q < 8) {
        acc[c] = acc[c] + v;
      } else {
        centre[c] = v;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (mask & (1u << c))
      out[c * n_out + idx] = 0.5f * (acc[c] / 8.0f) + 0.5f * centre[c];
}

template <typename T>
void launch(dim3 grid, dim3 block, cudaStream_t s, int C, const float* m,
            int ni, int nj, int nk, const T* f, int nx, int ny, int nz,
            const uint8_t* fl, int nb0, int nb1, int nb2, int bx, int by,
            int bz, float h, const Params& p, float* o) {
  switch (C) {
    case 1:
      vol9_fixup_kernel<1, T><<<grid, block, 0, s>>>(
          m, ni, nj, nk, f, nx, ny, nz, fl, nb0, nb1, nb2, bx, by, bz, h, p, o);
      break;
    case 2:
      vol9_fixup_kernel<2, T><<<grid, block, 0, s>>>(
          m, ni, nj, nk, f, nx, ny, nz, fl, nb0, nb1, nb2, bx, by, bz, h, p, o);
      break;
    case 3:
      vol9_fixup_kernel<3, T><<<grid, block, 0, s>>>(
          m, ni, nj, nk, f, nx, ny, nz, fl, nb0, nb1, nb2, bx, by, bz, h, p, o);
      break;
    default:
      vol9_fixup_kernel<4, T><<<grid, block, 0, s>>>(
          m, ni, nj, nk, f, nx, ny, nz, fl, nb0, nb1, nb2, bx, by, bz, h, p, o);
  }
}

}  // namespace

// One launch; bf16: the fields are bfloat16, else float32.
static int vol9_fixup(const void* maps, int ni, int nj, int nk,
                      const void* fields, bool bf16, int C, int nx, int ny,
                      int nz, const void* flags, int nb0, int nb1, int nb2,
                      int bx, int by, int bz, float h,
                      const float* params_host, void* out, void* stream) {
  const long long limit = 1LL << 31;
  if (C < 1 || C > kMaxC || ni < 1 || nj < 1 || nk < 1 || nx < 1 ||
      ny < 1 || nz < 2 || bx < 1 || by < 1 || bz < 1 || bx % kBlockI ||
      by % kBlockJ || bz % kBlockK || 3LL * ni * nj * nk >= limit ||
      (long long)C * nx * ny * nz >= limit ||
      (long long)C * nb0 * nb1 * nb2 >= limit)
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int a = 0; a < 3; ++a) {
    p.off[a] = params_host[a];
    p.lo[a] = params_host[3 + a];
    p.hi[a] = params_host[6 + a];
  }
  const dim3 block(kBlockK, kBlockJ, kBlockI);
  const dim3 grid((nz + kBlockK - 1) / kBlockK, (ny + kBlockJ - 1) / kBlockJ,
                  (nx + kBlockI - 1) / kBlockI);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const float* m = (const float*)maps;
  const uint8_t* fl = (const uint8_t*)flags;
  float* o = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch(grid, block, s, C, m, ni, nj, nk, (const __nv_bfloat16*)fields,
           nx, ny, nz, fl, nb0, nb1, nb2, bx, by, bz, h, p, o);
  else
    launch(grid, block, s, C, m, ni, nj, nk, (const float*)fields, nx, ny,
           nz, fl, nb0, nb1, nb2, bx, by, bz, h, p, o);
  return (int)cudaGetLastError();
}

// float32 fields
extern "C" int gfs_vol9_fixup(const void* maps, int ni, int nj, int nk,
                              const void* fields, int C, int nx, int ny,
                              int nz, const void* flags, int nb0, int nb1,
                              int nb2, int bx, int by, int bz, float h,
                              const float* params_host, void* out,
                              void* stream) {
  return vol9_fixup(maps, ni, nj, nk, fields, false, C, nx, ny, nz, flags,
                    nb0, nb1, nb2, bx, by, bz, h, params_host, out, stream);
}

// bfloat16 fields (the bf16 mode); the same arguments
extern "C" int gfs_vol9_fixup_bf16(const void* maps, int ni, int nj, int nk,
                                   const void* fields, int C, int nx, int ny,
                                   int nz, const void* flags, int nb0,
                                   int nb1, int nb2, int bx, int by, int bz,
                                   float h, const float* params_host,
                                   void* out, void* stream) {
  return vol9_fixup(maps, ni, nj, nk, fields, true, C, nx, ny, nz, flags,
                    nb0, nb1, nb2, bx, by, bz, h, params_host, out, stream);
}
