// Shared device helpers of the port's kernels.
//
// trilerp_clamped is the exact clamped-index trilinear of
// gpufluidsimulation_tpu.core.interp.sample3 (and of the plain
// gpufluidsimulation_tpu_torch.core.interp.trilerp_grid): corner indices
// floor(g) and floor(g)+1 are clamped per axis to the field, and the blend
// runs x, then y, then z. The library is built with -fmad=false, so every
// product and sum below rounds as its PyTorch counterpart does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gfs {

constexpr int kThreads = 256;

// A field value as float32. The samplers that read field values (not maps
// or positions) are templated on their storage: float32, loaded as it is,
// or bfloat16 (the bf16 field windows of EngineMode.interp_bf16), whose 16
// bits are the high half of a float32 and are widened exactly at the load.
// All arithmetic after the load is float32, so a bfloat16 launch computes
// the float32 kernel's function of the rounded values, bit for bit.
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Flat offset of node (i, j, k) of an (nx, ny, nz) k-fastest array, each
// index clamped to the array.
__device__ __forceinline__ int64_t clamped_offset(int i, int j, int k, int nx,
                                                  int ny, int nz) {
  return ((int64_t)clampi(i, 0, nx - 1) * ny + clampi(j, 0, ny - 1)) * nz +
         clampi(k, 0, nz - 1);
}

// Trilinear sample of an (nx, ny, nz) k-fastest field at grid coordinates
// (index units on the field's own lattice).
__device__ __forceinline__ float trilerp_clamped(
    const float* __restrict__ f, int nx, int ny, int nz,
    float gx, float gy, float gz) {
  const float i0f = floorf(gx), j0f = floorf(gy), k0f = floorf(gz);
  const float fx = gx - i0f, fy = gy - j0f, fz = gz - k0f;
  const int i0 = (int)i0f, j0 = (int)j0f, k0 = (int)k0f;
  const int64_t ia = clampi(i0, 0, nx - 1), ib = clampi(i0 + 1, 0, nx - 1);
  const int64_t ja = clampi(j0, 0, ny - 1), jb = clampi(j0 + 1, 0, ny - 1);
  const int64_t ka = clampi(k0, 0, nz - 1), kb = clampi(k0 + 1, 0, nz - 1);
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  const float v000 = __ldg(f + ia * sx + ja * sy + ka);
  const float v100 = __ldg(f + ib * sx + ja * sy + ka);
  const float v010 = __ldg(f + ia * sx + jb * sy + ka);
  const float v110 = __ldg(f + ib * sx + jb * sy + ka);
  const float v001 = __ldg(f + ia * sx + ja * sy + kb);
  const float v101 = __ldg(f + ib * sx + ja * sy + kb);
  const float v011 = __ldg(f + ia * sx + jb * sy + kb);
  const float v111 = __ldg(f + ib * sx + jb * sy + kb);
  const float c00 = (1.0f - fx) * v000 + fx * v100;
  const float c10 = (1.0f - fx) * v010 + fx * v110;
  const float c01 = (1.0f - fx) * v001 + fx * v101;
  const float c11 = (1.0f - fx) * v011 + fx * v111;
  const float c0 = (1.0f - fy) * c00 + fy * c10;
  const float c1 = (1.0f - fy) * c01 + fy * c11;
  return (1.0f - fz) * c0 + fz * c1;
}

// ---------------------------------------------------------------------------
// Building blocks of the redesigned samplers (rk3_substep, dmc_substep,
// trilerp_sample, vol9_fixup). Every one evaluates clamped trilinears with
// the operands and the x, then y, then z order of trilerp_clamped, so that
// the results stay bit-identical, but shares floors, weights and offsets
// between samples, and indexes with unsigned 32-bit offsets (the wrappers
// raise unless every array holds fewer than 2^31 values): a load then adds
// the offset to the array's base address in the load itself.
// ---------------------------------------------------------------------------

// The clamped node of an integral float coordinate. Clamping in float
// keeps huge or non-finite coordinates at the edge node, as the plain
// version's integer clamp does.
__device__ __forceinline__ unsigned clamp_node(float i, int n) {
  return (unsigned)fminf(fmaxf(i, 0.0f), (float)(n - 1));
}

// One x or y coordinate of a trilinear sample: its fraction f, 1 - f,
// and the clamped corner nodes floor(g) and floor(g) + 1.
struct Coord {
  float f, w;
  unsigned lo, hi;
};

// The z coordinate: f, 1 - f, the first node lo of the loaded pair
// (lo, lo + 1), and whether both clamped corners sit at lo + 1 (top) or at
// lo (bottom; also for a NaN, which the plain clamp sends to node 0).
struct ZPair {
  float f, w;
  unsigned lo;
  bool top, bottom;
};

__device__ __forceinline__ Coord coord(float g, int n) {
  Coord c;
  const float fl = floorf(g);
  c.f = g - fl;
  c.w = 1.0f - c.f;
  c.lo = clamp_node(fl, n);
  c.hi = clamp_node(fl + 1.0f, n);
  return c;
}

// Along z, the innermost axis, the corners are loaded as the pair (lo,
// lo + 1) with lo = clamp(floor(g), 0, n - 2), two loads from one address;
// where the plain version's clamped corners coincide (floor(g) <= -1: both
// 0; floor(g) >= n - 1: both n - 1), the pair's lerped value at that node
// is taken for both after the x and y lerps, which are the same operations
// on the same values, so the same bits. Needs n >= 2.
__device__ __forceinline__ ZPair zpair(float g, int n) {
  ZPair c;
  const float fl = floorf(g);
  c.f = g - fl;
  c.w = 1.0f - c.f;
  c.lo = clamp_node(fl, n - 1);
  c.top = fl >= (float)(n - 1);
  c.bottom = !(fl >= 0.0f);
  return c;
}

// ---------------------------------------------------------------------------
// Slab mode (the sharded path): an array holds planes z0 .. z0 + n - 1 of a
// grid whose z extent is N planes. Coordinates stay global: the float
// index, its floor and its weights are formed exactly as on the whole
// grid, and the node is clamped to the global bounds [0, N - 1]. Only then
// is the integer origin z0 subtracted, to address the slab; a node that
// falls outside the slab is clamped to its edge and sets `out`. With z0 = 0
// and n = N nothing changes, so a slab launch whose nodes stay inside its
// slab reads the values, and gives the bits, of the whole-grid launch.
// ---------------------------------------------------------------------------

// The slab node of a global node g clamped to [0, N - 1].
__device__ __forceinline__ unsigned slab_node(unsigned g, int z0, int n,
                                              bool& out) {
  const int l = (int)g - z0;
  const int c = clampi(l, 0, n - 1);
  out |= c != l;
  return (unsigned)c;
}

// zpair on a slab: the plain version's two clamped corners, each taken to
// the slab (la <= lb), loaded as the pair (lo, lo + 1) of the slab.
__device__ __forceinline__ ZPair zpair_slab(float g, int N, int z0, int n,
                                            bool& out) {
  ZPair c;
  const float fl = floorf(g);
  c.f = g - fl;
  c.w = 1.0f - c.f;
  const unsigned la = slab_node(clamp_node(fl, N), z0, n, out);
  const unsigned lb = slab_node(clamp_node(fl + 1.0f, N), z0, n, out);
  c.top = la >= (unsigned)(n - 1);
  c.bottom = la == lb && !c.top;
  c.lo = c.top ? (unsigned)(n - 2) : la;
  return c;
}

// The 8 values a clamped trilerp reads, loaded as 4 z pairs: v[q][p] at
// the (x, y) corner q = (x.lo, y.lo), (x.hi, y.lo), (x.lo, y.hi),
// (x.hi, y.hi) and z node z.lo + p; (sx, sy) the field's x and y strides.
struct Corners {
  float v[4][2];
};

template <typename T>
__device__ __forceinline__ Corners corners_zpair(const T* __restrict__ f,
                                                 const Coord& x,
                                                 const Coord& y,
                                                 const ZPair& z, unsigned sx,
                                                 unsigned sy) {
  const unsigned xa = x.lo * sx, xb = x.hi * sx;
  const unsigned ya = y.lo * sy, yb = y.hi * sy;
  const T* row[4] = {f + (xa + ya + z.lo), f + (xb + ya + z.lo),
                     f + (xa + yb + z.lo), f + (xb + yb + z.lo)};
  Corners c;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    c.v[q][0] = load(row[q]);
    c.v[q][1] = load(row[q] + 1);
  }
  return c;
}

// The blend of trilerp_clamped from the corners of corners_zpair.
__device__ __forceinline__ float blend_zpair(const Corners& c, const Coord& x,
                                             const Coord& y, const ZPair& z) {
  // the x, then y lerps at z nodes lo and lo + 1
  const float c00 = x.w * c.v[0][0] + x.f * c.v[1][0];
  const float c10 = x.w * c.v[2][0] + x.f * c.v[3][0];
  const float c01 = x.w * c.v[0][1] + x.f * c.v[1][1];
  const float c11 = x.w * c.v[2][1] + x.f * c.v[3][1];
  const float l0 = y.w * c00 + y.f * c10;
  const float l1 = y.w * c01 + y.f * c11;
  // the plain version's lerps at its two clamped z corners
  const float c0 = z.top ? l1 : l0;
  const float c1 = z.bottom ? l0 : l1;
  return z.w * c0 + z.f * c1;
}

// The clamped trilerp of trilerp_clamped from per-axis coordinates, (sx,
// sy) the field's x and y strides. Samples of several fields of one shape
// at one position share x, y, z and the offsets.
template <typename T>
__device__ __forceinline__ float trilerp_zpair(const T* __restrict__ f,
                                               const Coord& x, const Coord& y,
                                               const ZPair& z, unsigned sx,
                                               unsigned sy) {
  return blend_zpair(corners_zpair(f, x, y, z, sx, sy), x, y, z);
}

// One axis of a 3-point stencil whose coordinates c[0] <= c[1] <= c[2]
// span less than one node (the volume stencils' g - 1/4, g, g + 1/4):
// their floors lie within B = floor(c[0]) and B + 1, so the fractions f,
// the offsets (index times stride) of the clamped nodes B, B + 1, B + 2,
// and whether coordinate q takes its corners at (B+1, B+2) rather than
// (B, B+1) describe every sample. Coordinate 0 always takes (B, B+1), so
// its up flag is a constant false (for a NaN c[0], where floor(c[0]) !=
// B, every clamped node is node 0 and either choice reads the same
// values): its lerps need no selects.
struct Axis {
  float f[3];
  unsigned node[3];
  bool up[3];
};

__device__ __forceinline__ Axis axis3(const float (&c)[3], int n,
                                      unsigned stride) {
  Axis a;
  const float base = floorf(c[0]);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float fl = floorf(c[q]);
    a.f[q] = c[q] - fl;
    a.up[q] = q > 0 && fl != base;
    a.node[q] = clamp_node(base + (float)q, n) * stride;
  }
  return a;
}

// axis3 along z on a slab: the nodes B, B + 1, B + 2 clamped to the global
// bounds, then to the slab (stride 1). `out` is set where a node that a
// sample uses left the slab: B and B + 1 always, B + 2 where a coordinate
// takes its corners at (B + 1, B + 2).
__device__ __forceinline__ Axis axis3_slab(const float (&c)[3], int N, int z0,
                                           int n, bool& out) {
  Axis a;
  const float base = floorf(c[0]);
  bool past[3] = {false, false, false};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float fl = floorf(c[q]);
    a.f[q] = c[q] - fl;
    a.up[q] = q > 0 && fl != base;
    a.node[q] = slab_node(clamp_node(base + (float)q, N), z0, n, past[q]);
  }
  out |= past[0] || past[1] || (past[2] && (a.up[1] || a.up[2]));
  return a;
}

// (1 - f) * lo + f * hi, the blend of the plain version (1 - f is not
// kept per coordinate: recomputing it costs less than the registers)
__device__ __forceinline__ float lerp(float f, float lo, float hi) {
  return (1.0f - f) * lo + f * hi;
}

// The 9 samples of the volume stencil from a field's clamped 3 x 3 x 3
// neighbourhood, 27 loads: s[0..7] at the corners (x, y, z coordinates 0
// or 2) in _VOL3 order (+,+,+) (+,+,-) (+,-,+) (+,-,-) (-,+,+) ... (-,-,-),
// + coordinate 2 and - coordinate 0, and s[8] at the centre (1, 1, 1). The
// corners of each sample are picked by selects on the axes' up flags with
// compile-time register indices (no dynamic indexing, so no local memory),
// and lerps that two samples share (same x coordinate and the same two
// nodes) are computed once: the x lerps for all 9 (y, z) node pairs of each
// x coordinate, the y lerps per (x, y) coordinate pair, then one z lerp per
// sample.
template <typename T>
__device__ __forceinline__ void stencil9(const T* __restrict__ f,
                                         const Axis& ax, const Axis& ay,
                                         const Axis& az, float (&s)[9]) {
  // one z node at a time: its 9 (x, y) nodes, the x lerps of each y node
  // for each x coordinate, then the y lerps of the (x, y) coordinate pairs
  // the 9 samples use, (-,-) (-,+) (+,-) (+,+) and the centre's (0,0):
  // pair p at x coordinate qx and y coordinate qy
  float Y[5][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        v[a][b] = load(f + (ax.node[a] + ay.node[b] + az.node[c]));
    float X[3][3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float lo = ax.up[q] ? v[1][b] : v[0][b];
        const float hi = ax.up[q] ? v[2][b] : v[1][b];
        X[q][b] = lerp(ax.f[q], lo, hi);
      }
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const int qx = p == 4 ? 1 : (p < 2 ? 0 : 2);
      const int qy = p == 4 ? 1 : (p % 2 == 0 ? 0 : 2);
      const float lo = ay.up[qy] ? X[qx][1] : X[qx][0];
      const float hi = ay.up[qy] ? X[qx][2] : X[qx][1];
      Y[p][c] = lerp(ay.f[qy], lo, hi);
    }
  }
  // z lerp of one sample from its (x, y) pair and z coordinate
  auto zl = [&](int p, int qz) {
    const float lo = az.up[qz] ? Y[p][1] : Y[p][0];
    const float hi = az.up[qz] ? Y[p][2] : Y[p][1];
    return lerp(az.f[qz], lo, hi);
  };
  // pair index: (+,+) 3, (+,-) 2, (-,+) 1, (-,-) 0
  s[0] = zl(3, 2);
  s[1] = zl(3, 0);
  s[2] = zl(2, 2);
  s[3] = zl(2, 0);
  s[4] = zl(1, 2);
  s[5] = zl(1, 0);
  s[6] = zl(0, 2);
  s[7] = zl(0, 0);
  s[8] = zl(4, 1);
}

// Sum of the six axis neighbours of cell (i, j, k) of an (nx, ny, nz)
// k-fastest field with zero ghosts outside it, in the order of the JAX
// smoothers: ((((((0 + x[i+1]) + x[i-1]) + x[j+1]) + x[j-1]) + x[k+1]) + x[k-1]).
__device__ __forceinline__ float neighbour_sum(const float* x, int64_t idx,
                                               int i, int j, int k, int nx,
                                               int ny, int nz) {
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  float nb = 0.0f;
  nb = nb + (i < nx - 1 ? x[idx + sx] : 0.0f);
  nb = nb + (i > 0 ? x[idx - sx] : 0.0f);
  nb = nb + (j < ny - 1 ? x[idx + sy] : 0.0f);
  nb = nb + (j > 0 ? x[idx - sy] : 0.0f);
  nb = nb + (k < nz - 1 ? x[idx + 1] : 0.0f);
  nb = nb + (k > 0 ? x[idx - 1] : 0.0f);
  return nb;
}

inline unsigned int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 64;  // grid-stride beyond 64 blocks per SM
  return (unsigned int)(b < cap ? (b > 0 ? b : 1) : cap);
}

}  // namespace gfs
