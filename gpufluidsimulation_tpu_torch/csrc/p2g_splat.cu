// p2g_splat: the 2D particle-to-grid transfer of FLIP, APIC and PolyPIC
// onto the u, v and cell lattices, in gather form, in one launch.
//
// Replaces the TPU kernel path's XLA code, which has no pallas_call:
// gpufluidsimulation_tpu/solvers/particles.py _splat_multi_sorted and
// _splat_poly_multi_sorted (:106-165), one sorted segment_sum a tap over
// particles that bin_sort ordered by the key sx*(2nj+4) + ky, with
// sx = floor(x/h - 0.5) and ky = floor(2y/h). Per node (ii, jj) of a
// lattice with offset (ox, oy) and per channel the result is
//   sum over taps of sum over particles of w * value,  w = hat(gx - ii) *
//   hat(gy - jj),  hat(r) = max(0, 1 - |r|),  g = p / h - o (IEEE),
// divided by the summed weight + 1e-4; the value is the particle's
// channel (FLIP) or its polynomial c0 + c1 dx + c2 dy (+ c3 dx dy for
// PolyPIC) at dx = (ii - gx) h, dy = (jj - gy) h.
//
// Design: a gather, not atomics. One thread a node, all of the lattice's
// channels in that thread; blockIdx.y picks the lattice (0: u, 1: v, 2:
// the cell lattice with rho and T). A particle of bin sx has x taps sx,
// sx + 1 (and sx + 2 on the u lattice, whose taps JAX takes from the same
// base), so node ii reads the bins sx = ii - di, di = 0, 1 (, 2). Its y
// taps are j0 = floor(gy) and j0 + 1, and j0 is a function of ky alone:
// 2y/h is 2 (y/h) exactly, and y/h - oy is exact for y/h >= 0.5 (both
// multiples of y/h's ulp) and lies in [-0.5, 0) below. So within an sx
// group the particles whose tap jj is j0 (JAX's dj = 0) are exactly the
// keys ky in [2(jj + oy), 2(jj + oy) + 2) and those whose tap is j0 + 1
// (dj = 1) the two bins below: each a contiguous run of the sorted
// particles, whose bounds come from `starts` (the first particle of
// every key, one searchsorted over the sorted keys). Each run is summed
// in order from 0, as XLA's segment_sum of that tap sums it, and added to
// the node's total in JAX's tap order (di, then dj): every term and every
// sum is the plain version's, so on the CPU, where index_add_ sums in
// order, the two agree bit for bit, and on the card the result is the
// same bits from run to run (the plain version's atomics reorder its
// sums). A bin may hold any number of particles: a pile-up on the clamp
// ring is summed by the threads of the nodes around it, serially.
//
// Contract (the step's clamp guarantees it, as for JAX's sorted splat):
// positions in [h, (n-1)h], so sx lies in [0, ni) and ky in [0, 2nj+4).
// Offsets are 32-bit: the wrapper raises unless P, the starts and the
// output fit.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 4;

// The particle columns: channel c of particle k is col[c][k * stride[c]]
// in the FLIP mode, the 4 coefficients at col[c] + 4k in the poly modes.
// Channel 0 goes to u, 1 to v, 2 and 3 to the cell lattice.
struct Cols {
  const float* col[4];
  int stride[4];
};

enum Order { kFlip = 0, kApic = 1, kPolyPic = 2 };

__device__ __forceinline__ float hat(float r) {
  const float t = 1.0f - fabsf(r);
  return t < 0.0f ? 0.0f : t;   // NaN stays NaN, as jnp.maximum keeps it
}

// channel value of particle k: its column entry (FLIP) or its polynomial
// at (dx, dy), summed left to right as JAX sums it
template <int kOrder>
__device__ __forceinline__ float value(const float* __restrict__ col,
                                       int stride, int k, float dx,
                                       float dy) {
  if (kOrder == kFlip) return __ldg(col + (unsigned)k * (unsigned)stride);
  const float4 q = __ldg(reinterpret_cast<const float4*>(col) + k);
  float val = q.x + q.y * dx + q.z * dy;
  if (kOrder == kPolyPic) val = val + q.w * dx * dy;
  return val;
}

// particle k's terms at node (fi, fj): w * value for the lattice's one
// or two channels, and w
template <int kOrder>
__device__ __forceinline__ void term(
    const float2* __restrict__ pos, const float* __restrict__ colA, int strA,
    const float* __restrict__ colB, int strB, int nch, int k, float fi,
    float fj, float ox, float oy, float h, float& t0, float& t1, float& tw) {
  const float2 p = __ldg(pos + k);
  const float gx = p.x / h - ox;
  const float gy = p.y / h - oy;
  const float w = hat(gx - fi) * hat(gy - fj);
  float dx = 0.0f, dy = 0.0f;
  if (kOrder != kFlip) {
    dx = (fi - gx) * h;
    dy = (fj - gy) * h;
  }
  t0 = w * value<kOrder>(colA, strA, k, dx, dy);
  t1 = nch == 2 ? w * value<kOrder>(colB, strB, k, dx, dy) : 0.0f;
  tw = w;
}

template <int kOrder>
__global__ void __launch_bounds__(kThreads)
    p2g_splat_kernel(const float2* __restrict__ pos, Cols cols,
                     const int* __restrict__ starts, int ni, int nj, float h,
                     float* __restrict__ out) {
  const int lat = blockIdx.y;
  const int nx = lat == 0 ? ni + 1 : ni;
  const int ny = lat == 1 ? nj + 1 : nj;
  const float ox = lat == 0 ? 0.0f : 0.5f;
  const float oy = lat == 1 ? 0.0f : 0.5f;
  const int ndi = lat == 0 ? 3 : 2;
  const int nch = lat == 2 ? 2 : 1;
  // the lattice's columns, picked by selects (no dynamic index into the
  // kernel's parameters)
  const float* colA = lat == 0 ? cols.col[0] : (lat == 1 ? cols.col[1]
                                                         : cols.col[2]);
  const int strA = lat == 0 ? cols.stride[0] : (lat == 1 ? cols.stride[1]
                                                         : cols.stride[2]);
  const float* colB = cols.col[3];
  const int strB = cols.stride[3];
  const unsigned idx = blockIdx.x * (unsigned)kThreads + threadIdx.x;
  if (idx >= (unsigned)nx * (unsigned)ny) return;
  const int ii = (int)(idx / (unsigned)ny);
  const int jj = (int)(idx - (unsigned)ii * (unsigned)ny);
  const float fi = (float)ii, fj = (float)jj;
  const int W = 2 * nj + 4;
  // first key of the particles whose y tap jj is their j0: 2(jj + oy)
  const int split = 2 * jj + (lat == 1 ? 0 : 1);
  const int klo = max(split - 2, 0), kmid = min(split, W),
            khi = min(split + 2, W);
  float acc0 = 0.0f, acc1 = 0.0f, accw = 0.0f;
  for (int di = 0; di < ndi; ++di) {
    const int sx = ii - di;
    if (sx < 0 || sx >= ni) continue;
    const int* st = starts + sx * W;
    const int b0 = __ldg(st + klo), bm = __ldg(st + kmid),
              b1 = __ldg(st + khi);
    // JAX's tap order within di: dj = 0 (j0 = jj), then dj = 1
    for (int dj = 0; dj < 2; ++dj) {
      const int from = dj == 0 ? bm : b0, to = dj == 0 ? b1 : bm;
      if (from >= to) continue;
      float s0 = 0.0f, s1 = 0.0f, sw = 0.0f;
      // kBatch particles' loads and terms are formed together (they are
      // independent) and then added in order, so a long run (a pile-up)
      // waits on memory once a batch, not once a particle
      int k = from;
      for (; k + kBatch <= to; k += kBatch) {
        float t0[kBatch], t1[kBatch], tw[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          term<kOrder>(pos, colA, strA, colB, strB, nch, k + b, fi, fj, ox,
                       oy, h, t0[b], t1[b], tw[b]);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          s0 = s0 + t0[b];
          s1 = s1 + t1[b];
          sw = sw + tw[b];
        }
      }
      for (; k < to; ++k) {
        float t0, t1, tw;
        term<kOrder>(pos, colA, strA, colB, strB, nch, k, fi, fj, ox, oy, h,
                     t0, t1, tw);
        s0 = s0 + t0;
        s1 = s1 + t1;
        sw = sw + tw;
      }
      acc0 = acc0 + s0;
      acc1 = acc1 + s1;
      accw = accw + sw;
    }
  }
  const float weight = accw + 1e-4f;
  const unsigned nu = (unsigned)(ni + 1) * nj, nv = (unsigned)ni * (nj + 1);
  const unsigned nc = (unsigned)ni * nj;
  const unsigned base = lat == 0 ? 0u : (lat == 1 ? nu : nu + nv);
  out[base + idx] = acc0 / weight;
  if (nch == 2) out[base + nc + idx] = acc1 / weight;
}

}  // namespace

// pos: (P, 2) bin-sorted positions; cols/strides: the 4 channel columns
// (FLIP: element strides; poly: (P, 4) rows); order 0 FLIP, 1 APIC, 2
// PolyPIC; starts: ni * (2nj + 4) + 1 int32 first-particle offsets of
// the keys; out: u (ni+1, nj), v (ni, nj+1), rho and T (ni, nj), one
// after the other.
extern "C" int gfs_p2g_splat(const void* pos, const void* const* cols,
                             const int* strides, int order,
                             const void* starts, int ni, int nj, float h,
                             long long P, void* out, void* stream) {
  const long long limit = 1LL << 31;
  if (ni < 1 || nj < 1 || P < 1 || 2 * P >= limit || order < kFlip ||
      order > kPolyPic ||
      (long long)ni * (2LL * nj + 4) + 1 >= limit ||
      (long long)(ni + 1) * nj + (long long)ni * (nj + 1) +
              2LL * ni * nj >= limit)
    return (int)cudaErrorInvalidValue;
  Cols c;
  for (int k = 0; k < 4; ++k) {
    c.col[k] = (const float*)cols[k];
    c.stride[k] = strides[k];
  }
  const long long nu = (long long)(ni + 1) * nj, nv = (long long)ni * (nj + 1);
  const long long most = nu > nv ? nu : nv;
  const dim3 grid((unsigned)((most + kThreads - 1) / kThreads), 3);
  const cudaStream_t st = (cudaStream_t)stream;
  const float2* p = (const float2*)pos;
  const int* s = (const int*)starts;
  float* o = (float*)out;
  if (order == kFlip)
    p2g_splat_kernel<kFlip><<<grid, kThreads, 0, st>>>(p, c, s, ni, nj, h, o);
  else if (order == kApic)
    p2g_splat_kernel<kApic><<<grid, kThreads, 0, st>>>(p, c, s, ni, nj, h, o);
  else
    p2g_splat_kernel<kPolyPic><<<grid, kThreads, 0, st>>>(p, c, s, ni, nj, h,
                                                           o);
  return (int)cudaGetLastError();
}
