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
// The runs. A particle of bin sx has x taps sx, sx + 1 (and sx + 2 on the
// u lattice, whose taps JAX takes from the same base), so node ii reads
// the bins sx = ii - di, di = 0, 1 (, 2). Its y taps are j0 = floor(gy)
// and j0 + 1, and j0 is a function of ky alone: 2y/h is 2 (y/h) exactly,
// and y/h - oy is exact for y/h >= 0.5 (both multiples of y/h's ulp) and
// lies in [-0.5, 0) below. So within an sx group the particles whose tap
// jj is j0 (JAX's dj = 0) are exactly the keys ky in [2(jj + oy), 2(jj +
// oy) + 2) and those whose tap is j0 + 1 (dj = 1) the two bins below:
// each a contiguous run of the sorted particles, whose bounds come from
// `starts` (the first particle of every key, one searchsorted over the
// sorted keys). Each run is summed in order from 0, as XLA's segment_sum
// of that tap sums it, and added to the node's total in JAX's tap order
// (di, then dj): every term and every sum is the plain version's, so on
// the CPU, where index_add_ sums in order, the two agree bit for bit, and
// on the card the result is the same bits from run to run (the plain
// version's atomics reorder its sums).
//
// Design. The bound is bytes (each particle's position and columns read
// once, the outputs written once), but a node's sum is an in-order chain
// of float adds, one a particle of its runs, and a pile of particles on
// one node (the clamp ring gathers them) makes that chain as long as the
// pile. So the work is split in two: a CTA owns a tile of nodes, one x
// column ii of one lattice by kTile nodes jj, one owner thread a node.
// For each x tap di the particles that feed the tile are one contiguous
// slice of the sorted particles (the keys sx*W + [2 J0 + 2oy - 2, 2 (J1 -
// 1) + 2oy + 2), sx = ii - di), which the CTA walks in chunks of kChunk:
// its threads load a chunk's positions and columns (coalesced, one
// particle a thread a row, in flight while the chunk before is added)
// and form each particle's two terms at the tile's column, dj = 0 at node j0 and dj = 1 at node j0 + 1, into
// shared-memory slots: the division by h, the hats and the polynomial
// once a particle and column, not once a node. After one barrier each
// owner adds the terms of its runs that lie in the chunk out of the
// slots, in particle order, onto its two run sums, which it carries from
// chunk to chunk and adds to its total when the tap changes. A pile
// longer than a chunk is just more chunks; its owner's chain of adds,
// one FADD a particle on each of its 2-3 channels, is the one serial
// part left, and the two nodes a pile reaches on a lattice add on two
// warps at once.
//
// Contract (the step's clamp guarantees it, as for JAX's sorted splat):
// positions in [h, (n-1)h], so sx lies in [0, ni) and ky in [0, 2nj+4).
// Offsets are 32-bit: the wrapper raises unless P, the starts and the
// output fit.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // a CTA's threads
constexpr int kTile = kThreads;  // nodes jj of a tile, one owner thread each
constexpr int kChunk = 512;     // particles staged at a time
constexpr int kPer = kChunk / kThreads;
constexpr int kMaxTaps = 3;     // x taps: 3 on the u lattice, 2 on v and c
constexpr int kBlocksPerSM = 5;
static_assert(kChunk % kThreads == 0, "a chunk is whole rows of threads");
static_assert(kThreads % 64 == 0, "owners pair their warps (splat_tile)");

// The particle columns: channel c of particle k is col[c][k * stride[c]]
// in the FLIP mode, the 4 coefficients at col[c] + 4k in the poly modes.
// Channel 0 goes to u, 1 to v, 2 and 3 to the cell lattice.
struct Cols {
  const float* col[4];
  int stride[4];
};

enum Order { kFlip = 0, kApic = 1, kPolyPic = 2 };

// a particle's staged channel: its value (FLIP) or its 4 coefficients
template <int kOrder>
using Coef = typename std::conditional<kOrder == kFlip, float, float4>::type;

// a slot: a particle's terms at one node, w * value for the lattice's one
// or two channels and w: (t0, w) or (t0, t1, w, unused)
template <int kNch>
using Slot = typename std::conditional<kNch == 1, float2, float4>::type;

__device__ __forceinline__ float hat(float r) {
  const float t = 1.0f - fabsf(r);
  return t < 0.0f ? 0.0f : t;   // NaN stays NaN, as jnp.maximum keeps it
}

template <int kOrder>
__device__ __forceinline__ Coef<kOrder> load_coef(
    const float* __restrict__ col, int stride, int k) {
  if constexpr (kOrder == kFlip)
    return __ldg(col + (unsigned)k * (unsigned)stride);
  else
    return __ldg(reinterpret_cast<const float4*>(col) + k);
}

// a channel's value at (dx, dy): the column entry (FLIP) or the
// polynomial summed left to right as JAX sums it
template <int kOrder>
__device__ __forceinline__ float value(const Coef<kOrder>& q, float dx,
                                       float dy) {
  if constexpr (kOrder == kFlip) {
    return q;
  } else {
    float val = q.x + q.y * dx + q.z * dy;
    if (kOrder == kPolyPic) val = val + q.w * dx * dy;
    return val;
  }
}

__device__ __forceinline__ float2 make_slot(float t0, float, float w,
                                            float2) {
  return make_float2(t0, w);
}
__device__ __forceinline__ float4 make_slot(float t0, float t1, float w,
                                            float4) {
  return make_float4(t0, t1, w, 0.0f);
}
__device__ __forceinline__ void add(float2& s, const float2& t) {
  s.x = s.x + t.x;
  s.y = s.y + t.y;
}
__device__ __forceinline__ void add(float4& s, const float4& t) {
  s.x = s.x + t.x;
  s.y = s.y + t.y;
  s.z = s.z + t.z;
}

// the slots sl[from, to) added in order onto s, one chain a channel
template <class S>
__device__ __forceinline__ void add_run(const S* __restrict__ sl, int from,
                                        int to, S& s) {
#pragma unroll 4
  for (int k = from; k < to; ++k) add(s, sl[k]);
}

// One tile: column ii of a lattice with offset (ox, oy = o / 2), nodes
// jj in [J0, J1), ndi x taps, kNch channels (columns A and B; outputs
// outA and outB point at the column's node 0).
template <int kOrder, int kNch>
__device__ __forceinline__ void splat_tile(
    const float2* __restrict__ pos, const float* __restrict__ colA, int strA,
    const float* __restrict__ colB, int strB, const int* __restrict__ starts,
    int ni, int W, int ii, int J0, int J1, int ndi, int o, float ox,
    float oy, float h, float* __restrict__ outA, float* __restrict__ outB,
    int (&slice)[kMaxTaps][2], int (&runs)[kMaxTaps][3][kThreads]) {
  using S = Slot<kNch>;
  extern __shared__ float4 smem[];
  S* const slots = reinterpret_cast<S*>(smem);  // [buffer][dj][kChunk]
  const int t = threadIdx.x;
  const float fi = (float)ii;
  // the owner's node: warps 2w and 2w + 1 hold the even and the odd nodes
  // of [64w, 64w + 64), so that neighbouring nodes, which a pile's two y
  // taps reach, add on two warps and not on two paths of one
  const int jj = J0 + (((t & 31) << 1) | ((t >> 5) & 1)) + (t & ~63);
  const bool owner = jj < J1;
  // first key of the particles whose y tap jj is their j0: 2(jj + oy)
  const int split = 2 * jj + o;
  const int klo = max(split - 2, 0), kmid = min(split, W),
            khi = min(split + 2, W);
  // the tile's keys within a column
  const int tlo = max(2 * J0 + o - 2, 0), thi = min(2 * (J1 - 1) + o + 2, W);
  // per x tap d: the tile's slice [lo, hi) of column sx = ii - d and the
  // owner's runs, [b0, bm) for dj = 1 and [bm, b1) for dj = 0, empty where
  // sx leaves [0, ni). They sit in shared memory, read a few times a
  // chunk, and take no registers between those reads.
#pragma unroll
  for (int d = 0; d < kMaxTaps; ++d) {
    const int sx = ii - d;
    const bool ok = d < ndi && sx >= 0 && sx < ni;
    const int* st = starts + (ok ? sx : 0) * W;
    if (t < 2) slice[d][t] = ok ? __ldg(st + (t == 0 ? tlo : thi)) : 0;
    runs[d][0][t] = ok && owner ? __ldg(st + klo) : 0;
    runs[d][1][t] = ok && owner ? __ldg(st + kmid) : 0;
    runs[d][2][t] = ok && owner ? __ldg(st + khi) : 0;
  }
  __syncthreads();
  // The chunk cursor: the next chunk is particles [begin, min(begin +
  // kChunk, hi of tap di)) of tap di's slice, di == ndi when the tile is
  // done. A chunk waits in registers (one particle a thread a row) from
  // its loads to its terms, a turn of the loop later: its loads are in
  // flight while the owners add the chunk before it.
  int di = 0, begin = slice[0][0];
  int cd = 0, first = 0, end = 0;  // the staged chunk: tap cd, [first, end)
  bool staged = false;
  float2 p[kPer];
  Coef<kOrder> ca[kPer], cb[kPer];
  const S zero = {};
  S acc = zero, s0 = zero, s1 = zero;
  int odi = 0;
  for (int buf = 0;; buf ^= 1) {
    S* const sl = slots + buf * 2 * kChunk;
    if (staged) {
      // the staged particles' terms at this column: dj = 0 at node j0
      // into sl[0, kChunk), dj = 1 at node j0 + 1 into sl[kChunk, 2 kChunk)
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int k = r * kThreads + t;
        if (first + k < end) {
          const float gx = p[r].x / h - ox;
          const float gy = p[r].y / h - oy;
          const float wx = hat(gx - fi);
          const float dx = kOrder == kFlip ? 0.0f : (fi - gx) * h;
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            const float fj = floorf(gy) + (float)dj;
            const float w = wx * hat(gy - fj);
            const float dy = kOrder == kFlip ? 0.0f : (fj - gy) * h;
            const float t0 = w * value<kOrder>(ca[r], dx, dy);
            const float t1 = kNch == 2 ? w * value<kOrder>(cb[r], dx, dy)
                                       : 0.0f;
            sl[dj * kChunk + k] = make_slot(t0, t1, w, zero);
          }
        }
      }
    }
    const bool had = staged;
    const int hd = cd, hfirst = first, hend = end;
    // the next chunk: the cursor past empty slices, then its loads
    while (di < ndi && begin >= slice[di][1]) {
      ++di;
      begin = di < ndi ? slice[di][0] : 0;
    }
    staged = di < ndi;
    if (staged) {
      cd = di;
      first = begin;
      end = min(begin + kChunk, slice[di][1]);
      begin += kChunk;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int g = first + r * kThreads + t;
        if (g < end) {
          p[r] = __ldg(pos + g);
          ca[r] = load_coef<kOrder>(colA, strA, g);
          if (kNch == 2) cb[r] = load_coef<kOrder>(colB, strB, g);
        }
      }
    }
    if (had) {
      __syncthreads();
      if (owner) {
        if (hd != odi) {
          // a new tap: the last one's runs go onto the total, dj = 0 first
          add(acc, s0);
          add(acc, s1);
          s0 = s1 = zero;
          odi = hd;
        }
        const int b0 = runs[hd][0][t], bm = runs[hd][1][t];
        const int b1 = runs[hd][2][t];
        add_run(sl + kChunk, max(b0, hfirst) - hfirst,
                min(bm, hend) - hfirst, s1);
        add_run(sl, max(bm, hfirst) - hfirst, min(b1, hend) - hfirst, s0);
      }
      // no second barrier: the next turn writes the other buffer, and the
      // turn after writes this one only past the next turn's barrier,
      // which every owner reaches after these adds
    }
    if (!staged) break;
  }
  if (!owner) return;
  add(acc, s0);
  add(acc, s1);
  if constexpr (kNch == 1) {
    outA[jj] = acc.x / (acc.y + 1e-4f);
  } else {
    const float weight = acc.z + 1e-4f;
    outA[jj] = acc.x / weight;
    outB[jj] = acc.y / weight;
  }
}

// blockIdx.x = 3 * tile + lattice (0: u, 1: v, 2: the cell lattice with
// rho and T); a lattice's tiles run column by column, so the clamp ring's
// columns start first on every lattice. At least kBlocksPerSM CTAs an SM:
// a budget of 102 registers, in which ptxas keeps every mode unspilled
// (left to itself it chose 56-80 and spilled)
template <int kOrder>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    p2g_splat_kernel(const float2* __restrict__ pos, Cols cols,
                     const int* __restrict__ starts, int ni, int nj, float h,
                     float* __restrict__ out) {
  __shared__ int slice[kMaxTaps][2], runs[kMaxTaps][3][kThreads];
  const int lat = blockIdx.x % 3;
  const int tile = blockIdx.x / 3;
  const int nx = lat == 0 ? ni + 1 : ni;
  const int ny = lat == 1 ? nj + 1 : nj;
  const int ntj = (ny + kTile - 1) / kTile;
  if (tile >= nx * ntj) return;
  const int ii = tile / ntj;
  const int J0 = (tile - ii * ntj) * kTile, J1 = min(J0 + kTile, ny);
  const int W = 2 * nj + 4;
  const unsigned nu = (unsigned)(ni + 1) * nj, nv = (unsigned)ni * (nj + 1);
  const unsigned nc = (unsigned)ni * nj;
  float* const col = out + (unsigned)ii * ny;   // the column's node 0
  if (lat < 2) {
    const bool u = lat == 0;
    splat_tile<kOrder, 1>(pos, u ? cols.col[0] : cols.col[1],
                          u ? cols.stride[0] : cols.stride[1], nullptr, 0,
                          starts, ni, W, ii, J0, J1, u ? 3 : 2, u ? 1 : 0,
                          u ? 0.0f : 0.5f, u ? 0.5f : 0.0f, h,
                          col + (u ? 0u : nu), nullptr, slice, runs);
  } else {
    splat_tile<kOrder, 2>(pos, cols.col[2], cols.stride[2], cols.col[3],
                          cols.stride[3], starts, ni, W, ii, J0, J1, 2, 1,
                          0.5f, 0.5f, h, col + nu + nv, col + nu + nv + nc,
                          slice, runs);
  }
}

constexpr int kSmem = 2 * 2 * kChunk * (int)sizeof(float4);

template <int kOrder>
int launch(unsigned blocks, const float2* p, const Cols& c, const int* s,
           int ni, int nj, float h, float* o, cudaStream_t st) {
  if (kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        p2g_splat_kernel<kOrder>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  p2g_splat_kernel<kOrder><<<blocks, kThreads, kSmem, st>>>(p, c, s, ni, nj,
                                                            h, o);
  return (int)cudaGetLastError();
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
  // tiles of the lattice with the most: u's or v's
  const long long tu = (long long)(ni + 1) * ((nj + kTile - 1) / kTile);
  const long long tv = (long long)ni * ((nj + kTile) / kTile);
  const long long blocks = 3 * (tu > tv ? tu : tv);
  if (blocks >= limit) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float2* p = (const float2*)pos;
  const int* s = (const int*)starts;
  float* o = (float*)out;
  if (order == kFlip)
    return launch<kFlip>((unsigned)blocks, p, c, s, ni, nj, h, o, st);
  if (order == kApic)
    return launch<kApic>((unsigned)blocks, p, c, s, ni, nj, h, o, st);
  return launch<kPolyPic>((unsigned)blocks, p, c, s, ni, nj, h, o, st);
}
