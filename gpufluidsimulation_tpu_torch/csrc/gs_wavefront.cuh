// The 2.5D wavefront of the two red-black Gauss-Seidel smoothers,
// rbgs_smooth.cu (the plain operator) and masked_rbgs_smooth.cu (the masked
// one). One launch runs L colour levels (half-sweeps) of a smoother call.
//
// Levels. Level 0 is the input x (zero where x is null; on the masked
// operator where(fluid, x, 0)). Level t (t = 1..L) updates the cells of
// colour c_t = first ^ ((t - 1) & 1), colour = (i + j + k) & 1 in global
// indices, from level t-1:
//   nb = ((((((0 + x[i+1]) + x[i-1]) + x[j+1]) + x[j-1]) + x[k+1]) + x[k-1])
//   x  = (nb + b) / diag
// and copies level t-1 everywhere else. Neighbours outside the array are
// zero ghosts: cells outside the array hold 0 at every level, as do the
// non-fluid cells of the masked operator. Level L is written out of place.
//
// Schedule. A block of kWarpsJ warps owns a kRegionJ x kRegionK region of
// the (j, k) plane, k fastest, and marches one segment [i0, i1) of i. A
// lane owns the column pair (2l, 2l + 1) of kRowsPerThread rows. At step m
// it takes plane m of level 0 and computes level t at plane m - t from
// level t-1's planes m-t+1 (this step's, registers), m-t-1 (registers) and
// m-t (one shared-memory plane per level, for the j and k neighbours).
// Since the colour of level t alternates with t and so does the parity of
// plane m - t, a column updates at every level of a step or at none: the
// pair element ((m + j) & 1) ^ first ^ 1 (k0 is even), the same for all the
// rows of a thread (kWarpsJ is even). So every lane makes one update a
// level, no lane idles on the other colour, and the element is a
// compile-time constant of each step: the steps run in fours, unrolled,
// the element alternating from the segment's first, so that no operand is
// selected at run time and the shifts of the register rings become
// renamings. The shared planes are double-buffered (a step reads one
// buffer and writes the other), one barrier a step. A cell at level t is
// stale within t cells of the region's edge or t planes of the loaded
// range; no stale cell reaches the output, since the segment is loaded
// from L planes before it to L planes after it and only the region's
// central (kRegionJ - 2L) x (kRegionK - 2L) columns are written. Stale
// rows are not updated, nor are the region's edge columns. Parity comes
// from the block coordinates and the step, offsets are unsigned 32-bit,
// and no index is divided.
//
// Masked operator. Each plane's flags are read once (one byte a cell). A
// cell's fluid bit and its count of fluid-or-air neighbours (outside the
// array counts as solid) are formed once, packed into one register a row
// for the L planes in flight, and kept for every level: 3 bits of count
// per element and plane, diag = max(count, 1). The open (fluid-or-air)
// bits of the plane before travel to the neighbours through one byte
// plane in shared memory. Region-edge cells are held, so their diagonal,
// which would need flags beyond the region, is never formed.
//
// Every level is bit-identical to the plain half-sweep: the same operands
// in the same order, a true division, built with -fmad=false.
//
// Measured (scripts/kernel_variants.py, H100, 2-sweep call at 256^3 and
// 32^3): 4 levels a launch against 2, region shapes, warps and rows a
// thread, the segment rule, a register cap for 2 blocks an SM, branch-free
// updates, a table reciprocal with one remainder correction in place of the
// division and, masked, the diagonal recounted at every level; none beats
// the shipped choices by more than a few percent (PERF.md, rows 10, 12).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gs {

constexpr int kPairs = 32;               // column pairs (k): one a lane
constexpr int kRegionK = 2 * kPairs;     // region columns (k)
constexpr int kRegionJ = 32;             // region rows (j)
constexpr int kWarpsJ = 16;              // warps along j
constexpr int kRowsPerThread = kRegionJ / kWarpsJ;
constexpr int kThreads = 32 * kWarpsJ;
// resident blocks an SM the register allocation must allow (stated, so
// that ptxas may use up to 128 registers a thread and no level count spills)
constexpr int kMinBlocks = 1;
// colour levels a launch: stencil_kernels.LEVELS_PER_LAUNCH
constexpr int kLevels = 4;
// blocks per resident block slot of the card
constexpr int kWaves = 1;

// The operator: the plain one with Dirichlet (diag 6) or Neumann (diag the
// in-domain neighbours) walls, or the masked one (diag from the flags).
enum Op { kDirichlet, kNeumann, kMasked };

// a[off], or 0 where the cell is outside the array (no load)
__device__ __forceinline__ float load(const float* __restrict__ a,
                                      unsigned off, bool ok) {
  return ok ? __ldg(a + off) : 0.0f;
}

// the flag at off, or solid (2) outside the array
__device__ __forceinline__ unsigned load_flag(const uint8_t* __restrict__ f,
                                              unsigned off, bool ok) {
  return ok ? (unsigned)__ldg(f + off) : 2u;
}

template <int E>
using Elem = std::integral_constant<int, E>;

template <int L, Op kOp>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
levels_kernel(const float* __restrict__ x, const float* __restrict__ b,
              const uint8_t* __restrict__ flags, int nx, int ny, int nz,
              int first, int seg_len, float* __restrict__ out) {
  static_assert(L % 2 == 0, "k0 must stay even: an even number of levels");
  static_assert(kWarpsJ % 2 == 0, "a thread's rows must share j's parity");
  constexpr bool kMask = kOp == kMasked;
  constexpr int RJ = kRegionJ, RP = kPairs, RK = kRegionK;
  constexpr int TJ = RJ - 2 * L, TK = RK - 2 * L;  // written rows, columns
  constexpr int Q = kRowsPerThread;
  constexpr int ROW = 2 * RP;   // a shared row: even columns, then odd ones
  constexpr int PLANE = (RJ + 2) * ROW;
  // two buffers (read at even and odd steps) of level t's plane m-t-1
  // (t < L), each [L][RJ + 2][2][RP] (a pad row before and after the
  // region's rows); the masked operator's open bits of plane m-1 as two
  // buffers of [RJ + 2][2][RP] bytes after them
  extern __shared__ float smem[];
  uint8_t* const open_sh = reinterpret_cast<uint8_t*>(smem + 2 * L * PLANE);
  const int k0 = blockIdx.x * TK - L;
  const int j0 = blockIdx.y * TJ - L;
  const int i0 = blockIdx.z * seg_len;
  const int i1 = min(i0 + seg_len, nx);
  const unsigned ps = (unsigned)ny * (unsigned)nz;
  const int lp = threadIdx.x;

  // the thread's rows q (region row jr[q]) and elements e = 0, 1 (region
  // column 2 lp + e); bit 2q + e of inb: inside the array, of updb: inside
  // and not on the region's edge columns, of wrb: written out. rows[q]:
  // bit t set where level t computes the row (not within t of the edge).
  int jr[Q], cjk[Q][2];
  unsigned col[Q], rows[Q], inb = 0u, updb = 0u, wrb = 0u;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    jr[q] = threadIdx.y + kWarpsJ * q;
    const int j = j0 + jr[q];
    col[q] = (unsigned)j * (unsigned)nz + (unsigned)(k0 + 2 * lp);
    rows[q] = 0u;
#pragma unroll
    for (int t = 1; t <= L; ++t)
      rows[q] |= (jr[q] >= t && jr[q] < RJ - t ? 1u : 0u) << t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kc = 2 * lp + e, k = k0 + kc;
      const bool in = j >= 0 && j < ny && k >= 0 && k < nz;
      inb |= (in ? 1u : 0u) << (2 * q + e);
      updb |= (in && kc > 0 && kc < RK - 1 ? 1u : 0u) << (2 * q + e);
      wrb |= (jr[q] >= L && jr[q] < L + TJ && j < ny && kc >= L &&
                      kc < L + TK && k < nz
                  ? 1u
                  : 0u)
             << (2 * q + e);
      // Neumann: in-domain neighbours along j and k
      cjk[q][e] = (j > 0) + (j < ny - 1) + (k > 0) + (k < nz - 1);
    }
  }
  {
    const int words = 2 * L * PLANE + (kMask ? PLANE / 2 : 0);
    for (int w = threadIdx.y * 32 + threadIdx.x; w < words; w += kThreads)
      smem[w] = 0.0f;
  }
  // level t of the own pair: cur[t] at plane m-t-1, prv[t] the element
  // active at step m of plane m-t-2. bq[t]: b at plane m-t-1, read once and
  // kept for the levels that use it. xn, bn (and the flags fn): x at plane
  // m and b at plane m-1, loaded one step ahead. Masked: fl holds the fluid
  // bits of planes m .. m-L (2 bits a plane), opn the open bits of planes
  // m, m-1, m-2, cnt the open-neighbour counts of planes m-1 .. m-L (6 bits
  // a plane, 3 an element).
  float2 cur[L][Q], bq[L][Q], xn[Q], bn[Q];
  float prv[L][Q];
  unsigned fn[Q], fl[Q], opn[Q], cnt[Q];
  auto load2 = [&](const float* a, int q, int i) {
    const bool ok = a != nullptr && (unsigned)i < (unsigned)nx;
    const unsigned off = col[q] + (unsigned)i * ps;
    return make_float2(load(a, off, ok && ((inb >> (2 * q)) & 1u)),
                       load(a, off + 1u, ok && ((inb >> (2 * q + 1)) & 1u)));
  };
  auto load_flags = [&](int q, int i) {
    const bool ok = (unsigned)i < (unsigned)nx;
    const unsigned off = col[q] + (unsigned)i * ps;
    return load_flag(flags, off, ok && ((inb >> (2 * q)) & 1u)) |
           (load_flag(flags, off + 1u, ok && ((inb >> (2 * q + 1)) & 1u))
            << 8);
  };
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      cur[t][q] = bq[t][q] = make_float2(0.0f, 0.0f);
      prv[t][q] = 0.0f;
    }
    xn[q] = load2(x, q, i0 - L);
    bn[q] = load2(b, q, i0 - L - 1);
    fl[q] = opn[q] = cnt[q] = 0u;
    fn[q] = kMask ? load_flags(q, i0 - L) : 0u;
  }
  __syncthreads();

  // One step m: element E of every pair is active (the rows of a thread
  // share j's parity), shared buffer S is read and 1 - S written.
  auto step = [&](int m, auto elem, auto buf) {
    constexpr int e = decltype(elem)::value, S = decltype(buf)::value;
    const float* rd = smem + S * L * PLANE;
    float* wt = smem + (1 - S) * L * PLANE;
    // levels whose plane m - t lies in the array
    unsigned planes = 0u;
#pragma unroll
    for (int t = 1; t <= L; ++t)
      planes |= ((unsigned)(m - t) < (unsigned)nx ? 1u : 0u) << t;
    float2 nw[L + 1][Q];        // level t at plane m-t
    unsigned ok[Q];             // bit t: level t updates the active element
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      ok[q] = (updb >> (2 * q + e)) & 1u ? rows[q] & planes : 0u;
      if (kMask) {
        const unsigned f0 = fn[q] & 0xffu, f1 = fn[q] >> 8;
        const unsigned fluid = (f0 == 0u) | ((f1 == 0u) << 1);
        const unsigned open = (f0 <= 1u) | ((f1 <= 1u) << 1);
        fl[q] = (fl[q] << 2) | fluid;
        opn[q] = ((opn[q] << 2) | open) & 0x3fu;
        fn[q] = load_flags(q, m + 1);
        nw[0][q] = make_float2(fluid & 1u ? xn[q].x : 0.0f,
                               fluid & 2u ? xn[q].y : 0.0f);
        // plane m-1's counts: i+1 from plane m, i-1 from plane m-2, j and
        // k from plane m-1's open bits in shared memory and the own pair
        const uint8_t* o = open_sh + S * PLANE + (jr[q] + 1) * ROW + lp;
        const unsigned o1 = opn[q] >> 2;
        const unsigned c0 = (opn[q] & 1u) + ((opn[q] >> 4) & 1u) + o[ROW] +
                            o[-ROW] + ((o1 >> 1) & 1u) + o[RP - 1];
        const unsigned c1 = ((opn[q] >> 1) & 1u) + ((opn[q] >> 5) & 1u) +
                            o[ROW + RP] + o[RP - ROW] + o[1] + (o1 & 1u);
        cnt[q] = ((cnt[q] << 6) | c0 | (c1 << 3)) & ((1u << (6 * L)) - 1u);
      } else {
        nw[0][q] = xn[q];
      }
#pragma unroll
      for (int t = L - 1; t > 0; --t) bq[t][q] = bq[t - 1][q];
      bq[0][q] = bn[q];
      xn[q] = load2(x, q, m + 1);
      bn[q] = load2(b, q, m);
    }
#pragma unroll
    for (int t = 1; t <= L; ++t) {
      const int i = m - t;
      const int ci = (i > 0) + (i < nx - 1);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        // the update of the active element where ok: rows within t-1 of the
        // region's edge are stale, the region's edge columns and the cells
        // outside the array (and non-fluid cells) are held
        bool u = (ok[q] >> t) & 1u;
        if (kMask) u = u && ((fl[q] >> (2 * t + e)) & 1u);
        float2 v = cur[t - 1][q];
        if (u) {
          const float* c =
              rd + (t - 1) * PLANE + (jr[q] + 1) * ROW + lp + e * RP;
          float nb = 0.0f;
          nb = nb + (e ? nw[t - 1][q].y : nw[t - 1][q].x);  // x[i+1]
          nb = nb + prv[t - 1][q];                           // x[i-1]
          nb = nb + c[ROW];                                  // x[j+1]
          nb = nb + c[-ROW];                                 // x[j-1]
          nb = nb + (e ? c[1 - RP] : c[RP]);                 // x[k+1]
          nb = nb + (e ? c[-RP] : c[RP - 1]);                // x[k-1]
          int d;
          if (kOp == kMasked)
            d = max((int)((cnt[q] >> (6 * (t - 1) + 3 * e)) & 7u), 1);
          else if (kOp == kNeumann)
            d = ci + cjk[q][e];
          else
            d = 6;
          const float res =
              (nb + (e ? bq[t - 1][q].y : bq[t - 1][q].x)) / (float)d;
          if (e)
            v.y = res;
          else
            v.x = res;
        }
        nw[t][q] = v;
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int t = 0; t < L; ++t) {
        // the element active at step m+1 is the other one
        prv[t][q] = e ? cur[t][q].x : cur[t][q].y;
        cur[t][q] = nw[t][q];
        float* p = wt + t * PLANE + (jr[q] + 1) * ROW + lp;
        p[0] = nw[t][q].x;
        p[RP] = nw[t][q].y;
      }
      if (kMask) {
        uint8_t* o = open_sh + (1 - S) * PLANE + (jr[q] + 1) * ROW + lp;
        o[0] = (uint8_t)(opn[q] & 1u);
        o[RP] = (uint8_t)((opn[q] >> 1) & 1u);
      }
    }
    const int io = m - L;
    if (io >= i0 && io < i1) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const unsigned off = col[q] + (unsigned)io * ps;
        if ((wrb >> (2 * q)) & 1u) out[off] = nw[L][q].x;
        if ((wrb >> (2 * q + 1)) & 1u) out[off + 1u] = nw[L][q].y;
      }
    }
    __syncthreads();
  };

  // steps in fours (a segment's last steps past i1 + L write nothing): the
  // active element alternates from e0 and the shared buffers with the step
  const bool e0 = (((i0 - L + j0 + (int)threadIdx.y) & 1) ^ first ^ 1) != 0;
  for (int m = i0 - L; m < i1 + L; m += 4) {
    if (e0) {
      step(m, Elem<1>(), Elem<0>());
      step(m + 1, Elem<0>(), Elem<1>());
      step(m + 2, Elem<1>(), Elem<0>());
      step(m + 3, Elem<0>(), Elem<1>());
    } else {
      step(m, Elem<0>(), Elem<0>());
      step(m + 1, Elem<1>(), Elem<1>());
      step(m + 2, Elem<0>(), Elem<0>());
      step(m + 3, Elem<1>(), Elem<1>());
    }
  }
}

template <int L, Op kOp>
size_t shared_bytes() {
  return 2 * ((size_t)L * (kRegionJ + 2) * kRegionK * sizeof(float) +
              (kOp == kMasked ? (size_t)(kRegionJ + 2) * kRegionK : 0));
}

template <int L, Op kOp>
int launch(const float* x, const float* b, const uint8_t* flags, int nx,
           int ny, int nz, int first, float* out, cudaStream_t stream) {
  constexpr int TJ = kRegionJ - 2 * L, TK = kRegionK - 2 * L;
  const size_t smem = shared_bytes<L, kOp>();
  // segments of i: as many blocks as fill the card kWaves times over, each
  // segment at least L planes long (small levels get several segments)
  static int resident = 0;
  if (resident == 0) {
    // more than 48 KB of dynamic shared memory needs the opt-in; reading
    // the kernel's attributes first loads its module under lazy loading
    const void* fn = (const void*)levels_kernel<L, kOp>;
    cudaFuncAttributes attrs;
    cudaError_t err = cudaFuncGetAttributes(&attrs, fn);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, levels_kernel<L, kOp>, kThreads, smem);
    resident = max(1, sms * per_sm);
  }
  const int tiles = ((nz + TK - 1) / TK) * ((ny + TJ - 1) / TJ);
  int segs = max(1, kWaves * resident / tiles);
  segs = min(segs, max(1, nx / L));
  const int seg_len = (nx + segs - 1) / segs;
  segs = (nx + seg_len - 1) / seg_len;
  const dim3 grid((nz + TK - 1) / TK, (ny + TJ - 1) / TJ, segs);
  levels_kernel<L, kOp><<<grid, dim3(32, kWarpsJ), smem, stream>>>(
      x, b, flags, nx, ny, nz, first, seg_len, out);
  return (int)cudaGetLastError();
}

// Arguments the kernels take: at least one cell, fewer than 2^31 (32-bit
// offsets), a colour of 0 or 1.
inline bool valid(int nx, int ny, int nz, int first) {
  return nx >= 1 && ny >= 1 && nz >= 1 &&
         (long long)nx * ny * nz < (1LL << 31) && (first == 0 || first == 1);
}

}  // namespace gs
