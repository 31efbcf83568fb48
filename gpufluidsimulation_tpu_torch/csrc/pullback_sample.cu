// pullback_sample: C fields of mixed lattice kinds pulled back through one
// map in one launch.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel_pullback (pallas_call in _pullback_padded; entry
// sample3_pullback). For every node (i, j, k) of the output extent and
// every channel c, whose kind is staggered along axis s = stag[c] (-1 for
// the cell lattice), it computes in grid units, per map channel a:
//   m_a = maps[a] / h at the node, or 0.5 * (maps[a] / h at the node one
//         lower along s + maps[a] / h at the node), map indices clamped to
//         the map's (ni, nj, nk);
//   p_a = min(max(m_a, lo), hi_a), hi_a = n_a - clamp_hi;
// and writes trilerp(field_c, p + 0.5 e_s), the field's corner indices
// clamped to its own extent. This is the plain version
// pullback_sample_plain operation for operation, so the two agree to the
// bit under -fmad=false.
//
// What bounds it on the H100: bytes. At 256^3 for the velocity triplet the
// function reads the map (3 x 67 MB) and the three face fields (3 x 67 MB)
// once and writes 3 x 67 MB, ~0.18 ms at 3.35 TB/s, against ~50 float32
// operations per output (~0.04 ms at 67 TFLOP/s). The TPU kernel fetched a
// map window and a union-origin field window per block by DMA and summed
// adaptive hat loops over them. The first port here ran one thread per
// (channel, node) in a grid-stride loop: six 64-bit divisions and
// remainders to recover (c, i, j, k), the map's three channels loaded and
// divided by h again for every channel (18 loads and divisions a node for
// u, v, w, where 12 distinct values would do), and a clamped trilerp with
// its own floors and 64-bit offsets per channel: ~5x its bound, held by
// instruction issue.
//
// The design here: one thread per node on 32 x 2 x 2 (k, j, i) blocks of
// the output extent, k fastest, over all channels, no integer division.
// The node's three map values are loaded and divided by h once; each
// staggered axis among the channels loads and divides the three values
// one node lower along it once, for its kind's average. The wrapper orders
// the channels so that those of one kind are adjacent (slot[] maps them
// back to their output channels): a kind forms its positions, floors,
// fractions and clamped corner nodes once, on its own field's extent, and
// each of its channels samples from them (rho+T: one set), the z corners
// loaded as a pair (gfs::zpair and gfs::trilerp_zpair, which need n >= 2
// along z: the wrapper raises). Each channel's output is written
// k-fastest, so that a warp's stores coalesce. Offsets are unsigned 32-bit
// (the wrapper raises unless the map, each field and C times the extent
// hold fewer than 2^31 values). Each field's pointer and extent are kernel
// arguments, so fields of different shapes are never copied to a common
// extent.
//
// Measured (scripts/kernel_variants.py, H100, 256^3, clamp (1, 1), the
// first port timed in the same rounds): u, v, w 0.879 -> 0.431 ms, 2.4x
// the bound; rho+T 0.517 -> 0.241. A thread a (channel, node) took 0.637,
// the k below-node by a warp shuffle 0.495, the map staged in shared
// memory (each value divided once a block) 0.487; the 12 IEEE divisions
// a node are ~14% of the time (PERF.md, row 7).
#include "common.cuh"

namespace {

constexpr int kMaxC = 4;
// A block covers 32 x 2 x 2 nodes (k, j, i): 2.6% faster than 32 x 4 x 1
// for u, v, w (scripts/kernel_variants.py), the same for rho+T
constexpr int kBlockK = 32, kBlockJ = 2, kBlockI = 2;

using gfs::Coord;
using gfs::coord;
using gfs::ZPair;
using gfs::zpair;

// The channels in the wrapper's order: those of one kind adjacent.
struct Channels {
  const float* f[kMaxC];
  int n[kMaxC][3];  // the field's extent
  int stag[kMaxC];  // its staggered axis, or -1
  int slot[kMaxC];  // its channel in the output
};

__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI)
    pullback_sample_kernel(const float* __restrict__ maps, int ni, int nj,
                           int nk, Channels ch, int C, int ex, int ey, int ez,
                           float h, float lo, float hx, float hy, float hz,
                           float* __restrict__ out) {
  const int k = blockIdx.x * kBlockK + threadIdx.x;
  const int j = blockIdx.y * kBlockJ + threadIdx.y;
  const int i = blockIdx.z * kBlockI + threadIdx.z;
  if (k >= ez || j >= ey || i >= ex) return;
  const unsigned n_node = (unsigned)ex * ey * ez;
  const unsigned idx = ((unsigned)i * ey + j) * ez + k;
  const unsigned sj = nk, si = (unsigned)nj * nk, map_size = si * ni;
  // the node, clamped to the map, and its map values in grid units
  const int ci = min(i, ni - 1), cj = min(j, nj - 1), ck = min(k, nk - 1);
  const unsigned at = ci * si + cj * sj + ck;
  float m[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) m[a] = __ldg(maps + (a * map_size + at)) / h;
  const float hi[3] = {hx, hy, hz};
  Coord cx, cy;
  ZPair cz;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= C) break;
    const int s = ch.stag[c];
    if (c == 0 || s != ch.stag[c - 1]) {
      // this kind's position: the node's map value, averaged with the
      // node one lower along s (clamped: at index 0 the node itself)
      float g[3] = {m[0], m[1], m[2]};
      if (s >= 0) {
        const int bi = max(min(i - (s == 0), ni - 1), 0);
        const int bj = max(min(j - (s == 1), nj - 1), 0);
        const int bk = max(min(k - (s == 2), nk - 1), 0);
        const unsigned below = bi * si + bj * sj + bk;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          g[a] = 0.5f * (__ldg(maps + (a * map_size + below)) / h + g[a]);
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

}  // namespace

// fields, shapes, stag and slot in the kernel's channel order (those of
// one kind adjacent); slot[c] is the output channel of channel c.
extern "C" int gfs_pullback_sample(const void* maps, int ni, int nj, int nk,
                                   const void* const* fields,
                                   const int* shapes, const int* stag,
                                   const int* slot, int C, int ex, int ey,
                                   int ez, float h, float lo, const float* hi,
                                   void* out, void* stream) {
  const long long limit = 1LL << 31;
  if (C < 1 || C > kMaxC || ex < 1 || ey < 1 || ez < 1 ||
      3LL * ni * nj * nk >= limit || (long long)C * ex * ey * ez >= limit)
    return (int)cudaErrorInvalidValue;
  Channels ch = {};
  for (int c = 0; c < C; ++c) {
    ch.f[c] = (const float*)fields[c];
    for (int a = 0; a < 3; ++a) ch.n[c][a] = shapes[3 * c + a];
    if (ch.n[c][2] < 2 || (long long)ch.n[c][0] * ch.n[c][1] * ch.n[c][2] >=
                              limit)
      return (int)cudaErrorInvalidValue;
    ch.stag[c] = stag[c];
    ch.slot[c] = slot[c];
  }
  const dim3 block(kBlockK, kBlockJ, kBlockI);
  const dim3 grid((ez + kBlockK - 1) / kBlockK, (ey + kBlockJ - 1) / kBlockJ,
                  (ex + kBlockI - 1) / kBlockI);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  pullback_sample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)maps, ni, nj, nk, ch, C, ex, ey, ez, h, lo, hi[0], hi[1],
      hi[2], (float*)out);
  return (int)cudaGetLastError();
}
