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
// adaptive hat loops over them; here one thread computes one (channel,
// node) output: it reads the map's three channels at the one or two
// lattice nodes its kind needs, averages and clips them in registers (no
// position array is written), and gathers its field's 8 corners through
// L1/L2, k fastest so that a warp's map reads and output writes are
// coalesced. Each channel's pointer and extent are kernel arguments, so
// the fields of different shapes are never copied to a common extent.
#include "common.cuh"

namespace {

constexpr int kMaxC = 4;

struct Channels {
  const float* f[kMaxC];
  int n[kMaxC][3];  // the field's extent
  int stag[kMaxC];  // its staggered axis, or -1
};

__global__ void pullback_sample_kernel(const float* __restrict__ maps, int ni,
                                       int nj, int nk, Channels ch, int C,
                                       int ex, int ey, int ez, float h,
                                       float lo, float hx, float hy, float hz,
                                       float* __restrict__ out) {
  const int64_t n_node = (int64_t)ex * ey * ez;
  const int64_t n = (int64_t)C * n_node;
  const int64_t map_size = (int64_t)ni * nj * nk;
  const float hi[3] = {hx, hy, hz};
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(idx % ez);
    int64_t t = idx / ez;
    const int j = (int)(t % ey);
    t /= ey;
    const int i = (int)(t % ex);
    const int c = (int)(t / ex);
    const int s = ch.stag[c];
    const int64_t at = gfs::clamped_offset(i, j, k, ni, nj, nk);
    const int64_t below = gfs::clamped_offset(i - (s == 0), j - (s == 1),
                                              k - (s == 2), ni, nj, nk);
    float g[3];
    for (int a = 0; a < 3; ++a) {
      const float* m = maps + a * map_size;
      float v = __ldg(m + at) / h;
      if (s >= 0) v = 0.5f * (__ldg(m + below) / h + v);
      g[a] = fminf(fmaxf(v, lo), hi[a]) + (s == a ? 0.5f : 0.0f);
    }
    out[idx] = gfs::trilerp_clamped(ch.f[c], ch.n[c][0], ch.n[c][1],
                                    ch.n[c][2], g[0], g[1], g[2]);
  }
}

}  // namespace

extern "C" int gfs_pullback_sample(const void* maps, int ni, int nj, int nk,
                                   const void* const* fields,
                                   const int* shapes, const int* stag, int C,
                                   int ex, int ey, int ez, float h, float lo,
                                   const float* hi, void* out, void* stream) {
  if (C < 1 || C > kMaxC || ex < 1 || ey < 1 || ez < 1)
    return (int)cudaErrorInvalidValue;
  Channels ch = {};
  for (int c = 0; c < C; ++c) {
    ch.f[c] = (const float*)fields[c];
    for (int a = 0; a < 3; ++a) ch.n[c][a] = shapes[3 * c + a];
    ch.stag[c] = stag[c];
  }
  const int64_t n = (int64_t)C * ex * ey * ez;
  pullback_sample_kernel<<<gfs::blocks_for(n), gfs::kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)maps, ni, nj, nk, ch, C, ex, ey, ez, h, lo, hi[0], hi[1],
      hi[2], (float*)out);
  return (int)cudaGetLastError();
}
