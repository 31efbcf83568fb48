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
// (3, ni, nj, nk) world map on the cell lattice, clamp the per-axis world
// bounds [lo, hi], and f the channel's field sampled on its own lattice
// (grid coordinate M/h - off). The corners are added one by one in _VOL3
// order and every operation is the plain version's (vol9_exact_plain and
// core/interp.trilerp_grid), so the two agree to the bit under
// -fmad=false. Unflagged nodes and channels keep their dual value.
//
// What bounds it on the H100: at tol = 0 (every block flagged) the
// operations, per node 9 map samples (3 channels sharing one weight set)
// and 9 x C field samples (~21 GFLOP at 257x256x256, C=1, ~0.32 ms at
// 67 TFLOP/s) against ~0.34 GB of map and field reads and output writes
// (~0.10 ms). The TPU kernel fetched a ring-1 map window and a
// union-origin field window per flagged block, with branch codes for
// windows that do not fit; here there is no window to fit: one thread per
// output node, k fastest, gathers through L1/L2, an unflagged block's
// threads return after reading the flags, and nothing is compacted or
// synchronised with the host.
#include "common.cuh"

namespace {

constexpr int kMaxC = 4;

struct Params {
  float off[3];  // node and field lattice offset of the kind (units of h)
  float lo[3];   // world clamp of the mapped positions, per axis
  float hi[3];
};

// _VOL3 corner order of gpufluidsimulation_tpu.bimocq.mapping, then the
// centre
__constant__ float kVol9[9][3] = {
    {0.25f, 0.25f, 0.25f},  {0.25f, 0.25f, -0.25f},
    {0.25f, -0.25f, 0.25f}, {0.25f, -0.25f, -0.25f},
    {-0.25f, 0.25f, 0.25f}, {-0.25f, 0.25f, -0.25f},
    {-0.25f, -0.25f, 0.25f}, {-0.25f, -0.25f, -0.25f},
    {0.0f, 0.0f, 0.0f}};

__global__ void vol9_fixup_kernel(
    const float* __restrict__ maps, int ni, int nj, int nk,
    const float* __restrict__ fields, int C, int nx, int ny, int nz,
    const uint8_t* __restrict__ flags, int nb0, int nb1, int nb2, int bx,
    int by, int bz, float h, Params p, float* __restrict__ out) {
  const int64_t n_out = (int64_t)nx * ny * nz;
  const int64_t map_size = (int64_t)ni * nj * nk;
  const int64_t n_blocks = (int64_t)nb0 * nb1 * nb2;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n_out; idx += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(idx % nz);
    const int64_t t = idx / nz;
    const int j = (int)(t % ny);
    const int i = (int)(t / ny);
    const int bi = i / bx, bj = j / by, bk = k / bz;
    if (bi >= nb0 || bj >= nb1 || bk >= nb2) continue;
    const int64_t blk = ((int64_t)bi * nb1 + bj) * nb2 + bk;
    unsigned mask = 0;
    for (int c = 0; c < C; ++c)
      if (flags[c * n_blocks + blk]) mask |= 1u << c;
    if (mask == 0) continue;
    const float x0 = ((float)i + p.off[0]) * h;
    const float y0 = ((float)j + p.off[1]) * h;
    const float z0 = ((float)k + p.off[2]) * h;
    float acc[kMaxC], centre[kMaxC];
    for (int q = 0; q < 9; ++q) {
      const float gx = (x0 + kVol9[q][0] * h) / h;
      const float gy = (y0 + kVol9[q][1] * h) / h;
      const float gz = (z0 + kVol9[q][2] * h) / h;
      float m[3];
      for (int a = 0; a < 3; ++a) {
        const float v = gfs::trilerp_clamped(maps + a * map_size, ni, nj, nk,
                                             gx, gy, gz);
        m[a] = fminf(fmaxf(v, p.lo[a]), p.hi[a]);
      }
      const float fx = m[0] / h - p.off[0];
      const float fy = m[1] / h - p.off[1];
      const float fz = m[2] / h - p.off[2];
      for (int c = 0; c < C; ++c) {
        if (!(mask & (1u << c))) continue;
        const float v = gfs::trilerp_clamped(fields + c * n_out, nx, ny, nz,
                                             fx, fy, fz);
        if (q == 0) {
          acc[c] = v;
        } else if (q < 8) {
          acc[c] = acc[c] + v;
        } else {
          centre[c] = v;
        }
      }
    }
    for (int c = 0; c < C; ++c)
      if (mask & (1u << c))
        out[c * n_out + idx] = 0.5f * (acc[c] / 8.0f) + 0.5f * centre[c];
  }
}

}  // namespace

extern "C" int gfs_vol9_fixup(const void* maps, int ni, int nj, int nk,
                              const void* fields, int C, int nx, int ny,
                              int nz, const void* flags, int nb0, int nb1,
                              int nb2, int bx, int by, int bz, float h,
                              const float* params_host, void* out,
                              void* stream) {
  if (C < 1 || C > kMaxC || bx < 1 || by < 1 || bz < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int a = 0; a < 3; ++a) {
    p.off[a] = params_host[a];
    p.lo[a] = params_host[3 + a];
    p.hi[a] = params_host[6 + a];
  }
  const int64_t n_out = (int64_t)nx * ny * nz;
  vol9_fixup_kernel<<<gfs::blocks_for(n_out), gfs::kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)maps, ni, nj, nk, (const float*)fields, C, nx, ny, nz,
      (const uint8_t*)flags, nb0, nb1, nb2, bx, by, bz, h, p, (float*)out);
  return (int)cudaGetLastError();
}
