// dmc_substep: one backward-map DMC substep on the cell lattice.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel_dmc (pallas_call in _dmc_padded; entries dmc_substep_fast and
// dmc_substep_fast_carry). Per cell (i, j, k) in the interior band
// 2 <= idx <= n-3 (interior_mask('c', 2, 3)), else the old map is kept:
//   vel  = MAC face averages at the cell center
//   t    = the same averages at the diagonal upwind neighbour
//          (i - 1 where vel_u > 0 else i + 1, likewise in y and z)
//   disp = exponential DMC step in cells per axis
//          (advect.dmc_displacements_3d: du = vel - t, q = du*sgn*sh,
//           (1 - exp(-q)) * vel / (du*sgn) when |du| > 1e-4 h, else vel*sh)
//   map' = trilerp(map_c, (i, j, k) - disp) for the 3 map channels,
//          clamped corner indices.
// expf is the IEEE-accurate libdevice expf (no fast math).
//
// What bounds it on the H100: bytes. Each cell reads 3 map floats and
// writes 3, and reads the velocity triplet (centre and upwind faces, all
// within one cell); at 256^3 that is ~9 x 67 MB, ~0.18 ms at 3.35 TB/s.
// The TPU kernel DMAs static padded windows of the MAC pack and the maps
// per block; here one thread per cell gathers through L1/L2, with k
// fastest so the map loads and stores of a warp are coalesced.
#include "common.cuh"

namespace {

__device__ __forceinline__ float dmc_disp(float vel, float t, bool pos,
                                          float sh, float thresh) {
  const float sgn = pos ? 1.0f : -1.0f;
  const float du = vel - t;
  const float q = du * sgn * sh;
  const bool safe = fabsf(du) > thresh;
  const float denom = safe ? du * sgn : 1.0f;
  const float exp_disp = (1.0f - expf(-q)) * vel / denom;
  return safe ? exp_disp : vel * sh;
}

__global__ void dmc_substep_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, int ni, int nj, int nk,
    const float* __restrict__ maps, float sh, float thresh,
    float* __restrict__ out) {
  const int64_t n = (int64_t)ni * nj * nk;
  const int64_t su = (int64_t)nj * nk;            // u: (ni+1, nj, nk)
  const int64_t svx = (int64_t)(nj + 1) * nk;     // v: (ni, nj+1, nk)
  const int64_t swx = (int64_t)nj * (nk + 1);     // w: (ni, nj, nk+1)
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(idx % nk);
    const int j = (int)((idx / nk) % nj);
    const int i = (int)(idx / ((int64_t)nj * nk));
    const bool band = i >= 2 && i <= ni - 3 && j >= 2 && j <= nj - 3 &&
                      k >= 2 && k <= nk - 3;
    if (!band) {
      out[idx] = maps[idx];
      out[n + idx] = maps[n + idx];
      out[2 * n + idx] = maps[2 * n + idx];
      continue;
    }
    const float vu = 0.5f * (u[i * su + j * nk + k] + u[(i + 1) * su + j * nk + k]);
    const float vv = 0.5f * (v[i * svx + j * nk + k] + v[i * svx + (j + 1) * nk + k]);
    const float vw = 0.5f * (w[i * swx + j * (nk + 1) + k] + w[i * swx + j * (nk + 1) + k + 1]);
    const bool sx = vu > 0.0f, sy = vv > 0.0f, sz = vw > 0.0f;
    const int64_t ti = gfs::clampi(sx ? i - 1 : i + 1, 0, ni - 1);
    const int64_t tj = gfs::clampi(sy ? j - 1 : j + 1, 0, nj - 1);
    const int64_t tk = gfs::clampi(sz ? k - 1 : k + 1, 0, nk - 1);
    const float tu = 0.5f * (u[ti * su + tj * nk + tk] + u[(ti + 1) * su + tj * nk + tk]);
    const float tv = 0.5f * (v[ti * svx + tj * nk + tk] + v[ti * svx + (tj + 1) * nk + tk]);
    const float tw = 0.5f * (w[ti * swx + tj * (nk + 1) + tk] + w[ti * swx + tj * (nk + 1) + tk + 1]);
    const float gx = (float)i - dmc_disp(vu, tu, sx, sh, thresh);
    const float gy = (float)j - dmc_disp(vv, tv, sy, sh, thresh);
    const float gz = (float)k - dmc_disp(vw, tw, sz, sh, thresh);
    for (int c = 0; c < 3; ++c) {
      out[c * n + idx] =
          gfs::trilerp_clamped(maps + c * n, ni, nj, nk, gx, gy, gz);
    }
  }
}

}  // namespace

extern "C" int gfs_dmc_substep(const void* u, const void* v, const void* w,
                               int ni, int nj, int nk, const void* maps,
                               float sh, float thresh, void* out,
                               void* stream) {
  const int64_t n = (int64_t)ni * nj * nk;
  dmc_substep_kernel<<<gfs::blocks_for(n), gfs::kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)w, ni, nj, nk,
      (const float*)maps, sh, thresh, (float*)out);
  return (int)cudaGetLastError();
}
