// rk3_substep: one Ralston RK3 substep of the characteristic trace.
//
// Replaces the TPU kernels gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel_rk3 / _kernel_rk3_twotier (pallas_call in _rk3_padded) and the
// identity-start peel _kernel_rk3_ident (pallas_call in _rk3_padded_ident).
// Positions are cell-lattice grid coordinates g = p/h, stacked (3, n).
// With the MAC velocity vel(g) sampled on the staggered u/v/w lattices:
//   k1 = vel(g); k2 = vel(g + a*k1); k3 = vel(g + b*k2)
//   g' = clamp(g + c1*k1 + c2*k2 + c3*k3, [lo, hi] per axis)
// where a = sh/2, b = 3sh/4, c1..c3 = (2/9, 3/9, 4/9)*sh and sh is the
// signed substep over h (advect.trace_rk3_3d in grid units, the fused
// kernels' arithmetic order). The identity peel launches this kernel on
// the lattice positions: stage 1 there is exactly the face average k1.
//
// What bounds it on the H100: bytes. Each node reads 3 position floats
// and writes 3; the velocity gathers (3 stages x 3 components x 8 corners)
// land within a cell or two of the node, so the velocity triplet is read
// about once through L1/L2. At 256^3 that is ~6 x 67 MB + 3 x 67 MB of
// velocity, ~0.18 ms at 3.35 TB/s. The TPU kernel fetched a padded window
// per block and evaluated hat-weighted taps because the TPU has no fast
// gather; the simple design here is one thread per node holding all three
// stages in registers, so no intermediate position touches device memory.
#include "common.cuh"

namespace {

__global__ void rk3_substep_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, int ni, int nj, int nk,
    const float* __restrict__ pos, int64_t n, float a, float b, float c1,
    float c2, float c3, float lox, float hix, float loy, float hiy,
    float loz, float hiz, float* __restrict__ out) {
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (int64_t)gridDim.x * blockDim.x) {
    const float gx = pos[idx], gy = pos[n + idx], gz = pos[2 * n + idx];
    float u1, v1, w1, u2, v2, w2, u3, v3, w3;
    gfs::mac_velocity(u, v, w, ni, nj, nk, gx, gy, gz, &u1, &v1, &w1);
    gfs::mac_velocity(u, v, w, ni, nj, nk, gx + a * u1, gy + a * v1,
                      gz + a * w1, &u2, &v2, &w2);
    gfs::mac_velocity(u, v, w, ni, nj, nk, gx + b * u2, gy + b * v2,
                      gz + b * w2, &u3, &v3, &w3);
    const float ox = gx + c1 * u1 + c2 * u2 + c3 * u3;
    const float oy = gy + c1 * v1 + c2 * v2 + c3 * v3;
    const float oz = gz + c1 * w1 + c2 * w2 + c3 * w3;
    out[idx] = fminf(fmaxf(ox, lox), hix);
    out[n + idx] = fminf(fmaxf(oy, loy), hiy);
    out[2 * n + idx] = fminf(fmaxf(oz, loz), hiz);
  }
}

}  // namespace

extern "C" int gfs_rk3_substep(const void* u, const void* v, const void* w,
                               int ni, int nj, int nk, const void* pos,
                               long long n, float a, float b, float c1,
                               float c2, float c3, const float* clamp_host,
                               void* out, void* stream) {
  rk3_substep_kernel<<<gfs::blocks_for(n), gfs::kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)w, ni, nj, nk,
      (const float*)pos, (int64_t)n, a, b, c1, c2, c3, clamp_host[0],
      clamp_host[1], clamp_host[2], clamp_host[3], clamp_host[4],
      clamp_host[5], (float*)out);
  return (int)cudaGetLastError();
}
