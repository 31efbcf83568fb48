// Shared device helpers of the port's kernels.
//
// trilerp_clamped is the exact clamped-index trilinear of
// gpufluidsimulation_tpu.core.interp.sample3 (and of the plain
// gpufluidsimulation_tpu_torch.core.interp.trilerp_grid): corner indices
// floor(g) and floor(g)+1 are clamped per axis to the field, and the blend
// runs x, then y, then z. The library is built with -fmad=false, so every
// product and sum below rounds as its PyTorch counterpart does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gfs {

constexpr int kThreads = 256;

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
