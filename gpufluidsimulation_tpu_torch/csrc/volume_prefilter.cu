// volume_prefilter: the separable volume prefilter of C stacked fields.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel_prefilter (pallas_call in _prefilter_padded; entry
// volume_prefilter_fast). Computes, per channel and node,
//   out = 0.5 * f + 0.5 * (S_x S_y S_z f),  S = [1/8, 3/4, 1/8],
// with edge-clamped indices: the z pass first, then y, then x, each pass
// (0.125 * lo + 0.75 * mid) + 0.125 * hi, as the plain version
// volume_prefilter_plain (and the JAX package's XLA form) orders them.
//
// What bounds it on the H100: bytes. The function reads each field once
// and writes each output once: 2 x 67 MB at 257x256x256, ~0.04 ms at
// 3.35 TB/s. The TPU kernel double-buffered a haloed window per block by
// DMA; here one thread computes one output from its 27 clamped
// neighbours, k fastest so that a warp's loads and stores are
// coalesced, and the neighbours' reuse across threads is served by L1/L2.
#include "common.cuh"

namespace {

__global__ void volume_prefilter_kernel(const float* __restrict__ f, int C,
                                        int nx, int ny, int nz,
                                        float* __restrict__ out) {
  const int64_t field_size = (int64_t)nx * ny * nz;
  const int64_t n = (int64_t)C * field_size;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(idx % nz);
    int64_t t = idx / nz;
    const int j = (int)(t % ny);
    t /= ny;
    const int i = (int)(t % nx);
    const float* base = f + (t / nx) * field_size;
    const int ii[3] = {i > 0 ? i - 1 : 0, i, i < nx - 1 ? i + 1 : nx - 1};
    const int jj[3] = {j > 0 ? j - 1 : 0, j, j < ny - 1 ? j + 1 : ny - 1};
    const int kk[3] = {k > 0 ? k - 1 : 0, k, k < nz - 1 ? k + 1 : nz - 1};
    float ty[3];
    for (int a = 0; a < 3; ++a) {
      float tz[3];
      for (int b = 0; b < 3; ++b) {
        const float* row = base + ((int64_t)ii[a] * ny + jj[b]) * nz;
        tz[b] = (0.125f * __ldg(row + kk[0]) + 0.75f * __ldg(row + kk[1])) +
                0.125f * __ldg(row + kk[2]);
      }
      ty[a] = (0.125f * tz[0] + 0.75f * tz[1]) + 0.125f * tz[2];
    }
    const float tx = (0.125f * ty[0] + 0.75f * ty[1]) + 0.125f * ty[2];
    out[idx] = 0.5f * __ldg(base + ((int64_t)i * ny + j) * nz + k) + 0.5f * tx;
  }
}

}  // namespace

extern "C" int gfs_volume_prefilter(const void* fields, int C, int nx, int ny,
                                    int nz, void* out, void* stream) {
  if (C < 1 || nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)C * nx * ny * nz;
  volume_prefilter_kernel<<<gfs::blocks_for(n), gfs::kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)fields, C, nx, ny, nz, (float*)out);
  return (int)cudaGetLastError();
}
