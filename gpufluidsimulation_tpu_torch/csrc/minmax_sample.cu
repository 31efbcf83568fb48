// minmax_sample: min and max of the 8 trilinear corner values of C stacked
// float32 fields at one position lattice.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel_minmax (pallas_call in _minmax3_padded, entry minmax3_fast), the
// MacCormack scalar trace clamp. Computes, per output node and channel c
// with static offset off_c (units of h):
//   g = p / h - off_c,  i0 = floor(g) per axis,
//   corners (i0|i0+1, j0|j0+1, k0|k0+1), each index clamped to [0, n-1],
//   mn = min over the 8 corner values, mx = max over them
// which is the exact-gather clamp of gpufluidsimulation_tpu.ops.advect
// maccormack_multi_3d (interp._gather8_3d, then min/max over the corners).
// The TPU kernel drops a corner whose hat weight rounds to 0; this kernel,
// like the exact gathers, always takes all 8.
//
// What bounds it on the H100: bytes. Each output node reads 3 position
// floats and writes 2*C floats; the field's corner reads hit L1/L2 when
// positions stay near their lattice site. At 256^3 with C=2 that is about
// 7 x 67 MB + the 2 x 67 MB fields, ~0.18 ms at 3.35 TB/s. As in
// trilerp_sample, one thread per output node, k fastest so that a warp's
// position loads and output stores are coalesced, and all C channels in
// the thread's loop so rho and T share one read of the positions.
#include "common.cuh"

namespace {

constexpr int kMaxC = 4;

struct Offsets {
  float o[kMaxC][3];
};

__global__ void minmax_sample_kernel(
    const float* __restrict__ fields, int C, int nx, int ny, int nz,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, int64_t n_out, float h, Offsets offs,
    float* __restrict__ mn_out, float* __restrict__ mx_out) {
  const int64_t field_size = (int64_t)nx * ny * nz;
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n_out; idx += (int64_t)gridDim.x * blockDim.x) {
    const float x = px[idx] / h, y = py[idx] / h, z = pz[idx] / h;
    for (int c = 0; c < C; ++c) {
      const float* f = fields + c * field_size;
      const int i0 = (int)floorf(x - offs.o[c][0]);
      const int j0 = (int)floorf(y - offs.o[c][1]);
      const int k0 = (int)floorf(z - offs.o[c][2]);
      const int64_t ia = gfs::clampi(i0, 0, nx - 1);
      const int64_t ib = gfs::clampi(i0 + 1, 0, nx - 1);
      const int64_t ja = gfs::clampi(j0, 0, ny - 1);
      const int64_t jb = gfs::clampi(j0 + 1, 0, ny - 1);
      const int64_t ka = gfs::clampi(k0, 0, nz - 1);
      const int64_t kb = gfs::clampi(k0 + 1, 0, nz - 1);
      // corner order of interp._gather8_3d; min and max are exact in any
      // order for finite values
      const float v[8] = {
          __ldg(f + ia * sx + ja * sy + ka), __ldg(f + ib * sx + ja * sy + ka),
          __ldg(f + ia * sx + jb * sy + ka), __ldg(f + ib * sx + jb * sy + ka),
          __ldg(f + ia * sx + ja * sy + kb), __ldg(f + ib * sx + ja * sy + kb),
          __ldg(f + ia * sx + jb * sy + kb), __ldg(f + ib * sx + jb * sy + kb)};
      float lo = v[0], hi = v[0];
#pragma unroll
      for (int q = 1; q < 8; ++q) {
        lo = fminf(lo, v[q]);
        hi = fmaxf(hi, v[q]);
      }
      mn_out[c * n_out + idx] = lo;
      mx_out[c * n_out + idx] = hi;
    }
  }
}

}  // namespace

extern "C" int gfs_minmax_sample(const void* fields, int C, int nx, int ny,
                                 int nz, const void* px, const void* py,
                                 const void* pz, long long n_out, float h,
                                 const float* offs_host, void* mn, void* mx,
                                 void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  Offsets offs;
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < 3; ++a) offs.o[c][a] = offs_host[3 * c + a];
  minmax_sample_kernel<<<gfs::blocks_for(n_out), gfs::kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)fields, C, nx, ny, nz, (const float*)px,
      (const float*)py, (const float*)pz, (int64_t)n_out, h, offs,
      (float*)mn, (float*)mx);
  return (int)cudaGetLastError();
}
