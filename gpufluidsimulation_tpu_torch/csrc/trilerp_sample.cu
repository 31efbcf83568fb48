// trilerp_sample: C stacked float32 fields sampled at one position lattice.
//
// Replaces the TPU kernels gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel (single field, pallas_call in _sample3_padded) and _kernel_multi
// (C stacked fields, pallas_call in _sample3_padded_multi), including their
// dual volume form (_trilerp_sum_dual). Computes, per output node and
// channel c with static offset off_c (units of h):
//   g = p / h - off_c
//   plain: trilerp(field_c, g)
//   dual:  0.5 * mean_{8 corners d in {+-1/4}^3} trilerp(field_c, g + d)
//          + 0.5 * trilerp(field_c, g)
// with clamped corner indices. The dual form equals
// gpufluidsimulation_tpu.bimocq.mapping._dual_gather_3d; the corners are
// summed in that function's _VOL3 order.
//
// What bounds it on the H100: bytes. Each output reads 3 position floats
// and writes C floats; the field is read once from device memory when
// positions stay near their lattice site (neighbouring threads gather
// neighbouring cells, and the reuse hits L1/L2). At 256^3 with C=1 that is
// about 5 x 67 MB, ~0.1 ms at 3.35 TB/s. The TPU kernel's windowed DMA,
// block origins and coverage renormalization existed to avoid scalar
// gathers on the TPU; on Hopper the gathers go through the cache, so the
// simple design is one thread per output node, k fastest so that a warp's
// position loads and output stores are coalesced, and all C channels
// sampled by the same thread so the position loads are shared.
#include "common.cuh"

namespace {

constexpr int kMaxC = 4;

struct Offsets {
  float o[kMaxC][3];
};

// _VOL3 corner order of gpufluidsimulation_tpu.bimocq.mapping
__constant__ float kVol3[8][3] = {
    {0.25f, 0.25f, 0.25f},  {0.25f, 0.25f, -0.25f},
    {0.25f, -0.25f, 0.25f}, {0.25f, -0.25f, -0.25f},
    {-0.25f, 0.25f, 0.25f}, {-0.25f, 0.25f, -0.25f},
    {-0.25f, -0.25f, 0.25f}, {-0.25f, -0.25f, -0.25f}};

__global__ void trilerp_sample_kernel(
    const float* __restrict__ fields, int C, int nx, int ny, int nz,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, int64_t n_out, float h, Offsets offs,
    int dual, float* __restrict__ out) {
  const int64_t field_size = (int64_t)nx * ny * nz;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n_out; idx += (int64_t)gridDim.x * blockDim.x) {
    const float x = px[idx] / h, y = py[idx] / h, z = pz[idx] / h;
    for (int c = 0; c < C; ++c) {
      const float* f = fields + c * field_size;
      const float gx = x - offs.o[c][0];
      const float gy = y - offs.o[c][1];
      const float gz = z - offs.o[c][2];
      const float center = gfs::trilerp_clamped(f, nx, ny, nz, gx, gy, gz);
      float res = center;
      if (dual) {
        float acc = gfs::trilerp_clamped(f, nx, ny, nz, gx + kVol3[0][0],
                                         gy + kVol3[0][1], gz + kVol3[0][2]);
        for (int q = 1; q < 8; ++q) {
          acc = acc + gfs::trilerp_clamped(f, nx, ny, nz, gx + kVol3[q][0],
                                           gy + kVol3[q][1],
                                           gz + kVol3[q][2]);
        }
        res = 0.5f * (acc / 8.0f) + 0.5f * center;
      }
      out[c * n_out + idx] = res;
    }
  }
}

}  // namespace

extern "C" int gfs_trilerp_sample(const void* fields, int C, int nx, int ny,
                                  int nz, const void* px, const void* py,
                                  const void* pz, long long n_out, float h,
                                  const float* offs_host, int dual, void* out,
                                  void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  Offsets offs;
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < 3; ++a) offs.o[c][a] = offs_host[3 * c + a];
  trilerp_sample_kernel<<<gfs::blocks_for(n_out), gfs::kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)fields, C, nx, ny, nz, (const float*)px,
      (const float*)py, (const float*)pz, (int64_t)n_out, h, offs, dual,
      (float*)out);
  return (int)cudaGetLastError();
}
