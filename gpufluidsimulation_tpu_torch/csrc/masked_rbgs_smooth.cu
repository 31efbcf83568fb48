// masked_rbgs_smooth: red-black Gauss-Seidel half-sweeps on the masked
// (voxel-boundary) pressure operator.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/pallas_kernels.py
// _masked_rbgs_kernel (pallas_call in _masked_rbgs_launch, entry
// masked_rbgs_smooth). Cell flags: 0 fluid, 1 air (p = 0 ghost), 2 domain
// solid, 3 moving solid; outside the field counts as solid. Only fluid
// cells update; every other cell holds 0. Because of that the sum over
// fluid neighbours is the plain 6-point sum with zero ghosts
//   nb = ((((((0 + x[i+1]) + x[i-1]) + x[j+1]) + x[j-1]) + x[k+1]) + x[k-1])
// and only the diagonal needs the flags:
//   diag = max(number of fluid-or-air neighbours, 1),  x = (nb + b) / diag
// with a true division. Red is (i+j+k) even; one launch updates one colour.
//   gfs_masked_rbgs_first  the first half-sweep of a call, out of place:
//                   non-fluid cells are written 0, fluid cells of the other
//                   colour are copied, fluid cells of `colour` are updated
//                   from x_in with its non-fluid neighbours read as 0 (the
//                   caller's x may be nonzero there, e.g. after a
//                   prolongation). x_in == nullptr means x is exactly zero.
//   gfs_masked_rbgs_half   every later half-sweep, in place on the output.
//
// What bounds it on the H100: bytes. A full sweep must read x, b and the
// flags and write x. The flags are one byte a cell here (the TPU kernel
// moved them as float32 windows), 13 bytes a cell, 218 MB at 256^3,
// ~0.065 ms at 3.35 TB/s; the seven flag reads per update hit L1/L2. The
// in-place half-sweep uses half of every sector it touches, as in
// rbgs_smooth.cu; tiles in shared memory are later work.
#include "common.cuh"

namespace {

__device__ __forceinline__ float counts(const uint8_t* f, int64_t idx) {
  return f[idx] <= 1 ? 1.0f : 0.0f;  // fluid or air neighbour
}

__device__ __forceinline__ float masked_diag(const uint8_t* __restrict__ f,
                                             int64_t idx, int i, int j, int k,
                                             int nx, int ny, int nz) {
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  float d = 0.0f;
  d += i < nx - 1 ? counts(f, idx + sx) : 0.0f;
  d += i > 0 ? counts(f, idx - sx) : 0.0f;
  d += j < ny - 1 ? counts(f, idx + sy) : 0.0f;
  d += j > 0 ? counts(f, idx - sy) : 0.0f;
  d += k < nz - 1 ? counts(f, idx + 1) : 0.0f;
  d += k > 0 ? counts(f, idx - 1) : 0.0f;
  return fmaxf(d, 1.0f);
}

__device__ __forceinline__ float fluid_value(const float* __restrict__ x,
                                             const uint8_t* __restrict__ f,
                                             int64_t idx) {
  return f[idx] == 0 ? x[idx] : 0.0f;
}

__global__ void masked_rbgs_first_kernel(const float* __restrict__ x_in,
                                         const float* __restrict__ b,
                                         const uint8_t* __restrict__ f, int nx,
                                         int ny, int nz, int colour,
                                         float* __restrict__ out) {
  const int64_t n = (int64_t)nx * ny * nz;
  const int64_t sx = (int64_t)ny * nz, sy = nz;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (int64_t)gridDim.x * blockDim.x) {
    if (f[idx] != 0) {
      out[idx] = 0.0f;
      continue;
    }
    const int k = (int)(idx % nz);
    const int j = (int)((idx / nz) % ny);
    const int i = (int)(idx / sx);
    if (((i + j + k) & 1) != colour) {
      out[idx] = x_in ? x_in[idx] : 0.0f;
      continue;
    }
    float nb = 0.0f;
    if (x_in) {
      nb = nb + (i < nx - 1 ? fluid_value(x_in, f, idx + sx) : 0.0f);
      nb = nb + (i > 0 ? fluid_value(x_in, f, idx - sx) : 0.0f);
      nb = nb + (j < ny - 1 ? fluid_value(x_in, f, idx + sy) : 0.0f);
      nb = nb + (j > 0 ? fluid_value(x_in, f, idx - sy) : 0.0f);
      nb = nb + (k < nz - 1 ? fluid_value(x_in, f, idx + 1) : 0.0f);
      nb = nb + (k > 0 ? fluid_value(x_in, f, idx - 1) : 0.0f);
    }
    out[idx] = (nb + b[idx]) / masked_diag(f, idx, i, j, k, nx, ny, nz);
  }
}

// In place: `x` is read at the other colour and written at `colour`.
__global__ void masked_rbgs_half_kernel(float* x, const float* __restrict__ b,
                                        const uint8_t* __restrict__ f, int nx,
                                        int ny, int nz, int colour) {
  const int half = (nz + 1) / 2;
  const int64_t n = (int64_t)nx * ny * half;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int kh = (int)(t % half);
    const int j = (int)((t / half) % ny);
    const int i = (int)(t / ((int64_t)half * ny));
    const int k = 2 * kh + ((i + j + colour) & 1);
    if (k >= nz) continue;
    const int64_t idx = ((int64_t)i * ny + j) * nz + k;
    if (f[idx] != 0) continue;
    const float nb = gfs::neighbour_sum(x, idx, i, j, k, nx, ny, nz);
    x[idx] = (nb + b[idx]) / masked_diag(f, idx, i, j, k, nx, ny, nz);
  }
}

}  // namespace

extern "C" int gfs_masked_rbgs_first(const void* x_in, const void* b,
                                     const void* flags, int nx, int ny, int nz,
                                     int colour, void* out, void* stream) {
  const int64_t n = (int64_t)nx * ny * nz;
  masked_rbgs_first_kernel<<<gfs::blocks_for(n), gfs::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)x_in, (const float*)b, (const uint8_t*)flags, nx, ny, nz,
      colour, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int gfs_masked_rbgs_half(void* x, const void* b, const void* flags,
                                    int nx, int ny, int nz, int colour,
                                    void* stream) {
  const int64_t n = (int64_t)nx * ny * ((nz + 1) / 2);
  masked_rbgs_half_kernel<<<gfs::blocks_for(n), gfs::kThreads, 0,
                            (cudaStream_t)stream>>>(
      (float*)x, (const float*)b, (const uint8_t*)flags, nx, ny, nz, colour);
  return (int)cudaGetLastError();
}
