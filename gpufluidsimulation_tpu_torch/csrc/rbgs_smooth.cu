// rbgs_smooth: red-black Gauss-Seidel half-sweeps of L x = b.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/pallas_kernels.py
// _rbgs_kernel (pallas_call in _rbgs_launch, entry rbgs_smooth).
// L x = diag*x - (sum of the 6 axis neighbours, zero ghosts outside the
// field); diag is 6 (Dirichlet) or the count of in-domain neighbours
// (Neumann), computed from the indices. A cell update is
//   nb = ((((((0 + x[i+1]) + x[i-1]) + x[j+1]) + x[j-1]) + x[k+1]) + x[k-1])
//   x  = (nb + b) / diag
// in exactly this order, with a true division. Red is (i+j+k) even.
//
// Colour order is the semantics: a cell of one colour reads only cells of
// the other, so updating one colour in place is race-free, and one launch
// never mixes colours. A sweep is two launches:
//   gfs_rbgs_first  the first half-sweep of a call, out of place: cells of
//                   `colour` get the update computed from x_in, the other
//                   colour is copied (x_in == nullptr means x is exactly
//                   zero: update = (0 + b)/diag, other colour = 0, and x_in
//                   is never read). This is the copy the functional wrapper
//                   needs anyway, fused with a half-sweep.
//   gfs_rbgs_half   every later half-sweep, in place on the output: one
//                   thread per cell of `colour`, k fastest.
//
// What bounds it on the H100: bytes. A full sweep must read x and b and
// write x, 3 x 67 MB at 256^3, ~0.06 ms at 3.35 TB/s. The in-place
// half-sweep touches every 32-byte sector of x and b for half the cells,
// so two launches move about twice that. The TPU kernel ran 2 sweeps per
// (32+8)x(32+16)xnz VMEM window with halos losing a ring per half-sweep;
// none of that carries over. Shared-memory tiles that run both colours of
// a sweep per launch are later work.
#include "common.cuh"

namespace {

__device__ __forceinline__ float structural_diag(int i, int j, int k, int nx,
                                                 int ny, int nz, int neumann) {
  if (!neumann) return 6.0f;
  return (i > 0 ? 1.0f : 0.0f) + (i < nx - 1 ? 1.0f : 0.0f) +
         (j > 0 ? 1.0f : 0.0f) + (j < ny - 1 ? 1.0f : 0.0f) +
         (k > 0 ? 1.0f : 0.0f) + (k < nz - 1 ? 1.0f : 0.0f);
}

__global__ void rbgs_first_kernel(const float* __restrict__ x_in,
                                  const float* __restrict__ b, int nx, int ny,
                                  int nz, int neumann, int colour,
                                  float* __restrict__ out) {
  const int64_t n = (int64_t)nx * ny * nz;
  const int64_t sx = (int64_t)ny * nz;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (int64_t)gridDim.x * blockDim.x) {
    const int k = (int)(idx % nz);
    const int j = (int)((idx / nz) % ny);
    const int i = (int)(idx / sx);
    if (((i + j + k) & 1) != colour) {
      out[idx] = x_in ? x_in[idx] : 0.0f;
      continue;
    }
    const float nb =
        x_in ? gfs::neighbour_sum(x_in, idx, i, j, k, nx, ny, nz) : 0.0f;
    out[idx] = (nb + b[idx]) / structural_diag(i, j, k, nx, ny, nz, neumann);
  }
}

// In place: `x` is read at the other colour and written at `colour`, so
// it carries no __restrict__.
__global__ void rbgs_half_kernel(float* x, const float* __restrict__ b,
                                 int nx, int ny, int nz, int neumann,
                                 int colour) {
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
    const float nb = gfs::neighbour_sum(x, idx, i, j, k, nx, ny, nz);
    x[idx] = (nb + b[idx]) / structural_diag(i, j, k, nx, ny, nz, neumann);
  }
}

}  // namespace

extern "C" int gfs_rbgs_first(const void* x_in, const void* b, int nx, int ny,
                              int nz, int neumann, int colour, void* out,
                              void* stream) {
  const int64_t n = (int64_t)nx * ny * nz;
  rbgs_first_kernel<<<gfs::blocks_for(n), gfs::kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)x_in, (const float*)b, nx, ny, nz, neumann, colour,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int gfs_rbgs_half(void* x, const void* b, int nx, int ny, int nz,
                             int neumann, int colour, void* stream) {
  const int64_t n = (int64_t)nx * ny * ((nz + 1) / 2);
  rbgs_half_kernel<<<gfs::blocks_for(n), gfs::kThreads, 0,
                     (cudaStream_t)stream>>>(
      (float*)x, (const float*)b, nx, ny, nz, neumann, colour);
  return (int)cudaGetLastError();
}
