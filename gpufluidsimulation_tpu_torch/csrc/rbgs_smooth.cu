// rbgs_smooth: red-black Gauss-Seidel sweeps of L x = b, a whole smoother
// call in one launch.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/pallas_kernels.py
// _rbgs_kernel (pallas_call in _rbgs_launch, entry rbgs_smooth).
// L x = diag*x - (sum of the 6 axis neighbours, zero ghosts outside the
// field); diag is 6 (Dirichlet) or the count of in-domain neighbours
// (Neumann), computed from the indices. A cell update is
//   nb = ((((((0 + x[i+1]) + x[i-1]) + x[j+1]) + x[j-1]) + x[k+1]) + x[k-1])
//   x  = (nb + b) / diag
// in exactly this order, with a true division. Red is (i+j+k) even; a sweep
// is red then black, or black then red from `first` = 1 (the V-cycle's
// reverse post-smoother).
//
// gfs_rbgs_smooth runs `levels` colour half-sweeps (kLevels or 2) from x
// (null: exactly zero, never read) out of place into `out`. The wrapper
// (stencil_kernels.rbgs_smooth) makes a call of `iters` sweeps 2*iters
// levels in launches of kLevels and one of the remainder, ping-ponging two
// buffers: the V-cycle's 2-sweep calls are one launch each.
//
// What bounds it on the H100: bytes. The unit the V-cycle calls is the
// 2-sweep call, whose least traffic is one read of x and b and one write of
// the result: 3 x 67 MB at 256^3, ~0.060 ms at 3.35 TB/s (~0.040 from a
// zero guess). The first port made each half-sweep a device-memory pass
// that used half of every sector it touched, 4 launches a call, and
// recovered (i, j, k) with int64 divisions. The TPU kernel ran both sweeps
// of a call in one VMEM window with a shrinking halo; the design here is
// its counterpart on Hopper, the 2.5D wavefront of gs_wavefront.cuh: a
// (j, k) region marching along i with one shared-memory plane per level,
// each lane owning a column pair so that every lane updates at every level.
#include "gs_wavefront.cuh"

extern "C" int gfs_rbgs_smooth(const void* x, const void* b, int nx, int ny,
                               int nz, int neumann, int first, int levels,
                               void* out, void* stream) {
  if (!gs::valid(nx, ny, nz, first)) return (int)cudaErrorInvalidValue;
  const float* xp = (const float*)x;
  const float* bp = (const float*)b;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (levels == gs::kLevels)
    return neumann ? gs::launch<gs::kLevels, gs::kNeumann>(xp, bp, nullptr,
                                                           nx, ny, nz, first,
                                                           op, s)
                   : gs::launch<gs::kLevels, gs::kDirichlet>(
                         xp, bp, nullptr, nx, ny, nz, first, op, s);
  if (levels == 2)
    return neumann ? gs::launch<2, gs::kNeumann>(xp, bp, nullptr, nx, ny, nz,
                                                 first, op, s)
                   : gs::launch<2, gs::kDirichlet>(xp, bp, nullptr, nx, ny,
                                                   nz, first, op, s);
  return (int)cudaErrorInvalidValue;
}
