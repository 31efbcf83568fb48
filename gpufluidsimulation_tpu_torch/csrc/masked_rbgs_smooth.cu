// masked_rbgs_smooth: red-black Gauss-Seidel sweeps on the masked
// (voxel-boundary) pressure operator, a whole smoother call in one launch.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/pallas_kernels.py
// _masked_rbgs_kernel (pallas_call in _masked_rbgs_launch, entry
// masked_rbgs_smooth). Cell flags: 0 fluid, 1 air (p = 0 ghost), 2 domain
// solid, 3 moving solid; outside the field counts as solid. Only fluid
// cells update; every other cell holds 0, whatever x held there (the
// caller's x may be nonzero on them after a prolongation). Because of that
// the sum over fluid neighbours is the plain 6-point sum with zero ghosts
//   nb = ((((((0 + x[i+1]) + x[i-1]) + x[j+1]) + x[j-1]) + x[k+1]) + x[k-1])
// and only the diagonal needs the flags:
//   diag = max(number of fluid-or-air neighbours, 1),  x = (nb + b) / diag
// with a true division. Red is (i+j+k) even; a sweep is red then black, or
// black then red from `first` = 1.
//
// gfs_masked_rbgs_smooth runs `levels` colour half-sweeps (kLevels or 2)
// from where(fluid, x, 0) (x null: exactly zero, never read) out of place
// into `out`; the wrapper splits a call as rbgs_smooth's does.
//
// What bounds it on the H100: bytes. A 2-sweep call must read x, b and the
// flags (one byte a cell) and write x once: 13 bytes a cell, 218 MB at
// 256^3, ~0.065 ms at 3.35 TB/s (~0.045 from a zero guess). The first port
// made 4 device-memory passes a call, read 7 flag bytes per update and
// recounted the diagonal at every half-sweep. Here the wavefront of
// gs_wavefront.cuh reads each plane's flags once and forms each cell's
// fluid bit and diagonal once for all the levels of a launch.
#include "gs_wavefront.cuh"

extern "C" int gfs_masked_rbgs_smooth(const void* x, const void* b,
                                      const void* flags, int nx, int ny,
                                      int nz, int first, int levels,
                                      void* out, void* stream) {
  if (!gs::valid(nx, ny, nz, first)) return (int)cudaErrorInvalidValue;
  const float* xp = (const float*)x;
  const float* bp = (const float*)b;
  const uint8_t* fp = (const uint8_t*)flags;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (levels == gs::kLevels)
    return gs::launch<gs::kLevels, gs::kMasked>(xp, bp, fp, nx, ny, nz,
                                                first, op, s);
  if (levels == 2)
    return gs::launch<2, gs::kMasked>(xp, bp, fp, nx, ny, nz, first, op, s);
  return (int)cudaErrorInvalidValue;
}
