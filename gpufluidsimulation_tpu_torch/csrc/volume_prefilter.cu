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
// 3.35 TB/s. The first design gave each output its own thread, which
// split a 64-bit index by three 64-bit divisions, loaded 27 neighbours and
// recomputed the z pass 9 times and the y pass 3 times: 6x the bound.
//
// The design here is 2.5D blocking. A block owns a 32 x 4 (k, j) tile of
// one channel and marches along i over a segment of 32 output planes.
// For each input plane it stages the clamped tile + 1-cell (j, k) halo in
// shared memory (each element loaded once, coalesced along k; the next
// plane's loads are started before this plane's passes), computes the z
// pass of the tile's rows and the two halo rows, then each thread the y
// pass of its node. The y-passed values of planes i - 1, i, i + 1 and the
// centre value ride a register ring, from which the x pass and the blend
// give the output of plane i. A segment's first plane reloads one halo
// plane; at the i edges the clamped plane is the edge plane itself, whose
// values are reused. Each z and y value is the plain version's float32
// expression on the same operands, computed once instead of 9 or 3
// times, and the library is built with -fmad=false: bit-identical.
// Indices come from blockIdx/threadIdx; offsets are 32-bit (the wrapper
// raises unless C*nx*ny*nz is below 2^31).
//
// Measured (scripts/kernel_variants.py, H100, 257x256x256): 0.069 ms at
// C=1 and 0.131 at C=2, 1.7x the bytes bound (PERF.md, row 4); other
// tiles and segment lengths 2-20% longer, loading each plane only when it
// is staged 25% longer.
#include "common.cuh"

namespace {

constexpr int kTileK = 32, kTileJ = 4, kSeg = 32;
constexpr int kSlabK = kTileK + 2, kSlabJ = kTileJ + 2;
constexpr int kThreads = kTileK * kTileJ;
constexpr int kSlab = kSlabJ * kSlabK;
constexpr int kLoads = (kSlab + kThreads - 1) / kThreads;

__device__ __forceinline__ float smooth3(float lo, float mid, float hi) {
  return (0.125f * lo + 0.75f * mid) + 0.125f * hi;
}

__global__ void __launch_bounds__(kThreads)
    volume_prefilter_kernel(const float* __restrict__ f, int nx, int ny,
                            int nz, int nseg, float* __restrict__ out) {
  __shared__ float slab[kSlabJ][kSlabK];
  __shared__ float zpass[kSlabJ][kTileK];
  const int tk = threadIdx.x, tj = threadIdx.y;
  const int tid = tj * kTileK + tk;
  const int k0 = blockIdx.x * kTileK, j0 = blockIdx.y * kTileJ;
  const int c = blockIdx.z / nseg;
  const int i0 = (blockIdx.z - c * nseg) * kSeg;
  const int i1 = min(i0 + kSeg, nx);       // outputs i0 .. i1 - 1
  const int plane = ny * nz;
  const float* src = f + c * (nx * plane);
  float* dst = out + c * (nx * plane);
  // this thread's slab elements: their clamped in-plane offsets
  int off[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int e = tid + q * kThreads;
    const int jj = e / kSlabK, kk = e - jj * kSlabK;
    off[q] = gfs::clampi(j0 - 1 + jj, 0, ny - 1) * nz +
             gfs::clampi(k0 - 1 + kk, 0, nz - 1);
  }
  const int last_plane = min(i1, nx - 1);
  float buf[kLoads] = {};
  auto load = [&](int ip) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q)
      if (tid + q * kThreads < kSlab)
        buf[q] = __ldg(src + ip * plane + off[q]);
  };
  const int k = k0 + tk, j = j0 + tj;
  const bool active = k < nz && j < ny;
  const int node = j * nz + k;
  load(max(i0 - 1, 0));
  // ring: y-passed values r0, r1, r2 of planes p - 2, p - 1, p and the
  // centre values c1, c2 of planes p - 1, p
  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  float t = 0.0f, centre = 0.0f;
  int last = -1;
  for (int p = i0 - 1; p <= i1; ++p) {
    const int cur = gfs::clampi(p, 0, nx - 1);
    if (cur != last) {      // uniform over the block
#pragma unroll
      for (int q = 0; q < kLoads; ++q)
        if (tid + q * kThreads < kSlab)
          (&slab[0][0])[tid + q * kThreads] = buf[q];
      __syncthreads();
      // the planes this segment visits are max(i0 - 1, 0) .. last_plane
      if (cur < last_plane) load(cur + 1);
      for (int e = tid; e < kSlabJ * kTileK; e += kThreads) {
        const int jj = e / kTileK, kk = e - jj * kTileK;
        zpass[jj][kk] = smooth3(slab[jj][kk], slab[jj][kk + 1],
                                slab[jj][kk + 2]);
      }
      centre = slab[tj + 1][tk + 1];
      __syncthreads();
      t = smooth3(zpass[tj][tk], zpass[tj + 1][tk], zpass[tj + 2][tk]);
      last = cur;
    }
    r0 = r1;
    r1 = r2;
    r2 = t;
    c1 = c2;
    c2 = centre;
    if (p > i0 && active)
      dst[(p - 1) * plane + node] = 0.5f * c1 + 0.5f * smooth3(r0, r1, r2);
  }
}

}  // namespace

extern "C" int gfs_volume_prefilter(const void* fields, int C, int nx, int ny,
                                    int nz, void* out, void* stream) {
  if (C < 1 || nx < 1 || ny < 1 || nz < 1 ||
      (long long)C * nx * ny * nz >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int nseg = (nx + kSeg - 1) / kSeg;
  const dim3 block(kTileK, kTileJ);
  const dim3 grid((nz + kTileK - 1) / kTileK, (ny + kTileJ - 1) / kTileJ,
                  C * nseg);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  volume_prefilter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)fields, nx, ny, nz, nseg, (float*)out);
  return (int)cudaGetLastError();
}
