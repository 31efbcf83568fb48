// dmc_substep: one backward-map DMC substep on the cell lattice.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel_dmc (pallas_call in _dmc_padded; entries dmc_substep_fast and
// dmc_substep_fast_carry). Per cell (i, j, k) in the interior band
// 2 <= idx <= n-3 (interior_mask('c', 2, 3)), else the old map is kept:
//   vel  = MAC face averages at the cell center
//   t    = the same averages at the diagonal upwind neighbour
//          (i - 1 where vel_u > 0 else i + 1, likewise in y and z)
//   disp = exponential DMC step in cells per axis
//          (advect.dmc_displacements_3d: du = vel - t, q = du*sgn*sh,
//           (1 - exp(-q)) * vel / (du*sgn) when |du| > 1e-4 h, else vel*sh)
//   map' = trilerp(map_c, (i, j, k) - disp) for the 3 map channels,
//          clamped corner indices.
// expf is the IEEE-accurate libdevice expf (no fast math).
//
// The lattice mode computes the same substep applied to the identity map
// (the first substep of a march from the identity: the JAX package's
// identity peel, advect.dmc_backward_identity_3d) and reads no map:
// sampling the identity at the new position is the position itself,
// clamped to the lattice-value range, so inside the band
//   map' = clamp(p - disp*h, 0, (n-1)h),   p = (i, j, k)*h
// and outside it map' = p. p is formed as Grid3D.axis_coords('c') forms
// it, (float)i * h, and the clamp propagates a NaN as torch.clamp does.
//
// What bounds it on the H100: bytes. Each cell reads 3 map floats and
// writes 3, and reads the velocity triplet (centre and upwind faces, all
// within one cell); at 256^3 that is ~9 x 67 MB, ~0.18 ms at 3.35 TB/s
// (the lattice mode reads no map: ~0.12 ms). The first design ran one
// thread per cell on a grid-stride loop over an int64 index (three 64-bit
// divisions and modulos a cell), clamped the upwind indices, and called
// gfs::trilerp_clamped once per map channel at the same position: three
// floor sets, 18 clamps and 24 64-bit offsets a cell. It ran at 2.4x the
// bound, held by instruction issue, as rk3_substep's first design was.
//
// The design here: one thread per cell on a (k, j, i) block of the cell
// lattice, k fastest, so that map loads, face loads and stores coalesce
// and a block's upwind gathers hit the rows its neighbours loaded, in L1.
// Offsets are unsigned 32-bit, formed from the cell's own offset and the
// strides (the wrapper raises unless every face array and the map hold
// fewer than 2^31 values). Inside the band the upwind neighbour i -+ 1 lies
// in [1, n-2], so the plain version's clamp of it changes nothing and is
// left out. The map position is floored once and its weight set and
// corner offsets serve the three map channels; along z the corners are
// loaded as a pair (gfs::zpair, which needs nk >= 2: the wrapper raises
// below that). The velocity averages, the guard, the exponential and the
// division keep the plain version's operands and order, and the library
// is built with -fmad=false: the result is bit-identical.
//
// Measured (chip_smoke.py and scripts/kernel_variants.py, H100, 256^3):
// 0.443 -> 0.286 ms from a displaced map, 0.179 ms in the lattice mode
// (the plain-torch peel it replaces: 7.1 ms); block shapes 32x2x2 to
// 64x2x1 within 2% (32x1x1 +18%), the z corners clamped one by one +6%,
// a velocity tile staged in shared memory 4x slower. 1.6x and 1.5x the
// bytes bound (PERF.md, rows 9 and 9').
#include "common.cuh"

namespace {

// A block covers 32 x 4 x 1 cells (k, j, i): 128 threads
constexpr int kBlockK = 32, kBlockJ = 4, kBlockI = 1;

using gfs::Coord;
using gfs::coord;
using gfs::trilerp_zpair;
using gfs::ZPair;
using gfs::zpair;

__device__ __forceinline__ float dmc_disp(float vel, float t, bool pos,
                                          float sh, float thresh) {
  const float sgn = pos ? 1.0f : -1.0f;
  const float du = vel - t;
  const float q = du * sgn * sh;
  const bool safe = fabsf(du) > thresh;
  const float denom = safe ? du * sgn : 1.0f;
  const float exp_disp = (1.0f - expf(-q)) * vel / denom;
  return safe ? exp_disp : vel * sh;
}

// clamp(x, 0, hi) as torch.clamp computes it on the card (a NaN stays)
__device__ __forceinline__ float clamp_pos(float x, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), hi);
}

struct Params {
  float sh, thresh;
  float h;                 // the lattice mode's cell size, float32
  float hix, hiy, hiz;     // the lattice mode's clamp: (n - 1) * h
};

// kLattice: the substep of the identity map (no map read); else of `maps`.
template <bool kLattice>
__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI)
    dmc_substep_kernel(const float* __restrict__ u,
                       const float* __restrict__ v,
                       const float* __restrict__ w, int ni, int nj, int nk,
                       const float* __restrict__ maps, Params P,
                       float* __restrict__ out) {
  const int k = blockIdx.x * kBlockK + threadIdx.x;
  const int j = blockIdx.y * kBlockJ + threadIdx.y;
  const int i = blockIdx.z * kBlockI + threadIdx.z;
  if (k >= nk || j >= nj || i >= ni) return;
  const unsigned n = (unsigned)ni * nj * nk;
  const unsigned idx = ((unsigned)i * nj + j) * nk + k;
  const bool band = i >= 2 && i <= ni - 3 && j >= 2 && j <= nj - 3 &&
                    k >= 2 && k <= nk - 3;
  if (!band) {
    if (kLattice) {
      out[idx] = (float)i * P.h;
      out[n + idx] = (float)j * P.h;
      out[2 * n + idx] = (float)k * P.h;
    } else {
      out[idx] = __ldg(maps + idx);
      out[n + idx] = __ldg(maps + n + idx);
      out[2 * n + idx] = __ldg(maps + 2 * n + idx);
    }
    return;
  }
  // the faces of cell (i, j, k): u (ni+1, nj, nk) at idx and idx + su,
  // v (ni, nj+1, nk) at ov and ov + nk, w (ni, nj, nk+1) at ow and ow + 1
  const unsigned su = (unsigned)nj * nk;
  const unsigned sv = (unsigned)(nj + 1) * nk;
  const unsigned sw = (unsigned)nj * (nk + 1);
  const unsigned ov = idx + (unsigned)i * nk;
  const unsigned ow = idx + (unsigned)i * nj + j;
  const float vu = 0.5f * (__ldg(u + idx) + __ldg(u + (idx + su)));
  const float vv = 0.5f * (__ldg(v + ov) + __ldg(v + (ov + nk)));
  const float vw = 0.5f * (__ldg(w + ow) + __ldg(w + (ow + 1)));
  const bool sx = vu > 0.0f, sy = vv > 0.0f, sz = vw > 0.0f;
  // the upwind cell (i -+ 1, j -+ 1, k -+ 1), inside the lattice
  const unsigned tu = sx ? idx - su : idx + su;
  const unsigned tv0 = sx ? ov - sv : ov + sv;
  const unsigned tw0 = sx ? ow - sw : ow + sw;
  const unsigned step_y = sy ? 0u - nk : (unsigned)nk;
  const unsigned step_yw = sy ? 0u - (nk + 1) : (unsigned)(nk + 1);
  const unsigned step_z = sz ? 0u - 1u : 1u;
  const unsigned tu1 = tu + step_y + step_z, tv1 = tv0 + step_y + step_z,
                 tw1 = tw0 + step_yw + step_z;
  const float tu_ = 0.5f * (__ldg(u + tu1) + __ldg(u + (tu1 + su)));
  const float tv_ = 0.5f * (__ldg(v + tv1) + __ldg(v + (tv1 + nk)));
  const float tw_ = 0.5f * (__ldg(w + tw1) + __ldg(w + (tw1 + 1)));
  const float disp_x = dmc_disp(vu, tu_, sx, P.sh, P.thresh);
  const float disp_y = dmc_disp(vv, tv_, sy, P.sh, P.thresh);
  const float disp_z = dmc_disp(vw, tw_, sz, P.sh, P.thresh);
  if (kLattice) {
    out[idx] = clamp_pos((float)i * P.h - disp_x * P.h, P.hix);
    out[n + idx] = clamp_pos((float)j * P.h - disp_y * P.h, P.hiy);
    out[2 * n + idx] = clamp_pos((float)k * P.h - disp_z * P.h, P.hiz);
  } else {
    // one weight set and one set of corner offsets for the 3 channels
    const Coord x = coord((float)i - disp_x, ni);
    const Coord y = coord((float)j - disp_y, nj);
    const ZPair z = zpair((float)k - disp_z, nk);
    out[idx] = trilerp_zpair(maps, x, y, z, su, nk);
    out[n + idx] = trilerp_zpair(maps + n, x, y, z, su, nk);
    out[2 * n + idx] = trilerp_zpair(maps + 2 * n, x, y, z, su, nk);
  }
}

}  // namespace

// maps == NULL selects the lattice mode: the substep of the identity map
// on the cell lattice of spacing h, clamped to [0, hi_host[a]] per axis.
extern "C" int gfs_dmc_substep(const void* u, const void* v, const void* w,
                               int ni, int nj, int nk, const void* maps,
                               float sh, float thresh, float h,
                               const float* hi_host, void* out,
                               void* stream) {
  const long long limit = 1LL << 31;
  if (ni < 1 || nj < 1 || nk < 2 ||
      3LL * ni * nj * nk >= limit || (long long)(ni + 1) * nj * nk >= limit ||
      (long long)ni * (nj + 1) * nk >= limit ||
      (long long)ni * nj * (nk + 1) >= limit)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockK, kBlockJ, kBlockI);
  const dim3 grid((nk + kBlockK - 1) / kBlockK, (nj + kBlockJ - 1) / kBlockJ,
                  (ni + kBlockI - 1) / kBlockI);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const Params P{sh, thresh, h, hi_host[0], hi_host[1], hi_host[2]};
  if (maps == nullptr)
    dmc_substep_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)v, (const float*)w, ni, nj, nk,
        nullptr, P, (float*)out);
  else
    dmc_substep_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)v, (const float*)w, ni, nj, nk,
        (const float*)maps, P, (float*)out);
  return (int)cudaGetLastError();
}
