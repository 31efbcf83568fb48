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
// The slab mode (the sharded backward march, parallel/sharded_interp.py):
// the output holds the cell planes oz0 .. oz0 + nko - 1 of a grid of nkg
// cells, the faces the planes vz0 .. vz0 + nk - 1 (w one more), and the
// map the planes mz0 .. mz0 + nkm - 1 (the output slab and its exchanged
// halo). Cell k of the output is global plane kg = k + oz0: the band test,
// the lattice position and the map coordinate kg - disp use kg; each map
// z node is clamped to [0, nkg - 1], then mz0 is subtracted to address the
// slab (gfs::zpair_slab), and a node outside the map slab is clamped to
// its edge and the cell adds 1 to *overflow. The wrapper checks that the
// faces hold every plane a cell in the band reads (kg - 1 .. kg + 1) and
// the map every output plane. Nothing is rebased in float. The
// whole-grid kernel is compiled apart (kSlab = false) and stays as it was.
//
// Measured (chip_smoke.py and scripts/kernel_variants.py, H100, 256^3):
// 0.443 -> 0.286 ms from a displaced map, 0.179 ms in the lattice mode
// (the plain-torch peel it replaces: 7.1 ms); block shapes 32x2x2 to
// 64x2x1 within 2% (32x1x1 +18%), the z corners clamped one by one +6%,
// a velocity tile staged in shared memory 4x slower. 1.6x and 1.5x the
// bytes bound (PERF.md, rows 9 and 9').
//
// The bf16 mode (EngineMode.interp_bf16, the JAX package's bf16 MAC pack),
// in the map mode only: u, v, w are bfloat16, each value widened to float32
// at its load (gfs::load), all arithmetic after it float32. The lattice
// mode stands for the JAX identity peel, which reads the unrounded faces,
// so it has no bf16 mode. Compiled apart (T = __nv_bfloat16), whole grid
// only; the float32 instantiations stay as they were.
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

// The slab mode's planes: the grid's cell extent nkg; the output's first
// plane oz0 and its planes nko; the faces' first plane vz0; the map's
// first plane mz0 and its planes nkm.
struct ZSlab {
  int nkg, oz0, nko, vz0, mz0, nkm;
};

// kLattice: the substep of the identity map (no map read); else of `maps`.
// kSlab: the output, the faces and the map are slabs of the grid (zs); nk
// is the faces' cell extent.
template <bool kLattice, bool kSlab, typename T>
__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI)
    dmc_substep_kernel(const T* __restrict__ u, const T* __restrict__ v,
                       const T* __restrict__ w, int ni, int nj, int nk,
                       const float* __restrict__ maps, Params P, ZSlab zs,
                       int* __restrict__ overflow, float* __restrict__ out) {
  const int nko = kSlab ? zs.nko : nk;
  const int k = blockIdx.x * kBlockK + threadIdx.x;
  const int j = blockIdx.y * kBlockJ + threadIdx.y;
  const int i = blockIdx.z * kBlockI + threadIdx.z;
  if (k >= nko || j >= nj || i >= ni) return;
  const int kg = kSlab ? k + zs.oz0 : k;         // the global plane
  const int nkg = kSlab ? zs.nkg : nk;
  const int nkm = kSlab ? zs.nkm : nk;
  // the cell's offsets in the output (and, on the whole grid, everywhere),
  // in the map and in the faces' cell lattice
  const unsigned no = (unsigned)ni * nj * nko;
  const unsigned idx = ((unsigned)i * nj + j) * nko + k;
  const unsigned nm = kSlab ? (unsigned)ni * nj * nkm : no;
  const unsigned im =
      kSlab ? ((unsigned)i * nj + j) * nkm + (unsigned)(kg - zs.mz0) : idx;
  const bool band = i >= 2 && i <= ni - 3 && j >= 2 && j <= nj - 3 &&
                    kg >= 2 && kg <= nkg - 3;
  if (!band) {
    if (kLattice) {
      out[idx] = (float)i * P.h;
      out[no + idx] = (float)j * P.h;
      out[2 * no + idx] = (float)kg * P.h;
    } else {
      out[idx] = __ldg(maps + im);
      out[no + idx] = __ldg(maps + nm + im);
      out[2 * no + idx] = __ldg(maps + 2 * nm + im);
    }
    return;
  }
  const unsigned iv =
      kSlab ? ((unsigned)i * nj + j) * nk + (unsigned)(kg - zs.vz0) : idx;
  // the faces of cell (i, j, k): u (ni+1, nj, nk) at iv and iv + su,
  // v (ni, nj+1, nk) at ov and ov + nk, w (ni, nj, nk+1) at ow and ow + 1
  const unsigned su = (unsigned)nj * nk;
  const unsigned sv = (unsigned)(nj + 1) * nk;
  const unsigned sw = (unsigned)nj * (nk + 1);
  const unsigned ov = iv + (unsigned)i * nk;
  const unsigned ow = iv + (unsigned)i * nj + j;
  const float vu = 0.5f * (gfs::load(u + iv) + gfs::load(u + (iv + su)));
  const float vv = 0.5f * (gfs::load(v + ov) + gfs::load(v + (ov + nk)));
  const float vw = 0.5f * (gfs::load(w + ow) + gfs::load(w + (ow + 1)));
  const bool sx = vu > 0.0f, sy = vv > 0.0f, sz = vw > 0.0f;
  // the upwind cell (i -+ 1, j -+ 1, k -+ 1), inside the lattice
  const unsigned tu = sx ? iv - su : iv + su;
  const unsigned tv0 = sx ? ov - sv : ov + sv;
  const unsigned tw0 = sx ? ow - sw : ow + sw;
  const unsigned step_y = sy ? 0u - nk : (unsigned)nk;
  const unsigned step_yw = sy ? 0u - (nk + 1) : (unsigned)(nk + 1);
  const unsigned step_z = sz ? 0u - 1u : 1u;
  const unsigned tu1 = tu + step_y + step_z, tv1 = tv0 + step_y + step_z,
                 tw1 = tw0 + step_yw + step_z;
  const float tu_ = 0.5f * (gfs::load(u + tu1) + gfs::load(u + (tu1 + su)));
  const float tv_ = 0.5f * (gfs::load(v + tv1) + gfs::load(v + (tv1 + nk)));
  const float tw_ = 0.5f * (gfs::load(w + tw1) + gfs::load(w + (tw1 + 1)));
  const float disp_x = dmc_disp(vu, tu_, sx, P.sh, P.thresh);
  const float disp_y = dmc_disp(vv, tv_, sy, P.sh, P.thresh);
  const float disp_z = dmc_disp(vw, tw_, sz, P.sh, P.thresh);
  if (kLattice) {
    out[idx] = clamp_pos((float)i * P.h - disp_x * P.h, P.hix);
    out[no + idx] = clamp_pos((float)j * P.h - disp_y * P.h, P.hiy);
    out[2 * no + idx] = clamp_pos((float)kg * P.h - disp_z * P.h, P.hiz);
  } else {
    // one weight set and one set of corner offsets for the 3 channels
    const Coord x = coord((float)i - disp_x, ni);
    const Coord y = coord((float)j - disp_y, nj);
    bool outside = false;
    const ZPair z = kSlab ? gfs::zpair_slab((float)kg - disp_z, nkg, zs.mz0,
                                            nkm, outside)
                          : zpair((float)k - disp_z, nk);
    const unsigned sm = (unsigned)nj * nkm;
    out[idx] = trilerp_zpair(maps, x, y, z, sm, nkm);
    out[no + idx] = trilerp_zpair(maps + nm, x, y, z, sm, nkm);
    out[2 * no + idx] = trilerp_zpair(maps + 2 * nm, x, y, z, sm, nkm);
    if (kSlab && outside && overflow != nullptr)
    atomicAdd(overflow, 1);
  }
}

template <bool kLattice, bool kSlab, typename T>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const T* u,
            const T* v, const T* w, int ni, int nj, int nk,
            const float* maps, const Params& P, ZSlab zs, int* overflow,
            float* out) {
  dmc_substep_kernel<kLattice, kSlab, T><<<grid, block, 0, stream>>>(
      u, v, w, ni, nj, nk, maps, P, zs, overflow, out);
}

}  // namespace

// maps == NULL selects the lattice mode: the substep of the identity map
// on the cell lattice of spacing h, clamped to [0, hi_host[a]] per axis.
// slab_host == NULL selects the whole-grid kernel; else it holds nkg, oz0,
// nko, vz0, mz0 and nkm (ZSlab): the faces are the cell planes vz0 .. vz0 +
// nk - 1, the map (3, ni, nj, nkm) and the output (3, ni, nj, nko), and a
// cell whose map sample used a plane outside the map adds 1 to *overflow
// where that is not NULL (the lattice mode reads no map and counts
// nothing). bf16 != 0: u, v, w are bfloat16 (the map mode on the whole grid
// only), else float32.
extern "C" int gfs_dmc_substep(const void* u, const void* v, const void* w,
                               int bf16, int ni, int nj, int nk,
                               const void* maps,
                               float sh, float thresh, float h,
                               const float* hi_host, const int* slab_host,
                               void* overflow, void* out, void* stream) {
  const long long limit = 1LL << 31;
  const bool slab = slab_host != nullptr;
  ZSlab zs{nk, 0, nk, 0, 0, nk};
  if (slab)
    zs = ZSlab{slab_host[0], slab_host[1], slab_host[2],
               slab_host[3], slab_host[4], slab_host[5]};
  if (ni < 1 || nj < 1 || nk < 2 || zs.nko < 1 ||
      (maps != nullptr && zs.nkm < 2) ||
      3LL * ni * nj * nk >= limit || (long long)(ni + 1) * nj * nk >= limit ||
      (long long)ni * (nj + 1) * nk >= limit ||
      (long long)ni * nj * (nk + 1) >= limit ||
      3LL * ni * nj * zs.nko >= limit || 3LL * ni * nj * zs.nkm >= limit ||
      (bf16 && (slab || maps == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockK, kBlockJ, kBlockI);
  const dim3 grid((zs.nko + kBlockK - 1) / kBlockK,
                  (nj + kBlockJ - 1) / kBlockJ, (ni + kBlockI - 1) / kBlockI);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const Params P{sh, thresh, h, hi_host[0], hi_host[1], hi_host[2]};
  const auto st = (cudaStream_t)stream;
  const auto *fu = (const float*)u, *fv = (const float*)v,
             *fw = (const float*)w, *m = (const float*)maps;
  auto* o = (float*)out;
  auto* ov = (int*)overflow;
  if (bf16)
    launch<false, false>(grid, block, st, (const __nv_bfloat16*)u,
                         (const __nv_bfloat16*)v, (const __nv_bfloat16*)w, ni,
                         nj, nk, m, P, zs, ov, o);
  else if (maps == nullptr && slab)
    launch<true, true>(grid, block, st, fu, fv, fw, ni, nj, nk, m, P, zs, ov,
                       o);
  else if (maps == nullptr)
    launch<true, false>(grid, block, st, fu, fv, fw, ni, nj, nk, m, P, zs,
                        ov, o);
  else if (slab)
    launch<false, true>(grid, block, st, fu, fv, fw, ni, nj, nk, m, P, zs,
                        ov, o);
  else
    launch<false, false>(grid, block, st, fu, fv, fw, ni, nj, nk, m, P, zs,
                         ov, o);
  return (int)cudaGetLastError();
}
