// rk3_substep: one Ralston RK3 substep of the characteristic trace.
//
// Replaces the TPU kernels gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel_rk3 / _kernel_rk3_twotier (pallas_call in _rk3_padded) and the
// identity-start peel _kernel_rk3_ident (pallas_call in _rk3_padded_ident).
// Positions are cell-lattice grid coordinates g = p/h, stacked (3, n).
// With the MAC velocity vel(g) sampled on the staggered u/v/w lattices:
//   k1 = vel(g); k2 = vel(g + a*k1); k3 = vel(g + b*k2)
//   g' = clamp(g + c1*k1 + c2*k2 + c3*k3, [lo, hi] per axis)
// where a = sh/2, b = 3sh/4, c1..c3 = (2/9, 3/9, 4/9)*sh and sh is the
// signed substep over h (advect.trace_rk3_3d in grid units, the fused
// kernels' arithmetic order). The lattice mode (_kernel_rk3_ident) reads
// no positions: node (i, j, k) of the (ni, nj, nk) cell block starts at
// (i - 0.5*dim_x, j - 0.5*dim_y, k - 0.5*dim_z), exact in float32 and the
// bits of advect._cropped_positions for the kind with face vector dim.
//
// What bounds it on the H100: bytes, ~0.18 ms at 256^3 (3 position floats
// read and 3 written a node, the velocity triplet read once; 0.12 ms from
// the lattice). The first design called gfs::trilerp_clamped nine times a
// node (3 stages x u, v, w): each call floored its own three coordinates,
// clamped six indices and formed eight 64-bit offsets, in a grid-stride
// loop over an int64 index; it ran at 4-6x the bound, held by instruction
// throughput (an estimate from the source: ~800 instructions a node).
//
// The design here: one thread per node on a (k, j, i) block of the node
// lattice, k fastest, so that position loads and output stores coalesce and
// a block's gathers share rows of the faces through L1. At one stage the
// three components sample at (gx+1/2, gy, gz), (gx, gy+1/2, gz) and
// (gx, gy, gz+1/2): per axis the two coordinates g and g + 1/2 (the same
// float32 add as the plain version's mac_velocity_grid) are floored once,
// with their fraction and 1 - f, and each component takes its corners from
// those: 6 floor/weight sets a stage instead of 9. Each component still
// clamps to its own extent: the coordinate g + 1/2 of the staggered axis
// to n + 1 nodes, g to n. Along z, the innermost axis, the corners are
// loaded as the pair (lo, lo + 1) with lo = clamp(floor(g), 0, n - 2), two
// loads from one address; where the plain version's clamped corners
// coincide (floor(g) <= -1: both 0; floor(g) >= n - 1: both n - 1), the
// pair's lerped value at that node is taken for both after the x and y
// lerps, which are the same operations on the same values, so the same
// bits. That halves the address arithmetic of the gathers and needs
// n >= 2 along z (the wrapper raises for nk < 2); gfs::coord, gfs::zpair
// and gfs::trilerp_zpair in common.cuh, shared with dmc_substep and
// vol9_fixup. Offsets are unsigned 32-bit (the wrapper raises unless each
// face and n are below 2^31). Each blend keeps the plain version's
// operands and its x, then y, then z order, and the library is built with
// -fmad=false: the result is bit-identical.
//
// The slab mode (the sharded map march, parallel/sharded_interp.py): the
// faces hold the cell planes vz0 .. vz0 + nk - 1 of a grid of nkg cells
// (u and v nk planes, w nk + 1), and positions stay global grid
// coordinates. Each z node is clamped to the global bounds (nkg - 1 for u
// and v, nkg for w), then vz0 is subtracted to address the slab
// (gfs::zpair_slab); a node outside the slab is clamped to its edge and
// each node that used one adds 1 to *overflow. In the lattice mode node
// (i, j, k) of the output slab is global plane k + oz0. Nothing is rebased
// in float. With vz0 = oz0 = 0 and nkg = nk it is the whole-grid kernel,
// which is compiled apart (kSlab = false) and stays as it was.
//
// Measured (scripts/kernel_variants.py, H100, 256^3): the shared sets
// took 0.70 to 0.52 ms, the z pairs to 0.46, the 64-register cap (no
// spill) to 0.46 from displaced positions and 0.43 from the lattice;
// block shapes move it by 2%, a velocity tile staged in shared memory is
// 4x slower. The kernel stays bound by instruction throughput (~700 SASS
// instructions a node, 72 gathers among them): 2.5-3.5x its bytes bound
// (PERF.md, rows 5-6).
//
// The bf16 mode (EngineMode.interp_bf16, the JAX package's bf16 MAC pack):
// the faces every velocity sample reads are bfloat16, widened to float32 at
// each load (gfs::load), all arithmetic after it float32. In the lattice
// mode the first stage is the exception: the JAX identity peel takes its
// stage-1 velocity k1 from the unrounded faces (a float32 block input), so
// stage 1 reads the float32 faces (F1) and stages 2 and 3 the bfloat16
// ones. Compiled apart (T = __nv_bfloat16), whole grid only; the float32
// instantiations stay as they were.
#include <type_traits>

#include "common.cuh"

namespace {

// A block covers 32 x 4 x 1 nodes (k, j, i): 128 threads, at most 64
// registers a thread (8 blocks an SM)
constexpr int kBlockK = 32, kBlockJ = 4, kBlockI = 1;
constexpr int kMinBlocks = 8;
// the slab mode's extra clamps get a little more room (80 registers), so
// that neither mode spills
constexpr int kMinBlocksSlab = 6;

using gfs::Coord;
using gfs::coord;
using gfs::trilerp_zpair;
using gfs::ZPair;
using gfs::zpair;

// The MAC faces of an (ni, nj, nk) grid: u (ni+1, nj, nk), v (ni, nj+1,
// nk), w (ni, nj, nk+1), k-fastest, stored as T.
template <typename T>
struct Faces {
  const T* __restrict__ u;
  const T* __restrict__ v;
  const T* __restrict__ w;
  int ni, nj, nk;
};

// Where the faces sit along z (the slab mode): the grid's cell extent, the
// faces' first cell plane and the output slab's first plane.
struct ZSlab {
  int nkg, vz0, oz0;
};

// The MAC velocity at cell-lattice grid coordinates g = p/h: each
// staggered component's own lattice sits half a cell lower on its axis.
template <bool kSlab, typename T>
__device__ __forceinline__ void mac_velocity(const Faces<T>& F,
                                             const ZSlab& zs,
                                             float gx, float gy, float gz,
                                             float* ou, float* ov, float* ow,
                                             bool& out) {
  const Coord x0 = coord(gx, F.ni), x1 = coord(gx + 0.5f, F.ni + 1);
  const Coord y0 = coord(gy, F.nj), y1 = coord(gy + 0.5f, F.nj + 1);
  ZPair z0, z1;
  if (kSlab) {
    z0 = gfs::zpair_slab(gz, zs.nkg, zs.vz0, F.nk, out);
    z1 = gfs::zpair_slab(gz + 0.5f, zs.nkg + 1, zs.vz0, F.nk + 1, out);
  } else {
    z0 = zpair(gz, F.nk);
    z1 = zpair(gz + 0.5f, F.nk + 1);
  }
  const unsigned nj = F.nj, nk = F.nk;
  *ou = trilerp_zpair(F.u, x1, y0, z0, nj * nk, nk);
  *ov = trilerp_zpair(F.v, x0, y1, z0, (nj + 1) * nk, nk);
  *ow = trilerp_zpair(F.w, x0, y0, z1, nj * (nk + 1), nk + 1);
}

struct Params {
  float a, b, c1, c2, c3;
  float lox, hix, loy, hiy, loz, hiz;
  float dimx, dimy, dimz;   // the lattice mode's face vector (0 or 1)
};

// kLattice: start at the node's own lattice coordinate; else read it.
// kSlab: the faces are a slab of the grid (zs). T: the faces' storage; with
// bfloat16 faces the lattice mode's stage 1 reads the float32 faces F1.
template <bool kLattice, bool kSlab, typename T>
__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI,
                                  kSlab ? kMinBlocksSlab : kMinBlocks)
    rk3_substep_kernel(Faces<T> F, Faces<float> F1,
                       const float* __restrict__ px,
                       const float* __restrict__ py,
                       const float* __restrict__ pz, int d0, int d1, int d2,
                       Params P, ZSlab zs, int* __restrict__ overflow,
                       float* __restrict__ ox, float* __restrict__ oy,
                       float* __restrict__ oz) {
  const int k = blockIdx.x * kBlockK + threadIdx.x;
  const int j = blockIdx.y * kBlockJ + threadIdx.y;
  const int i = blockIdx.z * kBlockI + threadIdx.z;
  if (k >= d2 || j >= d1 || i >= d0) return;
  const int idx = (i * d1 + j) * d2 + k;
  float gx, gy, gz;
  if (kLattice) {
    gx = (float)i - 0.5f * P.dimx;
    gy = (float)j - 0.5f * P.dimy;
    gz = (float)(kSlab ? k + zs.oz0 : k) - 0.5f * P.dimz;
  } else {
    gx = __ldg(px + idx);
    gy = __ldg(py + idx);
    gz = __ldg(pz + idx);
  }
  float u1, v1, w1, u2, v2, w2, u3, v3, w3;
  bool outside = false;
  if (kLattice && !std::is_same<T, float>::value)
    mac_velocity<kSlab>(F1, zs, gx, gy, gz, &u1, &v1, &w1, outside);
  else
    mac_velocity<kSlab>(F, zs, gx, gy, gz, &u1, &v1, &w1, outside);
  mac_velocity<kSlab>(F, zs, gx + P.a * u1, gy + P.a * v1, gz + P.a * w1,
                      &u2, &v2, &w2, outside);
  mac_velocity<kSlab>(F, zs, gx + P.b * u2, gy + P.b * v2, gz + P.b * w2,
                      &u3, &v3, &w3, outside);
  const float rx = gx + P.c1 * u1 + P.c2 * u2 + P.c3 * u3;
  const float ry = gy + P.c1 * v1 + P.c2 * v2 + P.c3 * v3;
  const float rz = gz + P.c1 * w1 + P.c2 * w2 + P.c3 * w3;
  ox[idx] = fminf(fmaxf(rx, P.lox), P.hix);
  oy[idx] = fminf(fmaxf(ry, P.loy), P.hiy);
  oz[idx] = fminf(fmaxf(rz, P.loz), P.hiz);
  if (kSlab && outside && overflow != nullptr)
    atomicAdd(overflow, 1);
}

template <bool kLattice, bool kSlab, typename T>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const Faces<T>& F,
            const Faces<float>& F1, const float* p, int d0, int d1, int d2,
            const Params& P, ZSlab zs, int* overflow, float* o, long long n) {
  const float* px = kLattice ? nullptr : p;
  const float* py = kLattice ? nullptr : p + n;
  const float* pz = kLattice ? nullptr : p + 2 * n;
  rk3_substep_kernel<kLattice, kSlab, T><<<grid, block, 0, stream>>>(
      F, F1, px, py, pz, d0, d1, d2, P, zs, overflow, o, o + n, o + 2 * n);
}

}  // namespace

// bf16 != 0: u, v, w are bfloat16 (whole grid only), and the lattice
// mode's stage 1 reads the float32 faces u1, v1, w1; else u, v, w are
// float32 and u1, v1, w1 are not read.
// pos == NULL selects the lattice mode: the (d0, d1, d2) block of the
// kind whose face vector is dim_host, (ni, nj, nk) on the whole grid.
// nkg == 0 selects the whole-grid kernel; else the faces hold the cell
// planes vz0 .. vz0 + nk - 1 of a grid of nkg cells, the lattice mode's
// block starts at global plane oz0, and each node that used a z node
// outside the faces' planes adds 1 to *overflow where that is not NULL.
extern "C" int gfs_rk3_substep(const void* u, const void* v, const void* w,
                               int bf16, const void* u1, const void* v1,
                               const void* w1, int ni, int nj, int nk,
                               const void* pos,
                               int d0, int d1, int d2, const float* dim_host,
                               float a, float b, float c1, float c2,
                               float c3, const float* clamp_host, int nkg,
                               int vz0, int oz0, void* overflow, void* out,
                               void* stream) {
  const long long limit = 1LL << 31;
  const long long n = (long long)d0 * d1 * d2;
  const bool slab = nkg != 0;
  if (ni < 1 || nj < 1 || nk < 2 || d0 < 1 || d1 < 1 || d2 < 1 ||
      n >= limit || (long long)(ni + 1) * nj * nk >= limit ||
      (long long)ni * (nj + 1) * nk >= limit ||
      (long long)ni * nj * (nk + 1) >= limit ||
      (slab && nkg < 2) || (bf16 && slab) ||
      (bf16 && pos == nullptr && (!u1 || !v1 || !w1)))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockK, kBlockJ, kBlockI);
  const dim3 grid((d2 + kBlockK - 1) / kBlockK, (d1 + kBlockJ - 1) / kBlockJ,
                  (d0 + kBlockI - 1) / kBlockI);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const Faces<float> F{(const float*)u, (const float*)v, (const float*)w,
                       ni, nj, nk};
  const Faces<float> F1{(const float*)u1, (const float*)v1, (const float*)w1,
                        ni, nj, nk};
  const Params P{a, b, c1, c2, c3,
                 clamp_host[0], clamp_host[1], clamp_host[2], clamp_host[3],
                 clamp_host[4], clamp_host[5],
                 dim_host[0], dim_host[1], dim_host[2]};
  const ZSlab zs{nkg, vz0, oz0};
  const auto st = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  float* o = (float*)out;
  int* ov = (int*)overflow;
  if (bf16) {
    const Faces<__nv_bfloat16> B{(const __nv_bfloat16*)u,
                                 (const __nv_bfloat16*)v,
                                 (const __nv_bfloat16*)w, ni, nj, nk};
    if (pos == nullptr)
      launch<true, false>(grid, block, st, B, F1, p, d0, d1, d2, P, zs, ov,
                          o, n);
    else
      launch<false, false>(grid, block, st, B, F1, p, d0, d1, d2, P, zs, ov,
                           o, n);
  } else if (pos == nullptr && slab) {
    launch<true, true>(grid, block, st, F, F, p, d0, d1, d2, P, zs, ov, o, n);
  } else if (pos == nullptr) {
    launch<true, false>(grid, block, st, F, F, p, d0, d1, d2, P, zs, ov, o,
                        n);
  } else if (slab) {
    launch<false, true>(grid, block, st, F, F, p, d0, d1, d2, P, zs, ov, o,
                        n);
  } else {
    launch<false, false>(grid, block, st, F, F, p, d0, d1, d2, P, zs, ov, o,
                         n);
  }
  return (int)cudaGetLastError();
}
