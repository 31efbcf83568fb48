// trilerp_sample: C stacked float32 (or bfloat16) fields sampled at one
// position lattice.
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
// and writes C floats, and the field is read once from device memory when
// positions stay near their lattice site: about 5 x 67 MB at 256^3 with
// C=1, ~0.1 ms at 3.35 TB/s. The first design evaluated the dual form as
// 9 independent clamped trilerps: 72 gathers and 27 floor/fraction pairs
// a channel, every address in int64, and ran at 8x that bound, held by
// its loads and integer work rather than by device memory.
//
// The design here: one thread per output node, k fastest, so that the
// position loads and output stores coalesce; the C channels share the
// positions, and the per-axis weights while their offsets agree. Per
// axis the 9 samples use only 3 coordinates (g - 1/4, g, g + 1/4), each
// rounded as g + d in float32 exactly as before; their floors lie within
// B = floor(g - 1/4) and B + 1 (the spread is 1/2 < 1), so the floors,
// fractions and clamped node indices are taken once per axis (9 pairs, not
// 27) and each channel loads its clamped 3 x 3 x 3 neighbourhood
// clamp(B .. B+2) once: 27 loads, not 72. Clamping node by node yields the
// values the plain version reads, since it clamps each corner index the
// same way. The 8 corners of each sample are picked by selects on "this
// coordinate's floor is B + 1" with compile-time register indices (no
// dynamic indexing, so no local memory). Lerps that two samples share
// (same x coordinate and the same two nodes) are computed once: the
// x lerps for all 9 (j, k) node pairs of each x coordinate, the y lerps
// per (x, y) coordinate pair, then one z lerp per sample (gfs::axis3 and
// gfs::stencil9 in common.cuh, shared with vol9_fixup). Every lerp sees
// the operands of the plain version's x, then y, then z blend, the corners
// are summed in _VOL3 order and blended as 0.5*(acc/8) + 0.5*centre, and
// the library is built with -fmad=false: the result is bit-identical.
// Indices are int32: the wrapper raises unless C*nx*ny*nz and C*n_out are
// below 2^31 (every field up to 512^3 at C <= 4). The plain (dual=False)
// path loads the 2 x 2 x 2 corners of the centre only.
//
// The slab mode (the sharded path, parallel/sharded_interp.py): the field
// holds planes z0 .. z0 + nz - 1 of a grid of nzg planes (its own halo
// planes included), and the positions stay global. The float index, its
// floor and its weights are formed as above; each z node is clamped to
// [0, nzg - 1], and only then is z0 subtracted to address the slab
// (gfs::slab_node). A node outside the slab is clamped to the slab's edge,
// and each output node that used one adds 1 to *overflow. Nothing is
// rebased in float: (z - s) / h would round otherwise than z / h - s. With
// z0 = 0 and nzg = nz it is the whole-grid kernel, which is compiled
// apart (kSlab = false) and stays as it was.
//
// Measured (chip_smoke.py, H100, 256^3): the dual form is now held by
// instruction throughput, ~700 instructions an output channel, not by
// device memory: 0.40 ms at C=1 against its 0.10 ms bound (PERF.md,
// row 1).
//
// The bf16 mode (EngineMode.interp_bf16, the JAX package's bf16 field
// windows): the fields are bfloat16, each value widened to float32 at its
// load (gfs::load) and every operation after it the float32 kernel's, so
// the result is the float32 kernel's on the rounded fields, bit for bit.
// It is compiled apart (T = __nv_bfloat16), on the whole grid and in the
// slab mode (the sharded samplers of the bf16 mode: the JAX package's
// sample3_fast_sharded / sample3_multi_sharded pad bf16 windows per shard);
// the float32 instantiations stay as they were.
#include "common.cuh"

namespace {

constexpr int kMaxC = 4;
// A block samples a 32 x 2 x 2 box of the output lattice (k, j, i), so
// that its warps gather overlapping rows of the field through one L1;
// 128 threads a block: at the dual kernel's 72 registers, 7 blocks (28
// warps) fit an SM, against 3 blocks (24 warps) of 256
constexpr int kBlockK = 32, kBlockJ = 2, kBlockI = 2;

struct Offsets {
  float o[kMaxC][3];
};

// Channel c's offset on axis a, read at compile-time indices (a dynamic
// index would copy the argument to local memory).
__device__ __forceinline__ float offset(const Offsets& offs, int c, int a) {
  float o = offs.o[0][a];
#pragma unroll
  for (int q = 1; q < kMaxC; ++q) o = c == q ? offs.o[q][a] : o;
  return o;
}

using gfs::Axis;
using gfs::clamp_node;

// One axis of the dual stencil: the coordinates g - 1/4 (index 0), g (1)
// and g + 1/4 (2), each rounded as g + d in float32 (gfs::axis3).
__device__ __forceinline__ Axis make_axis(float g, int n, int stride) {
  const float c[3] = {g + (-0.25f), g, g + 0.25f};
  return gfs::axis3(c, n, (unsigned)stride);
}

// The dual volume sample of one channel from its 27-node neighbourhood:
// the 8 corners summed in _VOL3 order, blended with the centre.
template <typename T>
__device__ __forceinline__ float dual_sample(const T* __restrict__ f,
                                             const Axis& ax, const Axis& ay,
                                             const Axis& az) {
  float s[9];
  gfs::stencil9(f, ax, ay, az, s);
  float acc = s[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) acc = acc + s[q];
  return 0.5f * (acc / 8.0f) + 0.5f * s[8];
}

// Where a slab sits along z: the global extent and the slab's origin.
struct ZSlab {
  int nzg, z0;
};

// The clamped trilerp of gfs::trilerp_clamped with int32 offsets; on a slab
// (kSlab) the z corners are taken to it and `out` set where one left it.
template <bool kSlab, typename T>
__device__ __forceinline__ float trilerp32(const T* __restrict__ f,
                                           int nx, int ny, int nz, float gx,
                                           float gy, float gz, ZSlab zs,
                                           bool& out) {
  const float i0f = floorf(gx), j0f = floorf(gy), k0f = floorf(gz);
  const float fx = gx - i0f, fy = gy - j0f, fz = gz - k0f;
  const unsigned sx = ny * nz, sy = nz;
  const unsigned ia = clamp_node(i0f, nx) * sx;
  const unsigned ib = clamp_node(i0f + 1.0f, nx) * sx;
  const unsigned ja = clamp_node(j0f, ny) * sy;
  const unsigned jb = clamp_node(j0f + 1.0f, ny) * sy;
  unsigned ka, kb;
  if (kSlab) {
    ka = gfs::slab_node(clamp_node(k0f, zs.nzg), zs.z0, nz, out);
    kb = gfs::slab_node(clamp_node(k0f + 1.0f, zs.nzg), zs.z0, nz, out);
  } else {
    ka = clamp_node(k0f, nz);
    kb = clamp_node(k0f + 1.0f, nz);
  }
  const float v000 = gfs::load(f + (ia + ja + ka));
  const float v100 = gfs::load(f + (ib + ja + ka));
  const float v010 = gfs::load(f + (ia + jb + ka));
  const float v110 = gfs::load(f + (ib + jb + ka));
  const float v001 = gfs::load(f + (ia + ja + kb));
  const float v101 = gfs::load(f + (ib + ja + kb));
  const float v011 = gfs::load(f + (ia + jb + kb));
  const float v111 = gfs::load(f + (ib + jb + kb));
  const float c00 = (1.0f - fx) * v000 + fx * v100;
  const float c10 = (1.0f - fx) * v010 + fx * v110;
  const float c01 = (1.0f - fx) * v001 + fx * v101;
  const float c11 = (1.0f - fx) * v011 + fx * v111;
  const float c0 = (1.0f - fy) * c00 + fy * c10;
  const float c1 = (1.0f - fy) * c01 + fy * c11;
  return (1.0f - fz) * c0 + fz * c1;
}

template <bool kDual, bool kSlab, typename T>
__global__ void trilerp_sample_kernel(
    const T* __restrict__ fields, int C, int nx, int ny, int nz,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, int n_out, int d0, int d1, int d2,
    float h, Offsets offs, ZSlab zs, int* __restrict__ overflow,
    float* __restrict__ out) {
  // the output lattice is (d0, d1, d2), k = last index fastest; the bounds
  // are checked before the offset is formed, so it stays below n_out
  const int k = blockIdx.x * kBlockK + threadIdx.x;
  const int j = blockIdx.y * kBlockJ + threadIdx.y;
  const int i = blockIdx.z * kBlockI + threadIdx.z;
  if (k >= d2 || j >= d1 || i >= d0) return;
  const int idx = (i * d1 + j) * d2 + k;
  const int field_size = nx * ny * nz;
  const float x = __ldg(px + idx) / h, y = __ldg(py + idx) / h,
              z = __ldg(pz + idx) / h;
  Axis ax, ay, az;
  bool outside = false;
  for (int c = 0; c < C; ++c) {
    const T* f = fields + c * field_size;
    const float gx = x - offset(offs, c, 0);
    const float gy = y - offset(offs, c, 1);
    const float gz = z - offset(offs, c, 2);
    float res;
    if (kDual) {
      if (c == 0 || offset(offs, c, 0) != offset(offs, c - 1, 0) ||
          offset(offs, c, 1) != offset(offs, c - 1, 1) ||
          offset(offs, c, 2) != offset(offs, c - 1, 2)) {
        ax = make_axis(gx, nx, ny * nz);
        ay = make_axis(gy, ny, nz);
        if (kSlab) {
          const float cz[3] = {gz + (-0.25f), gz, gz + 0.25f};
          az = gfs::axis3_slab(cz, zs.nzg, zs.z0, nz, outside);
        } else {
          az = make_axis(gz, nz, 1);
        }
      }
      res = dual_sample(f, ax, ay, az);
    } else {
      res = trilerp32<kSlab>(f, nx, ny, nz, gx, gy, gz, zs, outside);
    }
    out[c * n_out + idx] = res;
  }
  if (kSlab && outside && overflow != nullptr)
    atomicAdd(overflow, 1);
}

template <bool kDual, bool kSlab, typename T>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const T* fields,
            int C, int nx, int ny, int nz, const float* px, const float* py,
            const float* pz, int n_out, int d0, int d1, int d2, float h,
            const Offsets& offs, ZSlab zs, int* overflow, float* out) {
  trilerp_sample_kernel<kDual, kSlab, T><<<grid, block, 0, stream>>>(
      fields, C, nx, ny, nz, px, py, pz, n_out, d0, d1, d2, h, offs, zs,
      overflow, out);
}

}  // namespace

// bf16 != 0: the fields are bfloat16, else float32.
// nzg == 0 selects the whole-grid kernel; else the field holds planes
// z0 .. z0 + nz - 1 of a grid of nzg planes, and each output node that
// used a z node outside them adds 1 to *overflow where that is not NULL.
extern "C" int gfs_trilerp_sample(const void* fields, int bf16, int C,
                                  int nx, int ny, int nz, const void* px,
                                  const void* py, const void* pz,
                                  long long n_out, int d1, int d2, float h,
                                  const float* offs_host, int dual, int nzg,
                                  int z0, void* overflow, void* out,
                                  void* stream) {
  const long long limit = 1LL << 31;
  const bool slab = nzg != 0;
  if (C < 1 || C > kMaxC || n_out < 1 || d1 < 1 || d2 < 1 ||
      n_out % ((long long)d1 * d2) != 0 ||
      (long long)C * nx * ny * nz >= limit || (long long)C * n_out >= limit ||
      (slab && nzg < 1))
    return (int)cudaErrorInvalidValue;
  const long long d0 = n_out / ((long long)d1 * d2);
  const dim3 block(kBlockK, kBlockJ, kBlockI);
  const dim3 grid((d2 + kBlockK - 1) / kBlockK, (d1 + kBlockJ - 1) / kBlockJ,
                  (unsigned int)((d0 + kBlockI - 1) / kBlockI));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  Offsets offs;
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < 3; ++a) offs.o[c][a] = offs_host[3 * c + a];
  const ZSlab zs{nzg, z0};
  const auto st = (cudaStream_t)stream;
  const auto* f = (const float*)fields;
  const auto *x = (const float*)px, *y = (const float*)py,
             *z = (const float*)pz;
  auto* o = (float*)out;
  auto* ov = (int*)overflow;
  if (bf16) {
    const auto* fb = (const __nv_bfloat16*)fields;
    if (dual && slab)
      launch<true, true>(grid, block, st, fb, C, nx, ny, nz, x, y, z,
                         (int)n_out, (int)d0, d1, d2, h, offs, zs, ov, o);
    else if (dual)
      launch<true, false>(grid, block, st, fb, C, nx, ny, nz, x, y, z,
                          (int)n_out, (int)d0, d1, d2, h, offs, zs, ov, o);
    else if (slab)
      launch<false, true>(grid, block, st, fb, C, nx, ny, nz, x, y, z,
                          (int)n_out, (int)d0, d1, d2, h, offs, zs, ov, o);
    else
      launch<false, false>(grid, block, st, fb, C, nx, ny, nz, x, y, z,
                           (int)n_out, (int)d0, d1, d2, h, offs, zs, ov, o);
  } else if (dual && slab)
    launch<true, true>(grid, block, st, f, C, nx, ny, nz, x, y, z,
                       (int)n_out, (int)d0, d1, d2, h, offs, zs, ov, o);
  else if (dual)
    launch<true, false>(grid, block, st, f, C, nx, ny, nz, x, y, z,
                        (int)n_out, (int)d0, d1, d2, h, offs, zs, ov, o);
  else if (slab)
    launch<false, true>(grid, block, st, f, C, nx, ny, nz, x, y, z,
                        (int)n_out, (int)d0, d1, d2, h, offs, zs, ov, o);
  else
    launch<false, false>(grid, block, st, f, C, nx, ny, nz, x, y, z,
                         (int)n_out, (int)d0, d1, d2, h, offs, zs, ov, o);
  return (int)cudaGetLastError();
}
