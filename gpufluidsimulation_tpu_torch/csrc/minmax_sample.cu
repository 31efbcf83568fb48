// minmax_sample: min and max of the 8 trilinear corner values of C stacked
// float32 fields at one position lattice, and in its sample mode also the
// clamped trilinear sample from those corners.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel_minmax (pallas_call in _minmax3_padded, entry minmax3_fast), the
// MacCormack scalar trace clamp. Computes, per output node and channel c
// with static offset off_c (units of h):
//   g = p / h - off_c,  i0 = floor(g) per axis,
//   corners (i0|i0+1, j0|j0+1, k0|k0+1), each index clamped to [0, n-1],
//   mn = min over the 8 corner values, mx = max over them,
//   sample mode: s = the x, then y, then z blend of the 8 corners
// which is the exact-gather clamp of gpufluidsimulation_tpu.ops.advect
// maccormack_multi_3d (interp._gather8_3d, then min/max over the corners)
// and, for s, trilerp_sample's plain trilinear at the same positions: the
// fallback that the trace clamp takes where the MacCormack correction
// leaves [mn, mx]. The JAX package computes that fallback in a second
// pass (its kernel is a window kernel). The TPU kernel drops a corner
// whose hat weight rounds to 0; this kernel, like the exact gathers,
// always takes all 8.
//
// What bounds it on the H100: bytes. Each output node reads 3 position
// floats and writes 2*C floats (3*C with the sample); the fields' corner
// reads hit L1/L2 when positions stay near their lattice site. At 256^3
// with C=2 that is 9 x 67 MB, ~0.18 ms at 3.35 TB/s (11 x 67 MB, ~0.22
// ms, with the sample, against the 14 x 67 MB of the min/max and a
// separate trilerp_sample launch). The first port ran at twice that bound,
// held by instruction issue: a grid-stride loop over a 64-bit index, and
// per channel its own floors, six clamps and eight 64-bit corner offsets.
//
// The design here: one thread per output node on 32 x 4 x 1 (k, j, i)
// blocks, k fastest, so that the position loads and the output stores
// coalesce. p / h is divided once per axis. Where every channel has the
// same offset (the trace clamp's only case) the floors, fractions, clamped
// nodes and corner offsets are formed once, at channel 0 (kShared);
// otherwise per channel. The z corners are loaded as the pair (lo, lo + 1),
// lo = clamp(floor(g), 0, n - 2) (gfs::zpair, which needs n >= 2 along z:
// the wrapper raises), and where the plain version's two clamped z
// corners coincide (floor(g) <= -1 or >= n - 1) only the pair's node that
// they clamp to enters the min and the max. min and max are exact in any
// order for finite values. The sample blends the same 8 corners as
// gfs::trilerp_zpair does, with the plain version's operands and order,
// built with -fmad=false: every output is bit-identical. Offsets are
// unsigned 32-bit (the wrapper raises unless C*nx*ny*nz and C*n_out are
// below 2^31).
//
// Measured (scripts/kernel_variants.py, H100, 256^3, C=2, the first port
// timed in the same rounds): 0.361 -> 0.247 ms, 1.37x the bound; the
// sample mode 0.306 ms where the min/max and trilerp_sample's C=2 sample
// took 0.457 in two launches. Per-channel floors cost 6%, eight corner
// loads 4%, a 32 x 2 x 2 block 1% (PERF.md, row 3).
//
// The bf16 mode (EngineMode.interp_bf16, the JAX package's bf16 field
// windows), both modes: the fields are bfloat16, each value widened to
// float32 at its load (gfs::load), so the min, the max and the sample are
// the float32 kernel's of the rounded fields, bit for bit. Compiled apart
// (T = __nv_bfloat16); the float32 instantiations stay as they were.
#include "common.cuh"

namespace {

constexpr int kMaxC = 4;
constexpr int kBlockK = 32, kBlockJ = 4, kBlockI = 1;

struct Offsets {
  float o[kMaxC][3];
};

using gfs::Coord;
using gfs::coord;
using gfs::Corners;
using gfs::ZPair;
using gfs::zpair;

template <bool kShared, bool kSample, typename T>
__global__ void __launch_bounds__(kBlockK * kBlockJ * kBlockI)
    minmax_sample_kernel(const T* __restrict__ fields, int C, int nx,
                         int ny, int nz, const float* __restrict__ px,
                         const float* __restrict__ py,
                         const float* __restrict__ pz, int d0, int d1, int d2,
                         float h, Offsets offs, float* __restrict__ mn_out,
                         float* __restrict__ mx_out,
                         float* __restrict__ sample_out) {
  // the output lattice is (d0, d1, d2), k = last index fastest
  const int k = blockIdx.x * kBlockK + threadIdx.x;
  const int j = blockIdx.y * kBlockJ + threadIdx.y;
  const int i = blockIdx.z * kBlockI + threadIdx.z;
  if (k >= d2 || j >= d1 || i >= d0) return;
  const unsigned n_out = (unsigned)d0 * d1 * d2;
  const unsigned idx = ((unsigned)i * d1 + j) * d2 + k;
  const unsigned sy = nz, sx = (unsigned)ny * nz, field_size = sx * nx;
  const float x = __ldg(px + idx) / h, y = __ldg(py + idx) / h,
              z = __ldg(pz + idx) / h;
  Coord cx, cy;
  ZPair cz;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= C) break;
    if (c == 0 || !kShared) {
      cx = coord(x - offs.o[c][0], nx);
      cy = coord(y - offs.o[c][1], ny);
      cz = zpair(z - offs.o[c][2], nz);
    }
    const Corners v =
        gfs::corners_zpair(fields + c * field_size, cx, cy, cz, sx, sy);
    float lo[2], hi[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      lo[p] = fminf(fminf(v.v[0][p], v.v[1][p]), fminf(v.v[2][p], v.v[3][p]));
      hi[p] = fmaxf(fmaxf(v.v[0][p], v.v[1][p]), fmaxf(v.v[2][p], v.v[3][p]));
    }
    const unsigned o = c * n_out + idx;
    mn_out[o] = cz.top ? lo[1] : (cz.bottom ? lo[0] : fminf(lo[0], lo[1]));
    mx_out[o] = cz.top ? hi[1] : (cz.bottom ? hi[0] : fmaxf(hi[0], hi[1]));
    if (kSample) sample_out[o] = gfs::blend_zpair(v, cx, cy, cz);
  }
}

// One launch of the instantiation for T, shared offsets and the sample.
template <typename T>
void launch(const T* fields, bool shared, bool sample, dim3 grid, dim3 block,
            cudaStream_t stream, int C, int nx, int ny, int nz,
            const float* px, const float* py, const float* pz, int d0, int d1,
            int d2, float h, const Offsets& offs, float* mn, float* mx,
            float* sample_out) {
  const auto kernel =
      shared ? (sample ? minmax_sample_kernel<true, true, T>
                       : minmax_sample_kernel<true, false, T>)
             : (sample ? minmax_sample_kernel<false, true, T>
                       : minmax_sample_kernel<false, false, T>);
  kernel<<<grid, block, 0, stream>>>(fields, C, nx, ny, nz, px, py, pz, d0,
                                     d1, d2, h, offs, mn, mx, sample_out);
}

}  // namespace

// bf16 != 0: the fields are bfloat16, else float32. sample: null, or where
// the C trilinear samples go (the sample mode).
extern "C" int gfs_minmax_sample(const void* fields, int bf16, int C,
                                 int nx, int ny, int nz, const void* px,
                                 const void* py,
                                 const void* pz, long long n_out, int d1,
                                 int d2, float h, const float* offs_host,
                                 void* mn, void* mx, void* sample,
                                 void* stream) {
  const long long limit = 1LL << 31;
  if (C < 1 || C > kMaxC || nz < 2 || n_out < 1 || d1 < 1 || d2 < 1 ||
      n_out % ((long long)d1 * d2) != 0 ||
      (long long)C * nx * ny * nz >= limit || (long long)C * n_out >= limit)
    return (int)cudaErrorInvalidValue;
  const long long d0 = n_out / ((long long)d1 * d2);
  const dim3 block(kBlockK, kBlockJ, kBlockI);
  const dim3 grid((d2 + kBlockK - 1) / kBlockK, (d1 + kBlockJ - 1) / kBlockJ,
                  (unsigned int)((d0 + kBlockI - 1) / kBlockI));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  Offsets offs;
  bool shared = true;
  for (int c = 0; c < C; ++c)
    for (int a = 0; a < 3; ++a) {
      offs.o[c][a] = offs_host[3 * c + a];
      shared = shared && offs.o[c][a] == offs.o[0][a];
    }
  if (bf16)
    launch((const __nv_bfloat16*)fields, shared, sample != nullptr, grid,
           block, (cudaStream_t)stream, C, nx, ny, nz, (const float*)px,
           (const float*)py, (const float*)pz, (int)d0, d1, d2, h, offs,
           (float*)mn, (float*)mx, (float*)sample);
  else
    launch((const float*)fields, shared, sample != nullptr, grid, block,
           (cudaStream_t)stream, C, nx, ny, nz, (const float*)px,
           (const float*)py, (const float*)pz, (int)d0, d1, d2, h, offs,
           (float*)mn, (float*)mx, (float*)sample);
  return (int)cudaGetLastError();
}
