// bilerp_sample: clamped bilinear samples of C 2D float32 fields at one
// set of world positions, and the 2D MAC velocity with its band mask.
//
// Replaces the TPU kernel gpufluidsimulation_tpu/ops/interp_fast.py
// _kernel (pallas_call in _sample3_padded) as the 2D solver reaches it:
// sample2_fast and mac2_fast lift each 2D field onto a singleton x axis
// and run the 3D windowed sampler on it. Here the 2D function is computed
// directly, per output position p and channel c with static offset off_c
// (units of h):
//   g = p / h - off_c                      (IEEE division)
//   i0 = floor(g), f = g - i0, corners i0 and i0 + 1 clamped on their own
//   out = (1-fy)*((1-fx)*v00 + fx*v10) + fy*((1-fx)*v01 + fx*v11)
// which is gpufluidsimulation_tpu.core.interp.sample2 operation for
// operation (the library is built with -fmad=false, so every product and
// sum rounds as in the plain PyTorch version). In the mac mode channel 0
// is u (ni+1, nj) at offset (0, 0.5) and channel 1 is v (ni, nj+1) at
// (0.5, 0); a sample whose float floors leave the band of
// interp.mac_velocity_2d (u: i0 in [0, ni-1], j0 in [0, nj-2]; v: i0 in
// [0, ni-2], j0 in [0, nj-1]) is 0, not clamped.
//
// Design: one thread per output position, all C channels in that thread,
// so that the two position loads and the divisions by h are made once and
// the floors and weights once for each run of channels that share an
// offset (the callers stack fields sampled at the same positions: a map's
// x and y, init and the accumulated change, u's and v's of a trace stage).
// A corner reads 4 values, not the 8 of the lifted 3D window. The output
// is written channel-major, (C, n_out), so that every store coalesces.
// Offsets are unsigned 32-bit: the wrapper raises unless each field and
// C * n_out hold fewer than 2^31 values.
#include "common.cuh"

namespace {

constexpr int kMaxC = 4;
constexpr int kThreads = 256;

// Per-channel field pointer, extents, offset and (mac mode) band: a
// sample is kept where 0 <= floor(gx) <= bx and 0 <= floor(gy) <= by.
struct Channels {
  const float* f[kMaxC];
  int nx[kMaxC], ny[kMaxC];
  float ox[kMaxC], oy[kMaxC];
  float bx[kMaxC], by[kMaxC];
};

using gfs::clamp_node;

template <bool kMac>
__global__ void __launch_bounds__(kThreads)
    bilerp_sample_kernel(Channels ch, int C, const float* __restrict__ px,
                         const float* __restrict__ py, unsigned n_out,
                         float h, float* __restrict__ out) {
  const unsigned idx = blockIdx.x * (unsigned)kThreads + threadIdx.x;
  if (idx >= n_out) return;
  const float x = __ldg(px + idx) / h;
  const float y = __ldg(py + idx) / h;
  float fx = 0.0f, fy = 0.0f, wx = 1.0f, wy = 1.0f, i0f = 0.0f, j0f = 0.0f;
  // the channel loop is unrolled, so every Channels member is read at a
  // compile-time index (no copy of the argument to local memory)
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= C) break;
    const int p = c > 0 ? c - 1 : 0;
    if (c == 0 || ch.ox[c] != ch.ox[p] || ch.oy[c] != ch.oy[p]) {
      const float gx = x - ch.ox[c];
      const float gy = y - ch.oy[c];
      i0f = floorf(gx);
      j0f = floorf(gy);
      fx = gx - i0f;
      fy = gy - j0f;
      wx = 1.0f - fx;
      wy = 1.0f - fy;
    }
    const int nx = ch.nx[c], ny = ch.ny[c];
    const unsigned ia = clamp_node(i0f, nx) * (unsigned)ny;
    const unsigned ib = clamp_node(i0f + 1.0f, nx) * (unsigned)ny;
    const unsigned ja = clamp_node(j0f, ny);
    const unsigned jb = clamp_node(j0f + 1.0f, ny);
    const float* f = ch.f[c];
    const float v00 = __ldg(f + (ia + ja));
    const float v10 = __ldg(f + (ib + ja));
    const float v01 = __ldg(f + (ia + jb));
    const float v11 = __ldg(f + (ib + jb));
    float r = wy * (wx * v00 + fx * v10) + fy * (wx * v01 + fx * v11);
    if (kMac) {
      const bool valid = i0f >= 0.0f && i0f <= ch.bx[c] && j0f >= 0.0f &&
                         j0f <= ch.by[c];
      r = valid ? r : 0.0f;
    }
    out[(unsigned)c * n_out + idx] = r;
  }
}

}  // namespace

// fields[c]: C field pointers with extents dims[2c], dims[2c+1] and
// offsets offs[2c], offs[2c+1]; bands (2C values, or null for the sample
// mode) switches on the mac mode's mask.
extern "C" int gfs_bilerp_sample(const void* const* fields, const int* dims,
                                 const float* offs, const float* bands,
                                 int C, const void* px, const void* py,
                                 long long n_out, float h, void* out,
                                 void* stream) {
  const long long limit = 1LL << 31;
  if (C < 1 || C > kMaxC || n_out < 1 || (long long)C * n_out >= limit)
    return (int)cudaErrorInvalidValue;
  Channels ch;
  for (int c = 0; c < kMaxC; ++c) {
    const int s = c < C ? c : 0;
    ch.f[c] = (const float*)fields[s];
    ch.nx[c] = dims[2 * s];
    ch.ny[c] = dims[2 * s + 1];
    if (ch.nx[c] < 1 || ch.ny[c] < 1 ||
        (long long)ch.nx[c] * ch.ny[c] >= limit)
      return (int)cudaErrorInvalidValue;
    ch.ox[c] = offs[2 * s];
    ch.oy[c] = offs[2 * s + 1];
    ch.bx[c] = bands ? bands[2 * s] : 0.0f;
    ch.by[c] = bands ? bands[2 * s + 1] : 0.0f;
  }
  const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  if (bands)
    bilerp_sample_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ch, C, (const float*)px, (const float*)py, (unsigned)n_out, h,
        (float*)out);
  else
    bilerp_sample_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ch, C, (const float*)px, (const float*)py, (unsigned)n_out, h,
        (float*)out);
  return (int)cudaGetLastError();
}
