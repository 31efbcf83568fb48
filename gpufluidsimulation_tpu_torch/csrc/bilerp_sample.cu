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
// (0.5, 0), and channels 2 and 3 a second pair on the same lattices
// (FLIP's grid change du, dv); a sample whose float floors leave the band of
// interp.mac_velocity_2d (u: i0 in [0, ni-1], j0 in [0, nj-2]; v: i0 in
// [0, ni-2], j0 in [0, nj-1]) is 0, not clamped.
//
// The cp mode computes calculateCp (gpufluidsimulation_tpu.solvers.
// particles.calculate_cp, XLA in the JAX package: APIC's and PolyPIC's
// grid-to-particle fit) of up to 4 fields of their own shapes, offsets
// and bands at one set of positions: with px = (g - i0)*h and py alike,
// a = h - px, b = h - py and the 4 clamped corners of the cell,
//   c0 = (a*b*f00 + px*b*f10 + px*py*f11 + a*py*f01) / hh
//   c1 = (-b*f00 + b*f10 + py*f11 - py*f01) / hh
//   c2 = (-a*f00 - px*f10 + px*f11 + a*f01) / hh
//   c3 = (f00 - f10 + f11 - f01) / hh
// summed left to right, hh = h*h rounded once to float32, and all four 0
// where the cell's floors leave the field's band [0, bx] x [0, by]. The
// output is (C, n_out, 4), one 16-byte store a channel and position.
//
// Design: one thread per output position, all C channels in that thread,
// so that the two position loads and the divisions by h are made once and
// the floors and weights once for each run of channels that share an
// offset (the callers stack fields sampled at the same positions: a map's
// x and y, init and the accumulated change, u's and v's of a trace stage).
// A corner reads 4 values, not the 8 of the lifted 3D window. The output
// is written channel-major, (C, n_out), so that every store coalesces.
// Offsets are unsigned 32-bit: the wrapper raises unless each field and
// the output (C * n_out values, 4 C * n_out in the cp mode) hold fewer
// than 2^31 values.
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

enum Mode { kSample = 0, kMac = 1, kCp = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    bilerp_sample_kernel(Channels ch, int C, const float* __restrict__ px,
                         const float* __restrict__ py, unsigned n_out,
                         float h, float hh, float* __restrict__ out) {
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
    const bool valid = i0f >= 0.0f && i0f <= ch.bx[c] && j0f >= 0.0f &&
                       j0f <= ch.by[c];
    if (kMode == kCp) {
      const float qx = fx * h, qy = fy * h;
      const float a = h - qx, b = h - qy;
      float4 r;
      r.x = (a * b * v00 + qx * b * v10 + qx * qy * v11 + a * qy * v01) / hh;
      r.y = (-b * v00 + b * v10 + qy * v11 - qy * v01) / hh;
      r.z = (-a * v00 - qx * v10 + qx * v11 + a * v01) / hh;
      r.w = (v00 - v10 + v11 - v01) / hh;
      if (!valid) r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      reinterpret_cast<float4*>(out)[(unsigned)c * n_out + idx] = r;
    } else {
      float r = wy * (wx * v00 + fx * v10) + fy * (wx * v01 + fx * v11);
      if (kMode == kMac) r = valid ? r : 0.0f;
      out[(unsigned)c * n_out + idx] = r;
    }
  }
}

}  // namespace

// fields[c]: C field pointers with extents dims[2c], dims[2c+1] and
// offsets offs[2c], offs[2c+1]; mode 0 samples, 1 is the mac mode and 2
// the cp mode, both with the bands (2C values) that mode 0 takes as null;
// hh is h*h rounded to float32 (the cp mode's divisor).
extern "C" int gfs_bilerp_sample(const void* const* fields, const int* dims,
                                 const float* offs, const float* bands,
                                 int C, int mode, const void* px,
                                 const void* py, long long n_out, float h,
                                 float hh, void* out, void* stream) {
  const long long limit = 1LL << 31;
  const long long per = mode == kCp ? 4 : 1;
  if (C < 1 || C > kMaxC || n_out < 1 || (long long)C * n_out * per >= limit
      || mode < kSample || mode > kCp || (mode != kSample && !bands))
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
  const cudaStream_t st = (cudaStream_t)stream;
  const float* x = (const float*)px;
  const float* y = (const float*)py;
  if (mode == kMac)
    bilerp_sample_kernel<kMac><<<blocks, kThreads, 0, st>>>(
        ch, C, x, y, (unsigned)n_out, h, hh, (float*)out);
  else if (mode == kCp)
    bilerp_sample_kernel<kCp><<<blocks, kThreads, 0, st>>>(
        ch, C, x, y, (unsigned)n_out, h, hh, (float*)out);
  else
    bilerp_sample_kernel<kSample><<<blocks, kThreads, 0, st>>>(
        ch, C, x, y, (unsigned)n_out, h, hh, (float*)out);
  return (int)cudaGetLastError();
}
