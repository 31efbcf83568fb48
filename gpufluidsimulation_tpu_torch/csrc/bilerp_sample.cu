// bilerp_sample: the 2D kernels of the grid and particle solvers. Clamped
// bilinear samples of C 2D float32 fields at one set of world positions,
// the 2D MAC velocity with its band mask, calculateCp, a whole
// CFL-substepped 2D RK3 trace (trace mode) and one 2D DMC substep of the
// backward map (DMC mode).
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
// The trace mode stands for the JAX package's 2D march, which computes
// the same function through the lifted _kernel and XLA glue
// (gpufluidsimulation_tpu/ops/advect.py trace_rk3_2d, trace_2d,
// _semilag_2d_at, _clamp_2d_at, update_forward_map_2d): per position, for
// each CFL substep with the host's float32 Ralston coefficients (a, b,
// c1, c2, c3) (one set for the n - 1 full substeps, one for the last),
//   u1 = mac(p), u2 = mac(p + a*u1), u3 = mac(p + b*u2)
//   p  = clamp(p + c1*u1 + c2*u2 + c3*u3, 0.001h, L - 0.001h)
// then an optional final clamp ([h, L - h] for the forward map, [h, (n-1)h]
// for the particles), and at the foot optionally the clamped bilinear
// samples of C <= 4 fields of the traced kind and the min and max of each
// field's 4 clamped corners (the MacCormack/BFECC clamp, NaN where the
// foot is NaN), and the foot itself. The start is read (any element
// stride: the particles' (P, 2) columns) or formed from a kind's lattice
// as grids.lattice_coords forms it, ((float)i + off) * h. Clamps are
// compare-and-select, so that a NaN stays as torch.clamp keeps it; their
// bounds are the host's, rounded once to float32 as torch rounds them.
//
// The DMC mode is one substep of the 2D backward-map march (JAX:
// dmc_backward_step_2d, XLA glue around two lifted samples): per cell
// node p = ((float)i + 0.5)h, the MAC velocity vel at p and t at the
// upwind node p -+ h per axis, the slope a = (vel - t) / (p - p_upwind),
// p' = p - (1 - exp(-a*s)) * vel / a where |a| > 1e-4, else p - vel*s,
// clamped to [h, L - h], and the map's two channels sampled there. The
// plain version takes the slopes once a march; recomputing them here in
// each substep gives the same bits. expf is the IEEE-accurate libdevice
// expf, as in dmc_substep.cu.
//
// What bounds it on the H100: the launch and the chain of dependent
// gathers, not bytes. The fields of a 2D step fit the 50 MB L2 many times
// over (u, v, rho and T at 256^2: ~1 MB), so a launch's bytes take
// 0.3-0.6 us, below what a launch costs. A trace runs 3k dependent
// gathers of the velocity for k substeps.
//
// Design: one thread per output position. In the sample, mac and cp
// modes all C channels are in that thread, so that the two position
// loads and the divisions by h are made once and the floors and weights
// once for each run of channels that share an offset (the callers stack
// fields sampled at the same positions). A corner reads 4 values, not
// the 8 of the lifted 3D window. Outputs are channel-major, (C, n_out),
// so that every store coalesces. The trace mode keeps the whole march of
// a position in registers (one position a thread: two a thread, their
// chains interleaved, measured slower), so that a trace with its foot samples,
// its corner min/max and its foot is one launch where the first form
// took 3 launches a substep and ~22 elementwise kernels around them;
// in the lattice mode consecutive threads take consecutive j, so that the
// stores coalesce. The DMC mode does the same for a substep of the map
// march. Offsets are unsigned 32-bit: the wrappers raise unless each
// field and each output holds fewer than 2^31 values.
//
// The bf16 mode (EngineMode.interp_bf16, the JAX package's bf16 field
// windows, which its 2D solver reads through sample2_fast wherever it
// samples field values; its velocity samples, mac2_fast, and its map
// samples stay float32): the sample mode and the trace mode's foot samples
// read bfloat16 fields, each value widened to float32 at its load
// (gfs::load) and every operation after it the float32 kernel's, so the
// result is the float32 kernel's on the rounded fields, bit for bit. In
// the trace mode the velocity stays float32, and MacCormack's corner
// min/max, which the JAX package takes by exact gathers of the unrounded
// field, reads the float32 fields from a second set of pointers in the
// same launch. The mac, cp and DMC modes read float32 only. Compiled apart
// (S = __nv_bfloat16); the float32 instantiations stay as they were.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxC = 4;
constexpr int kThreads = 256;
// the trace and DMC modes: threads a CTA (at 256^2, 512 CTAs: ~4 an SM)
constexpr int kTraceThreads = 128;

// Per-channel field pointer, extents, offset and (mac mode) band: a
// sample is kept where 0 <= floor(gx) <= bx and 0 <= floor(gy) <= by.
struct Channels {
  const void* f[kMaxC];  // stored as the kernel's S
  int nx[kMaxC], ny[kMaxC];
  float ox[kMaxC], oy[kMaxC];
  float bx[kMaxC], by[kMaxC];
};

using gfs::clamp_node;

enum Mode { kSample = 0, kMac = 1, kCp = 2 };

// The fractions, their complements and the float floors of a sample at
// grid coordinates (gx, gy).
struct Frac {
  float fx, fy, wx, wy, i0, j0;
};

__device__ __forceinline__ Frac frac(float gx, float gy) {
  Frac w;
  w.i0 = floorf(gx);
  w.j0 = floorf(gy);
  w.fx = gx - w.i0;
  w.fy = gy - w.j0;
  w.wx = 1.0f - w.fx;
  w.wy = 1.0f - w.fy;
  return w;
}

// The 4 clamped corners of an (nx, ny) field, y fastest, widened to
// float32 from the field's storage S.
struct Quad {
  float v00, v10, v01, v11;
};

template <typename S>
__device__ __forceinline__ Quad corners(const S* __restrict__ f,
                                        const Frac& w, int nx, int ny) {
  const unsigned ia = clamp_node(w.i0, nx) * (unsigned)ny;
  const unsigned ib = clamp_node(w.i0 + 1.0f, nx) * (unsigned)ny;
  const unsigned ja = clamp_node(w.j0, ny);
  const unsigned jb = clamp_node(w.j0 + 1.0f, ny);
  return {gfs::load(f + (ia + ja)), gfs::load(f + (ib + ja)),
          gfs::load(f + (ia + jb)), gfs::load(f + (ib + jb))};
}

__device__ __forceinline__ float blend(const Quad& q, const Frac& w) {
  return w.wy * (w.wx * q.v00 + w.fx * q.v10) +
         w.fy * (w.wx * q.v01 + w.fx * q.v11);
}

// clamp(x, lo, hi) as torch.clamp computes it for lo <= hi: a NaN stays
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <int kMode, typename S>
__global__ void __launch_bounds__(kThreads)
    bilerp_sample_kernel(Channels ch, int C, const float* __restrict__ px,
                         const float* __restrict__ py, unsigned n_out,
                         float h, float hh, float* __restrict__ out) {
  const unsigned idx = blockIdx.x * (unsigned)kThreads + threadIdx.x;
  if (idx >= n_out) return;
  const float x = __ldg(px + idx) / h;
  const float y = __ldg(py + idx) / h;
  Frac w = frac(x - ch.ox[0], y - ch.oy[0]);
  // the channel loop is unrolled, so every Channels member is read at a
  // compile-time index (no copy of the argument to local memory)
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= C) break;
    if (c > 0 && (ch.ox[c] != ch.ox[c - 1] || ch.oy[c] != ch.oy[c - 1]))
      w = frac(x - ch.ox[c], y - ch.oy[c]);
    const Quad q = corners(static_cast<const S*>(ch.f[c]), w, ch.nx[c],
                           ch.ny[c]);
    const bool valid = w.i0 >= 0.0f && w.i0 <= ch.bx[c] && w.j0 >= 0.0f &&
                       w.j0 <= ch.by[c];
    if (kMode == kCp) {
      const float qx = w.fx * h, qy = w.fy * h;
      const float a = h - qx, b = h - qy;
      float4 r;
      r.x = (a * b * q.v00 + qx * b * q.v10 + qx * qy * q.v11 +
             a * qy * q.v01) / hh;
      r.y = (-b * q.v00 + b * q.v10 + qy * q.v11 - qy * q.v01) / hh;
      r.z = (-a * q.v00 - qx * q.v10 + qx * q.v11 + a * q.v01) / hh;
      r.w = (q.v00 - q.v10 + q.v11 - q.v01) / hh;
      if (!valid) r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      reinterpret_cast<float4*>(out)[(unsigned)c * n_out + idx] = r;
    } else {
      float r = blend(q, w);
      if (kMode == kMac) r = valid ? r : 0.0f;
      out[(unsigned)c * n_out + idx] = r;
    }
  }
}

// ---------------------------------------------------------------------------
// The trace and DMC modes
// ---------------------------------------------------------------------------

// The MAC velocity of an ni x nj grid: u (ni+1, nj), v (ni, nj+1).
struct Mac {
  const float* u;
  const float* v;
  int ni, nj;
  float h;
};

// interp.mac_velocity_2d at world position (px, py): each component's
// clamped bilinear on its lattice, 0 where its float floors leave its band
__device__ __forceinline__ void mac_velocity(const Mac& m, float px,
                                             float py, float& us,
                                             float& vs) {
  const float x = px / m.h, y = py / m.h;
  const Frac a = frac(x - 0.0f, y - 0.5f);
  const float ru = blend(corners(m.u, a, m.ni + 1, m.nj), a);
  us = (a.i0 >= 0.0f && a.i0 <= (float)(m.ni - 1) && a.j0 >= 0.0f &&
        a.j0 <= (float)(m.nj - 2)) ? ru : 0.0f;
  const Frac b = frac(x - 0.5f, y - 0.0f);
  const float rv = blend(corners(m.v, b, m.ni, m.nj + 1), b);
  vs = (b.i0 >= 0.0f && b.i0 <= (float)(m.ni - 2) && b.j0 >= 0.0f &&
        b.j0 <= (float)(m.nj - 1)) ? rv : 0.0f;
}

struct Trace {
  Mac m;
  int n_sub;                    // CFL substeps
  float a0, b0, c10, c20, c30;  // substeps 0 .. n_sub - 2
  float a1, b1, c11, c21, c31;  // the last substep
  float elx, ehx, ely, ehy;     // each substep's clamp
  int fin;                      // the final clamp is on
  float flx, fhx, fly, fhy;     // the final clamp
  const float* px;              // start positions (not the lattice mode),
  const float* py;              // element stride in_stride
  unsigned in_stride;
  int lny;                      // the lattice mode: nodes along y
  float lox, loy;               // and the kind's offset
  unsigned n;                   // positions
  float* ox;                    // the foot (null: not written), element
  float* oy;                    // stride out_stride
  unsigned out_stride;
  int C;                        // fields sampled at the foot, stored as
  const void* f[kMaxC];         // the kernel's S
  const float* fm[kMaxC];       // with bfloat16 f: their float32 fields
  int fnx, fny;                 // their extents
  float fox, foy;               // and their offset (units of h)
  float* samples;               // (C, n)
  float* mn;                    // (C, n) each, the minmax flavour
  float* mx;
};

// kLattice: the start is the lattice (lox, loy) of n / lny x lny nodes;
// kMinmax: the corner min/max of each field at the foot (of the float32
// fields fm where the sampled fields are bfloat16); S: the sampled fields'
// storage.
template <bool kLattice, bool kMinmax, typename S>
__global__ void __launch_bounds__(kTraceThreads)
    bilerp_trace_kernel(Trace T) {
  const unsigned idx = blockIdx.x * (unsigned)kTraceThreads + threadIdx.x;
  if (idx >= T.n) return;
  float x, y;
  if (kLattice) {
    const unsigned i = idx / (unsigned)T.lny;
    const unsigned j = idx - i * (unsigned)T.lny;
    x = ((float)i + T.lox) * T.m.h;
    y = ((float)j + T.loy) * T.m.h;
  } else {
    x = __ldg(T.px + idx * T.in_stride);
    y = __ldg(T.py + idx * T.in_stride);
  }
  // unrolled by 2: 3-27% faster than the loop as the compiler leaves it
  // (scripts/kernel_variants.py), at 1 substep too
#pragma unroll 2
  for (int s = 0; s < T.n_sub; ++s) {
    const bool last = s == T.n_sub - 1;
    const float a = last ? T.a1 : T.a0, b = last ? T.b1 : T.b0;
    const float c1 = last ? T.c11 : T.c10, c2 = last ? T.c21 : T.c20;
    const float c3 = last ? T.c31 : T.c30;
    float u1, v1, u2, v2, u3, v3;
    mac_velocity(T.m, x, y, u1, v1);
    mac_velocity(T.m, x + a * u1, y + a * v1, u2, v2);
    mac_velocity(T.m, x + b * u2, y + b * v2, u3, v3);
    x = clampf(x + c1 * u1 + c2 * u2 + c3 * u3, T.elx, T.ehx);
    y = clampf(y + c1 * v1 + c2 * v2 + c3 * v3, T.ely, T.ehy);
  }
  if (T.fin) {
    x = clampf(x, T.flx, T.fhx);
    y = clampf(y, T.fly, T.fhy);
  }
  if (T.ox) {
    T.ox[idx * T.out_stride] = x;
    T.oy[idx * T.out_stride] = y;
  }
  if (T.C == 0) return;
  const float gx = x / T.m.h - T.fox, gy = y / T.m.h - T.foy;
  const Frac w = frac(gx, gy);
  const bool nan_foot = gx != gx || gy != gy;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= T.C) break;
    const Quad q = corners(static_cast<const S*>(T.f[c]), w, T.fnx, T.fny);
    T.samples[(unsigned)c * T.n + idx] = blend(q, w);
    if (kMinmax) {
      Quad m = q;
      if constexpr (!std::is_same<S, float>::value)
        m = corners(T.fm[c], w, T.fnx, T.fny);
      float lo = nan_min(nan_min(m.v00, m.v10), nan_min(m.v01, m.v11));
      float hi = nan_max(nan_max(m.v00, m.v10), nan_max(m.v01, m.v11));
      if (nan_foot) lo = hi = __int_as_float(0x7fc00000);
      T.mn[(unsigned)c * T.n + idx] = lo;
      T.mx[(unsigned)c * T.n + idx] = hi;
    }
  }
}

struct Dmc {
  Mac m;
  const float* mapx;  // the map's x and y, (ni, nj) each
  const float* mapy;
  float s;            // the signed substep
  float lo, hix, hiy; // the clamp [h, L - h]
  float* out;         // (2, ni, nj)
};

// _dmc_newpos: the exponential step where |a| > 1e-4, else explicit Euler
__device__ __forceinline__ float dmc_newpos(float p, float vel, float a,
                                           float s) {
  const bool big = fabsf(a) > 1e-4f;
  const float sa = big ? a : 1.0f;
  const float e = p - (1.0f - expf(-sa * s)) * vel / sa;
  return big ? e : p - vel * s;
}

__global__ void __launch_bounds__(kTraceThreads) bilerp_dmc_kernel(Dmc D) {
  const unsigned n = (unsigned)D.m.ni * (unsigned)D.m.nj;
  const unsigned idx = blockIdx.x * (unsigned)kTraceThreads + threadIdx.x;
  if (idx >= n) return;
  const unsigned i = idx / (unsigned)D.m.nj;
  const unsigned j = idx - i * (unsigned)D.m.nj;
  const float h = D.m.h;
  const float x = ((float)i + 0.5f) * h, y = ((float)j + 0.5f) * h;
  float vu, vv, tu, tv;
  mac_velocity(D.m, x, y, vu, vv);
  const float tx = vu > 0.0f ? x - h : x + h;
  const float ty = vv > 0.0f ? y - h : y + h;
  mac_velocity(D.m, tx, ty, tu, tv);
  const float ax = (vu - tu) / (x - tx), ay = (vv - tv) / (y - ty);
  const float nx = clampf(dmc_newpos(x, vu, ax, D.s), D.lo, D.hix);
  const float ny = clampf(dmc_newpos(y, vv, ay, D.s), D.lo, D.hiy);
  const Frac w = frac(nx / h - 0.5f, ny / h - 0.5f);
  D.out[idx] = blend(corners(D.mapx, w, D.m.ni, D.m.nj), w);
  D.out[n + idx] = blend(corners(D.mapy, w, D.m.ni, D.m.nj), w);
}

template <typename S>
void launch_trace(bool lattice, bool minmax, unsigned blocks,
                  cudaStream_t st, const Trace& T) {
  if (lattice && minmax)
    bilerp_trace_kernel<true, true, S><<<blocks, kTraceThreads, 0, st>>>(T);
  else if (lattice)
    bilerp_trace_kernel<true, false, S><<<blocks, kTraceThreads, 0, st>>>(T);
  else if (minmax)
    bilerp_trace_kernel<false, true, S><<<blocks, kTraceThreads, 0, st>>>(T);
  else
    bilerp_trace_kernel<false, false, S><<<blocks, kTraceThreads, 0, st>>>(T);
}

}  // namespace

// fields[c]: C field pointers with extents dims[2c], dims[2c+1] and
// offsets offs[2c], offs[2c+1]; mode 0 samples, 1 is the mac mode and 2
// the cp mode, both with the bands (2C values) that mode 0 takes as null;
// hh is h*h rounded to float32 (the cp mode's divisor). bf16 (mode 0
// only): the fields are bfloat16, else float32.
static int sample(const void* const* fields, const int* dims,
                  const float* offs, const float* bands, int C, int mode,
                  bool bf16, const void* px, const void* py, long long n_out,
                  float h, float hh, void* out, void* stream) {
  const long long limit = 1LL << 31;
  const long long per = mode == kCp ? 4 : 1;
  if (C < 1 || C > kMaxC || n_out < 1 || (long long)C * n_out * per >= limit
      || mode < kSample || mode > kCp || (mode != kSample && !bands) ||
      (bf16 && mode != kSample))
    return (int)cudaErrorInvalidValue;
  Channels ch;
  for (int c = 0; c < kMaxC; ++c) {
    const int s = c < C ? c : 0;
    ch.f[c] = fields[s];
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
  if (bf16)
    bilerp_sample_kernel<kSample, __nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        ch, C, x, y, (unsigned)n_out, h, hh, (float*)out);
  else if (mode == kMac)
    bilerp_sample_kernel<kMac, float><<<blocks, kThreads, 0, st>>>(
        ch, C, x, y, (unsigned)n_out, h, hh, (float*)out);
  else if (mode == kCp)
    bilerp_sample_kernel<kCp, float><<<blocks, kThreads, 0, st>>>(
        ch, C, x, y, (unsigned)n_out, h, hh, (float*)out);
  else
    bilerp_sample_kernel<kSample, float><<<blocks, kThreads, 0, st>>>(
        ch, C, x, y, (unsigned)n_out, h, hh, (float*)out);
  return (int)cudaGetLastError();
}

// float32 fields
extern "C" int gfs_bilerp_sample(const void* const* fields, const int* dims,
                                 const float* offs, const float* bands,
                                 int C, int mode, const void* px,
                                 const void* py, long long n_out, float h,
                                 float hh, void* out, void* stream) {
  return sample(fields, dims, offs, bands, C, mode, false, px, py, n_out, h,
                hh, out, stream);
}

// bfloat16 fields (the bf16 mode), the sample mode (mode 0) only; the
// same arguments
extern "C" int gfs_bilerp_sample_bf16(const void* const* fields,
                                      const int* dims, const float* offs,
                                      const float* bands, int C, int mode,
                                      const void* px, const void* py,
                                      long long n_out, float h, float hh,
                                      void* out, void* stream) {
  return sample(fields, dims, offs, bands, C, mode, true, px, py, n_out, h,
                hh, out, stream);
}

// One 2D trace. fp: h, the two coefficient sets (a, b, c1, c2, c3), the
// substep clamp (lo x, hi x, lo y, hi y), the final clamp (the same), the
// lattice offset (x, y) and the fields' offset (x, y): 23 floats. ip: the
// substeps, the final clamp on, the positions n, the lattice's nodes
// along y (0: positions px, py are read), the input and output element
// strides, C, the fields' extents (nx, ny), the min/max on: 10 ints. ox,
// oy: the foot (both null: not written); fields: C pointers, bfloat16 with
// bf16, else float32; minmax_fields: with bf16 and the min/max on, the C
// float32 fields whose corners the min/max reads, else not read; samples,
// mn and mx: (C, n) each (mn, mx only with the min/max on).
static int trace(const void* u, const void* v, int ni, int nj,
                 const float* fp, const int* ip, const void* px,
                 const void* py, void* ox, void* oy,
                 const void* const* fields, bool bf16,
                 const void* const* minmax_fields, void* samples, void* mn,
                 void* mx, void* stream) {
  const long long limit = 1LL << 31;
  Trace T;
  T.m = {(const float*)u, (const float*)v, ni, nj, fp[0]};
  T.n_sub = ip[0];
  T.a0 = fp[1], T.b0 = fp[2], T.c10 = fp[3], T.c20 = fp[4], T.c30 = fp[5];
  T.a1 = fp[6], T.b1 = fp[7], T.c11 = fp[8], T.c21 = fp[9], T.c31 = fp[10];
  T.elx = fp[11], T.ehx = fp[12], T.ely = fp[13], T.ehy = fp[14];
  T.fin = ip[1];
  T.flx = fp[15], T.fhx = fp[16], T.fly = fp[17], T.fhy = fp[18];
  T.lox = fp[19], T.loy = fp[20];
  T.fox = fp[21], T.foy = fp[22];
  const long long n = ip[2];
  T.lny = ip[3];
  const bool lattice = T.lny > 0;
  T.in_stride = (unsigned)ip[4];
  T.out_stride = (unsigned)ip[5];
  T.C = ip[6];
  T.fnx = ip[7];
  T.fny = ip[8];
  const bool minmax = ip[9] != 0;
  if (ni < 2 || nj < 2 || T.n_sub < 0 || n < 1 || T.C < 0 || T.C > kMaxC ||
      (long long)(ni + 1) * (nj + 1) >= limit || ip[4] < 1 || ip[5] < 1 ||
      (n - 1) * ip[4] >= limit || (n - 1) * ip[5] + 1 >= limit ||
      (long long)T.C * n >= limit || (lattice && n % T.lny) ||
      (!lattice && (!px || !py)) || (!ox != !oy) ||
      (T.C && (T.fnx < 1 || T.fny < 1 || !samples ||
               (long long)T.fnx * T.fny >= limit)) ||
      (minmax && (!T.C || !mn || !mx)) ||
      (bf16 && (!T.C || (minmax && !minmax_fields))))
    return (int)cudaErrorInvalidValue;
  T.n = (unsigned)n;
  T.px = (const float*)px;
  T.py = (const float*)py;
  T.ox = (float*)ox;
  T.oy = (float*)oy;
  for (int c = 0; c < kMaxC; ++c) {
    T.f[c] = c < T.C ? fields[c] : nullptr;
    T.fm[c] = c < T.C && bf16 && minmax ? (const float*)minmax_fields[c]
                                        : nullptr;
  }
  T.samples = (float*)samples;
  T.mn = (float*)mn;
  T.mx = (float*)mx;
  const unsigned blocks = (unsigned)((n + kTraceThreads - 1) / kTraceThreads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    launch_trace<__nv_bfloat16>(lattice, minmax, blocks, st, T);
  else
    launch_trace<float>(lattice, minmax, blocks, st, T);
  return (int)cudaGetLastError();
}

// float32 fields
extern "C" int gfs_bilerp_trace(const void* u, const void* v, int ni, int nj,
                                const float* fp, const int* ip,
                                const void* px, const void* py, void* ox,
                                void* oy, const void* const* fields,
                                void* samples, void* mn, void* mx,
                                void* stream) {
  return trace(u, v, ni, nj, fp, ip, px, py, ox, oy, fields, false, nullptr,
               samples, mn, mx, stream);
}

// bfloat16 fields (the bf16 mode) with, for the min/max, their float32
// fields minmax_fields
extern "C" int gfs_bilerp_trace_bf16(const void* u, const void* v, int ni,
                                     int nj, const float* fp, const int* ip,
                                     const void* px, const void* py,
                                     void* ox, void* oy,
                                     const void* const* fields,
                                     const void* const* minmax_fields,
                                     void* samples, void* mn, void* mx,
                                     void* stream) {
  return trace(u, v, ni, nj, fp, ip, px, py, ox, oy, fields, true,
               minmax_fields, samples, mn, mx, stream);
}

// One 2D DMC substep of the map (mapx, mapy), (ni, nj) each, into the
// (2, ni, nj) `out`: fp holds h, the signed substep s and the clamp (lo,
// hi x, hi y).
extern "C" int gfs_bilerp_dmc(const void* u, const void* v, int ni, int nj,
                              const void* mapx, const void* mapy,
                              const float* fp, void* out, void* stream) {
  if (ni < 2 || nj < 2 || (long long)(ni + 1) * (nj + 1) * 2 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Dmc D;
  D.m = {(const float*)u, (const float*)v, ni, nj, fp[0]};
  D.mapx = (const float*)mapx;
  D.mapy = (const float*)mapy;
  D.s = fp[1];
  D.lo = fp[2], D.hix = fp[3], D.hiy = fp[4];
  D.out = (float*)out;
  const unsigned n = (unsigned)ni * (unsigned)nj;
  const unsigned blocks = (n + kTraceThreads - 1) / kTraceThreads;
  bilerp_dmc_kernel<<<blocks, kTraceThreads, 0, (cudaStream_t)stream>>>(D);
  return (int)cudaGetLastError();
}
