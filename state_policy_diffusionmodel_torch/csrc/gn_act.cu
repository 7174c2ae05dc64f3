// GroupNorm(1) with the conv blocks' epilogue, NHWC: per batch element b,
// over its n = H*W*C values x,
//   m = mean(x), v = max(mean(x*x) - m*m, 0), rs = rsqrt(v + 1e-6),
//   y = (x - m) * rs * gamma[c] + beta[c]
//   [y = GELU(y)] [y = ps[b, c] * y + pb[b, c]] [y = GELU(y + x_res)],
// statistics and epilogue in f32, written in x's type.
//
// Replaces the Pallas TPU kernel
// state_policy_diffusionmodel_tpu/models/pallas_ops.py::_gn_act_pallas
// (body _gn_act_kernel, statistics _gn_rows). The TPU kernel takes the
// per-batch-element sums as matmuls against a block-indicator matrix,
// because Mosaic cannot reduce over several axes; here a team of threads
// owns a batch element and reduces with warp shuffles.
//
// Bound on an H100: the bytes. A call reads x (and x_res) once and writes
// the output once, ~10 flops an element; at the largest r5blend shape
// (B=256, 32x8x128, fp32) that is 67 MB, 20 us at 3.35 TB/s, while the
// ten calls at the 4x1 and 8x2 levels move 1-8 MB each and are latency:
// a DRAM round trip, a reduction, a launch. The design:
//   - a team of `team` threads (at most 256, one CTA) owns a batch element;
//     small slices pack `per_cta` teams into one CTA, and a one-warp team
//     reduces with shuffles alone;
//   - a thread holds `nv` 16-byte packs of x (4 fp32 or 8 bf16 values
//     each; 16 values on r5blend's path) a pass in registers, the next
//     pass's loads in flight while it adds the current one. The statistics
//     take `iters` passes; the epilogue starts from the last pass, still
//     held, and reads the others again (from L2: the CTA read them just
//     before). One pass reads x once. A bf16 slice of fewer than 256
//     16-byte packs takes 8-byte packs (4 values), so that more threads
//     share it and each computes fewer GELUs in series;
//   - pack (it * nv + k) * team + t of the slice is thread t's k-th of pass
//     `it`, so a warp reads 512 contiguous bytes a pack, and team * E is a
//     multiple of C: a thread's E channels are fixed, and it loads gamma,
//     beta, ps and pb once, into registers;
//   - a plain launch. Launched behind K3 by programmatic dependent launch,
//     the kernel measured no faster on the path (K3 then K4), and its CTAs
//     waited on the SMs beside K3's (kernels/ab.py `pdl`).
// Measured on an H100 (kernels/ab.py, PERF.md section 6), and dropped:
// thread-block clusters of 2-8 CTAs holding a large slice in registers and
// exchanging their partial sums through distributed shared memory (a CTA's
// second read of its own slice from L2 costs less than the cluster's sync);
// teams of 384 and 512 threads (no faster in bf16; at two CTAs an SM 512
// spills); 32 values a thread; one-value loads (1.7-2x the time).
// The launch plan (models/cuda_ops.py gn_act_plan) is Python; the launcher
// checks it and refuses (cudaErrorInvalidValue) what it does not take.
// Without such packs (C not a multiple of E, an unaligned pointer) a pack
// is one value and its channel is computed per value.
//
// Numerics follow the plain PyTorch version (cuda_ops.gn_act_ref) op for
// op, each rounded once (__fmul_rn/__fadd_rn keep nvcc from contracting
// them into FMAs); only the two sums differ, in order and in precision,
// and their order is fixed: a thread adds its values and their exact
// squares in pack order in double, rounds both to f32, a warp adds its
// lanes by an xor butterfly (every lane ends with the same sum) and a
// team adds its warps in order, so each shape repeats bit for bit. The
// double sums are the cure for the fast variance's cancellation: with f32
// sums, sequential over 64 values a thread, the U-Net's gradients on the
// conv path left the all-plain path's by 1.7e-4 of a tensor's largest
// gradient (chip_smoke.py's limit is 1e-4), and so they did with each
// pack's sums in f32 added in double (kernels/ab.py `pack_sums`, ~2.5%
// faster); with double sums, 4e-6 to 9e-6 (H100).
//   - rs is rsqrtf(v + eps), the function torch.rsqrt calls on the card;
//   - GELU is the exact one, x * 0.5 * (1 + erf(x * (1/sqrt 2))), with
//     CUDA's erff. The TPU kernel uses the A&S 7.1.26 rational erf (max abs
//     error 1.5e-7) only because Mosaic has no erf; the reference semantics
//     are the exact GELU (_gelu_exact), and erff is what torch.erf calls on
//     the card. PyTorch divides by the Python scalar sqrt(2) on the card as
//     a multiply by its f32 reciprocal, and so does this kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

using conv_tile::from_f32;
using conv_tile::to_f32;

constexpr int kMaxThreads = 256;                       // a CTA
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kEps = 1e-6f;                          // flax GroupNorm
constexpr float kInvSqrt2 = 1.0f / 1.41421356237309515f;

// E values of T as one load: 16 bytes, 8 bytes (bf16) or a single value
template <typename T, int E> struct Io;

template <> struct Io<float, 4> {
  static constexpr int E = 4;
  using Raw = uint4;
  __device__ static Raw zero() { return make_uint4(0, 0, 0, 0); }
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static void unpack(const Raw& r, float (&f)[E]) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  __device__ static void store(float* p, const float (&f)[E]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <> struct Io<__nv_bfloat16, 8> {
  static constexpr int E = 8;
  using Raw = uint4;
  __device__ static Raw zero() { return make_uint4(0, 0, 0, 0); }
  __device__ static Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static float2 half(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
  __device__ static uint32_t pair(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static void unpack(const Raw& r, float (&f)[E]) {
    const float2 a = half(r.x), b = half(r.y), c = half(r.z), d = half(r.w);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[E]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7]));
  }
};

template <> struct Io<__nv_bfloat16, 4> {
  static constexpr int E = 4;
  using Raw = uint2;
  using W = Io<__nv_bfloat16, 8>;
  __device__ static Raw zero() { return make_uint2(0, 0); }
  __device__ static Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint2*>(p); }
  __device__ static void unpack(const Raw& r, float (&f)[E]) {
    const float2 a = W::half(r.x), b = W::half(r.y);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[E]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(W::pair(f[0], f[1]), W::pair(f[2], f[3]));
  }
};

template <typename T> struct Io<T, 1> {
  static constexpr int E = 1;
  using Raw = T;
  __device__ static Raw zero() { return from_f32<T>(0.f); }
  __device__ static Raw load(const T* p) { return *p; }
  __device__ static void unpack(const Raw& r, float (&f)[E]) { f[0] = to_f32(r); }
  __device__ static void store(T* p, const float (&f)[E]) { *p = from_f32<T>(f[0]); }
};

__device__ __forceinline__ float gelu(float x) {
  const float e = erff(__fmul_rn(x, kInvSqrt2));
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, e));
}

// ---- the kernel -------------------------------------------------------------

struct Args {
  const void* x;
  const void* gamma;
  const void* beta;
  const void* ps;
  long ps_stride;
  const void* pb;
  long pb_stride;
  const void* xres;
  void* out;
  int B, HW, C;
  int gelu, post, res;
  int team, per_cta, iters;   // the plan
};

template <typename T, int PACK, int NV>
__global__ void __launch_bounds__(kMaxThreads) gn_act_kernel(const Args a) {
  using IO = Io<T, PACK>;
  constexpr int E = IO::E;
  using Raw = typename IO::Raw;
  __shared__ float red[2][kMaxWarps];   // warp partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team_id = tid / a.team, t = tid - team_id * a.team;
  const long b = (long)blockIdx.x * a.per_cta + team_id;
  const bool live = b < a.B;
  const int n = a.HW * a.C, packs = n / E;
  const long off = live ? b * n : 0;
  const T* __restrict__ xb = static_cast<const T*>(a.x) + off;
  const T* __restrict__ rb = a.res ? static_cast<const T*>(a.xres) + off : nullptr;
  T* __restrict__ ob = static_cast<T*>(a.out) + off;
  const T* __restrict__ gamma = static_cast<const T*>(a.gamma);
  const T* __restrict__ beta = static_cast<const T*>(a.beta);
  const T* __restrict__ psb = a.post ? static_cast<const T*>(a.ps) + (live ? b : 0) * a.ps_stride
                                     : nullptr;
  const T* __restrict__ pbb = a.post ? static_cast<const T*>(a.pb) + (live ? b : 0) * a.pb_stride
                                     : nullptr;

  // statistics: a pass adds its nv packs in order, in double, while the
  // next pass's loads are in flight; the last pass stays held for the
  // epilogue
  Raw held[NV], next[NV];
  const auto load = [&](Raw (&dst)[NV], int it) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int p = (it * NV + k) * a.team + t;
      dst[k] = live && p < packs ? IO::load(xb + (long)p * E) : IO::zero();
    }
  };
  // x_res of a pass, loaded before the pass's epilogue needs it: the last
  // pass's before the statistics
  Raw rh[NV];
  const auto load_res = [&](int it) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int p = (it * NV + k) * a.team + t;
      rh[k] = live && p < packs ? IO::load(rb + (long)p * E) : IO::zero();
    }
  };
  double sd = 0.0, qd = 0.0;   // this thread's sums
  load(held, 0);
  if (a.res) load_res(a.iters - 1);
  for (int it = 0; it < a.iters; ++it) {
    if (it + 1 < a.iters) load(next, it + 1);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float f[E];
      IO::unpack(held[k], f);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const double v = f[j];
        sd += v;
        qd = fma(v, v, qd);
      }
    }
    if (it + 1 < a.iters) {
#pragma unroll
      for (int k = 0; k < NV; ++k) held[k] = next[k];
    }
  }
  float s = (float)sd, q = (float)qd;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, o));
  }
  const int wt = a.team / 32;
  if (wt > 1) {   // the team's warps, in order
    if (lane == 0) red[0][warp] = s, red[1][warp] = q;
    __syncthreads();
    s = q = 0.f;
    for (int w = team_id * wt; w < (team_id + 1) * wt; ++w)
      s = __fadd_rn(s, red[0][w]), q = __fadd_rn(q, red[1][w]);
  }
  const float nf = (float)n;
  const float m = s / nf;
  const float var = fmaxf(__fsub_rn(q / nf, __fmul_rn(m, m)), 0.f);
  const float rs = rsqrtf(var + kEps);

  // this thread's channels: fixed where packs are 16 bytes (team * E % C == 0)
  float gm[E], bt[E], sc[E], sh[E];
  if (PACK > 1) {
    const int c0 = (t * E) % a.C;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      gm[j] = to_f32(gamma[c0 + j]);
      bt[j] = to_f32(beta[c0 + j]);
      sc[j] = a.post ? to_f32(psb[c0 + j]) : 0.f;
      sh[j] = a.post ? to_f32(pbb[c0 + j]) : 0.f;
    }
  }

  // epilogue, last pass first (still held), the pass before it loading
  for (int it = a.iters - 1; it >= 0; --it) {
    if (it > 0) load(next, it - 1);
    if (a.res && it != a.iters - 1) load_res(it);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int p = (it * NV + k) * a.team + t;
      if (!live || p >= packs) continue;
      float f[E], r[E];
      IO::unpack(held[k], f);
      if (a.res) IO::unpack(rh[k], r);
      if (PACK == 1) {   // one value: its own channel
        const int c = p % a.C;
        gm[0] = to_f32(gamma[c]);
        bt[0] = to_f32(beta[c]);
        sc[0] = a.post ? to_f32(psb[c]) : 0.f;
        sh[0] = a.post ? to_f32(pbb[c]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < E; ++j) {
        float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[j], m), rs), gm[j]), bt[j]);
        if (a.gelu) y = gelu(y);
        if (a.post) y = __fadd_rn(__fmul_rn(y, sc[j]), sh[j]);
        if (a.res) y = gelu(__fadd_rn(y, r[j]));
        f[j] = y;
      }
      IO::store(ob + (long)p * E, f);
    }
    if (it > 0) {
#pragma unroll
      for (int k = 0; k < NV; ++k) held[k] = next[k];
    }
  }
}

template <typename T, int PACK, int NV>
cudaError_t launch_nv(const Args& a, int threads, long grid, cudaStream_t s) {
  gn_act_kernel<T, PACK, NV><<<(unsigned)grid, threads, 0, s>>>(a);
  return cudaSuccess;
}

template <typename T, int PACK>
cudaError_t launch_pack(const Args& a, int nv, int threads, long grid, cudaStream_t s) {
  switch (nv) {
    case 1: return launch_nv<T, PACK, 1>(a, threads, grid, s);
    case 2: return launch_nv<T, PACK, 2>(a, threads, grid, s);
    case 4: return launch_nv<T, PACK, 4>(a, threads, grid, s);
    case 8: return launch_nv<T, PACK, 8>(a, threads, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, const void* ps, long ps_stride,
           const void* pb, long pb_stride, const void* xres, void* out, int B, int HW, int C,
           int gelu, int pack, int nv, int team, int per_cta, int iters, void* stream) {
  constexpr int kWide = 16 / (int)sizeof(T);   // values a 16-byte pack
  const int E = pack;
  const long n = (long)HW * C;
  const auto aligned = [&](const void* p) { return (uintptr_t)p % (E * sizeof(T)) == 0; };
  // a pack of 16 bytes, of 8 (bf16) or one value; the plan must cover each
  // batch element's packs exactly (every pack index below iters * nv * team
  // is one thread's), with no empty pass, keep a thread's channels fixed
  // where packs are wider than a value, and fit a CTA
  const bool ok =
      (E == 1 || E == kWide || (E == 4 && kWide == 8)) && B > 0 && HW > 0 && C > 0 &&
      n <= 0x7fffffffL && (ps == nullptr) == (pb == nullptr) && team > 0 && team % 32 == 0 &&
      per_cta > 0 && (long)team * per_cta <= kMaxThreads && iters >= 1 &&
      (long)iters * nv * team * E >= n && (long)(iters - 1) * nv * team * E < n &&
      (E == 1 || (C % E == 0 && ((long)team * E) % C == 0 && aligned(x) && aligned(out) &&
                  (xres == nullptr || aligned(xres))));
  if (!ok) return (int)cudaErrorInvalidValue;
  const long grid = ((long)B + per_cta - 1) / per_cta;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const Args a{x, gamma, beta, ps, ps_stride, pb, pb_stride, xres, out, B, (int)HW, C,
               gelu != 0, ps != nullptr, xres != nullptr, team, per_cta, iters};
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = team * per_cta;
  const cudaError_t err = E == 1 ? launch_pack<T, 1>(a, nv, threads, grid, s)
                         : E == kWide ? launch_pack<T, kWide>(a, nv, threads, grid, s)
                                      : launch_pack<T, 4>(a, nv, threads, grid, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ps, pb (rows of ps_stride, pb_stride elements) and xres may be null: no
// affine, no residual. The plan (models/cuda_ops.py gn_act_plan): pack
// (values a load: 16 bytes, 8 bytes in bf16, or 1), nv (packs a thread
// holds a pass), team (threads of a batch element), per_cta (batch
// elements a CTA), iters (passes over a batch element).
int gn_act_f32(const void* x, const void* gamma, const void* beta, const void* ps,
               long ps_stride, const void* pb, long pb_stride, const void* xres, void* out,
               int B, int HW, int C, int gelu, int pack, int nv, int team, int per_cta,
               int iters, void* stream) {
  return launch<float>(x, gamma, beta, ps, ps_stride, pb, pb_stride, xres, out, B, HW, C, gelu,
                       pack, nv, team, per_cta, iters, stream);
}

int gn_act_bf16(const void* x, const void* gamma, const void* beta, const void* ps,
                long ps_stride, const void* pb, long pb_stride, const void* xres, void* out,
                int B, int HW, int C, int gelu, int pack, int nv, int team, int per_cta,
                int iters, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, ps, ps_stride, pb, pb_stride, xres, out, B, HW,
                               C, gelu, pack, nv, team, per_cta, iters, stream);
}

}  // extern "C"
