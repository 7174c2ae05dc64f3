// The previous design of K4 (gn_act), kept as it was so that the current kernel
// can be timed against it in one process (chip_smoke.py, kernels/ab.py).
// The port never calls it. Its own notes follow.
//
// GroupNorm(1) with the conv blocks' epilogue, NHWC: per batch element b,
// over its H*W*C values x,
//   m = mean(x), v = max(mean(x*x) - m*m, 0), rs = rsqrt(v + 1e-6),
//   y = (x - m) * rs * gamma[c] + beta[c]
//   [y = GELU(y)] [y = ps[b, c] * y + pb[b, c]] [y = GELU(y + x_res)],
// statistics and epilogue in f32, written in x's type.
//
// Replaces the Pallas TPU kernel
// state_policy_diffusionmodel_tpu/models/pallas_ops.py::_gn_act_pallas
// (body _gn_act_kernel, statistics _gn_rows). The TPU kernel takes the
// per-batch-element sums as matmuls against a block-indicator matrix,
// because Mosaic cannot reduce over several axes; on Hopper one block owns
// one batch element and reduces with warp shuffles.
//
// Bound on an H100: the bytes. A call reads x (and x_res) once and writes
// the output once, ~10 flops an element; at the largest r5blend shape
// (B=256, 32x8x128, fp32) that is 67 MB, 20 us at 3.35 TB/s. The design:
// one block of 512 threads per batch element (at most 32,768 values at the
// U-Net's shapes); pass 1 reads the slice four elements at a time (16
// bytes in fp32, 8 in bf16) and sums x and x*x in f32; pass 2 reads it
// again (from L2: the block's slice was just read) and writes the
// normalised, activated result.
//
// Numerics follow the plain PyTorch version (cuda_ops.gn_act_ref) op for
// op, each rounded once (__fmul_rn/__fadd_rn keep nvcc from contracting
// them into FMAs); only the order of the two sums differs:
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

namespace {

constexpr int kThreads = 512;
constexpr float kEps = 1e-6f;                          // flax GroupNorm
constexpr float kInvSqrt2 = 1.0f / 1.41421356237309515f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 q;
  *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ float gelu(float x) {
  const float e = erff(__fmul_rn(x, kInvSqrt2));
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, e));
}

struct Epilogue {
  int gelu, post, res;
};

template <typename T>
__device__ __forceinline__ float apply(float xv, int c, float m, float rs, const T* gamma,
                                       const T* beta, const T* psb, const T* pbb,
                                       const T* xresb, long i, Epilogue ep) {
  float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv, m), rs), to_f32(gamma[c])),
                      to_f32(beta[c]));
  if (ep.gelu) y = gelu(y);
  if (ep.post) y = __fadd_rn(__fmul_rn(y, to_f32(psb[c])), to_f32(pbb[c]));
  if (ep.res) y = gelu(__fadd_rn(y, to_f32(xresb[i])));
  return y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_act_kernel(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
              const T* __restrict__ ps, long ps_stride, const T* __restrict__ pb,
              long pb_stride, const T* __restrict__ xres, T* __restrict__ out, int HW, int C,
              Epilogue ep, int vec) {
  __shared__ float red[2][kThreads / 32];
  const int b = blockIdx.x;
  const long n = (long)HW * C;
  const T* xb = x + b * n;
  const T* xresb = ep.res ? xres + b * n : nullptr;
  T* ob = out + b * n;
  const T* psb = ep.post ? ps + b * ps_stride : nullptr;
  const T* pbb = ep.post ? pb + b * pb_stride : nullptr;

  float s = 0.f, q = 0.f;
  if (vec) {
    for (long i = 4L * threadIdx.x; i < n; i += 4L * kThreads) {
      float v[4];
      load4(xb + i, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s += v[k];
        q += v[k] * v[k];
      }
    }
  } else {
    for (long i = threadIdx.x; i < n; i += kThreads) {
      const float v = to_f32(xb[i]);
      s += v;
      q += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  s = lane < kThreads / 32 ? red[0][lane] : 0.f;
  q = lane < kThreads / 32 ? red[1][lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    q += __shfl_xor_sync(0xffffffffu, q, off);
  }
  const float nf = (float)n;
  const float m = s / nf;
  const float var = fmaxf(__fsub_rn(q / nf, __fmul_rn(m, m)), 0.f);
  const float rs = rsqrtf(var + kEps);

  if (vec) {
    for (long i = 4L * threadIdx.x; i < n; i += 4L * kThreads) {
      float v[4];
      load4(xb + i, v);
      const int c = (int)(i % C);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = apply(v[k], c + k, m, rs, gamma, beta, psb, pbb, xresb, i + k, ep);
      store4(ob + i, v);
    }
  } else {
    for (long i = threadIdx.x; i < n; i += kThreads)
      ob[i] = from_f32<T>(apply(to_f32(xb[i]), (int)(i % C), m, rs, gamma, beta, psb, pbb,
                                xresb, i, ep));
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, const void* ps, long ps_stride,
           const void* pb, long pb_stride, const void* xres, void* out, int B, int HW, int C,
           int gelu, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const Epilogue ep{gelu != 0, ps != nullptr, xres != nullptr};
  if ((ps == nullptr) != (pb == nullptr)) return (int)cudaErrorInvalidValue;
  const uintptr_t a = 4 * sizeof(T) - 1;
  const int vec = C % 4 == 0 && ((uintptr_t)x & a) == 0 && ((uintptr_t)out & a) == 0;
  gn_act_kernel<T><<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)gamma, (const T*)beta, (const T*)ps, ps_stride, (const T*)pb,
      pb_stride, (const T*)xres, (T*)out, HW, C, ep, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ps, pb (rows of ps_stride, pb_stride elements) and xres may be null: no
// affine, no residual.
int gn_act_f32(const void* x, const void* gamma, const void* beta, const void* ps,
               long ps_stride, const void* pb, long pb_stride, const void* xres, void* out,
               int B, int HW, int C, int gelu, void* stream) {
  return launch<float>(x, gamma, beta, ps, ps_stride, pb, pb_stride, xres, out, B, HW, C,
                       gelu, stream);
}

int gn_act_bf16(const void* x, const void* gamma, const void* beta, const void* ps,
                long ps_stride, const void* pb, long pb_stride, const void* xres, void* out,
                int B, int HW, int C, int gelu, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, ps, ps_stride, pb, pb_stride, xres, out, B,
                               HW, C, gelu, stream);
}

}  // extern "C"
