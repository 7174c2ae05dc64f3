// Weight gradient of the 3x3 same-padded convolution (K6), NHWC in, OIHW out:
//   dw[co, ci, di, dj] = sum over (b, h, w) of
//     x[b, h + di - 1, w + dj - 1, ci] * g[b, h, w, co],
// with zeros outside the image, accumulated in f32 and written in f32.
//
// Replaces the Pallas TPU kernel
// state_policy_diffusionmodel_tpu/models/pallas_ops.py::_conv_dw_pallas
// (body _dw_kernel): one grid step per batch tile, nine (Cin, Cout) patch
// products summed into one persistent VMEM accumulator across the whole
// sequential grid, over a zero-padded copy of x in HBM. On the card blocks
// run in parallel and in no order, so nothing can carry a sum from one block
// to the next. Here the product is a GEMM with M = Cout, N = 9*Cin (the OIHW
// order ci*9 + tap, so the result is the port's weight layout as it is) and
// a long K = B*H*W pixels, and the K axis is split:
//   - a block owns kBCo = 64 output channels x kBCi = 32 input channels x
//     all nine taps, and one chunk of the pixels. Each of its 8 warps holds
//     8 output channels; each lane one input channel; a thread's 8 x 9 f32
//     sums stay in registers for the whole chunk;
//   - a K step stages kKP = 16 pixels in shared memory as f32: for each
//     pixel its nine shifted x rows of the block's input channels (the halo
//     is a bounds test, so no padded copy of x exists) and its g row of the
//     block's output channels. Per pixel a thread reads its 8 g values as
//     two broadcast float4 loads and its 9 x values conflict-free, and does
//     72 FMAs;
//   - the launcher (state_policy_diffusionmodel_torch/models/cuda_ops.py
//     conv_dw_plan) picks the number of pixel chunks so that the grid
//     holds about two blocks per SM at every level of the U-Net (the 32x8
//     level has 65,536 pixels and as few as two channel tiles; the 4x1
//     level 1,024 pixels and up to 64 tiles). With more than one chunk each
//     block writes its partial sums to an f32 workspace, and a second
//     kernel adds the chunks up in chunk order, so two runs agree bit for
//     bit (no atomics).
// bf16 inputs are widened to f32 as they are staged: each bf16 x bf16
// product is exact in f32 and the sum is f32, as _dw_kernel's dots with
// preferred_element_type=f32 are.
//
// Bound on an H100: one r5blend training step at B=256 runs 31 such
// gradients, ~192 GFLOP against ~1 GB of x and g in fp32, so the operations
// bound it (~2.9 ms at the 67 TFLOP/s fp32 rate outside the tensor cores).
// This first kernel runs on the CUDA cores in both types; the tensor cores
// (mma.sync or wgmma for bf16), TMA and a pipelined K loop are left to a
// later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kBCo = 64;        // output channels per block, 8 per warp
constexpr int kBCi = 32;        // input channels per block, one per lane
constexpr int kCoT = 8;         // output channels per thread
constexpr int kKP = 16;         // pixels per K step
constexpr int kTaps = 9;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ out,
               int B, int H, int W, int Cin, int Cout, int chunk_pixels) {
  __shared__ float xs[kKP][kTaps][kBCi];
  __shared__ __align__(16) float gs[kKP][kBCo];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ci0 = blockIdx.x * kBCi;
  const int co0 = blockIdx.y * kBCo;
  const int HW = H * W;
  const int P = B * HW;
  const int p_begin = blockIdx.z * chunk_pixels;
  const int p_end = min(P, p_begin + chunk_pixels);

  // x loader: this thread stages input channel ci0 + lane of pixels
  // warp and warp + 8 of each step, all nine taps
  const int ci = ci0 + lane;
  const bool ci_ok = ci < Cin;
  // g loader: output channel co0 + (tid % 64) of pixels tid / 64 + 4k
  const int co_l = tid & (kBCo - 1);
  const int co_ld = co0 + co_l;
  const bool co_ld_ok = co_ld < Cout;

  float acc[kCoT][kTaps];
#pragma unroll
  for (int c = 0; c < kCoT; ++c)
#pragma unroll
    for (int t = 0; t < kTaps; ++t) acc[c][t] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += kKP) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pl = warp + 8 * half;
      const int p = p0 + pl;
      int b = 0, h = 0, w = 0;
      const bool p_ok = p < p_end;
      if (p_ok) {
        b = p / HW;
        const int r = p - b * HW;
        h = r / W;
        w = r - h * W;
      }
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        const int hh = h + t / 3 - 1;
        const int ww = w + t % 3 - 1;
        float v = 0.f;
        if (p_ok && ci_ok && hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = to_f32(x[((int64_t)(b * H + hh) * W + ww) * Cin + ci]);
        xs[pl][t][lane] = v;
      }
    }
#pragma unroll
    for (int k = 0; k < kKP * kBCo / kThreads; ++k) {
      const int pl = tid / kBCo + (kThreads / kBCo) * k;
      const int p = p0 + pl;
      float v = 0.f;
      if (p < p_end && co_ld_ok) v = to_f32(g[(int64_t)p * Cout + co_ld]);
      gs[pl][co_l] = v;
    }
    __syncthreads();

#pragma unroll 4
    for (int pl = 0; pl < kKP; ++pl) {
      const float4 ga = *reinterpret_cast<const float4*>(&gs[pl][warp * kCoT]);
      const float4 gb = *reinterpret_cast<const float4*>(&gs[pl][warp * kCoT + 4]);
      const float gv[kCoT] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      float xv[kTaps];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) xv[t] = xs[pl][t][lane];
#pragma unroll
      for (int c = 0; c < kCoT; ++c)
#pragma unroll
        for (int t = 0; t < kTaps; ++t) acc[c][t] = fmaf(gv[c], xv[t], acc[c][t]);
    }
    __syncthreads();
  }

  if (!ci_ok) return;
  float* dst = out + (int64_t)blockIdx.z * Cout * Cin * kTaps;
#pragma unroll
  for (int c = 0; c < kCoT; ++c) {
    const int co = co0 + warp * kCoT + c;
    if (co >= Cout) break;
    float* row = dst + ((int64_t)co * Cin + ci) * kTaps;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) row[t] = acc[c][t];
  }
}

// out[i] = sum over the chunks, in chunk order, of ws[chunk * n + i]
__global__ void sum_chunks_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                  int64_t n, int chunks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += ws[c * n + i];
  out[i] = s;
}

template <typename T>
int launch(const void* x, const void* g, void* out, void* ws, int B, int H, int W, int Cin,
           int Cout, int n_chunks, int chunk_pixels, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || n_chunks <= 0 ||
      chunk_pixels <= 0 || (int64_t)n_chunks * chunk_pixels < (int64_t)B * H * W ||
      (n_chunks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Cin + kBCi - 1) / kBCi, (Cout + kBCo - 1) / kBCo, n_chunks);
  float* dst = static_cast<float*>(n_chunks > 1 ? ws : out);
  conv_dw_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                              static_cast<const T*>(g), dst, B, H, W, Cin,
                                              Cout, chunk_pixels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  const int64_t n = (int64_t)Cout * Cin * kTaps;
  sum_chunks_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) and g (B, H, W, Cout), contiguous; out (Cout, Cin, 3, 3)
// f32. The pixels split into n_chunks chunks of chunk_pixels (the last may
// be short); ws holds n_chunks * Cout * Cin * 9 f32 partial sums and may be
// null when n_chunks == 1.
int conv_dw_f32(const void* x, const void* g, void* out, void* ws, int B, int H, int W,
                int Cin, int Cout, int n_chunks, int chunk_pixels, void* stream) {
  return launch<float>(x, g, out, ws, B, H, W, Cin, Cout, n_chunks, chunk_pixels, stream);
}

int conv_dw_bf16(const void* x, const void* g, void* out, void* ws, int B, int H, int W,
                 int Cin, int Cout, int n_chunks, int chunk_pixels, void* stream) {
  return launch<__nv_bfloat16>(x, g, out, ws, B, H, W, Cin, Cout, n_chunks, chunk_pixels,
                               stream);
}

}  // extern "C"
