// 3x3 same-padded convolution of the denoiser U-Net's conv blocks, NHWC, no
// bias: out[b, h, w, co] = sum over (di, dj, ci) of
//   x[b, h + di - 1, w + dj - 1, ci] * w[co, ci, di, dj],
// with zeros outside the image, accumulated in f32 and written in x's type.
//
// Replaces the Pallas TPU kernel
// state_policy_diffusionmodel_tpu/models/pallas_ops.py::_conv3x3_pallas
// (body _conv_kernel): nine shifted (rows, Cin) x (Cin, Cout) matmuls over a
// zero-padded VMEM block of whole batch elements. Here the same product is
// an implicit GEMM, M = B*H*W output pixels, N = Cout, K = 9*Cin, and the
// zero halo is a bounds test on each input pixel, so neither a padded copy
// nor an im2col tensor goes to device memory.
//
// Weights are read as the port stores them, OIHW (Cout, Cin, 3, 3): for one
// output channel the K index ci*9 + tap is contiguous, so a K step of kCK
// input channels and all nine taps is one contiguous run per output channel
// and the weight tile loads coalesced. No weight copy is made per call.
//
// Bound on an H100: one r5blend U-Net forward at B=256 runs 30 such convs,
// 187 GFLOP against ~0.55 GB of activations in fp32, so the operations
// bound it (2.79 ms at the 67 TFLOP/s fp32 rate outside the tensor cores;
// 0.16 ms for the bytes). This first kernel runs on the CUDA cores in both
// types:
//   - a block owns BM = 16*TM output pixels and kBN = 64 output channels;
//     256 threads each hold a TM x 4 register tile of f32 sums;
//   - each K step stages kCK = 4 input channels x 9 taps of the block's
//     pixels (A, transposed so a thread reads its TM pixels as one vector)
//     and of the block's output channels (B) in shared memory as f32;
//   - the launcher takes the largest TM in {8, 4, 2} that still gives two
//     blocks per SM, so the 8x2 and 4x1 levels (M = 4096 and 1024 at
//     B=256) fill the card.
// bf16 runs on the tensor cores (conv3x3_mma_kernel) where Cin % 16 == 0
// and Cout % 8 == 0, which holds at every r5blend shape: 128 threads own a
// 64-pixel x 64-channel tile as four 32x32 warp tiles of mma.sync
// m16n8k16 (bf16 in, f32 accumulate); a K step is 16 input channels x 9
// taps, staged in shared memory as bf16 with the K index ordered tap-major
// (tap*16 + ci), so each m16n8k16 slice is one tap and the fragments load
// as 32-bit pairs. The weights' OIHW order (ci*9 + tap) is permuted into
// that order as the tile is stored. Other bf16 shapes take the CUDA-core
// kernel with bf16 widened to f32 when staged. Either way each bf16 x bf16
// product is exact in f32 and the sum is f32, rounded to bf16 once at the
// output, as _conv_kernel does (preferred_element_type=f32, then astype).
// wgmma and TMA are left to a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kBN = 64;         // output channels per block
constexpr int kTN = 4;          // output channels per thread
constexpr int kCK = 4;          // input channels per K step
constexpr int kKS = 9 * kCK;    // K rows per step
constexpr int kBNP = kBN + 4;   // padded row of the weight tile (16 B aligned)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive channels of one pixel as f32. vec: the four lie in one
// aligned vector (Cin % 4 == 0 and an aligned base); else each channel at or
// past cin_left reads as 0.
__device__ __forceinline__ void load4(const float* p, int cin_left, bool vec, float (&v)[4]) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < cin_left ? p[i] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int cin_left, bool vec,
                                      float (&v)[4]) {
  if (vec) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < cin_left ? __bfloat162float(p[i]) : 0.f;
  }
}

// Four consecutive output channels of one pixel; vec: Cout % 4 == 0.
__device__ __forceinline__ void store4(float* p, const float (&v)[4], int n_left, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_left) p[i] = v[i];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4], int n_left,
                                       bool vec) {
  if (vec) {
    uint2 q;
    *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_left) p[i] = __float2bfloat16_rn(v[i]);
  }
}

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int M, int H, int W, int Cin, int Cout, int vec_in, int vec_out) {
  constexpr int BM = 16 * TM;
  constexpr int kPairs = BM * 9;                                  // (pixel, tap)
  constexpr int kPairsPerThread = (kPairs + kThreads - 1) / kThreads;
  __shared__ __align__(16) float As[kKS][BM];     // As[ci*9 + tap][pixel]
  __shared__ __align__(16) float Bs[kKS][kBNP];   // Bs[ci*9 + tap][out channel]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int HW = H * W;
  const int K9 = 9 * Cin;

  // The (pixel, tap) pairs this thread stages are the same in every K step:
  // the element offset of each pair's input pixel, or -1 where the tap falls
  // in the zero halo (or past the last pixel).
  int a_off[kPairsPerThread];
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    const int idx = tid + i * kThreads;
    a_off[i] = -1;
    if (idx < kPairs) {
      const int m = idx % BM, tap = idx / BM;
      const int gm = m0 + m;
      if (gm < M) {
        const int b = gm / HW, r = gm - b * HW;
        const int h = r / W + tap / 3 - 1;
        const int ww = r % W + tap % 3 - 1;
        if (h >= 0 && h < H && ww >= 0 && ww < W) a_off[i] = ((b * H + h) * W + ww) * Cin;
      }
    }
  }

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCK) {
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kPairs) {
        const int m = idx % BM, tap = idx / BM;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (a_off[i] >= 0) load4(x + a_off[i] + c0, Cin - c0, vec_in != 0, v);
#pragma unroll
        for (int ci = 0; ci < kCK; ++ci) As[ci * 9 + tap][m] = v[ci];
      }
    }
    for (int idx = tid; idx < kBN * kKS; idx += kThreads) {
      const int j = idx % kKS, n = idx / kKS;
      const int k = c0 * 9 + j;
      Bs[j][n] = (n0 + n < Cout && k < K9) ? to_f32(w[(long)(n0 + n) * K9 + k]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kKS; ++k) {
      float a[TM], bv[kTN];
#pragma unroll
      for (int i = 0; i < TM; i += 2) {
        const float2 q = *reinterpret_cast<const float2*>(&As[k][ty * TM + i]);
        a[i] = q.x; a[i + 1] = q.y;
      }
      const float4 q = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
      bv[0] = q.x; bv[1] = q.y; bv[2] = q.z; bv[3] = q.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int n = n0 + tx * kTN;
  if (n >= Cout) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm < M) store4(out + (long)gm * Cout + n, acc[i], Cout - n, vec_out != 0);
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kMmaThreads = 128;       // 4 warps, 2 x 2 warp tiles of 32 x 32
constexpr int kMmaBM = 64;             // pixels per block
constexpr int kMmaBN = 64;             // output channels per block
constexpr int kMmaCK = 16;             // input channels per K step
constexpr int kMmaKS = 9 * kMmaCK;     // K per step: 9 m16n8k16 slices
constexpr int kMmaLD = kMmaKS + 8;     // padded row: fragment loads hit 32 banks

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaThreads)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int M, int H, int W, int Cin, int Cout) {
  constexpr int kPairs = kMmaBM * 9;                              // (pixel, tap)
  constexpr int kPairsPerThread = (kPairs + kMmaThreads - 1) / kMmaThreads;
  constexpr int kVecPerRow = kMmaKS / 8;                          // 16-byte vectors
  // As[pixel][tap*16 + ci], Bs[out channel][tap*16 + ci]
  __shared__ __align__(16) __nv_bfloat16 As[kMmaBM * kMmaLD];
  __shared__ __align__(16) __nv_bfloat16 Bs[kMmaBN * kMmaLD];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;            // mma fragment coordinates
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.x * kMmaBM;
  const int n0 = blockIdx.y * kMmaBN;
  const int HW = H * W;
  const int K9 = 9 * Cin;

  int a_off[kPairsPerThread];
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    const int idx = tid + i * kMmaThreads;
    a_off[i] = -1;
    if (idx < kPairs) {
      const int m = idx % kMmaBM, tap = idx / kMmaBM;
      const int gm = m0 + m;
      if (gm < M) {
        const int b = gm / HW, r = gm - b * HW;
        const int h = r / W + tap / 3 - 1;
        const int ww = r % W + tap % 3 - 1;
        if (h >= 0 && h < H && ww >= 0 && ww < W) a_off[i] = ((b * H + h) * W + ww) * Cin;
      }
    }
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kMmaCK) {
    // A: 16 channels of each (pixel, tap) as two 16-byte vectors
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      const int idx = tid + i * kMmaThreads;
      if (idx < kPairs) {
        const int m = idx % kMmaBM, tap = idx / kMmaBM;
        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
        if (a_off[i] >= 0) {
          const uint4* p = reinterpret_cast<const uint4*>(x + a_off[i] + c0);
          lo = p[0];
          hi = p[1];
        }
        uint4* q = reinterpret_cast<uint4*>(As + m * kMmaLD + tap * kMmaCK);
        q[0] = lo;
        q[1] = hi;
      }
    }
    // B: each output channel's contiguous run w[n][c0*9 .. c0*9 + 144) in
    // 16-byte vectors, element ci*9 + tap stored at tap*16 + ci
    for (int idx = tid; idx < kMmaBN * kVecPerRow; idx += kMmaThreads) {
      const int n = idx / kVecPerRow, v = idx % kVecPerRow;
      uint4 q = make_uint4(0, 0, 0, 0);
      if (n0 + n < Cout)
        q = *reinterpret_cast<const uint4*>(w + (long)(n0 + n) * K9 + c0 * 9 + v * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = v * 8 + k, ci = j / 9, tap = j - ci * 9;
        Bs[n * kMmaLD + tap * kMmaCK + ci] = e[k];
      }
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int k0 = s * kMmaCK + 2 * t;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* r0 = As + (wm + i * 16 + g) * kMmaLD + k0;
        const __nv_bfloat16* r8 = r0 + 8 * kMmaLD;
        a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* c = Bs + (wn + j * 8 + g) * kMmaLD + k0;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(c);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(c + 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + j * 8 + 2 * t;
      if (n >= Cout) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm + i * 16 + g + 8 * h;
        if (gm < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (long)gm * Cout + n) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// The tensor-core kernel's conditions: whole 16-channel K steps, 8-channel
// fragments, 16-byte aligned rows of x and w.
bool takes_mma(const void* x, const void* w, int Cin, int Cout) {
  return Cin % kMmaCK == 0 && Cout % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
}

template <typename T, int TM>
int launch_tm(const void* x, const void* w, void* out, int M, int H, int W, int Cin,
              int Cout, int vec_in, int vec_out, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + 16 * TM - 1) / (16 * TM)), (unsigned)((Cout + kBN - 1) / kBN));
  conv3x3_kernel<T, TM><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)out, M, H, W, Cin, Cout, vec_in, vec_out);
  return (int)cudaGetLastError();
}

// The row tile: the largest TM whose grid still holds two blocks per SM of
// an H100 (132 SMs); the smallest otherwise.
int pick_tm(long M, int Cout) {
  const long nb = (Cout + kBN - 1) / kBN;
  if (((M + 127) / 128) * nb >= 264) return 8;
  if (((M + 63) / 64) * nb >= 264) return 4;
  return 2;
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int H, int W, int Cin, int Cout,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const long M = (long)B * H * W;
  if (M * Cin >= (1L << 31) || M * Cout >= (1L << 31) || (long)Cout * 9 * Cin >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  const size_t vec_bytes = 4 * sizeof(T);
  const int vec_in = Cin % 4 == 0 && (uintptr_t)x % vec_bytes == 0;
  const int vec_out = Cout % 4 == 0 && (uintptr_t)out % vec_bytes == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (sizeof(T) == 2 && takes_mma(x, w, Cin, Cout)) {
    const dim3 grid((unsigned)((M + kMmaBM - 1) / kMmaBM), (unsigned)((Cout + kMmaBN - 1) / kMmaBN));
    conv3x3_mma_kernel<<<grid, kMmaThreads, 0, s>>>((const __nv_bfloat16*)x,
                                                    (const __nv_bfloat16*)w,
                                                    (__nv_bfloat16*)out, (int)M, H, W, Cin, Cout);
    return (int)cudaGetLastError();
  }
  switch (pick_tm(M, Cout)) {
    case 8: return launch_tm<T, 8>(x, w, out, (int)M, H, W, Cin, Cout, vec_in, vec_out, s);
    case 4: return launch_tm<T, 4>(x, w, out, (int)M, H, W, Cin, Cout, vec_in, vec_out, s);
    default: return launch_tm<T, 2>(x, w, out, (int)M, H, W, Cin, Cout, vec_in, vec_out, s);
  }
}

}  // namespace

extern "C" {

int conv3x3_f32(const void* x, const void* w, void* out, int B, int H, int W, int Cin,
                int Cout, void* stream) {
  return launch<float>(x, w, out, B, H, W, Cin, Cout, stream);
}

int conv3x3_bf16(const void* x, const void* w, void* out, int B, int H, int W, int Cin,
                 int Cout, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, B, H, W, Cin, Cout, stream);
}

}  // extern "C"
