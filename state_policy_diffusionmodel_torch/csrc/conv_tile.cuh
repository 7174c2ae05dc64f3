// Building blocks of the two implicit-GEMM 3x3 convolution kernels of the
// port: K3 (csrc/conv3x3.cu, the forward) and K6 (csrc/conv_dw.cu, the
// weight gradient). Both read NHWC activations through a halo tile.
//
// The halo tile. A 3x3 same-padded tap (di, dj) of the flat pixel
// p = (b*H + h)*W + w reads pixel p + (di-1)*W + (dj-1) when that lies inside
// the image, and zero otherwise. So the taps of a run of `n` consecutive
// pixels starting at p0 read only pixels in [p0 - W - 1, p0 + n + W + 1): a
// K step stages that window of n + 2W + 2 pixels once (one row of its
// channel slice per pixel), plus one zero row after it, and a tap becomes an
// offset into shared memory. Which taps of a pixel lie inside the image is a
// 9-bit mask (tap_mask); a tap outside reads the zero row, so neither the
// image border nor the border between two images of the batch inside one
// tile costs a branch in the inner loop. On the tensor cores, ldmatrix takes
// one row address per lane, so each lane points at its pixel's tap row (or
// at the zero row): an im2col at no cost.
//
// Copies: cp.async of 16 bytes with the source size as an operand (0 writes
// 16 zero bytes and reads nothing), committed as one group per K step into a
// ring of `stages` shared-memory buffers; the consumer waits until at most
// stages - 2 groups are in flight, so stages - 1 steps are being copied
// while one is computed.
//
// Split K: the blocks that share an output tile (K3's split-K parts, K6's
// pixel chunks) write f32 partial sums to a workspace, and a second kernel
// adds them in part order (sum_in_order), so two runs agree bit for bit (no
// atomics). K3's kernels of one call are chained by programmatic dependent
// launch (launch_after): the next one's blocks start while the last drains.
//
// The block-tile plan (tile widths, split) is chosen per shape in Python
// (models/cuda_ops.py conv3x3_plan, conv_dw_plan) and passed in as
// integers; each launcher checks it and refuses (cudaErrorInvalidValue) what
// it does not take. The ring's depth is the launcher's own (ring_stages):
// the shared-memory layout is known only here.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace conv_tile {

// the most dynamic shared memory one block may have on an H100
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; valid == false reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait until at most n committed groups are still in flight (n in 0..3)
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8, row l % 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// two matrices; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a * b, m16n8k16, bf16 inputs, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Bit di*3 + dj is set where tap (di, dj) of flat pixel p lies inside its
// image; 0 for p outside [0, n_pixels).
__device__ __forceinline__ int tap_mask(int p, int n_pixels, int H, int W) {
  if (p < 0 || p >= n_pixels) return 0;
  const int r = p % (H * W);
  const int h = r / W, w = r - (r / W) * W;
  int m = 0;
#pragma unroll
  for (int di = 0; di < 3; ++di)
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int hh = h + di - 1, ww = w + dj - 1;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) m |= 1 << (di * 3 + dj);
    }
  return m;
}

// the flat-pixel offset of tap (di, dj) = tap / 3, tap % 3
__device__ __forceinline__ int tap_delta(int tap, int W) {
  return (tap / 3 - 1) * W + (tap % 3 - 1);
}

// The taps a kernel computes: all nine, or where W == 1 only the middle
// column (dj = 1), since dj = 0 and 2 then lie in the zero halo for every
// pixel and their products are all zero.
template <int NT>
__host__ __device__ constexpr int tap_of(int t) {
  return NT == 9 ? t : 3 * t + 1;
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The deepest ring, 4, 3 or 2 stages of `stage_bytes` each beside `fixed`
// bytes, that fits in `limit` bytes of shared memory; 0 where none fits.
inline int ring_stages(long stage_bytes, long fixed, long limit) {
  for (int stages = 4; stages >= 2; --stages)
    if (stages * stage_bytes + fixed <= limit) return stages;
  return 0;
}

// src[0] + src[n] + ... + src[(parts - 1) * n], added in that order (so the
// sum is the same in every run) with eight loads in flight at a time.
__device__ __forceinline__ float sum_in_order(const float* __restrict__ src, long n, int parts) {
  float v = 0.f;
  int c = 0;
  for (; c + 8 <= parts; c += 8) {
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = src[(c + j) * n];
#pragma unroll
    for (int j = 0; j < 8; ++j) v += a[j];
  }
  for (; c < parts; ++c) v += src[c * n];
  return v;
}

// Let `kernel` launch with `bytes` of dynamic shared memory: above the
// 48 KB default a kernel has to opt in, up to the card's limit less its
// static shared memory. `allowed` keeps the most granted so far, so the
// attribute is set once per kernel and size.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long bytes, long& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// Launch `kernel` right behind the kernel before it on the stream
// (programmatic dependent launch): its blocks may be scheduled and run their
// preamble while that kernel drains, and call griddep_wait() before they
// read what it wrote or write anything. The kernel before it calls
// griddep_launch_dependents() once all its blocks are running.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, int threads, long smem,
                         cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Wait until the kernel before this one on the stream has finished and its
// writes are visible (a no-op in a kernel launched without launch_after).
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Let the kernel after this one on the stream be scheduled.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

}  // namespace conv_tile
