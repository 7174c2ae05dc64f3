// The previous design of K2 (sample_banked), kept as it was so that the current kernel
// can be timed against it in one process (chip_smoke.py, kernels/ab.py).
// The port never calls it. Its own notes follow.
//
// Nearest-texel palette sampling for the 96x96 rasterizer: for env b and
// pixel p of the flat (72, 128) image plane,
//   px = (c*rx[p] + s*ry[p]) + pos_x      py = ((-s)*rx[p] + c*ry[p]) + pos_y
//   fx = (px + PLAYFIELD) * scale         fy = (py + PLAYFIELD) * scale
//   out[b, p] = tex[track_ids[b], floor(fx), floor(fy)] if 0 <= fx, fy < T
//               else 0
// with the bank tex of shape (U, T, T) uint8 and out (B, 72, 128) int32.
//
// Replaces the Pallas TPU kernel
// state_policy_diffusionmodel_tpu/render/pallas_sampler.py::sample_banked
// (body _kernel). The TPU has no per-lane gather, so that kernel DMAs a
// 136x256 texel window into VMEM and selects texels with int8 one-hot
// matmuls. Hopper gathers directly: one thread per output pixel, one byte
// read through the read-only cache.
//
// Bound on an H100: bytes. Per env the kernel writes 9216 x 4 B = 36.9 KB
// and reads the distinct texels under the viewport (about 61.7 x 49.4
// world units at 0.651 units per texel, ~7.2k bytes); ~10 flops a pixel
// are far below the float32 rate. At B = 1024 that is ~45 MB, ~13.5 us at
// 3.35 TB/s. The design reads each input once (the rx, ry planes are
// shared by all envs and stay in L2), writes the output once with
// neighbouring threads on neighbouring words, and keeps the texel map in
// registers.
//
// Numerics: the map is written with __fmul_rn / __fadd_rn, which nvcc
// never contracts into FMAs. An FMA rounds once where the reference rounds
// twice, and that moves floor() across a texel boundary for some pixels;
// with these intrinsics the kernel computes the plain PyTorch version's
// float32 values exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 72 * 128;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sample_banked_kernel(const uint8_t* __restrict__ tex,
                     const int* __restrict__ track_ids,
                     const float* __restrict__ cos_a,
                     const float* __restrict__ sin_a,
                     const float* __restrict__ pos,
                     const float* __restrict__ rx,
                     const float* __restrict__ ry,
                     int* __restrict__ out, int U, int T,
                     float playfield, float scale) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= kPixels) return;
  const int tid = __ldg(track_ids + b);
  const float c = __ldg(cos_a + b);
  const float s = __ldg(sin_a + b);
  const float x0 = __ldg(pos + 2 * b);
  const float y0 = __ldg(pos + 2 * b + 1);
  const float r_x = __ldg(rx + p);
  const float r_y = __ldg(ry + p);

  const float px = __fadd_rn(__fadd_rn(__fmul_rn(c, r_x), __fmul_rn(s, r_y)), x0);
  const float py = __fadd_rn(__fadd_rn(__fmul_rn(-s, r_x), __fmul_rn(c, r_y)), y0);
  const float fx = __fmul_rn(__fadd_rn(px, playfield), scale);
  const float fy = __fmul_rn(__fadd_rn(py, playfield), scale);
  const float tf = (float)T;

  int v = 0;
  if (fx >= 0.0f && fx < tf && fy >= 0.0f && fy < tf && tid >= 0 && tid < U) {
    const int i = (int)floorf(fx);
    const int j = (int)floorf(fy);
    v = __ldg(tex + ((size_t)tid * T + i) * T + j);
  }
  out[(size_t)b * kPixels + p] = v;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sample_banked_launch(const void* tex, const void* track_ids,
                         const void* cos_a, const void* sin_a, const void* pos,
                         const void* rx, const void* ry, void* out, int B,
                         int U, int T, float playfield, float scale,
                         void* stream) {
  if (B <= 0 || B > 65535 || U <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((kPixels + kThreads - 1) / kThreads, B);
  sample_banked_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tex, (const int*)track_ids, (const float*)cos_a,
      (const float*)sin_a, (const float*)pos, (const float*)rx,
      (const float*)ry, (int*)out, U, T, playfield, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
