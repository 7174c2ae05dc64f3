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
// matmuls. Hopper gathers directly.
//
// Bound on an H100: bytes. Per env the kernel writes 9216 x 4 B = 36.9 KB
// and reads the distinct texels under the viewport (about 61.7 x 49.4
// world units at 0.651 units per texel, ~7.2k bytes); ~12 flops a pixel
// are far below the float32 rate. At B = 1024 that is ~45 MB, ~13.5 us at
// 3.35 TB/s. The design:
//   - a thread owns 4 consecutive pixels: float4 reads of rx and ry, one
//     16-byte store of the four int32 results;
//   - the grid is sized to the card, not to B: CTA (strip, g) renders its
//     strip of 1,024 pixels (8 screen rows) of envs g, g + groups, ...,
//     keeping its rx and ry in registers across the envs;
//   - the texels: the gathers stay __ldg. A 128-pixel screen row spans up
//     to ~95 texel rows (1,024 bytes apart) when the camera turns, so a
//     warp that rendered one screen row touched up to 32 L1 lines a
//     gather; a warp now renders a patch of 8 rows by 16 columns (pixel_of),
//     whose 32 pixels of a gather fall in about 12 texel rows or fewer.
// Measured on an H100 (kernels/ab.py, PERF.md): a copy of each env's texel
// window in shared memory (coalesced loads, rows 33 words apart, gathers
// from there), one CTA an env, ran slower than these gathers at headings
// 0, 45 and 90 degrees at B = 1024 and 256 (its copy precedes every env's
// gathers, and at B = 256 it has 256 CTAs).
// The grid (render/cuda_sampler.py sample_banked_plan) is Python.
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
constexpr int kCols = 128;
constexpr int kThreads = 256;
constexpr int kStrips = kPixels / (4 * kThreads);   // CTAs across an env: 9
static_assert(kThreads == 256 && kCols == 128, "pixel_of: 8 warps by 16 columns");

struct Args {
  const uint8_t* tex;
  const int* track_ids;
  const float* cos_a;
  const float* sin_a;
  const float* pos;
  const float* rx;
  const float* ry;
  int* out;
  int B, U, T;
  float playfield, scale;
};

struct Camera {
  float c, s, x0, y0;
  int tid;   // -1: not a track of the bank
};

__device__ __forceinline__ Camera camera(const Args& a, int b) {
  Camera k;
  k.c = __ldg(a.cos_a + b);
  k.s = __ldg(a.sin_a + b);
  k.x0 = __ldg(a.pos + 2 * b);
  k.y0 = __ldg(a.pos + 2 * b + 1);
  const int t = __ldg(a.track_ids + b);
  k.tid = t >= 0 && t < a.U ? t : -1;
  return k;
}

// the texel coordinates of a pixel, rounded as the reference rounds them
__device__ __forceinline__ void texel(const Args& a, const Camera& k, float r_x, float r_y,
                                      float& fx, float& fy) {
  const float px = __fadd_rn(__fadd_rn(__fmul_rn(k.c, r_x), __fmul_rn(k.s, r_y)), k.x0);
  const float py = __fadd_rn(__fadd_rn(__fmul_rn(-k.s, r_x), __fmul_rn(k.c, r_y)), k.y0);
  fx = __fmul_rn(__fadd_rn(px, a.playfield), a.scale);
  fy = __fmul_rn(__fadd_rn(py, a.playfield), a.scale);
}

// four consecutive pixels of env b from p0 on, stored as one int4
__device__ __forceinline__ void render4(const Args& a, const Camera& k, float4 r_x, float4 r_y,
                                        int b, int p0) {
  const uint8_t* tex = a.tex + (size_t)(k.tid < 0 ? 0 : k.tid) * a.T * a.T;
  const float tf = (float)a.T;
  const float rxs[4] = {r_x.x, r_x.y, r_x.z, r_x.w};
  const float rys[4] = {r_y.x, r_y.y, r_y.z, r_y.w};
  int v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float fx, fy;
    texel(a, k, rxs[e], rys[e], fx, fy);
    v[e] = 0;
    if (fx >= 0.0f && fx < tf && fy >= 0.0f && fy < tf && k.tid >= 0) {
      const int i = (int)floorf(fx), j = (int)floorf(fy);
      v[e] = __ldg(tex + (size_t)i * a.T + j);
    }
  }
  *reinterpret_cast<int4*>(a.out + (size_t)b * kPixels + p0) = make_int4(v[0], v[1], v[2], v[3]);
}

// The first of the four pixels thread t renders in strip s (8 screen rows
// of 128 pixels): warp w covers columns [16w, 16w + 16) of the 8 rows, lane
// l row l / 4 and columns 16w + 4 (l % 4) to + 3, so that a warp's 32
// gathers fall in a compact patch of texels.
__device__ __forceinline__ int pixel_of(int s, int t) {
  const int w = t / 32, l = t % 32;
  return (s * 8 + l / 4) * kCols + w * 16 + 4 * (l % 4);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// CTA (strip, g) renders its strip of envs g, g + groups, ...
__global__ void __launch_bounds__(kThreads) sample_banked_kernel(const Args a) {
  const int strip = blockIdx.x % kStrips, groups = gridDim.x / kStrips;
  const int p0 = pixel_of(strip, threadIdx.x);
  const float4 r_x = ld4(a.rx + p0), r_y = ld4(a.ry + p0);
  for (int b = blockIdx.x / kStrips; b < a.B; b += groups)
    render4(a, camera(a, b), r_x, r_y, b, p0);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success):
// groups x 9 CTAs (sample_banked_plan). rx, ry and out 16-byte aligned.
int sample_banked_launch(const void* tex, const void* track_ids, const void* cos_a,
                         const void* sin_a, const void* pos, const void* rx, const void* ry,
                         void* out, int B, int U, int T, float playfield, float scale, int groups,
                         void* stream) {
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  if (B <= 0 || U <= 0 || T <= 0 || groups <= 0 || groups > 0x7fffffff / kStrips ||
      !aligned(rx) || !aligned(ry) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)tex, (const int*)track_ids, (const float*)cos_a,
               (const float*)sin_a, (const float*)pos, (const float*)rx, (const float*)ry,
               (int*)out, B, U, T, playfield, scale};
  sample_banked_kernel<<<(unsigned)(groups * kStrips), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
