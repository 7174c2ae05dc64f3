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
// to the next. Here the product is a GEMM with M = Cout, N = 9*Cin and a
// long K = B*H*W pixels, and the K axis is split:
//   - a block owns 64 output channels x 32 input channels x the taps, and
//     one chunk of the pixels (models/cuda_ops.py conv_dw_plan picks the
//     chunks so that the grid holds about two blocks per SM at every level
//     of the U-Net: the 32x8 level has 65,536 pixels and as few as two
//     channel tiles, the 4x1 level 1,024 pixels and up to 128);
//   - a K step stages, with cp.async into a ring of stages (4, or fewer
//     where a wide image's patch leaves no room: conv_dw_ring), its pixels'
//     g rows and the halo tile of x (csrc/conv_tile.cuh): the step's pixels
//     and the W + 1 on each side, once, so a tap is an offset into shared
//     memory and no x element is read nine times; on the tensor cores the
//     pixels' tap masks come from a per-block table of one image's
//     positions;
//   - every chunk writes its f32 partial sums to a workspace
//     [chunk][co][tap][ci], and conv_dw_sum_kernel adds the chunks in chunk
//     order into the OIHW output (the port's weight layout), so two runs
//     agree bit for bit (no atomics);
//   - bf16 (Cin % 8 == 0, Cout % 8 == 0: every r5blend shape) runs on the
//     tensor cores, mma.sync m16n8k16 with f32 sums: A = g^T comes from the
//     [pixel][co] tile through ldmatrix.trans, B = x at a tap from the patch
//     through ldmatrix.trans with one row address per lane (each lane's
//     pixel's tap row, or a zero row outside the image). 4 warps, each 64
//     output channels x 8 input channels x the taps. Where W == 1 only the
//     taps dj = 1 are computed: the others lie in the zero halo for every
//     pixel, so their sums are exactly zero and the second pass writes 0;
//   - fp32 (and the other bf16 shapes, widened as they are staged) runs on
//     the CUDA cores: 192 threads, each 8 output channels x 3 taps x 4 input
//     channels (96 f32 sums) fed per pixel by 2 float4 loads of g and 3 of
//     x, 5 shared loads per 96 FMAs.
// Each bf16 x bf16 product is exact in f32 and the sum is f32, as
// _dw_kernel's dots with preferred_element_type=f32 are.
//
// Bound on an H100: one r5blend training step at B=256 runs 31 such
// gradients, ~192 GFLOP against ~1 GB of x and g in fp32, so the operations
// bound it (2.87 ms at the 67 TFLOP/s fp32 rate outside the tensor cores,
// 0.195 ms at 989 TFLOP/s bf16).

#include "conv_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using conv_tile::cp_async16;
using conv_tile::cp_async_commit;
using conv_tile::cp_async_wait;
using conv_tile::cp_async_wait_pending;
using conv_tile::kMaxSmem;
using conv_tile::ring_stages;
using conv_tile::round_up;
using conv_tile::smem_u32;
using conv_tile::tap_delta;
using conv_tile::tap_mask;
using conv_tile::tap_of;
using conv_tile::to_f32;

constexpr int kBCo = 64;        // output channels a block
constexpr int kBCi = 32;        // input channels a block
// tensor cores: 4 warps along the input channels (8 each), each with all
// 64 output channels
constexpr int kMmaThreads = 128;
constexpr int kMmaKP = 64;      // pixels a K step (tensor cores)
constexpr int kSimtThreads = 192;
constexpr int kSimtKP = 32;     // pixels a K step (CUDA cores)

// A pixel's tap mask (which of its taps lie inside its image) is a function
// of its position in the image, p % (H*W). The tensor-core kernel, where
// one image's positions fit (kMaskTable), tabulates their masks once in
// shared memory after its ring, and each loader thread walks its pixel's
// position forward a K step at a time: a mask is then one shared load and
// no division (on an H100 the table took 5% off bf16 K6:
// tools/sweep_conv_plans.py --ab mask_table). The CUDA cores' kernel,
// whose longer steps hide the division, computes each mask.
constexpr int kMaskTable = 4096;

__host__ __device__ constexpr int mask_table_bytes(int H, int W) {
  return H * W <= kMaskTable ? round_up(H * W * 4, 128) : 0;
}

// ---- bf16 on the tensor cores -------------------------------------------

// one ring stage in bf16 elements: the g tile (KP pixels x 64 channels and
// 8 of padding: ldmatrix's eight rows fall on eight distinct bank groups),
// the x patch (KP + 2W + 2 pixels and the zero row, 32 channels and 8 of
// padding), and KP int tap masks
__host__ __device__ constexpr int mma_patch_elems(int W) {
  return round_up((kMmaKP + 2 * W + 3) * (kBCi + 8), 64);
}
__host__ __device__ constexpr int mma_stage_elems(int W) {
  return kMmaKP * (kBCo + 8) + mma_patch_elems(W) + 2 * kMmaKP;
}

template <int NT>
__global__ void __launch_bounds__(kMmaThreads, 2)
conv_dw_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                   float* __restrict__ ws, int P, int H, int W, int Cin, int Cout,
                   int chunk_pixels, int stages) {
  constexpr int KP = kMmaKP, GROW = kBCo + 8, XROW = kBCi + 8, G_ELEMS = KP * GROW;
  constexpr int MF = kBCo / 16;                 // m16 fragments a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int Q = KP + 2 * W + 2;                 // patch rows; row Q is zero
  const int x_elems = mma_patch_elems(W);
  const int stage_elems = mma_stage_elems(W);
  const int tid = threadIdx.x, lane = tid & 31, wci = tid >> 5;
  const int ci0 = blockIdx.x * kBCi, co0 = blockIdx.y * kBCo;
  const int p_begin = blockIdx.z * chunk_pixels;
  const int p_end = min(P, p_begin + chunk_pixels);
  const int nk = (p_end - p_begin + KP - 1) / KP;
  const int HW = H * W;
  int* table = nullptr;
  if (mask_table_bytes(H, W) > 0) {
    table = reinterpret_cast<int*>(smem_raw + (long)stages * stage_elems * 2);
    for (int i = tid; i < HW; i += kMmaThreads) table[i] = tap_mask(i, HW, H, W);
    __syncthreads();
  }
  // loader thread tid < KP: the position in its image of its pixel of the
  // next step to load
  int pos = (p_begin + tid) % HW;
  const int pos_step = KP % HW;

  auto load = [&](int buf, int step) {
    bf16* G = smem + buf * stage_elems;
    bf16* X = G + G_ELEMS;
    int* mask = reinterpret_cast<int*>(X + x_elems);
    const int p0 = p_begin + step * KP;
    for (int i = tid; i < KP * (kBCo / 8); i += kMmaThreads) {
      const int pl = i >> 3, c = i & 7;
      const int p = p0 + pl;
      const bool ok = p < p_end && co0 + c * 8 < Cout;
      cp_async16(smem_u32(G + pl * GROW + c * 8), ok ? g + (long)p * Cout + co0 + c * 8 : g, ok);
    }
    for (int i = tid; i < (Q + 1) * (kBCi / 8); i += kMmaThreads) {
      const int q = i >> 2, c = i & 3;
      const int p = p0 - W - 1 + q;
      const bool ok = q < Q && p >= 0 && p < P && ci0 + c * 8 < Cin;
      cp_async16(smem_u32(X + q * XROW + c * 8), ok ? x + (long)p * Cin + ci0 + c * 8 : x, ok);
    }
    if (tid < KP) {
      const int p = p0 + tid;
      mask[tid] = p >= p_end ? 0 : table != nullptr ? table[pos] : tap_mask(p, P, H, W);
      pos += pos_step;
      if (pos >= HW) pos -= HW;
    }
  };

  for (int s = 0; s < stages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  // A (g^T, m = output channel, k = pixel) from the [pixel][co] tile: lane
  // l gives pixel row ((l / 16) % 2) * 8 + l % 8 at channel ((l / 8) % 2) * 8
  // of each m16 fragment. B (x at a tap, k = pixel, n = input channel):
  // lane l's pixel is ((l / 8) % 2) * 8 + l % 8 of the k16 slice, and its
  // tap the pair's first (l < 16) or second
  const int a_krow = ((lane >> 4) & 1) * 8 + (lane & 7);
  const int a_mcol = ((lane >> 3) & 1) * 8;
  const int b_kpix = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int hi = lane >> 4;

  float acc[MF][NT][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k = 0; k < nk; ++k) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    const int kn = k + stages - 1;
    if (kn < nk) load(kn % stages, kn);
    cp_async_commit();

    const bf16* G = smem + (k % stages) * stage_elems;
    const bf16* X = G + G_ELEMS;
    const int* mask = reinterpret_cast<const int*>(X + x_elems);
    const uint32_t g_base = smem_u32(G);
    const uint32_t x_base = smem_u32(X) + wci * 16;
    const uint32_t x_zero = x_base + Q * XROW * 2;
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      uint32_t af[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
        conv_tile::ldmatrix_x4_trans(
            af[mf], g_base + (uint32_t)((kk * 16 + a_krow) * GROW + a_mcol + mf * 16) * 2);
      const int kpix = kk * 16 + b_kpix;
      const int mk = mask[kpix];
      const int qc = kpix + W + 1;
      uint32_t bfr[NT][2];
#pragma unroll
      for (int tp = 0; tp + 1 < NT; tp += 2) {
        const int tap = hi ? tap_of<NT>(tp + 1) : tap_of<NT>(tp);
        const int delta = hi ? tap_delta(tap_of<NT>(tp + 1), W) : tap_delta(tap_of<NT>(tp), W);
        const uint32_t addr =
            ((mk >> tap) & 1) ? x_base + (uint32_t)((qc + delta) * XROW) * 2 : x_zero;
        uint32_t r4[4];
        conv_tile::ldmatrix_x4_trans(r4, addr);
        bfr[tp][0] = r4[0];
        bfr[tp][1] = r4[1];
        bfr[tp + 1][0] = r4[2];
        bfr[tp + 1][1] = r4[3];
      }
      if constexpr (NT % 2 == 1) {
        constexpr int tap = tap_of<NT>(NT - 1);
        const uint32_t addr = ((mk >> tap) & 1)
                                  ? x_base + (uint32_t)((qc + tap_delta(tap, W)) * XROW) * 2
                                  : x_zero;
        uint32_t r2[2];
        conv_tile::ldmatrix_x2_trans(r2, addr);
        bfr[NT - 1][0] = r2[0];
        bfr[NT - 1][1] = r2[1];
      }
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int t = 0; t < NT; ++t) conv_tile::mma_bf16(acc[mf][t], af[mf], bfr[t]);
    }
  }
  cp_async_wait<0>();

  // output channels lane / 4 (+8), input channels 2 * (lane % 4) + {0, 1},
  // into this chunk's slab [co][tap][ci] of the workspace
  float* dst = ws + (long)blockIdx.z * Cout * 9 * Cin;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + mf * 16 + (lane >> 2) + 8 * h;
        const int ci = ci0 + wci * 8 + (lane & 3) * 2;
        if (co < Cout && ci < Cin)
          *reinterpret_cast<float2*>(dst + ((long)co * 9 + tap_of<NT>(t)) * Cin + ci) =
              make_float2(acc[mf][t][2 * h], acc[mf][t][2 * h + 1]);
      }
}

// ---- fp32 (and the other bf16 shapes) on the CUDA cores -------------------

// one ring stage in floats: the g tile (KP x 64), the x patch (KP + 2W + 2
// pixels and the zero row, 32 channels each) and KP int tap masks
__host__ __device__ constexpr int simt_patch_floats(int W) {
  return round_up((kSimtKP + 2 * W + 3) * kBCi, 32);
}
__host__ __device__ constexpr int simt_stage_floats(int W) {
  return kSimtKP * kBCo + simt_patch_floats(W) + kSimtKP;
}

// Four consecutive channels of one pixel into shared memory as f32: with
// VEC one 16-byte cp.async, else element loads (n_left channels remain).
template <typename T, bool VEC>
__device__ __forceinline__ void stage4(float* dst, const T* src, bool ok, int n_left,
                                       const T* any) {
  if constexpr (VEC) {
    cp_async16(smem_u32(dst), ok ? (const void*)src : (const void*)any, ok);
  } else {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (ok) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n_left) v[e] = to_f32(src[e]);
    }
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kSimtThreads, 2)
conv_dw_simt_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ ws,
                    int P, int H, int W, int Cin, int Cout, int chunk_pixels, int stages) {
  constexpr int KP = kSimtKP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int Q = KP + 2 * W + 2;
  const int x_floats = simt_patch_floats(W);
  const int stage_floats = simt_stage_floats(W);
  const int tid = threadIdx.x;
  // thread: input channels ci_g*4 + {0..3}, taps tap_g*3 + {0, 1, 2},
  // output channels co_g*8 + {0..7}
  const int ci_g = tid & 7, tap_g = (tid >> 3) % 3, co_g = tid / 24;
  const int ci0 = blockIdx.x * kBCi, co0 = blockIdx.y * kBCo;
  const int p_begin = blockIdx.z * chunk_pixels;
  const int p_end = min(P, p_begin + chunk_pixels);
  const int nk = (p_end - p_begin + KP - 1) / KP;

  auto load = [&](int buf, int step) {
    float* G = smem + buf * stage_floats;
    float* X = G + KP * kBCo;
    int* mask = reinterpret_cast<int*>(X + x_floats);
    const int p0 = p_begin + step * KP;
    for (int i = tid; i < KP * (kBCo / 4); i += kSimtThreads) {
      const int pl = i >> 4, c = i & 15;
      const int p = p0 + pl, co = co0 + c * 4;
      stage4<T, VEC>(G + pl * kBCo + c * 4, g + (long)p * Cout + co, p < p_end && co < Cout,
                     Cout - co, g);
    }
    for (int i = tid; i < (Q + 1) * (kBCi / 4); i += kSimtThreads) {
      const int q = i >> 3, c = i & 7;
      const int p = p0 - W - 1 + q, ci = ci0 + c * 4;
      stage4<T, VEC>(X + q * kBCi + c * 4, x + (long)p * Cin + ci,
                     q < Q && p >= 0 && p < P && ci < Cin, Cin - ci, x);
    }
    if (tid < KP) mask[tid] = p0 + tid < p_end ? tap_mask(p0 + tid, P, H, W) : 0;
  };

  for (int s = 0; s < stages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  float acc[8][3][4];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  // tap tap_g*3 + j of pixel pl reads patch row pl + dbase + j
  const int dbase = W + 1 + (tap_g - 1) * W - 1;
  const int shift = 3 * tap_g;

  for (int k = 0; k < nk; ++k) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    const int kn = k + stages - 1;
    if (kn < nk) load(kn % stages, kn);
    cp_async_commit();

    const float* G = smem + (k % stages) * stage_floats;
    const float* X = G + KP * kBCo;
    const int* mask = reinterpret_cast<const int*>(X + x_floats);
#pragma unroll 4
    for (int pl = 0; pl < KP; ++pl) {
      const int mk = mask[pl] >> shift;
      const float4 ga = *reinterpret_cast<const float4*>(G + pl * kBCo + co_g * 8);
      const float4 gb = *reinterpret_cast<const float4*>(G + pl * kBCo + co_g * 8 + 4);
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int off = ((mk >> j) & 1) ? pl + dbase + j : Q;
        const float4 xv = *reinterpret_cast<const float4*>(X + off * kBCi + ci_g * 4);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc[c][j][0] = fmaf(gv[c], xv.x, acc[c][j][0]);
          acc[c][j][1] = fmaf(gv[c], xv.y, acc[c][j][1]);
          acc[c][j][2] = fmaf(gv[c], xv.z, acc[c][j][2]);
          acc[c][j][3] = fmaf(gv[c], xv.w, acc[c][j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // into this chunk's slab [co][tap][ci] of the workspace
  float* dst = ws + (long)blockIdx.z * Cout * 9 * Cin;
  const int ci = ci0 + ci_g * 4;
  if (ci >= Cin) return;
  const bool vec = (Cin & 3) == 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int co = co0 + co_g * 8 + c;
    if (co >= Cout) break;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float* row = dst + ((long)co * 9 + tap_g * 3 + j) * Cin + ci;
      if (vec) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[c][j][0], acc[c][j][1], acc[c][j][2], acc[c][j][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ci + e < Cin) row[e] = acc[c][j][e];
      }
    }
  }
}

// ---- the chunks added in order, [chunk][co][tap][ci] -> OIHW ------------

__global__ void __launch_bounds__(32 * 9)
conv_dw_sum_kernel(const float* __restrict__ ws, float* __restrict__ out, int Cin, int Cout,
                   int chunks, int taps) {
  __shared__ float s[32 * 9];
  const int ci0 = blockIdx.x * 32, co = blockIdx.y;
  const int tid = threadIdx.x, tap = tid >> 5, cil = tid & 31, ci = ci0 + cil;
  float v = 0.f;
  // taps == 3: only dj = 1 was computed; the others are exactly zero
  if (ci < Cin && (taps == 9 || tap % 3 == 1)) {
    const long n = (long)Cout * 9 * Cin;
    const float* src = ws + ((long)co * 9 + tap) * Cin + ci;
    v = conv_tile::sum_in_order(src, n, chunks);
  }
  s[cil * 9 + tap] = v;
  __syncthreads();
  if (tid < min(32, Cin - ci0) * 9) out[((long)co * Cin + ci0) * 9 + tid] = s[tid];
}

// ---- launcher ------------------------------------------------------------

template <int NT>
cudaError_t launch_mma(dim3 grid, long smem, cudaStream_t s, const bf16* x, const bf16* g,
                       float* ws, int P, int H, int W, int Cin, int Cout, int chunk_pixels,
                       int stages) {
  static long allowed = 48 * 1024;
  const cudaError_t err = conv_tile::allow_smem(conv_dw_mma_kernel<NT>, smem, allowed);
  if (err != cudaSuccess) return err;
  conv_dw_mma_kernel<NT><<<grid, kMmaThreads, (size_t)smem, s>>>(x, g, ws, P, H, W, Cin, Cout,
                                                                 chunk_pixels, stages);
  return cudaSuccess;
}

// The ring's depth for a route: the deepest whose stages fit (beside the
// tensor cores' mask table), 0 where none fits.
int ring(int mma, int H, int W) {
  return mma ? ring_stages((long)mma_stage_elems(W) * 2, mask_table_bytes(H, W), kMaxSmem)
             : ring_stages((long)simt_stage_floats(W) * 4, 0, kMaxSmem);
}

template <typename T>
int launch(const void* x, const void* g, void* out, void* ws, int B, int H, int W, int Cin,
           int Cout, int mma, int taps, int n_chunks, int chunk_pixels, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const long P = (long)B * H * W;
  if (P * Cin >= (1L << 31) || P * Cout >= (1L << 31) || (long)Cout * 9 * Cin >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  const int kp = mma ? kMmaKP : kSimtKP;
  if (ws == nullptr || n_chunks <= 0 || chunk_pixels <= 0 ||
      chunk_pixels % kp != 0 || (long)n_chunks * chunk_pixels < P ||
      (long)(n_chunks - 1) * chunk_pixels >= P || (long)n_chunks * Cout * 9 * Cin >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  if (mma && (sizeof(T) != 2 || Cin % 8 != 0 || Cout % 8 != 0 || (uintptr_t)x % 16 != 0 ||
              (uintptr_t)g % 16 != 0 || !(taps == 9 || (taps == 3 && W == 1))))
    return (int)cudaErrorInvalidValue;
  if (!mma && taps != 9) return (int)cudaErrorInvalidValue;
  const int stages = ring(mma, H, W);
  if (stages == 0) return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  const dim3 grid((unsigned)((Cin + kBCi - 1) / kBCi), (unsigned)((Cout + kBCo - 1) / kBCo),
                  (unsigned)n_chunks);
  cudaError_t err;
  if (mma) {
    const long smem = (long)stages * mma_stage_elems(W) * 2 + mask_table_bytes(H, W);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* gb = static_cast<const bf16*>(g);
    err = taps == 9 ? launch_mma<9>(grid, smem, s, xb, gb, part, (int)P, H, W, Cin, Cout,
                                    chunk_pixels, stages)
                    : launch_mma<3>(grid, smem, s, xb, gb, part, (int)P, H, W, Cin, Cout,
                                    chunk_pixels, stages);
    if (err != cudaSuccess) return (int)err;
  } else {
    const long smem = (long)stages * simt_stage_floats(W) * 4;
    const T* xt = static_cast<const T*>(x);
    const T* gt = static_cast<const T*>(g);
    const bool vec = sizeof(T) == 4 && Cin % 4 == 0 && Cout % 4 == 0 &&
                     (uintptr_t)x % 16 == 0 && (uintptr_t)g % 16 == 0;
    if (vec) {
      static long allowed = 48 * 1024;
      err = conv_tile::allow_smem(conv_dw_simt_kernel<T, true>, smem, allowed);
      if (err != cudaSuccess) return (int)err;
      conv_dw_simt_kernel<T, true><<<grid, kSimtThreads, (size_t)smem, s>>>(
          xt, gt, part, (int)P, H, W, Cin, Cout, chunk_pixels, stages);
    } else {
      static long allowed = 48 * 1024;
      err = conv_tile::allow_smem(conv_dw_simt_kernel<T, false>, smem, allowed);
      if (err != cudaSuccess) return (int)err;
      conv_dw_simt_kernel<T, false><<<grid, kSimtThreads, (size_t)smem, s>>>(
          xt, gt, part, (int)P, H, W, Cin, Cout, chunk_pixels, stages);
    }
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv_dw_sum_kernel<<<dim3((unsigned)((Cin + 31) / 32), (unsigned)Cout), 32 * 9, 0, s>>>(
      part, static_cast<float*>(out), Cin, Cout, n_chunks, mma ? taps : 9);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) and g (B, H, W, Cout), contiguous; out (Cout, Cin, 3, 3)
// f32. The plan (models/cuda_ops.py conv_dw_plan): mma (tensor cores, bf16
// only), taps (9, or 3 where W == 1 on the tensor cores), and the pixels
// split into n_chunks chunks of chunk_pixels (a whole number of K steps: 64
// pixels on the tensor cores, 32 otherwise; the last chunk may be short).
// ws holds n_chunks * Cout * 9 * Cin f32 partial sums.
int conv_dw_f32(const void* x, const void* g, void* out, void* ws, int B, int H, int W,
                int Cin, int Cout, int mma, int taps, int n_chunks, int chunk_pixels,
                void* stream) {
  return launch<float>(x, g, out, ws, B, H, W, Cin, Cout, mma, taps, n_chunks, chunk_pixels,
                       stream);
}

int conv_dw_bf16(const void* x, const void* g, void* out, void* ws, int B, int H, int W,
                 int Cin, int Cout, int mma, int taps, int n_chunks, int chunk_pixels,
                 void* stream) {
  return launch<__nv_bfloat16>(x, g, out, ws, B, H, W, Cin, Cout, mma, taps, n_chunks,
                               chunk_pixels, stream);
}

// The ring depth the launch of this route and image takes (0: it refuses).
int conv_dw_ring(int mma, int H, int W) { return ring(mma, H, W); }

}  // extern "C"
