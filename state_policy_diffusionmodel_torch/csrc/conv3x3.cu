// 3x3 same-padded convolution of the denoiser U-Net's conv blocks (K3), NHWC,
// no bias: out[b, h, w, co] = sum over (di, dj, ci) of
//   x[b, h + di - 1, w + dj - 1, ci] * w[co, ci, di, dj],
// with zeros outside the image, accumulated in f32 and written in x's type.
//
// Replaces the Pallas TPU kernel
// state_policy_diffusionmodel_tpu/models/pallas_ops.py::_conv3x3_pallas
// (body _conv_kernel): nine shifted (rows, Cin) x (Cin, Cout) matmuls over a
// zero-padded VMEM block of whole batch elements. Here the same product is
// an implicit GEMM, M = B*H*W output pixels, N = Cout, K = 9*Cin, with no
// padded copy and no im2col tensor in device memory.
//
// Bound on an H100: one r5blend U-Net forward at B=256 runs 30 such convs,
// 187 GFLOP against ~0.55 GB of activations in fp32, so the operations bound
// it in both types (2.79 ms at 67 TFLOP/s fp32 outside the tensor cores,
// 0.19 ms at 989 TFLOP/s bf16). The design (csrc/conv_tile.cuh):
//   - the halo tile: a block owns BM consecutive output pixels; each K step
//     stages its channel slice of the BM + 2W + 2 input pixels those pixels'
//     taps read, once, and every tap is an offset into that patch (a tap
//     outside the image reads a zero row). Each input element is read from
//     device memory once per block and N tile, not nine times;
//   - the weights are repacked per call by conv3x3_repack_kernel from OIHW
//     into a workspace [tap][ci][co] (zero-padded to whole tiles), so a K
//     row of the weight tile is one run of 16-byte vectors;
//   - both tiles are copied with cp.async into a ring of stages (4, or
//     fewer where a wide image's patch leaves no room: conv3x3_ring), so
//     the copies of the next K steps overlap the math of this one;
//   - bf16 (Cin % 16 == 0, Cout % 8 == 0: every r5blend shape) runs on the
//     tensor cores: 8 warps own 128 or 256 pixels x 64 channels (256 x 128
//     in the largest convs) as warp tiles of mma.sync m16n8k16 (bf16 in,
//     f32 sums; up to 64 x 64 in the large tile); a K step is 16 input
//     channels x 9 taps; A fragments come from the patch through ldmatrix
//     with one row address per lane (each lane's pixel's tap row: the
//     im2col costs nothing), B fragments through ldmatrix.trans;
//   - fp32 runs on the CUDA cores, not TF32 (its limit is 1e-5 of the
//     largest output): 256 threads own 256 pixels x 64 channels with 8 x 8
//     f32 register tiles; a K step is 4 input channels x 9 taps; a thread
//     reads its pixel's 4 channels at a tap as one float4 and its 8 weights
//     as two, 16 shared loads per 256 FMAs; other bf16 shapes take this
//     path with bf16 widened as it is staged;
//   - where W == 1 the taps dj = 0 and 2 lie in the zero halo for every
//     pixel, so only the three dj = 1 taps are computed (the result is
//     identical);
//   - split-K (where the pixels give too few blocks, as at the 8x2 and 4x1
//     levels): the channel slices split into parts, each part writes f32
//     partial sums into a workspace, and conv3x3_sum_splits_kernel adds the
//     parts in order and rounds once to the output type, so two runs agree
//     bit for bit. Without a split the f32 sums are rounded once at the
//     output, as _conv_kernel does (preferred_element_type=f32, astype);
//   - the two or three kernels of a call are chained by programmatic
//     dependent launch, so each one's launch and preamble overlap the tail
//     of the one before (on an H100 a small conv takes ~10-15 us, most of
//     it fixed cost).
// The plan (route, tile width, split) is chosen per shape in
// models/cuda_ops.py conv3x3_plan.

#include "conv_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using conv_tile::cp_async16;
using conv_tile::cp_async_commit;
using conv_tile::cp_async_wait;
using conv_tile::cp_async_wait_pending;
using conv_tile::from_f32;
using conv_tile::griddep_launch_dependents;
using conv_tile::griddep_wait;
using conv_tile::kMaxSmem;
using conv_tile::launch_after;
using conv_tile::ring_stages;
using conv_tile::round_up;
using conv_tile::smem_u32;
using conv_tile::tap_delta;
using conv_tile::tap_mask;
using conv_tile::tap_of;
using conv_tile::to_f32;

constexpr int kThreads = 256;
constexpr int kStaticSmem = 1024;   // room kept for a kernel's static row masks

// ---- weights: OIHW (Cout, Cin, 3, 3) -> wt[tap][ci][co], zero-padded -----

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
conv3x3_repack_kernel(const Tin* __restrict__ w, Tout* __restrict__ wt, int Cin, int Cout,
                      int cin_pad, int cout_pad) {
  // 32 output channels x 8 input channels x 9 taps: read as 32 runs of 72
  // contiguous elements, written as 72 rows of 32 output channels
  __shared__ float s[32][8 * 9 + 1];
  griddep_launch_dependents();
  const int ci0 = blockIdx.x * 8, co0 = blockIdx.y * 32;
  for (int i = threadIdx.x; i < 32 * 72; i += kThreads) {
    const int r = i / 72, e = i - r * 72;
    const int co = co0 + r, ci = ci0 + e / 9;
    s[r][e] = (co < Cout && ci < Cin) ? to_f32(w[((long)co * Cin + ci0) * 9 + e]) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * 8 * 32; i += kThreads) {
    const int col = i & 31, cil = (i >> 5) & 7, tap = i >> 8;
    const int co = co0 + col, ci = ci0 + cil;
    if (co < cout_pad && ci < cin_pad)
      wt[((long)tap * cin_pad + ci) * cout_pad + co] = from_f32<Tout>(s[col][cil * 9 + tap]);
  }
}

// ---- output: four channels of a pixel -------------------------------------

// Four consecutive output channels of one pixel; vec: Cout % 4 == 0 (the
// output is the wrapper's own, so aligned).
__device__ __forceinline__ void store4(float* p, const float* v, int n_left, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_left) p[i] = v[i];
  }
}

__device__ __forceinline__ void store4(bf16* p, const float* v, int n_left, bool vec) {
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

// ---- split-K: out[i] = the parts' f32 sums added in part order ------------

template <typename T>
__global__ void conv3x3_sum_splits_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                          long n, int splits) {
  griddep_wait();
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = from_f32<T>(conv_tile::sum_in_order(ws + i, n, splits));
}

// ---- bf16 on the tensor cores -------------------------------------------

// shared memory of one ring stage of the mma kernel, in bf16 elements: the
// patch (BM + 2W + 2 pixels and the zero row, CK channels and 8 of padding
// each: ldmatrix's eight rows then fall on eight distinct bank groups), then
// NT*CK weight rows of BN channels and 8 of padding
__host__ __device__ constexpr int mma_patch_elems(int W, int BM, int CK) {
  return round_up((BM + 2 * W + 3) * (CK + 8), 64);
}
__host__ __device__ constexpr int mma_stage_elems(int W, int BM, int BN, int NT, int CK) {
  return mma_patch_elems(W, BM, CK) + NT * CK * (BN + 8);
}

// 8 warps over a BM x BN tile, 4 x 2: warp tiles of 32 x 32 in the 128 x
// 64 tile (two blocks an SM), 64 x 32 in the 256 x 64 tile, 64 x 64 in the
// 256 x 128 tile of the largest convs (one block an SM, a third more math
// per shared load)
template <int BM, int BN, int NT, int CK>
__global__ void __launch_bounds__(kThreads, BM == 128 ? 2 : 1)
conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                   bf16* __restrict__ out, float* __restrict__ ws, int M, int H, int W, int Cin,
                   int Cout, int cin_pad, int cout_pad, int stages, int per_split) {
  constexpr int WARPS_N = 2, WM = BM / 4, WN = BN / 2;
  constexpr int MF = WM / 16;                  // m16 fragments a warp
  constexpr int NF = WN / 8;                   // n8 fragments a warp
  constexpr int AROW = CK + 8, BROW = BN + 8, KROWS = NT * CK;
  constexpr int ACH = CK / 8, BCH = BN / 8;    // 16-byte chunks a row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int row_mask[BM];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int Q = BM + 2 * W + 2;                // patch rows; row Q is zero
  const int a_elems = mma_patch_elems(W, BM, CK);
  const int stage_elems = mma_stage_elems(W, BM, BN, NT, CK);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int slices = cin_pad / CK;
  const int s_begin = blockIdx.z * per_split;
  const int nk = min(slices, s_begin + per_split) - s_begin;

  for (int i = tid; i < BM; i += kThreads) row_mask[i] = tap_mask(m0 + i, M, H, W);
  griddep_wait();  // the repacked weights
  griddep_launch_dependents();

  auto load = [&](int buf, int slice) {
    bf16* A = smem + buf * stage_elems;
    bf16* Bs = A + a_elems;
    const int c0 = slice * CK;
    for (int i = tid; i < (Q + 1) * ACH; i += kThreads) {
      const int q = i / ACH, c = i - q * ACH;
      const int p = m0 - W - 1 + q;
      const bool ok = q < Q && p >= 0 && p < M && c0 + c * 8 < Cin;
      cp_async16(smem_u32(A + q * AROW + c * 8), ok ? x + (long)p * Cin + c0 + c * 8 : x, ok);
    }
    for (int i = tid; i < KROWS * BCH; i += kThreads) {
      const int r = i / BCH, c = i - r * BCH;
      const int t = r / CK, ci = r - t * CK;
      const bf16* src = wt + ((long)tap_of<NT>(t) * cin_pad + c0 + ci) * cout_pad + n0 + c * 8;
      cp_async16(smem_u32(Bs + r * BROW + c * 8), src, true);
    }
  };

  for (int s = 0; s < stages - 1; ++s) {
    if (s < nk) load(s, s_begin + s);
    cp_async_commit();
  }
  __syncthreads();  // row_mask

  // lane l reads A rows l % 16 at channel offset (l / 16) * 8 of each m16
  // fragment; B rows (k) l % 8 + 8 * ((l / 8) % 2) at channel offset
  // (l / 16) * 8 of each pair of n8 fragments
  int qb[MF], mk[MF];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
    const int r = wm * WM + mf * 16 + (lane & 15);
    qb[mf] = r + W + 1;
    mk[mf] = row_mask[r];
  }
  const int a_koff = (lane >> 4) * 8;
  const int b_krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_ncol = wn * WN + (lane >> 4) * 8;

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k = 0; k < nk; ++k) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    const int kn = k + stages - 1;
    if (kn < nk) load(kn % stages, s_begin + kn);
    cp_async_commit();

    const bf16* A = smem + (k % stages) * stage_elems;
    const uint32_t a_base = smem_u32(A);
    const uint32_t a_zero = a_base + Q * AROW * 2 + a_koff * 2;
    const uint32_t b_base = smem_u32(A + a_elems);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int tap = tap_of<NT>(t);
      const int delta = tap_delta(tap, W);
      uint32_t arow[MF];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
        arow[mf] = ((mk[mf] >> tap) & 1)
                       ? a_base + (uint32_t)((qb[mf] + delta) * AROW + a_koff) * 2
                       : a_zero;
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        uint32_t af[MF][4];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) conv_tile::ldmatrix_x4(af[mf], arow[mf] + kk * 32);
        uint32_t bfr[NF][2];
#pragma unroll
        for (int np = 0; np < NF / 2; ++np) {
          uint32_t r4[4];
          conv_tile::ldmatrix_x4_trans(
              r4, b_base + (uint32_t)((t * CK + kk * 16 + b_krow) * BROW + b_ncol + np * 16) * 2);
          bfr[2 * np][0] = r4[0];
          bfr[2 * np][1] = r4[1];
          bfr[2 * np + 1][0] = r4[2];
          bfr[2 * np + 1][1] = r4[3];
        }
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) conv_tile::mma_bf16(acc[mf][nf], af[mf], bfr[nf]);
      }
    }
  }
  cp_async_wait<0>();

  // rows lane / 4 and lane / 4 + 8, channels 2 * (lane % 4) + {0, 1}: to
  // out, or with a split to this part's slab of the workspace
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + mf * 16 + (lane >> 2) + 8 * h;
        const int n = n0 + wn * WN + nf * 8 + (lane & 3) * 2;
        if (m >= M || n >= Cout) continue;
        const float v0 = acc[mf][nf][2 * h], v1 = acc[mf][nf][2 * h + 1];
        if (ws != nullptr)
          *reinterpret_cast<float2*>(ws + ((long)blockIdx.z * M + m) * Cout + n) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + (long)m * Cout + n) =
              __floats2bfloat162_rn(v0, v1);
      }
}

// ---- fp32 (and the other bf16 shapes) on the CUDA cores -------------------

constexpr int kSimtCK = 4;  // input channels a K step

constexpr int kSimtBM = 256, kSimtBN = 64;  // 32 x 8 threads of 8 x 8 sums
// one ring stage in floats: the patch (one float4 of CK channels a pixel)
// and NT*CK weight rows of BN channels
__host__ __device__ constexpr int simt_patch_floats(int W) {
  return round_up((kSimtBM + 2 * W + 3) * kSimtCK, 32);
}
__host__ __device__ constexpr int simt_stage_floats(int W, int NT) {
  return simt_patch_floats(W) + NT * kSimtCK * kSimtBN;
}

template <typename T, int NT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_simt_kernel(const T* __restrict__ x, const float* __restrict__ wt, T* __restrict__ out,
                    float* __restrict__ ws, int M, int H, int W, int Cin, int Cout, int cin_pad,
                    int cout_pad, int stages, int per_split) {
  constexpr int CK = kSimtCK, BM = kSimtBM, BN = kSimtBN;
  constexpr int TX = BN / 8;                 // threads along N, 8 channels each
  constexpr int KROWS = NT * CK, BV = BN / 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(16) int row_mask[BM];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int Q = BM + 2 * W + 2;
  const int a_floats = simt_patch_floats(W);
  const int stage_floats = simt_stage_floats(W, NT);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int slices = cin_pad / CK;
  const int s_begin = blockIdx.z * per_split;
  const int nk = min(slices, s_begin + per_split) - s_begin;

  for (int i = tid; i < BM; i += kThreads) row_mask[i] = tap_mask(m0 + i, M, H, W);
  griddep_wait();  // the repacked weights
  griddep_launch_dependents();

  auto load = [&](int buf, int slice) {
    float* A = smem + buf * stage_floats;
    float* Bs = A + a_floats;
    const int c0 = slice * CK;
    for (int i = tid; i < Q + 1; i += kThreads) {
      const int p = m0 - W - 1 + i;
      const bool ok = i < Q && p >= 0 && p < M;
      if constexpr (VEC) {
        cp_async16(smem_u32(A + i * CK), ok ? (const void*)(x + (long)p * Cin + c0) : x, ok);
      } else {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (ok) {
          const T* src = x + (long)p * Cin + c0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < Cin) v[c] = to_f32(src[c]);
        }
        *reinterpret_cast<float4*>(A + i * CK) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int i = tid; i < KROWS * BV; i += kThreads) {
      const int r = i / BV, c = i - r * BV;
      const int t = r / CK, ci = r - t * CK;
      const float* src = wt + ((long)tap_of<NT>(t) * cin_pad + c0 + ci) * cout_pad + n0 + c * 4;
      cp_async16(smem_u32(Bs + r * BN + c * 4), src, true);
    }
  };

  for (int s = 0; s < stages - 1; ++s) {
    if (s < nk) load(s, s_begin + s);
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < nk; ++k) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    const int kn = k + stages - 1;
    if (kn < nk) load(kn % stages, s_begin + kn);
    cp_async_commit();

    const float* A = smem + (k % stages) * stage_floats;
    const float* Bs = A + a_floats;
    const int4 mlo = *reinterpret_cast<const int4*>(row_mask + ty * 8);
    const int4 mhi = *reinterpret_cast<const int4*>(row_mask + ty * 8 + 4);
    const int rm[8] = {mlo.x, mlo.y, mlo.z, mlo.w, mhi.x, mhi.y, mhi.z, mhi.w};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int tap = tap_of<NT>(t);
      const int base = ty * 8 + W + 1 + tap_delta(tap, W);
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int off = ((rm[i] >> tap) & 1) ? base + i : Q;
        a[i] = *reinterpret_cast<const float4*>(A + off * CK);
      }
#pragma unroll
      for (int ci = 0; ci < CK; ++ci) {
        const float* brow = Bs + (t * CK + ci) * BN + tx * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + BN / 2);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = reinterpret_cast<const float*>(&a[i])[ci];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // pixels ty*8 + i; channels tx*4 + {0..3} and BN/2 + tx*4 + {0..3}: to
  // out, or with a split to this part's slab of the workspace
  const bool vec = (Cout & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      if (n >= Cout) continue;
      if (ws != nullptr)
        store4(ws + ((long)blockIdx.z * M + m) * Cout + n, &acc[i][4 * h], Cout - n, vec);
      else
        store4(out + (long)m * Cout + n, &acc[i][4 * h], Cout - n, vec);
    }
  }
}

// ---- launchers ---------------------------------------------------------

struct Args {
  const void* x;
  void* out;
  const void* wt;
  float* part;   // split-K partial sums, or null
  int M, H, W, Cin, Cout, cin_pad, cout_pad, stages, splits, per_split;
  cudaStream_t s;
};

template <int BM, int BN, int NT, int CK>
int launch_mma(const Args& a) {
  const long smem = (long)a.stages * mma_stage_elems(a.W, BM, BN, NT, CK) * 2;
  auto kernel = conv3x3_mma_kernel<BM, BN, NT, CK>;
  static long allowed = 48 * 1024;
  const cudaError_t err = conv_tile::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.M + BM - 1) / BM), (unsigned)(a.cout_pad / BN),
                  (unsigned)a.splits);
  return (int)launch_after(kernel, grid, kThreads, smem, a.s, (const bf16*)a.x,
                           (const bf16*)a.wt, (bf16*)a.out, a.part, a.M, a.H, a.W, a.Cin,
                           a.Cout, a.cin_pad, a.cout_pad, a.stages, a.per_split);
}

template <typename T, int NT, bool VEC>
int launch_simt(const Args& a) {
  const long smem = (long)a.stages * simt_stage_floats(a.W, NT) * 4;
  auto kernel = conv3x3_simt_kernel<T, NT, VEC>;
  static long allowed = 48 * 1024;
  const cudaError_t err = conv_tile::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.M + kSimtBM - 1) / kSimtBM), (unsigned)(a.cout_pad / kSimtBN),
                  (unsigned)a.splits);
  return (int)launch_after(kernel, grid, kThreads, smem, a.s, (const T*)a.x, (const float*)a.wt,
                           (T*)a.out, a.part, a.M, a.H, a.W, a.Cin, a.Cout, a.cin_pad,
                           a.cout_pad, a.stages, a.per_split);
}

template <typename T, int NT>
int launch_simt_vec(const Args& a, bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec) return launch_simt<T, NT, true>(a);
  }
  return launch_simt<T, NT, false>(a);
}

template <int BM, int BN>
int launch_mma_taps(const Args& a, int taps) {
  return taps == 9 ? launch_mma<BM, BN, 9, 16>(a) : launch_mma<BM, BN, 3, 32>(a);
}

// The ring's depth for a route and tile: the deepest whose stages fit
// beside the kernel's static row masks, 0 where none fits.
int ring(int mma, int W, int bm, int bn, int taps) {
  const long limit = kMaxSmem - kStaticSmem;
  if (!mma) return ring_stages((long)simt_stage_floats(W, taps) * 4, 0, limit);
  return ring_stages((long)mma_stage_elems(W, bm, bn, taps, taps == 9 ? 16 : 32) * 2, 0, limit);
}

template <typename T>
int launch(const void* x, const void* w, void* out, void* wt, void* ws, int B, int H, int W,
           int Cin, int Cout, int mma, int bm, int bn, int taps, int splits, int per_split,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const long M = (long)B * H * W;
  if (M * Cin >= (1L << 31) || M * Cout >= (1L << 31) || (long)Cout * 9 * Cin >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  if (!(taps == 9 || (taps == 3 && W == 1)) || wt == nullptr) return (int)cudaErrorInvalidValue;
  // the tensor cores' tiles are 128 x 64, 256 x 64 and 256 x 128, the CUDA
  // cores' 256 x 64
  if (mma ? !((bm == 128 && bn == 64) || (bm == 256 && (bn == 64 || bn == 128)))
          : !(bm == kSimtBM && bn == kSimtBN))
    return (int)cudaErrorInvalidValue;
  if (mma && (sizeof(T) != 2 || Cin % 16 != 0 || Cout % 8 != 0 || (uintptr_t)x % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int ck = mma ? (taps == 9 ? 16 : 32) : kSimtCK;
  const int slices = (Cin + ck - 1) / ck;
  if (splits < 1 || per_split < 1 || (long)splits * per_split < slices ||
      (long)(splits - 1) * per_split >= slices || (splits > 1 && ws == nullptr) ||
      (long)splits * M * Cout >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  const int stages = ring(mma, W, bm, bn, taps);
  if (stages == 0) return (int)cudaErrorInvalidValue;

  const Args a{x, out, wt, splits > 1 ? (float*)ws : nullptr, (int)M, H, W, Cin, Cout,
               slices * ck, (Cout + bn - 1) / bn * bn, stages, splits, per_split,
               (cudaStream_t)stream};
  const dim3 rgrid((unsigned)((a.cin_pad + 7) / 8), (unsigned)(a.cout_pad / 32));
  if (mma)
    conv3x3_repack_kernel<T, bf16><<<rgrid, kThreads, 0, a.s>>>(
        (const T*)w, (bf16*)wt, Cin, Cout, a.cin_pad, a.cout_pad);
  else
    conv3x3_repack_kernel<T, float><<<rgrid, kThreads, 0, a.s>>>(
        (const T*)w, (float*)wt, Cin, Cout, a.cin_pad, a.cout_pad);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  if (mma) {
    err = bm == 128  ? launch_mma_taps<128, 64>(a, taps)
          : bn == 64 ? launch_mma_taps<256, 64>(a, taps)
                     : launch_mma_taps<256, 128>(a, taps);
  } else {
    const bool vec = sizeof(T) == 4 && Cin % 4 == 0 && (uintptr_t)x % 16 == 0;
    err = taps == 9 ? launch_simt_vec<T, 9>(a, vec) : launch_simt_vec<T, 3>(a, vec);
  }
  if (err == 0) err = (int)cudaGetLastError();
  if (err != 0 || splits == 1) return err;
  const long n = M * Cout;
  err = (int)launch_after(conv3x3_sum_splits_kernel<T>, dim3((unsigned)((n + 255) / 256)), 256,
                          0, a.s, (const float*)ws, (T*)out, n, splits);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, Cin) and w (Cout, Cin, 3, 3) contiguous, out (B, H, W, Cout).
// The plan (models/cuda_ops.py conv3x3_plan): mma (tensor cores, bf16
// only), bm and bn (the block tile: 128 x 64, 256 x 64 or 256 x 128 on the
// tensor cores, 256 x 64 on the CUDA cores), taps (9, or 3 where W == 1),
// splits and per_split (channel slices a part). wt holds the repacked
// weights, 9 * cin_pad * cout_pad elements (bf16 on the tensor cores, f32
// otherwise); ws holds splits * B*H*W * Cout f32 partial sums and may be
// null when splits == 1.
int conv3x3_f32(const void* x, const void* w, void* out, void* wt, void* ws, int B, int H, int W,
                int Cin, int Cout, int mma, int bm, int bn, int taps, int splits, int per_split,
                void* stream) {
  return launch<float>(x, w, out, wt, ws, B, H, W, Cin, Cout, mma, bm, bn, taps, splits,
                       per_split, stream);
}

int conv3x3_bf16(const void* x, const void* w, void* out, void* wt, void* ws, int B, int H,
                 int W, int Cin, int Cout, int mma, int bm, int bn, int taps, int splits,
                 int per_split, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, wt, ws, B, H, W, Cin, Cout, mma, bm, bn, taps,
                               splits, per_split, stream);
}

// The ring depth the launch of this route and tile takes (0: it refuses).
int conv3x3_ring(int mma, int W, int bm, int bn, int taps) { return ring(mma, W, bm, bn, taps); }

}  // extern "C"
