// Multi-head attention core for the denoiser U-Net: per head,
// out = softmax(q k^T / sqrt(Dh)) v over packed (B, T, heads*Dh) tensors,
// head h in feature columns [h*Dh, (h+1)*Dh).
//
// Replaces the Pallas TPU kernel
// state_policy_diffusionmodel_tpu/models/pallas_ops.py::_attn_pallas
// (body _attn_kernel). The TPU kernel packs 128//T batch elements
// block-diagonally into one MXU tile and masks the cross-batch blocks with
// -1e30. Nothing is masked across batch elements here: at small T a block
// holds several (batch, head) pairs side by side in shared memory instead
// (enough for each of its four warps to own a 16-row query tile), and every
// warp attends within its own pair.
//
// What bounds it on an H100 at r5blend's five calls (B=256, 4 heads; (T, Dh)
// = (64, 32), (16, 64), (16, 32), (64, 16), (256, 16)). Per (batch, head):
// 4*T*T*Dh flops, T*T exponentials, 4*T*Dh elements moved. fp32: the
// operations bound every shape (67 TFLOP/s outside the tensor cores; 0.087
// ms the five, 0.064 of it at T=256). bf16: the bytes bound the T <= 64
// shapes, and the exponentials (16 a clock an SM, ~4.2e12/s) the T=256 one
// (0.016 ms against 0.010 for its bytes); the tensor cores never do.
// What the design does about that:
//   - one pass over device memory: a block copies q, k, v of its pairs into
//     shared memory once (16-byte cp.async; rows padded by 16 bytes, so that
//     ldmatrix and float4 reads hit distinct banks; heads zero-padded to a
//     width DP of 16, 32, 64 or 128) and writes each output once;
//   - a warp owns 16 query rows and walks the keys in chunks of KC (16, 64
//     or 128, kc_max); a chunk's scores stay in registers, so T has no cap;
//   - bf16: QK^T and PV on the tensor cores (mma.sync m16n8k16, f32 sums,
//     the ldmatrix / mma wrappers of conv_tile.cuh); the f32 accumulators
//     of P, rounded to bf16, are PV's A fragments (two n8 tiles make a k16
//     tile), V comes in through ldmatrix.trans; the exponentials take the
//     SFU's ex2.approx, one instruction a score;
//   - fp32: the CUDA cores, no TF32; a lane holds 4 rows x KC/8 keys of
//     scores, reading q and k as float4. At Dh <= 16 each lane sums p v over
//     its own keys into 4 rows x 16 features and the 8 lanes of a row add
//     theirs once a tile (one float4 of V feeds 16 multiply-adds); wider
//     heads go through a per-warp P tile of 64 keys, each lane owning 2-4
//     rows x 4-16 features of the output.
// Where a block's pairs do not fit in 96 KB of shared memory (long T, wide
// fp32 heads) it streams: one pair, four query tiles, K (pass 1) and K and
// V (pass 2) copied 64 keys at a time.
//
// Heads wider than 128 (a UNetFiLM at --model_width 256 has one, Dh = 256)
// take a plain row kernel instead (attention_core_kernel_rows): one warp a
// (batch, head, query row), four a block. The warp scales its q row in q's
// dtype into shared memory, forms the row's T scores in f32 (the lanes
// streaming each key over Dh, then summing across the warp) into shared
// memory, takes the exact softmax there (max,
// expf, sum, p = e / sum rounded to v's dtype) and sums p v with the lanes
// across Dh. Shared memory bounds it: four rows of Dh + T floats, so
// Dh + T <= kMaxSmem / 16 (14,528).
//
// Numerics follow the reference formulation (pallas_ops._attn_xla,
// cuda_ops.attention_core_ref): q is divided by sqrt(Dh) in q's dtype, the
// scores, the softmax and the PV sums are f32, and the normalized
// probabilities are rounded to v's dtype before PV; the output is rounded
// once. The softmax is exact and two-pass over a warp's chunks: pass 1
// takes each row's max and its sum of exp(s - max) (the sum rescaled when
// the max moves), pass 2 forms p = exp(s - max) / sum chunk by chunk
// (recomputing the scores of all but the last chunk, whose exponentials
// pass 1 left in registers) and accumulates PV. With one chunk (T <= KC)
// the scores are formed once and take one exponential each. p is exp(s -
// max) times the row's reciprocal sum, within an ulp of the quotient.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "conv_tile.cuh"

namespace {

using conv_tile::cp_async16;
using conv_tile::cp_async_commit;
using conv_tile::cp_async_wait;
using conv_tile::from_f32;
using conv_tile::ldmatrix_x4;
using conv_tile::ldmatrix_x4_trans;
using conv_tile::mma_bf16;
using conv_tile::round_up;
using conv_tile::smem_u32;
using conv_tile::to_f32;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;               // query rows of a warp tile
constexpr int kMaxDh = 128;             // wider heads take the row kernel
constexpr int kRowWarps = 4;            // row kernel: query rows a block
constexpr int kStreamKC = 64;           // keys a chunk when streaming
constexpr long kResidentSmem = 96 * 1024;
constexpr int kPC = 64;                 // fp32: keys of P in a warp's tile

// the padded head width the kernel computes with
__host__ __device__ constexpr int dp_of(int Dh) {
  return Dh <= 16 ? 16 : Dh <= 32 ? 32 : Dh <= 64 ? 64 : 128;
}
// shared-memory row stride in elements: 16 bytes of padding
template <typename T> __host__ __device__ constexpr int ld_of(int DP) {
  return DP + 16 / (int)sizeof(T);
}
// The most keys whose scores a warp holds in registers (s[KC/8][4], KC/2
// registers a lane): 64 in fp32, where the output sums and the float4
// reads need the rest, 128 in bf16 but 64 at a head width of 128 (whose q
// fragments and output sums take 96 registers). Larger chunks spilled or
// ran slower on the card.
__host__ __device__ constexpr int kc_max(int DP, int esize) {
  return esize == 4 || DP > 64 ? 64 : 128;
}
// fp32: keys of P staged at a time, and the per-warp P tile in floats
__host__ __device__ constexpr int pc_of(int KC) { return KC < kPC ? KC : kPC; }
__host__ __device__ constexpr int ptile_floats(int KC) { return kRows * (pc_of(KC) + 8); }
// bytes of the four warps' P tiles: fp32 heads wider than 16 only
__host__ __device__ constexpr long ptile_bytes(int DP, int KC, int esize) {
  return esize == 4 && DP > 16 ? (long)kWarps * ptile_floats(KC) * 4 : 0;
}

// ---- the launch plan ------------------------------------------------------

struct Plan {
  int dp, kc, groups, streamed, vec;
  long smem;
  long blocks;
};

Plan make_plan(long pairs, int T_len, int Dh, int esize) {
  Plan p{};
  p.dp = dp_of(Dh);
  const int tp = round_up(T_len, kRows), qt = tp / kRows;
  const long ld = p.dp + 16 / esize;
  p.kc = tp <= 16 ? 16 : tp <= 64 ? 64 : 128;
  if (p.kc > kc_max(p.dp, esize)) p.kc = kc_max(p.dp, esize);
  // as many pairs as give each warp a query tile and fit in kResidentSmem
  const long pair_bytes = 3L * tp * ld * esize, ptile = ptile_bytes(p.dp, p.kc, esize);
  p.groups = (int)std::min<long>(qt >= kWarps ? 1 : kWarps / qt,
                                 (kResidentSmem - ptile) / pair_bytes);
  p.smem = p.groups * pair_bytes + ptile;
  p.streamed = p.groups < 1;
  if (p.streamed) {
    p.kc = kStreamKC;
    p.groups = 1;
    p.smem = (long)(kWarps * kRows + 2 * kStreamKC) * ld * esize +
             ptile_bytes(p.dp, kStreamKC, esize);
    p.blocks = pairs * ((qt + kWarps - 1) / kWarps);
  } else {
    p.blocks = (pairs + p.groups - 1) / p.groups;
  }
  return p;
}

// ---- copies into shared memory --------------------------------------------

// Rows [row0, row0 + rows) of one pair (row stride C, head columns
// [0, Dh) from src) into dst (row stride LD), zeros past T_len and past Dh
// up to DP. vec: 16-byte cp.async (Dh * sizeof(T) a multiple of 16 and the
// pointers aligned); otherwise element by element.
template <typename T, int DP>
__device__ void stage_rows(T* dst, const T* __restrict__ src, int row0, int rows, int T_len,
                           int C, int Dh, bool vec) {
  constexpr int E = 16 / (int)sizeof(T), CPR = DP / E, LD = ld_of<T>(DP);
  for (int idx = threadIdx.x; idx < rows * CPR; idx += kThreads) {
    const int r = idx / CPR, col = (idx - r * CPR) * E;
    const int row = row0 + r;
    T* d = dst + r * LD + col;
    const T* s = src + (long)row * C + col;
    if (vec) {
      const bool ok = row < T_len && col < Dh;
      cp_async16(smem_u32(d), ok ? (const void*)s : (const void*)src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = (row < T_len && col + e < Dh) ? s[e] : from_f32<T>(0.f);
    }
  }
}

// x / s rounded once, given r = 1 / s rounded: q = x r lies within an ulp,
// its remainder x - q s is exact by fma, and q + remainder * r rounds to
// the quotient (Markstein's theorem; equal to __fdiv_rn away from
// underflow)
__device__ __forceinline__ float div_rn(float x, float s, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, s, x), r, q);
}

// A warp's 16 q rows in shared memory become q / sqrt(Dh) rounded to q's
// dtype, in place (the reference's first step); the zero padding stays 0.
template <typename T, int DP>
__device__ void scale_tile(T* qt, float sqrt_dh, int lane) {
  constexpr int E = 16 / (int)sizeof(T), CPR = DP / E, LD = ld_of<T>(DP);
  const float r = 1.f / sqrt_dh;
  for (int idx = lane; idx < kRows * CPR; idx += 32) {
    uint4* p = reinterpret_cast<uint4*>(qt + (idx / CPR) * LD + (idx % CPR) * E);
    uint4 w = *p;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int i = 0; i < E; ++i) e[i] = from_f32<T>(div_rn(to_f32(e[i]), sqrt_dh, r));
    *p = w;
  }
  __syncwarp();
}

// ---- the softmax over a chunk's scores, shared by both routes --------------
//
// A warp's scores for a chunk are s[KC/8][4]; a Layout says which of the
// lane's rows (slot) and which key of the chunk each element is, and how
// many lanes share a row (they differ in the low bits of the lane index).

struct MmaLayout {   // m16n8 accumulators: rows g and g + 8 (g = lane / 4)
  static constexpr int R = 2, LANES = 4;
  // __expf (ex2.approx): its few-ulp f32 error lies far below the bf16
  // rounding of p (2^-9 relative)
  __device__ static float exp(float x) { return __expf(x); }
  __device__ static int slot(int e) { return e >> 1; }
  __device__ static int key(int n, int e, int lane) { return 8 * n + 2 * (lane & 3) + (e & 1); }
};

struct SimtLayout {  // fp32: rows lane / 8 + 4m, keys lane % 8 + 8n
  static constexpr int R = 4, LANES = 8;
  __device__ static float exp(float x) { return expf(x); }
  __device__ static int slot(int e) { return e; }
  __device__ static int key(int n, int e, int lane) { return 8 * n + (lane & 7); }
};

template <class L> __device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < L::LANES; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <class L> __device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < L::LANES; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// keys at or past kvalid (padding past T) out of the max and the sum
template <class L, int NT>
__device__ __forceinline__ void mask_keys(float (&s)[NT][4], int kvalid, int lane) {
  if (kvalid >= 8 * NT) return;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (L::key(n, e, lane) >= kvalid) s[n][e] = -CUDART_INF_F;
}

// Pass 1 on one chunk: fold its scores into each row's max m and sum l, and
// leave exp(s - m) in s (final for the last chunk).
template <class L, int NT>
__device__ __forceinline__ void chunk_stats(float (&s)[NT][4], float (&m)[L::R], float (&l)[L::R],
                                            int kvalid, int lane) {
  mask_keys<L>(s, kvalid, lane);
  float cm[L::R], part[L::R];
#pragma unroll
  for (int r = 0; r < L::R; ++r) cm[r] = -CUDART_INF_F, part[r] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cm[L::slot(e)] = fmaxf(cm[L::slot(e)], s[n][e]);
#pragma unroll
  for (int r = 0; r < L::R; ++r) {
    const float mn = fmaxf(m[r], row_max<L>(cm[r]));
    l[r] *= L::exp(m[r] - mn);   // 0 before the first chunk (m = -inf)
    m[r] = mn;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = L::exp(s[n][e] - m[L::slot(e)]);
      part[L::slot(e)] += s[n][e];
    }
#pragma unroll
  for (int r = 0; r < L::R; ++r) l[r] += row_sum<L>(part[r]);
}

// Pass 2 on one chunk: s becomes p = exp(s - m) / l (have_exp: s already
// holds exp(s - m)).
template <class L, int NT>
__device__ __forceinline__ void chunk_probs(float (&s)[NT][4], const float (&m)[L::R],
                                            const float (&inv)[L::R], int kvalid, bool have_exp,
                                            int lane) {
  if (!have_exp) {
    mask_keys<L>(s, kvalid, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = L::exp(s[n][e] - m[L::slot(e)]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= inv[L::slot(e)];
}

// ---- bf16: tensor cores ----------------------------------------------------

template <typename T, int DP, int KC> struct Route;

template <int DP, int KC> struct Route<__nv_bfloat16, DP, KC> {
  using T = __nv_bfloat16;
  using L = MmaLayout;
  static constexpr int LD = ld_of<T>(DP), NT = KC / 8, DK = DP / 16, DN = DP / 8;
  uint32_t qa[DK][4];   // the warp's 16 scaled q rows as A fragments
  float o[DN][4];       // the output tile's f32 sums

  __device__ void begin(const T* Qs, int lane) {
    const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) ldmatrix_x4(qa[kk], smem_u32(Qs + row * LD + kk * 16 + col));
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  // s = q k^T for the chunk's keys at Ks, the first n16 * 16 of them staged
  __device__ void scores(float (&s)[NT][4], const T* Ks, int n16, int lane) const {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const int row = (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (j < n16) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(Ks + (j * 16 + row) * LD + kk * 16 + col));
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(s[2 * j], qa[kk], b0);
        mma_bf16(s[2 * j + 1], qa[kk], b1);
      }
      }
    }
  }

  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }

  // o += p v: p rounded to bf16 as the A fragments, v through ldmatrix.trans
  __device__ void accumulate(const float (&p)[NT][4], const T* Vs, int n16, int lane, float*) {
    const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (j >= n16) continue;
      const uint32_t a[4] = {pack(p[2 * j][0], p[2 * j][1]), pack(p[2 * j][2], p[2 * j][3]),
                             pack(p[2 * j + 1][0], p[2 * j + 1][1]),
                             pack(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
      for (int d = 0; d < DN / 2; ++d) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(Vs + (j * 16 + row) * LD + d * 16 + col));
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_bf16(o[2 * d], a, b0);
        mma_bf16(o[2 * d + 1], a, b1);
      }
    }
  }

  // rows [row0, row0 + 16) of the pair at out (row stride C), those < T_len
  __device__ void store(T* out, int row0, int T_len, int C, int Dh, bool vec, int lane) const {
    const int g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row >= T_len) continue;
      T* dst = out + (long)row * C;
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const int d = 8 * n + c;
        if (d >= Dh) continue;
        if (vec) {
          *reinterpret_cast<__nv_bfloat162*>(dst + d) =
              __floats2bfloat162_rn(o[n][2 * h], o[n][2 * h + 1]);
        } else {
          dst[d] = from_f32<T>(o[n][2 * h]);
          if (d + 1 < Dh) dst[d + 1] = from_f32<T>(o[n][2 * h + 1]);
        }
      }
    }
  }
};

// ---- fp32: CUDA cores, register tiles --------------------------------------

// s = q k^T on the CUDA cores: lane (ry, cx) sums rows ry + 4m of q (16 rows
// at q, row stride LD) against keys cx + 8n of the chunk at Ks, the first
// n16 * 16 of them staged; one float4 of q and of k a step of 4 features.
template <int DP, int NT>
__device__ __forceinline__ void simt_scores(float (&s)[NT][4], const float* q, const float* Ks,
                                            int n16, int lane) {
  constexpr int LD = ld_of<float>(DP);
  const int ry = lane >> 3, cx = lane & 7;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    float4 qv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) qv[m] = *reinterpret_cast<const float4*>(q + (ry + 4 * m) * LD + d);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= 2 * n16) continue;
      const float4 kv = *reinterpret_cast<const float4*>(Ks + (cx + 8 * n) * LD + d);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float a = s[n][m];
        a = fmaf(qv[m].x, kv.x, a);
        a = fmaf(qv[m].y, kv.y, a);
        a = fmaf(qv[m].z, kv.z, a);
        s[n][m] = fmaf(qv[m].w, kv.w, a);
      }
    }
  }
}

// fp32 at head widths of 32 to 128: PV through the warp's P tile
template <int DP, int KC> struct Route<float, DP, KC> {
  using T = float;
  using L = SimtLayout;
  static constexpr int LD = ld_of<T>(DP), NT = KC / 8, PC = pc_of(KC), LDP = PC + 8;
  // PV: lanes (pr, dx) own rows pr + 4i and features 4*(dx + 8f) + 0..3
  static constexpr int DX = 8, RY = 4, RM = kRows / RY, F = DP / (4 * DX);
  const float* q;       // the warp's 16 scaled q rows in shared memory
  float o[RM][F][4];

  __device__ void begin(const T* Qs, int) {
    q = Qs;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int f = 0; f < F; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][f][e] = 0.f;
  }

  __device__ void scores(float (&s)[NT][4], const T* Ks, int n16, int lane) const {
    simt_scores<DP>(s, q, Ks, n16, lane);
  }

  // o += p v, through the warp's P tile (pt), PC keys at a time
  __device__ void accumulate(const float (&p)[NT][4], const T* Vs, int n16, int lane, float* pt) {
    const int ry = lane >> 3, cx = lane & 7;
    const int pr = lane / DX, dx = lane % DX;
#pragma unroll
    for (int sub = 0; sub < KC / PC; ++sub) {
      const int keys = min(PC, n16 * 16 - sub * PC);
      if (keys <= 0) continue;
#pragma unroll
      for (int n = sub * PC / 8; n < (sub + 1) * PC / 8; ++n)
#pragma unroll
        for (int m = 0; m < 4; ++m) pt[(ry + 4 * m) * LDP + 8 * n - sub * PC + cx] = p[n][m];
      __syncwarp();
      const T* V = Vs + sub * PC * LD;
#pragma unroll 4
      for (int j = 0; j < keys; j += 4) {
        float4 pv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          pv[i] = *reinterpret_cast<const float4*>(pt + (pr + RY * i) * LDP + j);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float4 vv =
                *reinterpret_cast<const float4*>(V + (j + u) * LD + 4 * (dx + DX * f));
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              const float w = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
              o[i][f][0] = fmaf(w, vv.x, o[i][f][0]);
              o[i][f][1] = fmaf(w, vv.y, o[i][f][1]);
              o[i][f][2] = fmaf(w, vv.z, o[i][f][2]);
              o[i][f][3] = fmaf(w, vv.w, o[i][f][3]);
            }
          }
      }
      __syncwarp();
    }
  }

  __device__ void store(T* out, int row0, int T_len, int C, int Dh, bool vec, int lane) const {
    const int pr = lane / DX, dx = lane % DX;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = row0 + pr + RY * i;
      if (row >= T_len) continue;
      T* dst = out + (long)row * C;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int d = 4 * (dx + DX * f);
        if (d >= Dh) continue;
        if (vec) {
          *reinterpret_cast<float4*>(dst + d) =
              make_float4(o[i][f][0], o[i][f][1], o[i][f][2], o[i][f][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (d + e < Dh) dst[d + e] = o[i][f][e];
        }
      }
    }
  }
};

// fp32 at a head width of 16: PV without the P tile. A lane holds 4 rows x
// KC/8 keys of p, so it sums p v over its own keys into 4 rows x 16
// features, and the 8 lanes that share rows add their sums once a tile
// (halving the features each step, lane cx ends with features 2cx and
// 2cx + 1; see store). One float4 of V feeds 16 multiply-adds.
template <int KC> struct Route<float, 16, KC> {
  using T = float;
  using L = SimtLayout;
  static constexpr int DP = 16, LD = ld_of<T>(DP), NT = KC / 8;
  const float* q;       // the warp's 16 scaled q rows in shared memory
  float o[4][DP];       // partial sums over this lane's keys

  __device__ void begin(const T* Qs, int) {
    q = Qs;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int d = 0; d < DP; ++d) o[m][d] = 0.f;
  }

  __device__ void scores(float (&s)[NT][4], const T* Ks, int n16, int lane) const {
    simt_scores<DP>(s, q, Ks, n16, lane);
  }

  __device__ void accumulate(const float (&p)[NT][4], const T* Vs, int n16, int lane, float*) {
    const int cx = lane & 7;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= 2 * n16) continue;
      const T* vrow = Vs + (cx + 8 * n) * LD;
#pragma unroll
      for (int d = 0; d < DP; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          o[m][d + 0] = fmaf(p[n][m], vv.x, o[m][d + 0]);
          o[m][d + 1] = fmaf(p[n][m], vv.y, o[m][d + 1]);
          o[m][d + 2] = fmaf(p[n][m], vv.z, o[m][d + 2]);
          o[m][d + 3] = fmaf(p[n][m], vv.w, o[m][d + 3]);
        }
      }
    }
  }

  // Add the 8 lanes' sums (xor 4, 2, 1: each step keeps the half of the
  // features that the lane's bit selects), then write rows ry + 4m,
  // features f0 = 2cx and f0 + 1.
  __device__ void store(T* out, int row0, int T_len, int C, int Dh, bool vec, int lane) {
    const int ry = lane >> 3;
    const bool b2 = lane & 4, b1 = lane & 2, b0 = lane & 1;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const float lo = o[m][f], hi = o[m][f + 8];
        o[m][f] = (b2 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b2 ? lo : hi, 4);
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float lo = o[m][f], hi = o[m][f + 4];
        o[m][f] = (b1 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b1 ? lo : hi, 2);
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float lo = o[m][f], hi = o[m][f + 2];
        o[m][f] = (b0 ? hi : lo) + __shfl_xor_sync(0xffffffffu, b0 ? lo : hi, 1);
      }
    }
    const int f0 = 8 * b2 + 4 * b1 + 2 * b0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int row = row0 + ry + 4 * m;
      if (row >= T_len) continue;
      T* dst = out + (long)row * C;
      if (f0 < Dh) dst[f0] = o[m][0];
      if (f0 + 1 < Dh) dst[f0 + 1] = o[m][1];
    }
  }
};

// ---- the kernel ------------------------------------------------------------

// A warp's 16 query rows against the keys of one pair resident in shared
// memory (tp rows of K and V, zero past T_len): pass 1 over the chunks,
// then pass 2 from the last chunk (its exponentials kept) back to the first.
template <typename T, int DP, int KC>
__device__ void attend_resident(Route<T, DP, KC>& rt, const T* Ks, const T* Vs, int tp, int T_len,
                                int lane, float* pt) {
  using R = Route<T, DP, KC>;
  using L = typename R::L;
  constexpr int LD = R::LD, NT = R::NT;
  const int chunks = (tp + KC - 1) / KC;
  float m[L::R], l[L::R], s[NT][4];
#pragma unroll
  for (int r = 0; r < L::R; ++r) m[r] = -CUDART_INF_F, l[r] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    rt.scores(s, Ks + c * KC * LD, min(KC, tp - c * KC) / 16, lane);
    chunk_stats<L>(s, m, l, T_len - c * KC, lane);
  }
  float inv[L::R];
#pragma unroll
  for (int r = 0; r < L::R; ++r) inv[r] = 1.f / l[r];
  for (int c = chunks - 1; c >= 0; --c) {
    const int n16 = min(KC, tp - c * KC) / 16;
    if (c != chunks - 1) rt.scores(s, Ks + c * KC * LD, n16, lane);
    chunk_probs<L>(s, m, inv, T_len - c * KC, c == chunks - 1, lane);
    rt.accumulate(s, Vs + c * KC * LD, n16, lane, pt);
  }
}

template <typename T, int DP, int KC>
__global__ void __launch_bounds__(kThreads)
attention_core_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ out, long pairs, int T_len, int H, int Dh, float sqrt_dh,
                      int groups, int streamed, int vec) {
  using R = Route<T, DP, KC>;
  using L = typename R::L;
  constexpr int LD = R::LD, NT = R::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tp = round_up(T_len, kRows), qt = tp / kRows, C = H * Dh;
  auto base = [&](long pair) { return (pair / H) * T_len * C + (pair % H) * Dh; };
  R rt;

  if (!streamed) {
    // q, k, v of pair g at sm + (3g + 0, 1, 2) * tp * LD; the P tiles after
    const long pair0 = (long)blockIdx.x * groups;
    const int here = (int)min((long)groups, pairs - pair0);
    float* pt = reinterpret_cast<float*>(sm + 3L * groups * tp * LD) +
                warp * ptile_floats(KC);
    for (int g = 0; g < here; ++g) {
      const long b = base(pair0 + g);
      T* dst = sm + 3L * g * tp * LD;
      stage_rows<T, DP>(dst, q + b, 0, tp, T_len, C, Dh, vec);
      stage_rows<T, DP>(dst + tp * LD, k + b, 0, tp, T_len, C, Dh, vec);
      stage_rows<T, DP>(dst + 2L * tp * LD, v + b, 0, tp, T_len, C, Dh, vec);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int item = warp; item < here * qt; item += kWarps) {
      const int g = item / qt, t = item - g * qt;
      T* Qs = sm + 3L * g * tp * LD;
      scale_tile<T, DP>(Qs + t * kRows * LD, sqrt_dh, lane);
      rt.begin(Qs + t * kRows * LD, lane);
      attend_resident<T, DP, KC>(rt, Qs + tp * LD, Qs + 2L * tp * LD, tp, T_len, lane, pt);
      rt.store(out + base(pair0 + g), t * kRows, T_len, C, Dh, vec, lane);
    }
    return;
  }

  // streamed: one pair, the block's four query tiles, K and V by chunks
  const int tgroups = (qt + kWarps - 1) / kWarps;
  const long pair = blockIdx.x / tgroups;
  const int row0 = (blockIdx.x % tgroups) * kWarps * kRows;
  const long b = base(pair);
  T* Qs = sm;
  T* Ks = Qs + kWarps * kRows * LD;
  T* Vs = Ks + KC * LD;
  float* pt = reinterpret_cast<float*>(Vs + KC * LD) + warp * ptile_floats(KC);
  const int t = row0 / kRows + warp;
  const bool active = t < qt;

  stage_rows<T, DP>(Qs, q + b, row0, kWarps * kRows, T_len, C, Dh, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (active) {
    scale_tile<T, DP>(Qs + warp * kRows * LD, sqrt_dh, lane);
    rt.begin(Qs + warp * kRows * LD, lane);
  }

  const int chunks = (T_len + KC - 1) / KC;
  float m[L::R], l[L::R], s[NT][4];
#pragma unroll
  for (int r = 0; r < L::R; ++r) m[r] = -CUDART_INF_F, l[r] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();
    stage_rows<T, DP>(Ks, k + b, c * KC, KC, T_len, C, Dh, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
      rt.scores(s, Ks, KC / 16, lane);
      chunk_stats<L>(s, m, l, T_len - c * KC, lane);
    }
  }
  float inv[L::R];
#pragma unroll
  for (int r = 0; r < L::R; ++r) inv[r] = 1.f / l[r];
  for (int c = 0; c < chunks; ++c) {
    __syncthreads();
    stage_rows<T, DP>(Ks, k + b, c * KC, KC, T_len, C, Dh, vec);
    stage_rows<T, DP>(Vs, v + b, c * KC, KC, T_len, C, Dh, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
      rt.scores(s, Ks, KC / 16, lane);
      chunk_probs<L>(s, m, inv, T_len - c * KC, false, lane);
      rt.accumulate(s, Vs, KC / 16, lane, pt);
    }
  }
  if (active) rt.store(out + b, t * kRows, T_len, C, Dh, vec, lane);
}

template <typename T, int DP, int KC>
int launch_plan(const Plan& p, const void* q, const void* k, const void* v, void* out, long pairs,
                int T_len, int H, int Dh, float sqrt_dh, cudaStream_t stream) {
  static_assert(KC <= kc_max(DP, sizeof(T)), "a chunk's scores must fit in registers");
  auto kernel = attention_core_kernel<T, DP, KC>;
  static long allowed = 48 * 1024;
  cudaError_t err = conv_tile::allow_smem(kernel, p.smem, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)p.blocks, kThreads, p.smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, pairs, T_len, H, Dh, sqrt_dh, p.groups,
      p.streamed, p.vec);
  return (int)cudaGetLastError();
}

// ---- heads wider than kMaxDh: one warp a query row ------------------------

__host__ __device__ constexpr long rows_smem(int T_len, int Dh) {
  return (long)kRowWarps * (Dh + T_len) * 4;
}

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
attention_core_kernel_rows(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, long rows, int T_len,
                           int H, int Dh, float sqrt_dh) {
  extern __shared__ __align__(16) float row_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long r = (long)blockIdx.x * kRowWarps + warp;
  if (r >= rows) return;
  const long pair = r / T_len;
  const int t = (int)(r - pair * T_len), C = H * Dh;
  const long base = (pair / H) * T_len * C + (pair % H) * Dh;
  float* qs = row_smem + warp * (Dh + T_len);
  float* sc = qs + Dh;

  const float rcp = 1.f / sqrt_dh;
  for (int d = lane; d < Dh; d += 32)
    qs[d] = to_f32(from_f32<T>(div_rn(to_f32(q[base + (long)t * C + d]), sqrt_dh, rcp)));
  __syncwarp();
  // scores, four keys at a time: the lanes stream q . k over Dh (reads of
  // consecutive features), then each key's partials are summed across the
  // warp (every lane ends with the same sum)
  float mx = -CUDART_INF_F;
  for (int j0 = 0; j0 < T_len; j0 += 4) {
    const int nk = min(4, T_len - j0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = lane; d < Dh; d += 32) {
      const float qd = qs[d];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (u < nk) acc[u] = fmaf(qd, to_f32(k[base + (long)(j0 + u) * C + d]), acc[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
      if (u < nk) {
        if (lane == 0) sc[j0 + u] = acc[u];
        mx = fmaxf(mx, acc[u]);
      }
    }
  }
  __syncwarp();
  float sum = 0.f;
  for (int j = lane; j < T_len; j += 32) {
    const float e = expf(sc[j] - mx);
    sc[j] = e;
    sum += e;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  for (int j = lane; j < T_len; j += 32) sc[j] = to_f32(from_f32<T>(__fdiv_rn(sc[j], sum)));
  __syncwarp();
  constexpr int U = 8;   // output features a lane sums at once, 32 apart
  for (int d0 = 0; d0 < Dh; d0 += 32 * U) {
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.f;
    for (int j = 0; j < T_len; ++j) {
      const float p = sc[j];
      const T* vr = v + base + (long)j * C + d0 + lane;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (d0 + lane + 32 * u < Dh) acc[u] = fmaf(p, to_f32(vr[32 * u]), acc[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (d0 + lane + 32 * u < Dh)
        out[base + (long)t * C + d0 + lane + 32 * u] = from_f32<T>(acc[u]);
  }
}

template <typename T>
int launch_rows(const void* q, const void* k, const void* v, void* out, long rows, int T_len,
                int H, int Dh, float sqrt_dh, cudaStream_t stream) {
  const long smem = rows_smem(T_len, Dh), blocks = (rows + kRowWarps - 1) / kRowWarps;
  if (smem > conv_tile::kMaxSmem || blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  auto kernel = attention_core_kernel_rows<T>;
  static long allowed = 48 * 1024;
  cudaError_t err = conv_tile::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kRowWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, rows, T_len, H, Dh, sqrt_dh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int T_len, int H,
           int Dh, float sqrt_dh, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || Dh <= 0) return (int)cudaErrorInvalidValue;
  if (Dh > kMaxDh)
    return launch_rows<T>(q, k, v, out, (long)B * H * T_len, T_len, H, Dh, sqrt_dh,
                          (cudaStream_t)stream);
  const long pairs = (long)B * H;
  Plan p = make_plan(pairs, T_len, Dh, (int)sizeof(T));
  const auto aligned = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  p.vec = (Dh * (int)sizeof(T)) % 16 == 0 && aligned(q) && aligned(k) && aligned(v) &&
          aligned(out);
  if (p.blocks <= 0 || p.blocks > 0x7fffffffL || p.smem > conv_tile::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SPDM_ATTN_CASE(DP, KC)                                                          \
  if constexpr (KC <= kc_max(DP, (int)sizeof(T)))                                      \
    if (p.dp == DP && p.kc == KC)                                                       \
      return launch_plan<T, DP, KC>(p, q, k, v, out, pairs, T_len, H, Dh, sqrt_dh, s);
  SPDM_ATTN_CASE(16, 16) SPDM_ATTN_CASE(16, 64) SPDM_ATTN_CASE(16, 128)
  SPDM_ATTN_CASE(32, 16) SPDM_ATTN_CASE(32, 64) SPDM_ATTN_CASE(32, 128)
  SPDM_ATTN_CASE(64, 16) SPDM_ATTN_CASE(64, 64) SPDM_ATTN_CASE(64, 128)
  SPDM_ATTN_CASE(128, 16) SPDM_ATTN_CASE(128, 64)
#undef SPDM_ATTN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The plan of one call, for reports: path (0 tiles, 1 rows: Dh > 128),
// padded head width, keys a chunk, (batch, head) pairs a block (rows a
// block on the row path), streamed (1) or resident (0), dynamic shared
// memory in bytes, blocks. Returns 0, or cudaErrorInvalidValue where the
// kernel does not take the shape (the row path past its shared memory).
int attention_core_plan(int B, int T_len, int H, int Dh, int esize, long* plan7) {
  if (B <= 0 || T_len <= 0 || H <= 0 || Dh <= 0 || (esize != 2 && esize != 4))
    return (int)cudaErrorInvalidValue;
  if (Dh > kMaxDh) {
    const long smem = rows_smem(T_len, Dh);
    if (smem > conv_tile::kMaxSmem) return (int)cudaErrorInvalidValue;
    const long rows = (long)B * H * T_len;
    const long v[7] = {1, Dh, 0, kRowWarps, 0, smem, (rows + kRowWarps - 1) / kRowWarps};
    for (int i = 0; i < 7; ++i) plan7[i] = v[i];
    return 0;
  }
  const Plan p = make_plan((long)B * H, T_len, Dh, esize);
  const long v[7] = {0, p.dp, p.kc, p.groups, p.streamed, p.smem, p.blocks};
  for (int i = 0; i < 7; ++i) plan7[i] = v[i];
  return 0;
}

int attention_core_f32(const void* q, const void* k, const void* v, void* out, int B, int T_len,
                       int H, int Dh, float sqrt_dh, void* stream) {
  return launch<float>(q, k, v, out, B, T_len, H, Dh, sqrt_dh, stream);
}

int attention_core_bf16(const void* q, const void* k, const void* v, void* out, int B, int T_len,
                        int H, int Dh, float sqrt_dh, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, T_len, H, Dh, sqrt_dh, stream);
}

}  // extern "C"
