// MiT transformer block and whole-stage forward, and the frozen-trunk
// training block forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of surgical_tpu/kernels/mit_block.py:
//   mit_block_forward  <- fused_mit_block (_block_kernel) and
//                         fused_mit_block_hb (_block_kernel_hb): the same
//                         function, the latter only a TPU attention schedule
//   mit_block_packed2_forward <- fused_mit_block_packed2 (_block_kernel_packed2
//                         and its banded form _block_kernel_packed2s): the
//                         1-head C = 64 block on image pairs packed into
//                         128-wide rows
//   mit_stage_forward  <- fused_mit_stage (_stage_kernel)
//   mit_block_train_forward        <- fused_mit_block_train's forward
//                                     (_block_train_fwd_kernel)
//   mit_block_train_mlp_backward   <- its MLP backward (_mlp_bwd_kernel)
//   mit_block_train_attn_backward  <- its attention backward (_attn_bwd_kernel)
//
// The backward entry points recompute the forward's intermediates from the
// saved inputs, as the Pallas kernels do, and put them through the same
// GEMM with a transposed-B load for the input gradients. The TPU's hidden-
// chunk grid of the MLP backward has no counterpart: each GEMM here runs
// over the whole hidden width, with the recomputed [B*N, hidden]
// intermediates in device-memory scratch.
//
// What bounds it on the H100: at stages 1-2 the block GEMMs have K = 64-512
// and move the [B*N, C] activation (and the 4x wider MLP hidden) through
// device memory for a few hundred FLOPs per byte at most, so they are bound
// by bytes, not by the tensor cores; stage 3-4 GEMMs are closer to the
// ridge. The attention over the 49 spatially-reduced keys is small work
// that the TPU spread over MXU dots; here the forward runs on the CUDA cores
// and the training backward's five products on the tensor cores (wmma).
//
// This first design is simple and right, not fast: each entry point is a
// short chain of hand-written kernels on the caller's stream --
//   LN-prologue GEMM (q) -> attention -> residual GEMM (out proj)
//   -> LN-prologue GEMM (fc1) -> 3x3 depthwise conv + GELU -> residual GEMM
// -- with intermediates in scratch that the Python wrapper allocates. The
// design answers the byte bound only where it is cheap to: LayerNorm is
// fused into the A-operand load of the GEMM that consumes it and bias /
// GELU / residual into its epilogue, so neither LN output nor a pre-bias
// product ever goes to memory. Fusing the chain into one pass per block,
// TMA and wgmma are later work.
//
// Rounding mirrors the Pallas bodies so that the bf16 results agree: every
// product accumulates in fp32; q, kv, the attention probabilities, ctx, the
// post-attention residual, fc1's output, the dwconv output and the GELU
// output are rounded to bf16 where the Pallas body rounds them.

#include <math_constants.h>
#include <mma.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------- GEMM ----
// out[M, N] = epilogue( A'[M, K] @ B[K, N] ): B is Bw[K, N], or with BT the
// transpose of Bw[N, K] (a forward weight read transposed for an input
// gradient). A' by prologue:
//   kPlain      A
//   kLayerNorm  bf16(LayerNorm(A)), as the Pallas body rounds xln
//   kGroupLN    bf16(LayerNorm of each K/2-wide half of A) with fp32 scale
//               and bias (lnf_g, lnf_b): the lane-packed rows of packed2
//   kRowScale   bf16(A * rowscale[row / mrows]) (a per-image DropPath factor)
// and with v the fp32 product, the epilogue writes:
//   kBias          bf16(v + bias)
//   kBiasGelu      bf16(gelu_tanh(v + bias))
//   kBiasRes       bf16(res + (v + bias))
//   kBiasResScale  bf16(res + rowscale[row / mrows] * (v + bias))
//   kGeluGrad      bf16(v * gelu_tanh'(aux))
//   kPlain         bf16(v)
//   kF32           v in fp32
// bf16 wmma 16x16x16 with fp32 accumulate; 64x64 output tile per CTA, four
// warps of 32x32. Ragged M/N/K edges are zero-filled on load and masked on
// store. K, N and every leading dimension are multiples of 8 (checked by the
// wrapper) so each 8-wide chunk is 16-byte aligned and wholly in or out.
constexpr int BM = 64, BN = 64, BK = 32, GEMM_THREADS = 128;
constexpr int LN_MAX_K = 512;  // a LayerNorm row is held in registers

enum class Pro { kPlain, kLayerNorm, kGroupLN, kRowScale };
enum class Epi { kBias, kBiasGelu, kBiasRes, kBiasResScale, kGeluGrad, kPlain, kF32 };

struct GemmArgs {
  const bf16* A;
  int lda;
  const bf16* Bw;
  int ldb;
  const bf16* bias;
  const bf16* ln_g;
  const bf16* ln_b;
  const float* lnf_g;  // kGroupLN: fp32 scale and bias [K]
  const float* lnf_b;
  const float* rowscale;  // kRowScale / kBiasResScale: one factor per mrows rows
  int mrows;
  const bf16* res;  // kBiasRes*: may alias out (same thread reads, then writes)
  int ldr;
  const bf16* aux;  // kGeluGrad: the GELU input
  int ldx;
  void* out;
  int ldo;
  int M, N, K;
};

// LayerNorm statistics of one row of K <= LN_MAX_K values, one warp per row:
// mean, then rstd from the biased variance and LN_EPS. vals[i] receives
// element lane + 32 i (0 past K).
__device__ __forceinline__ void row_stats(const bf16* row, int K, int lane,
                                          float (&vals)[LN_MAX_K / 32], float& mean,
                                          float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_K / 32; ++i) {
    const int c = lane + 32 * i;
    vals[i] = c < K ? bf2f(row[c]) : 0.f;
    s += vals[i];
  }
  mean = warp_sum(s) / K;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_K / 32; ++i) {
    const float d = vals[i] - mean;
    if (lane + 32 * i < K) ss += d * d;
  }
  rstd = rsqrtf(warp_sum(ss) / K + LN_EPS);
}

// The same statistics for each K/2-wide half of the row (the two images of
// a lane-packed row; mit_block.py::_ln_packed2). K/2 is a multiple of 32, so
// element lane + 32 i lies in half (32 i >= K/2) whatever the lane.
__device__ __forceinline__ void row_stats2(const bf16* row, int K, int lane, float (&mean)[2],
                                           float (&rstd)[2]) {
  const int G = K / 2;
  float vals[LN_MAX_K / 32], s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_K / 32; ++i) {
    const int c = lane + 32 * i;
    vals[i] = c < K ? bf2f(row[c]) : 0.f;
    if (32 * i < G) s0 += vals[i];
    else s1 += vals[i];  // 0 past K
  }
  mean[0] = warp_sum(s0) / G;
  mean[1] = warp_sum(s1) / G;
  float ss0 = 0.f, ss1 = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_K / 32; ++i) {
    if (lane + 32 * i >= K) continue;
    if (32 * i < G) ss0 += (vals[i] - mean[0]) * (vals[i] - mean[0]);
    else ss1 += (vals[i] - mean[1]) * (vals[i] - mean[1]);
  }
  rstd[0] = rsqrtf(warp_sum(ss0) / G + LN_EPS);
  rstd[1] = rsqrtf(warp_sum(ss1) / G + LN_EPS);
}

template <Pro PRO, Epi EPI, bool BT>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_bf16(const GemmArgs a) {
  __shared__ __align__(32) bf16 As[BM][BK + 8];
  // B tile as [k][n] (row-major operand) or [n][k] (transposed operand)
  __shared__ __align__(32) bf16 Bs[BT ? BN : BK][BT ? BK + 8 : BN + 8];
  __shared__ __align__(32) float Cs[BM][BN + 4];
  __shared__ float s_mean[BM][2], s_rstd[BM][2];  // [row][half]; kLayerNorm uses half 0

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = a.M, N = a.N, K = a.K;

  if constexpr (PRO == Pro::kLayerNorm || PRO == Pro::kGroupLN) {  // this CTA's row statistics
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const int gm = m0 + r;
      float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
      if (gm < M) {
        const bf16* row = a.A + (size_t)gm * a.lda;
        if constexpr (PRO == Pro::kGroupLN) {
          row_stats2(row, K, lane, mean, rstd);
        } else {
          float vals[LN_MAX_K / 32];
          row_stats(row, K, lane, vals, mean[0], rstd[0]);
        }
      }
      if (lane == 0) {
        s_mean[r][0] = mean[0], s_mean[r][1] = mean[1];
        s_rstd[r][0] = rstd[0], s_rstd[r][1] = rstd[1];
      }
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK / 8; c += GEMM_THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K) {
        val = load8(a.A + (size_t)gm * a.lda + gk);
        bf16* e = lanes8(val);
        if constexpr (PRO == Pro::kLayerNorm) {
          uint4 gv = load8(a.ln_g + gk), bv = load8(a.ln_b + gk);
          bf16 *ge = lanes8(gv), *be = lanes8(bv);
          const float mu = s_mean[r][0], rs = s_rstd[r][0];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            e[i] = f2bf((bf2f(e[i]) - mu) * rs * bf2f(ge[i]) + bf2f(be[i]));
        } else if constexpr (PRO == Pro::kGroupLN) {
          const int h = gk >= K / 2;  // an 8-wide chunk lies in one half
          const float mu = s_mean[r][h], rs = s_rstd[r][h];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            e[i] = f2bf((bf2f(e[i]) - mu) * rs * a.lnf_g[gk + i] + a.lnf_b[gk + i]);
        } else if constexpr (PRO == Pro::kRowScale) {
          const float sc = a.rowscale[gm / a.mrows];
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = f2bf(bf2f(e[i]) * sc);
        }
      }
      store8(&As[r][kc], val);
    }
    if constexpr (BT) {
      for (int c = tid; c < BN * BK / 8; c += GEMM_THREADS) {
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + kc;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gn < N && gk < K) val = load8(a.Bw + (size_t)gn * a.ldb + gk);
        store8(&Bs[r][kc], val);
      }
    } else {
      for (int c = tid; c < BK * BN / 8; c += GEMM_THREADS) {
        const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + nc;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gk < K && gn < N) val = load8(a.Bw + (size_t)gk * a.ldb + gn);
        store8(&Bs[r][nc], val);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      using BLayout = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], &As[wm + 16 * i][kk], BK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (BT)
          wmma::load_matrix_sync(bfr[j], &Bs[wn + 16 * j][kk], BK + 8);
        else
          wmma::load_matrix_sync(bfr[j], &Bs[kk][wn + 16 * j], BN + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], BN + 4,
                              wmma::mem_row_major);
  __syncthreads();

  // epilogue; `res` may alias `out`: each element is read and written by
  // the same thread
  for (int c = tid; c < BM * BN / 8; c += GEMM_THREADS) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + nc;
    if (gm >= M || gn >= N) continue;
    if constexpr (EPI == Epi::kF32) {
      float* o = static_cast<float*>(a.out) + (size_t)gm * a.ldo + gn;
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = Cs[r][nc + i];
    } else {
      constexpr bool BIAS = EPI == Epi::kBias || EPI == Epi::kBiasGelu || EPI == Epi::kBiasRes ||
                            EPI == Epi::kBiasResScale;
      constexpr bool RES = EPI == Epi::kBiasRes || EPI == Epi::kBiasResScale;
      uint4 bv = make_uint4(0, 0, 0, 0), rv = bv, xv = bv, ov;
      if constexpr (BIAS) bv = load8(a.bias + gn);
      if constexpr (RES) rv = load8(a.res + (size_t)gm * a.ldr + gn);
      if constexpr (EPI == Epi::kGeluGrad) xv = load8(a.aux + (size_t)gm * a.ldx + gn);
      float sc = 1.f;
      if constexpr (EPI == Epi::kBiasResScale) sc = a.rowscale[gm / a.mrows];
      bf16 *be = lanes8(bv), *re = lanes8(rv), *xe = lanes8(xv), *oe = lanes8(ov);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = Cs[r][nc + i];
        if constexpr (BIAS) v = v + bf2f(be[i]);
        if constexpr (EPI == Epi::kBiasGelu) v = gelu_tanh(v);
        if constexpr (EPI == Epi::kBiasResScale) v = __fmul_rn(sc, v);
        if constexpr (RES) v = bf2f(re[i]) + v;
        if constexpr (EPI == Epi::kGeluGrad) v = v * gelu_tanh_grad(bf2f(xe[i]));
        oe[i] = f2bf(v);
      }
      store8(static_cast<bf16*>(a.out) + (size_t)gm * a.ldo + gn, ov);
    }
  }
}

// ----------------------------------------------------------- attention ----
// One CTA per (image, head, 64 query rows); K and V of that head live in
// shared memory as fp32 (K rows padded to HD+1 so the per-lane key reads hit
// distinct banks). Each warp walks 16 query rows: lane j scores keys j and
// j+32 (Nkv <= 64), fp32 softmax with warp shuffles, probabilities rounded
// to bf16 before P.V (mit_block.py:163), ctx rounded to bf16.
constexpr int HD = 64, ATT_ROWS = 64, ATT_THREADS = 128, MAX_KV = 64;

__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int ldkv, bf16* __restrict__ ctx, int ldc,
                 int N, int Nkv, int heads, float scale) {
  __shared__ float Ks[MAX_KV][HD + 1];
  __shared__ float Vs[MAX_KV][HD];
  __shared__ float Qs[ATT_THREADS / 32][HD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t kv_row0 = (size_t)b * Nkv;
  for (int idx = tid; idx < Nkv * HD; idx += ATT_THREADS) {
    const int j = idx / HD, d = idx % HD;
    const size_t off = (kv_row0 + j) * ldkv + h * HD + d;
    Ks[j][d] = bf2f(k[off]);
    Vs[j][d] = bf2f(v[off]);
  }
  __syncthreads();

  const int rows_per_warp = ATT_ROWS / (ATT_THREADS / 32);
  const int r0 = blockIdx.x * ATT_ROWS + warp * rows_per_warp;
  for (int i = 0; i < rows_per_warp; ++i) {
    const int row = r0 + i;
    if (row >= N) break;
    const size_t qoff = ((size_t)b * N + row) * ldq + h * HD;
    Qs[warp][lane] = bf2f(q[qoff + lane]);
    Qs[warp][lane + 32] = bf2f(q[qoff + lane + 32]);
    __syncwarp();

    float s[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = lane + 32 * jj;
      if (j < Nkv) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot += Qs[warp][d] * Ks[j][d];
        s[jj] = dot * scale;
      } else {
        s[jj] = -CUDART_INF_F;
      }
    }
    const float m = warp_max(fmaxf(s[0], s[1]));
    float e[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) e[jj] = (lane + 32 * jj < Nkv) ? expf(s[jj] - m) : 0.f;
    const float denom = warp_sum(e[0] + e[1]);
    float p[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) p[jj] = bf2f(f2bf(e[jj] / denom));

    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < Nkv; ++j) {
      const float pj = __shfl_sync(FULL_MASK, j < 32 ? p[0] : p[1], j & 31);
      a0 += pj * Vs[j][lane];
      a1 += pj * Vs[j][lane + 32];
    }
    const size_t coff = ((size_t)b * N + row) * ldc + h * HD;
    ctx[coff + lane] = f2bf(a0);
    ctx[coff + lane + 32] = f2bf(a1);
    __syncwarp();
  }
}

// ------------------------------------------------- depthwise conv + GELU ----
// Channel-last [B, H, W, C] 3x3 depthwise conv with zero edges, fp32
// accumulate in the tap order of mit_block.py::_dwconv3x3, + bias, rounded to
// bf16, then (GELU) tanh GELU, rounded to bf16. One thread per 8 channels.
template <bool GELU>
__global__ void dwconv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                 const bf16* __restrict__ bias, bf16* __restrict__ out,
                                 int B, int H, int W, int C) {
  const int C8 = C / 8;
  const size_t total = (size_t)B * H * W * C8;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(t % C8) * 8;
    size_t p = t / C8;
    const int xx = (int)(p % W);
    p /= W;
    const int yy = (int)(p % H);
    const size_t b = p / H;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int sy = yy + dy, sx = xx + dx;
        if (sy < 0 || sy >= H || sx < 0 || sx >= W) continue;
        uint4 hv = load8(x + ((b * H + sy) * W + sx) * C + c);
        uint4 wv = load8(w + (size_t)((dy + 1) * 3 + (dx + 1)) * C + c);
        bf16 *he = lanes8(hv), *we = lanes8(wv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += bf2f(he[i]) * bf2f(we[i]);
      }
    }
    uint4 bv = load8(bias + c), ov;
    bf16 *be = lanes8(bv), *oe = lanes8(ov);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bf16 h = f2bf(acc[i] + bf2f(be[i]));
      oe[i] = GELU ? f2bf(gelu_tanh(bf2f(h))) : h;
    }
    store8(out + ((b * H + yy) * W + xx) * C + c, ov);
  }
}

// The conv's input gradient (mit_block.py::_dwconv3x3_T): the flipped-tap
// conv out[y, x] = sum_k g[y - dy_k, x - dx_k] * w_k over the taps whose
// source (y - dy_k, x - dx_k) lies in the grid -- exactly the positions
// that fired tap k in the forward. No bias; fp32 accumulate in tap order,
// rounded to bf16.
__global__ void dwconv3x3_t_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
                                   bf16* __restrict__ out, int B, int H, int W, int C) {
  const int C8 = C / 8;
  const size_t total = (size_t)B * H * W * C8;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(t % C8) * 8;
    size_t p = t / C8;
    const int xx = (int)(p % W);
    p /= W;
    const int yy = (int)(p % H);
    const size_t b = p / H;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int sy = yy - dy, sx = xx - dx;
        if (sy < 0 || sy >= H || sx < 0 || sx >= W) continue;
        uint4 gv = load8(g + ((b * H + sy) * W + sx) * C + c);
        uint4 wv = load8(w + (size_t)((dy + 1) * 3 + (dx + 1)) * C + c);
        bf16 *ge = lanes8(gv), *we = lanes8(wv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += bf2f(ge[i]) * bf2f(we[i]);
      }
    }
    uint4 ov;
    bf16* oe = lanes8(ov);
#pragma unroll
    for (int i = 0; i < 8; ++i) oe[i] = f2bf(acc[i]);
    store8(out + ((b * H + yy) * W + xx) * C + c, ov);
  }
}

// ------------------------------------------------- attention backward ----
// The softmax/context backward of mit_block.py::_attn_bwd_kernel for one
// (image, head, ABW_TILES tiles of ABW_R query rows) per CTA, on the tensor
// cores (bf16 wmma 16x16x16, fp32 accumulate). K and V of the head (keys
// zero-padded to 64) stay in shared memory; per tile of rows:
//   S = q k^T and dP = dctx v^T (wmma, fp32 to shared);
//   a warp per row: P = softmax(S * scale) in fp32, rowsum(dP * P),
//     dS = bf16(P * (dP - rowsum) * scale), bf16(P) (rows past N: zeros);
//   dq = dS k (wmma) rounded to bf16; dv += bf16(P)^T dctx and
//   dk += dS^T q in wmma accumulators that live across the CTA's tiles.
// dk and dv sum over every query row of the image, which spans CTAs: each
// CTA adds its fp32 partial sums into an fp32 workspace with atomics, rounded
// to bf16 once by f32_to_bf16_kernel afterwards. The operands are rounded
// where the plain version rounds them, so only summation order differs.
constexpr int ABW_R = 64, ABW_TILES = 2, ABW_THREADS = 256;
constexpr int ABW_LD = HD + 8, ABW_LDF = HD + 4;  // padded row strides (elements)
static_assert(MAX_KV == HD, "the key and head-dim tiles share one layout");

struct AbwSmem {
  bf16 K[MAX_KV][ABW_LD], V[MAX_KV][ABW_LD];  // [key][d]
  bf16 Q[ABW_R][ABW_LD], D[ABW_R][ABW_LD];    // [row][d]: q and dctx
  bf16 P[ABW_R][ABW_LD], S[ABW_R][ABW_LD];    // [row][key]: bf16(P), dS
  float F0[ABW_R][ABW_LDF], F1[ABW_R][ABW_LDF];  // S then dq; dP
};

__global__ void __launch_bounds__(ABW_THREADS)
attention_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dctx,
                     bf16* __restrict__ dq, float* __restrict__ dk_ws,
                     float* __restrict__ dv_ws, int N, int Nkv, int C, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char abw_smem[];
  AbwSmem& sm = *reinterpret_cast<AbwSmem*>(abw_smem);
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t kv_row0 = (size_t)b * Nkv;
  const uint4 zero8 = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < MAX_KV * HD / 8; idx += ABW_THREADS) {
    const int j = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
    const size_t off = (kv_row0 + j) * C + h * HD + d;
    store8(&sm.K[j][d], j < Nkv ? load8(k + off) : zero8);
    store8(&sm.V[j][d], j < Nkv ? load8(v + off) : zero8);
  }

  // warp -> 16-row block wr and the two 16-column blocks 2 wc, 2 wc + 1 of
  // every 64x64 product; dk/dv rows are keys
  const int wr = warp >> 1, wc = warp & 1;
  FragC acc_dk[2], acc_dv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    wmma::fill_fragment(acc_dk[i], 0.f);
    wmma::fill_fragment(acc_dv[i], 0.f);
  }

  for (int tile = 0; tile < ABW_TILES; ++tile) {
    const int row0 = (blockIdx.x * ABW_TILES + tile) * ABW_R;
    if (row0 >= N) break;  // the same for every thread of the CTA
    __syncthreads();  // the previous tile's readers of Q, D, P, S, F0 are done
    for (int idx = tid; idx < ABW_R * HD / 8; idx += ABW_THREADS) {
      const int r = idx / (HD / 8), d = (idx % (HD / 8)) * 8, row = row0 + r;
      const size_t off = ((size_t)b * N + row) * C + h * HD + d;
      store8(&sm.Q[r][d], row < N ? load8(q + off) : zero8);
      store8(&sm.D[r][d], row < N ? load8(dctx + off) : zero8);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i) {  // S = q k^T, dP = dctx v^T
      const int cb = 16 * (2 * wc + i);
      FragC cs, cp;
      wmma::fill_fragment(cs, 0.f);
      wmma::fill_fragment(cp, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        FragA a;
        FragBT bt;
        wmma::load_matrix_sync(a, &sm.Q[16 * wr][kk], ABW_LD);
        wmma::load_matrix_sync(bt, &sm.K[cb][kk], ABW_LD);
        wmma::mma_sync(cs, a, bt, cs);
        wmma::load_matrix_sync(a, &sm.D[16 * wr][kk], ABW_LD);
        wmma::load_matrix_sync(bt, &sm.V[cb][kk], ABW_LD);
        wmma::mma_sync(cp, a, bt, cp);
      }
      wmma::store_matrix_sync(&sm.F0[16 * wr][cb], cs, ABW_LDF, wmma::mem_row_major);
      wmma::store_matrix_sync(&sm.F1[16 * wr][cb], cp, ABW_LDF, wmma::mem_row_major);
    }
    __syncthreads();

    for (int r = warp; r < ABW_R; r += ABW_THREADS / 32) {  // softmax backward
      const bool valid = row0 + r < N;
      float s[2], e[2], p[2], dp[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        s[jj] = j < Nkv ? sm.F0[r][j] * scale : -CUDART_INF_F;
        dp[jj] = sm.F1[r][j];
      }
      const float m = warp_max(fmaxf(s[0], s[1]));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) e[jj] = (lane + 32 * jj < Nkv) ? expf(s[jj] - m) : 0.f;
      const float denom = warp_sum(e[0] + e[1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) p[jj] = e[jj] / denom;
      const float rs = warp_sum(dp[0] * p[0] + dp[1] * p[1]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        sm.P[r][j] = f2bf(valid ? p[jj] : 0.f);
        sm.S[r][j] = f2bf(valid ? p[jj] * (dp[jj] - rs) * scale : 0.f);
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cb = 16 * (2 * wc + i);
      FragC cq;
      wmma::fill_fragment(cq, 0.f);
#pragma unroll
      for (int kk = 0; kk < MAX_KV; kk += 16) {
        FragA a;
        FragB bm;
        FragAT at;
        wmma::load_matrix_sync(a, &sm.S[16 * wr][kk], ABW_LD);  // dq = dS k
        wmma::load_matrix_sync(bm, &sm.K[kk][cb], ABW_LD);
        wmma::mma_sync(cq, a, bm, cq);
        wmma::load_matrix_sync(at, &sm.P[kk][16 * wr], ABW_LD);  // dv += P^T dctx
        wmma::load_matrix_sync(bm, &sm.D[kk][cb], ABW_LD);
        wmma::mma_sync(acc_dv[i], at, bm, acc_dv[i]);
        wmma::load_matrix_sync(at, &sm.S[kk][16 * wr], ABW_LD);  // dk += dS^T q
        wmma::load_matrix_sync(bm, &sm.Q[kk][cb], ABW_LD);
        wmma::mma_sync(acc_dk[i], at, bm, acc_dk[i]);
      }
      wmma::store_matrix_sync(&sm.F0[16 * wr][cb], cq, ABW_LDF, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < ABW_R * HD / 8; idx += ABW_THREADS) {
      const int r = idx / (HD / 8), d = (idx % (HD / 8)) * 8, row = row0 + r;
      if (row >= N) continue;
      uint4 ov;
      bf16* oe = lanes8(ov);
#pragma unroll
      for (int i = 0; i < 8; ++i) oe[i] = f2bf(sm.F0[r][d + i]);
      store8(dq + ((size_t)b * N + row) * C + h * HD + d, ov);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int cb = 16 * (2 * wc + i);
    wmma::store_matrix_sync(&sm.F0[16 * wr][cb], acc_dk[i], ABW_LDF, wmma::mem_row_major);
    wmma::store_matrix_sync(&sm.F1[16 * wr][cb], acc_dv[i], ABW_LDF, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = tid; idx < Nkv * HD; idx += ABW_THREADS) {
    const int j = idx / HD, d = idx % HD;
    const size_t off = (kv_row0 + j) * C + h * HD + d;
    atomicAdd(dk_ws + off, sm.F0[j][d]);
    atomicAdd(dv_ws + off, sm.F1[j][d]);
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ in, bf16* __restrict__ out,
                                   size_t n) {
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x)
    out[t] = f2bf(in[t]);
}

// ------------------------------------------------------------ LayerNorm ----
// One warp per row of C <= LN_MAX_K; out = bf16(LN(x)). On the stage path
// only: its LN1 output feeds both the q and kv products (and the SR regroup).
__global__ void layernorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                                 const bf16* __restrict__ b, bf16* __restrict__ y, int M,
                                 int C) {
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float vals[LN_MAX_K / 32], mean, rstd;
  row_stats(x + (size_t)row * C, C, lane, vals, mean, rstd);
#pragma unroll
  for (int i = 0; i < LN_MAX_K / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < C) y[(size_t)row * C + c] = f2bf((vals[i] - mean) * rstd * bf2f(g[c]) + bf2f(b[c]));
  }
}

// ------------------------------------------------------ SR patch regroup ----
// The sr x sr stride-sr conv is a GEMM over regrouped patches:
// out[b, r, c, (dy*sr + dx)*C + ch] = x[b, sr*r + dy, sr*c + dx, ch]
// (the row order of the flax kernel reshaped to [sr*sr*C, C]).
__global__ void sr_patches_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int B,
                                  int H, int W, int C, int sr) {
  const int Hk = H / sr, Wk = W / sr, C8 = C / 8;
  const size_t total = (size_t)B * Hk * Wk * sr * sr * C8;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(t % C8) * 8;
    size_t p = t / C8;
    const int tap = (int)(p % (sr * sr));
    p /= sr * sr;
    const int cc = (int)(p % Wk);
    p /= Wk;
    const int rr = (int)(p % Hk);
    const size_t b = p / Hk;
    const int sy = sr * rr + tap / sr, sx = sr * cc + tap % sr;
    store8(out + (((b * Hk + rr) * Wk + cc) * sr * sr + tap) * C + c,
           load8(x + ((b * H + sy) * W + sx) * C + c));
  }
}

// ------------------------------------------------------ lane pack/unpack ----
// The image-pair packing of fused_mit_block_packed2 (mit_block.py:826-829,
// 950-951): packed[p, n, s*C + c] = x[2p + s, n, c], for s in {0, 1}. PACK
// copies x [2P, n, C] into packed [P, n, 2C]; otherwise the inverse.
template <bool PACK>
__global__ void lane_pack2_kernel(const bf16* __restrict__ in, bf16* __restrict__ out, int P,
                                  int n, int C) {
  const int C8 = C / 8;
  const size_t total = (size_t)P * n * 2 * C8;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(t % C8) * 8;
    size_t r = t / C8;
    const int s = (int)(r % 2);
    r /= 2;
    const size_t row = r % n, p = r / n;
    const size_t packed = ((p * n + row) * 2 + s) * C + c;
    const size_t plain = ((2 * p + s) * n + row) * C + c;
    if (PACK)
      store8(out + packed, load8(in + plain));
    else
      store8(out + plain, load8(in + packed));
  }
}

// ------------------------------------------------------------- launchers ----
template <Pro PRO, Epi EPI, bool BT = false>
void launch_gemm(cudaStream_t s, const GemmArgs& a) {
  dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  gemm_bf16<PRO, EPI, BT><<<grid, GEMM_THREADS, 0, s>>>(a);
}

// The forward's products: out = bf16([res +] [gelu](A' @ Bw + bias)),
// A' = A or LayerNorm(A); Bw [K, N].
template <bool LN, bool GELU, bool RES>
void gemm(cudaStream_t s, const bf16* A, int lda, const bf16* Bw, int ldb, const bf16* bias,
          const bf16* ln_g, const bf16* ln_b, const bf16* res, int ldr, bf16* out, int ldo,
          int M, int N, int K) {
  static_assert(!(GELU && RES), "no forward product has both");
  GemmArgs a{};
  a.A = A, a.lda = lda, a.Bw = Bw, a.ldb = ldb, a.bias = bias, a.ln_g = ln_g, a.ln_b = ln_b;
  a.res = res, a.ldr = ldr, a.out = out, a.ldo = ldo, a.M = M, a.N = N, a.K = K;
  constexpr Epi E = GELU ? Epi::kBiasGelu : RES ? Epi::kBiasRes : Epi::kBias;
  launch_gemm<LN ? Pro::kLayerNorm : Pro::kPlain, E>(s, a);
}

// A GemmArgs for out[M, N] = A[M, K] @ B with every leading dimension the
// matrices' own widths (B: Bw [K, N], or Bw [N, K] when transposed).
GemmArgs dense_args(const bf16* A, const bf16* Bw, void* out, int M, int N, int K,
                    bool transposed) {
  GemmArgs a{};
  a.A = A, a.lda = K, a.Bw = Bw, a.ldb = transposed ? K : N, a.out = out, a.ldo = N;
  a.M = M, a.N = N, a.K = K;
  return a;
}

int grid_for(size_t work, int threads) {
  const size_t blocks = (work + threads - 1) / threads;
  return (int)(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

void attention(cudaStream_t s, const bf16* q, const bf16* k, const bf16* v, int ldkv, bf16* ctx,
               int B, int N, int Nkv, int C, int heads) {
  dim3 grid((N + ATT_ROWS - 1) / ATT_ROWS, B * heads);
  attention_kernel<<<grid, ATT_THREADS, 0, s>>>(q, C, k, v, ldkv, ctx, C, N, Nkv, heads,
                                                1.0f / sqrtf((float)HD));
}

// x1 = x + (ctx @ wo + bo) -> y ; y = y + fc2(gelu(dwconv(fc1(LN2(y)))))
void attn_out_and_mlp(cudaStream_t s, const bf16* x, const bf16* ctx, const bf16* wo,
                      const bf16* bo, const bf16* ln2_g, const bf16* ln2_b, const bf16* w1,
                      const bf16* b1, const bf16* wdw, const bf16* bdw, const bf16* w2,
                      const bf16* b2, bf16* hid, bf16* act, bf16* y, int B, int H, int W,
                      int C, int hidden) {
  const int M = B * H * W;
  gemm<false, false, true>(s, ctx, C, wo, C, bo, nullptr, nullptr, x, C, y, C, M, C, C);
  gemm<true, false, false>(s, y, C, w1, hidden, b1, ln2_g, ln2_b, nullptr, 0, hid, hidden, M,
                           hidden, C);
  dwconv3x3_kernel<true><<<grid_for((size_t)M * hidden / 8, 256), 256, 0, s>>>(
      hid, wdw, bdw, act, B, H, W, hidden);
  gemm<false, false, true>(s, act, hidden, w2, C, b2, nullptr, nullptr, y, C, y, C, M, C,
                           hidden);
}

}  // namespace

extern "C" {

// One MiT block, LN1 in the q GEMM's prologue; k, v: [B, Nkv, C] precomputed
// from the spatial-reduction path. Weights in the JAX layout ([in, out]),
// all bf16; wdw [9, hidden] in dy-major tap order. Scratch: q, ctx [B*N, C],
// hid, act [B*N, hidden]. y must not alias x.
int mit_block_forward(const void* x, const void* k, const void* v, const void* ln1_g,
                      const void* ln1_b, const void* wq, const void* bq, const void* wo,
                      const void* bo, const void* ln2_g, const void* ln2_b, const void* w1,
                      const void* b1, const void* wdw, const void* bdw, const void* w2,
                      const void* b2, void* q, void* ctx, void* hid, void* act, void* y, int B,
                      int H, int W, int C, int heads, int Nkv, int hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * H * W;
  typedef const bf16* P;
  gemm<true, false, false>(s, (P)x, C, (P)wq, C, (P)bq, (P)ln1_g, (P)ln1_b, nullptr, 0,
                           (bf16*)q, C, M, C, C);
  attention(s, (P)q, (P)k, (P)v, C, (bf16*)ctx, B, H * W, Nkv, C, heads);
  attn_out_and_mlp(s, (P)x, (P)ctx, (P)wo, (P)bo, (P)ln2_g, (P)ln2_b, (P)w1, (P)b1, (P)wdw,
                   (P)bdw, (P)w2, (P)b2, (bf16*)hid, (bf16*)act, (bf16*)y, B, H, W, C, hidden);
  return (int)cudaGetLastError();
}

// fused_mit_block_packed2 (mit_block.py:801): the 1-head, C = 64 block over
// image pairs, each token row the 128-wide [x[2p, n], x[2p+1, n]]. The
// packed weights are used as given, as full 128-wide products (wq, wo
// [128, 128], w1 [128, hidden], w2 [hidden, 128], wdw [9, hidden]), so any
// packed dict gives the TPU kernel's function, not only block-diagonal ones.
// On the packed rows:
//   LN1 per 64-lane half (ln1 [2, 128] fp32: scale, bias) in the q GEMM's
//   prologue; attention at heads = 2, head_dim 64 over k, v packed the same
//   way, which is the per-image segment softmax of the TPU body (each
//   segment takes its own max: the TPU body's row-global max is the same in
//   real arithmetic); out projection + residual; LN2 per half (ln2 [2, 128]
//   fp32) in fc1's prologue; dwconv 3x3 + GELU; fc2 + residual.
// The TPU kernel's row bands (row_chunks) bound its VMEM; here every kernel
// sees the whole grid, and the zero-edge dwconv is that same function. Like
// the stage-1 block it is bound by bytes: the full 128-wide products double
// the block GEMMs' FLOPs but leave them far under the ridge.
// Pack and unpack are copies around the chain. Scratch: xp [P*N, 128]
// (x, then the residual stream in place), kp, vp [P*Nkv, 128], q, ctx
// [P*N, 128], hid, act [P*N, hidden]. y [B, N, 64] must not alias x.
int mit_block_packed2_forward(const void* x, const void* k, const void* v, const void* ln1,
                              const void* wq, const void* bq, const void* wo, const void* bo,
                              const void* ln2, const void* w1, const void* b1, const void* wdw,
                              const void* bdw, const void* w2, const void* b2, void* xp, void* kp,
                              void* vp, void* q, void* ctx, void* hid, void* act, void* y, int B,
                              int H, int W, int Nkv, int hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  constexpr int C = HD, C2 = 2 * HD;  // 64 channels per image, two images per row
  const int pairs = B / 2, N = H * W, M = pairs * N;
  const int pack_threads = 256;
  lane_pack2_kernel<true><<<grid_for((size_t)M * C2 / 8, pack_threads), pack_threads, 0, s>>>(
      (P)x, (bf16*)xp, pairs, N, C);
  lane_pack2_kernel<true><<<grid_for((size_t)pairs * Nkv * C2 / 8, pack_threads), pack_threads,
                            0, s>>>((P)k, (bf16*)kp, pairs, Nkv, C);
  lane_pack2_kernel<true><<<grid_for((size_t)pairs * Nkv * C2 / 8, pack_threads), pack_threads,
                            0, s>>>((P)v, (bf16*)vp, pairs, Nkv, C);
  GemmArgs a = dense_args((P)xp, (P)wq, q, M, C2, C2, false);  // q = LN1(xp) wq + bq
  a.bias = (P)bq, a.lnf_g = (const float*)ln1, a.lnf_b = (const float*)ln1 + C2;
  launch_gemm<Pro::kGroupLN, Epi::kBias>(s, a);
  attention(s, (P)q, (P)kp, (P)vp, C2, (bf16*)ctx, pairs, N, Nkv, C2, 2);
  a = dense_args((P)ctx, (P)wo, xp, M, C2, C2, false);  // xp += ctx wo + bo
  a.bias = (P)bo, a.res = (P)xp, a.ldr = C2;
  launch_gemm<Pro::kPlain, Epi::kBiasRes>(s, a);
  a = dense_args((P)xp, (P)w1, hid, M, hidden, C2, false);  // hid = LN2(xp) w1 + b1
  a.bias = (P)b1, a.lnf_g = (const float*)ln2, a.lnf_b = (const float*)ln2 + C2;
  launch_gemm<Pro::kGroupLN, Epi::kBias>(s, a);
  dwconv3x3_kernel<true><<<grid_for((size_t)M * hidden / 8, 256), 256, 0, s>>>(
      (P)hid, (P)wdw, (P)bdw, (bf16*)act, pairs, H, W, hidden);
  a = dense_args((P)act, (P)w2, xp, M, C2, hidden, false);  // xp += fc2(act) + b2
  a.bias = (P)b2, a.res = (P)xp, a.ldr = C2;
  launch_gemm<Pro::kPlain, Epi::kBiasRes>(s, a);
  lane_pack2_kernel<false><<<grid_for((size_t)M * C2 / 8, pack_threads), pack_threads, 0, s>>>(
      (P)xp, (bf16*)y, pairs, N, C);
  return (int)cudaGetLastError();
}

// All `depth` blocks of one stage. Per block d: [prompt add from the stage
// entry base: x += gelu(base @ lww[d] + lwb[d]) @ sharedw + sharedb], LN1,
// [sr > 1: SR conv as patch regroup + GEMM, its LN], kv and q projections,
// attention, out projection, MLP. Per-depth weights are stacked on a leading
// axis in the layout of stage_weights_from_params; `base` is null for a stage
// without prompts, srw/srb/lnkv are null when sr == 1. y [B, N, C] receives
// the stage output. Scratch: xln, q, ctx [B*N, C]; feat [B*N, C4];
// patches [B*Nkv, sr*sr*C]; red, kvin [B*Nkv, C]; kv [B*Nkv, 2C];
// hid, act [B*N, hidden].
int mit_stage_forward(const void* x, const void* base, const void* sharedw, const void* sharedb,
                      const void* lww, const void* lwb, const void* srw, const void* srb,
                      const void* lnkv, const void* ln1, const void* wkv, const void* bkv,
                      const void* wq, const void* bq, const void* wo, const void* bo,
                      const void* ln2, const void* w1, const void* b1, const void* wdw,
                      const void* bdw, const void* w2, const void* b2, void* y, void* xln,
                      void* feat, void* patches, void* red, void* kvin, void* kv, void* q,
                      void* ctx, void* hid, void* act, int B, int H, int W, int C, int heads,
                      int sr, int depth, int Cb, int C4, int hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  const int N = H * W, M = B * N;
  const int Nkv = (H / sr) * (W / sr), Mkv = B * Nkv;
  bf16* Y = (bf16*)y;
  cudaMemcpyAsync(y, x, (size_t)M * C * sizeof(bf16), cudaMemcpyDeviceToDevice, s);
  for (int d = 0; d < depth; ++d) {
    if (base != nullptr) {
      gemm<false, true, false>(s, (P)base, Cb, (P)lww + (size_t)d * Cb * C4, C4,
                               (P)lwb + (size_t)d * C4, nullptr, nullptr, nullptr, 0,
                               (bf16*)feat, C4, M, C4, Cb);
      gemm<false, false, true>(s, (P)feat, C4, (P)sharedw, C, (P)sharedb, nullptr, nullptr, Y,
                               C, Y, C, M, C, C4);
    }
    const bf16* l1 = (P)ln1 + (size_t)d * 2 * C;
    layernorm_kernel<<<(M + 3) / 4, 128, 0, s>>>(Y, l1, l1 + C, (bf16*)xln, M, C);
    const bf16* kv_in = (P)xln;
    if (sr > 1) {
      sr_patches_kernel<<<grid_for((size_t)Mkv * sr * sr * C / 8, 256), 256, 0, s>>>(
          (P)xln, (bf16*)patches, B, H, W, C, sr);
      gemm<false, false, false>(s, (P)patches, sr * sr * C, (P)srw + (size_t)d * sr * sr * C * C,
                                C, (P)srb + (size_t)d * C, nullptr, nullptr, nullptr, 0,
                                (bf16*)red, C, Mkv, C, sr * sr * C);
      const bf16* lk = (P)lnkv + (size_t)d * 2 * C;
      layernorm_kernel<<<(Mkv + 3) / 4, 128, 0, s>>>((P)red, lk, lk + C, (bf16*)kvin, Mkv, C);
      kv_in = (P)kvin;
    }
    gemm<false, false, false>(s, kv_in, C, (P)wkv + (size_t)d * C * 2 * C, 2 * C,
                              (P)bkv + (size_t)d * 2 * C, nullptr, nullptr, nullptr, 0,
                              (bf16*)kv, 2 * C, Mkv, 2 * C, C);
    gemm<false, false, false>(s, (P)xln, C, (P)wq + (size_t)d * C * C, C, (P)bq + (size_t)d * C,
                              nullptr, nullptr, nullptr, 0, (bf16*)q, C, M, C, C);
    attention(s, (P)q, (P)kv, (P)kv + C, 2 * C, (bf16*)ctx, B, N, Nkv, C, heads);
    const bf16* l2 = (P)ln2 + (size_t)d * 2 * C;
    attn_out_and_mlp(s, Y, (P)ctx, (P)wo + (size_t)d * C * C, (P)bo + (size_t)d * C, l2, l2 + C,
                     (P)w1 + (size_t)d * C * hidden, (P)b1 + (size_t)d * hidden,
                     (P)wdw + (size_t)d * 9 * hidden, (P)bdw + (size_t)d * hidden,
                     (P)w2 + (size_t)d * hidden * C, (P)b2 + (size_t)d * C, (bf16*)hid,
                     (bf16*)act, Y, B, H, W, C, hidden);
  }
  return (int)cudaGetLastError();
}

// ---- training: fused_mit_block_train (surgical_tpu/kernels/mit_block.py) ----
// The trunk is frozen, so the backward computes input gradients only.

// Forward (_block_train_fwd_kernel, mit_block.py:1339): the block with xln =
// LN1(x) given, the per-image DropPath factors m1/m2 [B] (fp32, 0 or
// 1/keep) applied to each fp32 branch before its residual rounding, and the
// post-attention residual x1 written out for the backward. Scratch: q, ctx
// [B*N, C]; hid, act [B*N, hidden].
int mit_block_train_forward(const void* x, const void* xln, const void* k, const void* v,
                            const void* m1, const void* m2, const void* wq, const void* bq,
                            const void* wo, const void* bo, const void* ln2_g,
                            const void* ln2_b, const void* w1, const void* b1, const void* wdw,
                            const void* bdw, const void* w2, const void* b2, void* q, void* ctx,
                            void* hid, void* act, void* x1, void* y, int B, int H, int W, int C,
                            int heads, int Nkv, int hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  const int N = H * W, M = B * N;
  GemmArgs a = dense_args((P)xln, (P)wq, q, M, C, C, false);
  a.bias = (P)bq;
  launch_gemm<Pro::kPlain, Epi::kBias>(s, a);
  attention(s, (P)q, (P)k, (P)v, C, (bf16*)ctx, B, N, Nkv, C, heads);
  a = dense_args((P)ctx, (P)wo, x1, M, C, C, false);  // x1 = x + m1 * (ctx wo + bo)
  a.bias = (P)bo, a.res = (P)x, a.ldr = C, a.rowscale = (const float*)m1, a.mrows = N;
  launch_gemm<Pro::kPlain, Epi::kBiasResScale>(s, a);
  gemm<true, false, false>(s, (P)x1, C, (P)w1, hidden, (P)b1, (P)ln2_g, (P)ln2_b, nullptr, 0,
                           (bf16*)hid, hidden, M, hidden, C);
  dwconv3x3_kernel<true><<<grid_for((size_t)M * hidden / 8, 256), 256, 0, s>>>(
      (P)hid, (P)wdw, (P)bdw, (bf16*)act, B, H, W, hidden);
  a = dense_args((P)act, (P)w2, y, M, C, hidden, false);  // y = x1 + m2 * mlp
  a.bias = (P)b2, a.res = (P)x1, a.ldr = C, a.rowscale = (const float*)m2, a.mrows = N;
  launch_gemm<Pro::kPlain, Epi::kBiasResScale>(s, a);
  return (int)cudaGetLastError();
}

// MLP backward (_mlp_bwd_kernel, mit_block.py:1419) over all of hidden at
// once: recompute a1 = bf16(h2ln w1 + b1) and hd = bf16(dwconv(a1) + bdw),
// then dh = bf16((dmlp w2^T) * gelu'(hd)), da1 = dwconv^T(dh) and
// dh2ln = da1 w1^T in fp32 [B*N, C]. Scratch bufA, bufB [B*N, hidden]
// (a1 then dh; hd then da1).
int mit_block_train_mlp_backward(const void* h2ln, const void* dmlp, const void* w1,
                                 const void* b1, const void* wdw, const void* bdw,
                                 const void* w2, void* bufA, void* bufB, void* dh2ln, int B,
                                 int H, int W, int C, int hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  const int M = B * H * W;
  const int conv_grid = grid_for((size_t)M * hidden / 8, 256);
  GemmArgs a = dense_args((P)h2ln, (P)w1, bufA, M, hidden, C, false);
  a.bias = (P)b1;
  launch_gemm<Pro::kPlain, Epi::kBias>(s, a);
  dwconv3x3_kernel<false><<<conv_grid, 256, 0, s>>>((P)bufA, (P)wdw, (P)bdw, (bf16*)bufB, B, H,
                                                    W, hidden);
  a = dense_args((P)dmlp, (P)w2, bufA, M, hidden, C, true);
  a.aux = (P)bufB, a.ldx = hidden;
  launch_gemm<Pro::kPlain, Epi::kGeluGrad, true>(s, a);
  dwconv3x3_t_kernel<<<conv_grid, 256, 0, s>>>((P)bufA, (P)wdw, (bf16*)bufB, B, H, W, hidden);
  launch_gemm<Pro::kPlain, Epi::kF32, true>(s, dense_args((P)bufB, (P)w1, dh2ln, M, C, hidden,
                                                          true));
  return (int)cudaGetLastError();
}

// Attention backward (_attn_bwd_kernel, mit_block.py:1472): recompute
// q = bf16(xln wq + bq); dctx = bf16(bf16(dx1 * m1) wo^T); the softmax and
// context backward (attention_bwd_kernel) into dq and the fp32 dk/dv
// workspaces dk_ws, dv_ws [B*Nkv, C], which the caller zeroes; then
// dxln = bf16(dq wq^T), dk = bf16(dk_ws), dv = bf16(dv_ws). Scratch: q,
// dctx, dq [B*N, C].
int mit_block_train_attn_backward(const void* xln, const void* k, const void* v,
                                  const void* dx1, const void* m1, const void* wq,
                                  const void* bq, const void* wo, void* q, void* dctx, void* dq,
                                  void* dk_ws, void* dv_ws, void* dxln, void* dk, void* dv, int B,
                                  int N, int C, int heads, int Nkv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  const int M = B * N;
  GemmArgs a = dense_args((P)xln, (P)wq, q, M, C, C, false);
  a.bias = (P)bq;
  launch_gemm<Pro::kPlain, Epi::kBias>(s, a);
  a = dense_args((P)dx1, (P)wo, dctx, M, C, C, true);
  a.rowscale = (const float*)m1, a.mrows = N;
  launch_gemm<Pro::kRowScale, Epi::kPlain, true>(s, a);
  const int rows_per_cta = ABW_R * ABW_TILES;
  dim3 grid((N + rows_per_cta - 1) / rows_per_cta, B * heads);
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(AbwSmem));
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  attention_bwd_kernel<<<grid, ABW_THREADS, sizeof(AbwSmem), s>>>(
      (P)q, (P)k, (P)v, (P)dctx, (bf16*)dq, (float*)dk_ws, (float*)dv_ws, N, Nkv, C, heads,
      1.0f / sqrtf((float)HD));
  launch_gemm<Pro::kPlain, Epi::kPlain, true>(s, dense_args((P)dq, (P)wq, dxln, M, C, C, true));
  const size_t nkv = (size_t)B * Nkv * C;
  f32_to_bf16_kernel<<<grid_for(nkv, 256), 256, 0, s>>>((const float*)dk_ws, (bf16*)dk, nkv);
  f32_to_bf16_kernel<<<grid_for(nkv, 256), 256, 0, s>>>((const float*)dv_ws, (bf16*)dv, nkv);
  return (int)cudaGetLastError();
}

}  // extern "C"
