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
// that the TPU spread over MXU dots; here the serving forward runs on the
// tensor cores (mma.sync), the train and packed2 forward on the CUDA cores,
// and the training backward's five products on the tensor cores (wmma).
//
// Each entry point is a short chain of hand-written kernels on the caller's
// stream --
//   LN-prologue product (q) -> attention -> residual product (out proj)
//   -> LN-prologue product (fc1) -> 3x3 depthwise conv + GELU -> residual
//   product (fc2)
// -- with intermediates in scratch that the Python wrapper allocates.
// LayerNorm is fused into the A operand of the product that consumes it and
// bias / GELU / residual into its epilogue, so neither LN output nor a
// pre-bias product goes to memory.
//
// The serving entry points (mit_block_forward, mit_stage_forward) run that
// chain on Hopper's own paths (see "serving kernels" below): wgmma_linear,
// wgmma products fed by a TMA ring with the LN'd A panel resident in shared
// memory, and attention_tc_kernel, the attention on the tensor cores with
// K and V staged once per CTA; their launch plans come from the Python
// wrapper. The train and packed2 entry points keep the first design's
// gemm_bf16 (wmma, one stage of synchronous loads) and attention_kernel
// (CUDA cores). The MLP tail fused on chip (the Pallas body's mlp_chunk
// form, hid and act kept out of device memory) was built and measured
// slower than this chain at every b3 stage (PERF.md, Findings), so it is not
// here.
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
#include "hopper.cuh"

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

// ===================================================== serving kernels ====
// The products and the attention of mit_block_forward and mit_stage_forward
// (the serving path), redesigned for Hopper; the train and packed2 entry
// points above keep gemm_bf16, attention_kernel and dwconv3x3_kernel.

// ---------------------------------------------------- wgmma_linear ----
// out[M, N] = epilogue(A'[M, K] @ Bw[K, N]), A' = A or bf16(LayerNorm(A)),
// on the tensor cores with wgmma. A CTA owns 128 rows and walks
// `tiles_per_cta` output tiles of 64 NSLAB columns. One producer warp feeds
// a ring of WG_STAGES weight tiles [64 K x 64 NSLAB N] by TMA (128-byte
// swizzle, zero fill past the edges); two consumer warpgroups each run
// m64n64k16 wgmma on 64 of the rows.
//   RESIDENT (K <= WG_PANEL_MAX_K): the CTA's A panel [128 x K] is loaded
//   once and serves every N tile. With LN each row's statistics are taken
//   once from the panel and bf16(LN(A)) written back in place, the rounding
//   of the Pallas body's xln.
//   Otherwise A tiles [128 x 64] stream through the ring beside B.
// The epilogue runs on the accumulators in registers: a shuffle within each
// quad of lanes gives every lane 8 consecutive columns of one row, so bias,
// residual and output move 16 bytes per thread. `res` may alias `out`.
constexpr int WG_BM = 128, WG_BK = 64, WG_STAGES = 4, WG_PANEL_MAX_K = 512;
constexpr int WG_CONSUMERS = 256, WG_THREADS = WG_CONSUMERS + 32;
constexpr int WG_A_TILE = WG_BM * WG_BK * 2;  // bytes of a [128 x 64] A tile
constexpr int WG_B_SLAB = WG_BK * 64 * 2;     // bytes of a [64 K x 64 N] B slab
constexpr int WG_SLACK = 1024 + 256;          // 1024-byte atom alignment + barriers
constexpr int SMEM_LIMIT = 232448;            // dynamic shared memory per CTA (sm_90)

constexpr int wg_smem_bytes(int K, int bn, bool resident) {
  return (resident ? (K + WG_BK - 1) / WG_BK : WG_STAGES) * WG_A_TILE +
         WG_STAGES * (bn / 64) * WG_B_SLAB + WG_SLACK;
}

struct WgArgs {
  const bf16* ln_g;
  const bf16* ln_b;
  const bf16* bias;
  const bf16* res;
  bf16* out;
  int M, N, K, ldr, ldo, tiles_per_cta;
};

// Byte offset of 16-byte chunk `ch` (columns 8 ch .. 8 ch + 7) of row r of a
// panel of [128 x 64] swizzled tiles.
__device__ __forceinline__ int panel_chunk(int r, int ch) {
  return (ch >> 3) * WG_A_TILE + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// bf16(LayerNorm(row r)) in place in the panel; one warp per row, lane l
// holding chunks l and l + 32 (K > 128).
__device__ __forceinline__ void ln_panel_row(unsigned char* panel, int r, int K, const bf16* g,
                                             const bf16* b, int lane) {
  constexpr int CH = WG_PANEL_MAX_K / 8 / 32;  // 16-byte chunks per lane
  uint4 v[CH];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int ch = lane + 32 * i;
    v[i] = make_uint4(0, 0, 0, 0);
    if (ch * 8 < K) v[i] = *reinterpret_cast<const uint4*>(panel + panel_chunk(r, ch));
    const bf16* e = lanes8(v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += bf2f(e[j]);
  }
  const float mean = warp_sum(s) / K;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if ((lane + 32 * i) * 8 >= K) continue;
    const bf16* e = lanes8(v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += (bf2f(e[j]) - mean) * (bf2f(e[j]) - mean);
  }
  const float rstd = rsqrtf(warp_sum(ss) / K + LN_EPS);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int ch = lane + 32 * i;
    if (ch * 8 >= K) continue;
    uint4 gv = load8(g + ch * 8), bv = load8(b + ch * 8);
    bf16 *e = lanes8(v[i]), *ge = lanes8(gv), *be = lanes8(bv);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = f2bf((bf2f(e[j]) - mean) * rstd * bf2f(ge[j]) + bf2f(be[j]));
    *reinterpret_cast<uint4*>(panel + panel_chunk(r, ch)) = v[i];
  }
}

// The same for K <= 128 with every lane busy: a row is held by a group of
// L lanes (one 16-byte chunk each), so a warp takes 32 / L rows at a time.
template <int L>
__device__ __forceinline__ void ln_panel_rows_grouped(unsigned char* panel, int row0, int K,
                                                      const bf16* g, const bf16* b, int lane) {
  constexpr int PER = 32 / L;
  const int ch = lane % L;
  const bool in = ch * 8 < K;
#pragma unroll
  for (int it = 0; it < 16 / PER; ++it) {
    const int r = row0 + it * PER + lane / L;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (in) v = *reinterpret_cast<const uint4*>(panel + panel_chunk(r, ch));
    bf16* e = lanes8(v);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += bf2f(e[j]);
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
    const float mean = s / K;
    float ss = 0.f;
    if (in) {
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += (bf2f(e[j]) - mean) * (bf2f(e[j]) - mean);
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL_MASK, ss, o);
    const float rstd = rsqrtf(ss / K + LN_EPS);
    if (in) {
      uint4 gv = load8(g + ch * 8), bv = load8(b + ch * 8);
      bf16 *ge = lanes8(gv), *be = lanes8(bv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = f2bf((bf2f(e[j]) - mean) * rstd * bf2f(ge[j]) + bf2f(be[j]));
      *reinterpret_cast<uint4*>(panel + panel_chunk(r, ch)) = v;
    }
  }
}

// bf16(LayerNorm) in place for panel rows row0 .. row0 + 15, by one warp.
// The two forms give the same bits; on an H100 the grouped one is the faster
// at K <= 128 and the one-row form at K = 320 and 512 (PERF.md, Findings).
__device__ __forceinline__ void ln_panel_rows(unsigned char* panel, int row0, int K,
                                              const bf16* g, const bf16* b, int lane) {
  const int nch = K / 8;
  if (nch > 16) {
    for (int i = 0; i < 16; ++i) ln_panel_row(panel, row0 + i, K, g, b, lane);
  } else if (nch > 8) {
    ln_panel_rows_grouped<16>(panel, row0, K, g, b, lane);
  } else if (nch > 4) {
    ln_panel_rows_grouped<8>(panel, row0, K, g, b, lane);
  } else if (nch > 2) {
    ln_panel_rows_grouped<4>(panel, row0, K, g, b, lane);
  } else {
    ln_panel_rows_grouped<2>(panel, row0, K, g, b, lane);
  }
}

template <typename T>
__device__ __forceinline__ T pick4(const T (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// The epilogue of one 64-column slab of a consumer warpgroup's accumulators:
// rows row_lo and row_lo + 8 of this lane (those below row_end), columns
// n_base + 8 jb + 2 t (those below n_end): out = bf16([res +] [gelu](v +
// bias)).
template <Epi EPI>
__device__ __forceinline__ void store_slab(const float (&d)[32], const bf16* bias, const bf16* res,
                                           int ldr, bf16* out, int ldo, int row_lo, int row_end,
                                           int n_base, int n_end, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
#pragma unroll
    for (int G = 0; G < 2; ++G) {
      float2 it[4], recv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        it[i] = make_float2(d[(4 * G + i) * 4 + 2 * half], d[(4 * G + i) * 4 + 2 * half + 1]);
      recv[0] = pick4(it, t);
#pragma unroll
      for (int r = 1; r < 4; ++r) {  // lane t ^ r wants its column block 4 G + (t ^ r)
        const float2 snd = pick4(it, t ^ r);
        recv[r].x = __shfl_xor_sync(FULL_MASK, snd.x, r);
        recv[r].y = __shfl_xor_sync(FULL_MASK, snd.y, r);
      }
      const int col = n_base + 8 * (4 * G + t);
      if (row >= row_end || col >= n_end) continue;
      float v[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // columns 2k, 2k+1 came from lane k
        const float2 p = pick4(recv, k ^ t);
        v[2 * k] = p.x, v[2 * k + 1] = p.y;
      }
      uint4 bv = load8(bias + col), rv = make_uint4(0, 0, 0, 0), ov;
      if constexpr (EPI == Epi::kBiasRes) rv = load8(res + (size_t)row * ldr + col);
      bf16 *be = lanes8(bv), *re = lanes8(rv), *oe = lanes8(ov);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = v[i] + bf2f(be[i]);
        if constexpr (EPI == Epi::kBiasGelu) x = gelu_tanh(x);
        if constexpr (EPI == Epi::kBiasRes) x = bf2f(re[i]) + x;
        oe[i] = f2bf(x);
      }
      store8(out + (size_t)row * ldo + col, ov);
    }
  }
}

template <bool LN, Epi EPI, int NSLAB, bool RESIDENT>
__global__ void __launch_bounds__(WG_THREADS, 2)
    wgmma_linear(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                 const WgArgs a) {
  static_assert(!LN || RESIDENT, "the LayerNorm prologue works on a resident panel");
  extern __shared__ unsigned char wg_smem_raw[];
  const uint32_t raw = smem_addr(wg_smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* panel = wg_smem_raw + (base - raw);
  constexpr uint32_t B_STAGE = NSLAB * WG_B_SLAB;
  const int ktiles = (a.K + WG_BK - 1) / WG_BK;
  const uint32_t sA = base;
  constexpr int S = WG_STAGES;
  const uint32_t sB = sA + (RESIDENT ? ktiles : S) * WG_A_TILE;
  const uint32_t bars = sB + S * B_STAGE;  // full[S], empty[S], panel
  const uint32_t a_full = bars + 16 * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * WG_BM;
  const int ntiles = (a.N + 64 * NSLAB - 1) / (64 * NSLAB);
  const int nt0 = blockIdx.y * a.tiles_per_cta;
  const int nt1 = min(nt0 + a.tiles_per_cta, ntiles);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), WG_CONSUMERS / 32);
    }
    mbar_init(a_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS / 32) {  // producer warp: one thread issues every load
    if (lane == 0) {
      if constexpr (RESIDENT) {
        mbar_expect_tx(a_full, ktiles * WG_A_TILE);
        for (int kt = 0; kt < ktiles; ++kt)
          tma_load_2d(sA + kt * WG_A_TILE, &tma, kt * WG_BK, m0, a_full);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int nt = nt0; nt < nt1; ++nt) {
        for (int kt = 0; kt < ktiles; ++kt) {
          const uint32_t full = bars + 8 * s;
          mbar_wait(bars + 8 * (S + s), ph ^ 1);
          mbar_expect_tx(full, B_STAGE + (RESIDENT ? 0 : WG_A_TILE));
          if constexpr (!RESIDENT) tma_load_2d(sA + s * WG_A_TILE, &tma, kt * WG_BK, m0, full);
#pragma unroll
          for (int j = 0; j < NSLAB; ++j)
            tma_load_2d(sB + s * B_STAGE + j * WG_B_SLAB, &tmb, (nt * NSLAB + j) * 64,
                        kt * WG_BK, full);
          if (++s == S) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // consumer warpgroup: rows 64 wg .. 64 wg + 63
  if constexpr (RESIDENT) {
    mbar_wait(a_full, 0);
    if constexpr (LN) {
      ln_panel_rows(panel, 64 * wg + 16 * (warp & 3), a.K, a.ln_g, a.ln_b, lane);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
    }
  }
  const int row_lo = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int nt = nt0; nt < nt1; ++nt) {
    float acc[NSLAB][32];
#pragma unroll
    for (int j = 0; j < NSLAB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    // one k-step's wgmma group stays in flight while the next is issued;
    // a ring stage is released once the group that read it has completed
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(bars + 8 * s, ph);
      const uint32_t a_rows =
          (RESIDENT ? sA + kt * WG_A_TILE : sA + s * WG_A_TILE) + wg * (64 * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t da = smem_desc_sw128(a_rows + kk * 32);
#pragma unroll
        for (int j = 0; j < NSLAB; ++j)
          wgmma_m64n64k16(acc[j], da,
                          smem_desc_sw128(sB + s * B_STAGE + j * WG_B_SLAB + kk * 16 * 128));
      }
      wgmma_commit();
      wgmma_wait1();
      if (kt > 0 && lane == 0) mbar_arrive(bars + 8 * (S + prev));
      prev = s;
      if (++s == S) s = 0, ph ^= 1;
    }
    wgmma_wait0();
    if (lane == 0) mbar_arrive(bars + 8 * (S + prev));
#pragma unroll
    for (int j = 0; j < NSLAB; ++j)
      store_slab<EPI>(acc[j], a.bias, a.res, a.ldr, a.out, a.ldo, row_lo, a.M,
                      (nt * NSLAB + j) * 64, a.N, lane & 3);
  }
}

template <bool LN, Epi EPI, int NSLAB, bool RESIDENT>
int wg_launch(cudaStream_t s, dim3 grid, int smem, const CUtensorMap& ta, const CUtensorMap& tb,
              const WgArgs& a) {
  auto kern = wgmma_linear<LN, EPI, NSLAB, RESIDENT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<grid, WG_THREADS, smem, s>>>(ta, tb, a);
  return (int)cudaGetLastError();
}

// One serving product with its launch plan from the Python wrapper
// (kernels/mit_block.py::gemm_plan): plan = [bn, resident, tiles_per_cta,
// grid_x, grid_y, smem_bytes]. A plan that does not fit the shapes is
// refused with cudaErrorInvalidValue; so is a tensor map that cannot be
// made.
template <bool LN, Epi EPI>
int wg_linear(cudaStream_t s, const int* plan, const bf16* A, const bf16* Bw, const bf16* bias,
              const bf16* ln_g, const bf16* ln_b, const bf16* res, int ldr, bf16* out, int ldo,
              int M, int N, int K) {
  const int bn = plan[0], tpc = plan[2], smem = plan[5];
  const bool resident = plan[1] != 0;
  const int ntiles = bn > 0 ? (N + bn - 1) / bn : 0;
  const int bad = (int)cudaErrorInvalidValue;
  if ((bn != 64 && bn != 128) || tpc < 1 || (resident && K > WG_PANEL_MAX_K) || (LN && !resident) ||
      plan[3] != (M + WG_BM - 1) / WG_BM || plan[4] != (ntiles + tpc - 1) / tpc ||
      smem != wg_smem_bytes(K, bn, resident) || smem > SMEM_LIMIT || K % 8 || N % 8)
    return bad;
  CUtensorMap ta, tb;
  if (!make_tensor_map(&ta, A, M, K, WG_BM, WG_BK) || !make_tensor_map(&tb, Bw, K, N, WG_BK, 64))
    return bad;
  WgArgs a{ln_g, ln_b, bias, res, out, M, N, K, ldr, ldo, tpc};
  const dim3 grid(plan[3], plan[4]);
  if constexpr (LN) {
    return bn == 64 ? wg_launch<true, EPI, 1, true>(s, grid, smem, ta, tb, a)
                    : wg_launch<true, EPI, 2, true>(s, grid, smem, ta, tb, a);
  } else {
    if (resident)
      return bn == 64 ? wg_launch<false, EPI, 1, true>(s, grid, smem, ta, tb, a)
                      : wg_launch<false, EPI, 2, true>(s, grid, smem, ta, tb, a);
    return bn == 64 ? wg_launch<false, EPI, 1, false>(s, grid, smem, ta, tb, a)
                    : wg_launch<false, EPI, 2, false>(s, grid, smem, ta, tb, a);
  }
}

// ---------------------------------------------- attention_tc_kernel ----
// Softmax attention of one (image, head) per blockIdx.y over its Nkv <= 64
// keys, on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate).
// K_h and V_h are staged once per CTA in shared memory as bf16, zero-padded
// to MAX_KV keys; the CTA then walks `tiles_per_cta` query tiles of 64 rows,
// 16 rows per warp: S = q_h K_h^T in registers, the fp32 softmax with keys
// past Nkv masked, P rounded to bf16 (mit_block.py:163) and fed from the
// same registers as the A operand of ctx = P V_h, ctx rounded to bf16.
constexpr int TC_THREADS = 128, TC_ROWS = 64, TC_LD = HD + 8;  // padded rows: no bank conflicts

__global__ void __launch_bounds__(TC_THREADS)
    attention_tc_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, int ldkv, bf16* __restrict__ ctx, int ldc,
                        int N, int Nkv, int heads, int tiles_per_cta, float scale) {
  __shared__ __align__(16) bf16 Ks[MAX_KV][TC_LD];
  __shared__ __align__(16) bf16 Vs[MAX_KV][TC_LD];
  __shared__ __align__(16) bf16 Qs[TC_THREADS / 32][16][TC_LD];  // q rows, then ctx rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const uint4 zero8 = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < MAX_KV * HD / 8; idx += TC_THREADS) {
    const int j = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
    const size_t off = ((size_t)b * Nkv + j) * ldkv + h * HD + d;
    store8(&Ks[j][d], j < Nkv ? load8(k + off) : zero8);
    store8(&Vs[j][d], j < Nkv ? load8(v + off) : zero8);
  }
  __syncthreads();

  const int qtiles = (N + TC_ROWS - 1) / TC_ROWS;
  const int t0 = blockIdx.x * tiles_per_cta, t1 = min(t0 + tiles_per_cta, qtiles);
  bf16(*Qw)[TC_LD] = Qs[warp];
  for (int tile = t0; tile < t1; ++tile) {
    const int r0 = tile * TC_ROWS + warp * 16;
    for (int c = lane; c < 16 * HD / 8; c += 32) {
      const int rr = c / (HD / 8), d = (c % (HD / 8)) * 8, row = r0 + rr;
      store8(&Qw[rr][d], row < N ? load8(q + ((size_t)b * N + row) * ldq + h * HD + d) : zero8);
    }
    __syncwarp();
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(qa[kk], smem_addr(&Qw[lane & 15][16 * kk + (lane >> 4) * 8]));

    float sc[MAX_KV / 8][4];
#pragma unroll
    for (int nb = 0; nb < MAX_KV / 8; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int nb2 = 0; nb2 < MAX_KV / 16; ++nb2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_addr(&Ks[16 * nb2 + (lane & 7) + ((lane >> 4) << 3)]
                                    [16 * kk + ((lane >> 3) & 1) * 8]));
        mma_m16n8k16(sc[2 * nb2], qa[kk], kb[0], kb[1]);
        mma_m16n8k16(sc[2 * nb2 + 1], qa[kk], kb[2], kb[3]);
      }

    // softmax of rows g (elements 0, 1) and g + 8 (elements 2, 3); the four
    // lanes of a quad hold one row between them
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < MAX_KV / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nb * 8 + 2 * t + (e & 1);
        sc[nb][e] = key < Nkv ? sc[nb][e] * scale : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nb][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
    }
#pragma unroll
    for (int nb = 0; nb < MAX_KV / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = nb * 8 + 2 * t + (e & 1);
        sc[nb][e] = key < Nkv ? expf(sc[nb][e] - mx[e >> 1]) : 0.f;
        sum[e >> 1] += sc[nb][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(FULL_MASK, sum[i], 1);
      sum[i] += __shfl_xor_sync(FULL_MASK, sum[i], 2);
    }
    uint32_t pa[MAX_KV / 16][4];  // bf16(P) as the A operand of P V, key block kk
#pragma unroll
    for (int kk = 0; kk < MAX_KV / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(sc[2 * kk][0] / sum[0], sc[2 * kk][1] / sum[0]);
      pa[kk][1] = pack_bf16x2(sc[2 * kk][2] / sum[1], sc[2 * kk][3] / sum[1]);
      pa[kk][2] = pack_bf16x2(sc[2 * kk + 1][0] / sum[0], sc[2 * kk + 1][1] / sum[0]);
      pa[kk][3] = pack_bf16x2(sc[2 * kk + 1][2] / sum[1], sc[2 * kk + 1][3] / sum[1]);
    }

    float o[HD / 8][4];
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAX_KV / 16; ++kk)
#pragma unroll
      for (int nb2 = 0; nb2 < HD / 16; ++nb2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_addr(&Vs[16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)]
                                          [16 * nb2 + ((lane >> 4) << 3)]));
        mma_m16n8k16(o[2 * nb2], pa[kk], vb[0], vb[1]);
        mma_m16n8k16(o[2 * nb2 + 1], pa[kk], vb[2], vb[3]);
      }

    __syncwarp();  // every lane's q fragments are loaded: the buffer takes ctx
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(&Qw[g][nb * 8 + 2 * t]) = pack_bf16x2(o[nb][0], o[nb][1]);
      *reinterpret_cast<uint32_t*>(&Qw[g + 8][nb * 8 + 2 * t]) = pack_bf16x2(o[nb][2], o[nb][3]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * HD / 8; c += 32) {
      const int rr = c / (HD / 8), d = (c % (HD / 8)) * 8, row = r0 + rr;
      if (row < N) store8(ctx + ((size_t)b * N + row) * ldc + h * HD + d, load8(&Qw[rr][d]));
    }
    __syncwarp();
  }
}

// plan = [tiles_per_cta, grid_x, grid_y] (kernels/mit_block.py::attention_plan)
int attention_tc(cudaStream_t s, const int* plan, const bf16* q, const bf16* k, const bf16* v,
                 int ldkv, bf16* ctx, int B, int N, int Nkv, int C, int heads) {
  const int tpc = plan[0], qtiles = (N + TC_ROWS - 1) / TC_ROWS;
  if (tpc < 1 || Nkv > MAX_KV || plan[1] != (qtiles + tpc - 1) / tpc || plan[2] != B * heads)
    return (int)cudaErrorInvalidValue;
  attention_tc_kernel<<<dim3(plan[1], plan[2]), TC_THREADS, 0, s>>>(
      q, C, k, v, ldkv, ctx, C, N, Nkv, heads, tpc, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

#define TRY(call)                  \
  do {                             \
    const int err_ = (call);       \
    if (err_ != 0) return err_;    \
  } while (0)

constexpr int GEMM_PLAN = 6, ATTN_PLAN = 3;

// x1 = x + (ctx @ wo + bo) into x1buf; y = x1 + fc2(gelu(dwconv(fc1(LN2(x1)))))
// through hid and act. plan: the out, fc1 and fc2 product plans. y may alias
// x (the stage's in-place residual stream), not x1buf.
int serve_out_and_mlp(cudaStream_t s, const int* plan, const bf16* x, const bf16* ctx,
                      const bf16* wo, const bf16* bo, const bf16* ln2_g, const bf16* ln2_b,
                      const bf16* w1, const bf16* b1, const bf16* wdw, const bf16* bdw,
                      const bf16* w2, const bf16* b2, bf16* x1buf, bf16* hid, bf16* act, bf16* y,
                      int B, int H, int W, int C, int hidden) {
  const int M = B * H * W;
  TRY((wg_linear<false, Epi::kBiasRes>(s, plan, ctx, wo, bo, nullptr, nullptr, x, C, x1buf, C, M,
                                       C, C)));
  TRY((wg_linear<true, Epi::kBias>(s, plan + GEMM_PLAN, x1buf, w1, b1, ln2_g, ln2_b, nullptr, 0,
                                   hid, hidden, M, hidden, C)));
  dwconv3x3_kernel<true><<<grid_for((size_t)M * hidden / 8, 256), 256, 0, s>>>(
      hid, wdw, bdw, act, B, H, W, hidden);
  TRY((wg_linear<false, Epi::kBiasRes>(s, plan + 2 * GEMM_PLAN, act, w2, b2, nullptr, nullptr,
                                       x1buf, C, y, C, M, C, hidden)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One MiT block, LN1 in the q product's prologue; k, v: [B, Nkv, C]
// precomputed from the spatial-reduction path. Weights in the JAX layout
// ([in, out]), all bf16; wdw [9, hidden] in dy-major tap order. `plan` (host
// memory, from kernels/mit_block.py::block_plan) holds the launch plans of
// the q product, the attention, the out product, fc1 and fc2. Scratch: q
// [B*N, C] (q, then x1), ctx [B*N, C], hid, act [B*N, hidden]. y must not
// alias x.
int mit_block_forward(const void* x, const void* k, const void* v, const void* ln1_g,
                      const void* ln1_b, const void* wq, const void* bq, const void* wo,
                      const void* bo, const void* ln2_g, const void* ln2_b, const void* w1,
                      const void* b1, const void* wdw, const void* bdw, const void* w2,
                      const void* b2, const void* plan, void* q, void* ctx, void* hid, void* act,
                      void* y, int B, int H, int W, int C, int heads, int Nkv, int hidden,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * H * W;
  const int* pl = (const int*)plan;
  typedef const bf16* P;
  TRY((wg_linear<true, Epi::kBias>(s, pl, (P)x, (P)wq, (P)bq, (P)ln1_g, (P)ln1_b, nullptr, 0,
                                   (bf16*)q, C, M, C, C)));
  TRY(attention_tc(s, pl + GEMM_PLAN, (P)q, (P)k, (P)v, C, (bf16*)ctx, B, H * W, Nkv, C, heads));
  return serve_out_and_mlp(s, pl + GEMM_PLAN + ATTN_PLAN, (P)x, (P)ctx, (P)wo, (P)bo, (P)ln2_g,
                           (P)ln2_b, (P)w1, (P)b1, (P)wdw, (P)bdw, (P)w2, (P)b2, (bf16*)q,
                           (bf16*)hid, (bf16*)act, (bf16*)y, B, H, W, C, hidden);
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
// the stage output. `plan` (host memory, kernels/mit_block.py::stage_plan)
// holds the launch plans of the prompt products (lww, sharedw), the SR
// product, kv, q, the attention, out, fc1 and fc2. Scratch: xln, q (q,
// then x1), ctx [B*N, C]; feat [B*N, C4]; patches [B*Nkv, sr*sr*C]; red,
// kvin [B*Nkv, C]; kv [B*Nkv, 2C]; hid, act [B*N, hidden].
int mit_stage_forward(const void* x, const void* base, const void* sharedw, const void* sharedb,
                      const void* lww, const void* lwb, const void* srw, const void* srb,
                      const void* lnkv, const void* ln1, const void* wkv, const void* bkv,
                      const void* wq, const void* bq, const void* wo, const void* bo,
                      const void* ln2, const void* w1, const void* b1, const void* wdw,
                      const void* bdw, const void* w2, const void* b2, const void* plan, void* y,
                      void* xln, void* feat, void* patches, void* red, void* kvin, void* kv,
                      void* q, void* ctx, void* hid, void* act, int B, int H, int W, int C,
                      int heads, int sr, int depth, int Cb, int C4, int hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  const int N = H * W, M = B * N;
  const int Nkv = (H / sr) * (W / sr), Mkv = B * Nkv;
  const int* pl = (const int*)plan;
  const int *p_lw = pl, *p_shared = pl + GEMM_PLAN, *p_sr = pl + 2 * GEMM_PLAN;
  const int *p_kv = pl + 3 * GEMM_PLAN, *p_q = pl + 4 * GEMM_PLAN, *p_attn = pl + 5 * GEMM_PLAN;
  const int* p_mlp = p_attn + ATTN_PLAN;
  bf16* Y = (bf16*)y;
  TRY((int)cudaMemcpyAsync(y, x, (size_t)M * C * sizeof(bf16), cudaMemcpyDeviceToDevice, s));
  for (int d = 0; d < depth; ++d) {
    if (base != nullptr) {
      TRY((wg_linear<false, Epi::kBiasGelu>(s, p_lw, (P)base, (P)lww + (size_t)d * Cb * C4,
                                            (P)lwb + (size_t)d * C4, nullptr, nullptr, nullptr, 0,
                                            (bf16*)feat, C4, M, C4, Cb)));
      TRY((wg_linear<false, Epi::kBiasRes>(s, p_shared, (P)feat, (P)sharedw, (P)sharedb, nullptr,
                                           nullptr, Y, C, Y, C, M, C, C4)));
    }
    const bf16* l1 = (P)ln1 + (size_t)d * 2 * C;
    layernorm_kernel<<<(M + 3) / 4, 128, 0, s>>>(Y, l1, l1 + C, (bf16*)xln, M, C);
    const bf16* kv_in = (P)xln;
    if (sr > 1) {
      sr_patches_kernel<<<grid_for((size_t)Mkv * sr * sr * C / 8, 256), 256, 0, s>>>(
          (P)xln, (bf16*)patches, B, H, W, C, sr);
      TRY((wg_linear<false, Epi::kBias>(s, p_sr, (P)patches, (P)srw + (size_t)d * sr * sr * C * C,
                                        (P)srb + (size_t)d * C, nullptr, nullptr, nullptr, 0,
                                        (bf16*)red, C, Mkv, C, sr * sr * C)));
      const bf16* lk = (P)lnkv + (size_t)d * 2 * C;
      layernorm_kernel<<<(Mkv + 3) / 4, 128, 0, s>>>((P)red, lk, lk + C, (bf16*)kvin, Mkv, C);
      kv_in = (P)kvin;
    }
    TRY((wg_linear<false, Epi::kBias>(s, p_kv, kv_in, (P)wkv + (size_t)d * C * 2 * C,
                                      (P)bkv + (size_t)d * 2 * C, nullptr, nullptr, nullptr, 0,
                                      (bf16*)kv, 2 * C, Mkv, 2 * C, C)));
    TRY((wg_linear<false, Epi::kBias>(s, p_q, (P)xln, (P)wq + (size_t)d * C * C,
                                      (P)bq + (size_t)d * C, nullptr, nullptr, nullptr, 0,
                                      (bf16*)q, C, M, C, C)));
    TRY(attention_tc(s, p_attn, (P)q, (P)kv, (P)kv + C, 2 * C, (bf16*)ctx, B, N, Nkv, C, heads));
    const bf16* l2 = (P)ln2 + (size_t)d * 2 * C;
    TRY(serve_out_and_mlp(s, p_mlp, Y, (P)ctx, (P)wo + (size_t)d * C * C, (P)bo + (size_t)d * C,
                          l2, l2 + C, (P)w1 + (size_t)d * C * hidden, (P)b1 + (size_t)d * hidden,
                          (P)wdw + (size_t)d * 9 * hidden, (P)bdw + (size_t)d * hidden,
                          (P)w2 + (size_t)d * hidden * C, (P)b2 + (size_t)d * C, (bf16*)q,
                          (bf16*)hid, (bf16*)act, Y, B, H, W, C, hidden));
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
