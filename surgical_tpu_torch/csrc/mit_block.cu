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
// saved inputs, as the Pallas kernels do, and read the forward weights
// transposed for the input gradients. The TPU's hidden-chunk grid of the
// MLP backward has no counterpart: each product here runs over the whole
// hidden width, with the recomputed [B*N, hidden] intermediates in
// device-memory scratch.
//
// What bounds it on the H100: at stages 1-2 the block GEMMs have K = 64-512
// and move the [B*N, C] activation (and the 4x wider MLP hidden) through
// device memory for a few hundred FLOPs per byte at most, so they are bound
// by bytes, not by the tensor cores; stage 3-4 GEMMs are closer to the
// ridge. The attention over the spatially-reduced keys (49 per head at 224
// px, 64 at 256, 81 to 256 from 288 to 512 px) is small work that the TPU
// spread over MXU dots; here every forward and the training attention
// backward run it on the tensor cores (mma.sync), with the keys of a head
// staged at once up to 64 of them and streamed in tiles of 64 past that.
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
// Every entry point runs on Hopper's own paths (see "wgmma kernels"
// below): wgmma_linear, wgmma products fed by a TMA ring with the A panel
// resident in shared memory (LayerNorm'd, per-half LayerNorm'd or
// row-scaled in place there, and for the backward the weights read K-major
// as their transposes); attention_tc_kernel, the attention on the tensor
// cores with K and V staged once per CTA (attention_tc_tiled_kernel past 64
// keys per head, the keys streamed); and attention_bwd_tc_kernel, the
// training attention backward on the same mma.sync fragments (past 64 keys
// after attention_bwd_dq_kernel, which computes dq and the row statistics).
// Their launch plans come from the Python wrapper.
// The MLP tail fused on chip (the Pallas body's mlp_chunk
// form, hid and act kept out of device memory) was built and measured
// slower than this chain at every b3 stage (PERF.md, Findings), so it is not
// here.
//
// Rounding mirrors the Pallas bodies so that the bf16 results agree: every
// product accumulates in fp32; q, kv, the attention probabilities, ctx, the
// post-attention residual, fc1's output, the dwconv output and the GELU
// output are rounded to bf16 where the Pallas body rounds them.

#include <math_constants.h>

#include <algorithm>
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int LN_MAX_K = 512;  // a LayerNorm row is held in registers
// Keys per tile of the attention kernels: up to MAX_KV keys per head an
// (image, head) stages its keys once (the one-tile instances); more keys
// stream through shared memory in tiles of MAX_KV (the tiled instances).
constexpr int MAX_KV = 64;
// The attention kernels, forward and backward, take the head width as a
// template parameter, built at the two widths of the published MiT sizes:
// 32 (b0) and 64 (b1-b5). packed2's images are 64 channels wide (one head).
constexpr int PACK_C = 64;

// A prologue on the A operand of wgmma_linear's resident panel: none,
// LayerNorm, the row scale bf16(A * rowscale[row / mrows]), or LayerNorm
// per K/2-wide half (the lane-packed rows of packed2).
enum class Pro { kPlain, kLN, kRowScale, kGroupLN };
enum class Epi { kBias, kBiasGelu, kBiasRes, kBiasResScale, kGeluGrad, kPlain, kF32 };

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

// ------------------------------------------------------- glue LayerNorm ----
// The LayerNorms of the graph glue between the kernels of this file
// (models/_ops.py::layernorm on the card: each block's LN1 and SR LayerNorm
// ahead of mit_block_forward, the patch embeds', the stage norms, the
// cross-attentions'). It replaces no TPU kernel: the JAX package leaves this
// LayerNorm to XLA, which fuses it. In plain PyTorch it is ten full-size
// kernels (casts, two reduces, five broadcast binaries, a square), ~68 bytes
// of traffic per element; one pass needs 4 (a bf16 read and a bf16 write),
// so the kernel is bound by memory, and its design is about moving those 4
// bytes at full width:
// - a row is spread over a group of L lanes (C/8 rounded up to a power of
//   two, at most a warp), each holding V 16-byte vectors of 8 bf16 in
//   registers: 4 lanes at C = 32, 8 at 64, 16 at 128, 32 from 160 (V = 2
//   from 320; vectors past C masked). Every load and store is 16 bytes, and
//   a warp holds 32 / L short rows at once, where layernorm_kernel walks one
//   row with 2-byte lane-strided loads;
// - the mean, then the centred variance, are summed over the registers and
//   across the group by shuffles (the plain path's ((x - m)^2).mean()), with
//   LN_EPS; the output is bf16(((x - m) * rstd) * g + b) with the fp32
//   affine, in the plain path's order of operations, rounded once;
// - CTAs are persistent and stride over rows: a thread keeps the same
//   columns for its whole life, so its fp32 scale and bias are loaded once
//   and stay in registers (the launch bounds keep 6 CTAs of 256 per SM at
//   one vector per lane, 4 at two, without spills);
// - no atomics and no split reductions: the same input gives the same bits.
// x: [M, C] rows of stride ld elements; y: [M, C] contiguous.
constexpr int LNR_THREADS = 256;

template <int L, int V>
__global__ void __launch_bounds__(LNR_THREADS, V == 1 ? 6 : 4)
    glue_layernorm_rows(const bf16* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ b, bf16* __restrict__ y, int M, int C,
                        int ld) {
  constexpr int ROWS = LNR_THREADS / L;  // rows of a CTA per pass
  const int lane = threadIdx.x % L, sub = threadIdx.x / L;
  float gs[V][8], bs[V][8];
  bool in[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = (lane + L * v) * 8;
    in[v] = c < C;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      gs[v][j] = in[v] ? g[c + j] : 0.f;
      bs[v][j] = in[v] ? b[c + j] : 0.f;
    }
  }
  // every thread of the CTA makes the same passes, so the shuffles below
  // see whole groups; a row past M loads zeros and stores nothing
  for (int64_t base = (int64_t)blockIdx.x * ROWS; base < M; base += (int64_t)gridDim.x * ROWS) {
    const int64_t row = base + sub;
    const bool ok = row < M;
    uint4 raw[V];
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      raw[v] = make_uint4(0, 0, 0, 0);
      if (ok && in[v]) raw[v] = load8(x + row * ld + (lane + L * v) * 8);
      const bf16* e = lanes8(raw[v]);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += bf2f(e[j]);
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
    const float mean = s / C;
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!in[v]) continue;
      const bf16* e = lanes8(raw[v]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = bf2f(e[j]) - mean;
        ss += d * d;
      }
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL_MASK, ss, o);
    const float rstd = rsqrtf(ss / C + LN_EPS);
    if (!ok) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!in[v]) continue;
      bf16* e = lanes8(raw[v]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = f2bf(__fadd_rn(__fmul_rn(__fmul_rn(bf2f(e[j]) - mean, rstd), gs[v][j]), bs[v][j]));
      store8(y + row * C + (lane + L * v) * 8, raw[v]);
    }
  }
}

// One launch on as many persistent CTAs as stay resident on every SM (read
// once per instance from the occupancy API, so the grid follows the launch
// bounds), or fewer where the rows fill fewer.
template <int L, int V>
int glue_layernorm_launch(cudaStream_t s, const bf16* x, const float* g, const float* b,
                          bf16* y, int M, int C, int ld) {
  static int per_sm = 0;
  if (!per_sm) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, glue_layernorm_rows<L, V>, LNR_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  constexpr int ROWS = LNR_THREADS / L;
  const int grid = (int)std::min<int64_t>(((int64_t)M + ROWS - 1) / ROWS, (int64_t)sms * per_sm);
  glue_layernorm_rows<L, V><<<grid, LNR_THREADS, 0, s>>>(x, g, b, y, M, C, ld);
  return (int)cudaGetLastError();
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
int grid_for(size_t work, int threads) {
  const size_t blocks = (work + threads - 1) / threads;
  return (int)(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

// ======================================================= wgmma kernels ====
// The products and the attention of mit_block_forward, packed2,
// mit_stage_forward (the serving path) and the three training entry
// points, redesigned for Hopper. All keep dwconv3x3_kernel.

// ---------------------------------------------------- wgmma_linear ----
// out[M, N] = epilogue(A'[M, K] @ B[K, N]), A' = A, bf16(LayerNorm(A)), the
// same per K/2-wide half or bf16(A * rowscale[row / mrows]) (Pro), B = Bw [K, N] or, with BT, Bw^T for
// Bw stored [N, K], on the tensor cores
// with wgmma. A CTA owns 128 rows and walks `tiles_per_cta` output tiles of
// 64 NSLAB columns. One producer warp feeds a ring of WG_STAGES weight
// tiles of 64 K x 64 NSLAB N by TMA (128-byte swizzle, zero fill past the
// edges): MN-major slabs read with imm-trans-b, or with BT K-major boxes
// [64 N x 64 K] read as wgmma's other B layout, with the A tile's
// descriptor form; two consumer warpgroups each run m64n64k16 wgmma on 64
// of the rows.
//   RESIDENT (K <= WG_PANEL_MAX_K): the CTA's A panel [128 x K] is loaded
//   once and serves every N tile. With kLN each row's statistics are taken
//   once from the panel and bf16(LN(A)) written back in place, the rounding
//   of the Pallas body's xln (kGroupLN: per 64-lane half, packed2's rows,
//   with fp32 scale and bias); with kRowScale each row is scaled and rounded
//   in place, the rounding of the attention backward's dattn = bf16(dx1 m1).
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
  void* out;  // bf16, or fp32 for Epi::kF32
  int M, N, K, ldr, ldo, tiles_per_cta;
  const float* rowscale;  // Epi::kBiasResScale, Pro::kRowScale: one factor per mrows rows
  int mrows;
  const bf16* aux;  // Epi::kGeluGrad: the GELU input [M, N], leading dimension ldx
  int ldx;
  const float* lnf;  // Pro::kGroupLN: fp32 scale [K], then bias [K]; else ln_g, ln_b
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return bf2f(v); }

// bf16(LayerNorm of each K/2-wide half) in place for panel rows row0 ..
// row0 + 15, by one warp, with scale g [K] and bias b [K] (fp32 for packed2's
// LN1, bf16 for its LN2): the lane-packed rows of packed2
// (mit_block.py::_ln_packed2), K = 2 PACK_C = 128. A row is held by 16 lanes
// (one 16-byte chunk each), each half by 8 of them; values round to bf16
// where the Pallas body's xln does.
template <typename T>
__device__ __forceinline__ void gln_panel_rows(unsigned char* panel, int row0, const T* g,
                                               const T* b, int lane) {
  constexpr int K = 2 * PACK_C, L = K / 8, G = L / 2, PER = 32 / L;
  const int ch = lane % L;
#pragma unroll
  for (int it = 0; it < 16 / PER; ++it) {
    const int r = row0 + it * PER + lane / L;
    uint4* p = reinterpret_cast<uint4*>(panel + panel_chunk(r, ch));
    uint4 v = *p;
    bf16* e = lanes8(v);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += bf2f(e[j]);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
    const float mean = s / (K / 2);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += (bf2f(e[j]) - mean) * (bf2f(e[j]) - mean);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL_MASK, ss, o);
    const float rstd = rsqrtf(ss / (K / 2) + LN_EPS);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = f2bf((bf2f(e[j]) - mean) * rstd * to_f32(g[ch * 8 + j]) + to_f32(b[ch * 8 + j]));
    *p = v;
  }
}

// bf16(A * rowscale[row / mrows]) in place for panel rows row0 .. row0 +
// 15 (global rows m0 + r), by one warp; rows past M are TMA's zeros and stay.
__device__ __forceinline__ void scale_panel_rows(unsigned char* panel, int row0, int m0,
                                                 const WgArgs& a, int lane) {
  const int nch = a.K / 8;
  for (int i = lane; i < 16 * nch; i += 32) {
    const int r = row0 + i / nch, ch = i % nch;
    if (m0 + r >= a.M) continue;
    const float sc = a.rowscale[(m0 + r) / a.mrows];
    uint4* p = reinterpret_cast<uint4*>(panel + panel_chunk(r, ch));
    uint4 v = *p;
    bf16* e = lanes8(v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = f2bf(bf2f(e[j]) * sc);
    *p = v;
  }
}

template <typename T>
__device__ __forceinline__ T pick4(const T (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// The epilogue of one 64-column slab of a consumer warpgroup's accumulators:
// rows row_lo and row_lo + 8 of this lane (those below a.M), columns n_base +
// 8 jb + 2 t (those below a.N), with v the fp32 product:
//   kPlain                      bf16(v)
//   kBias, kBiasGelu, kBiasRes  bf16([res +] [gelu](v + bias))
//   kBiasResScale               bf16(res + rowscale[row / mrows] * (v + bias)),
//                               the scale on the fp32 branch before the
//                               residual rounding
//   kGeluGrad                   bf16(v * gelu_tanh'(aux))
//   kF32                        v in fp32
template <Epi EPI>
__device__ __forceinline__ void store_slab(const float (&d)[32], const WgArgs& a, int row_lo,
                                           int n_base, int t) {
  constexpr bool BIAS = EPI == Epi::kBias || EPI == Epi::kBiasGelu || EPI == Epi::kBiasRes ||
                        EPI == Epi::kBiasResScale;
  constexpr bool RES = EPI == Epi::kBiasRes || EPI == Epi::kBiasResScale;
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
      if (row >= a.M || col >= a.N) continue;
      float v[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // columns 2k, 2k+1 came from lane k
        const float2 p = pick4(recv, k ^ t);
        v[2 * k] = p.x, v[2 * k + 1] = p.y;
      }
      if constexpr (EPI == Epi::kF32) {
        float4* o =
            reinterpret_cast<float4*>(static_cast<float*>(a.out) + (size_t)row * a.ldo + col);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
        continue;
      }
      uint4 bv = make_uint4(0, 0, 0, 0), rv = bv, xv = bv, ov;
      if constexpr (BIAS) bv = load8(a.bias + col);
      if constexpr (RES) rv = load8(a.res + (size_t)row * a.ldr + col);
      if constexpr (EPI == Epi::kGeluGrad) xv = load8(a.aux + (size_t)row * a.ldx + col);
      float sc = 1.f;
      if constexpr (EPI == Epi::kBiasResScale) sc = a.rowscale[row / a.mrows];
      bf16 *be = lanes8(bv), *re = lanes8(rv), *xe = lanes8(xv), *oe = lanes8(ov);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = v[i];
        if constexpr (BIAS) x = x + bf2f(be[i]);
        if constexpr (EPI == Epi::kBiasGelu) x = gelu_tanh(x);
        if constexpr (EPI == Epi::kBiasResScale) x = __fmul_rn(sc, x);
        if constexpr (RES) x = bf2f(re[i]) + x;
        if constexpr (EPI == Epi::kGeluGrad) x = x * gelu_tanh_grad(bf2f(xe[i]));
        oe[i] = f2bf(x);
      }
      store8(static_cast<bf16*>(a.out) + (size_t)row * a.ldo + col, ov);
    }
  }
}

template <Pro PRO, Epi EPI, int NSLAB, bool RESIDENT, bool BT>
__global__ void __launch_bounds__(WG_THREADS, 2)
    wgmma_linear(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                 const WgArgs a) {
  static_assert(PRO == Pro::kPlain || RESIDENT, "a prologue works on a resident panel");
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
          for (int j = 0; j < NSLAB; ++j) {  // B box: [64 K x 64 N], or [64 N x 64 K] with BT
            const int n = (nt * NSLAB + j) * 64, k = kt * WG_BK;
            tma_load_2d(sB + s * B_STAGE + j * WG_B_SLAB, &tmb, BT ? k : n, BT ? n : k, full);
          }
          if (++s == S) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // consumer warpgroup: rows 64 wg .. 64 wg + 63
  if constexpr (RESIDENT) {
    mbar_wait(a_full, 0);
    if constexpr (PRO != Pro::kPlain) {
      if constexpr (PRO == Pro::kLN)
        ln_panel_rows(panel, 64 * wg + 16 * (warp & 3), a.K, a.ln_g, a.ln_b, lane);
      else if constexpr (PRO == Pro::kGroupLN) {
        if (a.lnf != nullptr)
          gln_panel_rows(panel, 64 * wg + 16 * (warp & 3), a.lnf, a.lnf + a.K, lane);
        else
          gln_panel_rows(panel, 64 * wg + 16 * (warp & 3), a.ln_g, a.ln_b, lane);
      }
      else
        scale_panel_rows(panel, 64 * wg + 16 * (warp & 3), m0, a, lane);
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
        for (int j = 0; j < NSLAB; ++j) {  // k-step kk: 16 K rows of 128 bytes, or with BT
          // the next 32 bytes of every N row (the A operand's stepping)
          const uint32_t b = sB + s * B_STAGE + j * WG_B_SLAB + kk * (BT ? 32 : 16 * 128);
          wgmma_m64n64k16<BT ? 0 : 1>(acc[j], da, smem_desc_sw128(b));
        }
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
      store_slab<EPI>(acc[j], a, row_lo, (nt * NSLAB + j) * 64, lane & 3);
  }
}

template <Pro PRO, Epi EPI, int NSLAB, bool RESIDENT, bool BT>
int wg_launch(cudaStream_t s, dim3 grid, int smem, const CUtensorMap& ta, const CUtensorMap& tb,
              const WgArgs& a) {
  auto kern = wgmma_linear<PRO, EPI, NSLAB, RESIDENT, BT>;
  static std::atomic<bool> attr_set[kMaxDevices];
  const cudaError_t attr = smem_limit_once(kern, SMEM_LIMIT, attr_set);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<grid, WG_THREADS, smem, s>>>(ta, tb, a);
  return (int)cudaGetLastError();
}

// One product out[M, N] = epilogue(A'[M, K] @ B[K, N]) with its launch plan
// from the Python wrapper (kernels/mit_block.py::gemm_plan): plan = [bn,
// resident, tiles_per_cta, grid_x, grid_y, smem_bytes]. B is Bw stored [K,
// N] (read MN-major), or with BT the transpose of Bw stored [N, K] (read
// K-major: a forward weight [in, out] read transposed for an input
// gradient). The trailing arguments serve the row-scale prologue, the
// scaled-residual and GELU-gradient epilogues and the per-half LayerNorm
// (at K = 128, its scale and bias fp32 in lnf or bf16 in ln_g, ln_b). A plan that does not fit the shapes is refused with
// cudaErrorInvalidValue; so is a tensor map that cannot be made.
template <Pro PRO, Epi EPI, bool BT = false>
int wg_linear(cudaStream_t s, const int* plan, const bf16* A, const bf16* Bw, const bf16* bias,
              const bf16* ln_g, const bf16* ln_b, const bf16* res, int ldr, void* out, int ldo,
              int M, int N, int K, const float* rowscale = nullptr, int mrows = 1,
              const bf16* aux = nullptr, int ldx = 0, const float* lnf = nullptr) {
  static_assert(!((PRO == Pro::kLN || PRO == Pro::kGroupLN) && BT),
                "no LayerNorm'd product reads its weight transposed");
  const int bn = plan[0], tpc = plan[2], smem = plan[5];
  const bool resident = plan[1] != 0;
  const int ntiles = bn > 0 ? (N + bn - 1) / bn : 0;
  const int bad = (int)cudaErrorInvalidValue;
  if ((bn != 64 && bn != 128) || tpc < 1 || (resident && K > WG_PANEL_MAX_K) ||
      (PRO != Pro::kPlain && !resident) || (PRO == Pro::kRowScale && rowscale == nullptr) ||
      plan[3] != (M + WG_BM - 1) / WG_BM || plan[4] != (ntiles + tpc - 1) / tpc ||
      smem != wg_smem_bytes(K, bn, resident) || smem > SMEM_LIMIT || K % 8 || N % 8 || mrows < 1 ||
      (PRO == Pro::kGroupLN && (K != 2 * PACK_C || (lnf == nullptr && (ln_g == nullptr ||
                                                                     ln_b == nullptr)))))
    return bad;
  CUtensorMap ta, tb;
  if (!make_tensor_map(&ta, A, M, K, WG_BM, WG_BK) ||
      !(BT ? make_tensor_map(&tb, Bw, N, K, 64, WG_BK) : make_tensor_map(&tb, Bw, K, N, WG_BK, 64)))
    return bad;
  WgArgs a{ln_g, ln_b, bias, res, out, M, N, K, ldr, ldo, tpc, rowscale, mrows, aux, ldx, lnf};
  const dim3 grid(plan[3], plan[4]);
  if constexpr (PRO != Pro::kPlain) {
    return bn == 64 ? wg_launch<PRO, EPI, 1, true, BT>(s, grid, smem, ta, tb, a)
                    : wg_launch<PRO, EPI, 2, true, BT>(s, grid, smem, ta, tb, a);
  } else {
    if (resident)
      return bn == 64 ? wg_launch<PRO, EPI, 1, true, BT>(s, grid, smem, ta, tb, a)
                      : wg_launch<PRO, EPI, 2, true, BT>(s, grid, smem, ta, tb, a);
    return bn == 64 ? wg_launch<PRO, EPI, 1, false, BT>(s, grid, smem, ta, tb, a)
                    : wg_launch<PRO, EPI, 2, false, BT>(s, grid, smem, ta, tb, a);
  }
}

// ---------------------------------------------- attention_tc_kernel ----
// Softmax attention of one (image, head) per blockIdx.y over its Nkv <= 64
// keys, on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate),
// at head width HD (32 or 64: the k-steps of S = q K^T and the column
// blocks of ctx = P V follow it, the key blocks do not).
// K_h and V_h are staged once per CTA in shared memory as bf16, zero-padded
// to MAX_KV keys; the CTA then walks `tiles_per_cta` query tiles of 64 rows,
// 16 rows per warp: S = q_h K_h^T in registers, the fp32 softmax with keys
// past Nkv masked, P rounded to bf16 (mit_block.py:163) and fed from the
// same registers as the A operand of ctx = P V_h, ctx rounded to bf16.
constexpr int TC_THREADS = 128, TC_ROWS = 64;

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
    attention_tc_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, int ldkv, bf16* __restrict__ ctx, int ldc,
                        int N, int Nkv, int heads, int tiles_per_cta, float scale) {
  static_assert(HD % 16 == 0 && HD <= 64, "k-steps and column blocks of 16");
  constexpr int TC_LD = HD + 8;  // padded rows: no bank conflicts (80 or 144 bytes)
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

// ------------------------------------------------ key tiles, streamed ----
// The tiled instances walk the keys of one (image, head) in tiles of MAX_KV
// keys through two shared-memory buffers: step s of a CTA loads its tile
// into buffer s & 1 by cp.async while the products of step s - 1 run, keys
// past Nkv zero-filled.
template <int HD>
struct KvRing {
  bf16 K[2][MAX_KV][HD + 8], V[2][MAX_KV][HD + 8];  // [buffer][key][d]
};

// One commit group: keys k0 .. k0 + MAX_KV - 1 of K (and of V with `with_v`)
// into buffer `buf`; row `key` of head h at ((b * Nkv + key) * ld + h * HD).
template <int HD, int THREADS>
__device__ __forceinline__ void load_kv_tile(KvRing<HD>& r, int buf, const bf16* k, const bf16* v,
                                             int ld, int b, int h, int Nkv, int k0, bool with_v,
                                             int tid) {
  for (int idx = tid; idx < MAX_KV * HD / 8; idx += THREADS) {
    const int j = idx / (HD / 8), d = (idx % (HD / 8)) * 8, key = k0 + j;
    const size_t off = key < Nkv ? ((size_t)b * Nkv + key) * ld + h * HD + d : 0;
    cp_async16(smem_addr(&r.K[buf][j][d]), k + off, key < Nkv);
    if (with_v) cp_async16(smem_addr(&r.V[buf][j][d]), v + off, key < Nkv);
  }
  cp_async_commit();
}

// acc = a X^T over one tile of MAX_KV rows X [key][d] (pitch HD + 8): a warp's
// 16 rows against every key, acc[nb] holding keys 8 nb .. 8 nb + 7 (S = q K^T
// and dP = dctx V^T).
template <int HD>
__device__ __forceinline__ void tile_products(float (&acc)[MAX_KV / 8][4],
                                              const uint32_t (&a)[HD / 16][4],
                                              const bf16 (*X)[HD + 8], int lane) {
#pragma unroll
  for (int nb = 0; nb < MAX_KV / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int nb2 = 0; nb2 < MAX_KV / 16; ++nb2) {
      uint32_t xb[4];
      ldmatrix_x4(xb, smem_addr(&X[16 * nb2 + (lane & 7) + ((lane >> 4) << 3)]
                                  [16 * kk + ((lane >> 3) & 1) * 8]));
      mma_m16n8k16(acc[2 * nb2], a[kk], xb[0], xb[1]);
      mma_m16n8k16(acc[2 * nb2 + 1], a[kk], xb[2], xb[3]);
    }
}

// A warp's 16 rows of a [rows][HD + 8] shared tile as A fragments.
template <int HD>
__device__ __forceinline__ void a_fragments(uint32_t (&a)[HD / 16][4], const bf16 (*X)[HD + 8],
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(a[kk], smem_addr(&X[lane & 15][16 * kk + (lane >> 4) * 8]));
}

// rows g (elements 0, 1) and g + 8 (elements 2, 3) of a fragment: the four
// lanes of a quad hold one row between them
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// The softmax statistics of a row over all keys, one key tile at a time:
// scores scaled, keys at or past kmax (the keys left in this tile) masked,
// the running max mx and the sum of exp(score - mx), the sum rescaled when
// the max grows. sc holds the scaled scores afterwards.
__device__ __forceinline__ void online_stats(float (&sc)[MAX_KV / 8][4], int kmax, float scale,
                                             int t, float (&mx)[2], float (&sum)[2]) {
  float tm[2] = {-CUDART_INF_F, -CUDART_INF_F}, ts[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < MAX_KV / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[nb][e] = nb * 8 + 2 * t + (e & 1) < kmax ? sc[nb][e] * scale : -CUDART_INF_F;
      tm[e >> 1] = fmaxf(tm[e >> 1], sc[nb][e]);
    }
  float m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) m[i] = fmaxf(mx[i], quad_max(tm[i]));  // finite: a tile has a key
#pragma unroll
  for (int nb = 0; nb < MAX_KV / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) ts[e >> 1] += expf(sc[nb][e] - m[e >> 1]);  // masked: exp(-inf) = 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] = sum[i] * expf(mx[i] - m[i]) + quad_sum(ts[i]);
    mx[i] = m[i];
  }
}

// P = exp(score * scale - mx) * inv in fp32 over one key tile (inv the
// reciprocal of the row's sum), 0 for keys at or past kmax.
__device__ __forceinline__ void tile_probs(float (&sc)[MAX_KV / 8][4], int kmax, float scale, int t,
                                           const float (&mx)[2], const float (&inv)[2]) {
#pragma unroll
  for (int nb = 0; nb < MAX_KV / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[nb][e] = nb * 8 + 2 * t + (e & 1) < kmax
                      ? expf(sc[nb][e] * scale - mx[e >> 1]) * inv[e >> 1] : 0.f;
}

// ----------------------------------------- attention_tc_tiled_kernel ----
// attention_tc_kernel past MAX_KV keys per head, with no key limit but the
// grid's. Each query tile of 64 rows (16 per warp) walks the key tiles of
// its (image, head) twice, K and V streamed through a KvRing:
//   pass 1 (K): S = q K^T per tile, the row max and sum over all keys
//     (online_stats);
//   pass 2 (K, V): S again, P = exp(S - max) / sum in fp32 and rounded to
//     bf16 (mit_block.py:163, the Pallas body's rounding point: the softmax
//     is normalized before the rounding, as in the one-tile kernel), then
//     ctx += bf16(P) V; ctx rounded to bf16 after the last tile.
// A one-pass online softmax would round unnormalized probabilities, which
// is another rounding than the Pallas body's.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
    attention_tc_tiled_kernel(const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, int ldkv, bf16* __restrict__ ctx,
                              int ldc, int N, int Nkv, int heads, int tiles_per_cta, float scale) {
  static_assert(HD % 16 == 0 && HD <= 64, "k-steps and column blocks of 16");
  constexpr int LD = HD + 8;
  __shared__ __align__(16) KvRing<HD> kv;
  __shared__ __align__(16) bf16 Qs[TC_THREADS / 32][16][LD];  // q rows, then ctx rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int nt = (Nkv + MAX_KV - 1) / MAX_KV, steps = 2 * nt;  // per query tile
  const int qtiles = (N + TC_ROWS - 1) / TC_ROWS;
  const int t0 = blockIdx.x * tiles_per_cta, t1 = min(t0 + tiles_per_cta, qtiles);
  const int total = max(t1 - t0, 0) * steps;
  auto issue = [&](int s) {
    const int j = s % steps;
    load_kv_tile<HD, TC_THREADS>(kv, s & 1, k, v, ldkv, b, h, Nkv, (j % nt) * MAX_KV, j >= nt, tid);
  };
  bf16(*Qw)[LD] = Qs[warp];
  const uint4 zero8 = make_uint4(0, 0, 0, 0);
  uint32_t qa[HD / 16][4];
  float mx[2], sum[2], inv[2], o[HD / 8][4];
  int r0 = 0;
  if (total > 0) issue(0);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // step s's keys are in shared memory; every warp is done with step s - 1
    if (s + 1 < total) issue(s + 1);
    const int j = s % steps, buf = s & 1, kmax = Nkv - (j % nt) * MAX_KV;
    if (j == 0) {  // a new query tile: its q rows, the statistics reset
      r0 = (t0 + s / steps) * TC_ROWS + warp * 16;
      for (int c = lane; c < 16 * HD / 8; c += 32) {
        const int rr = c / (HD / 8), d = (c % (HD / 8)) * 8, row = r0 + rr;
        store8(&Qw[rr][d], row < N ? load8(q + ((size_t)b * N + row) * ldq + h * HD + d) : zero8);
      }
      __syncwarp();
      a_fragments<HD>(qa, Qw, lane);
      mx[0] = mx[1] = -CUDART_INF_F;
      sum[0] = sum[1] = 0.f;
    }
    float sc[MAX_KV / 8][4];
    tile_products<HD>(sc, qa, kv.K[buf], lane);
    if (j < nt) {
      online_stats(sc, kmax, scale, t, mx, sum);
      continue;
    }
    if (j == nt) {
      inv[0] = 1.f / sum[0], inv[1] = 1.f / sum[1];
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
    }
    tile_probs(sc, kmax, scale, t, mx, inv);
#pragma unroll
    for (int kk = 0; kk < MAX_KV / 16; ++kk) {
      uint32_t pa[4];  // bf16(P) of keys 16 kk .. 16 kk + 15 as the A operand of P V
      pa[0] = pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int nb2 = 0; nb2 < HD / 16; ++nb2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_addr(&kv.V[buf][16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)]
                                               [16 * nb2 + ((lane >> 4) << 3)]));
        mma_m16n8k16(o[2 * nb2], pa, vb[0], vb[1]);
        mma_m16n8k16(o[2 * nb2 + 1], pa, vb[2], vb[3]);
      }
    }
    if (j + 1 < steps) continue;
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

// plan = [tiles_per_cta, grid_x, grid_y] (kernels/mit_block.py::attention_plan);
// the head width C / heads must be 32 or 64. Up to MAX_KV keys per head the
// one-tile kernel runs, past it the tiled one (chosen per call, each built
// at both head widths).
template <int HD>
void attention_tc_launch(cudaStream_t s, dim3 grid, const bf16* q, int ldq, const bf16* k,
                         const bf16* v, int ldkv, bf16* ctx, int N, int Nkv, int heads, int tpc) {
  const float scale = 1.0f / sqrtf((float)HD);
  if (Nkv <= MAX_KV)
    attention_tc_kernel<HD><<<grid, TC_THREADS, 0, s>>>(q, ldq, k, v, ldkv, ctx, ldq, N, Nkv,
                                                        heads, tpc, scale);
  else
    attention_tc_tiled_kernel<HD><<<grid, TC_THREADS, 0, s>>>(q, ldq, k, v, ldkv, ctx, ldq, N,
                                                              Nkv, heads, tpc, scale);
}

int attention_tc(cudaStream_t s, const int* plan, const bf16* q, const bf16* k, const bf16* v,
                 int ldkv, bf16* ctx, int B, int N, int Nkv, int C, int heads) {
  const int tpc = plan[0], qtiles = (N + TC_ROWS - 1) / TC_ROWS;
  const int hd = heads > 0 ? C / heads : 0;
  if (tpc < 1 || Nkv < 1 || plan[1] != (qtiles + tpc - 1) / tpc || plan[2] != B * heads ||
      hd * heads != C || (hd != 32 && hd != 64))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(plan[1], plan[2]);
  if (hd == 32)
    attention_tc_launch<32>(s, grid, q, C, k, v, ldkv, ctx, N, Nkv, heads, tpc);
  else
    attention_tc_launch<64>(s, grid, q, C, k, v, ldkv, ctx, N, Nkv, heads, tpc);
  return (int)cudaGetLastError();
}

// ------------------------------------------ attention_bwd_tc_kernel ----
// The softmax and context backward of mit_block.py::_attn_bwd_kernel for one
// (image, head) per blockIdx.y and `tiles_per_cta` tiles of 64 query rows
// per blockIdx.x, on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate), at head width HD (32 or 64: the k-steps of S = q K^T and
// dP = dctx V^T and the column blocks of dq, dk and dv follow it, the key
// blocks do not). K and V of the CTA's keys are staged once per CTA (zero
// past Nkv). The q and dctx rows of each tile come to shared memory by
// cp.async, double-buffered: the next tile's load runs under this one's
// products. Each warp takes 16 rows of a tile:
//   S = q K^T and dP = dctx V^T in accumulator fragments; the fp32 softmax
//   P = softmax(S * scale) and rowsum(dP * P) there, with quad shuffles for
//   the row max, sum and rowsum; dS = bf16(P * (dP - rowsum) * scale);
//   dq = dS K from dS in the same registers as the A operand, rounded to
//   bf16 and stored;
//   bf16(P) and dS to shared memory.
// Then each warp owns 16 keys of the tile's dv += bf16(P)^T dctx and
// dk += dS^T q, reading P, dS, dctx and q transposed with ldmatrix.trans; the
// sums over the CTA's rows stay in registers across its tiles. At the end
// a CTA that holds all N rows of its (image, head) (gridDim.x == 1) rounds dk
// and dv to bf16 and writes them; otherwise it writes fp32 partial sums to
// part [gridDim.x][2][B*Nkv*C], which dkv_reduce_kernel sums in split order
// and rounds. No atomics: dk and dv are the same from run to run. Operands
// round where the Pallas body rounds them, so only summation order differs.
//
// With TILED (past MAX_KV keys per head) blockIdx.z picks the CTA's tile of
// MAX_KV keys, whose dk and dv it owns. The row statistics over all keys,
// max, 1 / sum and rowsum(dP * P), come from attention_bwd_dq_kernel (in
// `stats`), which computes dq too; this kernel then forms P and dS of its
// key tile from them and computes no dq.
constexpr int ABW_THREADS = 128, ABW_ROWS = 64;
constexpr int ABW_MIN_CTAS = 3;  // CTAs per SM the register budget keeps resident

template <int HD>
struct AbwSmem {
  static constexpr int LD = HD + 8, PLD = MAX_KV + 8;   // padded rows
  bf16 K[MAX_KV][LD], V[MAX_KV][LD];                    // [key][d]
  bf16 Q[2][ABW_ROWS][LD], D[2][ABW_ROWS][LD];          // [buffer][row][d]: q and dctx
  bf16 P[ABW_ROWS][PLD], S[ABW_ROWS][PLD];              // [row][key]: bf16(P) and dS
};

template <int HD, bool TILED>
__global__ void __launch_bounds__(ABW_THREADS, ABW_MIN_CTAS)
    attention_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dctx,
                            bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                            float* __restrict__ part, const float* __restrict__ stats, int N,
                            int Nkv, int C, int heads, int tiles_per_cta, float scale) {
  static_assert(HD % 16 == 0 && HD <= 64, "k-steps and column blocks of 16");
  extern __shared__ __align__(16) unsigned char abw_smem[];
  AbwSmem<HD>& sm = *reinterpret_cast<AbwSmem<HD>*>(abw_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = TILED ? blockIdx.z * MAX_KV : 0, kmax = Nkv - k0;  // this CTA's keys
  const uint4 zero8 = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < MAX_KV * HD / 8; idx += ABW_THREADS) {
    const int j = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
    const size_t off = ((size_t)b * Nkv + k0 + j) * C + h * HD + d;
    store8(&sm.K[j][d], j < kmax ? load8(k + off) : zero8);
    store8(&sm.V[j][d], j < kmax ? load8(v + off) : zero8);
  }

  // dk and dv of keys 16 warp + g (+ 8), head dims 8 nb + 2 t (+ 1)
  float adk[HD / 8][4], adv[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nb][e] = adv[nb][e] = 0.f;

  const int qtiles = (N + ABW_ROWS - 1) / ABW_ROWS;
  const int t0 = blockIdx.x * tiles_per_cta, t1 = min(t0 + tiles_per_cta, qtiles);
  const int wr = 16 * warp;  // this warp's rows of the tile, then its keys
  // one commit group per tile: its q and dctx rows into buffer `buf`, zeros
  // past N
  auto load_tile = [&](int tile, int buf) {
    for (int idx = tid; idx < ABW_ROWS * HD / 8; idx += ABW_THREADS) {
      const int r = idx / (HD / 8), d = (idx % (HD / 8)) * 8, row = tile * ABW_ROWS + r;
      const size_t off = row < N ? ((size_t)b * N + row) * C + h * HD + d : 0;
      cp_async16(smem_addr(&sm.Q[buf][r][d]), q + off, row < N);
      cp_async16(smem_addr(&sm.D[buf][r][d]), dctx + off, row < N);
    }
    cp_async_commit();
  };
  if (t0 < t1) load_tile(t0, 0);
  for (int tile = t0; tile < t1; ++tile) {
    const int row0 = tile * ABW_ROWS, buf = (tile - t0) & 1;
    __syncthreads();  // K and V staged; the previous tile's Q, D, P, S are read
    if (tile + 1 < t1) {
      load_tile(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's q and dctx rows are in shared memory
    bf16(*Qs)[AbwSmem<HD>::LD] = sm.Q[buf];
    bf16(*Ds)[AbwSmem<HD>::LD] = sm.D[buf];

    float sc[MAX_KV / 8][4], dp[MAX_KV / 8][4];
#pragma unroll
    for (int nb = 0; nb < MAX_KV / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, smem_addr(&Qs[wr + (lane & 15)][16 * kk + (lane >> 4) * 8]));
      ldmatrix_x4(da, smem_addr(&Ds[wr + (lane & 15)][16 * kk + (lane >> 4) * 8]));
#pragma unroll
      for (int nb2 = 0; nb2 < MAX_KV / 16; ++nb2) {
        const int key = 16 * nb2 + (lane & 7) + ((lane >> 4) << 3);
        const int col = 16 * kk + ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, smem_addr(&sm.K[key][col]));
        ldmatrix_x4(vb, smem_addr(&sm.V[key][col]));
        mma_m16n8k16(sc[2 * nb2], qa, kb[0], kb[1]);
        mma_m16n8k16(sc[2 * nb2 + 1], qa, kb[2], kb[3]);
        mma_m16n8k16(dp[2 * nb2], da, vb[0], vb[1]);
        mma_m16n8k16(dp[2 * nb2 + 1], da, vb[2], vb[3]);
      }
    }

    // rows g (elements 0, 1) and g + 8 (elements 2, 3); a quad holds a row
    float rs[2] = {0.f, 0.f};
    if constexpr (TILED) {
      // P from the statistics over all keys; rows past N read none (P = 0)
      const size_t pn = (size_t)gridDim.y * N, base = (size_t)blockIdx.y * N;
      float mx[2], inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + wr + g + 8 * i;
        mx[i] = row < N ? stats[base + row] : 0.f;
        inv[i] = row < N ? stats[pn + base + row] : 0.f;
        rs[i] = row < N ? stats[2 * pn + base + row] : 0.f;
      }
      tile_probs(sc, kmax, scale, t, mx, inv);
    } else {
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
      // P in fp32 (by the reciprocal of the row sum; zero on rows past N)
      const float inv[2] = {row0 + wr + g < N ? 1.f / sum[0] : 0.f,
                            row0 + wr + g + 8 < N ? 1.f / sum[1] : 0.f};
#pragma unroll
      for (int nb = 0; nb < MAX_KV / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nb][e] *= inv[e >> 1];
          rs[e >> 1] += dp[nb][e] * sc[nb][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(FULL_MASK, rs[i], 1);
        rs[i] += __shfl_xor_sync(FULL_MASK, rs[i], 2);
      }
    }
    // bf16(P) and dS to shared memory; dS also as the A operand of dq = dS K
    uint32_t dsa[MAX_KV / 16][4];
#pragma unroll
    for (int nb = 0; nb < MAX_KV / 8; ++nb) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = sc[nb][e] * (dp[nb][e] - rs[e >> 1]) * scale;
      const uint32_t lo = pack_bf16x2(ds[0], ds[1]), hi = pack_bf16x2(ds[2], ds[3]);
      dsa[nb >> 1][(nb & 1) * 2] = lo;
      dsa[nb >> 1][(nb & 1) * 2 + 1] = hi;
      const int key = nb * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(&sm.S[wr + g][key]) = lo;
      *reinterpret_cast<uint32_t*>(&sm.S[wr + g + 8][key]) = hi;
      *reinterpret_cast<uint32_t*>(&sm.P[wr + g][key]) = pack_bf16x2(sc[nb][0], sc[nb][1]);
      *reinterpret_cast<uint32_t*>(&sm.P[wr + g + 8][key]) = pack_bf16x2(sc[nb][2], sc[nb][3]);
    }

    if constexpr (!TILED) {
      float o[HD / 8][4];
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MAX_KV / 16; ++kk)
#pragma unroll
        for (int nb2 = 0; nb2 < HD / 16; ++nb2) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, smem_addr(&sm.K[16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)]
                                              [16 * nb2 + ((lane >> 4) << 3)]));
          mma_m16n8k16(o[2 * nb2], dsa[kk], kb[0], kb[1]);
          mma_m16n8k16(o[2 * nb2 + 1], dsa[kk], kb[2], kb[3]);
        }
      const size_t dq0 = ((size_t)b * N + row0 + wr + g) * C + h * HD + 2 * t;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        if (row0 + wr + g < N)
          *reinterpret_cast<uint32_t*>(dq + dq0 + nb * 8) = pack_bf16x2(o[nb][0], o[nb][1]);
        if (row0 + wr + g + 8 < N)
          *reinterpret_cast<uint32_t*>(dq + dq0 + (size_t)8 * C + nb * 8) =
              pack_bf16x2(o[nb][2], o[nb][3]);
      }
    }
    __syncthreads();  // every warp's P and dS rows are in shared memory

    // keys wr .. wr + 15 of dv += P^T dctx and dk += dS^T q over the tile's rows
#pragma unroll
    for (int kk = 0; kk < ABW_ROWS / 16; ++kk) {
      const int prow = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
      const int pcol = wr + (((lane >> 3) & 1) << 3);
      uint32_t pa[4], sa[4];
      ldmatrix_x4_trans(pa, smem_addr(&sm.P[prow][pcol]));
      ldmatrix_x4_trans(sa, smem_addr(&sm.S[prow][pcol]));
#pragma unroll
      for (int nb2 = 0; nb2 < HD / 16; ++nb2) {
        const int brow = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int bcol = 16 * nb2 + ((lane >> 4) << 3);
        uint32_t db[4], qb[4];
        ldmatrix_x4_trans(db, smem_addr(&Ds[brow][bcol]));
        ldmatrix_x4_trans(qb, smem_addr(&Qs[brow][bcol]));
        mma_m16n8k16(adv[2 * nb2], pa, db[0], db[1]);
        mma_m16n8k16(adv[2 * nb2 + 1], pa, db[2], db[3]);
        mma_m16n8k16(adk[2 * nb2], sa, qb[0], qb[1]);
        mma_m16n8k16(adk[2 * nb2 + 1], sa, qb[2], qb[3]);
      }
    }
  }

  const size_t nkv = (size_t)gridDim.y / heads * Nkv * C;  // B * Nkv * C
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = wr + g + 8 * half;
    if (key >= kmax) continue;
    const size_t row = ((size_t)b * Nkv + k0 + key) * C + h * HD + 2 * t;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      const float k0v = adk[nb][2 * half], k1v = adk[nb][2 * half + 1];
      const float v0 = adv[nb][2 * half], v1 = adv[nb][2 * half + 1];
      if (part == nullptr) {
        *reinterpret_cast<uint32_t*>(dk + row + nb * 8) = pack_bf16x2(k0v, k1v);
        *reinterpret_cast<uint32_t*>(dv + row + nb * 8) = pack_bf16x2(v0, v1);
      } else {
        float* pk = part + (size_t)blockIdx.x * 2 * nkv + row + nb * 8;
        *reinterpret_cast<float2*>(pk) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(pk + nkv) = make_float2(v0, v1);
      }
    }
  }
}

// -------------------------------------------- attention_bwd_dq_kernel ----
// The tiled backward's first launch, past MAX_KV keys per head: for each
// query tile of 64 rows (16 per warp), on the grid of attention_plan, the
// key tiles of its (image, head) stream through a KvRing three times:
//   pass 1 (K): the row max and sum over all keys (online_stats);
//   pass 2 (K, V): S and dP = dctx V^T again, P = exp(S - max) / sum in fp32
//     (tile_probs), rowsum(dP * P);
//   pass 3 (K, V): S and dP again, dS = bf16(P * (dP - rowsum) * scale),
//     dq += dS K.
// dq is rounded to bf16 once after the last tile (the one-tile kernel's
// rounding point, its fp32 sum over every key), and each row's max, 1 / sum
// and rowsum go to stats [3][B * heads * N] for the key-tile CTAs of
// attention_bwd_tc_kernel<HD, true>. P and dS round where the one-tile
// kernel rounds them.
template <int HD>
struct AbwDqSmem {
  KvRing<HD> kv;
  bf16 Q[ABW_THREADS / 32][16][HD + 8], D[ABW_THREADS / 32][16][HD + 8];  // per warp
};

template <int HD>
__global__ void __launch_bounds__(ABW_THREADS)
    attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dctx,
                            bf16* __restrict__ dq, float* __restrict__ stats, int N, int Nkv,
                            int C, int heads, int tiles_per_cta, float scale) {
  extern __shared__ __align__(16) unsigned char dq_smem[];
  AbwDqSmem<HD>& sm = *reinterpret_cast<AbwDqSmem<HD>*>(dq_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int nt = (Nkv + MAX_KV - 1) / MAX_KV, steps = 3 * nt;  // per query tile
  const int qtiles = (N + ABW_ROWS - 1) / ABW_ROWS;
  const int t0 = blockIdx.x * tiles_per_cta, t1 = min(t0 + tiles_per_cta, qtiles);
  const int total = max(t1 - t0, 0) * steps;
  auto issue = [&](int s) {
    const int j = s % steps;
    load_kv_tile<HD, ABW_THREADS>(sm.kv, s & 1, k, v, C, b, h, Nkv, (j % nt) * MAX_KV, j >= nt,
                                  tid);
  };
  bf16(*Qw)[HD + 8] = sm.Q[warp];
  bf16(*Dw)[HD + 8] = sm.D[warp];
  const uint4 zero8 = make_uint4(0, 0, 0, 0);
  uint32_t qa[HD / 16][4], da[HD / 16][4];
  float mx[2], sum[2], inv[2], rs[2], o[HD / 8][4];
  int r0 = 0;
  if (total > 0) issue(0);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // step s's keys are in shared memory; every warp is done with step s - 1
    if (s + 1 < total) issue(s + 1);
    const int j = s % steps, buf = s & 1, kmax = Nkv - (j % nt) * MAX_KV;
    if (j == 0) {  // a new query tile: its q and dctx rows, the statistics reset
      r0 = (t0 + s / steps) * ABW_ROWS + warp * 16;
      for (int c = lane; c < 16 * HD / 8; c += 32) {
        const int rr = c / (HD / 8), d = (c % (HD / 8)) * 8, row = r0 + rr;
        const size_t off = ((size_t)b * N + row) * C + h * HD + d;
        store8(&Qw[rr][d], row < N ? load8(q + off) : zero8);
        store8(&Dw[rr][d], row < N ? load8(dctx + off) : zero8);
      }
      __syncwarp();
      a_fragments<HD>(qa, Qw, lane);
      a_fragments<HD>(da, Dw, lane);
      mx[0] = mx[1] = -CUDART_INF_F;
      sum[0] = sum[1] = rs[0] = rs[1] = 0.f;
    }
    float sc[MAX_KV / 8][4];
    tile_products<HD>(sc, qa, sm.kv.K[buf], lane);
    if (j < nt) {
      online_stats(sc, kmax, scale, t, mx, sum);
      continue;
    }
    if (j == nt) inv[0] = 1.f / sum[0], inv[1] = 1.f / sum[1];
    float dp[MAX_KV / 8][4];
    tile_products<HD>(dp, da, sm.kv.V[buf], lane);
    tile_probs(sc, kmax, scale, t, mx, inv);
    if (j < 2 * nt) {  // pass 2: this thread's part of rowsum(dP * P)
#pragma unroll
      for (int nb = 0; nb < MAX_KV / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += dp[nb][e] * sc[nb][e];
      if (j == 2 * nt - 1) {
        rs[0] = quad_sum(rs[0]), rs[1] = quad_sum(rs[1]);
#pragma unroll
        for (int nb = 0; nb < HD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
      }
      continue;
    }
    // pass 3: dq += dS K over this key tile
#pragma unroll
    for (int kk = 0; kk < MAX_KV / 16; ++kk) {
      uint32_t dsa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float(&p)[4] = sc[2 * kk + half];
        const float(&d)[4] = dp[2 * kk + half];
        dsa[2 * half] = pack_bf16x2(p[0] * (d[0] - rs[0]) * scale, p[1] * (d[1] - rs[0]) * scale);
        dsa[2 * half + 1] =
            pack_bf16x2(p[2] * (d[2] - rs[1]) * scale, p[3] * (d[3] - rs[1]) * scale);
      }
#pragma unroll
      for (int nb2 = 0; nb2 < HD / 16; ++nb2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, smem_addr(&sm.kv.K[buf][16 * kk + (lane & 7) +
                                                      (((lane >> 3) & 1) << 3)]
                                                     [16 * nb2 + ((lane >> 4) << 3)]));
        mma_m16n8k16(o[2 * nb2], dsa, kb[0], kb[1]);
        mma_m16n8k16(o[2 * nb2 + 1], dsa, kb[2], kb[3]);
      }
    }
    if (j + 1 < steps) continue;
    const size_t pn = (size_t)gridDim.y * N, base = (size_t)blockIdx.y * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row >= N) continue;
      const size_t dq0 = ((size_t)b * N + row) * C + h * HD + 2 * t;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
        *reinterpret_cast<uint32_t*>(dq + dq0 + nb * 8) =
            pack_bf16x2(o[nb][2 * i], o[nb][2 * i + 1]);
      if (t == 0) {
        stats[base + row] = mx[i];
        stats[pn + base + row] = inv[i];
        stats[2 * pn + base + row] = rs[i];
      }
    }
  }
}

// dk, dv [nkv] = bf16(sum over the splits of part [splits][2][nkv]), in split
// order; 4 values per thread (nkv is a multiple of 4).
__global__ void dkv_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, size_t nkv, int splits) {
  const size_t n4 = nkv / 4;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < 2 * n4;
       t += (size_t)gridDim.x * blockDim.x) {
    const int which = t >= n4;
    const size_t i = 4 * (t - which * n4);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float4 p = *reinterpret_cast<const float4*>(part + ((size_t)sp * 2 + which) * nkv + i);
      acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
    }
    uint2 out;
    out.x = pack_bf16x2(acc.x, acc.y);
    out.y = pack_bf16x2(acc.z, acc.w);
    *reinterpret_cast<uint2*>((which ? dv : dk) + i) = out;
  }
}

// plan = [tiles_per_cta, grid_x, grid_y, dq_tiles_per_cta, dq_grid_x,
// dq_grid_y] (kernels/mit_block.py::attn_backward_plan): grid_x CTAs split
// the query tiles of each (image, head); above 1, their partial sums go to
// part and one reduce launch follows. Up to MAX_KV keys the one-tile kernel
// computes dq, dk and dv (the dq record is zeros); past it
// attention_bwd_dq_kernel (on the dq record's grid) computes dq and the row
// statistics into stats [3][B * heads * N], then one CTA per (split, image
// and head, key tile) the key tile's dk and dv.
template <int HD>
int attention_bwd_tc_hd(cudaStream_t s, const int* plan, const bf16* q, const bf16* k,
                        const bf16* v, const bf16* dctx, bf16* dq, bf16* dk, bf16* dv,
                        float* part, float* stats, int B, int N, int Nkv, int C, int heads) {
  const int tpc = plan[0], splits = plan[1], qtiles = (N + ABW_ROWS - 1) / ABW_ROWS;
  const int ktiles = (Nkv + MAX_KV - 1) / MAX_KV;
  const int bad = (int)cudaErrorInvalidValue;
  if (tpc < 1 || Nkv < 1 || C != heads * HD || splits != (qtiles + tpc - 1) / tpc ||
      plan[2] != B * heads || (splits > 1 && part == nullptr))
    return bad;
  const float scale = 1.0f / sqrtf((float)HD);
  const int smem = (int)sizeof(AbwSmem<HD>);
  float* parts = splits > 1 ? part : nullptr;
  if (ktiles == 1) {
    static std::atomic<bool> attr_set[kMaxDevices];
    const cudaError_t attr = smem_limit_once(attention_bwd_tc_kernel<HD, false>, smem, attr_set);
    if (attr != cudaSuccess) return (int)attr;
    attention_bwd_tc_kernel<HD, false><<<dim3(splits, plan[2]), ABW_THREADS, smem, s>>>(
        q, k, v, dctx, dq, dk, dv, parts, nullptr, N, Nkv, C, heads, tpc, scale);
  } else {
    const int dq_tpc = plan[3];
    if (dq_tpc < 1 || plan[4] != (qtiles + dq_tpc - 1) / dq_tpc || plan[5] != B * heads ||
        stats == nullptr)
      return bad;
    static std::atomic<bool> dq_set[kMaxDevices], tiled_set[kMaxDevices];
    const int dq_smem = (int)sizeof(AbwDqSmem<HD>);
    cudaError_t attr = smem_limit_once(attention_bwd_dq_kernel<HD>, dq_smem, dq_set);
    if (attr == cudaSuccess)
      attr = smem_limit_once(attention_bwd_tc_kernel<HD, true>, smem, tiled_set);
    if (attr != cudaSuccess) return (int)attr;
    attention_bwd_dq_kernel<HD><<<dim3(plan[4], plan[5]), ABW_THREADS, dq_smem, s>>>(
        q, k, v, dctx, dq, stats, N, Nkv, C, heads, dq_tpc, scale);
    attention_bwd_tc_kernel<HD, true><<<dim3(splits, plan[2], ktiles), ABW_THREADS, smem, s>>>(
        q, k, v, dctx, dq, dk, dv, parts, stats, N, Nkv, C, heads, tpc, scale);
  }
  if (splits > 1) {
    const size_t nkv = (size_t)B * Nkv * C;
    dkv_reduce_kernel<<<grid_for(nkv / 2, 256), 256, 0, s>>>(part, dk, dv, nkv, splits);
  }
  return (int)cudaGetLastError();
}

int attention_bwd_tc(cudaStream_t s, const int* plan, const bf16* q, const bf16* k,
                     const bf16* v, const bf16* dctx, bf16* dq, bf16* dk, bf16* dv, float* part,
                     float* stats, int B, int N, int Nkv, int C, int heads) {
  const int hd = heads > 0 ? C / heads : 0;
  if (hd == 32)
    return attention_bwd_tc_hd<32>(s, plan, q, k, v, dctx, dq, dk, dv, part, stats, B, N, Nkv,
                                   C, heads);
  if (hd == 64)
    return attention_bwd_tc_hd<64>(s, plan, q, k, v, dctx, dq, dk, dv, part, stats, B, N, Nkv,
                                   C, heads);
  return (int)cudaErrorInvalidValue;
}

#define TRY(call)                  \
  do {                             \
    const int err_ = (call);       \
    if (err_ != 0) return err_;    \
  } while (0)

constexpr int GEMM_PLAN = 6, ATTN_PLAN = 3;

// x1 = x + (ctx @ wo + bo) into x1buf; y = x1 + fc2(gelu(dwconv(fc1(LN2(x1)))))
// through hid and act. With SCALE (the training block) each fp32 branch is
// first scaled per image: by m1 [B] for the attention branch, m2 [B] for
// the MLP branch. LN2 kGroupLN (packed2) takes LN2 per 64-lane half.
// plan: the out, fc1 and fc2 product plans. y may alias x (the stage's
// in-place residual stream), not x1buf.
template <bool SCALE, Pro LN2 = Pro::kLN>
int out_and_mlp(cudaStream_t s, const int* plan, const bf16* x, const bf16* ctx, const bf16* wo,
                const bf16* bo, const bf16* ln2_g, const bf16* ln2_b, const bf16* w1,
                const bf16* b1, const bf16* wdw, const bf16* bdw, const bf16* w2, const bf16* b2,
                const float* m1, const float* m2, bf16* x1buf, bf16* hid, bf16* act, bf16* y,
                int B, int H, int W, int C, int hidden) {
  constexpr Epi RES = SCALE ? Epi::kBiasResScale : Epi::kBiasRes;
  const int N = H * W, M = B * N;
  TRY((wg_linear<Pro::kPlain, RES>(s, plan, ctx, wo, bo, nullptr, nullptr, x, C, x1buf, C, M, C, C,
                                   m1, N)));
  TRY((wg_linear<LN2, Epi::kBias>(s, plan + GEMM_PLAN, x1buf, w1, b1, ln2_g, ln2_b, nullptr, 0,
                                  hid, hidden, M, hidden, C)));
  dwconv3x3_kernel<true><<<grid_for((size_t)M * hidden / 8, 256), 256, 0, s>>>(
      hid, wdw, bdw, act, B, H, W, hidden);
  TRY((wg_linear<Pro::kPlain, RES>(s, plan + 2 * GEMM_PLAN, act, w2, b2, nullptr, nullptr, x1buf, C,
                                   y, C, M, C, hidden, m2, N)));
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
  TRY((wg_linear<Pro::kLN, Epi::kBias>(s, pl, (P)x, (P)wq, (P)bq, (P)ln1_g, (P)ln1_b, nullptr, 0,
                                       (bf16*)q, C, M, C, C)));
  TRY(attention_tc(s, pl + GEMM_PLAN, (P)q, (P)k, (P)v, C, (bf16*)ctx, B, H * W, Nkv, C, heads));
  return out_and_mlp<false>(s, pl + GEMM_PLAN + ATTN_PLAN, (P)x, (P)ctx, (P)wo, (P)bo, (P)ln2_g,
                            (P)ln2_b, (P)w1, (P)b1, (P)wdw, (P)bdw, (P)w2, (P)b2, nullptr, nullptr,
                            (bf16*)q, (bf16*)hid, (bf16*)act, (bf16*)y, B, H, W, C, hidden);
}

// fused_mit_block_packed2 (mit_block.py:801): the 1-head, C = 64 block over
// image pairs, each token row the 128-wide [x[2p, n], x[2p+1, n]]. The
// packed weights are used as given, as full 128-wide products (wq, wo
// [128, 128], w1 [128, hidden], w2 [hidden, 128], wdw [9, hidden]), so any
// packed dict gives the TPU kernel's function, not only block-diagonal ones.
// It is mit_block_forward's chain on the packed rows, with the per-half
// LayerNorm in the resident-panel prologue:
//   q = LN1(xp) wq + bq, LN1 per 64-lane half (ln1 [2, 128] fp32: scale,
//   bias), on wgmma_linear (kGroupLN); attention_tc at heads = 2, head_dim
//   64 and leading dimension 128 over k, v packed the same way, which is
//   the per-image segment softmax of the TPU body (each segment takes its
//   own max: the TPU body's row-global max is the same in real arithmetic);
//   then out_and_mlp: xp + ctx wo + bo, hid = LN2(x1) w1 + b1 per half
//   (ln2_g, ln2_b [128] bf16, K = 128 resident), dwconv 3x3 + GELU, xp =
//   x1 + act w2 + b2 (K = hidden = 512, resident).
// The TPU kernel's row bands (row_chunks) bound its VMEM; here every kernel
// sees the whole grid, and the zero-edge dwconv is that same function.
// Pack and unpack stay copies around the chain (lane_pack2_kernel: 3 + 1 of
// the call's 10 launches): the products' tensor maps read rows of 128 lanes,
// and a packed row is two 128-byte runs of two images. `plan` (host memory,
// kernels/mit_block.py::packed2_plan) is block_plan's record for the packed
// rows. Scratch: xp [P*N, 128] (x, then the residual stream in place), kp,
// vp [P*Nkv, 128], q [P*N, 128] (q, then x1), ctx [P*N, 128], hid, act
// [P*N, hidden]. y [B, N, 64] must not alias x.
int mit_block_packed2_forward(const void* x, const void* k, const void* v, const void* ln1,
                              const void* wq, const void* bq, const void* wo, const void* bo,
                              const void* ln2_g, const void* ln2_b, const void* w1,
                              const void* b1, const void* wdw,
                              const void* bdw, const void* w2, const void* b2, const void* plan,
                              void* xp, void* kp, void* vp, void* q, void* ctx, void* hid,
                              void* act, void* y, int B, int H, int W, int Nkv, int hidden,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  constexpr int C = PACK_C, C2 = 2 * PACK_C;  // 64 channels per image, two images per row
  const int pairs = B / 2, N = H * W, M = pairs * N;
  const int* pl = (const int*)plan;
  const int pack_threads = 256;
  lane_pack2_kernel<true><<<grid_for((size_t)M * C2 / 8, pack_threads), pack_threads, 0, s>>>(
      (P)x, (bf16*)xp, pairs, N, C);
  lane_pack2_kernel<true><<<grid_for((size_t)pairs * Nkv * C2 / 8, pack_threads), pack_threads,
                            0, s>>>((P)k, (bf16*)kp, pairs, Nkv, C);
  lane_pack2_kernel<true><<<grid_for((size_t)pairs * Nkv * C2 / 8, pack_threads), pack_threads,
                            0, s>>>((P)v, (bf16*)vp, pairs, Nkv, C);
  TRY((wg_linear<Pro::kGroupLN, Epi::kBias>(s, pl, (P)xp, (P)wq, (P)bq, nullptr, nullptr, nullptr,
                                            0, (bf16*)q, C2, M, C2, C2, nullptr, 1, nullptr, 0,
                                            (const float*)ln1)));
  TRY(attention_tc(s, pl + GEMM_PLAN, (P)q, (P)kp, (P)vp, C2, (bf16*)ctx, pairs, N, Nkv, C2, 2));
  TRY((out_and_mlp<false, Pro::kGroupLN>(
      s, pl + GEMM_PLAN + ATTN_PLAN, (P)xp, (P)ctx, (P)wo, (P)bo, (P)ln2_g, (P)ln2_b, (P)w1,
      (P)b1, (P)wdw, (P)bdw, (P)w2, (P)b2, nullptr, nullptr, (bf16*)q, (bf16*)hid, (bf16*)act,
      (bf16*)xp, pairs, H, W, C2, hidden)));
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
      TRY((wg_linear<Pro::kPlain, Epi::kBiasGelu>(s, p_lw, (P)base, (P)lww + (size_t)d * Cb * C4,
                                                  (P)lwb + (size_t)d * C4, nullptr, nullptr,
                                                  nullptr, 0, (bf16*)feat, C4, M, C4, Cb)));
      TRY((wg_linear<Pro::kPlain, Epi::kBiasRes>(s, p_shared, (P)feat, (P)sharedw, (P)sharedb,
                                                 nullptr, nullptr, Y, C, Y, C, M, C, C4)));
    }
    const bf16* l1 = (P)ln1 + (size_t)d * 2 * C;
    layernorm_kernel<<<(M + 3) / 4, 128, 0, s>>>(Y, l1, l1 + C, (bf16*)xln, M, C);
    const bf16* kv_in = (P)xln;
    if (sr > 1) {
      sr_patches_kernel<<<grid_for((size_t)Mkv * sr * sr * C / 8, 256), 256, 0, s>>>(
          (P)xln, (bf16*)patches, B, H, W, C, sr);
      TRY((wg_linear<Pro::kPlain, Epi::kBias>(s, p_sr, (P)patches,
                                              (P)srw + (size_t)d * sr * sr * C * C,
                                              (P)srb + (size_t)d * C, nullptr, nullptr, nullptr, 0,
                                              (bf16*)red, C, Mkv, C, sr * sr * C)));
      const bf16* lk = (P)lnkv + (size_t)d * 2 * C;
      layernorm_kernel<<<(Mkv + 3) / 4, 128, 0, s>>>((P)red, lk, lk + C, (bf16*)kvin, Mkv, C);
      kv_in = (P)kvin;
    }
    TRY((wg_linear<Pro::kPlain, Epi::kBias>(s, p_kv, kv_in, (P)wkv + (size_t)d * C * 2 * C,
                                            (P)bkv + (size_t)d * 2 * C, nullptr, nullptr, nullptr,
                                            0, (bf16*)kv, 2 * C, Mkv, 2 * C, C)));
    TRY((wg_linear<Pro::kPlain, Epi::kBias>(s, p_q, (P)xln, (P)wq + (size_t)d * C * C,
                                            (P)bq + (size_t)d * C, nullptr, nullptr, nullptr, 0,
                                            (bf16*)q, C, M, C, C)));
    TRY(attention_tc(s, p_attn, (P)q, (P)kv, (P)kv + C, 2 * C, (bf16*)ctx, B, N, Nkv, C, heads));
    const bf16* l2 = (P)ln2 + (size_t)d * 2 * C;
    TRY(out_and_mlp<false>(s, p_mlp, Y, (P)ctx, (P)wo + (size_t)d * C * C, (P)bo + (size_t)d * C,
                           l2, l2 + C, (P)w1 + (size_t)d * C * hidden, (P)b1 + (size_t)d * hidden,
                           (P)wdw + (size_t)d * 9 * hidden, (P)bdw + (size_t)d * hidden,
                           (P)w2 + (size_t)d * hidden * C, (P)b2 + (size_t)d * C, nullptr, nullptr,
                           (bf16*)q, (bf16*)hid, (bf16*)act, Y, B, H, W, C, hidden));
  }
  return (int)cudaGetLastError();
}

// ---- training: fused_mit_block_train (surgical_tpu/kernels/mit_block.py) ----
// The trunk is frozen, so the backward computes input gradients only.

// Forward (_block_train_fwd_kernel, mit_block.py:1339): the block with xln =
// LN1(x) given, the per-image DropPath factors m1/m2 [B] (fp32, 0 or
// 1/keep) applied to each fp32 branch before its residual rounding, and the
// post-attention residual x1 written out for the backward. The serving
// block's chain: the q product (no LN prologue: xln is given), the
// tensor-core attention, then out_and_mlp with the scaled-residual
// epilogues. `plan` (host memory, kernels/mit_block.py::train_forward_plan)
// holds the plans of q, the attention, out, fc1 and fc2. Scratch: q, ctx
// [B*N, C]; hid, act [B*N, hidden].
int mit_block_train_forward(const void* x, const void* xln, const void* k, const void* v,
                            const void* m1, const void* m2, const void* wq, const void* bq,
                            const void* wo, const void* bo, const void* ln2_g,
                            const void* ln2_b, const void* w1, const void* b1, const void* wdw,
                            const void* bdw, const void* w2, const void* b2, const void* plan,
                            void* q, void* ctx, void* hid, void* act, void* x1, void* y, int B,
                            int H, int W, int C, int heads, int Nkv, int hidden, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  const int N = H * W, M = B * N;
  const int* pl = (const int*)plan;
  TRY((wg_linear<Pro::kPlain, Epi::kBias>(s, pl, (P)xln, (P)wq, (P)bq, nullptr, nullptr, nullptr, 0,
                                          q, C, M, C, C)));
  TRY(attention_tc(s, pl + GEMM_PLAN, (P)q, (P)k, (P)v, C, (bf16*)ctx, B, N, Nkv, C, heads));
  return out_and_mlp<true>(s, pl + GEMM_PLAN + ATTN_PLAN, (P)x, (P)ctx, (P)wo, (P)bo, (P)ln2_g,
                           (P)ln2_b, (P)w1, (P)b1, (P)wdw, (P)bdw, (P)w2, (P)b2,
                           (const float*)m1, (const float*)m2, (bf16*)x1, (bf16*)hid, (bf16*)act,
                           (bf16*)y, B, H, W, C, hidden);
}

// MLP backward (_mlp_bwd_kernel, mit_block.py:1419) over all of hidden at
// once, three products on wgmma_linear with the dwconvs between them:
//   a1 = bf16(h2ln w1 + b1)                      (resident panel, K = C)
//   hd = bf16(dwconv(a1) + bdw)
//   dh = bf16((dmlp w2^T) * gelu'(hd))           (w2 [hidden, C] read K-major)
//   da1 = dwconv^T(dh)
//   dh2ln = da1 w1^T in fp32 [B*N, C]            (w1 [C, hidden] read K-major;
//                                                 K = hidden, the ring above 512)
// `plan` (host memory, kernels/mit_block.py::mlp_backward_plan) holds the
// three product plans. Scratch bufA, bufB [B*N, hidden] (a1 then dh; hd
// then da1).
int mit_block_train_mlp_backward(const void* h2ln, const void* dmlp, const void* w1,
                                 const void* b1, const void* wdw, const void* bdw,
                                 const void* w2, const void* plan, void* bufA, void* bufB,
                                 void* dh2ln, int B, int H, int W, int C, int hidden,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  const int M = B * H * W;
  const int* pl = (const int*)plan;
  const int conv_grid = grid_for((size_t)M * hidden / 8, 256);
  TRY((wg_linear<Pro::kPlain, Epi::kBias>(s, pl, (P)h2ln, (P)w1, (P)b1, nullptr, nullptr, nullptr,
                                          0, bufA, hidden, M, hidden, C)));
  dwconv3x3_kernel<false><<<conv_grid, 256, 0, s>>>((P)bufA, (P)wdw, (P)bdw, (bf16*)bufB, B, H,
                                                    W, hidden);
  TRY((wg_linear<Pro::kPlain, Epi::kGeluGrad, true>(s, pl + GEMM_PLAN, (P)dmlp, (P)w2, nullptr,
                                                    nullptr, nullptr, nullptr, 0, bufA, hidden, M,
                                                    hidden, C, nullptr, 1, (P)bufB, hidden)));
  dwconv3x3_t_kernel<<<conv_grid, 256, 0, s>>>((P)bufA, (P)wdw, (bf16*)bufB, B, H, W, hidden);
  TRY((wg_linear<Pro::kPlain, Epi::kF32, true>(s, pl + 2 * GEMM_PLAN, (P)bufB, (P)w1, nullptr,
                                               nullptr, nullptr, nullptr, 0, dh2ln, C, M, C,
                                               hidden)));
  return (int)cudaGetLastError();
}

// Attention backward (_attn_bwd_kernel, mit_block.py:1472) in four to six
// launches, with no memset and no atomics:
//   q = bf16(xln wq + bq)                        (wgmma, resident panel)
//   dctx = bf16(bf16(dx1 * m1[row / N]) wo^T)    (wgmma: the row scale in
//                                                 place on the resident panel,
//                                                 wo read K-major)
//   dq, and dk, dv or their partial sums         (attention_bwd_tc_kernel,
//                                                 past MAX_KV keys after
//                                                 attention_bwd_dq_kernel;
//                                                 then dkv_reduce_kernel when
//                                                 the rows of an image split)
//   dxln = bf16(dq wq^T)                         (wgmma, wq read K-major)
// `plan` (host memory, kernels/mit_block.py::attn_backward_plan) holds the
// plans of the q, dctx and dxln products and of the attention. Scratch: q,
// dctx, dq [B*N, C]; part [splits][2][B*Nkv*C] fp32 when the plan splits
// (null otherwise); stats [3][B*heads*N] fp32 past MAX_KV keys (null
// otherwise).
int mit_block_train_attn_backward(const void* xln, const void* k, const void* v,
                                  const void* dx1, const void* m1, const void* wq,
                                  const void* bq, const void* wo, const void* plan, void* q,
                                  void* dctx, void* dq, void* part, void* stats, void* dxln,
                                  void* dk, void* dv, int B, int N, int C, int heads, int Nkv,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  const int M = B * N;
  const int* pl = (const int*)plan;
  TRY((wg_linear<Pro::kPlain, Epi::kBias>(s, pl, (P)xln, (P)wq, (P)bq, nullptr, nullptr, nullptr, 0,
                                          q, C, M, C, C)));
  TRY((wg_linear<Pro::kRowScale, Epi::kPlain, true>(s, pl + GEMM_PLAN, (P)dx1, (P)wo, nullptr,
                                                    nullptr, nullptr, nullptr, 0, dctx, C, M, C, C,
                                                    (const float*)m1, N)));
  TRY(attention_bwd_tc(s, pl + 3 * GEMM_PLAN, (P)q, (P)k, (P)v, (P)dctx, (bf16*)dq, (bf16*)dk,
                       (bf16*)dv, (float*)part, (float*)stats, B, N, Nkv, C, heads));
  TRY((wg_linear<Pro::kPlain, Epi::kPlain, true>(s, pl + 2 * GEMM_PLAN, (P)dq, (P)wq, nullptr,
                                                 nullptr, nullptr, nullptr, 0, dxln, C, M, C, C)));
  return (int)cudaGetLastError();
}

// The graph glue's LayerNorm (glue_layernorm_rows): x [M, C] bf16 in rows of
// stride ld (a multiple of 8, 16-byte aligned), g, b [C] fp32 -> y [M, C]
// bf16, for C a multiple of 8 up to LN_MAX_K. The lane group follows C: the
// C/8 vectors of a row rounded up to a power of two lanes, at most a warp,
// with two vectors per lane past 256.
int glue_layernorm(const void* x, const void* g, const void* b, void* y, int M, int C, int ld,
                   void* stream) {
  if (M < 1 || C < 8 || C > LN_MAX_K || C % 8 || ld < C || ld % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  typedef const bf16* P;
  typedef const float* F;
  const int nvec = C / 8;
  if (nvec <= 1) return glue_layernorm_launch<1, 1>(s, (P)x, (F)g, (F)b, (bf16*)y, M, C, ld);
  if (nvec <= 2) return glue_layernorm_launch<2, 1>(s, (P)x, (F)g, (F)b, (bf16*)y, M, C, ld);
  if (nvec <= 4) return glue_layernorm_launch<4, 1>(s, (P)x, (F)g, (F)b, (bf16*)y, M, C, ld);
  if (nvec <= 8) return glue_layernorm_launch<8, 1>(s, (P)x, (F)g, (F)b, (bf16*)y, M, C, ld);
  if (nvec <= 16) return glue_layernorm_launch<16, 1>(s, (P)x, (F)g, (F)b, (bf16*)y, M, C, ld);
  if (nvec <= 32) return glue_layernorm_launch<32, 1>(s, (P)x, (F)g, (F)b, (bf16*)y, M, C, ld);
  return glue_layernorm_launch<32, 2>(s, (P)x, (F)g, (F)b, (bf16*)y, M, C, ld);
}

}  // extern "C"
