// Mamba S6 selective scan for Hopper (sm_90a), split over time.
//
// Replaces surgical_tpu/kernels/selective_scan.py::selective_scan_pallas
// (body _scan_kernel), batched over videos instead of vmapped:
//
//   h_t[d, n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[d, n] + dt_t[d] * x_t[d] * B_t[n]
//   y_t[d]    = sum_n h_t[d, n] * C_t[n] + D[d] * x_t[d]
//
// x, dt, y [Bt, T, D]; A [D, N]; B, C [Bt, T, N]; D [D]; all fp32, state fp32
// from zero. N is MambaConfig()'s d_state, 64: the one width the path runs
// and the card checks.
//
// Design. The Pallas kernel walks a sequential grid of 128-step chunks,
// carrying the [D, N] state in VMEM; a CUDA grid has no order. Here time is
// cut into chunks of L steps (a multiple of 32, from the wrapper), and the
// grid is (video x channel group, chunk), so a 6000-frame video at D = 128
// fills the card instead of 32 SMs. The map h -> a_t h + b_t composes, so
// over a chunk c it is h -> Lambda_c h + S_c, with Lambda_c = prod_t
// exp(dt_t A) and S_c the chunk's end state from zero. Two launches:
//   1. selective_scan_chunk_kernel<false> scans every chunk but the last
//      from zero and writes (Lambda_c, S_c) to an fp32 workspace
//      [2][Bt][chunks - 1][D][N];
//   2. selective_scan_chunk_kernel<true> folds the pairs of the chunks
//      before its own, h_in(c + 1) = Lambda_c h_in(c) + S_c from h_in(0) = 0
//      (in chunk order: no flags, the same bits every run), then reruns its
//      chunk from h_in(c) and writes y.
// A video of at most L steps is one chunk: launch 2 alone, from zero. For
// the backward (below), launch 2 can also write the state at the start of
// every 32-step sub-chunk it reruns: the backward then reruns each
// sub-chunk from there instead of scanning its chunk again.
//
// Within a chunk, one warp owns one (video, channel d): each lane holds
// NS = N/32 = 2 states in registers and steps them in order. A block is
// WARPS channels of one video, which share every B_t/C_t row: the block
// stages each 32-step sub-chunk of B, C (and its channels' x, dt) in shared
// memory with coalesced loads issued while the previous sub-chunk computes,
// zero past the chunk's end (dt = 0 leaves the state as it is). In launch 2
// each lane keeps its 32 partial dot products h_t . C_t of a sub-chunk in
// registers, and one butterfly over the warp (31 shuffles) leaves lane i
// with y of step i, off the critical path of the steps. exp is expf, not
// __expf, so the state keeps fp32 accuracy over thousands of steps; the
// chunked form changes only where the products round.
//
// Bound on this card (H100 SXM): per (t, d, n) one exp (an SFU op, 16 per
// SM per clock) and ~5 fp32 flops against 4 bytes per (t, d) of x, dt, y and
// per (t, n) of B, C, so the SFU rate bounds it (PERF.md has the
// arithmetic). The split costs a second exp per (t, d, n) (launch 2 reruns
// what launch 1 scanned) and the fold's reads of the earlier chunks' pairs,
// for parallelism over time: one warp per (video, channel) walking all T
// steps left most SMs idle and nothing to hide each step's latency.

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;    // channels per block
constexpr int TC = 32;      // time steps per sub-chunk: one per lane in the y reduction
constexpr int N = 64;       // d_state
constexpr int NS = N / 32;  // states per lane

// One step of the butterfly reduce-scatter over part[S] (see below), with
// offset O: a constant trip count, so part stays in registers. After the
// steps with offsets S/2 .. 1, part[0] holds the sum over the lanes that
// share bits >= log2(S) of the lane index, for entry (lane & (S - 1)).
template <int O, int S>
__device__ __forceinline__ void butterfly_step(float (&part)[S], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = upper ? part[k] : part[k + O];
    const float keep = upper ? part[k + O] : part[k];
    part[k] = keep + __shfl_xor_sync(FULL_MASK, send, O);
  }
}

// One chunk of one block's WARPS channels. OUT false: scan from zero and
// write (Lambda_c, S_c) to `pairs`. OUT true: fold the earlier chunks'
// pairs into h_in, rerun the chunk from it and write y, and where `states`
// is not null each 32-step sub-chunk's start state h (for the backward).
template <bool OUT>
__global__ void __launch_bounds__(WARPS * 32)
selective_scan_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ A, const float* __restrict__ Bm,
                            const float* __restrict__ Cm, const float* __restrict__ Dv,
                            float* __restrict__ y, float* __restrict__ pairs,
                            float* __restrict__ states, int T, int D, int L,
                            int blocks_per_video) {
  __shared__ float sB[TC * N];
  __shared__ float sC[OUT ? TC * N : 1];
  __shared__ float sx[TC * WARPS];
  __shared__ float sdt[TC * WARPS];

  const int video = blockIdx.x / blocks_per_video;
  const int d0 = (blockIdx.x % blocks_per_video) * WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = d0 + warp;
  const bool live = d < D;
  const int chunk = blockIdx.y, chunks = (T + L - 1) / L;
  const int t_begin = chunk * L, t_end = min(T, t_begin + L);
  // pairs [2][Bt][chunks - 1][D][N]: Lambda, then S
  const size_t pair_stride = (size_t)gridDim.x / blocks_per_video * (chunks - 1) * D * N;
  auto pair_at = [&](int c) {
    return ((size_t)video * (chunks - 1) + c) * D * N + (size_t)d * N;
  };

  float a_row[NS], h[NS], lam[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a_row[j] = live ? A[(size_t)d * N + lane + 32 * j] : 0.f;
    h[j] = 0.f;
    lam[j] = 1.f;
  }
  if constexpr (OUT) {
    if (live) {  // h_in(chunk) from the pairs of chunks 0 .. chunk - 1, in order
#pragma unroll 8
      for (int c = 0; c < chunk; ++c) {  // unrolled: the loads of 8 pairs in flight at once
        const size_t p = pair_at(c);
#pragma unroll
        for (int j = 0; j < NS; ++j)
          h[j] = pairs[p + lane + 32 * j] * h[j] + pairs[pair_stride + p + lane + 32 * j];
      }
    }
  }
  const float skip = live ? Dv[d] : 0.f;

  // The next sub-chunk's B, C, x, dt rows travel to registers while this
  // one computes (each thread loads a fixed share: PER of the TC x N rows of
  // B and of C, one of the TC x WARPS values of x and of dt), then go to
  // shared memory between the two barriers. Zero past the chunk's end.
  constexpr int THREADS = WARPS * 32, PER = TC * N / THREADS;
  static_assert(TC * WARPS == THREADS, "one x and one dt value per thread");
  static_assert(PER * THREADS == TC * N, "every thread loads the same share of B, C");
  const size_t row0 = (size_t)video * T;
  const int xw = threadIdx.x % WARPS, xt = threadIdx.x / WARPS;
  float rb[PER], rc[PER], rx, rdt;
  auto fetch = [&](int t0) {
    const int valid = min(TC, t_end - t0) * N;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = threadIdx.x + r * THREADS;
      const size_t g = (row0 + t0) * N + i;
      rb[r] = i < valid ? Bm[g] : 0.f;
      if constexpr (OUT) rc[r] = i < valid ? Cm[g] : 0.f;
    }
    const bool ok = t0 + xt < t_end && d0 + xw < D;
    const size_t g = (row0 + t0 + xt) * D + d0 + xw;
    rx = ok ? x[g] : 0.f;
    rdt = ok ? dt[g] : 0.f;
  };
  fetch(t_begin);
  for (int t0 = t_begin; t0 < t_end; t0 += TC) {
    const int tc = min(TC, t_end - t0);
    if (OUT && states != nullptr && live) {  // states [Bt][ceil(T / TC)][D][N]
      const size_t o = (((size_t)video * ((T + TC - 1) / TC) + t0 / TC) * D + d) * N + lane;
#pragma unroll
      for (int j = 0; j < NS; ++j) states[o + 32 * j] = h[j];
    }
    __syncthreads();  // the previous sub-chunk is consumed
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = threadIdx.x + r * THREADS;
      sB[i] = rb[r];
      if constexpr (OUT) sC[i] = rc[r];
    }
    sx[threadIdx.x] = rx;
    sdt[threadIdx.x] = rdt;
    __syncthreads();
    if (t0 + TC < t_end) fetch(t0 + TC);
    if (!live) continue;

    if constexpr (!OUT) {
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) {
        const float dv = sdt[tt * WARPS + warp];
        const float dx = dv * sx[tt * WARPS + warp];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float a = expf(dv * a_row[j]);
          h[j] = a * h[j] + dx * sB[tt * N + lane + 32 * j];
          lam[j] *= a;
        }
      }
    } else {
      float part[TC];  // this lane's share of h_t . C_t, per step of the sub-chunk
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) {
        const float dv = sdt[tt * WARPS + warp];
        const float dx = dv * sx[tt * WARPS + warp];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int n = lane + 32 * j;
          const float a = expf(dv * a_row[j]);
          h[j] = a * h[j] + dx * sB[tt * N + n];
          acc += h[j] * sC[tt * N + n];
        }
        part[tt] = acc;
      }
      // Butterfly reduce-scatter: after the step with offset o, part[k] holds
      // the sum over lanes that differ in bits >= o of step k + (lane & ~(o-1)
      // & 31); at the end part[0] is y of step `lane` without the skip term.
      butterfly_step<16>(part, lane);
      butterfly_step<8>(part, lane);
      butterfly_step<4>(part, lane);
      butterfly_step<2>(part, lane);
      butterfly_step<1>(part, lane);
      if (lane < tc)
        y[(row0 + t0 + lane) * D + d] = part[0] + skip * sx[lane * WARPS + warp];
    }
  }
  if constexpr (!OUT) {
    if (live) {
      const size_t p = pair_at(chunk);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        pairs[p + lane + 32 * j] = lam[j];
        pairs[pair_stride + p + lane + 32 * j] = h[j];
      }
    }
  }
}


// ---------------------------------------------------------------------------
// Backward. No TPU kernel corresponds: the JAX package differentiates its
// XLA associative scan (surgical_tpu/kernels/selective_scan.py:62-67). With
// a_t = exp(dt_t A) and lambda_t the gradient of the loss in h_t,
//
//   lambda_t = dy_t C_t + a_{t+1} lambda_{t+1}        (backwards in time)
//   dx_t  = dt_t sum_n lambda_t B_t + D dy_t
//   ddt_t = sum_n lambda_t (A a_t h_{t-1} + B_t x_t)
//   dA    = sum_t lambda_t a_t h_{t-1} dt_t,  dD = sum_t dy_t x_t
//   dB_t  = sum_d lambda_t dt_t x_t,         dC_t = sum_d dy_t h_t
//
// Design. The states come from the forward: under autograd its second
// launch writes each 32-step sub-chunk's start state h (`states`
// [Bt][ceil(T / 32)][D][N]), which it passes through anyway. So the
// backward needs nothing of the forward's chunking and cuts time its own
// way: into chunks of K2 sub-chunks, K2 chosen by the wrapper so that the
// clusters below fill the card in whole waves. Let g_c be what the steps
// after chunk c hand back into its last step: g_c = a_s' lambda_s' (s' the
// first step after the chunk). Inside a chunk [s, e], lambda_e = dy_e C_e +
// g_c, and the map g_c -> g_{c-1} = a_s lambda_s is affine with the decay
// prod_{t=s}^{e} a_t; the same holds for every sub-chunk. Three launches:
//   B1. selective_scan_bwd_chunk_kernel: every sub-chunk after the first
//       chunk, one per CTA row, from g = 0, backwards, into its (decay,
//       Q = a_s lambda_s) pair;
//   B2. selective_scan_bwd_kernel: one thread-block cluster per (video,
//       chunk), its CTAs the channel blocks of 16 channels (one warp each).
//       Each warp folds B1's pairs of the sub-chunks after its chunk, last
//       first, into g, then walks its sub-chunks backwards: reruns one
//       forwards from its start state, keeping a_t (32 steps x 2 states per
//       lane, registers) and h_t (a shared-memory tile), then steps lambda
//       back with the same a_t: one exp per (t, d, n). The next sub-chunk's
//       rows and states arrive by cp.async meanwhile. dx and ddt reduce over
//       n in the warp (butterflies over 8 steps at a time) and leave
//       through a shared tile in rows of 16 channels; dA and dD sum over the
//       chunk in registers; dB and dC sum over the CTA's channels in channel
//       order (four states per thread, unrolled) into a [32, 64] tile per
//       sub-chunk, double-buffered. Each CTA arrives at a cluster barrier
//       once its tiles are written and waits on it after the next
//       sub-chunk's rerun; then it sums its share of the tiles' elements
//       over the cluster's tiles (distributed shared memory), in rank
//       order, and writes dB and dC.
//   B3. selective_scan_bwd_reduce_kernel: sums dA and dD over the videos
//       and chunks, in a fixed order.
// No atomics and no memset: the same inputs give the same bits every run.
//
// Bound on this card: per (t, d, n) an exp (B1 and B2 one each) and ~16
// fp32 flops, against ~5 bytes per (t, d) and ~8 per (t, n) of inputs and
// outputs: the SFU and FP32 pipes bound it (PERF.md). exp is expf, as in the
// forward; the state and the adjoint are fp32, and a_t is never inverted
// (exp(dt A) underflows). The scratch is the adjoint's pairs and the dA, dD
// partials: dB and dC never leave the chip before they are summed.

constexpr int BWD_WARPS = 8;  // B1: channels per block
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int CL_WARPS = 16;  // B2: channels per CTA of a cluster
constexpr int CL_THREADS = CL_WARPS * 32;
constexpr int CL_MAX = 8;     // CTAs per cluster at most (the portable size): D <= 128
constexpr int RQ = 8;         // steps per butterfly of dx, ddt
static_assert(TC * CL_WARPS == CL_THREADS, "one (step, 4 states) of a tile per thread");
static_assert(TC % RQ == 0 && RQ <= 32, "butterfly groups tile the sub-chunk");

// B2's dynamic shared memory, in floats: two stage buffers (the sub-chunk
// being computed and the next one in flight by cp.async), each rows of B
// and C [TC][N], the channels' x, dt, dy [TC][CL_WARPS] and start states
// [CL_WARPS][N]; x, dt, dy again per channel [3][CL_WARPS][CL_TP], so that
// a warp reads four steps' values in one broadcast; one [TC][N] tile per
// warp (h_t, then lambda_t); dx and ddt [TC][CL_WARPS]; and the dB, dC
// tiles [2 buffers][2][TC][N] that the cluster reads.
constexpr int CL_RED = TC * N;
constexpr int CL_STAGE = 2 * TC * N + 3 * TC * CL_WARPS + CL_WARPS * N;
constexpr int CL_TP = TC + 4;  // row of a channel's step scalars: 16-byte rows, 2-way banks
constexpr int CL_SMEM_FLOATS = 2 * CL_STAGE + 3 * CL_WARPS * CL_TP + CL_WARPS * TC * N +
                               2 * TC * CL_WARPS + 4 * CL_RED;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// B1: the adjoint pair (Lambda_s, Q_s) of sub-chunk s = blockIdx.y + first,
// from g = 0, into bpairs [2][Bt][subs - first][D][N] at index s - first:
// every sub-chunk after B2's first chunk, one per CTA row.
__global__ void __launch_bounds__(BWD_THREADS)
selective_scan_bwd_chunk_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                                const float* __restrict__ Cm, const float* __restrict__ dy,
                                float* __restrict__ bpairs, int T, int D, int first,
                                int blocks_per_video) {
  constexpr int PER = TC * N / BWD_THREADS;
  static_assert(TC * BWD_WARPS == BWD_THREADS, "one dt and one dy value per thread");
  __shared__ float sC[TC * N];
  __shared__ float sdt[TC * BWD_WARPS];
  __shared__ float sdy[TC * BWD_WARPS];
  const int video = blockIdx.x / blocks_per_video;
  const int d0 = (blockIdx.x % blocks_per_video) * BWD_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = d0 + warp;
  const int subs = (T + TC - 1) / TC, s = blockIdx.y + first;
  const int t0 = s * TC, rows = min(TC, T - t0);
  const size_t row0 = (size_t)video * T;
#pragma unroll
  for (int r = 0; r < PER; ++r) {  // zero past the video's end and past D
    const int i = threadIdx.x + r * BWD_THREADS;
    sC[i] = i < rows * N ? Cm[(row0 + t0) * N + i] : 0.f;
  }
  {
    const int xw = threadIdx.x % BWD_WARPS, xt = threadIdx.x / BWD_WARPS;
    const bool ok = xt < rows && d0 + xw < D;
    const size_t g = (row0 + t0 + xt) * D + d0 + xw;
    sdt[threadIdx.x] = ok ? dt[g] : 0.f;
    sdy[threadIdx.x] = ok ? dy[g] : 0.f;
  }
  __syncthreads();
  if (d >= D) return;

  float a_row[NS], carry[NS], decay[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a_row[j] = A[(size_t)d * N + lane + 32 * j];
    carry[j] = 0.f;
    decay[j] = 1.f;
  }
#pragma unroll
  for (int tt = TC - 1; tt >= 0; --tt) {
    const float dv = sdt[tt * BWD_WARPS + warp], g = sdy[tt * BWD_WARPS + warp];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float a = expf(dv * a_row[j]);
      const float lam = g * sC[tt * N + lane + 32 * j] + carry[j];
      carry[j] = a * lam;
      decay[j] *= a;
    }
  }
  const size_t stride = (size_t)gridDim.x / blocks_per_video * (subs - first) * D * N;
  const size_t p = ((size_t)video * (subs - first) + s - first) * D * N + (size_t)d * N;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    bpairs[p + lane + 32 * j] = decay[j];
    bpairs[stride + p + lane + 32 * j] = carry[j];
  }
}

// The butterfly over RQ = 8 steps' entries, then the shuffles over the
// remaining lane bits: every lane gets the warp's sum for step (lane & 7).
__device__ __forceinline__ float reduce_scatter8(float (&part)[RQ], int lane) {
  static_assert(RQ == 8, "the steps below are those of 8 entries");
  butterfly_step<4>(part, lane);
  butterfly_step<2>(part, lane);
  butterfly_step<1>(part, lane);
  float v = part[0];
  v += __shfl_xor_sync(FULL_MASK, v, 8);
  v += __shfl_xor_sync(FULL_MASK, v, 16);
  return v;
}

// acc[0..3] += c[w] * tile row w (4 floats at `off` of warp w's tile), for
// w = 0 .. CL_WARPS - 1 in order: one CTA's channel sum of a [TC][N] tile.
__device__ __forceinline__ float4 channel_sum(const float (&c)[CL_WARPS], const float* tiles,
                                              int off) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < CL_WARPS; ++w) {
    const float4 v = *reinterpret_cast<const float4*>(tiles + w * TC * N + off);
    acc.x += c[w] * v.x;
    acc.y += c[w] * v.y;
    acc.z += c[w] * v.z;
    acc.w += c[w] * v.w;
  }
  return acc;
}

// The CTA's CL_WARPS values of one step (a row of a [TC][CL_WARPS] tile),
// by 16-byte loads.
__device__ __forceinline__ void load_row(float (&c)[CL_WARPS], const float* row) {
#pragma unroll
  for (int q = 0; q < CL_WARPS / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(row)[q];
    c[4 * q] = v.x, c[4 * q + 1] = v.y, c[4 * q + 2] = v.z, c[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ float pick(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// B2: one chunk (blockIdx.y) of K2 sub-chunks of CL_WARPS channels of one
// video; the cluster's CTAs (ranks 0 .. cl - 1 along blockIdx.x) hold the
// video's channel blocks in order. D is a multiple of 4 (16-byte rows of x,
// dt, dy). Warps past D compute on zeros (their tiles stay zero) and write
// nothing.
__global__ void __launch_bounds__(CL_THREADS, 1)
selective_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ Dv,
                          const float* __restrict__ dy, const float* __restrict__ states,
                          const float* __restrict__ bpairs, float* __restrict__ dx,
                          float* __restrict__ ddt, float* __restrict__ dB,
                          float* __restrict__ dC, float* __restrict__ part_dA,
                          float* __restrict__ part_dD, int Bt, int T, int D, int K2) {
  constexpr int W = CL_WARPS;
  extern __shared__ __align__(16) float smem[];
  float* const tT = smem + 2 * CL_STAGE;       // x, dt, dy [3][W][CL_TP]
  float* const hs_all = tT + 3 * W * CL_TP;    // [W][TC][N]
  float* const sdx = hs_all + W * TC * N;      // [TC][W]
  float* const sddt = sdx + TC * W;
  float* const red = sddt + TC * W;  // [buffer][dB, dC][TC][N]

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int video = blockIdx.x / cl;
  const int d0 = rank * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = d0 + warp;
  const bool live = d < D;
  const int chunk = blockIdx.y;
  const int subs = (T + TC - 1) / TC;  // sub-chunks of the video
  const int t_begin = chunk * K2 * TC, t_end = min(T, t_begin + K2 * TC);
  const size_t row0 = (size_t)video * T;
  const int n_pairs = max(0, subs - K2);  // B1's pairs per (video, channel)
  const size_t pair_stride = (size_t)Bt * n_pairs * D * N;
  float* const hs = hs_all + warp * TC * N;  // this warp's tile
  const float* const xT = tT + warp * CL_TP;
  const float* const dtT = tT + (W + warp) * CL_TP;
  const float* const dyT = tT + (2 * W + warp) * CL_TP;

  // cp.async of sub-chunk t0 into a stage buffer, zero past the video's end
  // and past D; one commit group per sub-chunk
  auto prefetch = [&](float* st, int t0) {
    const int rows = min(TC, T - t0);
    {  // B and C rows: one 16-byte piece of each per thread
      const bool ok = tid / (N / 4) < rows;
      const size_t g = (row0 + t0) * N + 4 * tid;
      cp_async16(smem_addr(st + 4 * tid), ok ? Bm + g : Bm, ok);
      cp_async16(smem_addr(st + TC * N + 4 * tid), ok ? Cm + g : Cm, ok);
    }
    if (tid < 3 * TC * W / 4) {  // x, dt, dy [TC][W]
      const int which = tid / (TC * W / 4), q = tid % (TC * W / 4);
      const int r = q / (W / 4), c4 = 4 * (q % (W / 4));
      const bool ok = r < rows && d0 + c4 < D;
      const float* src = which == 0 ? x : which == 1 ? dt : dy;
      const size_t g = (row0 + t0 + r) * D + d0 + c4;
      cp_async16(smem_addr(st + 2 * TC * N + which * TC * W + 4 * q), ok ? src + g : src, ok);
    }
    if (tid < W * N / 4) {  // the start states [W][N]
      const int w = tid / (N / 4);
      const bool ok = d0 + w < D;
      const size_t g = (((size_t)video * subs + t0 / TC) * D + d0 + w) * N + 4 * (tid % (N / 4));
      cp_async16(smem_addr(st + 2 * TC * N + 3 * TC * W + 4 * tid), ok ? states + g : states, ok);
    }
    cp_async_commit();
  };

  float a_row[NS], carry[NS], dA_acc[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a_row[j] = live ? A[(size_t)d * N + lane + 32 * j] : 0.f;
    carry[j] = 0.f;
    dA_acc[j] = 0.f;
  }
  int t0 = t_begin + (t_end - 1 - t_begin) / TC * TC;
  prefetch(smem, t0);
  if (live) {  // g: B1's pairs of the sub-chunks after this chunk, last first
    const size_t base = (size_t)video * n_pairs * D * N + (size_t)d * N + lane;
#pragma unroll 8
    for (int s = subs - 1; s >= (chunk + 1) * K2; --s) {
      const size_t p = base + (size_t)(s - K2) * D * N;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        carry[j] = bpairs[p + 32 * j] * carry[j] + bpairs[pair_stride + p + 32 * j];
    }
  }
  const float skip = live ? Dv[d] : 0.f;
  const int share = (CL_RED + cl - 1) / cl;  // tile elements this CTA sums over the cluster
  const int e0 = rank * share, e1 = min(CL_RED, e0 + share);
  // dB, dC of the sub-chunk whose tiles are in `red` buffer rb: the cluster's
  // tiles summed in rank order, this CTA's share of the elements
  auto cluster_reduce = [&](int rb, int s0, int rows) {
    const float* tile = red + rb * 2 * CL_RED;
    for (int i = e0 + tid; i < e1; i += CL_THREADS) {
      if (i / N >= rows) break;
      float rb_[CL_MAX], rc_[CL_MAX];  // every rank's load in flight, then the sums in order
#pragma unroll
      for (int r = 0; r < CL_MAX; ++r) {
        const float* remote = cluster.map_shared_rank(tile, r < cl ? r : 0);
        rb_[r] = remote[i];
        rc_[r] = remote[CL_RED + i];
      }
      float b = 0.f, c = 0.f;
#pragma unroll
      for (int r = 0; r < CL_MAX; ++r)
        if (r < cl) b += rb_[r], c += rc_[r];
      const size_t o = (row0 + s0) * N + i;
      dB[o] = b;
      dC[o] = c;
    }
  };

  float dD_acc = 0.f;
  int sb = 0, rb = 0, prev_t0 = -1, prev_rows = 0;
  for (; t0 >= t_begin; t0 -= TC, sb ^= 1, rb ^= 1) {
    const int tc = min(TC, t_end - t0);
    cp_async_wait<0>();
    __syncthreads();  // this sub-chunk's stage has landed; the other buffer is free
    if (t0 - TC >= t_begin) prefetch(smem + (sb ^ 1) * CL_STAGE, t0 - TC);
    const float* sB = smem + sb * CL_STAGE;
    const float* sC = sB + TC * N;
    const float* sx = sC + TC * N;  // [TC][W]
    const float* sdt = sx + TC * W;
    const float* sdy = sdt + TC * W;
    const float* sh0 = sdy + TC * W;  // [W][N]
    {  // each channel's x, dt, dy in a row of its own
      const int tt = tid / W, w = tid % W;
      tT[w * CL_TP + tt] = sx[tid];
      tT[(W + w) * CL_TP + tt] = sdt[tid];
      tT[(2 * W + w) * CL_TP + tt] = sdy[tid];
    }
    __syncthreads();

    float h0[NS], h[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) h[j] = h0[j] = sh0[warp * N + lane + 32 * j];
    float a[TC][NS];  // a_t of the sub-chunk: the rerun's exps, reused by the adjoint
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) {  // rerun: h_t of every step into the tile
      const float4 dt4 = reinterpret_cast<const float4*>(dtT)[q];
      const float4 x4 = reinterpret_cast<const float4*>(xT)[q];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int tt = 4 * q + r;
        const float dv = pick(dt4, r);
        const float dxv = dv * pick(x4, r);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int n = lane + 32 * j;
          a[tt][j] = expf(dv * a_row[j]);
          h[j] = a[tt][j] * h[j] + dxv * sB[tt * N + n];
          hs[tt * N + n] = h[j];
        }
      }
    }
    if (prev_t0 >= 0) {  // the previous sub-chunk's tiles, behind this rerun
      cluster_wait();
      cluster_reduce(rb ^ 1, prev_t0, prev_rows);
    }
    __syncthreads();
    float* const tile_dB = red + rb * 2 * CL_RED;
    float* const tile_dC = tile_dB + CL_RED;
    const int ct = tid / (N / 4), off = ct * N + 4 * (tid % (N / 4));  // (step, 4 states)
    {  // dC_t = sum_d dy_t h_t over the CTA's channels, in channel order
      float c[W];
      load_row(c, sdy + ct * W);
      *reinterpret_cast<float4*>(tile_dC + off) = channel_sum(c, hs_all, off);
    }
    __syncthreads();  // dC has read h_t: the tiles now take lambda_t
#pragma unroll
    for (int grp = TC / RQ - 1; grp >= 0; --grp) {
      float p1[RQ], p2[RQ];  // per step: sum_n lambda B, sum_n lambda A a h_{t-1} (this lane's n)
#pragma unroll
      for (int q = RQ / 4 - 1; q >= 0; --q) {
        const float4 dt4 = reinterpret_cast<const float4*>(dtT)[grp * RQ / 4 + q];
        const float4 dy4 = reinterpret_cast<const float4*>(dyT)[grp * RQ / 4 + q];
#pragma unroll
        for (int r = 3; r >= 0; --r) {
          const int k = 4 * q + r, tt = grp * RQ + k;
          const float dv = pick(dt4, r), g = pick(dy4, r);
          float acc1 = 0.f, acc2 = 0.f;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const int n = lane + 32 * j;
            const float h_prev = tt > 0 ? hs[(tt - 1) * N + n] : h0[j];
            const float lam = g * sC[tt * N + n] + carry[j];
            const float u = lam * a[tt][j] * h_prev;
            acc1 += lam * sB[tt * N + n];
            acc2 += u * a_row[j];
            dA_acc[j] += u * dv;
            carry[j] = a[tt][j] * lam;
            hs[tt * N + n] = lam;  // h_t was last read as step t + 1's h_{t-1}
          }
          p1[k] = acc1;
          p2[k] = acc2;
        }
      }
      const float s1 = reduce_scatter8(p1, lane), s2 = reduce_scatter8(p2, lane);
      if (lane < RQ) {  // lane holds step grp * RQ + lane
        const int tt = grp * RQ + lane;
        const float dv = dtT[tt], xv = xT[tt], g = dyT[tt];
        sdx[tt * W + warp] = dv * s1 + skip * g;
        sddt[tt * W + warp] = s2 + xv * s1;
        dD_acc += g * xv;  // zero past the chunk's end
      }
    }
    __syncthreads();
    {  // dx, ddt in rows of the CTA's channels
      const int tt = tid / W, w = tid % W;
      if (tt < tc && d0 + w < D) {
        const size_t o = (row0 + t0 + tt) * D + d0 + w;
        dx[o] = sdx[tid];
        ddt[o] = sddt[tid];
      }
    }
    {  // dB_t = sum_d lambda_t dt_t x_t over the CTA's channels, in channel order
      float c[W], cx[W];
      load_row(c, sdt + ct * W);
      load_row(cx, sx + ct * W);
#pragma unroll
      for (int w = 0; w < W; ++w) c[w] *= cx[w];
      *reinterpret_cast<float4*>(tile_dB + off) = channel_sum(c, hs_all, off);
    }
    cluster_arrive();  // this CTA's tiles of the sub-chunk are written
    prev_t0 = t0;
    prev_rows = tc;
  }
  cluster_wait();
  cluster_reduce(rb ^ 1, prev_t0, prev_rows);
  cluster_arrive();  // no CTA leaves while another reads its tiles
  cluster_wait();
  if (live) {
    const size_t q = (size_t)video * gridDim.y + chunk;
#pragma unroll
    for (int j = 0; j < NS; ++j) part_dA[(q * D + d) * N + lane + 32 * j] = dA_acc[j];
    dD_acc = warp_sum(dD_acc);
    if (lane == 0) part_dD[q * D + d] = dD_acc;
  }
}

// B3: dA and dD, each element summing its partials over the videos and
// chunks in order.
__global__ void selective_scan_bwd_reduce_kernel(const float* __restrict__ part_dA,
                                                 const float* __restrict__ part_dD,
                                                 float* __restrict__ dA, float* __restrict__ dD,
                                                 int D, int parts) {
  const size_t n_a = (size_t)D * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_a) {
    float a = 0.f;
    for (int q = 0; q < parts; ++q) a += part_dA[q * n_a + i];
    dA[i] = a;
  } else if (i < n_a + D) {
    const size_t j = i - n_a;
    float v = 0.f;
    for (int q = 0; q < parts; ++q) v += part_dD[q * (size_t)D + j];
    dD[j] = v;
  }
}

}  // namespace

extern "C" {

// x, dt, y [Bt, T, D]; A [D, N]; B, C [Bt, T, N]; D [D]; fp32, contiguous.
// `chunk` (L) is the chunk length, a positive multiple of 32
// (kernels/selective_scan.py::scan_chunk); `pairs` is fp32 scratch of
// 2 * Bt * (ceil(T / L) - 1) * D * N values, null when T <= L. `states`,
// null or [Bt, ceil(T / 32), D, N] fp32, receives each 32-step sub-chunk's
// start state for the backward. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for an N other than 64, a bad chunk
// length or missing scratch).
int selective_scan_forward(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* Dv, void* y, void* pairs, void* states,
                           int Bt, int T, int D, int n_state, int chunk, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  if (n_state != N || chunk < TC || chunk % TC) return (int)cudaErrorInvalidValue;
  if (Bt == 0 || T == 0 || D == 0) return (int)cudaGetLastError();
  const int chunks = (T + chunk - 1) / chunk;
  if (chunks > 65535 || (chunks > 1 && pairs == nullptr)) return (int)cudaErrorInvalidValue;
  const int bpv = (D + WARPS - 1) / WARPS;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunks > 1)
    selective_scan_chunk_kernel<false><<<dim3(Bt * bpv, chunks - 1), WARPS * 32, 0, s>>>(
        f(x), f(dt), f(A), f(B), f(C), f(Dv), (float*)y, (float*)pairs, nullptr, T, D, chunk,
        bpv);
  selective_scan_chunk_kernel<true><<<dim3(Bt * bpv, chunks), WARPS * 32, 0, s>>>(
      f(x), f(dt), f(A), f(B), f(C), f(Dv), (float*)y, (float*)pairs, (float*)states, T, D,
      chunk, bpv);
  return (int)cudaGetLastError();
}

// The gradient of selective_scan_forward at dy [Bt, T, D]: dx, ddt [Bt, T, D],
// dA [D, N], dB, dC [Bt, T, N], dD [D], fp32, contiguous; `states` is the
// forward's sub-chunk start states for the same inputs, `sub_chunks` (K2)
// the 32-step sub-chunks per chunk of the cluster launch
// (kernels/selective_scan.py::backward_chunk), `scratch` n_scratch fp32
// values laid out as kernels/selective_scan.py::backward_scratch_floats
// says. D is at most 16 x 8 (one cluster of channel blocks) and a multiple
// of 4. Returns cudaGetLastError() after the launches (cudaErrorInvalidValue
// for an N other than 64, a D the cluster cannot take, a bad chunk, missing
// states or too little scratch).
int selective_scan_backward(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* Dv, const void* dy, const void* states,
                            void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD,
                            void* scratch, int Bt, int T, int D, int n_state, int sub_chunks,
                            int n_scratch, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  if (n_state != N || sub_chunks < 1 || D > CL_WARPS * CL_MAX || D % 4)
    return (int)cudaErrorInvalidValue;
  if (Bt == 0 || T == 0 || D == 0) return (int)cudaGetLastError();
  const int subs = (T + TC - 1) / TC, K2 = sub_chunks;
  const int chunks = (subs + K2 - 1) / K2, n_b1 = subs > K2 ? subs - K2 : 0;
  if (chunks > 65535 || n_b1 > 65535 || states == nullptr) return (int)cudaErrorInvalidValue;
  const int bpv = (D + BWD_WARPS - 1) / BWD_WARPS;
  const int cl = (D + CL_WARPS - 1) / CL_WARPS;
  const size_t n_pairs = 2ull * Bt * n_b1 * D * N;
  const size_t n_dA = (size_t)Bt * chunks * D * N;
  if (n_pairs + n_dA + (size_t)Bt * chunks * D > (size_t)n_scratch)
    return (int)cudaErrorInvalidValue;
  float* bpairs = (float*)scratch;
  float* part_dA = bpairs + n_pairs;
  float* part_dD = part_dA + n_dA;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int smem = CL_SMEM_FLOATS * (int)sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      selective_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  if (n_b1 > 0)
    selective_scan_bwd_chunk_kernel<<<dim3(Bt * bpv, n_b1), BWD_THREADS, 0, s>>>(
        f(dt), f(A), f(C), f(dy), bpairs, T, D, K2, bpv);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Bt * cl, chunks);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = cl;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, selective_scan_bwd_kernel, f(x), f(dt), f(A), f(B),
                                     f(C), f(Dv), f(dy), f(states), (const float*)bpairs,
                                     (float*)dx, (float*)ddt, (float*)dB, (float*)dC, part_dA,
                                     part_dD, Bt, T, D, K2);
  if (e != cudaSuccess) return (int)e;
  const int total = D * N + D, threads = 256;
  selective_scan_bwd_reduce_kernel<<<(total + threads - 1) / threads, threads, 0, s>>>(
      part_dA, part_dD, (float*)dA, (float*)dD, D, Bt * chunks);
  return (int)cudaGetLastError();
}

// What the backward's cluster kernel (B2) holds on this card, for the
// record: out = [registers per thread, static shared bytes, dynamic shared
// bytes, local (spill) bytes per thread, CTAs per SM, clusters of `cl`
// CTAs active at once]. Returns a cudaError_t.
int selective_scan_backward_resources(int* out, int cl) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, selective_scan_bwd_kernel);
  if (e != cudaSuccess) return (int)e;
  constexpr int smem = CL_SMEM_FLOATS * (int)sizeof(float);
  e = cudaFuncSetAttribute(selective_scan_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, clusters = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, selective_scan_bwd_kernel,
                                                    CL_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = cl;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(&clusters, selective_scan_bwd_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = smem;
  out[3] = (int)fa.localSizeBytes;
  out[4] = per_sm;
  out[5] = clusters;
  return 0;
}

}  // extern "C"
