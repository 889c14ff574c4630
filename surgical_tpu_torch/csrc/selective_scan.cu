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
// A video of at most L steps is one chunk: launch 2 alone, from zero. The
// pairs are kept for the backward (below), which folds them into each
// chunk's carry-in instead of scanning the chunks before it again.
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

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;    // channels per block
constexpr int TC = 32;      // time steps per sub-chunk: one per lane in the y reduction
constexpr int N = 64;       // d_state
constexpr int NS = N / 32;  // states per lane

// One step of the butterfly reduce-scatter over part[TC] (see below), with
// offset O: a constant trip count, so part stays in registers.
template <int O>
__device__ __forceinline__ void butterfly_step(float (&part)[TC], int lane) {
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
// pairs into h_in, rerun the chunk from it and write y.
template <bool OUT>
__global__ void __launch_bounds__(WARPS * 32)
selective_scan_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ A, const float* __restrict__ Bm,
                            const float* __restrict__ Cm, const float* __restrict__ Dv,
                            float* __restrict__ y, float* __restrict__ pairs, int T, int D,
                            int L, int blocks_per_video) {
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
// Design, over the forward's chunks. Let g_c = a_s' lambda_s' be what the
// chunks after chunk c hand back into its last step (s' the first step of
// chunk c + 1). Inside a chunk [s, e], lambda_e = dy_e C_e + g_c, and the map
// g_c -> g_{c-1} = a_s lambda_s is affine with the decay prod_{t=s}^{e} a_t:
// the forward's Lambda_c, because the carry already holds the first step of
// the next chunk. Three launches:
//   B1. selective_scan_bwd_chunk_kernel: every chunk but the first, from
//       g = 0, backwards, into its (Lambda_c, Q_c = a_s lambda_s) pair;
//   B2. selective_scan_bwd_kernel: each chunk folds the forward's pairs
//       before it into h_in (as the forward's launch 2 does) and the
//       adjoint pairs after it, last first, into g; scans its chunk forwards
//       once, keeping each 32-step sub-chunk's start state in the scratch;
//       then walks the sub-chunks backwards: reruns one forwards from its
//       start state with every h_t in shared memory, then steps lambda
//       back through it. dx and ddt reduce over n in the warp (a butterfly,
//       as y in the forward); dA and dD sum over the chunk in registers;
//       dB and dC sum over the block's channels in shared memory, in
//       channel order, into per-block partials;
//   B3. selective_scan_bwd_reduce_kernel: sums the partials of dB and dC
//       over the blocks of a video, and those of dA and dD over the videos
//       and chunks, each in a fixed order.
// No atomics and no memset: the same inputs give the same bits every run.
// A block holds BWD_WARPS = 8 channels (one warp each, NS = 2 states per
// lane), so the dB and dC partials are 16 per video at d_inner = 128.
//
// Bound on this card: per (t, d, n) an exp (B1, and three in B2: the chunk
// scan, the rerun, the adjoint step) and ~16 fp32 flops, against ~5 bytes
// per (t, d) and ~8 per (t, n) of inputs and outputs: the SFU rate bounds
// it (PERF.md). exp is expf, as in the forward; the state and the adjoint
// are fp32, and a_t is never inverted (exp(dt A) underflows).

constexpr int BWD_WARPS = 8;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int BWD_PER = TC * N / BWD_THREADS;  // rows of B or C per thread per sub-chunk
static_assert(TC * BWD_WARPS == BWD_THREADS, "one x, dt and dy value per thread");
static_assert(BWD_PER * BWD_THREADS == TC * N, "every thread stages the same share");

// The backward's dynamic shared memory, in floats: B and C rows of a
// sub-chunk, one [TC][N] tile per warp (h_t, then lambda_t), and the
// channels' x, dt, dy.
constexpr int BWD_SMEM_FLOATS = 2 * TC * N + BWD_WARPS * TC * N + 3 * TC * BWD_WARPS;

struct BwdTile {
  float* sB;
  float* sC;
  float* hs;   // [BWD_WARPS][TC][N]
  float* sx;   // [TC][BWD_WARPS]
  float* sdt;
  float* sdy;
};

__device__ __forceinline__ BwdTile bwd_tile(float* smem) {
  BwdTile s;
  s.sB = smem;
  s.sC = s.sB + TC * N;
  s.hs = s.sC + TC * N;
  s.sx = s.hs + BWD_WARPS * TC * N;
  s.sdt = s.sx + TC * BWD_WARPS;
  s.sdy = s.sdt + TC * BWD_WARPS;
  return s;
}

// Stage the sub-chunk [t0, t0 + TC) of one video into shared memory: rows
// of B and/or C (null skips), and x, dt, dy of the block's channels; zero
// past t_end and past D (dt = 0 and dy = 0 leave the state and the adjoint
// as they are). Callers synchronize around it.
__device__ __forceinline__ void bwd_stage(float* sB, float* sC, float* sx, float* sdt,
                                          float* sdy, const float* Bm, const float* Cm,
                                          const float* x, const float* dt, const float* dy,
                                          size_t row0, int t0, int t_end, int d0, int D) {
  const int valid = min(TC, t_end - t0) * N;
#pragma unroll
  for (int r = 0; r < BWD_PER; ++r) {
    const int i = threadIdx.x + r * BWD_THREADS;
    const size_t g = (row0 + t0) * N + i;
    if (sB) sB[i] = i < valid ? Bm[g] : 0.f;
    if (sC) sC[i] = i < valid ? Cm[g] : 0.f;
  }
  const int xw = threadIdx.x % BWD_WARPS, xt = threadIdx.x / BWD_WARPS;
  const bool ok = t0 + xt < t_end && d0 + xw < D;
  const size_t g = (row0 + t0 + xt) * D + d0 + xw;
  if (sx) sx[threadIdx.x] = ok ? x[g] : 0.f;
  if (sdt) sdt[threadIdx.x] = ok ? dt[g] : 0.f;
  if (sdy) sdy[threadIdx.x] = ok ? dy[g] : 0.f;
}

// B1: the adjoint pair (Lambda_c, Q_c) of chunk c = blockIdx.y + 1, from
// g = 0, into bpairs [2][Bt][chunks - 1][D][N] at index c - 1.
__global__ void __launch_bounds__(BWD_THREADS)
selective_scan_bwd_chunk_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                                const float* __restrict__ Cm, const float* __restrict__ dy,
                                float* __restrict__ bpairs, int T, int D, int L,
                                int blocks_per_video) {
  __shared__ float sC[TC * N];
  __shared__ float sdt[TC * BWD_WARPS];
  __shared__ float sdy[TC * BWD_WARPS];
  const int video = blockIdx.x / blocks_per_video;
  const int d0 = (blockIdx.x % blocks_per_video) * BWD_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = d0 + warp;
  const bool live = d < D;
  const int chunk = blockIdx.y + 1, chunks = (T + L - 1) / L;
  const int t_begin = chunk * L, t_end = min(T, t_begin + L);
  const size_t row0 = (size_t)video * T;

  float a_row[NS], carry[NS], decay[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a_row[j] = live ? A[(size_t)d * N + lane + 32 * j] : 0.f;
    carry[j] = 0.f;
    decay[j] = 1.f;
  }
  for (int t0 = t_begin + (t_end - 1 - t_begin) / TC * TC; t0 >= t_begin; t0 -= TC) {
    __syncthreads();
    bwd_stage(nullptr, sC, nullptr, sdt, sdy, nullptr, Cm, nullptr, dt, dy, row0, t0, t_end,
              d0, D);
    __syncthreads();
    if (!live) continue;
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
  }
  if (live) {
    const size_t stride = (size_t)gridDim.x / blocks_per_video * (chunks - 1) * D * N;
    const size_t p = ((size_t)video * (chunks - 1) + chunk - 1) * D * N + (size_t)d * N;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      bpairs[p + lane + 32 * j] = decay[j];
      bpairs[stride + p + lane + 32 * j] = carry[j];
    }
  }
}

// B2: one chunk (blockIdx.y) of BWD_WARPS channels of one video.
__global__ void __launch_bounds__(BWD_THREADS)
selective_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ Dv,
                          const float* __restrict__ dy, const float* __restrict__ pairs,
                          const float* __restrict__ bpairs, float* __restrict__ hstart,
                          float* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ part_dB, float* __restrict__ part_dC,
                          float* __restrict__ part_dA, float* __restrict__ part_dD, int Bt,
                          int T, int D, int L, int blocks_per_video) {
  extern __shared__ float smem[];
  const BwdTile s = bwd_tile(smem);
  const int video = blockIdx.x / blocks_per_video, block = blockIdx.x % blocks_per_video;
  const int d0 = block * BWD_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = d0 + warp;
  const bool live = d < D;
  const int n_live = min(BWD_WARPS, D - d0);
  const int chunk = blockIdx.y, chunks = (T + L - 1) / L;
  const int t_begin = chunk * L, t_end = min(T, t_begin + L);
  const int subs = (T + TC - 1) / TC;  // sub-chunks of the video: hstart's time index
  const size_t row0 = (size_t)video * T;
  const size_t pair_stride = (size_t)Bt * (chunks - 1) * D * N;
  auto pair_at = [&](int c) {
    return ((size_t)video * (chunks - 1) + c) * D * N + (size_t)d * N;
  };
  float* hs = s.hs + warp * TC * N;  // this warp's tile

  float a_row[NS], h[NS], carry[NS], dA_acc[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a_row[j] = live ? A[(size_t)d * N + lane + 32 * j] : 0.f;
    h[j] = 0.f;
    carry[j] = 0.f;
    dA_acc[j] = 0.f;
  }
  if (live) {
    // h_in: the forward's pairs of chunks 0 .. chunk - 1, in order
    for (int c = 0; c < chunk; ++c) {
      const size_t p = pair_at(c);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        h[j] = pairs[p + lane + 32 * j] * h[j] + pairs[pair_stride + p + lane + 32 * j];
    }
    // g: the adjoint pairs of chunks chunks - 1 .. chunk + 1, last first
    for (int c = chunks - 1; c > chunk; --c) {
      const size_t p = pair_at(c - 1);
#pragma unroll
      for (int j = 0; j < NS; ++j)
        carry[j] = bpairs[p + lane + 32 * j] * carry[j] + bpairs[pair_stride + p + lane + 32 * j];
    }
  }
  const float skip = live ? Dv[d] : 0.f;
  auto hstart_at = [&](int t0) {
    return (((size_t)video * subs + t0 / TC) * D + d) * N;
  };

  // the chunk forwards once: each sub-chunk's start state to the scratch
  for (int t0 = t_begin; t0 < t_end; t0 += TC) {
    if (live) {
#pragma unroll
      for (int j = 0; j < NS; ++j) hstart[hstart_at(t0) + lane + 32 * j] = h[j];
    }
    __syncthreads();
    bwd_stage(s.sB, nullptr, s.sx, s.sdt, nullptr, Bm, nullptr, x, dt, nullptr, row0, t0, t_end,
              d0, D);
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      const float dv = s.sdt[tt * BWD_WARPS + warp];
      const float dxv = dv * s.sx[tt * BWD_WARPS + warp];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        h[j] = expf(dv * a_row[j]) * h[j] + dxv * s.sB[tt * N + lane + 32 * j];
    }
  }

  // the sub-chunks backwards
  float dD_acc = 0.f;
  const size_t part_row = ((size_t)block * Bt + video) * T;  // part_dB/dC [blocks][Bt][T][N]
  for (int t0 = t_begin + (t_end - 1 - t_begin) / TC * TC; t0 >= t_begin; t0 -= TC) {
    const int tc = min(TC, t_end - t0);
    __syncthreads();  // the previous sub-chunk's partials have read the tiles
    bwd_stage(s.sB, s.sC, s.sx, s.sdt, s.sdy, Bm, Cm, x, dt, dy, row0, t0, t_end, d0, D);
    __syncthreads();
    float h0[NS];
    if (live) {
#pragma unroll
      for (int j = 0; j < NS; ++j) h[j] = h0[j] = hstart[hstart_at(t0) + lane + 32 * j];
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) {  // rerun: h_t of every step into the tile
        const float dv = s.sdt[tt * BWD_WARPS + warp];
        const float dxv = dv * s.sx[tt * BWD_WARPS + warp];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int n = lane + 32 * j;
          h[j] = expf(dv * a_row[j]) * h[j] + dxv * s.sB[tt * N + n];
          hs[tt * N + n] = h[j];
        }
      }
    }
    __syncthreads();
    // dC_t = sum_d dy_t h_t over the block's channels, in channel order
    for (int i = threadIdx.x; i < tc * N; i += BWD_THREADS) {
      const int tt = i / N, n = i % N;
      float acc = 0.f;
      for (int w = 0; w < n_live; ++w)
        acc += s.sdy[tt * BWD_WARPS + w] * s.hs[(w * TC + tt) * N + n];
      part_dC[(part_row + t0 + tt) * N + n] = acc;
    }
    __syncthreads();  // dC has read h_t: the tiles now take lambda_t
    if (live) {
      float p1[TC], p2[TC];  // per step: sum_n lambda B, sum_n lambda A a h_{t-1} (this lane's n)
#pragma unroll
      for (int tt = TC - 1; tt >= 0; --tt) {
        const float dv = s.sdt[tt * BWD_WARPS + warp], g = s.sdy[tt * BWD_WARPS + warp];
        float acc1 = 0.f, acc2 = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int n = lane + 32 * j;
          const float a = expf(dv * a_row[j]);
          const float h_prev = tt > 0 ? hs[(tt - 1) * N + n] : h0[j];
          const float lam = g * s.sC[tt * N + n] + carry[j];
          const float u = lam * a * h_prev;
          acc1 += lam * s.sB[tt * N + n];
          acc2 += u * a_row[j];
          dA_acc[j] += u * dv;
          carry[j] = a * lam;
          hs[tt * N + n] = lam;  // h_t was last read as step t + 1's h_{t-1}
        }
        p1[tt] = acc1;
        p2[tt] = acc2;
      }
      butterfly_step<16>(p1, lane);
      butterfly_step<8>(p1, lane);
      butterfly_step<4>(p1, lane);
      butterfly_step<2>(p1, lane);
      butterfly_step<1>(p1, lane);
      butterfly_step<16>(p2, lane);
      butterfly_step<8>(p2, lane);
      butterfly_step<4>(p2, lane);
      butterfly_step<2>(p2, lane);
      butterfly_step<1>(p2, lane);
      if (lane < tc) {  // lane holds step t0 + lane
        const float dv = s.sdt[lane * BWD_WARPS + warp], xv = s.sx[lane * BWD_WARPS + warp];
        const float g = s.sdy[lane * BWD_WARPS + warp];
        const size_t o = (row0 + t0 + lane) * D + d;
        dx[o] = dv * p1[0] + skip * g;
        ddt[o] = p2[0] + xv * p1[0];
        dD_acc += g * xv;
      }
    }
    __syncthreads();
    // dB_t = sum_d lambda_t dt_t x_t over the block's channels, in channel order
    for (int i = threadIdx.x; i < tc * N; i += BWD_THREADS) {
      const int tt = i / N, n = i % N;
      float acc = 0.f;
      for (int w = 0; w < n_live; ++w)
        acc += s.sdt[tt * BWD_WARPS + w] * s.sx[tt * BWD_WARPS + w] * s.hs[(w * TC + tt) * N + n];
      part_dB[(part_row + t0 + tt) * N + n] = acc;
    }
  }
  if (live) {
    const size_t q = (size_t)video * chunks + chunk;
#pragma unroll
    for (int j = 0; j < NS; ++j) part_dA[(q * D + d) * N + lane + 32 * j] = dA_acc[j];
    dD_acc = warp_sum(dD_acc);
    if (lane == 0) part_dD[q * D + d] = dD_acc;
  }
}

// B3: each output element sums its partials in a fixed order: dB, dC over
// the blocks of its video; dA, dD over the videos and chunks.
__global__ void selective_scan_bwd_reduce_kernel(const float* __restrict__ part_dB,
                                                 const float* __restrict__ part_dC,
                                                 const float* __restrict__ part_dA,
                                                 const float* __restrict__ part_dD,
                                                 float* __restrict__ dB, float* __restrict__ dC,
                                                 float* __restrict__ dA, float* __restrict__ dD,
                                                 int Bt, int T, int D, int blocks, int chunks) {
  const size_t n_bc = (size_t)Bt * T * N, n_a = (size_t)D * N, n_d = D;
  const int q_count = Bt * chunks;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_bc + n_a + n_d;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n_bc) {
      float b = 0.f, c = 0.f;
      for (int p = 0; p < blocks; ++p) {
        b += part_dB[p * n_bc + i];
        c += part_dC[p * n_bc + i];
      }
      dB[i] = b;
      dC[i] = c;
    } else if (i < n_bc + n_a) {
      const size_t j = i - n_bc;
      float a = 0.f;
      for (int q = 0; q < q_count; ++q) a += part_dA[q * n_a + j];
      dA[j] = a;
    } else {
      const size_t j = i - n_bc - n_a;
      float v = 0.f;
      for (int q = 0; q < q_count; ++q) v += part_dD[q * n_d + j];
      dD[j] = v;
    }
  }
}

}  // namespace

extern "C" {

// x, dt, y [Bt, T, D]; A [D, N]; B, C [Bt, T, N]; D [D]; fp32, contiguous.
// `chunk` (L) is the chunk length, a positive multiple of 32
// (kernels/selective_scan.py::scan_chunk); `pairs` is fp32 scratch of
// 2 * Bt * (ceil(T / L) - 1) * D * N values, null when T <= L. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an N
// other than 64, a bad chunk length or missing scratch).
int selective_scan_forward(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* Dv, void* y, void* pairs, int Bt, int T,
                           int D, int n_state, int chunk, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  if (n_state != N || chunk < TC || chunk % TC) return (int)cudaErrorInvalidValue;
  if (Bt == 0 || T == 0 || D == 0) return (int)cudaGetLastError();
  const int chunks = (T + chunk - 1) / chunk;
  if (chunks > 65535 || (chunks > 1 && pairs == nullptr)) return (int)cudaErrorInvalidValue;
  const int bpv = (D + WARPS - 1) / WARPS;
  cudaStream_t s = (cudaStream_t)stream;
  if (chunks > 1)
    selective_scan_chunk_kernel<false><<<dim3(Bt * bpv, chunks - 1), WARPS * 32, 0, s>>>(
        f(x), f(dt), f(A), f(B), f(C), f(Dv), (float*)y, (float*)pairs, T, D, chunk, bpv);
  selective_scan_chunk_kernel<true><<<dim3(Bt * bpv, chunks), WARPS * 32, 0, s>>>(
      f(x), f(dt), f(A), f(B), f(C), f(Dv), (float*)y, (float*)pairs, T, D, chunk, bpv);
  return (int)cudaGetLastError();
}

// The gradient of selective_scan_forward at dy [Bt, T, D]: dx, ddt [Bt, T, D],
// dA [D, N], dB, dC [Bt, T, N], dD [D], fp32, contiguous; `pairs` is the
// forward's workspace for the same inputs and chunk (null when T <= chunk),
// `scratch` n_scratch fp32 values laid out as
// kernels/selective_scan.py::backward_scratch_floats says. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an N
// other than 64, a bad chunk length, missing pairs or too little scratch).
int selective_scan_backward(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* Dv, const void* dy, const void* pairs,
                            void* dx, void* ddt, void* dA, void* dB, void* dC, void* dD,
                            void* scratch, int Bt, int T, int D, int n_state, int chunk,
                            int n_scratch, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  if (n_state != N || chunk < TC || chunk % TC) return (int)cudaErrorInvalidValue;
  if (Bt == 0 || T == 0 || D == 0) return (int)cudaGetLastError();
  const int chunks = (T + chunk - 1) / chunk;
  if (chunks > 65535 || (chunks > 1 && pairs == nullptr)) return (int)cudaErrorInvalidValue;
  const int bpv = (D + BWD_WARPS - 1) / BWD_WARPS;
  const size_t n_pairs = 2ull * Bt * (chunks - 1) * D * N;
  const size_t n_hstart = (size_t)Bt * ((T + TC - 1) / TC) * D * N;
  const size_t n_part = (size_t)bpv * Bt * T * N;
  const size_t n_dA = (size_t)Bt * chunks * D * N;
  if (n_pairs + n_hstart + 2 * n_part + n_dA + (size_t)Bt * chunks * D > (size_t)n_scratch)
    return (int)cudaErrorInvalidValue;
  float* bpairs = (float*)scratch;
  float* hstart = bpairs + n_pairs;
  float* part_dB = hstart + n_hstart;
  float* part_dC = part_dB + n_part;
  float* part_dA = part_dC + n_part;
  float* part_dD = part_dA + n_dA;
  cudaStream_t s = (cudaStream_t)stream;
  static bool smem_set = false;
  constexpr int smem = BWD_SMEM_FLOATS * (int)sizeof(float);
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(selective_scan_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  if (chunks > 1)
    selective_scan_bwd_chunk_kernel<<<dim3(Bt * bpv, chunks - 1), BWD_THREADS, 0, s>>>(
        f(dt), f(A), f(C), f(dy), bpairs, T, D, chunk, bpv);
  selective_scan_bwd_kernel<<<dim3(Bt * bpv, chunks), BWD_THREADS, smem, s>>>(
      f(x), f(dt), f(A), f(B), f(C), f(Dv), f(dy), f(pairs), bpairs, hstart, (float*)dx,
      (float*)ddt, part_dB, part_dC, part_dA, part_dD, Bt, T, D, chunk, bpv);
  const size_t total = (size_t)Bt * T * N + (size_t)D * N + D;
  const int threads = 256;
  const int grid = (int)std::min<size_t>((total + threads - 1) / threads, 132 * 16);
  selective_scan_bwd_reduce_kernel<<<grid, threads, 0, s>>>(
      part_dB, part_dC, part_dA, part_dD, (float*)dB, (float*)dC, (float*)dA, (float*)dD, Bt, T,
      D, bpv, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
