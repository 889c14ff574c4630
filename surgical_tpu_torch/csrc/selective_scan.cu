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
// pairs are what a backward (a reverse-time scan over the same chunks) can
// reuse for its carry; this file has no backward yet.
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

}  // extern "C"
