// Mamba S6 selective scan for Hopper (sm_90a).
//
// Replaces surgical_tpu/kernels/selective_scan.py::selective_scan_pallas
// (body _scan_kernel), batched over videos instead of vmapped:
//
//   h_t[d, n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[d, n] + dt_t[d] * x_t[d] * B_t[n]
//   y_t[d]    = sum_n h_t[d, n] * C_t[n] + D[d] * x_t[d]
//
// x, dt, y [Bt, T, D]; A [D, N]; B, C [Bt, T, N]; D [D]; all fp32, state fp32.
// N is MambaConfig()'s d_state, 64: the one width the path runs and the card
// checks.
//
// Design. The Pallas kernel walks a sequential grid of 128-step chunks and
// scans each chunk in VMEM with Hillis-Steele doubling; a CUDA grid has no
// order, so here time is a loop inside the block instead. One warp owns one
// (video, channel d): each lane holds NS = N/32 = 2 states in registers and
// steps them through T in order. A block is WARPS channels of one video,
// which share every B_t/C_t row: the block stages each 32-step chunk of B, C
// (and its channels' x, dt) in shared memory with coalesced loads issued
// while the previous chunk computes, zero past the end of the video (dt = 0
// leaves the state as it is), so there is no time padding. Only h carries from step to step; each lane keeps its 32
// partial dot products h_t . C_t of the chunk in registers, and one
// butterfly over the warp (31 shuffles) leaves lane i with y of step i,
// instead of a 5-shuffle reduction on the critical path of every step.
// exp is expf, not __expf, so the state keeps fp32 accuracy against the
// plain version over thousands of steps.
//
// Bound on this card (H100 SXM): per (t, d, n) one exp (an SFU op, 16 per
// SM per clock) and ~5 fp32 flops against 4 bytes per (t, d) of x, dt, y and
// per (t, n) of B, C, so the SFU rate bounds it (PERF.md has the
// arithmetic). This first kernel is latency-bound instead: each warp walks
// its T steps in order, and a video of D = 128 channels puts one warp on
// each SM sub-partition of 32 of the 132 SMs, with nothing to hide the
// latency of each step's exp. A scan split over time is later work.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;    // channels per block
constexpr int TC = 32;      // time steps per chunk: one per lane in the y reduction
constexpr int N = 64;       // d_state
constexpr int NS = N / 32;  // states per lane

__global__ void __launch_bounds__(WARPS * 32)
selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ Bm,
                      const float* __restrict__ Cm, const float* __restrict__ Dv,
                      float* __restrict__ y, int T, int D, int blocks_per_video) {
  __shared__ float sB[TC * N];
  __shared__ float sC[TC * N];
  __shared__ float sx[TC * WARPS];
  __shared__ float sdt[TC * WARPS];

  const int video = blockIdx.x / blocks_per_video;
  const int d0 = (blockIdx.x % blocks_per_video) * WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = d0 + warp;
  const bool live = d < D;

  float a_row[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a_row[j] = live ? A[(size_t)d * N + lane + 32 * j] : 0.f;
    h[j] = 0.f;
  }
  const float skip = live ? Dv[d] : 0.f;

  // The next chunk's B, C, x, dt rows travel to registers while this chunk
  // computes (each thread loads a fixed share: PER of the TC x N rows of B
  // and of C, one of the TC x WARPS values of x and of dt), then go to
  // shared memory between the two barriers. Zero past the end of the video.
  constexpr int THREADS = WARPS * 32, PER = TC * N / THREADS;
  static_assert(TC * WARPS == THREADS, "one x and one dt value per thread");
  static_assert(PER * THREADS == TC * N, "every thread loads the same share of B, C");
  const size_t row0 = (size_t)video * T;
  const int xw = threadIdx.x % WARPS, xt = threadIdx.x / WARPS;
  float rb[PER], rc[PER], rx, rdt;
  auto fetch = [&](int t0) {
    const int valid = min(TC, T - t0) * N;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = threadIdx.x + r * THREADS;
      const size_t g = (row0 + t0) * N + i;
      rb[r] = i < valid ? Bm[g] : 0.f;
      rc[r] = i < valid ? Cm[g] : 0.f;
    }
    const bool ok = t0 + xt < T && d0 + xw < D;
    const size_t g = (row0 + t0 + xt) * D + d0 + xw;
    rx = ok ? x[g] : 0.f;
    rdt = ok ? dt[g] : 0.f;
  };
  fetch(0);
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tc = min(TC, T - t0);
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = threadIdx.x + r * THREADS;
      sB[i] = rb[r];
      sC[i] = rc[r];
    }
    sx[threadIdx.x] = rx;
    sdt[threadIdx.x] = rdt;
    __syncthreads();
    if (t0 + TC < T) fetch(t0 + TC);
    if (!live) continue;

    float part[TC];  // this lane's share of h_t . C_t, per step of the chunk
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
#pragma unroll
    for (int sh = 4; sh >= 0; --sh) {
      const int o = 1 << sh;
      const bool upper = lane & o;
#pragma unroll
      for (int k = 0; k < o; ++k) {
        const float send = upper ? part[k] : part[k + o];
        const float keep = upper ? part[k + o] : part[k];
        part[k] = keep + __shfl_xor_sync(FULL_MASK, send, o);
      }
    }
    if (lane < tc)
      y[(row0 + t0 + lane) * D + d] = part[0] + skip * sx[lane * WARPS + warp];
  }
}

}  // namespace

extern "C" {

// x, dt, y [Bt, T, D]; A [D, N]; B, C [Bt, T, N]; D [D]; fp32, contiguous.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// N other than 64).
int selective_scan_forward(const void* x, const void* dt, const void* A, const void* B,
                           const void* C, const void* Dv, void* y, int Bt, int T, int D,
                           int n_state, void* stream) {
  auto f = [](const void* p) { return (const float*)p; };
  if (n_state != N) return (int)cudaErrorInvalidValue;
  if (Bt == 0 || T == 0 || D == 0) return (int)cudaGetLastError();
  const int bpv = (D + WARPS - 1) / WARPS;
  selective_scan_kernel<<<Bt * bpv, WARPS * 32, 0, (cudaStream_t)stream>>>(
      f(x), f(dt), f(A), f(B), f(C), f(Dv), (float*)y, T, D, bpv);
  return (int)cudaGetLastError();
}

}  // extern "C"
