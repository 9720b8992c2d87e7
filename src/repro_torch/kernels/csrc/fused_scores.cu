// Fused full-path scores on Hopper (sm_90a): scan, accumulate, argmax, top-2.
//
// Replaces the TPU kernel src/repro/kernels/fused_window.py::fused_scores
// (body _fused_kernel). For query row n and class row m over the W words of
// a static plan's enabled columns:
//   acc[n, m] = d_eff - 2 * sum_w popc(q[n, w] ^ im[m, w])
//   best[n]   = the first m holding the row's maximum (jnp.argmax)
//   top2[n]   = (the maximum, the largest value at any other index), which
//               is lax.top_k(acc, 2)[0]: a tied maximum gives top2[1] ==
//               top2[0]; with M == 1 top2[1] is INT32_MIN.
//
// What bounds it on the H100: at the switch path's shape (N = N_max = 128
// proposals, M = 1024 classes, W = banks * 32 <= 256 words) the kernel reads
// about 1.2 MB and writes 0.5 MB (about 0.5 us at 3.35 TB/s) and takes
// N*M*W = 33.6 M word pairs, each a xor, a __popc and an add. Compute
// capability 9.0 issues 16 population counts per SM per clock, so on 132 SMs
// at 1.98 GHz the popcounts take about 8 us: operations bound it.
//
// What the design does about it: every word operation is fed from shared
// memory. A block owns TQ query rows (one warp each) and walks every class
// in tiles of TM = 32 rows staged in shared memory with an odd row stride,
// so the 32 lanes of a warp (32 consecutive classes of one query) read 32
// different banks while the query word is a broadcast. Each lane keeps its
// (query, class) count in a register, writes acc, and folds the value into a
// running (max, first index of the max, largest other value) triple; the
// classes a lane sees rise, so a strict > keeps the earliest maximum. Five
// xor-shuffles then merge the 32 lanes' triples of each row, preferring the
// lower index on equal maxima, which is exactly JAX's finalize rule. The
// block walks all M classes, so no second pass merges partial readouts; the
// price is that only N / TQ blocks run (32 at N = 128), which a later change
// can split over classes. Any N and M work (the ragged edge is masked).

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int TQ = 4;   // query rows per block: one warp each
constexpr int TM = 32;  // class rows per shared-memory tile: one per lane

__global__ void __launch_bounds__(TQ * 32)
fused_scores_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ im,
                    int32_t* __restrict__ acc, int32_t* __restrict__ best,
                    int32_t* __restrict__ top2, int N, int M, int W,
                    int d_eff) {
  extern __shared__ uint32_t smem[];
  const int ws = W + 1;            // odd stride: conflict-free column reads
  uint32_t* qs = smem;             // [TQ][ws]
  uint32_t* hs = smem + TQ * ws;   // [TM][ws]
  const int tid = threadIdx.x;
  const int r = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * TQ;
  const int n = n0 + r;

  for (int i = tid; i < TQ * W; i += TQ * 32) {
    const int rr = i / W, c = i - rr * W;
    qs[rr * ws + c] = n0 + rr < N ? q[(size_t)(n0 + rr) * W + c] : 0u;
  }

  int best_v = INT_MIN, best_i = INT_MAX, second = INT_MIN;
  const uint32_t* qr = qs + r * ws;
  const uint32_t* hr = hs + lane * ws;
  for (int m0 = 0; m0 < M; m0 += TM) {
    __syncthreads();               // the previous tile is consumed
    for (int i = tid; i < TM * W; i += TQ * 32) {
      const int rr = i / W, c = i - rr * W;
      hs[rr * ws + c] = m0 + rr < M ? im[(size_t)(m0 + rr) * W + c] : 0u;
    }
    __syncthreads();
    const int m = m0 + lane;
    if (n < N && m < M) {
      int ham = 0;
      for (int w = 0; w < W; ++w) ham += __popc(qr[w] ^ hr[w]);
      const int v = d_eff - 2 * ham;
      acc[(size_t)n * M + m] = v;
      if (v > best_v) {
        second = best_v;
        best_v = v;
        best_i = m;
      } else {
        second = max(second, v);
      }
    }
  }

  // merge the 32 lanes' (max, index, other) triples of row n
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(0xffffffffu, best_v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    const int os = __shfl_xor_sync(0xffffffffu, second, off);
    if (best_v > ov || (best_v == ov && best_i < oi)) {
      second = max(second, ov);
    } else {
      second = max(os, best_v);
      best_v = ov;
      best_i = oi;
    }
  }
  if (lane == 0 && n < N) {
    best[n] = best_i;
    top2[2 * (size_t)n] = best_v;
    top2[2 * (size_t)n + 1] = second;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int fused_scores_launch(const void* q, const void* im, void* acc,
                                   void* best, void* top2, int N, int M,
                                   int W, int d_eff, void* stream) {
  if (N <= 0 || M <= 0 || W < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(TQ + TM) * (size_t)(W + 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const dim3 grid((N + TQ - 1) / TQ);
  fused_scores_kernel<<<grid, TQ * 32, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)im, (int32_t*)acc,
      (int32_t*)best, (int32_t*)top2, N, M, W, d_eff);
  return (int)cudaGetLastError();
}
