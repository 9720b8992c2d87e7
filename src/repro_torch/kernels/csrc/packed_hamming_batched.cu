// Batched packed hamming table on Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/xnor_popcount_sim.py::packed_hamming_batched (body
// _kernel; packed_hamming is its TQ = 1 wrapper). For each batch s:
//   out[s, n, m] = sum_w popc(q[s, n, w] ^ im[s, m, w])
// over 32-bit word bit patterns. On the compact path the batch is the
// stream: the batched decide pass scores each stream's proposals against
// its own cache snapshot ([S, N, W] x [S, K, W]) and against its own
// proposals ([S, N, W] x [S, N, W]), with disabled words zeroed on both
// operands beforehand.
//
// What bounds it on the H100: at the decide pass's shapes (S = 16, N = 128,
// W = 256; M = K = 8 and M = N = 128) the inputs are 2 MB and 2.1 MB and the
// tables 64 KB and 1 MB (about 0.6 us and 0.9 us at 3.35 TB/s), against
// S*N*M*W = 4.2 M and 67 M word pairs, each a xor, a __popc and an add:
// about 1 us and 16 us of popcounts on 132 SMs at 16 per SM per clock and
// 1.98 GHz. The larger table is bound by operations, the snapshot table by
// bytes.
//
// What the design does about it: M may be as small as the cache depth
// (K = 8), so a block never assumes 32 classes. A block owns tq query rows
// of one batch, staged in shared memory; each warp takes one class row at a
// time, its 32 lanes read 32 consecutive words (coalesced) and hold them in
// a register while xor-ing them against all tq staged query rows (lane w
// reads word w of each row: conflict-free), so each class row is read once
// per block and reused tq times. Five xor-shuffles sum each row's lanes.
// The wrapper picks tq as a divisor of N, so every block's rows are real.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int TQ_MAX = 8;  // query rows per block, at most

__global__ void __launch_bounds__(WARPS * 32)
packed_hamming_batched_kernel(const uint32_t* __restrict__ q,
                              const uint32_t* __restrict__ im,
                              int32_t* __restrict__ out, int N, int M, int W,
                              int tq) {
  extern __shared__ uint32_t qs[];   // [tq][W]
  const int s = blockIdx.y;
  const int n0 = blockIdx.x * tq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t* qb = q + ((size_t)s * N + n0) * W;
  for (int i = tid; i < tq * W; i += WARPS * 32) qs[i] = qb[i];
  __syncthreads();

  const uint32_t* hb = im + (size_t)s * M * W;
  int32_t* ob = out + ((size_t)s * N + n0) * M;
  for (int m = warp; m < M; m += WARPS) {
    const uint32_t* hr = hb + (size_t)m * W;
    int part[TQ_MAX];
#pragma unroll
    for (int r = 0; r < TQ_MAX; ++r) part[r] = 0;
    for (int w = lane; w < W; w += 32) {
      const uint32_t h = hr[w];
#pragma unroll
      for (int r = 0; r < TQ_MAX; ++r) {
        if (r < tq) part[r] += __popc(qs[r * W + w] ^ h);
      }
    }
#pragma unroll
    for (int r = 0; r < TQ_MAX; ++r) {
      int v = part[r];
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0 && r < tq) ob[(size_t)r * M + m] = v;
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// q is [S, N, W], im [S, M, W], out [S, N, M]; tq must divide N.
extern "C" int packed_hamming_batched_launch(const void* q, const void* im,
                                             void* out, int S, int N, int M,
                                             int W, int tq, void* stream) {
  if (S <= 0 || N <= 0 || M <= 0 || W < 0 || tq < 1 || tq > TQ_MAX ||
      N % tq != 0 || S > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)tq * (size_t)W * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      packed_hamming_batched_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const dim3 grid(N / tq, S);
  packed_hamming_batched_kernel<<<grid, WARPS * 32, smem,
                                  (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)im, (int32_t*)out, N, M, W, tq);
  return (int)cudaGetLastError();
}
