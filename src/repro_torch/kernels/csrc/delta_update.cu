// Sparse Eq. 6 accumulator correction on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/delta_update.py::delta_update
// (body _kernel, scalar-prefetched indices). For each of L rows:
//   out[l, m] = acc[l, m] + sum_k w[l, k] * dmajor[idx[l, k], m]
// with dmajor the int8 D-major item memory (+-1) and w in {-2, 0, +2}
// (0 = padding). Indices are clamped to [0, D), as JAX's gather clamps.
//
// What bounds it on the H100: the work is a gather of whole dmajor rows.
// At the switch path's shape (L = 16 streams, budget K = 2048, M = 1024)
// each row reads its K flipped rows of M bytes: L*K*M = 33.6 MB of row
// reads (about 10 us at 3.35 TB/s), against 4*L*K*M = 134 M integer
// multiply-adds (a few us on the integer pipes). Rows with weight 0 add
// nothing, so the bytes that must move are those of the nonzero entries:
// bytes bound it.
//
// What the design does about it: one block per (row, 128-column tile).
// The block stages its row's K indices and weights in shared memory once;
// each of its 8 warps then walks every 8th entry, skips weight-0 entries
// (the same branch for the whole warp), and reads the flipped row's 128
// columns as one coalesced 128-byte load (4 int8 per lane, as a char4 when
// every row start is 4-byte aligned). Sums stay in int32 registers, so the
// result is exact in any order; the 8 warps' partial sums meet in shared
// memory and one thread per column adds the incoming accumulator and stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int COLS = 128;  // columns per block: 32 lanes x 4

__global__ void __launch_bounds__(WARPS * 32)
delta_update_kernel(const int32_t* __restrict__ acc,
                    const int8_t* __restrict__ dmajor,
                    const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ w, int32_t* __restrict__ out,
                    int M, int D, int K, bool vec) {
  extern __shared__ int32_t smem[];
  int32_t* is = smem;                  // [K] clamped indices
  int32_t* wsh = smem + K;             // [K] weights
  int32_t* red = smem + 2 * K;         // [WARPS][COLS] partial sums
  const int l = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t rk = (size_t)l * K;
  for (int k = tid; k < K; k += WARPS * 32) {
    is[k] = min(max(idx[rk + k], 0), D - 1);
    wsh[k] = w[rk + k];
  }
  __syncthreads();

  const int c0 = blockIdx.x * COLS + lane * 4;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (c0 < M) {
    for (int k = warp; k < K; k += WARPS) {
      const int wk = wsh[k];
      if (wk == 0) continue;
      const int8_t* row = dmajor + (size_t)is[k] * M + c0;
      if (vec) {
        const char4 v = *reinterpret_cast<const char4*>(row);
        a0 += wk * v.x;
        a1 += wk * v.y;
        a2 += wk * v.z;
        a3 += wk * v.w;
      } else {
        a0 += wk * row[0];
        if (c0 + 1 < M) a1 += wk * row[1];
        if (c0 + 2 < M) a2 += wk * row[2];
        if (c0 + 3 < M) a3 += wk * row[3];
      }
    }
  }
  int32_t* rw = red + warp * COLS + lane * 4;
  rw[0] = a0;
  rw[1] = a1;
  rw[2] = a2;
  rw[3] = a3;
  __syncthreads();

  if (tid < COLS) {
    const int col = blockIdx.x * COLS + tid;
    if (col < M) {
      int s = 0;
      for (int g = 0; g < WARPS; ++g) s += red[g * COLS + tid];
      const size_t o = (size_t)l * M + col;
      out[o] = acc[o] + s;
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int delta_update_launch(const void* acc, const void* dmajor,
                                   const void* idx, const void* w, void* out,
                                   int L, int M, int D, int K,
                                   void* stream) {
  if (L <= 0 || M <= 0 || D <= 0 || K < 0 || L > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      (2 * (size_t)K + (size_t)WARPS * COLS) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      delta_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const dim3 grid((M + COLS - 1) / COLS, L);
  delta_update_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)acc, (const int8_t*)dmajor, (const int32_t*)idx,
      (const int32_t*)w, (int32_t*)out, M, D, K,
      (M & 3) == 0 && ((uintptr_t)dmajor & 3) == 0);
  return (int)cudaGetLastError();
}
