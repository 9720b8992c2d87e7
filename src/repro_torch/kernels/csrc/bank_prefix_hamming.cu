// Bank-prefix hamming counts on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_window.py::bank_prefix_hamming
// (body _prefix_kernel): out[n, m, b] = number of differing bits between query
// row n and class row m over the first (b+1) banks of the plan-capped,
// bank-major word prefix, for b in [0, cap). Words are 32-bit bit patterns.
//
// What bounds it on the H100: at the main-path shape (N = S*N_max = 2048
// query rows, M = 1024 classes, W = 256 words, cap = 8) the kernel reads 3 MB
// and writes a 64 MB int32 output (about 21 us at 3.35 TB/s), and takes
// N*M*W = 537 M word pairs, each a xor, a __popc and an add. Compute
// capability 9.0 issues 16 population counts and 64 32-bit integer adds or
// bitwise ops per SM per clock (CUDA C++ Programming Guide, arithmetic
// instruction throughput), so on 132 SMs at 1.98 GHz the popcounts alone take
// about 128 us and the xors and adds about 64 us on the integer pipe. The
// popcount issue rate bounds it, six times above the memory bound; the
// shared-memory loads that feed each popcount come next.
//
// What the design does about it: every word operation is fed from shared
// memory, never from device memory. A block stages TQ query rows and TM class
// rows of the full capped width once (odd row stride, so the 32 lanes of a
// warp, which own 32 consecutive classes of one query, read 32 different
// banks while the query word is a broadcast), then each thread owns one
// (n, m) output and walks the cap banks x epw words with __popc(q ^ h),
// keeping the running prefix in a register and storing the cap counts, which
// are contiguous in the [N, M, cap] layout. Any N and M work (the ragged edge
// is masked); W % cap == 0 is required, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 8;   // query rows per block
constexpr int TM = 32;  // class rows per block: one warp spans them

__global__ void __launch_bounds__(TQ * TM)
bank_prefix_hamming_kernel(const uint32_t* __restrict__ q,
                           const uint32_t* __restrict__ im,
                           int32_t* __restrict__ out,
                           int N, int M, int W, int cap) {
  extern __shared__ uint32_t smem[];
  const int ws = W + 1;            // odd stride: conflict-free column reads
  uint32_t* qs = smem;             // [TQ][ws]
  uint32_t* hs = smem + TQ * ws;   // [TM][ws]
  const int n0 = blockIdx.y * TQ;
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x;

  for (int i = tid; i < TQ * W; i += TQ * TM) {
    const int r = i / W, c = i - r * W;
    const int n = n0 + r;
    qs[r * ws + c] = n < N ? q[(size_t)n * W + c] : 0u;
  }
  for (int i = tid; i < TM * W; i += TQ * TM) {
    const int r = i / W, c = i - r * W;
    const int m = m0 + r;
    hs[r * ws + c] = m < M ? im[(size_t)m * W + c] : 0u;
  }
  __syncthreads();

  const int r = tid / TM, c = tid - r * TM;
  const int n = n0 + r, m = m0 + c;
  if (n >= N || m >= M) return;
  const uint32_t* qr = qs + r * ws;
  const uint32_t* hr = hs + c * ws;
  const int epw = W / cap;
  int32_t* o = out + ((size_t)n * M + m) * cap;
  int run = 0;
  for (int b = 0; b < cap; ++b) {
    const int w0 = b * epw;
    for (int w = 0; w < epw; ++w) run += __popc(qr[w0 + w] ^ hr[w0 + w]);
    o[b] = run;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int bank_prefix_hamming_launch(const void* q, const void* im,
                                          void* out, int N, int M, int W,
                                          int cap, void* stream) {
  if (N <= 0 || M <= 0 || W <= 0 || cap <= 0 || W % cap != 0 ||
      (N + TQ - 1) / TQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(TQ + TM) * (size_t)(W + 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      bank_prefix_hamming_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const dim3 grid((M + TM - 1) / TM, (N + TQ - 1) / TQ);
  bank_prefix_hamming_kernel<<<grid, TQ * TM, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)im, (int32_t*)out, N, M, W, cap);
  return (int)cudaGetLastError();
}
