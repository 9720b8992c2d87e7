// Encode front-end on Hopper (sm_90a): packed words = pack(sign(z @ R^T)).
//
// Replaces the TPU kernel src/repro/kernels/fused_window.py::sign_project_pack
// (body _pack_kernel). out[n, w] bit i is 1 iff y[n, 32w+i] >= 0, where
// y = z @ R^T in float32 (sign(0) -> +1; NaN -> bit 0, as jnp.where(y >= 0)).
//
// What bounds it on the H100: at the main-path shape (N = 2048 feature rows,
// d = 512, D = 8192) the product is 2*N*D*d = 17.2 G float32 operations,
// about 256 us at the 67 TFLOP/s CUDA-core rate, against 22 MB of traffic
// (about 7 us at 3.35 TB/s): operations bound it. The tensor cores would be
// faster but run TF32 or lower precision, which changes signs near zero, so
// this kernel stays on plain FP32 FMAs.
//
// What the design does about it: neither the float32 projection nor the
// bipolar code ever reaches device memory; only the packed words are
// written (32x fewer bytes than the f32 y). One warp computes the 32
// consecutive dims of one packed word: lane i owns dim 32w+i and keeps the
// float32 FMA dot for ROWS feature rows in registers, reading R from a
// shared-memory tile (row stride KC+1, conflict-free) and z as a broadcast.
// __ballot_sync(y >= 0) is then exactly the packed word (bit i = lane i),
// and one lane stores it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;    // feature rows per block (registers per lane)
constexpr int WARPS = 8;   // packed words per block: one warp each
constexpr int KC = 32;     // feature columns per shared-memory stage

__global__ void __launch_bounds__(WARPS * 32)
sign_project_pack_kernel(const float* __restrict__ z,
                         const float* __restrict__ R,
                         uint32_t* __restrict__ out, int N, int d, int D) {
  __shared__ float zs[ROWS][KC];
  __shared__ float rs[WARPS * 32][KC + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.y * ROWS;
  const int dim0 = blockIdx.x * WARPS * 32;
  const int words = D / 32;

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < d; k0 += KC) {
    for (int i = threadIdx.x; i < ROWS * KC; i += WARPS * 32) {
      const int r = i / KC, k = i - r * KC;
      const int n = n0 + r, kk = k0 + k;
      zs[r][k] = (n < N && kk < d) ? z[(size_t)n * d + kk] : 0.f;
    }
    for (int i = threadIdx.x; i < WARPS * 32 * KC; i += WARPS * 32) {
      const int r = i / KC, k = i - r * KC;
      const int dim = dim0 + r, kk = k0 + k;
      rs[r][k] = (dim < D && kk < d) ? R[(size_t)dim * d + kk] : 0.f;
    }
    __syncthreads();
    const int kn = min(KC, d - k0);
    const float* rrow = rs[warp * 32 + lane];
    for (int k = 0; k < kn; ++k) {
      const float rv = rrow[k];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(zs[r][k], rv, acc[r]);
    }
    __syncthreads();
  }

  const int word = blockIdx.x * WARPS + warp;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const unsigned bits = __ballot_sync(0xffffffffu, acc[r] >= 0.f);
    const int n = n0 + r;
    if (lane == 0 && n < N && word < words) {
      out[(size_t)n * words + word] = bits;
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sign_project_pack_launch(const void* z, const void* R,
                                        void* out, int N, int d, int D,
                                        void* stream) {
  if (N <= 0 || d <= 0 || D <= 0 || D % 32 != 0 ||
      (N + ROWS - 1) / ROWS > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((D + WARPS * 32 - 1) / (WARPS * 32), (N + ROWS - 1) / ROWS);
  sign_project_pack_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)R, (uint32_t*)out, N, d, D);
  return (int)cudaGetLastError();
}
