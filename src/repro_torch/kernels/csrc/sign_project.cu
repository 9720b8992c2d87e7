// Bipolar sign projection on Hopper (sm_90a): codes = sign(z @ R^T) as int8.
//
// Replaces the TPU kernel src/repro/kernels/sign_project.py::sign_project
// (body _kernel). out[n, j] = +1 if y[n, j] >= 0 else -1, where
// y = z @ R^T in float32 (sign(0) -> +1; NaN -> -1, as
// jnp.where(y >= 0, 1, -1)). z is [N, d], R is [D, d], both row-major.
//
// What bounds it on the H100: at the encode shape (N = 2048 feature rows,
// d = 512, D = 8192) the product is 2*N*D*d = 17.2 G float32 operations,
// about 256 us at the 67 TFLOP/s CUDA-core rate, against 37 MB of traffic
// (about 11 us at 3.35 TB/s): operations bound it. At its benchmark
// caller's shape (N = 8) it is the other way round: the 16.8 MB of R take
// about 5 us to read and the 67 M operations 1 us, so bytes bound it. The
// tensor cores would be faster but run TF32 or lower precision, which
// changes signs near zero, so this kernel stays on plain FP32 FMAs.
//
// What the design does about it: a register-tiled FP32 product. A block
// of 256 threads owns a BM x BN = 64 x 64 tile of (rows, dims) and walks
// the feature axis in stages of BK = 16 columns: it stages the z tile and
// the R tile in shared memory transposed (k-major, so each thread reads its
// 4 rows and its 4 dims as one float4 each, conflict-free across the warp),
// and each thread keeps a 4 x 4 block of float32 accumulators in registers,
// 16 FMAs per two shared-memory loads. The float32 y never reaches device
// memory: the epilogue writes y >= 0 ? 1 : -1 as int8, four consecutive
// dims of a row per 32-bit store where D % 4 == 0 and the tile is whole,
// byte by byte on the ragged edge. Any N, d and D work (the ragged edges are
// masked with zeros, which add nothing to a sum).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // feature rows (z rows) per block
constexpr int BN = 64;   // projected dims (R rows) per block
constexpr int BK = 16;   // feature columns per shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // dims per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int PAD = 4;   // keeps float4 alignment of the transposed rows

__global__ void __launch_bounds__(THREADS)
sign_project_kernel(const float* __restrict__ z, const float* __restrict__ R,
                    int8_t* __restrict__ out, int N, int d, int D) {
  __shared__ __align__(16) float zs[BK][BM + PAD];
  __shared__ __align__(16) float rs[BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // which 4 dims of the tile
  const int ty = tid / (BN / TN);   // which 4 rows of the tile
  const int n0 = blockIdx.y * BM;
  const int dim0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // consecutive threads read consecutive feature columns of one row
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, k = i - r * BK;
      const int n = n0 + r, kk = k0 + k;
      zs[k][r] = (n < N && kk < d) ? z[(size_t)n * d + kk] : 0.f;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int c = i / BK, k = i - c * BK;
      const int dim = dim0 + c, kk = k0 + k;
      rs[k][c] = (dim < D && kk < d) ? R[(size_t)dim * d + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&zs[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&rs[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[m][j] = fmaf(av[m], bv[j], acc[m][j]);
    }
    __syncthreads();
  }

  const int dim = dim0 + tx * TN;
  const bool whole = (D % 4 == 0) && (dim + TN <= D);
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int n = n0 + ty * TM + m;
    if (n >= N) continue;
    int8_t* row = out + (size_t)n * D;
    if (whole) {
      uint32_t w = 0;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const uint32_t code = acc[m][j] >= 0.f ? 0x01u : 0xffu;
        w |= code << (8 * j);   // little-endian: dim + j is byte j
      }
      *reinterpret_cast<uint32_t*>(row + dim) = w;
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (dim + j < D) row[dim + j] = acc[m][j] >= 0.f ? 1 : -1;
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sign_project_launch(const void* z, const void* R, void* out,
                                   int N, int d, int D, void* stream) {
  if (N <= 0 || d <= 0 || D <= 0 || (N + BM - 1) / BM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((D + BN - 1) / BN, (N + BM - 1) / BM);
  sign_project_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)R, (int8_t*)out, N, d, D);
  return (int)cudaGetLastError();
}
