// Bipolar sign projection on Hopper (sm_90a): codes = sign(z @ R^T) as int8.
//
// Replaces the TPU kernel src/repro/kernels/sign_project.py:30
// (sign_project, body _kernel, pallas_call at :46). out[n, j] = +1 if
// y[n, j] >= 0 else -1, where y = z @ R^T (sign(0) -> +1; NaN -> -1, as
// jnp.where(y >= 0, 1, -1)). z is [N, d], R is [D, d], both row-major.
//
// What bounds it on the H100: at the encode shape (N = 2048, d = 512,
// D = 8192) operations do: the 3xTF32 product below is 3 * 2NDd = 51.5 G
// operations, 0.104 ms at the 495 TFLOP/s dense TF32 rate, against 37 MB of
// traffic (11 us at 3.35 TB/s); on FP32 FMAs it would take 0.256 ms. At a
// single window (N = 128) operations still bound it (6.5 us against 5.1 us
// of bytes); at its benchmark caller's shape (N = 8) bytes do: R's 16.8 MB
// read once take 5 us, the operations 0.4 us.
//
// Why 3xTF32 and not TF32: the agreement rule (kernels/ref.py::
// sign_disagreement) lets no code with |y| > tau = d * 2^-23 * sum|z*R|
// (2^-14 sum|z*R| at d = 512) differ, and at most 1e-4 of the codes below
// it. One TF32 product (10-bit mantissas, error about 2^-11 |z*R| per
// product) flipped 87 of 1,048,576 codes (83 % of that budget) in the
// emulation of tests/test_torch_encode_split.py at N = 128, d = 512,
// D = 8192; 3xTF32 (about 2^-21 |z*R| per product, two orders of
// magnitude inside tau) flipped none there.

// What the design does about it: the product runs on the tensor cores
// (sign_gemm.cuh: warpgroup MMA from a cp.async ring at N > 128, mma.sync
// with D on the M side at N <= 128, where a block takes 32 dims and every
// row, so R is read once), and the float32 y never reaches device memory.
// The epilogue reads the block's y tile from shared memory, one thread per
// four consecutive dims of a row, and writes y >= 0 ? 1 : -1 as int8: one
// 32-bit store per four dims where D % 4 == 0 (consecutive threads on
// consecutive words of a row), bytes on the ragged edge. Any N, d and D
// work.

#include "sign_gemm.cuh"

namespace {

struct CodeEpilogue {
  using Out = int8_t;

  template <class T>
  static __device__ void store(const float* ys, int8_t* out, int row0,
                               int dim0, int N, int D) {
    constexpr int QPR = T::DIMS / 4;           // four-dim quads per row
    constexpr int ITEMS = T::ROWS * QPR;
    const bool whole = D % 4 == 0;
    for (int q = threadIdx.x; q < ITEMS; q += T::THREADS) {
      const int r = q / QPR, c = (q % QPR) * 4;
      const int n = row0 + r, dim = dim0 + c;
      if (n >= N || dim >= D) continue;
      const float4 v = sign_gemm::y_quad<T>(ys, r, c);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      int8_t* row = out + (size_t)n * D;
      if (whole) {
        uint32_t w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t code = vv[j] >= 0.f ? 0x01u : 0xffu;
          w |= code << (8 * j);   // little-endian: dim + j is byte j
        }
        *reinterpret_cast<uint32_t*>(row + dim) = w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (dim + j < D) row[dim + j] = vv[j] >= 0.f ? 1 : -1;
        }
      }
    }
  }

  // From the wgmma accumulators (N > 128): through the y tile, so that
  // consecutive threads store consecutive words of a row
  template <class T>
  static __device__ void store_acc(const float (&acc)[T::NA], float* smem,
                                   int8_t* out, int row0, int dim0, int N,
                                   int D, int arow, int t) {
    sign_gemm::acc_to_y<T>(acc, smem, arow, t);
    store<T>(smem, out, row0, dim0, N, D);
  }
};

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sign_project_launch(const void* z, const void* R, void* out,
                                   int N, int d, int D, void* stream) {
  return sign_gemm::launch<CodeEpilogue>(z, R, out, N, d, D, stream);
}
