// Encode front-end on Hopper (sm_90a): packed words = pack(sign(z @ R^T)).
//
// Replaces the TPU kernel src/repro/kernels/fused_window.py:382
// (sign_project_pack, body _pack_kernel, pallas_call at :403). out[n, w]
// bit i is 1 iff y[n, 32w+i] >= 0, where y = z @ R^T (sign(0) -> +1;
// NaN -> bit 0, as jnp.where(y >= 0)); the layout of core/hdc.py::pack_bits.
//
// What bounds it on the H100: at the engine's shape (N = 2048 feature rows,
// d = 512, D = 8192) operations do. The product that the agreement rule
// accepts is three TF32 products (3xTF32, below): 3 * 2NDd = 51.5 G
// operations, 0.104 ms at the 495 TFLOP/s dense TF32 rate, against 22 MB of
// traffic (6.6 us at 3.35 TB/s); on FP32 FMAs the same product would take
// 0.256 ms. At a single window (N = 128) operations still bound it (6.5 us
// against 5.1 us of bytes); at N = 8 bytes do (R's 16.8 MB read once, 5 us).
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
// with D on the M side at N <= 128), and neither the float32 y nor the
// bipolar code reaches device memory. At N > 128 the words are built from
// the accumulators in registers: a thread holds 8 bits of each word of its
// two rows, and the row's four lanes OR them together with two shuffles.
// At N <= 128 the epilogue reads the block's y tile from shared memory: a
// warp takes 32 (row, word) items, for each one lane i reads dim 32w+i and
// __ballot_sync(y >= 0) is exactly the packed word (bit i = lane i).

#include "sign_gemm.cuh"

namespace {

struct PackEpilogue {
  using Out = uint32_t;

  template <class T>
  static __device__ void store(const float* ys, uint32_t* out, int row0,
                               int dim0, int N, int D) {
    constexpr int WPR = T::DIMS / 32;          // words per block row
    constexpr int ITEMS = T::ROWS * WPR;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int words = D / 32;
    for (int base = warp * 32; base < ITEMS; base += T::WARPS * 32) {
      uint32_t mine = 0;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int item = base + j;
        const float v = item < ITEMS
            ? sign_gemm::y_at<T>(ys, item / WPR, (item % WPR) * 32 + lane)
            : 0.f;
        const uint32_t bits = __ballot_sync(0xffffffffu, v >= 0.f);
        if (lane == j) mine = bits;
      }
      const int item = base + lane;
      const int n = row0 + item / WPR, w = dim0 / 32 + item % WPR;
      if (item < ITEMS && n < N && w < words) {
        out[(size_t)n * words + w] = mine;
      }
    }
  }

  // From the wgmma accumulators (N > 128), with no pass through shared
  // memory: for rows arow and arow + 8 the thread holds dims 8j + 2t and
  // 8j + 2t + 1 of every n8 tile j, i.e. 8 bits of each word; the four
  // lanes t of a row OR theirs together, and lane t stores the words
  // w = t (mod 4) of the block's row
  template <class T>
  static __device__ void store_acc(const float (&acc)[T::NA], float*,
                                   uint32_t* out, int row0, int dim0, int N,
                                   int D, int arow, int t) {
    const int words = D / 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = row0 + arow + 8 * h;
#pragma unroll
      for (int wd = 0; wd < T::DIMS / 32; ++wd) {
        uint32_t part = 0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            part |= (acc[4 * (4 * wd + jj) + 2 * h + p] >= 0.f ? 1u : 0u)
                    << (8 * jj + p);
        part <<= 2 * t;                       // bit 8 jj + 2 t + p
        part |= __shfl_xor_sync(0xffffffffu, part, 1);
        part |= __shfl_xor_sync(0xffffffffu, part, 2);
        const int w = dim0 / 32 + wd;
        if ((wd & 3) == t && n < N && w < words) {
          out[(size_t)n * words + w] = part;
        }
      }
    }
  }
};

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sign_project_pack_launch(const void* z, const void* R,
                                        void* out, int N, int d, int D,
                                        void* stream) {
  if (D % 32 != 0) return (int)cudaErrorInvalidValue;
  return sign_gemm::launch<PackEpilogue>(z, R, out, N, d, D, stream);
}
