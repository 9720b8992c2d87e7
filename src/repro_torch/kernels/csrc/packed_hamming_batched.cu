// Batched packed hamming table on Hopper (sm_90a), on the 1-bit tensor
// cores.
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
// W = 256; M = K = 8 and M = N = 128) the inputs are 2.1 MB and 4.2 MB and
// the tables 64 KB and 1 MB (0.6 us and 1.6 us at 3.35 TB/s), against
// S*N*M*W = 4.2 M and 67 M word pairs: 0.14 us and 2.2 us as int8-
// equivalent tensor-core operations (64 a word pair at 1,979 TOP/s), 1 us
// and 16 us as popcounts. Bytes bound both tables once the products run
// on the tensor cores; at these sizes the launch and the latency of the
// loads set the pace.
//
// What the design does about it: the mainloop of bank_prefix_hamming
// (hamming_mma.cuh) with one bank (cap = 1): mma.sync m16n8k256 b1
// .and.popc on the packed words, hamming = pq + ph - 2 dot, batch s on
// blockIdx.z. Whole 256-word rows fit in a 4-stage ring of 64-word
// stages, so every load of a block is in flight at once. At these sizes
// a block's chain of loads and dependent steps sets the pace, so the
// words are split across warps: the KW warps of an output tile take the
// k-steps j, j + KW, ... of each stage and add their counts in warp order
// through shared memory. Tiles, by M (the fastest of those timed on an
// H100 while this design was chosen):
//  * M <= 8 (the snapshot table): 16 queries x 8 classes a block, 8 warps
//    on the words, 128 blocks at the step's shape (one warp on the words
//    was slower);
//  * M > 8 (the proposal table): 64 queries x 32 classes a block, 8
//    tiles of 16 x 16 with 2 warps each (16 warps), 128 blocks (32 x 32
//    with one warp a tile was slower).
// Any S, N, M and W work (ragged edges are zero-filled and masked; W = 0
// gives zeros).

#include "hamming_mma.cuh"

namespace {

// WQ, WC, NT, KC, STAGES, KW
using Snapshot = ham::Tile<1, 1, 1, 64, 4, 8>;   // 16 x 8, 8 warps
using Table = ham::Tile<4, 2, 2, 64, 4, 2>;      // 64 x 32, 16 warps

// VEC: 16-byte copies (W % 8 == 0, aligned rows), else 4-byte ones;
// NARROW: 16-bit staging (32 W < 65,536)
template <class T, bool VEC, bool NARROW>
__global__ void __launch_bounds__(T::THREADS)
packed_hamming_batched_kernel(const uint32_t* __restrict__ q,
                              const uint32_t* __restrict__ im,
                              int32_t* __restrict__ out, int N, int M, int W,
                              int cap) {
  ham::prefix_block<T, VEC, NARROW>(q, im, out, N, M, W, cap);
}

template <class T>
cudaError_t launch(const void* q, const void* im, void* out, int S, int N,
                   int M, int W, cudaStream_t s) {
  return ham::launch<T, packed_hamming_batched_kernel<T, true, true>,
                     packed_hamming_batched_kernel<T, true, false>,
                     packed_hamming_batched_kernel<T, false, true>,
                     packed_hamming_batched_kernel<T, false, false>>(
      q, im, out, S, N, M, W, 1, s);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// q is [S, N, W], im [S, M, W], out [S, N, M].
extern "C" int packed_hamming_batched_launch(const void* q, const void* im,
                                             void* out, int S, int N, int M,
                                             int W, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(M <= 8 ? launch<Snapshot>(q, im, out, S, N, M, W, s)
                      : launch<Table>(q, im, out, S, N, M, W, s));
}
