// Bank-prefix hamming counts on Hopper (sm_90a), on the 1-bit tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/fused_window.py::bank_prefix_hamming
// (body _prefix_kernel): out[n, m, b] = number of differing bits between query
// row n and class row m over the first (b+1) banks of the plan-capped,
// bank-major word prefix, for b in [0, cap). Words are 32-bit bit patterns.
//
// What bounds it on the H100: at the main-path shape (N = S*N_max = 2048
// query rows, M = 1024 classes, W = 256 words, cap = 8) it reads 3 MB and
// writes a 64 MB int32 output: 21 us at 3.35 TB/s. Its N*M*W = 537 M word
// pairs are 34.4 G int8-equivalent tensor-core operations (17 us at 1,979
// TOP/s) but 128 us as popcounts (16 per SM per clock), where a popcount
// kernel sits. Bytes bound it once the products leave the popcount pipe.
//
// What the design does about it (hamming_mma.cuh): the products run as
// mma.sync m16n8k256 b1 .and.popc on the packed words (hamming = pq + ph -
// 2 dot, pq and ph from the same instruction against all-ones words), the
// running prefix stays in the accumulators and is emitted at each bank
// boundary into a per-warp staging tile in shared memory (16-bit counts),
// and each warp writes its [16 queries][32 classes][cap] block row by row
// as whole lines (16-byte stores at cap = 8). A block is 8 warps, 64
// queries x 64 classes, with a 2-stage ring of 32-word stages: 104.5 KB
// of shared memory and 98 registers a thread, two blocks an SM. That is
// 512 blocks at the prefix step's N = 2048 (also compact's overflow and
// no-savings tier) and 256 at the 1,024-row compact tier, the two tiers
// the served and reuse traffics launch. Of the tiles timed on an H100
// while this design was chosen, this one was fastest at N = 2048 (32 x 64
// and 64 x 32 tiles were slower): a larger tile reads the operands from L2
// fewer times, and the 16-bit staging keeps two blocks on an SM. Any N and M
// work (ragged edges are zero-filled and masked); W % cap == 0
// is required, as on the TPU.

#include "hamming_mma.cuh"

namespace {

// WQ, WC, NT, KC, STAGES, KW: 64 x 64, 8 warps
using Block = ham::Tile<4, 2, 4, 32, 2, 1>;

// VEC: 16-byte copies (epw % 8 == 0, aligned rows), else 4-byte ones;
// NARROW: 16-bit staging (32 W < 65,536)
template <bool VEC, bool NARROW>
__global__ void __launch_bounds__(Block::THREADS)
bank_prefix_hamming_kernel(const uint32_t* __restrict__ q,
                           const uint32_t* __restrict__ im,
                           int32_t* __restrict__ out, int N, int M, int W,
                           int cap) {
  ham::prefix_block<Block, VEC, NARROW>(q, im, out, N, M, W, cap);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int bank_prefix_hamming_launch(const void* q, const void* im,
                                          void* out, int N, int M, int W,
                                          int cap, void* stream) {
  return (int)ham::launch<Block, bank_prefix_hamming_kernel<true, true>,
                          bank_prefix_hamming_kernel<true, false>,
                          bank_prefix_hamming_kernel<false, true>,
                          bank_prefix_hamming_kernel<false, false>>(
      q, im, out, 1, N, M, W, cap, (cudaStream_t)stream);
}
