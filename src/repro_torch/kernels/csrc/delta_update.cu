// Sparse Eq. 6 accumulator correction on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/delta_update.py::delta_update
// (body _kernel, scalar-prefetched indices). For each of L rows:
//   out[l, m] = acc[l, m] + sum_k w[l, k] * dmajor[idx[l, k], m]
// with dmajor the int8 D-major item memory (+-1) and w in {-2, 0, +2}
// (0 = padding). An index is taken as JAX's gather and the plain version
// (kernels/ref.py) take it: a negative one wraps from the end once
// (idx + D), then it clamps to [0, D) (no path makes one out of range).
//
// What bounds it on the H100: the work is a gather of whole dmajor rows.
// The serial switch step and run_torr launch it with L = 1 row (one
// proposal), the batched switch lowering with L = 16; M = 1024 classes,
// budget K = 2048. Only the entries with weight carry work: a row whose
// flip count reaches the budget gathers 2048 rows of 1 KB (2 MB, 0.6 us at
// 3.35 TB/s; the 8 MB dmajor stays in the 50 MB L2 across a step), a row
// with one flip gathers 1 KB. The integer work (one multiply-add per
// weighted entry and column) is a fifth of the byte time: bytes bound it,
// and at these sizes the latency of dependent L2 loads and the launch set
// the pace, not the bandwidth.
//
// What the design does about it:
//  * The budget is dealt to a thread-block cluster of SPLIT = 8 blocks in
//    32-entry runs (block s takes runs s, s + 8, ...), and the columns are
//    cut into tiles of COLS = 16 * LANES columns. With LANES = 4 at L <= 8
//    rows, L = 1 at M = 1024 runs 16 x 8 = 128 blocks (one launch fills the
//    card); with LANES = 8 above, L = 16 runs 1,024 blocks, one wave. The
//    weighted entries lead a row's budget (k < its flip count), so dealing
//    runs, not slices, spreads them over the cluster.
//  * Each block compacts its runs 2 * 128 entries at a time: a ballot per
//    warp and a prefix over the ballots' counts give each weighted entry
//    its place in a dense list in shared memory, in budget order. A row
//    with one weighted entry costs one row load; padding costs nothing
//    beyond reading its weight. The served traffic mostly weights the whole
//    budget, but the rows whose result a window keeps (the delta path) carry
//    few flips, and on an H100 (perf/kernel_ab.py) a build without the
//    compaction, each warp gathering its own runs and skipping entries
//    without weight, was no faster with the budget weighted (4.3 against
//    4.2 us at L = 1) and slower on sparse rows: 9.5 against 6.9 us at
//    L = 16 with half of each row weighted, 9.0 against 4.9 us with one
//    entry a row, since the warps that draw padded runs idle.
//  * LANES lanes read an entry's COLS columns as 16-byte loads (16 int8 a
//    lane), so a warp serves 32 / LANES entries a round, and each lane
//    starts U = 4 rounds of loads before the first is used.
//  * Partial sums are int32 registers, exact in any order. The entry
//    groups of a warp meet through shuffles, the warps in shared memory,
//    and the 8 blocks of a cluster through distributed shared memory: each
//    block writes its sum of every column into the shared memory of the
//    block that finishes that column (block s: columns [s, s + 1) * COLS /
//    8 of the tile); one cluster barrier later each block adds acc (read
//    at the start) and stores. No memset, no atomics, no second launch.
//  * A ragged M (not a multiple of 16) or a dmajor not 16-byte aligned takes
//    byte loads with a bounds check.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SPLIT = 8;              // blocks of a cluster along the budget
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 2 * THREADS;    // budget entries compacted per pass
// LANES lanes read one entry's row, 16 int8 each: a block covers
// COLS = 16 * LANES columns and a warp GROUPS = 32 / LANES entries a round
// (LANES = 4 at L <= 8 rows, so L = 1 fills the card; 8 above, so L = 16
// runs its 1,024 blocks in one wave)

__device__ __forceinline__ int sx8(uint32_t x, int b) {
  return (int)(int8_t)(x >> (8 * b));
}

template <int LANES, int U>   // U: loads in flight per lane
__global__ void __cluster_dims__(1, SPLIT, 1) __launch_bounds__(THREADS)
delta_update_kernel(const int32_t* __restrict__ acc,
                    const int8_t* __restrict__ dmajor,
                    const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ w, int32_t* __restrict__ out,
                    int M, int D, int K, bool vec) {
  constexpr int COLS = 16 * LANES, GROUPS = 32 / LANES;
  constexpr int PER = COLS / SPLIT;         // columns each block finishes
  __shared__ int32_t is[CHUNK];             // dense clamped indices
  __shared__ int32_t ws[CHUNK];             // dense weights
  __shared__ int32_t wcount[2 * WARPS];     // weighted entries per ballot
  __shared__ int32_t red[WARPS][COLS];      // per-warp partial sums
  __shared__ int32_t recv[SPLIT][PER];      // every block's sums of mine

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / LANES, sub = lane % LANES;
  const int s = blockIdx.y;                 // == cluster.block_rank()
  const int l = blockIdx.z;
  const size_t rk = (size_t)l * K;
  // block s takes the 32-entry runs s, s + SPLIT, ... of the budget: the
  // weighted entries, which lead the budget, spread over the cluster
  const int runs = (K + 31) / 32;
  const int c0 = blockIdx.x * COLS + sub * 16;   // this lane's 16 columns
  // the columns this block finishes: read acc now, add it at the end
  const int col = blockIdx.x * COLS + s * PER + tid;
  const size_t o = (size_t)l * M + col;
  const int acc_o = tid < PER && col < M ? acc[o] : 0;

  int a[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = 0;

  for (int r0 = s; r0 < runs; r0 += SPLIT * 2 * WARPS) {
    // compact the weighted entries of this block's next 2 * WARPS runs (a
    // run a warp and ballot), in budget order
    int wk[2], ik[2];
    unsigned bal[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 32 * (r0 + SPLIT * (h * WARPS + warp)) + lane;
      wk[h] = k < K ? w[rk + k] : 0;
      ik[h] = k < K ? idx[rk + k] : 0;
      bal[h] = __ballot_sync(0xffffffffu, wk[h] != 0);
      if (lane == 0) wcount[h * WARPS + warp] = __popc(bal[h]);
    }
    __syncthreads();
    // ballot g = h * WARPS + warp: its entries follow those of every
    // earlier ballot
    const unsigned below = (1u << lane) - 1u;
    int n = 0, pos[2] = {0, 0};
    for (int g = 0; g < 2 * WARPS; ++g) {
      if (g == warp) pos[0] = n + __popc(bal[0] & below);
      if (g == WARPS + warp) pos[1] = n + __popc(bal[1] & below);
      n += wcount[g];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (wk[h] != 0) {
        const int ix = ik[h] < 0 ? ik[h] + D : ik[h];   // wrap, then clamp
        is[pos[h]] = min(max(ix, 0), D - 1);
        ws[pos[h]] = wk[h];
      }
    }
    __syncthreads();

    // gather: group grp of warp `warp` takes entries e0 + u * GROUPS + grp
    if (c0 < M) {
      for (int e0 = warp * GROUPS * U; e0 < n; e0 += WARPS * GROUPS * U) {
        int wt[U];
        uint4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * GROUPS + grp;
          wt[u] = 0;
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (e < n) {
            wt[u] = ws[e];
            const int8_t* row = dmajor + (size_t)is[e] * M + c0;
            if (vec) {
              v[u] = __ldg(reinterpret_cast<const uint4*>(row));
            } else {
              uint32_t b[4] = {0u, 0u, 0u, 0u};
              for (int j = 0; j < 16 && c0 + j < M; ++j) {
                b[j >> 2] |= (uint32_t)(uint8_t)row[j] << (8 * (j & 3));
              }
              v[u] = make_uint4(b[0], b[1], b[2], b[3]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const uint32_t x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int j = 0; j < 16; ++j) a[j] += wt[u] * sx8(x[j >> 2], j & 3);
        }
      }
    }
    __syncthreads();   // the dense list is consumed before the next chunk
  }

  // the groups of a warp hold the same columns: fold them into group 0
#pragma unroll
  for (int off = LANES; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
  }
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < 16; ++j) red[warp][sub * 16 + j] = a[j];
  }
  __syncthreads();
  // the block's sum of each column goes to the block that finishes it
  if (tid < COLS) {
    int t = 0;
#pragma unroll
    for (int g = 0; g < WARPS; ++g) t += red[g][tid];
    *cluster.map_shared_rank(&recv[s][tid % PER], tid / PER) = t;
  }
  cluster.sync();   // every block's sums are in place; none is read remotely
  if (tid < PER && col < M) {
    int t = acc_o;
#pragma unroll
    for (int r = 0; r < SPLIT; ++r) t += recv[r][tid];
    out[o] = t;
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
  const bool vec = (M & 15) == 0 && ((uintptr_t)dmajor & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* a = (const int32_t*)acc;
  const int8_t* dm = (const int8_t*)dmajor;
  const int32_t *ix = (const int32_t*)idx, *wt = (const int32_t*)w;
  if (L <= 8) {
    const dim3 grid((M + 63) / 64, SPLIT, L);
    delta_update_kernel<4, 4><<<grid, THREADS, 0, s>>>(
        a, dm, ix, wt, (int32_t*)out, M, D, K, vec);
  } else {
    const dim3 grid((M + 127) / 128, SPLIT, L);
    delta_update_kernel<8, 4><<<grid, THREADS, 0, s>>>(
        a, dm, ix, wt, (int32_t*)out, M, D, K, vec);
  }
  return (int)cudaGetLastError();
}
