// Fused full-path scores on Hopper (sm_90a): scan, accumulate, argmax, top-2.
//
// Replaces the TPU kernel src/repro/kernels/fused_window.py::fused_scores
// (body _fused_kernel). For query row n and class row m over the W words of
// a static plan's enabled columns:
//   acc[n, m] = d_eff - 2 * sum_w popc(q[n, w] ^ im[m, w])
//   best[n]   = the first m holding the row's maximum (jnp.argmax)
//   top2[n]   = (the maximum, the largest value at any other index), which
//               is lax.top_k(acc, 2)[0]: a tied maximum gives top2[1] ==
//               top2[0]; with M == 1 top2[1] is INT32_MIN.
//
// What bounds it on the H100: the switch step launches it per window at
// N = 128 proposals, the batched switch lowering at up to N = 2048, against
// M = 1024 classes over W = 256 words. It reads 1.2 MB and writes 0.5 MB at
// N = 128 (0.5 us at 3.35 TB/s) and does N*M*W word pairs. As xor and
// popcount (16 popcounts per SM per clock) they take 8 us at N = 128 and
// 128 us at N = 2048; as int8 products on the tensor cores (2*N*M*32W
// operations at 1,979 TOP/s) 1.1 and 17 us. Operations bound it.
//
// What the design does about it: the products run on the int8 tensor cores.
// A word's 32 bits are its 32 dimensions (bit i of word w is dimension
// 32w + i). With b the 0/1 bits, popc(q ^ h) = popc(q) + popc(h) -
// 2 * (q . h), so
//   acc = d_eff - 2 * (pq + ph) + 4 * dot,   dot = sum of b_q * b_h,
// exact in int32, where pq and ph are the rows' set bits over the W words;
// zero words (padding) add nothing to any term. (The +-1 form, dot_pm1 =
// 32W - 2 * hamming and acc = dot_pm1 + d_eff - 32W, is the same product;
// 0/1 bytes take two fewer instructions a nibble to unpack.) dot is
// mma.sync.m16n8k32.s32.u8.u8: one k32 step is one word, and a lane's
// fragment holds two nibbles of a word (bits 4t..4t+3 and 16+4t..16+4t+3),
// each spread to four 0/1 bytes by a multiply ((nib * 0x204081) &
// 0x01010101), so operands are unpacked in registers, never stored.
//  * Classes are the mma's M side (16 a tile, MT = 2 tiles = 32 classes a
//    warp, BM = 128 a block's 4 warps along the classes), queries its N
//    side (8 a tile, NT tiles: BQ = 8 * NT queries a block, NT = 2 below
//    N = 1024, else 4: at N = 2048 32-query tiles took 0.130 ms of device
//    time on an H100 against 0.161 with 16, perf/kernel_ab.py). Unpacking,
//    not the tensor cores, sets the pace,
//    and a class word is unpacked once per query tile, so the tiles are
//    as tall as the card allows: 16 queries on 64 blocks at N = 128 rather
//    than 8 queries on 128 blocks, which unpack every class word twice as
//    often.
//  * KS = 2 warp groups split each stage's words (a block has 8 warps), so
//    each SM scheduler has two warps to hide the unpack and mma latency;
//    the groups' shares are added in the epilogue.
//  * A thread-block cluster of CL = 8 blocks covers every class of BQ
//    queries (block r owns classes [r*Mb, (r+1)*Mb), Mb a multiple of BM,
//    walked BM at a time): N = 128 runs 8 clusters, 64 blocks.
//  * Packed words stream through a 3-stage cp.async ring of KC = 16-word
//    chunks (16-byte copies, zero fill at the ragged edges; 4-byte copies
//    when W % 4 != 0), rows padded to 20 words so the 8 rows a warp reads
//    at once fall in different banks. Each lane popcounts one of the four
//    words of a row it loads for pq and ph.
//  * Epilogue: the accumulators go through shared memory, acc is stored
//    coalesced (16 bytes a lane when M % 4 == 0), and a warp per query row
//    folds the block's (max, first index, largest other) triple. The
//    cluster's blocks then meet through distributed shared memory: block r
//    merges rows r, r + 8, ... over the 8 blocks in class order, the lower
//    index winning equal maxima and other = max(other_a, other_b,
//    min(max_a, max_b)) -- _fused_kernel's finalize rule -- and stores
//    best and top2. One launch, no scratch, no atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;        // blocks of a cluster, along the classes
constexpr int WARPS_M = 4;   // warps along the classes
constexpr int MT = 2;        // m16 class tiles per warp
constexpr int WM = 16 * MT;  // classes per warp
constexpr int BM = WARPS_M * WM;
constexpr int KC = 16;       // words per ring stage
constexpr int SW = KC + 4;   // padded row stride in words
constexpr int STAGES = 3;
constexpr int TS = BM + 4;   // row stride of the epilogue tile in words

__device__ __forceinline__ uint32_t spread(uint32_t x, int sh) {
  return (((x >> sh) & 0xFu) * 0x00204081u) & 0x01010101u;
}

// word i of four
__device__ __forceinline__ uint32_t comp(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a 16-byte (vec) or 4-byte copy, zero-filled when !ok
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok,
                                         bool vec) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (v, i, s) <- merge with (ov, oi, os): the lower index wins equal maxima
__device__ __forceinline__ void merge(int& v, int& i, int& s, int ov, int oi,
                                      int os) {
  if (v > ov || (v == ov && i < oi)) {
    s = max(s, ov);
  } else {
    s = max(os, v);
    v = ov;
    i = oi;
  }
}

// NT: n8 query tiles per warp (BQ = 8 * NT queries a block); KS: warp
// groups along the words of a stage (a block has WARPS_M * KS warps)
template <int NT, int KS, bool VEC>
__global__ void __launch_bounds__(WARPS_M * KS * 32)
fused_scores_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ im,
                    int32_t* __restrict__ acc, int32_t* __restrict__ best,
                    int32_t* __restrict__ top2, int N, int M, int W,
                    int d_eff, bool vst) {
  constexpr int WARPS = WARPS_M * KS, THREADS = WARPS * 32;
  constexpr int BQ = 8 * NT;
  constexpr int ROWS = BM + BQ;                  // staged rows per stage
  constexpr int RING = STAGES * ROWS * SW;       // words
  static_assert(KS * BQ * TS <= RING, "the epilogue tiles fit in the ring");
  __shared__ __align__(16) uint32_t smem[RING];
  __shared__ int tv[BQ], ti[BQ], tsec[BQ];       // the block's triples

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = blockIdx.x;                      // == cluster.block_rank()
  const int q0 = blockIdx.y * BQ;
  const int span = ((M + CL - 1) / CL + BM - 1) / BM * BM;
  const int m_lo = r * span, m_hi = min(M, m_lo + span);
  const int nk = (W + KC - 1) / KC;
  const int wc = (warp % WARPS_M) * WM, kg = warp / WARPS_M;

  if (tid < BQ) {
    tv[tid] = INT_MIN;
    ti[tid] = INT_MAX;
    tsec[tid] = INT_MIN;
  }

  for (int m0 = m_lo; m0 < m_hi; m0 += BM) {
    auto load = [&](int kc, int stage) {
      uint32_t* st = smem + stage * ROWS * SW;
      const int k0 = kc * KC;
      constexpr int PER = VEC ? KC / 4 : KC;     // copies per row
      for (int i = tid; i < ROWS * PER; i += THREADS) {
        const int row = i / PER, c = (i - row * PER) * (VEC ? 4 : 1);
        const int word = k0 + c;
        const uint32_t* src;
        bool ok;
        if (row < BM) {
          const int m = m0 + row;
          ok = m < m_hi && word < W;
          src = im + (size_t)m * W + word;
        } else {
          const int n = q0 + row - BM;
          ok = n < N && word < W;
          src = q + (size_t)n * W + word;
        }
        cp_async(st + row * SW + c, ok ? src : im, ok, VEC);
      }
    };

    int c[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0;
    int ph[MT][2];   // set bits of class rows g, g + 8 of each tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ph[mt][0] = ph[mt][1] = 0;
    int pq[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) pq[nt] = 0;

    __syncthreads();   // the previous sub-tile's epilogue left the ring
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load(s, s);
      cp_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      if (kc + STAGES - 1 < nk) load(kc + STAGES - 1, (kc + STAGES - 1) % STAGES);
      cp_commit();
      const uint32_t* st = smem + (kc % STAGES) * ROWS * SW;
#pragma unroll
      for (int j4 = kg; j4 < KC / 4; j4 += KS) {   // this group's words
        uint4 a[MT][2], b[NT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            a[mt][h] = *reinterpret_cast<const uint4*>(
                st + (wc + mt * 16 + h * 8 + g) * SW + j4 * 4);
            ph[mt][h] += __popc(comp(a[mt][h], t));
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          b[nt] = *reinterpret_cast<const uint4*>(
              st + (BM + nt * 8 + g) * SW + j4 * 4);
          pq[nt] += __popc(comp(b[nt], t));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b0[NT], b1[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint32_t x = comp(b[nt], j);
            b0[nt] = spread(x, 4 * t);
            b1[nt] = spread(x, 4 * t + 16);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t x0 = comp(a[mt][0], j), x1 = comp(a[mt][1], j);
            const uint32_t r0 = spread(x0, 4 * t), r1 = spread(x1, 4 * t);
            const uint32_t r2 = spread(x0, 4 * t + 16);
            const uint32_t r3 = spread(x1, 4 * t + 16);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma_u8(c[mt][nt], r0, r1, r2, r3, b0[nt], b1[nt]);
            }
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();   // every warp is done with the ring

    // the four lanes of a group saw one word in four of each row
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ph[mt][h] += __shfl_xor_sync(0xffffffffu, ph[mt][h], 1);
        ph[mt][h] += __shfl_xor_sync(0xffffffffu, ph[mt][h], 2);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      pq[nt] += __shfl_xor_sync(0xffffffffu, pq[nt], 1);
      pq[nt] += __shfl_xor_sync(0xffffffffu, pq[nt], 2);
    }
    // each word group's share, 4 * dot - 2 * (pq + ph) over its words, in
    // its own [BQ][TS] tile; the store below adds them and d_eff
    int32_t* tile = reinterpret_cast<int32_t*>(smem);   // [KS][BQ][TS]
    int32_t* mine = tile + kg * BQ * TS;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // query nt*8 + 2t + e: its set bits sit in group 2t + e
        const int pqv = __shfl_sync(0xffffffffu, pq[nt], (2 * t + e) * 4);
        const int qr = nt * 8 + 2 * t + e;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cls = wc + mt * 16 + h * 8 + g;
            mine[qr * TS + cls] =
                4 * c[mt][nt][2 * h + e] - 2 * (pqv + ph[mt][h]);
          }
        }
      }
    }
    __syncthreads();

    // acc, coalesced
    const int width = min(BM, m_hi - m0);
    for (int i = tid; i < BQ * (BM / 4); i += THREADS) {
      const int qr = i / (BM / 4), cc = (i - qr * (BM / 4)) * 4;
      int4 v = make_int4(d_eff, d_eff, d_eff, d_eff);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int4 x =
            *reinterpret_cast<const int4*>(tile + (k * BQ + qr) * TS + cc);
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
      *reinterpret_cast<int4*>(tile + qr * TS + cc) = v;
      if (q0 + qr < N && cc < width) {
        int32_t* dst = acc + (size_t)(q0 + qr) * M + m0 + cc;
        if (vst) {
          *reinterpret_cast<int4*>(dst) = v;
        } else {
          const int vv[4] = {v.x, v.y, v.z, v.w};
          for (int j = 0; j < 4 && cc + j < width; ++j) dst[j] = vv[j];
        }
      }
    }
    __syncthreads();
    // the sub-tile's triple of each query row, folded into the block's
    for (int qr = warp; qr < BQ; qr += WARPS) {
      int v = INT_MIN, vi = INT_MAX, sec = INT_MIN;
#pragma unroll
      for (int j = 0; j < BM / 32; ++j) {
        const int cc = j * 32 + lane;   // rises: strict > keeps the first
        if (cc < width) {
          const int x = tile[qr * TS + cc];
          if (x > v) {
            sec = v;
            v = x;
            vi = m0 + cc;
          } else {
            sec = max(sec, x);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        merge(v, vi, sec, __shfl_xor_sync(0xffffffffu, v, off),
              __shfl_xor_sync(0xffffffffu, vi, off),
              __shfl_xor_sync(0xffffffffu, sec, off));
      }
      if (lane == 0) {
        int bv = tv[qr], bi = ti[qr], bs = tsec[qr];
        merge(bv, bi, bs, v, vi, sec);
        tv[qr] = bv;
        ti[qr] = bi;
        tsec[qr] = bs;
      }
    }
  }

  cluster.sync();   // every block's triples are in its shared memory
  const int qr = r + CL * tid;   // block r finishes rows r, r + CL, ...
  if (qr < BQ) {
    int v = INT_MIN, vi = INT_MAX, sec = INT_MIN;
#pragma unroll
    for (int rr = 0; rr < CL; ++rr) {
      merge(v, vi, sec, cluster.map_shared_rank(tv, rr)[qr],
            cluster.map_shared_rank(ti, rr)[qr],
            cluster.map_shared_rank(tsec, rr)[qr]);
    }
    if (q0 + qr < N) {
      best[q0 + qr] = vi;
      top2[2 * (size_t)(q0 + qr)] = v;
      top2[2 * (size_t)(q0 + qr) + 1] = sec;
    }
  }
  cluster.sync();   // no block leaves while another reads its triples
}

template <int NT, int KS, bool VEC>
cudaError_t launch(const void* q, const void* im, void* acc, void* best,
                   void* top2, int N, int M, int W, int d_eff, bool vst,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, (N + 8 * NT - 1) / (8 * NT));
  cfg.blockDim = dim3(WARPS_M * KS * 32);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CL;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_scores_kernel<NT, KS, VEC>, (const uint32_t*)q, (const uint32_t*)im, (int32_t*)acc,
      (int32_t*)best, (int32_t*)top2, N, M, W, d_eff, vst);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int NT, int KS>
cudaError_t launch(const void* q, const void* im, void* acc, void* best,
                   void* top2, int N, int M, int W, int d_eff, bool vec,
                   bool vst, cudaStream_t s) {
  return vec ? launch<NT, KS, true>(q, im, acc, best, top2, N, M, W, d_eff,
                                    vst, s)
             : launch<NT, KS, false>(q, im, acc, best, top2, N, M, W, d_eff,
                                     vst, s);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int fused_scores_launch(const void* q, const void* im, void* acc,
                                   void* best, void* top2, int N, int M,
                                   int W, int d_eff, void* stream) {
  if (N <= 0 || M <= 0 || W < 0 || N > 65535 * 8) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = W % 4 == 0 && ((uintptr_t)q & 15) == 0 &&
                   ((uintptr_t)im & 15) == 0;
  const bool vst = M % 4 == 0 && ((uintptr_t)acc & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(N >= 1024
                   ? launch<4, 2>(q, im, acc, best, top2, N, M, W, d_eff,
                                  vec, vst, s)
                   : launch<2, 2>(q, im, acc, best, top2, N, M, W, d_eff,
                                  vec, vst, s));
}
