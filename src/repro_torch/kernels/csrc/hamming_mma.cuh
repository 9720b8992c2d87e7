// Shared mainloop of the two hamming kernels (bank_prefix_hamming.cu,
// packed_hamming_batched.cu) on Hopper's 1-bit tensor cores.
//
// Identity. Over the words of a row pair, with pq and ph the set bits of
// the query and the class row and dot the count of bits set in both,
//   hamming(q, h) = sum_w popc(q_w ^ h_w) = pq + ph - 2 * dot,
// exact in int32 for any width (at most 32 W <= 2^26 here). dot is
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc on the packed
// words as they are: a k256 step is 8 words, nothing is unpacked. Queries
// are the mma's M side (16 rows a tile), classes its N side (8 a tile).
// pq and ph come from the same instruction against all-ones words (the
// queries times an all-ones n8 tile, an all-ones m16 tile times the
// classes), so they land in the accumulators' own layout: no popcount,
// no shuffle, and the counts are three accumulators added per output.
// Zero words add nothing to pq, ph or dot, so zero fill past a ragged
// edge, and a plan's disabled words zeroed by the caller, are exact.
//
// Banks. Row words are cap banks of epw = W / cap words. Each bank is
// padded with zero words to epw8 = roundup(epw, 8) in shared memory, so a
// k-step never straddles a bank boundary (epw % 8 == 0 on every serving
// shape: no padding there). After the last k-step of bank b the running
// accumulators give the prefix count of banks 0..b: the kernel emits
// pq + ph - 2 * dot for each of the warp's outputs into a per-warp staging
// tile [16 queries][8 NT classes][G slots], G = min(cap, 8). When G banks
// are staged (or the last bank is), the warp copies the tile to out
// [N, M, cap] row by row: with cap <= 8 each query row's run of classes x
// cap counts is contiguous in out, so the copy is whole 128-byte lines
// (16-byte stores when cap == 8), never the 4-byte strided stores a lane
// owning an (n, m) pair would make. packed_hamming_batched is the cap == 1
// case: one bank, one emission.
//
// Feeding. A ring of STAGES stages of KC padded words of the block's BQ
// query and BC class rows in dynamic shared memory, filled with 16-byte
// cp.async.cg (when epw % 8 == 0 and the pointers are 16-byte aligned;
// 4-byte cp.async.ca with the bank padding otherwise), zero-filled past
// N, M and the padded width; the loop waits with STAGES - 2 groups in
// flight. Rows are padded to KC + 4 words (KC % 32 == 0), so each 8-row
// ldmatrix phase touches 32 distinct banks. A warp reads its fragments
// with ldmatrix.x4: for A (16 queries x 8 words) the four 8 x 4-word
// matrices are exactly a0..a3 (lane (g, t) gets word t of row g, row
// g + 8, then words t + 4), for B two n8 tiles' b0, b1 at once.
//
// Blocks. WQ x WC warps, each a 16 x 8 NT (queries x classes) tile over
// the whole padded width; grid (class tiles, query tiles, batch). Each .cu
// wraps prefix_block in a __global__ of its own name (so a profile tells
// the kernels apart) and launches it with launch(); the
// cudaFuncSetAttribute for the dynamic shared memory runs once per
// kernel, device and process.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace ham {

__device__ __forceinline__ void mma_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint32_t* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], const uint32_t* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
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

template <int WQ_, int WC_, int NT_, int KC_, int STAGES_, int KW_>
struct Tile {
  static constexpr int WQ = WQ_, WC = WC_, NT = NT_, KC = KC_;
  static constexpr int STAGES = STAGES_, KW = KW_;
  static constexpr int TILES = WQ * WC;            // output tiles a block
  static constexpr int WARPS = TILES * KW, THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WQ, BC = 8 * NT * WC, ROWS = BQ + BC;
  static constexpr int SW = KC + 4;   // ring row stride, words
  static_assert(KC % 32 == 0 && (NT == 1 || NT % 2 == 0) &&
                    (KC / 8) % KW == 0 &&
                    KW * TILES * 16 * 8 * NT <= STAGES * ROWS * SW,
                "tile shape");
  // staging row stride in elements of `bytes` bytes for G slots a class
  // (rows stay 16-byte aligned and start on different banks)
  static __host__ __device__ int cs(int G, int bytes) {
    return 8 * NT * G + 16 / bytes;
  }
  static size_t smem_bytes(int G, int bytes) {
    return 4 * (size_t)STAGES * ROWS * SW +
           (size_t)TILES * 16 * cs(G, bytes) * bytes;
  }
};

// out[s, n, m, b] = hamming of query n and class m of batch s over banks
// 0..b; q [S, N, W], h [S, M, W], out [S, N, M, cap]; the body of one
// block of T::THREADS threads. With T::KW > 1 (cap == 1 only) the KW
// warps of an output tile take the k-steps j, j + KW, ... of each stage
// and their partial counts are added in warp order after the loop.
// NARROW stages the counts as 16-bit values (they are below 65,536 when
// 32 W is), halving the staging tile.
template <class T, bool VEC, bool NARROW>
__device__ __forceinline__ void prefix_block(const uint32_t* __restrict__ q,
                                             const uint32_t* __restrict__ h,
                                             int32_t* __restrict__ out, int N,
                                             int M, int W, int cap) {
  constexpr int NT = T::NT, KC = T::KC, STAGES = T::STAGES, SW = T::SW;
  constexpr int KW = T::KW, TILES = T::TILES, THREADS = T::THREADS;
  constexpr int BQ = T::BQ, BC = T::BC, ROWS = T::ROWS;
  extern __shared__ __align__(16) uint32_t smem[];
  using ST = typename std::conditional<NARROW, uint16_t, int32_t>::type;
  const int G = min(cap, 8), CS = T::cs(G, sizeof(ST));
  uint32_t* ring = smem;                                      // [STAGES][ROWS][SW]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = warp % TILES, kw = warp / TILES;
  const int wq = tile % T::WQ, wc = tile / T::WQ;
  ST* so = reinterpret_cast<ST*>(smem + STAGES * ROWS * SW) +
           tile * 16 * CS;                                    // [16][CS]
  const size_t sb = blockIdx.z;
  q += sb * N * W;
  h += sb * M * W;
  out += sb * N * M * cap;
  const int q0 = blockIdx.y * BQ, m0 = blockIdx.x * BC;
  // (a bank of no words, W = 0, still takes one k-step of zeros)
  const int epw = W / cap, epw8 = max(8, (epw + 7) & ~7), kspb = epw8 / 8;
  const int nsteps = cap * kspb;                 // k-steps of 8 padded words
  const int nk = (8 * nsteps + KC - 1) / KC;

  // 16-byte copies: each thread's copies sit at fixed rows and columns of
  // every stage, so their addresses are computed once
  constexpr int PER4 = KC / 4;                   // 16-byte copies a row
  constexpr int SLOTS = (ROWS * PER4 + THREADS - 1) / THREADS;
  const uint32_t* vsrc[SLOTS];
  int vdst[SLOTS], vcol[SLOTS];
  bool vok[SLOTS];
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int i = tid + k * THREADS;
      const int row = i / PER4, col = (i - row * PER4) * 4;
      bool ok;
      const uint32_t* src;
      if (row < BQ) {
        ok = q0 + row < N;
        src = q + (size_t)(q0 + row) * W + col;
      } else {
        ok = m0 + row - BQ < M;
        src = h + (size_t)(m0 + row - BQ) * W + col;
      }
      vok[k] = ok;
      vsrc[k] = ok ? src : q;
      vdst[k] = i < ROWS * PER4 ? row * SW + col : -1;   // -1: no copy
      vcol[k] = col;
    }
  }
  auto load = [&](int kc, int stage) {
    uint32_t* st = ring + stage * ROWS * SW;
    if constexpr (VEC) {                         // epw8 == epw: no padding
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (vdst[k] < 0) continue;
        const bool ok = vok[k] && kc * KC + vcol[k] < W;
        cp_async(st + vdst[k], ok ? vsrc[k] + kc * KC : q, ok, true);
      }
    } else {
      for (int i = tid; i < ROWS * KC; i += THREADS) {
        const int row = i / KC, c = i - row * KC;
        const int p = kc * KC + c;               // padded word index
        const int b = p / epw8, j = p - b * epw8;
        bool ok = b < cap && j < epw;
        const uint32_t* src;
        if (row < BQ) {
          ok = ok && q0 + row < N;
          src = q + (size_t)(q0 + row) * W + b * epw + j;
        } else {
          ok = ok && m0 + row - BQ < M;
          src = h + (size_t)(m0 + row - BQ) * W + b * epw + j;
        }
        cp_async(st + row * SW + c, ok ? src : q, ok, false);
      }
    }
  };

  // the warp's rows in a stage, and its lanes' ldmatrix row addresses
  const int rq = wq * 16, rc = BQ + wc * 8 * NT;
  const int a_off = (rq + (lane & 7) + 8 * ((lane >> 3) & 1)) * SW +
                    4 * (lane >> 4);
  const int b_off = (rc + (lane & 7) + 8 * (lane >> 4)) * SW +
                    4 * ((lane >> 3) & 1);
  const int n_base = q0 + rq, m_base = m0 + wc * 8 * NT;

  // dot, and the set bits of the queries (pq: the product with all-ones
  // classes) and of the classes (ph: all-ones queries times the classes),
  // all on the tensor cores, in the accumulators' layout: lane (g, t)
  // holds rows g, g + 8 and classes 2t, 2t + 1 of each n8 tile
  int c[NT][4], ph[NT][4], pq[4] = {0, 0, 0, 0};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = ph[nt][e] = 0;
  const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};

  // pq + ph - 2 * dot over the words seen so far, for the lane's outputs
  auto counts = [&](int (&v)[NT][4]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[nt][e] = pq[e] + ph[nt][e] - 2 * c[nt][e];
  };
  auto stage_counts = [&](const int (&v)[NT][4], int slot) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t;
      so[g * CS + col * G + slot] = (ST)v[nt][0];
      so[g * CS + (col + 1) * G + slot] = (ST)v[nt][1];
      so[(g + 8) * CS + col * G + slot] = (ST)v[nt][2];
      so[(g + 8) * CS + (col + 1) * G + slot] = (ST)v[nt][3];
    }
  };
  // copy the staged banks b0 .. b0 + gs - 1 of the warp's tile to out
  auto flush = [&](int b0, int gs) {
    __syncwarp();
    const int cols = min(8 * NT, M - m_base);
    if (cap == 8 && gs == 8 && cols == 8 * NT) {
      // a row's 8 NT x 8 counts are contiguous in out: 16-byte copies
      constexpr int PER = 16 * NT;
#pragma unroll 4
      for (int i = lane; i < 16 * PER; i += 32) {
        const int r = i / PER, e = i % PER;
        if (n_base + r < N) {
          int4 x;
          if constexpr (NARROW) {
            const uint2 y = *reinterpret_cast<const uint2*>(so + r * CS + 4 * e);
            x = make_int4(y.x & 0xFFFF, y.x >> 16, y.y & 0xFFFF, y.y >> 16);
          } else {
            x = *reinterpret_cast<const int4*>(so + r * CS + 4 * e);
          }
          *reinterpret_cast<int4*>(
              out + ((size_t)(n_base + r) * M + m_base) * 8 + 4 * e) = x;
        }
      }
    } else if (cap == 1 && cols == 8 * NT) {
      // one count a class: a row's 8 NT counts are contiguous in out
      constexpr int PER = 8 * NT;
      for (int i = lane; i < 16 * PER; i += 32) {
        const int r = i / PER, e = i % PER;
        if (n_base + r < N) {
          out[(size_t)(n_base + r) * M + m_base + e] = so[r * CS + e];
        }
      }
    } else if (cols > 0) {
      const int per = cols * gs;
      for (int i = lane; i < 16 * per; i += 32) {
        const int r = i / per, e = i - r * per;
        const int col = e / gs, k = e - col * gs;
        if (n_base + r < N) {
          out[((size_t)(n_base + r) * M + m_base + col) * cap + b0 + k] =
              so[r * CS + col * G + k];
        }
      }
    }
    __syncwarp();
  };

  int b0 = 0;              // first bank of the staged group
  int bank = 0;            // the bank being scanned
  int kb = 0;              // k-steps done in it
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
    const uint32_t* st = ring + (kc % STAGES) * ROWS * SW;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      if (kc * (KC / 8) + j >= nsteps) break;
      if (KW > 1 && j % KW != kw) continue;      // another warp's k-step
      uint32_t a[4];
      ldsm_x4(a, st + a_off + 8 * j);
      mma_and_popc(pq, a, ~0u, ~0u);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        if (NT == 1) {
          ldsm_x2(b, st + b_off + 8 * j);
        } else {
          ldsm_x4(b, st + b_off + nt * 8 * SW + 8 * j);
        }
        mma_and_popc(c[nt], a, b[0], b[1]);
        mma_and_popc(ph[nt], ones, b[0], b[1]);
        if (NT > 1) {
          mma_and_popc(c[nt + 1], a, b[2], b[3]);
          mma_and_popc(ph[nt + 1], ones, b[2], b[3]);
        }
      }
      if (KW > 1 || ++kb < kspb) continue;
      // bank boundary: stage the counts of banks 0..b
      kb = 0;
      const int b = bank++;
      int v[NT][4];
      counts(v);
      stage_counts(v, b - b0);
      if (b - b0 + 1 == G || b + 1 == cap) {
        flush(b0, b - b0 + 1);
        b0 = b + 1;
      }
    }
  }
  cp_wait<0>();
  if constexpr (KW > 1) {    // cap == 1: add the KW warps' shares in order
    __syncthreads();         // every warp is done with the ring
    int32_t* red = reinterpret_cast<int32_t*>(smem);   // [KW][TILES][16][8 NT]
    int v[NT][4];
    counts(v);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      int32_t* r = red + (kw * TILES + tile) * 16 * 8 * NT + nt * 8 + 2 * t;
      r[g * 8 * NT] = v[nt][0];
      r[g * 8 * NT + 1] = v[nt][1];
      r[(g + 8) * 8 * NT] = v[nt][2];
      r[(g + 8) * 8 * NT + 1] = v[nt][3];
    }
    __syncthreads();
    if (kw == 0) {
      for (int i = lane; i < 16 * 8 * NT; i += 32) {
        int sum = 0;
#pragma unroll
        for (int k = 0; k < KW; ++k) sum += red[(k * TILES + tile) * 16 * 8 * NT + i];
        so[(i / (8 * NT)) * CS + i % (8 * NT)] = (ST)sum;
      }
      flush(0, 1);
    }
  }
}

using KernelFn = void (*)(const uint32_t*, const uint32_t*, int32_t*, int,
                         int, int, int);

// Launch kernel<T, VEC, NARROW> (a __global__ around prefix_block) for
// [S] x [N, W] x [M, W] -> [S, N, M, cap]; the four function pointers are
// its instantiations (VEC, NARROW) = (1, 1), (1, 0), (0, 1), (0, 0)
template <class T, KernelFn VN, KernelFn VW, KernelFn WN, KernelFn WW>
cudaError_t launch(const void* q, const void* h, void* out, int S, int N,
                   int M, int W, int cap, cudaStream_t stream) {
  if (S <= 0 || N <= 0 || M <= 0 || W < 0 || cap <= 0 || W % cap != 0 ||
      (T::KW > 1 && cap != 1) || (N + T::BQ - 1) / T::BQ > 65535 ||
      S > 65535) {
    return cudaErrorInvalidValue;
  }
  const int epw = W / cap;
  const bool vec = epw % 8 == 0 && epw > 0 && ((uintptr_t)q & 15) == 0 &&
                   ((uintptr_t)h & 15) == 0;
  const bool narrow = 32L * W < 65536;
  const size_t smem = T::smem_bytes(cap < 8 ? cap : 8, narrow ? 2 : 4);
  // once per kernel, device and process (the attribute is per device):
  // the largest staging tile (G = 8)
  constexpr int kDevices = 64;
  static std::once_flag once[kDevices];
  static cudaError_t attrs[kDevices];
  int dev = 0;
  cudaError_t attr = cudaGetDevice(&dev);
  if (attr == cudaSuccess && (dev < 0 || dev >= kDevices)) {
    attr = cudaErrorInvalidDevice;
  }
  if (attr == cudaSuccess) {
    std::call_once(once[dev], [dev] {
      cudaError_t e = cudaSuccess;
      const KernelFn fns[4] = {VN, VW, WN, WW};
      for (int i = 0; i < 4; ++i) {
        const cudaError_t ei = cudaFuncSetAttribute(
            fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)T::smem_bytes(8, i % 2 == 0 ? 2 : 4));
        if (e == cudaSuccess) e = ei;
      }
      attrs[dev] = e;
    });
    attr = attrs[dev];
  }
  if (attr != cudaSuccess) {
    cudaGetLastError();   // clear it, so the next launch does not report it
    return attr;
  }
  const dim3 grid((M + T::BC - 1) / T::BC, (N + T::BQ - 1) / T::BQ, S);
  const KernelFn fn = vec ? (narrow ? VN : VW) : (narrow ? WN : WW);
  fn<<<grid, T::THREADS, smem, stream>>>(
      (const uint32_t*)q, (const uint32_t*)h, (int32_t*)out, N, M, W, cap);
  return cudaGetLastError();
}

}  // namespace ham
