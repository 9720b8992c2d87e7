// Shared mainloops of the two encode kernels (sign_project.cu,
// sign_project_pack.cu): y = z @ R^T on the tensor cores in 3xTF32, with
// the float32 y kept on chip and handed to an epilogue that writes only the
// signs.
//
// Split. Each operand element x is split in registers into
// big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big) (x - big is
// exact in float32), and every k8 step accumulates small*big, then
// big*small, then big*big into float32 accumulators: the dropped
// small*small term and the rounding of small keep about 22 of the 24
// mantissa bits, an error of about 2^-21 |z*R| per product (the scheme of
// CUTLASS's OpMultiplyAddFastF32).
//
// Feeding. A ring of STAGES raw tiles of z and R in dynamic shared memory,
// filled with 16-byte cp.async.cg (4-byte cp.async.ca when d % 4 != 0 or a
// pointer is not 16-byte aligned) with zero fill past the ragged edges of
// N, D and d; the loop waits with STAGES - 2 groups still in flight. Raw
// rows are padded to BK + 4 floats, so a warp's 32-bit loads of rows
// g = 0..7, columns t = 0..3 (and its 16-byte loads of 8 rows) fall on 32
// distinct banks.
//
// Tiles, picked by N in launch():
//   * N > 128 (the engine's 16 streams x N_max = 2048 rows): warpgroup MMA,
//     wgmma.mma_async.m64n256k8.f32.tf32.tf32 with A (z) in registers and
//     B (R) in shared memory. A 128 x 256 (rows x dims) block tile, two
//     warpgroups of 64 rows, k-stage 16, 3 raw stages; 512 blocks at
//     D = 8192. Each thread loads and splits its own A fragments (the mma
//     layout: row 16 w + g (+8), column t (+4) for warp w of its warpgroup),
//     so every z element is split once per block. R's elements would be
//     split once per warpgroup if each split its own, and the split costs
//     about nine instructions an element (cvt.rna alone is four), so all
//     256 threads split R's stage once into big and small planes in the
//     canonical K-major layout (8-row x 16-byte core matrices, no swizzle)
//     that wgmma reads through shared-memory descriptors; three plane
//     buffers rotate. The products of stage k run on the tensor cores
//     while the same threads split stage k + 1; one barrier per stage, and
//     wgmma.wait_group keeps one stage of products in flight across it.
//     The 128 x 256 tile moves a quarter fewer bytes from L2 to the SMs
//     than a 128 x 128 one: with float32 operands that traffic, more than
//     the product, held the smaller tile back.
//   * N <= 128 (a single window, the ops.sign_project caller): D on the M
//     side (the block computes R z^T) with mma.sync.aligned.m16n8k8.row.col
//     .f32.tf32.tf32.f32. z [N, d] and R [D, d] are both row-major, i.e.
//     K-major, which is what "row.col" takes. One block per 32 dims with all
//     rows, so D = 8192 gives 256 blocks and R is read from device memory
//     once; each warp splits the fragments it loads. With N <= 8 the four
//     warps split each k-stage and their partial sums are added in a fixed
//     order in the epilogue; above it each warp takes 32 rows.
//
// Zero and NaN. Masked elements are zeros, which add nothing. An all-zero
// row gives y = +-0, so y >= 0 holds as in the plain version; a NaN in a
// row makes its big and small parts NaN and every y of the row NaN, so
// y >= 0 fails as in the plain version. A +-inf feature is outside the
// split's contract: big(inf) * small(R) can turn a y of +-inf into NaN
// (CUTLASS's fast-FP32 path has the same property); the port's encode
// features are finite on every path, and nothing on the hot path checks.
//
// Epilogues. Each kernel defines an Epi with `using Out` and
//   template <class T> static __device__ void store(const float* ys,
//       Out* out, int row0, int dim0, int N, int D);
// which writes the signs of the block's float32 y tile, left in shared
// memory (the ring's space, row-major [rows][dims], read through y_at /
// y_quad; T::ROWS, T::DIMS, T::YS, T::WK, T::WARPS and T::THREADS describe
// the tile), and
//   template <class T> static __device__ void store_acc(
//       const float (&acc)[T::NA], float* smem, Out* out, int row0,
//       int dim0, int N, int D, int arow, int t);
// which does the same from the wgmma accumulators (acc_to_y puts them in
// the y tile).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sign_gemm {

constexpr int PAD = 4;   // floats of padding per raw tile row

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// x = big + small, both TF32 bit patterns, rounded to nearest (ties away)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// Copy rows [0, ROWS_T) x columns [k0, k0 + BK) of a row-major [*, d]
// operand (`rows` of them exist) into a raw stage tile, zero-filling the
// rest
template <class T, bool VEC, int ROWS_T>
__device__ __forceinline__ void load_rows(float* s, const float* g, int rows,
                                          int d, int k0, int tid) {
  constexpr int CPR = VEC ? T::BK / 4 : T::BK;   // copies per row
  constexpr int CH = ROWS_T * CPR;
#pragma unroll
  for (int c0 = 0; c0 < CH; c0 += T::THREADS) {
    const int c = c0 + tid;
    if (CH % T::THREADS == 0 || c < CH) {
      const int r = c / CPR;
      const int k = (c % CPR) * (VEC ? 4 : 1);
      const bool ok = r < rows && k0 + k < d;
      const float* src = ok ? g + (size_t)r * d + k0 + k : g;
      if (VEC) {
        cp_async16(s + r * T::LDS + k, src, ok ? 16 : 0);
      } else {
        cp_async4(s + r * T::LDS + k, src, ok ? 4 : 0);
      }
    }
  }
}

// y of block row `row` and block dim `dim`: the WK partial sums in order
template <class T>
__device__ __forceinline__ float y_at(const float* ys, int row, int dim) {
  float v = ys[row * T::YS + dim];
#pragma unroll
  for (int k = 1; k < T::WK; ++k) v += ys[(k * T::ROWS + row) * T::YS + dim];
  return v;
}

// y of dims dim .. dim + 3 (dim % 4 == 0) of block row `row`
template <class T>
__device__ __forceinline__ float4 y_quad(const float* ys, int row, int dim) {
  float4 v = *reinterpret_cast<const float4*>(ys + row * T::YS + dim);
#pragma unroll
  for (int k = 1; k < T::WK; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(
        ys + (k * T::ROWS + row) * T::YS + dim);
    v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
  }
  return v;
}

// ---------------------------------------------------------------------------
// N > 128: warpgroup MMA, A (z) from registers, B (R) from split planes

template <int BN_, int BK_, int STAGES_>
struct WgTile {
  static constexpr int BM = 128, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int PLANES = 3;       // B plane buffers in rotation
  static constexpr int KK = BK / 8;      // k8 steps per stage
  static constexpr int WARPS = 8, THREADS = WARPS * 32;   // 2 warpgroups
  static constexpr int NA = BN / 2;      // accumulators per thread
  static constexpr int WK = 1, ROWS = BM, DIMS = BN, YS = BN + 8;
  static constexpr int LDS = BK + PAD;
  static constexpr int RAW_FLOATS = (BM + BN) * LDS;
  // one k8 slab of R's BN rows in core matrices: row r, column c at
  // (r / 8) * 64 + (c / 4) * 32 + (r % 8) * 4 + c % 4 floats (SBO 256
  // bytes between 8-row groups, LBO 128 bytes between the 4-column halves)
  static constexpr int SLAB = BN * 8;
  static constexpr int PLANE_FLOATS = 2 * KK * SLAB;     // big, then small
  static constexpr int LOOP_FLOATS =
      STAGES * RAW_FLOATS + PLANES * PLANE_FLOATS;
  static constexpr int Y_FLOATS = ROWS * YS;
  static constexpr int SMEM =
      4 * (LOOP_FLOATS > Y_FLOATS ? LOOP_FLOATS : Y_FLOATS);
  static_assert(BN == 256, "one wgmma.m64n256k8 per k8 step and operand");
  static_assert(STAGES >= 3, "the ring keeps STAGES - 2 copies in flight");
  static_assert(LDS % 8 == 4, "raw rows: conflict-free fragment loads");
};

using Large = WgTile<256, 16, 3>;

// Shared-memory matrix descriptor of a K-major core-matrix tile, no swizzle
__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3ffff) >> 4)     // start address
       | (uint64_t)(128 >> 4) << 16         // leading byte offset (K)
       | (uint64_t)(256 >> 4) << 32;        // stride byte offset (rows)
}

// d += a * b over m64 x nN x k8: a is the thread's mma-layout A fragment
// (row 16 w + g (+8), column t (+4) for warp w of the warpgroup), b the
// descriptor of R's k8 slab
__device__ __forceinline__ void wgmma(float (&d)[128], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,"
      "%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING)
               : "memory");
}
// keeps the compiler from moving accumulator accesses across a wgmma
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Split this thread's A fragments of one raw stage into registers: row is
// the thread's fragment row g of its warp's 16, t its column
template <class T>
__device__ __forceinline__ void split_a(const float* raw,
                                        uint32_t (&big)[T::KK][4],
                                        uint32_t (&small)[T::KK][4], int row,
                                        int t) {
  const float* p = raw + row * T::LDS + t;
#pragma unroll
  for (int kk = 0; kk < T::KK; ++kk) {
    split(p[kk * 8], big[kk][0], small[kk][0]);                  // g,   t
    split(p[8 * T::LDS + kk * 8], big[kk][1], small[kk][1]);     // g+8, t
    split(p[kk * 8 + 4], big[kk][2], small[kk][2]);              // g,   t+4
    split(p[8 * T::LDS + kk * 8 + 4], big[kk][3], small[kk][3]); // g+8, t+4
  }
}

// Split R's rows of one raw stage into a big and a small plane: a thread
// takes 16 bytes (4 columns) of one row, lanes 8 consecutive rows of one
// column group, so the raw loads and the plane stores are conflict-free
template <class T>
__device__ __forceinline__ void split_b(const float* raw, float* plane,
                                        int tid) {
  constexpr int CPR = T::BK / 4;                   // 16-byte chunks per row
  constexpr int CH = T::BN * CPR;
  static_assert(CH % T::THREADS == 0, "whole chunks per thread");
  const float* braw = raw + T::BM * T::LDS;
  float* small_plane = plane + T::KK * T::SLAB;
#pragma unroll
  for (int c0 = 0; c0 < CH; c0 += T::THREADS) {
    const int c = c0 + tid;
    const int r = (c / (8 * CPR)) * 8 + c % 8;
    const int q = (c / 8) % CPR;                   // columns 4q .. 4q + 3
    const float4 x =
        *reinterpret_cast<const float4*>(braw + r * T::LDS + 4 * q);
    uint4 big, small;
    split(x.x, big.x, small.x);
    split(x.y, big.y, small.y);
    split(x.z, big.z, small.z);
    split(x.w, big.w, small.w);
    const int off =
        (q >> 1) * T::SLAB + (r >> 3) * 64 + (q & 1) * 32 + (r & 7) * 4;
    *reinterpret_cast<uint4*>(plane + off) = big;
    *reinterpret_cast<uint4*>(small_plane + off) = small;
  }
  // the planes are read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int V>
struct Parity {
  static constexpr int value = V;
};

template <class T, class Epi, bool VEC>
__global__ void __launch_bounds__(T::THREADS, 1)
sign_wgmma_kernel(const float* __restrict__ z, const float* __restrict__ R,
                  typename Epi::Out* __restrict__ out, int N, int d, int D) {
  extern __shared__ __align__(1024) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this thread's fragment row: warpgroup warp >> 2 owns rows 64 (warp >> 2)
  // .., warp w of it rows 16 w ..
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int dim0 = blockIdx.x * T::BN, row0 = blockIdx.y * T::BM;
  const float* A = z + (size_t)row0 * d;
  const float* B = R + (size_t)dim0 * d;
  const int a_rows = min(T::BM, N - row0), b_rows = min(T::BN, D - dim0);

  float* raw = smem;
  float* planes = smem + T::STAGES * T::RAW_FLOATS;
  float acc[T::NA];
#pragma unroll
  for (int i = 0; i < T::NA; ++i) acc[i] = 0.f;
  // A fragments of two stages: the products of one are in flight while
  // the next is split
  uint32_t ab[2][T::KK][4], as[2][T::KK][4];

  const int ktiles = (d + T::BK - 1) / T::BK;
  auto load = [&](int kt) {
    float* s = raw + (kt % T::STAGES) * T::RAW_FLOATS;
    load_rows<T, VEC, T::BM>(s, A, a_rows, d, kt * T::BK, tid);
    load_rows<T, VEC, T::BN>(s + T::BM * T::LDS, B, b_rows, d, kt * T::BK,
                             tid);
  };
  auto plane = [&](int kt) {
    return planes + (kt % T::PLANES) * T::PLANE_FLOATS;
  };
  auto step = [&](int kt, auto parity) {
    constexpr int P = decltype(parity)::value;
    cp_async_wait<T::STAGES - 2>();   // stage kt + 1 has landed
    // ... for every thread; stage kt's planes are written, stage kt - 2's
    // products are done in both warpgroups (its planes take stage kt + 1),
    // and raw slot kt % STAGES is split (it takes stage kt + STAGES)
    __syncthreads();
    if (kt + T::STAGES < ktiles) load(kt + T::STAGES);
    cp_async_commit();
    const float* pb = plane(kt);
    const float* ps = pb + T::KK * T::SLAB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KK; ++kk) {
      // the small terms first, then big*big
      wgmma(acc, as[P][kk], desc(pb + kk * T::SLAB));
      wgmma(acc, ab[P][kk], desc(ps + kk * T::SLAB));
      wgmma(acc, ab[P][kk], desc(pb + kk * T::SLAB));
    }
    wgmma_commit();
    wgmma_wait<1>();   // stage kt - 1's products: its A registers are free
    if (kt + 1 < ktiles) {
      const float* next = raw + ((kt + 1) % T::STAGES) * T::RAW_FLOATS;
      split_a<T>(next, ab[1 - P], as[1 - P], arow, t);
      split_b<T>(next, plane(kt + 1), tid);
    }
  };
#pragma unroll
  for (int s = 0; s < T::STAGES; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();         // one group per stage, empty or not
  }
  cp_async_wait<T::STAGES - 1>();      // stage 0 has landed
  __syncthreads();
  split_a<T>(raw, ab[0], as[0], arow, t);
  split_b<T>(raw, plane(0), tid);
  for (int kt = 0; kt < ktiles; kt += 2) {
    step(kt, Parity<0>());
    if (kt + 1 < ktiles) step(kt + 1, Parity<1>());
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  Epi::template store_acc<T>(acc, smem, out, row0, dim0, N, D, arow, t);
}

// For an Epi that reads the y tile: the wgmma accumulators into it (the
// ring's space, free once every thread is past the loop); accumulator i is
// row arow + 8 ((i >> 1) & 1), dim 8 (i >> 2) + 2 t + (i & 1)
template <class T>
__device__ __forceinline__ void acc_to_y(const float (&acc)[T::NA],
                                         float* smem, int arow, int t) {
  __syncthreads();
#pragma unroll
  for (int j = 0; j < T::NA / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(smem + (arow + 8 * h) * T::YS + 8 * j +
                                 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// N <= 128: mma.sync with D on the M side

// BM dims x BN rows block tile on the mma's M and N sides (A = R, B = z),
// BK-deep stages, WN x WK warps (WK splits each stage's k8 steps), MT m16
// and NT n8 tiles per warp, MINB blocks per SM
template <int BN_, int BK_, int STAGES_, int WN_, int WK_, int NT_, int MINB_>
struct Tile {
  static constexpr int BM = 32, MT = 2;
  static constexpr int BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WN = WN_, WK = WK_, NT = NT_, MINB = MINB_;
  static constexpr int WARPS = WN * WK, THREADS = WARPS * 32;
  static constexpr int LDS = BK + PAD;
  static constexpr int STAGE_FLOATS = (BM + BN) * LDS;
  static constexpr int ROWS = BN, DIMS = BM;     // feature rows, dims
  // y tile row stride: the transposed scalar stores want 4 mod 32 banks
  static constexpr int YS = DIMS + 4;
  static constexpr int Y_FLOATS = WK * ROWS * YS;
  static constexpr int SMEM_FLOATS =
      STAGES * STAGE_FLOATS > Y_FLOATS ? STAGES * STAGE_FLOATS : Y_FLOATS;
  static constexpr int SMEM = SMEM_FLOATS * 4;
  static_assert(WN * NT * 8 == BN, "warp tiling");
  static_assert(BK % 8 == 0 && (BK / 8) % WK == 0, "k split");
  static_assert(STAGES >= 3, "the ring keeps STAGES - 2 copies in flight");
};

using Small128 = Tile<128, 32, 4, 4, 1, 4, 2>;
using Small8 = Tile<8, 32, 6, 1, 4, 1, 2>;

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// This warp's share of one stage: its k8 steps of the MT x NT mma tiles,
// each fragment split as it is loaded (lane = 4g + t)
template <class T>
__device__ __forceinline__ void compute_stage(
    const float* s, float (&acc)[T::MT][T::NT][4], int wn, int wk, int g,
    int t, int nt_valid) {
  const float* As = s + g * T::LDS + t;
  const float* Bs = s + T::BM * T::LDS + (wn * T::NT * 8 + g) * T::LDS + t;
#pragma unroll
  for (int i = 0; i < T::BK / 8 / T::WK; ++i) {
    const int k = (wk + i * T::WK) * 8;
    uint32_t ab[T::MT][4], as[T::MT][4], bb[T::NT][2], bs[T::NT][2];
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi) {
      const float* p = As + mi * 16 * T::LDS + k;
      split(p[0], ab[mi][0], as[mi][0]);                 // row g,   col t
      split(p[8 * T::LDS], ab[mi][1], as[mi][1]);        // row g+8, col t
      split(p[4], ab[mi][2], as[mi][2]);                 // row g,   col t+4
      split(p[8 * T::LDS + 4], ab[mi][3], as[mi][3]);    // row g+8, col t+4
    }
#pragma unroll
    for (int nj = 0; nj < T::NT; ++nj) {
      const float* p = Bs + nj * 8 * T::LDS + k;
      split(p[0], bb[nj][0], bs[nj][0]);                 // k t,   n g
      split(p[4], bb[nj][1], bs[nj][1]);                 // k t+4, n g
    }
    // the small terms first, then big*big, all into float32 accumulators
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < T::NT; ++nj)
        if (nj < nt_valid) mma(acc[mi][nj], as[mi], bb[nj]);
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < T::NT; ++nj)
        if (nj < nt_valid) mma(acc[mi][nj], ab[mi], bs[nj]);
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < T::NT; ++nj)
        if (nj < nt_valid) mma(acc[mi][nj], ab[mi], bb[nj]);
  }
}

template <class T, class Epi, bool VEC>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
sign_mma_kernel(const float* __restrict__ z, const float* __restrict__ R,
                typename Epi::Out* __restrict__ out, int N, int d, int D) {
  extern __shared__ __align__(1024) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row and column
  const int wn = warp % T::WN, wk = warp / T::WN;
  const int dim0 = blockIdx.x * T::BM;
  const float* A = R + (size_t)dim0 * d;   // A = R's dims, B = every row
  const int a_rows = min(T::BM, D - dim0), b_rows = min(T::BN, N);
  // n8 tiles of this warp that hold a feature row (the rest are skipped)
  const int nt_valid = max(0, min(T::NT, (b_rows - wn * T::NT * 8 + 7) / 8));

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < T::NT; ++nj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nj][c] = 0.f;

  const int ktiles = (d + T::BK - 1) / T::BK;
  auto load = [&](int kt) {
    float* s = smem + (kt % T::STAGES) * T::STAGE_FLOATS;
    load_rows<T, VEC, T::BM>(s, A, a_rows, d, kt * T::BK, tid);
    load_rows<T, VEC, T::BN>(s + T::BM * T::LDS, z, b_rows, d, kt * T::BK,
                             tid);
  };
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();         // one group per stage, empty or not
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<T::STAGES - 2>();   // stage kt has landed
    __syncthreads();                  // ... for every thread; slot kt - 1 free
    if (kt + T::STAGES - 1 < ktiles) load(kt + T::STAGES - 1);
    cp_async_commit();
    compute_stage<T>(smem + (kt % T::STAGES) * T::STAGE_FLOATS, acc, wn, wk,
                     g, t, nt_valid);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the accumulators into the y tile [WK][rows][dims]: accumulator c of
  // mma tile (mi, nj) is dim a + 8 (c >> 1), feature row b + (c & 1)
  float* ys = smem + wk * T::ROWS * T::YS;
#pragma unroll
  for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < T::NT; ++nj) {
      const int a = mi * 16 + g;
      const int b = wn * T::NT * 8 + nj * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ys[b * T::YS + a + 8 * h] = acc[mi][nj][2 * h];
        ys[(b + 1) * T::YS + a + 8 * h] = acc[mi][nj][2 * h + 1];
      }
    }
  __syncthreads();
  Epi::template store<T>(smem, out, 0, dim0, N, D);
}

// ---------------------------------------------------------------------------

template <class T, class Epi, bool VEC>
int launch_wgmma(const float* z, const float* R, typename Epi::Out* out,
                 int N, int d, int D, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      sign_wgmma_kernel<T, Epi, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((D + T::BN - 1) / T::BN, (N + T::BM - 1) / T::BM);
  sign_wgmma_kernel<T, Epi, VEC><<<grid, T::THREADS, T::SMEM, stream>>>(
      z, R, out, N, d, D);
  return (int)cudaGetLastError();
}

template <class T, class Epi, bool VEC>
int launch_mma(const float* z, const float* R, typename Epi::Out* out,
               int N, int d, int D, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      sign_mma_kernel<T, Epi, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((D + T::BM - 1) / T::BM);
  sign_mma_kernel<T, Epi, VEC><<<grid, T::THREADS, T::SMEM, stream>>>(
      z, R, out, N, d, D);
  return (int)cudaGetLastError();
}

template <class Epi, bool VEC>
int launch_tile(const float* z, const float* R, typename Epi::Out* out,
                int N, int d, int D, cudaStream_t st) {
  if (N <= 8) return launch_mma<Small8, Epi, VEC>(z, R, out, N, d, D, st);
  if (N <= 128) return launch_mma<Small128, Epi, VEC>(z, R, out, N, d, D, st);
  return launch_wgmma<Large, Epi, VEC>(z, R, out, N, d, D, st);
}

// One launch of y = z @ R^T with the tile N asks for; returns the
// cudaError_t of the attribute call or the launch (0 = success)
template <class Epi>
int launch(const void* z, const void* R, void* out, int N, int d, int D,
           void* stream) {
  if (N <= 0 || d <= 0 || D <= 0 || (N + Large::BM - 1) / Large::BM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = d % 4 == 0 && (uintptr_t)z % 16 == 0 &&
                   (uintptr_t)R % 16 == 0;
  using O = typename Epi::Out;
  const float* zf = (const float*)z;
  const float* Rf = (const float*)R;
  const cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch_tile<Epi, true>(zf, Rf, (O*)out, N, d, D, st)
             : launch_tile<Epi, false>(zf, Rf, (O*)out, N, d, D, st);
}

}  // namespace sign_gemm
