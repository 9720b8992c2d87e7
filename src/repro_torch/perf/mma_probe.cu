// Tensor-core rate probe for the hamming kernels' products on Hopper.
//
// Built once per variant by perf/mma_probe.py with -DVARIANT=<n>; a variant
// that ptxas refuses is reported as refused and the others still run.
//   1  mma.sync.m16n8k32   u8 x u8 -> s32            (0/1 bytes, one word a k-step)
//   2  mma.sync.m16n8k256  b1 x b1 -> s32, .and.popc  (packed words, 8 a k-step)
//   3  mma.sync.m16n8k256  b1 x b1 -> s32, .xor.popc
//   4  wgmma m64n64k32     u8 x u8 -> s32            (operands in shared memory)
//   5  wgmma m64n64k256    b1 x b1 -> s32, .and.popc
// probe_rate: every warp (every warpgroup for wgmma) issues `iters` rounds
// of a few independent products on zero operands; the caller times the
// launch. probe_latency (variants 1-3): one warp's chain of dependent
// products, clock cycles each. probe_check (variants 2 and 3): one m16n8k256 product of
// A [16 x 8 words] and B [8 x 8 words] loaded in the fragment layout the
// hamming kernels use (a0 = A[g][t], a1 = A[g+8][t],
// a2 = A[g][t+4], a3 = A[g+8][t+4]; b0 = B[g][t], b1 = B[g][t+4]; c0..c3 =
// C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]), so the host can hold it
// against popc(a & b) or popc(a ^ b) summed over the eight words.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef VARIANT
#define VARIANT 2
#endif

namespace {


#if VARIANT == 1
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#elif VARIANT == 2 || VARIANT == 3
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
#if VARIANT == 2
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
#else
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
#endif
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

#if VARIANT <= 3
template <int CHAINS>
__global__ void probe_rate_kernel(int iters, int* out) {
  uint32_t a[4], b[2];
  const uint32_t z = (uint32_t)(iters >> 30);   // 0, opaque to the compiler
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = z + i;
  b[0] = z;
  b[1] = z + 1;
  int c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) mma(c[k], a, b);
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 0x7fffffff) out[0] = s;   // keeps the products live
}

// one warp, one chain of dependent products: clock cycles a product
__global__ void probe_latency_kernel(int iters, long long* cycles, int* out) {
  uint32_t a[4], b[2];
  const uint32_t z = (uint32_t)(iters >> 30);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = z + i;
  b[0] = z;
  b[1] = z + 1;
  int c[4] = {0, 0, 0, 0};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) mma(c, a, b);
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
  if (c[0] + c[1] + c[2] + c[3] == 0x7fffffff) out[0] = 1;
}

#if VARIANT == 2 || VARIANT == 3
__global__ void probe_check_kernel(const uint32_t* A, const uint32_t* B,
                                   int* C) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint32_t a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + t + 4],
                         A[(g + 8) * 8 + t + 4]};
  const uint32_t b[2] = {B[g * 8 + t], B[g * 8 + t + 4]};
  int c[4] = {0, 0, 0, 0};
  mma(c, a, b);
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(g + 8) * 8 + 2 * t] = c[2];
  C[(g + 8) * 8 + 2 * t + 1] = c[3];
}
#endif
#else
// wgmma: one warpgroup a block, operands at the start of a zeroed shared
// buffer, no swizzle; only the rate is read
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((s & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
#if VARIANT == 4
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
#else
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc "
#endif
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}

template <int CHAINS>
__global__ void __launch_bounds__(128) probe_rate_kernel(int iters, int* out) {
  __shared__ __align__(1024) uint8_t smem[16384];
  for (int i = threadIdx.x; i < 16384 / 4; i += 128)
    reinterpret_cast<uint32_t*>(smem)[i] = 0;
  asm volatile("fence.proxy.async.shared::cta;\n" ::);
  __syncthreads();
  const uint64_t da = desc(smem), db = desc(smem + 8192);
  int d[CHAINS][32] = {};
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::);
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) wgmma(d[k], da, db);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::);
  int s = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) s += d[k][i];
  if (s == 0x7fffffff) out[0] = s;
}
#endif

}  // namespace

// word pairs (a 32-bit word of a row against a 32-bit word of a column)
// of one product
extern "C" long long probe_pairs_per_product() {
#if VARIANT == 1
  return 16 * 8 * 1;
#elif VARIANT <= 3
  return 16 * 8 * 8;
#elif VARIANT == 4
  return 64 * 64 * 1;
#else
  return 64 * 64 * 8;
#endif
}

extern "C" int probe_threads() { return VARIANT <= 3 ? 256 : 128; }

// `chains` independent products in flight a warp (mma.sync: 4 or 8) or a
// warpgroup (wgmma: 2 or 4; 8 sets of 32 accumulators would not fit)
extern "C" int probe_rate_launch(int blocks, int iters, int chains, void* out,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#if VARIANT <= 3
  if (chains == 8) {
    probe_rate_kernel<8><<<blocks, probe_threads(), 0, s>>>(iters, (int*)out);
  } else {
    probe_rate_kernel<4><<<blocks, probe_threads(), 0, s>>>(iters, (int*)out);
  }
#else
  if (chains == 2) {
    probe_rate_kernel<2><<<blocks, probe_threads(), 0, s>>>(iters, (int*)out);
  } else {
    probe_rate_kernel<4><<<blocks, probe_threads(), 0, s>>>(iters, (int*)out);
  }
#endif
  return (int)cudaGetLastError();
}

extern "C" int probe_latency_launch(int iters, void* cycles, void* out,
                                    void* stream) {
#if VARIANT <= 3
  probe_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      iters, (long long*)cycles, (int*)out);
  return (int)cudaGetLastError();
#else
  return -1;   // wgmma: no latency probe
#endif
}

extern "C" int probe_check_launch(const void* A, const void* B, void* C,
                                  void* stream) {
#if VARIANT == 2 || VARIANT == 3
  probe_check_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)A, (const uint32_t*)B, (int*)C);
  return (int)cudaGetLastError();
#else
  return -1;   // no layout check for the wgmma variants
#endif
}
