// Exact int8 x int8 -> int32 contractions of the int8 decode cache on Hopper
// (sm_90a).
//
// Replaces no Pallas kernel. The reference contracts its int8 operands into
// int32 with jnp.einsum on astype(int32) (src/repro/models/attention.py:178
// and :208, the GQA scores and values; src/repro/models/mla.py:126-132,
// _int8_dot, the MLA scores and values) and leaves the product to XLA. On
// the card PyTorch has no batched int8 or int32 product (torch.matmul and
// einsum refuse integer types on CUDA; torch._int_mm is 2-D only and needs
// more than 16 rows, while the GQA score product has G rows, 5 at
// qwen3-14b), and a float product is exact only while the sums stay below
// 2^24, which 127 * 127 * S passes at long S. So this kernel accumulates in
// int32, exactly, in any order.
//
// Two entry points, one launch function (mode):
//   rows (0): out[b,h,g,s] = sum_k a[b,h,g,k] * c[b,s,h,k]      k < K
//   cols (1): out[b,h,g,k] = sum_s a[b,h,g,s] * c[b,s,h,k]      k < K
// a is contiguous ([B, Hk, G, K] for rows, [B, Hk, G, S] for cols); the
// row of c at (b, s, h) starts at c + ((b * S + s) * Hk + h) * ldc, so a
// row holds ldc >= K codes and only the first K are read (the MLA value
// product reads the first r of each r + dr latent row without a copy).
// GQA: rows are the scores bhgd,bshd->bhgs, cols the values
// bhgs,bshd->bhgd; MLA: Hk = 1 and G = the heads.
//
// What bounds it: decode reads the int8 cache once (B * S * Hk * K bytes)
// and the small side once, and writes int32 [B, Hk, G, S or K]; the integer
// work is one multiply-add per code pair, far below the int8 tensor-core
// rate, so bytes bound it. At the decode shapes it is a few microseconds
// of work and the launch sets the pace.
//
// What the design does (a simple kernel first; it is not tuned):
//  * one thread per output element; blockIdx.y is (b, h) and blockIdx.x
//    tiles the G x S (rows) or G x K (cols) outputs, so a warp's threads
//    share g over consecutive s or k;
//  * rows: where K and ldc are multiples of 4 and both operands 4-byte
//    aligned, each thread walks its cache row and a's row (a broadcast to
//    the warp) one 32-bit word at a time with __dp4a; otherwise byte loads;
//  * cols: under the same condition each thread owns 4 consecutive k (one
//    word of every cache row, neighbouring threads on neighbouring words)
//    and keeps 4 int32 sums; otherwise one k a thread with byte loads;
//  * sums are int32 registers: exact for K, S < 2^31 / 127^2 (133,144).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int sx8(uint32_t x, int j) {
  return (int)(int8_t)(x >> (8 * j));
}

__global__ void __launch_bounds__(THREADS)
rows_words(const int8_t* __restrict__ a, const int8_t* __restrict__ c,
           int32_t* __restrict__ out, int G, int S, int Hk, int K, int ldc) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)G * S) return;
  const int bh = blockIdx.y;                       // b * Hk + h
  const int b = bh / Hk, h = bh - b * Hk;
  const int g = (int)(idx / S);
  const int s = (int)(idx - (long long)g * S);
  const int32_t* aw =
      reinterpret_cast<const int32_t*>(a + ((long long)bh * G + g) * K);
  const int32_t* cw = reinterpret_cast<const int32_t*>(
      c + (((long long)b * S + s) * Hk + h) * ldc);
  const int kw = K >> 2;
  int acc = 0;
#pragma unroll 4
  for (int w = 0; w < kw; ++w) acc = __dp4a(__ldg(aw + w), __ldg(cw + w), acc);
  out[((long long)bh * G + g) * S + s] = acc;
}

__global__ void __launch_bounds__(THREADS)
rows_bytes(const int8_t* __restrict__ a, const int8_t* __restrict__ c,
           int32_t* __restrict__ out, int G, int S, int Hk, int K, int ldc) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)G * S) return;
  const int bh = blockIdx.y;
  const int b = bh / Hk, h = bh - b * Hk;
  const int g = (int)(idx / S);
  const int s = (int)(idx - (long long)g * S);
  const int8_t* ar = a + ((long long)bh * G + g) * K;
  const int8_t* cr = c + (((long long)b * S + s) * Hk + h) * ldc;
  int acc = 0;
  for (int k = 0; k < K; ++k) acc += (int)ar[k] * (int)cr[k];
  out[((long long)bh * G + g) * S + s] = acc;
}

__global__ void __launch_bounds__(THREADS)
cols_words(const int8_t* __restrict__ p, const int8_t* __restrict__ c,
           int32_t* __restrict__ out, int G, int S, int Hk, int K, int ldc) {
  const int kw = K >> 2;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)G * kw) return;
  const int bh = blockIdx.y;
  const int b = bh / Hk, h = bh - b * Hk;
  const int g = (int)(idx / kw);
  const int w = (int)(idx - (long long)g * kw);
  const int8_t* pr = p + ((long long)bh * G + g) * S;
  const int8_t* cb = c + ((long long)b * S * Hk + h) * ldc + 4 * w;
  const long long rs = (long long)Hk * ldc;        // bytes from s to s + 1
  int acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
  for (int s = 0; s < S; ++s) {
    const int pv = (int)__ldg(pr + s);
    const uint32_t cv = __ldg(reinterpret_cast<const uint32_t*>(cb + s * rs));
    acc0 += pv * sx8(cv, 0);
    acc1 += pv * sx8(cv, 1);
    acc2 += pv * sx8(cv, 2);
    acc3 += pv * sx8(cv, 3);
  }
  int32_t* o = out + ((long long)bh * G + g) * K + 4 * w;
  o[0] = acc0;
  o[1] = acc1;
  o[2] = acc2;
  o[3] = acc3;
}

__global__ void __launch_bounds__(THREADS)
cols_bytes(const int8_t* __restrict__ p, const int8_t* __restrict__ c,
           int32_t* __restrict__ out, int G, int S, int Hk, int K, int ldc) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)G * K) return;
  const int bh = blockIdx.y;
  const int b = bh / Hk, h = bh - b * Hk;
  const int g = (int)(idx / K);
  const int k = (int)(idx - (long long)g * K);
  const int8_t* pr = p + ((long long)bh * G + g) * S;
  const int8_t* cb = c + ((long long)b * S * Hk + h) * ldc + k;
  const long long rs = (long long)Hk * ldc;
  int acc = 0;
  for (int s = 0; s < S; ++s) acc += (int)pr[s] * (int)cb[s * rs];
  out[((long long)bh * G + g) * K + k] = acc;
}

bool aligned4(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 3) == 0;
}

}  // namespace

// mode 0: rows, a [B, Hk, G, K] -> out [B, Hk, G, S]; mode 1: cols,
// a [B, Hk, G, S] -> out [B, Hk, G, K]. Every size >= 1, B * Hk <= 65535,
// ldc >= K. Returns the launch's cudaError_t.
extern "C" int int8_dot_launch(const void* a, const void* c, void* out,
                               int mode, int B, int Hk, int G, int S, int K,
                               int ldc, void* stream) {
  if (B < 1 || Hk < 1 || G < 1 || S < 1 || K < 1 || ldc < K ||
      (long long)B * Hk > 65535 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* cp = static_cast<const int8_t*>(c);
  int32_t* op = static_cast<int32_t*>(out);
  const bool words = K % 4 == 0 && ldc % 4 == 0 && aligned4(cp) &&
                     (mode == 1 || aligned4(ap));
  long long n;
  if (mode == 0)
    n = (long long)G * S;
  else
    n = (long long)G * (words ? K / 4 : K);
  dim3 grid((unsigned)((n + THREADS - 1) / THREADS), (unsigned)(B * Hk));
  if (mode == 0 && words)
    rows_words<<<grid, THREADS, 0, st>>>(ap, cp, op, G, S, Hk, K, ldc);
  else if (mode == 0)
    rows_bytes<<<grid, THREADS, 0, st>>>(ap, cp, op, G, S, Hk, K, ldc);
  else if (words)
    cols_words<<<grid, THREADS, 0, st>>>(ap, cp, op, G, S, Hk, K, ldc);
  else
    cols_bytes<<<grid, THREADS, 0, st>>>(ap, cp, op, G, S, Hk, K, ldc);
  return (int)cudaGetLastError();
}
