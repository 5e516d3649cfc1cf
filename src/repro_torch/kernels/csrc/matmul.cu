// Tiled matmul C = A @ B for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/matmul.py:matmul (bodies
// _matmul_kernel_kinner and _matmul_kernel_kouter). It computes what that
// kernel computes, not its block structure:
//
//   * A [M, K] and B [K, N] row-major, both float32 or both bf16; C [M, N]
//     row-major, float32 or bf16.
//   * The tuned tile (bm, bn, bk) = (min(block_m, M), min(block_n, N),
//     min(block_k, K)), as the TPU kernel clamps it. One CTA owns one
//     bm x bn output tile of the tuned grid.
//   * K is consumed in blocks of bk. Each block's partial product is summed
//     in float32 and added into the running output. With k_inner=0 and a
//     bf16 output the TPU kernel accumulates in the bf16 output tile, so
//     here the output becomes bf16(float(out) + float(bf16(partial))) at
//     every block boundary (round_each_block). In every other case the
//     output accumulates in float32 and is stored once in its dtype.
//   * float32 inputs use plain float32 FMA (no TF32); bf16 inputs are
//     widened to float32, so every product is exact.
//
// Bound on an H100 SXM: the larger of 2MNK over the peak rate of the input
// type (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 without
// TF32) and (MK + KN) * in_bytes + MN * out_bytes over 3.35 TB/s. ResNet-18's
// GEMMs sit below the bf16 ridge point, so they are bound by bytes.
//
// Design: simple and right first. The tuned tile may be far larger than a
// CTA's shared memory (block_m = block_n = 1024, block_k = 2048 are legal
// knobs), so the CTA walks its tile in 64 x 64 output sub-tiles and each
// k block in 32-deep slabs staged through 16.5 KB of static shared memory;
// 256 threads each own a 4 x 4 register tile. Edges are masked in the
// kernel (zero fill), so A and B are never padded or copied. Every legal
// config launches; what it does not do yet is reach the bound: it uses
// CUDA-core FMA instead of wgmma, no TMA or cp.async pipelining, and a
// tuned tile that is large leaves SMs idle. Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSubM = 64;     // output rows of one sub-tile pass
constexpr int kSubN = 64;     // output columns of one sub-tile pass
constexpr int kSlabK = 32;    // depth of one shared-memory slab
constexpr int kThreads = 256; // 16 x 16 threads
constexpr int kTM = 4;        // rows per thread: ty + 16 * i
constexpr int kTN = 4;        // columns per thread: tx + 16 * j

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                  TOut* __restrict__ c, int M, int N, int K, int bm, int bn,
                  int bk, bool round_each_block) {
  // A slab stored k-major; the +1 column keeps the transposing stores free
  // of bank conflicts.
  __shared__ float a_s[kSlabK][kSubM + 1];
  __shared__ float b_s[kSlabK][kSubN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int tile_m0 = blockIdx.x * bm;
  const int tile_n0 = blockIdx.y * bn;
  const int tile_m1 = min(tile_m0 + bm, M);
  const int tile_n1 = min(tile_n0 + bn, N);

  for (int sm0 = tile_m0; sm0 < tile_m1; sm0 += kSubM) {
    const int m_end = min(sm0 + kSubM, tile_m1);
    for (int sn0 = tile_n0; sn0 < tile_n1; sn0 += kSubN) {
      const int n_end = min(sn0 + kSubN, tile_n1);
      float acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

      for (int kb = 0; kb < K; kb += bk) {
        const int k_end = min(kb + bk, K);
        float part[kTM][kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) part[i][j] = 0.f;

        for (int k0 = kb; k0 < k_end; k0 += kSlabK) {
          // neighbouring threads read neighbouring k of one A row and
          // neighbouring n of one B row
          for (int e = tid; e < kSubM * kSlabK; e += kThreads) {
            const int mm = e / kSlabK, kk = e % kSlabK;
            const int gm = sm0 + mm, gk = k0 + kk;
            a_s[kk][mm] = (gm < m_end && gk < k_end)
                              ? to_float(a[(int64_t)gm * K + gk])
                              : 0.f;
          }
          for (int e = tid; e < kSlabK * kSubN; e += kThreads) {
            const int kk = e / kSubN, nn = e % kSubN;
            const int gk = k0 + kk, gn = sn0 + nn;
            b_s[kk][nn] = (gk < k_end && gn < n_end)
                              ? to_float(b[(int64_t)gk * N + gn])
                              : 0.f;
          }
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < kSlabK; ++kk) {
            float av[kTM], bv[kTN];
#pragma unroll
            for (int i = 0; i < kTM; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kTN; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kTM; ++i)
#pragma unroll
              for (int j = 0; j < kTN; ++j)
                part[i][j] = fmaf(av[i], bv[j], part[i][j]);
          }
          __syncthreads();
        }

#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = round_each_block
                            ? round_bf16(acc[i][j] + round_bf16(part[i][j]))
                            : acc[i][j] + part[i][j];
      }

#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int gm = sm0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int gn = sn0 + tx + 16 * j;
          if (gm < m_end && gn < n_end) store(&c[(int64_t)gm * N + gn], acc[i][j]);
        }
      }
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K,
                   int bm, int bn, int bk, bool round_each_block,
                   cudaStream_t stream) {
  const dim3 grid((M + bm - 1) / bm, (N + bn - 1) / bn);
  matmul_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<TOut*>(c), M, N, K, bm, bn, bk, round_each_block);
  return cudaGetLastError();
}

}  // namespace

// Launches C = A @ B on `stream` with the tuned tile (bm, bn, bk), which the
// caller has already clamped to (M, N, K). Returns the launch's error code;
// it does not synchronise.
extern "C" cudaError_t repro_matmul(const void* a, const void* b, void* c,
                                    int M, int N, int K, int bm, int bn,
                                    int bk, int in_bf16, int out_bf16,
                                    int round_each_block, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      bm > M || bn > N || bk > K || (N + bn - 1) / bn > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool r = round_each_block != 0;
  if (in_bf16) {
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, bm, bn, bk, r, s)
                    : launch<__nv_bfloat16, float>(a, b, c, M, N, K, bm, bn, bk, r, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(a, b, c, M, N, K, bm, bn, bk, r, s)
                  : launch<float, float>(a, b, c, M, N, K, bm, bn, bk, r, s);
}
