// RG-LRU linear scan h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rg_lru.py:rg_lru (body
// _lru_kernel). It computes what that kernel computes, not its block
// structure:
//
//   * a, x [B, S, W] row-major, both float32 or both bf16, each converted
//     to float32 per element; out [B, S, W] float32.
//   * h_0 = 0 and the carry stays float32 across the whole sequence. The
//     step is a float32 multiply then a float32 add, each rounded
//     (__fmul_rn, __fadd_rn: no FMA contraction), as the plain version
//     computes it.
//   * block_w lanes per CTA, one thread per (b, w) lane; the sequence is
//     consumed in tuned chunks of `chunk` steps. Ragged S and W are masked
//     in the kernel: nothing is padded or copied (the TPU kernel pads a
//     with 1 and x with 0, which leaves the real lanes and steps as they
//     are).
//
// Bound on an H100 SXM: the bytes, 2 * B * S * W * in_bytes + B * S * W * 4,
// over 3.35 TB/s (2 FLOPs per 10 or 12 bytes is far below the ridge point).
// At RecurrentGemma-2B's rg_lru_scan (B = 1, S = 512, W = 2560, bf16) that
// is 3.13 us.
//
// Design: simple and right first. Each thread keeps its lane's carry in a
// register; within a chunk it loads a and x for up to 16 steps into
// registers (neighbouring threads read neighbouring w, so the loads are
// coalesced and all 32 are in flight together) before the dependent loop
// runs over them, so 1024 x 1024 x 2 staged values never need to fit
// anywhere. The real limit of this design is the dependence: S dependent
// steps over only B * W lanes. At B * W = 2560 that is at most 2560
// threads, 3 CTAs of 1024 on 132 SMs, each waiting out the latency of
// every piece of loads in turn. A scan over chunks inside the kernel
// (combine (a, x) pairs per chunk in parallel, then carry across chunks)
// would spread it over the SMs; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPiece = 16;  // steps staged in registers before the loop
constexpr int kMaxThreads = 1024;  // block_w's most; caps registers at 64

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lru_kernel(const T* __restrict__ a, const T* __restrict__ x,
               float* __restrict__ out, int S, int W, int ck, int bw, int nw) {
  const int b = blockIdx.x / nw;
  const int w = (blockIdx.x % nw) * bw + threadIdx.x;
  if (w >= W) return;  // the ragged edge of the last lane tile
  const int64_t lane = (int64_t)b * S * W + w;
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += ck) {
    const int t1 = min(t0 + ck, S);
    for (int p0 = t0; p0 < t1; p0 += kPiece) {
      const int n = min(kPiece, t1 - p0);
      float av[kPiece], xv[kPiece];
#pragma unroll
      for (int i = 0; i < kPiece; ++i) {
        if (i < n) {
          const int64_t off = lane + (int64_t)(p0 + i) * W;
          av[i] = to_float(a[off]);
          xv[i] = to_float(x[off]);
        }
      }
#pragma unroll
      for (int i = 0; i < kPiece; ++i) {
        if (i < n) {
          h = __fadd_rn(__fmul_rn(av[i], h), xv[i]);
          out[lane + (int64_t)(p0 + i) * W] = h;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, void* out, int B, int S,
                   int W, int ck, int bw, cudaStream_t stream) {
  const int nw = (W + bw - 1) / bw;
  lru_kernel<T><<<B * nw, bw, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<float*>(out), S, W, ck, bw, nw);
  return cudaGetLastError();
}

}  // namespace

// Launches the scan on `stream` with the tuned (chunk, block_w), which the
// caller has already clamped to (S, W). Returns the launch's error code; it
// does not synchronise.
extern "C" cudaError_t repro_rg_lru(const void* a, const void* x, void* out,
                                    int B, int S, int W, int chunk,
                                    int block_w, int in_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || chunk <= 0 || block_w <= 0 ||
      chunk > S || block_w > W || block_w > kMaxThreads ||
      (int64_t)B * ((W + block_w - 1) / block_w) > 2147483647)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(a, x, out, B, S, W, chunk, block_w, s);
  return launch<float>(a, x, out, B, S, W, chunk, block_w, s);
}
