// Flash attention O = softmax(Q K^T * scale) V for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention (body _fa_kernel). It computes what that kernel computes,
// not its block structure:
//
//   * q, k, v [B, S, D] row-major, all float32 or all bf16, B = batch*heads;
//     out [B, S, D] float32.
//   * The tuned blocks (bq, bkv) = (min(block_q, S), min(block_kv, S)), as
//     the TPU kernel clamps them. One CTA owns one bq-row q tile of one
//     batch-head; kv is consumed in bkv blocks.
//   * Online softmax with the running max updated once per bkv block, so P
//     is rounded against the same max as in the TPU kernel: QK^T summed in
//     float32 (no TF32), times scale; masked logits become -1e30 (not -inf:
//     m_prev - m_new stays finite); a row whose max is still -1e30 adds
//     nothing; l += sum(p) in float32; P is cast to V's dtype before the PV
//     product (bf16 inputs round P to bf16); acc = acc * corr + P V; the
//     final divide uses 1 where l == 0.
//   * Masks as the TPU kernel has them: k < S; causal keeps k <= q; window
//     > 0 keeps k > q - window, also when causal is false (only the left
//     side is cut).
//   * kv blocks wholly above the diagonal, or wholly left of the window,
//     for every row of a sub-tile are skipped, and inside a block only the
//     columns some row keeps are computed. Every skipped logit is masked
//     for every row, so it would have added exactly 0 and left the max as
//     it was: skipping does not change the result.
//
// Bound on an H100 SXM: the larger of the FLOPs, 4 * B * S^2 * D (times 1/2
// when causal), over 989 TFLOP/s for bf16 (67 TFLOP/s for float32 without
// TF32), and the bytes, 3 * B * S * D * in_bytes + B * S * D * 4, over
// 3.35 TB/s. At RecurrentGemma-2B's self_attn (B = 10, S = 512, D = 256,
// causal, bf16) that is 1.36 us of FLOPs against 3.91 us of bytes, so it
// is bound by bytes.
//
// Design: simple and right first. A tuned bq of 1024 rows by D = 256 is a
// 1 MB float32 accumulator, far beyond a CTA's 227 KB of shared memory, so
// the CTA walks its q tile in sub-tiles of up to 16 rows: the sub-tile's Q
// and one bkv block of logits live in dynamic shared memory, K and V go
// through 32-row slabs, and each of the 256 threads keeps up to 16
// accumulator values in registers. Edges are masked in the kernel, so
// nothing is padded or copied. Any D <= 256 and any positive block size
// launches. What it does not do yet is approach the bound: every product
// is float32 FMA on the CUDA cores (no wgmma), there is no TMA or cp.async
// pipelining, K and V are re-read from L2 for every 16-row sub-tile, and a
// large tuned bq leaves SMs idle. Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's sentinel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;        // q rows of one sub-tile
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr int kSlab = 32;           // kv rows staged per slab, one per lane
constexpr int kMaxD = 256;
constexpr int kAcc = kMaxRows * kMaxD / kThreads;  // accumulators per thread
constexpr int kSmemLimit = 232448;  // 227 KB, a CTA's most on Hopper

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kv_s[c * (D + 1) + d] = float(src[(c0 + c) * D + d]) for c < nc; the +1
// keeps the lanes of phase A, which read one kv row each, on distinct banks
template <typename T>
__device__ __forceinline__ void stage_slab(float* kv_s, const T* src, int c0,
                                           int nc, int D) {
  const T* p = src + (int64_t)c0 * D;
  for (int e = threadIdx.x; e < nc * D; e += kThreads) {
    const int c = e / D;
    kv_s[c * (D + 1) + (e - c * D)] = to_float(p[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, float* __restrict__ out, int S, int D,
              int bq, int bkv, int R, bool causal, int window, float scale) {
  constexpr bool kRoundP = sizeof(T) == 2;  // P takes V's dtype before PV
  extern __shared__ float smem[];
  float* q_s = smem;                      // [R][D]
  float* s_s = q_s + R * D;               // [R][bkv] logits, then P
  float* kv_s = s_s + R * bkv;            // [kSlab][D + 1]
  float* m_s = kv_s + kSlab * (D + 1);    // [kMaxRows] running max
  float* l_s = m_s + kMaxRows;            // [kMaxRows] running denominator
  float* c_s = l_s + kMaxRows;            // [kMaxRows] this block's corr

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * S * D;
  const T* qh = q + base;
  const T* kh = k + base;
  const T* vh = v + base;
  const int tile0 = blockIdx.y * bq;
  const int tile1 = min(tile0 + bq, S);

  // accumulator i of this thread is element e = tid + kThreads * i of the
  // sub-tile's [rows, D] output
  int row[kAcc], col[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    row[i] = (tid + kThreads * i) / D;
    col[i] = (tid + kThreads * i) % D;
  }

  for (int r0 = tile0; r0 < tile1; r0 += R) {
    const int r1 = min(r0 + R, tile1);
    const int nr = r1 - r0;  // rows [r0, r1) of this sub-tile
    __syncthreads();         // the previous sub-tile is done with q_s, l_s
    for (int e = tid; e < nr * D; e += kThreads)
      q_s[e] = to_float(qh[(int64_t)r0 * D + e]);
    if (tid < kMaxRows) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

    for (int kb = 0; kb < S; kb += bkv) {
      if (causal && kb > r1 - 1) break;  // wholly above the diagonal
      int lo = kb;
      int hi = min(kb + bkv, S);
      if (causal) hi = min(hi, r1);
      if (window > 0) lo = max(lo, r0 - window + 1);
      if (lo >= hi) continue;  // every logit of the block is masked

      // phase A: logits of columns [lo, hi), masked, into s_s
      const int ra = warp, rb = warp + kWarps;
      const float* qa = q_s + min(ra, nr - 1) * D;
      const float* qb = q_s + min(rb, nr - 1) * D;
      for (int c0 = lo; c0 < hi; c0 += kSlab) {
        const int nc = min(kSlab, hi - c0);
        __syncthreads();
        stage_slab(kv_s, kh, c0, nc, D);
        __syncthreads();
        if (lane < nc) {
          const float* kr = kv_s + lane * (D + 1);
          float da = 0.f, db = 0.f;
          for (int d = 0; d < D; ++d) {
            const float kd = kr[d];
            da = fmaf(qa[d], kd, da);
            db = fmaf(qb[d], kd, db);
          }
          const int kp = c0 + lane;
#pragma unroll
          for (int j = 0; j < kRowsPerWarp; ++j) {
            const int r = j == 0 ? ra : rb;
            if (r < nr) {
              const int qp = r0 + r;
              bool keep = true;
              if (causal) keep = kp <= qp;
              if (window > 0) keep = keep && kp > qp - window;
              s_s[r * bkv + (kp - kb)] = keep ? (j == 0 ? da : db) * scale
                                              : kNegInf;
            }
          }
        }
      }
      __syncthreads();

      // row statistics: one warp per row; logits become P in place
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int r = warp + kWarps * j;
        if (r >= nr) continue;  // warp-uniform
        float* sr = s_s + r * bkv;
        float mx = kNegInf;
        for (int c = lo + lane; c < hi; c += 32) mx = fmaxf(mx, sr[c - kb]);
        mx = warp_max(mx);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const bool dead = m_new == kNegInf;
        float sum = 0.f;
        for (int c = lo + lane; c < hi; c += 32) {
          const float p = dead ? 0.f : expf(sr[c - kb] - m_new);
          sum += p;
          sr[c - kb] = kRoundP ? __bfloat162float(__float2bfloat16_rn(p)) : p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          l_s[r] = l_s[r] * corr + sum;
          c_s[r] = corr;
          m_s[r] = m_new;
        }
      }

      // phase B: part = P V over the block, then acc = acc * corr + part
      float part[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) part[i] = 0.f;
      for (int c0 = lo; c0 < hi; c0 += kSlab) {
        const int nc = min(kSlab, hi - c0);
        __syncthreads();  // also orders the row statistics before the reads
        stage_slab(kv_s, vh, c0, nc, D);
        __syncthreads();
        for (int c = 0; c < nc; ++c) {
          const float* vr = kv_s + c * (D + 1);
          const int sc = c0 + c - kb;
#pragma unroll
          for (int i = 0; i < kAcc; ++i)
            if (tid + kThreads * i < nr * D)
              part[i] = fmaf(s_s[row[i] * bkv + sc], vr[col[i]], part[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        if (tid + kThreads * i < nr * D)
          acc[i] = acc[i] * c_s[row[i]] + part[i];
    }

    __syncthreads();  // the last block's l_s is written
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + kThreads * i;
      if (e < nr * D) {
        const float l = l_s[row[i]];
        out[base + (int64_t)r0 * D + e] = acc[i] / (l == 0.f ? 1.f : l);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int D, int bq, int bkv, bool causal,
                   int window, float scale, cudaStream_t stream) {
  // shared memory: R rows of Q and of logits, one kv slab, three row stats;
  // R shrinks from 16 only when a very large bkv needs the room
  const int64_t fixed = (int64_t)kSlab * (D + 1) * 4 + 3 * kMaxRows * 4;
  const int64_t per_row = (int64_t)(D + bkv) * 4;
  const int64_t fit = (kSmemLimit - fixed) / per_row;
  if (fit < 1) return cudaErrorInvalidValue;
  const int R = fit < kMaxRows ? (int)fit : kMaxRows;
  const int smem = (int)(fixed + R * per_row);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (S + bq - 1) / bq);
  fa_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), S, D, bq, bkv, R,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches flash attention on `stream` with the tuned blocks (bq, bkv),
// which the caller has already clamped to S. Returns the launch's error
// code; it does not synchronise.
extern "C" cudaError_t repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int D, int bq, int bkv, int causal, int window, float scale, int in_bf16,
    void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D > kMaxD || bq <= 0 || bkv <= 0 ||
      bq > S || bkv > S || window < 0 || (S + bq - 1) / bq > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, D, bq, bkv, causal != 0,
                                 window, scale, s);
  return launch<float>(q, k, v, out, B, S, D, bq, bkv, causal != 0, window,
                       scale, s);
}
