// GQA decode attention on Hopper (sm_90a): one query token a row against a
// bf16 KV cache, O = softmax(q K^T * scale) V over the cache's kept slots.
//
// Built into the library of csrc/flash_attention_wgmma.cu (its last lines
// include this file and export `repro_decode_attention`), so that one nvcc
// builds the models' attention. The entry behind it is
// src/repro_torch/kernels/decode_attention.py:decode_attention; on the card
// it replaces the float32 eager chain of
// src/repro_torch/models/attention.py:decode_attend_partial (two float32
// einsums over float32 copies of the whole cache, then the compare, where,
// max, exp and sum passes) for a bf16 GQA or MQA decode. It replaces no TPU
// kernel: the reference's decode attention,
// src/repro/models/attention.py:decode_attend, is plain jnp that XLA fuses.
//
// What it computes, with the reference's semantics:
//
//   * q [B, H, D], k and v [B, Sc, G, D], all bf16, read in place through
//     their strides (the last dim contiguous, rows 16-byte aligned); q head
//     h reads kv head h / (H / G). kv_positions [B, Sc] and cur_pos [B]
//     int32. out [B, H, D] bf16.
//   * Slot j of row b is kept where kv_positions[b, j] >= 0, <= cur_pos[b]
//     and, for window > 0, > cur_pos[b] - window: the ring's order does not
//     matter, and empty slots (-1) are masked. A row with no kept slot gives
//     0 (the reference divides by 1 where l == 0).
//   * Logits are q . k of bf16 operands summed in float32, times `scale`.
//     The running max moves once per 16-slot kv tile of a warp's stream
//     (below); P is rounded to bf16 against it before P V, as the
//     reference's `p.astype(v.dtype)`; l sums the unrounded p in float32;
//     O = O * corr + P V in float32. The streams are merged in float32 (the
//     LSE combine of the distributed decode), then O / l is cast to bf16.
//     The reference takes one max over the whole cache instead, so P rounds
//     against another max: the reference's bf16 tolerance (3e-2) covers it,
//     as it does for the prefill kernel.
//
// Bound on an H100 SXM: the bytes of q, of the kept K and V rows and of the
// output over 3.35 TB/s (the products are 4 * B * H * Sc * D FLOPs, far
// under the tensor cores' rate). At glm4-9b.chat's decode (B 64, Sc 1288
// slots of which about 1146 are kept mid-wave, G 2, D 128) that is about
// 75 MB, 22 us a layer.
//
// Design, against that bound:
//   * Work units are (batch row, kv head, 16 q heads, kv split): one CTA
//     takes all the q heads of a kv head (R = H / G, up to 16 a CTA;
//     glm4-9b has 16), so each K and V row is read from device memory once
//     for all of them. The products are mma.sync m16n8k16 (bf16 in,
//     float32 accumulate): the 16 q heads are exactly its 16 rows, where
//     wgmma's 64-row tiles would waste three quarters of every product.
//   * Each warp is its own stream: warp w of W (8 for Dp <= 128, else 4,
//     so that the rings fit) walks the split's 16-slot kv tiles w, w + W,
//     ... through a ring of `stages` stages of its own, so no warp waits
//     for another inside the loop: the only synchronisation there is
//     __syncwarp and the stage's mbarrier. Lane j < 16 loads row j's K and
//     V of a tile through the TMA unit (1-d bulk copies of D * 2 bytes,
//     counted on the stage's mbarrier). The split's positions are read
//     into shared memory once, at the start, so a tile with no kept slot
//     is neither loaded nor computed (it would add exactly 0): at
//     glm4-9b.chat's mid-wave cache 11% of the slots.
//   * Measured on the H100 (its notes in PERF.md): a first version with 4
//     warps, 32-slot tiles and 16-byte cp.async loads read 51% of the bound
//     at glm4-9b.chat's shape; TMA loads in its place, 2 or 3 stages, and a
//     head-major cache layout changed nothing, while a plain sum over the
//     same cache reads 2.7 TB/s: each SM's few streams, not the memory,
//     set the pace, and 8 warps read more. Q's 16 rows were first read by a
//     loop of dependent 2-byte loads, tens of microseconds a CTA; they are
//     read in 16-byte chunks, every load issued before the first store.
//   * Q lives in shared memory (16 rows, zero past R and past D). K and V
//     rows are padded by 8 elements, so ldmatrix reads them without bank
//     conflicts; columns past D (D padded to Dp, a multiple of 64) are
//     zero, and V rows past Sc are zeroed, so that P's zeros meet finite
//     values.
//   * S = Q K^T: ldmatrix of Q and K (K-major, as stored). P V: the S
//     accumulator fragments, rounded to packed bf16 pairs, are the A
//     fragments of the P V product; V through ldmatrix.trans.
//   * At the end the CTA merges its streams in shared memory. With one
//     split the CTA writes the output; with more, it writes its (m, l, O)
//     to a float32 workspace, and the last CTA of a (row, kv head, head
//     tile) to arrive (a counter per unit, reset by that CTA) merges the
//     splits and writes the output, in the same launch.
//   * The number of splits follows the shape (the wrapper's plan): as few
//     as fill the card's CTA slots, each CTA charged a fixed cost of a few
//     tiles, and at most 128 tiles a split (the positions' buffer), e.g. 1
//     at glm4-9b.chat's 128 (row, kv head) units and 4 at
//     glm4-9b.longprompt's 32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace decode {

constexpr int kTile = 16;            // kv slots of one tile
constexpr int kRows = 16;            // q heads of one CTA: mma's 16 rows
constexpr int kMaxStages = 4;
constexpr int kMaxSplitTiles = 128;  // tiles of one split (positions buffer)
constexpr int kSmemLimit = 232448;   // shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* pos;
  const int* cur;
  __nv_bfloat16* out;
  float* ws;       // [units][splits][kRows][D + 4]: O, m, l, 2 spare
  int* counters;   // [units], 0 between launches
  int64_t q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, p_b, p_s;  // elements
  int B, Sc, H, G, D, R, rtiles, splits, tiles_per_split, stages, window;
  float scale;
};

// warps (streams) of a CTA: 8 where D pads to at most 128, else 4
__host__ __device__ constexpr int warps_of(int dp) { return dp <= 128 ? 8 : 4; }

__host__ __device__ constexpr int stage_bytes(int dp) {
  return 2 * kTile * (dp + 8) * 2;  // K and V, rows padded by 8
}

// Q (16 rows), the last-arrival flag (16 bytes), each warp's ring
// barriers, the split's positions, then the rings
__host__ __device__ constexpr int header_bytes(int dp) {
  return kRows * (dp + 8) * 2 + 16 + warps_of(dp) * kMaxStages * 8 +
         kMaxSplitTiles * kTile * 4;
}
__host__ __device__ constexpr int smem_bytes(int dp, int stages) {
  return header_bytes(dp) + warps_of(dp) * stages * stage_bytes(dp);
}

// `bytes` contiguous bytes through the TMA unit, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// orders this thread's generic accesses of shared memory before the async
// proxy's (TMA) writes that follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] (row) * b[16 x 8] (col), bf16 in, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int Dp>
__global__ void __launch_bounds__(32 * warps_of(Dp))
    decode_kernel(const Params p) {
  constexpr int W = warps_of(Dp);
  constexpr int kThreads = 32 * W;
  constexpr int LD = Dp + 8;         // row stride of Q, K and V in smem
  constexpr int DK = Dp / 16;        // k16 steps of Q K^T
  constexpr int DN = Dp / 8;         // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  int* last_s = reinterpret_cast<int*>(smem + kRows * LD * 2);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kRows * LD * 2 + 16);
  int* pos_s = reinterpret_cast<int*>(bars + W * kMaxStages);
  unsigned char* ring = smem + header_bytes(Dp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int unit = blockIdx.x;
  const int split = unit % p.splits;
  unit /= p.splits;                  // (b, g, rt) of this CTA
  const int rt = unit % p.rtiles;
  const int g = (unit / p.rtiles) % p.G;
  const int b = unit / p.rtiles / p.G;
  const int h0 = g * p.R + rt * kRows;
  const int nr = min(kRows, p.R - rt * kRows);
  const int D = p.D;
  const int tiles = (p.Sc + kTile - 1) / kTile;
  const int ts = split * p.tiles_per_split;            // the split's tiles
  const int te = min(ts + p.tiles_per_split, tiles);   // [ts, te)
  const int row_s = ts * kTile;

  // the split's positions (-1 past Sc) and Q in 16-byte chunks, every load
  // issued before the first store (a loop of dependent loads here cost
  // tens of microseconds a CTA)
  const int* pb = p.pos + b * p.p_b;
  for (int j = tid; j < (te - ts) * kTile; j += kThreads) {
    if (row_s + j < p.Sc)
      cp_async4(pos_s + j, pb + static_cast<int64_t>(row_s + j) * p.p_s);
    else
      pos_s[j] = -1;
  }
  const int cur = p.cur[b];
  {
    constexpr int QC = (kRows * Dp / 8 + kThreads - 1) / kThreads;
    int4 qv[QC];
#pragma unroll
    for (int i = 0; i < QC; ++i) {
      const int e = tid + i * kThreads, r = e / (Dp / 8), c = e % (Dp / 8) * 8;
      qv[i] = r < nr && c < D
                  ? *reinterpret_cast<const int4*>(
                        p.q + b * p.q_b + (h0 + r) * p.q_h + c)
                  : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < QC; ++i) {
      const int e = tid + i * kThreads, r = e / (Dp / 8), c = e % (Dp / 8) * 8;
      if (r < kRows) *reinterpret_cast<int4*>(q_s + r * LD + c) = qv[i];
    }
  }
  unsigned char* mine = ring + warp * p.stages * stage_bytes(Dp);
  uint64_t* full = bars + warp * kMaxStages;  // this warp's ring barriers
  if (D < Dp) {  // K and V columns past D stay zero: no load writes them
    for (int s = 0; s < p.stages; ++s) {
      __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(
          mine + s * stage_bytes(Dp));
      for (int e = lane; e < 2 * kTile * (Dp - D); e += 32) {
        const int r = e / (Dp - D);
        kv[r * LD + D + (e - r * (Dp - D))] = __float2bfloat16(0.f);
      }
    }
  }
  if (lane == 0) {
    for (int s = 0; s < p.stages; ++s) hopper::mbar_init(full + s, 1);
    hopper::mbar_fence_init();
  }
  cp_async_wait_all();
  __syncthreads();

  auto kept = [&](int pp) {
    return pp >= 0 && pp <= cur && (p.window <= 0 || pp > cur - p.window);
  };
  // the first tile at or after t of this warp's stream (t, t + W, ...)
  // with a kept slot; te where there is none
  auto next = [&](int t) {
    for (; t < te; t += W)
      if (__any_sync(0xffffffffu,
                     lane < kTile && kept(pos_s[(t - ts) * kTile + lane])))
        return t;
    return te;
  };
  const __nv_bfloat16* kb = p.k + b * p.k_b + g * p.k_h;
  const __nv_bfloat16* vb = p.v + b * p.v_b + g * p.v_h;
  // tile t into stage s: lane j < 16 loads row j's K and V through the TMA
  // unit, counted on the stage's barrier; V rows past Sc are zeroed. Every
  // lane has passed __syncwarp since its last read of the stage.
  auto load = [&](int t, int s) {
    const int row0 = t * kTile;
    const int rows = min(kTile, p.Sc - row0);
    __nv_bfloat16* ks =
        reinterpret_cast<__nv_bfloat16*>(mine + s * stage_bytes(Dp));
    __nv_bfloat16* vs = ks + kTile * LD;
    if (lane == 0) hopper::mbar_expect_tx(full + s, rows * D * 4);
    __syncwarp();
    if (lane < rows) {
      const int64_t row = row0 + lane;
      fence_proxy_async();
      bulk_load(ks + lane * LD, kb + row * p.k_s, D * 2, full + s);
      bulk_load(vs + lane * LD, vb + row * p.v_s, D * 2, full + s);
    } else if (lane < kTile) {
      for (int c = 0; c < Dp; c += 8)
        *reinterpret_cast<int4*>(vs + lane * LD + c) = make_int4(0, 0, 0, 0);
    }
  };

  float m[2] = {-INFINITY, -INFINITY};  // rows lane / 4 and lane / 4 + 8
  float l[2] = {0.f, 0.f};              // this thread's columns only
  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int lt = next(ts + warp), ct = lt, loads = 0;  // next to load, to compute
  for (; loads < p.stages - 1 && lt < te; ++loads) {
    load(lt, loads % p.stages);
    lt = next(lt + W);
  }
  for (int n = 0; ct < te; ++n) {
    const int slot = n % p.stages;
    hopper::mbar_wait(full + slot, (n / p.stages) & 1);
    __syncwarp();  // every lane's stores of tile ct, and tile ct - W read
    if (lt < te) {
      load(lt, loads++ % p.stages);
      lt = next(lt + W);
    }
    const __nv_bfloat16* ks =
        reinterpret_cast<const __nv_bfloat16*>(mine + slot * stage_bytes(Dp));
    const __nv_bfloat16* vs = ks + kTile * LD;
    const int* ps = pos_s + (ct - ts) * kTile;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, q_s + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(bk, ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma(s[0], a, bk[0], bk[1]);
      mma(s[1], a, bk[2], bk[3]);
    }

    // masks and scale; this thread holds slots j * 8 + 2 * (lane % 4) + e
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool keep = kept(ps[j * 8 + 2 * (lane & 3) + e]);
        s[j][e] = keep ? s[j][e] * p.scale : -INFINITY;
        s[j][2 + e] = keep ? s[j][2 + e] * p.scale : -INFINITY;
      }
    }
    float mul[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                             fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      const float mn = fmaxf(m[r], quad_max(mx));
      const float mu = mn == -INFINITY ? 0.f : mn;  // rows with nothing kept
      corr[r] = exp2f((m[r] - mu) * kLog2e);        // 0 while m was -inf
      mul[r] = -mu * kLog2e;
      m[r] = mn;
    }
    uint32_t pa[4];  // P as the A fragment of P V
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float p0 = exp2f(fmaf(s[j][0], kLog2e, mul[0]));
      const float p1 = exp2f(fmaf(s[j][1], kLog2e, mul[0]));
      const float p2 = exp2f(fmaf(s[j][2], kLog2e, mul[1]));
      const float p3 = exp2f(fmaf(s[j][3], kLog2e, mul[1]));
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pa[2 * j] = pack_bf16(p0, p1);
      pa[2 * j + 1] = pack_bf16(p2, p3);
    }
    l[0] = fmaf(l[0], corr[0], ls[0]);
    l[1] = fmaf(l[1], corr[1], ls[1]);
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < DN / 2; ++j) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            j * 16 + (lane >> 4) * 8);
      mma(o[2 * j], pa, bv[0], bv[1]);
      mma(o[2 * j + 1], pa, bv[2], bv[3]);
    }
    ct = next(ct + W);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  __syncthreads();  // every warp is done with the ring: reuse it

  // the streams' (m, l, O) in shared memory, then merged
  float* o_s = reinterpret_cast<float*>(ring);  // [W][kRows][Dp]
  float* m_s = o_s + W * kRows * Dp;       // [W][kRows]
  float* l_s = m_s + W * kRows;
  float* f_s = l_s + W * kRows;            // [W][kRows] factors
  float* ml_s = f_s + W * kRows;           // [kRows][2]: m, l
  const int r0 = lane >> 2;
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    const int c = j * 8 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(o_s + (warp * kRows + r0) * Dp + c) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(o_s + (warp * kRows + r0 + 8) * Dp + c) =
        make_float2(o[j][2], o[j][3]);
  }
  if ((lane & 3) == 0) {
    m_s[warp * kRows + r0] = m[0];
    m_s[warp * kRows + r0 + 8] = m[1];
    l_s[warp * kRows + r0] = l[0];
    l_s[warp * kRows + r0 + 8] = l[1];
  }
  __syncthreads();
  // each q head's factors: exp(m_w - M) for the streams (over l, with one
  // split); a row with nothing kept has M = -inf and every factor 0
  if (tid < nr) {
    float mx = -INFINITY;
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, m_s[w * kRows + tid]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float f[W], lt = 0.f;
    for (int w = 0; w < W; ++w) {
      f[w] = exp2f((m_s[w * kRows + tid] - mu) * kLog2e);
      lt = fmaf(l_s[w * kRows + tid], f[w], lt);
    }
    const float inv = p.splits == 1 ? 1.f / (lt == 0.f ? 1.f : lt) : 1.f;
    for (int w = 0; w < W; ++w) f_s[w * kRows + tid] = f[w] * inv;
    ml_s[2 * tid] = mx;
    ml_s[2 * tid + 1] = lt;
  }
  __syncthreads();

  __nv_bfloat16* out = p.out + (static_cast<int64_t>(b) * p.H + h0) * D;
  const int WR = D + 4;  // a workspace row: O, m, l (16-byte aligned)
  float* ws_unit = p.ws + static_cast<int64_t>(unit) * p.splits * kRows * WR;
  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w)
      x = fmaf(o_s[(w * kRows + r) * Dp + c], f_s[w * kRows + r], x);
    if (p.splits == 1)
      out[e] = __float2bfloat16(x);
    else
      ws_unit[(split * kRows + r) * WR + c] = x;
  }
  if (p.splits == 1) return;

  // more splits: this CTA's (m, l, O) is in the workspace; the last CTA of
  // the unit to arrive merges the splits (a counter per unit, reset by it)
  if (tid < nr) {
    ws_unit[(split * kRows + tid) * WR + D] = ml_s[2 * tid];
    ws_unit[(split * kRows + tid) * WR + D + 1] = ml_s[2 * tid + 1];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(p.counters + unit, 1) == p.splits - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // each q head's split factors exp(m_s - M) / L, one warp a head
  float* g_s = reinterpret_cast<float*>(ring);  // [kRows][splits]
  for (int r = warp; r < nr; r += W) {
    float mx = -INFINITY;
    for (int sp = lane; sp < p.splits; sp += 32)
      mx = fmaxf(mx, __ldcg(ws_unit + (sp * kRows + r) * WR + D));
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mu = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f;
    for (int sp = lane; sp < p.splits; sp += 32) {
      const float* row = ws_unit + (sp * kRows + r) * WR;
      const float f = exp2f((__ldcg(row + D) - mu) * kLog2e);
      g_s[r * p.splits + sp] = f;
      lt = fmaf(__ldcg(row + D + 1), f, lt);
    }
    for (int o = 16; o > 0; o >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    __syncwarp();
    for (int sp = lane; sp < p.splits; sp += 32) g_s[r * p.splits + sp] *= inv;
  }
  __syncthreads();
  for (int e = tid; e < nr * D / 4; e += kThreads) {
    const int r = e / (D / 4), c = e % (D / 4) * 4;
    const float* g = g_s + r * p.splits;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < p.splits; ++sp) {
      const float4 y = __ldcg(
          reinterpret_cast<const float4*>(ws_unit + (sp * kRows + r) * WR + c));
      x.x = fmaf(y.x, g[sp], x.x);
      x.y = fmaf(y.y, g[sp], x.y);
      x.z = fmaf(y.z, g[sp], x.z);
      x.w = fmaf(y.w, g[sp], x.w);
    }
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + r * D + c);
    o2[0] = __floats2bfloat162_rn(x.x, x.y);
    o2[1] = __floats2bfloat162_rn(x.z, x.w);
  }
  if (tid == 0) p.counters[unit] = 0;  // ready for the next launch
}

template <int Dp>
cudaError_t launch(const Params& p, int ctas, cudaStream_t stream) {
  const int smem = smem_bytes(Dp, p.stages);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  // the attribute is set once a device (a host call the decode step would
  // otherwise pay every layer)
  static int set_for[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (set_for[dev] < smem) {
    err = cudaFuncSetAttribute(decode_kernel<Dp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    set_for[dev] = smem;
  }
  decode_kernel<Dp><<<ctas, 32 * warps_of(Dp), smem, stream>>>(p);
  return cudaGetLastError();
}

// Launches decode attention on `stream` (no synchronisation) with the
// wrapper's plan: D padded to d_pad (64, 128, 192 or 256), `stages` ring
// stages, `splits` kv splits of `tiles_per_split` tiles. ws and counters
// are needed where splits > 1.
inline cudaError_t run(const Params& p, int d_pad, cudaStream_t stream) {
  if (p.B <= 0 || p.Sc <= 0 || p.G <= 0 || p.H % p.G != 0 || p.D <= 0 ||
      p.D % 8 != 0 || p.D > d_pad || d_pad % 64 != 0 || p.stages < 2 ||
      p.stages > kMaxStages || p.splits < 1 || p.tiles_per_split < 1 ||
      p.R != p.H / p.G || p.rtiles != (p.R + kRows - 1) / kRows ||
      (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)))
    return cudaErrorInvalidValue;
  const int tiles = (p.Sc + kTile - 1) / kTile;
  if ((p.splits - 1) * p.tiles_per_split >= tiles ||
      p.splits * p.tiles_per_split < tiles ||
      p.tiles_per_split > kMaxSplitTiles)
    return cudaErrorInvalidValue;  // an empty split, or tiles left over
  const int64_t ctas = static_cast<int64_t>(p.B) * p.G * p.rtiles * p.splits;
  if (ctas > 2147483647LL) return cudaErrorInvalidValue;
  switch (d_pad) {
    case 64:
      return launch<64>(p, static_cast<int>(ctas), stream);
    case 128:
      return launch<128>(p, static_cast<int>(ctas), stream);
    case 192:
      return launch<192>(p, static_cast<int>(ctas), stream);
    case 256:
      return launch<256>(p, static_cast<int>(ctas), stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace decode
