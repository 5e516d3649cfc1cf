// Flash attention O = softmax(Q K^T * scale) V on Hopper's tensor cores
// (sm_90a): wgmma fed by TMA. The `wgmma` variant of
// src/repro_torch/kernels/flash_attention.py; csrc/flash_attention.cu is
// the `simt` variant (float32 inputs, and head dims TMA cannot read).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _fa_kernel, pallas_call at :100) for bf16 q, k, v.
// It computes what that kernel computes, with its semantics:
//
//   * q, k, v [B, S, D] row-major bf16, B = batch * heads, D <= 256 and
//     D % 8 == 0 (TMA reads 16-byte rows); out [B, S, D] float32.
//   * Masks: k < S; causal keeps k <= q; window > 0 keeps k > q - window,
//     also when causal is false. Masked logits are -1e30 (not -inf), a row
//     whose running max is still -1e30 adds nothing (p = 0), and the final
//     divide uses 1 where l == 0.
//   * Online softmax over kv tiles of 64 rows: the running max moves once
//     per tile, l is summed in float32 from the unrounded p, P is rounded
//     to bf16 before P V, and O = O * corr + P V in float32. The TPU
//     kernel moves its max once per tuned block_kv block instead; with
//     bf16 inputs P then rounds against a different max, which the
//     reference's own bf16 tolerance (3e-2) covers. exp is exp2f with
//     log2(e) folded in: p = exp2(x * log2e - m * log2e), x = s * scale.
//   * kv tiles that lie wholly above the diagonal, or wholly left of the
//     window, for every row of the CTA are neither loaded nor computed.
//     Every logit they hold is masked for every row, so they would add
//     exactly 0 and leave the max as it is.
//
// Bound on an H100 SXM: the larger of 4 * B * S^2 * D FLOPs (halved when
// causal) over 989 TFLOP/s and 3 * B * S * D * 2 + B * S * D * 4 bytes
// over 3.35 TB/s. At RecurrentGemma-2B's self_attn (B = 10, S = 512,
// D = 256, causal) that is 1.36 us of FLOPs against 3.91 us of bytes.
//
// Design, against that bound:
//   * The grid fills the SMs rather than following the tuned block_q: one
//     CTA per (batch-head, q tile) of 128 rows (two consumer warpgroups
//     sharing the K/V stages) when B * ceil(S / 128) >= 132, else 64 rows
//     (one consumer). At self_attn that is 10 x 8 = 80 CTAs. With causal
//     masking the longest q tiles launch first.
//   * Warpgroup 0 produces: one thread issues TMA loads (128-byte swizzle,
//     D in 64-column boxes, zero fill past D and past S; D is padded in
//     shared memory to Dp = ceil(D / 64) * 64). Q is loaded once; K and V
//     tiles of 64 rows go through a ring of `stages` (2 to 4) stages with a
//     full and an empty mbarrier each.
//   * S = Q K^T: wgmma m64n64k16 with A = Q and B = K, both K-major from
//     shared memory (no transpose), Dp / 16 steps, float32 accumulators.
//   * Softmax in registers on the accumulator fragment; each thread holds
//     two rows, and a row's max and sum reduce over the 4 lanes that share
//     it.
//   * O += P V: wgmma m64nDpk16 with A = P from registers (the float32
//     m64n64 accumulator fragment, converted to packed bf16 pairs, is laid
//     out as the A fragment of the four k16 steps) and B = V from shared
//     memory, MN-major through the transpose flag, as csrc/matmul_wgmma.cu
//     reads its B. The zero columns past D are dropped at the store.
//   * Registers: at Dp = 256 the O accumulator is 128 a thread. With two
//     consumers, setmaxnreg moves registers from producer (40) to consumers
//     (232); with one, 256 threads may use 255 each.
//   * Shared memory: Q q_tile * Dp * 2 bytes, each stage 2 * 64 * Dp * 2
//     (K and V), 1 KB of alignment slack and the barriers; at Dp = 256 a
//     128-row tile takes 2 stages (197,672 bytes) and a 64-row tile 3
//     (230,456), within the 232,448 a block may use.
//
// Not done yet: overlapping one tile's softmax with the next tile's wgmma
// (ping-pong consumers), persistent CTAs, a TMA store epilogue.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;  // the TPU kernel's sentinel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKvTile = 64;        // kv rows of one stage and softmax step
constexpr int kBoxBytes = 64 * 64 * 2;  // one 64 x 64 bf16 TMA box
constexpr int kSmemLimit = 232448;
constexpr int kMaxStages = 4;

// shared memory of one CTA; the wrapper's plan computes the same
__host__ __device__ constexpr int smem_bytes(int nt, int q_tile, int stages) {
  return 1024 + q_tile * 64 * nt * 2 + stages * 2 * kKvTile * 64 * nt * 2 +
         (2 * stages + 1) * 8;
}

struct Params {
  float* out;
  int B, S, D, nq, stages, causal, window;
  float scale;
};

// D[64 x N] += A[64 x 16] (bf16 registers) * B[16 x N] (MN-major: trans-b = 1)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

// S[64 x 64] = Q[64 x 16] (K-major) * K^T[16 x 64] (K-major: trans-b = 0)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// NT: 64-column boxes of D (Dp = 64 NT); C: consumer warpgroups (q tile
// 64 C rows)
template <int NT, int C>
__global__ void __launch_bounds__(128 * (C + 1), 1)
    fa_wgmma(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const Params p) {
  constexpr int kDp = 64 * NT;
  constexpr int kQTile = 64 * C;
  constexpr int kQBytes = kQTile * kDp * 2;
  constexpr int kKvBytes = kKvTile * kDp * 2;  // K, or V, of one stage
  constexpr int kStageBytes = 2 * kKvBytes;
  extern __shared__ uint8_t smem_raw[];
  // TMA boxes with 128-byte swizzle and the wgmma descriptors' zero base
  // offset need 1024-byte aligned boxes
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;
  uint8_t* ring = smem + kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kStageBytes);
  uint64_t* empty = full + p.stages;
  uint64_t* q_full = empty + p.stages;

  // this CTA's (batch-head, q tile); causal: the longest tiles first
  const int b = blockIdx.x % p.B;
  int qt = blockIdx.x / p.B;
  if (p.causal) qt = p.nq - 1 - qt;
  const int q0 = qt * kQTile;
  const int q1 = min(q0 + kQTile, p.S);
  // the kv tiles some row of [q0, q1) keeps
  const int k_hi = p.causal ? q1 : p.S;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int j_lo = k_lo / kKvTile;
  const int n_tiles = max(0, (k_hi + kKvTile - 1) / kKvTile - j_lo);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C);
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads Q, then keeps the K/V ring full
    if constexpr (C == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        tma_load_3d(sq + t * kQTile * 128, &map_q, q_full, 64 * t, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % p.stages;
        // round r waits for the consumers' release of round r - 1; the
        // first round passes at once
        mbar_wait(&empty[st], ((it / p.stages) & 1) ^ 1);
        uint8_t* sk = ring + st * kStageBytes;
        uint8_t* sv = sk + kKvBytes;
        const int k0 = (j_lo + it) * kKvTile;
        mbar_expect_tx(&full[st], kStageBytes);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          tma_load_3d(sk + t * kBoxBytes, &map_k, &full[st], 64 * t, k0, b);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          tma_load_3d(sv + t * kBoxBytes, &map_v, &full[st], 64 * t, k0, b);
      }
    }
  } else {
    if constexpr (C == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1;  // this warpgroup's 64 rows of the q tile
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    // accumulator layout of m64nNk16: thread (warp, lane) holds rows
    // 16 warp + lane / 4 (+ 8) and columns 8 i + 2 (lane % 4) (+ 1)
    const int row0 = q0 + c * 64 + warp * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    // the kv positions each of the thread's two rows keeps: [lo, hi]
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = row0 + 8 * h;
      lo[h] = p.window > 0 ? q - p.window + 1 : 0;
      hi[h] = p.causal ? min(q, p.S - 1) : p.S - 1;
    }
    float o[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's columns; summed over the quad
    const uint8_t* sq_c = sq + c * 64 * 128;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % p.stages;
      mbar_wait(&full[st], (it / p.stages) & 1);
      const uint8_t* sk = ring + st * kStageBytes;
      const uint8_t* sv = sk + kKvBytes;

      // S = Q K^T. Q and K: K-major 128-byte rows in 64-column boxes,
      // 8-row swizzle atoms 1024 bytes apart; a k16 step is 32 bytes
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NT; ++kk)
        wgmma_m64n64k16_ss(
            s, smem_desc(sq_c + (kk / 4) * kQTile * 128 + 32 * (kk % 4), 16, 1024),
            smem_desc(sk + (kk / 4) * kBoxBytes + 32 * (kk % 4), 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // masked logits and the new running max
      const int k0 = (j_lo + it) * kKvTile;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * i + col0 + e;
            const int r = 4 * i + 2 * h + e;
            const float x =
                kp >= lo[h] && kp <= hi[h] ? s[r] * p.scale : kNegInf;
            s[r] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      }
      float corr[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        corr[h] = exp2f((m[h] - mx[h]) * kLog2e);
        m[h] = mx[h];
        mb[h] = m[h] * kLog2e;
      }
      // p = exp(x - m), 0 while the row's max is still -1e30
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * i + 2 * h + e;
            const float pv =
                m[h] == kNegInf ? 0.f : exp2f(fmaf(s[r], kLog2e, -mb[h]));
            rs[h] += pv;
            s[r] = pv;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
      for (int i = 0; i < kDp / 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * i + 2 * h] *= corr[h];
          o[4 * i + 2 * h + 1] *= corr[h];
        }
      }
      // P as bf16 A fragments: k16 step kk covers accumulator columns
      // 16 kk .. 16 kk + 15, i.e. s[8 kk .. 8 kk + 7] in fragment order
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }

      // O += P V. V: MN-major boxes of 64 kv rows x 64 columns (128 bytes),
      // 8-row atoms 1024 bytes apart (SBO), boxes 8 KB apart along D (LBO);
      // a k16 step is 16 rows = 2048 bytes
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<kDp>(o, pa[kk], smem_desc(sv + 2048 * kk, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // O / l, float32, rows < S and columns < D only
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const float lt = quad_sum(l[h]);
      const float inv = 1.f / (lt == 0.f ? 1.f : lt);
      if (row >= p.S) continue;
      float* dst = p.out + (static_cast<int64_t>(b) * p.S + row) * p.D;
#pragma unroll
      for (int i = 0; i < kDp / 8; ++i) {
        const int col = 8 * i + col0;
        if (col < p.D)
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
      }
    }
  }
}

// q, k or v [B, S, D] bf16 read in boxes of 64 columns x `rows` rows of one
// batch-head (128-byte rows, 128-byte swizzle); zero fill past D and S
bool qkv_map(CUtensorMap* map, const void* ptr, int B, int S, int D,
             int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims,
                  strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NT, int C>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, const Params& p, int ctas,
                   cudaStream_t s) {
  auto kernel = fa_wgmma<NT, C>;
  // the shared-memory opt-in is per device: once for each
  static uint64_t opted_in = 0;
  const cudaError_t err = opt_in_smem(kernel, kSmemLimit, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, 128 * (C + 1), smem_bytes(NT, 64 * C, p.stages), s>>>(
      mq, mk, mv, p);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(int nt, const CUtensorMap& mq, const CUtensorMap& mk,
                     const CUtensorMap& mv, const Params& p, int ctas,
                     cudaStream_t s) {
  switch (nt) {
    case 1: return launch<1, C>(mq, mk, mv, p, ctas, s);
    case 2: return launch<2, C>(mq, mk, mv, p, ctas, s);
    case 3: return launch<3, C>(mq, mk, mv, p, ctas, s);
    default: return launch<4, C>(mq, mk, mv, p, ctas, s);
  }
}

}  // namespace

// Launches flash attention on `stream` without synchronising, as the
// wrapper's plan says (src/repro_torch/kernels/flash_attention.py:plan):
// q_tile 64 or 128 rows per CTA, `stages` K/V ring stages. q, k, v [B, S,
// D] bf16 with 16-byte aligned bases, D % 8 == 0 and D <= 256; out [B, S,
// D] float32. Returns the first CUDA error, cudaErrorInvalidValue for
// arguments outside that.
extern "C" cudaError_t repro_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int D, int q_tile, int stages, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      (q_tile != 64 && q_tile != 128) || stages < 2 || stages > kMaxStages ||
      window < 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return cudaErrorInvalidValue;
  const int nt = (D + 63) / 64;
  if (smem_bytes(nt, q_tile, stages) > kSmemLimit) return cudaErrorInvalidValue;
  Params p;
  p.out = static_cast<float*>(out);
  p.B = B;
  p.S = S;
  p.D = D;
  p.nq = (S + q_tile - 1) / q_tile;
  p.stages = stages;
  p.causal = causal != 0;
  p.window = window;
  p.scale = scale;
  const int64_t ctas = static_cast<int64_t>(B) * p.nq;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!qkv_map(&mq, q, B, S, D, q_tile) || !qkv_map(&mk, k, B, S, D, kKvTile) ||
      !qkv_map(&mv, v, B, S, D, kKvTile))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(ctas);
  return q_tile == 128 ? launch_c<2>(nt, mq, mk, mv, p, n, s)
                       : launch_c<1>(nt, mq, mk, mv, p, n, s);
}
