// Flash attention O = softmax(Q K^T * scale) V on Hopper's tensor cores
// (sm_90a): wgmma fed by TMA. One kernel template, two entries:
//
//   repro_flash_attention_wgmma: the `wgmma` variant of
//     src/repro_torch/kernels/flash_attention.py:flash_attention (the
//     tuning path); csrc/flash_attention.cu is its `simt` variant (float32
//     inputs, and head dims TMA cannot read). q, k, v [B, S, D] row-major,
//     B = batch * heads; out [B, S, D] float32; kv tiles of 64 rows.
//   repro_prefill_attention_wgmma: the model zoo's prefill attention
//     (src/repro_torch/kernels/flash_attention.py:prefill_attention) in the
//     models' own layout: q [B, S, H, D] and k, v [B, S, G, D] read in place
//     through strided tensor maps, q head h reading kv head h / (H / G) (no
//     transpose, no copy of K and V per q head); out [B, S, H, D] bf16, the
//     out-projection's input; kv tiles of 128 rows for D <= 128, else 64.
//
// The end of this file also exports the models' decode attention,
// repro_decode_attention, whose kernel is csrc/decode_attention.cuh (its
// notes are there): one library, one nvcc, for the models' attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _fa_kernel, pallas_call at :100) for bf16 q, k, v,
// and on the card the float32 chunk loop of
// src/repro_torch/models/attention.py:_blocked_attention for a bf16
// prefill. It computes what they compute, with their semantics:
//
//   * bf16 q, k, v with D <= 256 and D % 8 == 0 (TMA reads 16-byte rows);
//     scale > 0.
//   * Masks: k < S; causal keeps k <= q; window > 0 keeps k > q - window,
//     also when causal is false. The references write -1e30 into masked
//     logits and give p = 0 while a row's running max is still -1e30; the
//     kernel writes -inf and guards the max instead (corr = 1 and p = 0
//     while a row's max is -inf), which gives the same P, l and O: a
//     masked logit adds exactly 0, and a row with nothing kept gives 0
//     (the final divide uses 1 where l == 0).
//   * Online softmax over kv tiles: logits are bf16 products summed in
//     float32, the running max moves once per tile, l is summed in float32
//     from the unrounded p, P is rounded to bf16 before P V, and
//     O = O * corr + P V in float32; O / l is cast to the output type. The
//     TPU kernel moves its max once per tuned block_kv block and the loop
//     once per 512-row chunk instead; with bf16 inputs P then rounds
//     against a different max, which the reference's own bf16 tolerance
//     (3e-2) covers. The scale is folded into exp: the max is taken over
//     the raw logits s (scale > 0, so it is the max of s * scale) and
//     p = exp2(s * scale * log2e - m * scale * log2e) on the
//     special-function unit, one FFMA and one ex2 a logit.
//   * kv tiles that lie wholly above the diagonal, or wholly left of the
//     window, for every row of the CTA are neither loaded nor computed.
//     Every logit they hold is masked for every row, so they would add
//     exactly 0 and leave the max as it is. The mask arithmetic runs only
//     on tiles that cross the diagonal, the window's edge or S for some row
//     of the warpgroup.
//
// Bound on an H100 SXM: the larger of 4 * B * H * S^2 * D FLOPs (halved
// when causal) over 989 TFLOP/s and the bytes of q, k, v and out over
// 3.35 TB/s. At glm4-9b's longest prefill (B = 16, S = 4070, H = 32, G = 2,
// D = 128, causal) that is 2.195 ms of FLOPs a layer against 0.34 ms of
// bytes; at RecurrentGemma-2B's self_attn (tuning; B = 10, S = 512,
// D = 256) 1.36 us of FLOPs against 3.91 us of bytes.
//
// Design, against that bound:
//   * Work tiles are (batch, q head, q tile), the q head fastest, so the
//     H / G q heads of one kv head run side by side and meet the same K/V
//     tiles in L2; with causal masking the longest q tiles come first. The
//     q tile is 128 rows (two consumer warpgroups sharing the K/V stages)
//     when there are at least 132 such tiles, else 64 (one consumer). The
//     tuning entry launches one CTA a tile; the prefill entry launches as
//     many CTAs as the plan says (one an SM), each walking the tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ..., so that one tile's last
//     softmax, P V and stores overlap the next tile's Q and K/V loads.
//   * Warpgroup 0 produces: one thread issues TMA loads from 4-d tensor
//     maps (D, heads, S, B) with the caller's strides (128-byte swizzle, D
//     in 64-column boxes, zero fill past D and past S; D is padded in
//     shared memory to Dp = ceil(D / 64) * 64). Each tile's Q is loaded
//     once the consumers' last S of the tile before is done (a q_full and,
//     on the persistent prefill entry, a q_empty mbarrier); K and V tiles
//     go through a ring of `stages` (2 to 4) stages with a full and an
//     empty mbarrier each, continued across tiles.
//   * S = Q K^T: wgmma m64nKVk16 with A = Q and B = K, both K-major from
//     shared memory (no transpose), Dp / 16 steps, float32 accumulators.
//   * O += P V: wgmma m64nDpk16 with A = P from registers (the float32
//     accumulator fragment of S, converted to packed bf16 pairs, is laid
//     out as the A fragment of the k16 steps) and B = V from shared
//     memory, MN-major through the transpose flag. The zero columns past D
//     are dropped at the store.
//   * Softmax runs under the tensor cores. Within a warpgroup, tile j's
//     S = Q K^T and tile j - 1's P V are issued together as two commit
//     groups; the softmax of tile j runs while P V is still in flight, and
//     only O's rescale and P's conversion wait for it. The two consumer
//     warpgroups run unsynchronised, so one's softmax also runs under the
//     other's products. Forcing them to take turns at issuing with two
//     named barriers (ping-pong) measured slower on the H100 (5.58 against
//     4.80 ms a layer at the glm4-9b prefill above) and is not done.
//   * Registers: with two consumers, setmaxnreg moves registers from the
//     producer (40) to the consumers (232). A consumer thread holds S
//     (KV / 2), O (Dp / 2) and P (KV / 4) registers: 160 at D = 128 with
//     128-row kv tiles, 176 at D = 256 with 64-row tiles.
//   * Shared memory: Q q_tile * Dp * 2 bytes, each stage 2 * KV * Dp * 2
//     (K and V), 1 KB of alignment slack and the barriers; at D = 128 a
//     128-row q tile with 128-row kv tiles takes 3 stages (230,464 bytes),
//     within the 232,448 a block may use.
//   * The epilogue multiplies by 1 / l in registers and stores straight to
//     the output's rows (bf16 pairs or float32 pairs).
//
// Not done yet: a TMA store epilogue; TMA multicast of K/V to the CTAs of
// one kv head in a cluster (each CTA reads its K/V tiles from L2).

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;
constexpr int kMaxStages = 4;

// shared memory of one CTA; the wrapper's plans compute the same
__host__ __device__ constexpr int smem_bytes(int nt, int q_tile, int kv_tile,
                                             int stages) {
  return 1024 + q_tile * 64 * nt * 2 + stages * 2 * kv_tile * 64 * nt * 2 +
         (2 * stages + 2) * 8;
}

// the kv tile of a launch: the tuning entry's is always 64 rows (its
// rounding point); the prefill entry's is 128 rows where S, O and P fit the
// registers (Dp <= 128)
__host__ __device__ constexpr int kv_tile_of(int nt, bool wide) {
  return wide && nt <= 2 ? 128 : 64;
}

struct Params {
  void* out;
  int64_t out_b, out_s, out_h;  // out's strides in elements
  int B, S, H, R, D, nq, stages, causal, window;
  float scale;
};

// D[64 x N] += A[64 x 16] (bf16 registers) * B[16 x N] (MN-major: trans-b = 1)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

// S[64 x N] (+)= Q[64 x 16] (K-major) * K^T[16 x N] (K-major: trans-b = 0);
// acc = 0 overwrites S
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b, int acc) {
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
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a,
                                          uint64_t desc_b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
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

// 2^x on the special-function unit; 2^-huge and 2^-inf give 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// one (batch, q head, q tile) of the work: the q head fastest, so the
// H / G q heads of one kv head run side by side and meet the same K/V
// tiles in L2; causal: the longest tiles first
struct Tile {
  int b, h, q0, j_lo, n_tiles;
};

template <int kQTile, int KV>
__device__ __forceinline__ Tile tile_of(const Params& p, int tile) {
  Tile t;
  const int bh = tile % (p.B * p.H);
  int qt = tile / (p.B * p.H);
  if (p.causal) qt = p.nq - 1 - qt;
  t.b = bh / p.H;
  t.h = bh % p.H;
  t.q0 = qt * kQTile;
  // the kv tiles some row of [q0, q1) keeps
  const int q1 = min(t.q0 + kQTile, p.S);
  const int k_hi = p.causal ? q1 : p.S;
  const int k_lo = p.window > 0 ? max(0, t.q0 - p.window + 1) : 0;
  t.j_lo = k_lo / KV;
  t.n_tiles = max(0, (k_hi + KV - 1) / KV - t.j_lo);
  return t;
}

// NT: 64-column boxes of D (Dp = 64 NT); C: consumer warpgroups (q tile
// 64 C rows); KV: kv rows of one stage and softmax step; OutT: float or
// bf16. kPersistent: each CTA walks the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ..., reloading Q once the consumers release it; else the grid
// covers the tiles, one a CTA, and Q is loaded once with no release
template <int NT, int C, int KV, typename OutT, bool kPersistent>
__global__ void __launch_bounds__(128 * (C + 1), 1)
    fa_wgmma(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const Params p) {
  constexpr int kDp = 64 * NT;
  constexpr int kQTile = 64 * C;
  constexpr int kQBytes = kQTile * kDp * 2;
  constexpr int kBoxBytes = KV * 128;         // one 64-column box of K or V
  constexpr int kKvBytes = NT * kBoxBytes;    // K, or V, of one stage
  constexpr int kStageBytes = 2 * kKvBytes;
  constexpr int kSteps = KV / 16;             // k16 steps of P V
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
  uint64_t* q_empty = q_full + 1;
  const int total = p.B * p.H * p.nq;
  // one pass of the tile loops where the grid covers the tiles
  const int stride = kPersistent ? static_cast<int>(gridDim.x) : total;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C);
    }
    mbar_init(q_full, 1);
    if constexpr (kPersistent) mbar_init(q_empty, 4 * C);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads each tile's Q once the consumers are done
    // with the last one's, and keeps the K/V ring full across tiles
    if constexpr (C == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int g = 0;  // K/V tiles loaded so far
      int n = 0;  // q tiles so far
      for (int tile = blockIdx.x; tile < total; tile += stride, ++n) {
        const Tile t = tile_of<kQTile, KV>(p, tile);
        const int kvh = t.h / p.R;  // the kv head q head h reads
        if constexpr (kPersistent) mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, kQBytes);
#pragma unroll
        for (int i = 0; i < NT; ++i)
          tma_load_4d(sq + i * kQTile * 128, &map_q, q_full, 64 * i, t.h,
                      t.q0, t.b);
        for (int it = 0; it < t.n_tiles; ++it, ++g) {
          const int st = g % p.stages;
          // round r waits for the consumers' release of round r - 1; the
          // first round passes at once
          mbar_wait(&empty[st], ((g / p.stages) & 1) ^ 1);
          uint8_t* sk = ring + st * kStageBytes;
          uint8_t* sv = sk + kKvBytes;
          const int k0 = (t.j_lo + it) * KV;
          mbar_expect_tx(&full[st], kStageBytes);
#pragma unroll
          for (int i = 0; i < NT; ++i)
            tma_load_4d(sk + i * kBoxBytes, &map_k, &full[st], 64 * i, kvh,
                        k0, t.b);
#pragma unroll
          for (int i = 0; i < NT; ++i)
            tma_load_4d(sv + i * kBoxBytes, &map_v, &full[st], 64 * i, kvh,
                        k0, t.b);
        }
      }
    }
  } else {
    if constexpr (C == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1;  // this warpgroup's 64 rows of the q tile
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const uint8_t* sq_c = sq + c * 64 * 128;
    float s[KV / 2];
#pragma unroll
    for (int i = 0; i < KV / 2; ++i) s[i] = 0.f;
    uint32_t pa[kSteps][4];
    float o[kDp / 2];
    int g = 0;  // K/V tiles consumed so far
    int n = 0;  // q tiles so far
    for (int tile = blockIdx.x; tile < total; tile += stride, ++n) {
      const Tile t = tile_of<kQTile, KV>(p, tile);
      // accumulator layout of m64nNk16: thread (warp, lane) holds rows
      // 16 warp + lane / 4 (+ 8) and columns 8 i + 2 (lane % 4) (+ 1)
      const int r_lo = t.q0 + c * 64;
      const int row0 = r_lo + warp * 16 + lane / 4;
      const int col0 = 2 * (lane % 4);
      // the kv positions each of the thread's two rows keeps: [lo, hi]
      int lo[2], hi[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = row0 + 8 * e;
        lo[e] = p.window > 0 ? q - p.window + 1 : 0;
        hi[e] = p.causal ? min(q, p.S - 1) : p.S - 1;
      }
      // a kv tile within [safe_lo, safe_hi] is kept whole by every row of
      // this warpgroup and skips the mask arithmetic
      const int safe_lo = p.window > 0 ? r_lo + 63 - p.window + 1 : 0;
      const int safe_hi = p.causal ? min(r_lo, p.S - 1) : p.S - 1;
#pragma unroll
      for (int i = 0; i < kDp / 2; ++i) o[i] = 0.f;
      // the running max of the raw logits; -inf while nothing is kept
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};  // this thread's columns; summed over the quad

      mbar_wait(q_full, n & 1);
      for (int it = 0; it < t.n_tiles; ++it, ++g) {
        const int st = g % p.stages;
        mbar_wait(&full[st], (g / p.stages) & 1);
        const uint8_t* sk = ring + st * kStageBytes;
        // S = Q K^T. Q and K: K-major 128-byte rows in 64-column boxes,
        // 8-row swizzle atoms 1024 bytes apart; a k16 step is 32 bytes
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NT; ++kk)
          wgmma_ss<KV>(
              s,
              smem_desc(sq_c + (kk / 4) * kQTile * 128 + 32 * (kk % 4), 16,
                        1024),
              smem_desc(sk + (kk / 4) * kBoxBytes + 32 * (kk % 4), 16, 1024),
              kk > 0);
        wgmma_commit();
        // O += P V of the tile before. V: MN-major boxes of KV rows x 64
        // columns (128 bytes), 8-row atoms 1024 bytes apart (SBO), boxes
        // KV * 128 bytes apart along D (LBO); a k16 step is 16 rows = 2048
        // bytes
        if (it > 0) {
          const uint8_t* sv =
              ring + ((g - 1) % p.stages) * kStageBytes + kKvBytes;
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            wgmma_rs<kDp>(o, pa[kk],
                          smem_desc(sv + 2048 * kk, kBoxBytes, 1024));
          wgmma_commit();
        }
        if (it > 0) {
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(s);
        if (kPersistent && it + 1 == t.n_tiles) {
          // the tile's last S is done: Q goes back to the producer
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty);
        }

        // masked logits and the new running max
        const int k0 = (t.j_lo + it) * KV;
        const bool masked = k0 < safe_lo || k0 + KV - 1 > safe_hi;
        const float c2 = p.scale * kLog2e;  // scale > 0
        if (masked) {
#pragma unroll
          for (int i = 0; i < KV / 8; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int kp = k0 + 8 * i + col0 + u;
                const int r = 4 * i + 2 * e + u;
                s[r] = kp >= lo[e] && kp <= hi[e] ? s[r] : -INFINITY;
              }
            }
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < KV / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mx[e] = fmaxf(mx[e], fmaxf(s[4 * i + 2 * e], s[4 * i + 2 * e + 1]));
        }
        float corr[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx[e] = quad_max(mx[e]);
          const bool none = mx[e] == -INFINITY;
          corr[e] = none ? 1.f : ex2((m[e] - mx[e]) * c2);
          m[e] = mx[e];
          mb[e] = none ? 0.f : m[e] * c2;
        }
#pragma unroll
        for (int i = 0; i < KV / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int r = 4 * i + 2 * e + u;
              s[r] = ex2(fmaf(s[r], c2, -mb[e]));
              rs[e] += s[r];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) l[e] = l[e] * corr[e] + rs[e];

        // the tile before's P V is done: its stage goes back to the
        // producer, and O and the P registers are free
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) fence_regs(pa[kk]);
        if (it > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(g - 1) % p.stages]);
        }
#pragma unroll
        for (int i = 0; i < kDp / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            o[4 * i + 2 * e] *= corr[e];
            o[4 * i + 2 * e + 1] *= corr[e];
          }
        }
        // P as bf16 A fragments: k16 step kk covers accumulator columns
        // 16 kk .. 16 kk + 15, i.e. s[8 kk .. 8 kk + 7] in fragment order
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        }
      }
      // the last kv tile's P V; then its stage goes back to the producer
      {
        const uint8_t* sv =
            ring + ((g - 1) % p.stages) * kStageBytes + kKvBytes;
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          wgmma_rs<kDp>(o, pa[kk], smem_desc(sv + 2048 * kk, kBoxBytes, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) fence_regs(pa[kk]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(g - 1) % p.stages]);
      }

      // O / l in the output type, rows < S and columns < D only
      OutT* base = static_cast<OutT*>(p.out) + t.b * p.out_b + t.h * p.out_h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + 8 * e;
        const float lt = quad_sum(l[e]);
        const float inv = 1.f / (lt == 0.f ? 1.f : lt);
        if (row >= p.S) continue;
        OutT* dst = base + row * p.out_s;
#pragma unroll
        for (int i = 0; i < kDp / 8; ++i) {
          const int col = 8 * i + col0;
          if (col < p.D)
            store_pair(dst + col, o[4 * i + 2 * e] * inv,
                       o[4 * i + 2 * e + 1] * inv);
        }
      }
    }
  }
}

// q, k or v read in boxes of 64 columns x `rows` rows of one (batch, head):
// a 4-d map (D, heads, S, B) with the tensor's strides (elements; 128-byte
// rows, 128-byte swizzle); zero fill past D and S
bool qkv_map(CUtensorMap* map, const void* ptr, int D, int heads, int S,
             int B, const int64_t (&stride)[3], int rows) {
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  // stride = (head, row, batch)
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride[0]) * 2,
                                 static_cast<cuuint64_t>(stride[1]) * 2,
                                 static_cast<cuuint64_t>(stride[2]) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims,
                  strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NT, int C, int KV, typename OutT, bool kWide>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, const Params& p, int ctas,
                   cudaStream_t s) {
  // the prefill entry's CTAs are persistent, the tuning entry's one a tile
  auto kernel = fa_wgmma<NT, C, KV, OutT, kWide>;
  // the shared-memory opt-in is per device: once for each
  static uint64_t opted_in = 0;
  const cudaError_t err = opt_in_smem(kernel, kSmemLimit, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, 128 * (C + 1), smem_bytes(NT, 64 * C, KV, p.stages), s>>>(
      mq, mk, mv, p);
  return cudaGetLastError();
}

template <int C, typename OutT, bool kWide>
cudaError_t launch_c(int nt, const CUtensorMap& mq, const CUtensorMap& mk,
                     const CUtensorMap& mv, const Params& p, int ctas,
                     cudaStream_t s) {
  switch (nt) {
    case 1: return launch<1, C, kv_tile_of(1, kWide), OutT, kWide>(mq, mk, mv, p, ctas, s);
    case 2: return launch<2, C, kv_tile_of(2, kWide), OutT, kWide>(mq, mk, mv, p, ctas, s);
    case 3: return launch<3, C, kv_tile_of(3, kWide), OutT, kWide>(mq, mk, mv, p, ctas, s);
    default: return launch<4, C, kv_tile_of(4, kWide), OutT, kWide>(mq, mk, mv, p, ctas, s);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Checks the arguments, builds the three tensor maps and launches. Strides
// are (head, row, batch) in elements; kWide: the prefill entry (its kv
// tile, persistent CTAs)
template <typename OutT, bool kWide>
cudaError_t run(const void* q, const void* k, const void* v, void* out, int B,
                int S, int H, int G, int D, const int64_t (&qs)[3],
                const int64_t (&ks)[3], const int64_t (&vs)[3],
                const int64_t (&os)[3], int q_tile, int kv_tile, int stages,
                int causal, int window, float scale, int grid, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || D <= 0 ||
      D > 256 || D % 8 != 0 || (q_tile != 64 && q_tile != 128) ||
      stages < 2 || stages > kMaxStages || window < 0 || !(scale > 0.f) ||
      !aligned16(q) ||
      !aligned16(k) || !aligned16(v) ||
      reinterpret_cast<uintptr_t>(out) % (2 * sizeof(OutT)) != 0)
    return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    if (qs[i] <= 0 || ks[i] <= 0 || vs[i] <= 0 || qs[i] % 8 != 0 ||
        ks[i] % 8 != 0 || vs[i] % 8 != 0)
      return cudaErrorInvalidValue;
  }
  const int nt = (D + 63) / 64;
  if (kv_tile != kv_tile_of(nt, kWide) ||
      smem_bytes(nt, q_tile, kv_tile, stages) > kSmemLimit)
    return cudaErrorInvalidValue;
  Params p;
  p.out = out;
  p.out_h = os[0];
  p.out_s = os[1];
  p.out_b = os[2];
  p.B = B;
  p.S = S;
  p.H = H;
  p.R = H / G;
  p.D = D;
  p.nq = (S + q_tile - 1) / q_tile;
  p.stages = stages;
  p.causal = causal != 0;
  p.window = window;
  p.scale = scale;
  const int64_t ctas = static_cast<int64_t>(B) * H * p.nq;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  // grid 0: one CTA a tile; else `grid` persistent CTAs
  if (grid < 0 || grid > ctas) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!qkv_map(&mq, q, D, H, S, B, qs, q_tile) ||
      !qkv_map(&mk, k, D, G, S, B, ks, kv_tile) ||
      !qkv_map(&mv, v, D, G, S, B, vs, kv_tile))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = grid > 0 ? grid : static_cast<int>(ctas);
  return q_tile == 128 ? launch_c<2, OutT, kWide>(nt, mq, mk, mv, p, n, s)
                       : launch_c<1, OutT, kWide>(nt, mq, mk, mv, p, n, s);
}

}  // namespace

// Launches flash attention on `stream` without synchronising, as the
// wrapper's plan says (src/repro_torch/kernels/flash_attention.py:plan):
// q_tile 64 or 128 rows per CTA, `stages` K/V ring stages, kv tiles of 64
// rows, one CTA a tile. q, k, v [B, S, D] bf16 with 16-byte aligned bases,
// D % 8 == 0 and D <= 256; out [B, S, D] float32; scale > 0. Returns the
// first CUDA error, cudaErrorInvalidValue for arguments outside that.
extern "C" cudaError_t repro_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int D, int q_tile, int stages, int causal, int window, float scale,
    void* stream) {
  // B batch-heads of one head each: strides (head, row, batch)
  const int64_t in[3] = {D, D, static_cast<int64_t>(S) * D};
  const int64_t os[3] = {0, D, static_cast<int64_t>(S) * D};
  return run<float, false>(q, k, v, out, B, S, 1, 1, D, in, in, in, os,
                           q_tile, 64, stages, causal, window, scale, 0,
                           stream);
}

// Launches the prefill attention on `stream` without synchronising, as the
// wrapper's plan says (src/repro_torch/kernels/flash_attention.py:
// prefill_plan). q [B, S, H, D], k and v [B, S, G, D] bf16 with 16-byte
// aligned bases, the last dim contiguous and the other strides (elements:
// batch, row, head) multiples of 8; H % G == 0, D % 8 == 0, D <= 256;
// kv_tile 128 for D <= 128, else 64; scale > 0; `ctas` CTAs walk the
// B * H * ceil(S / q_tile) tiles (0: one a tile). out [B, S, H, D] bf16,
// contiguous. Returns the first CUDA error, cudaErrorInvalidValue for
// arguments outside that.
extern "C" cudaError_t repro_prefill_attention_wgmma(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int G, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int q_tile, int kv_tile, int stages,
    int ctas, int causal, int window, float scale, void* stream) {
  const int64_t qs[3] = {q_sh, q_ss, q_sb};
  const int64_t ks[3] = {k_sh, k_ss, k_sb};
  const int64_t vs[3] = {v_sh, v_ss, v_sb};
  const int64_t os[3] = {D, static_cast<int64_t>(H) * D,
                         static_cast<int64_t>(S) * H * D};
  return run<__nv_bfloat16, true>(q, k, v, out, B, S, H, G, D, qs, ks, vs,
                                  os, q_tile, kv_tile, stages, causal,
                                  window, scale, ctas, stream);
}

// The models' decode attention (csrc/decode_attention.cuh), built into this
// library so that one nvcc builds the models' attention.
#include "decode_attention.cuh"

// Launches decode attention on `stream` without synchronising, as the
// wrapper's plan says (src/repro_torch/kernels/decode_attention.py:
// decode_plan). The integer arguments come packed in one int64 array `a`
// (the decode step calls this once a layer, and each argument ctypes
// converts costs the host time): the addresses of q, k, v, kv_positions,
// cur_pos, out, ws and counters; then B, Sc, H, G, D; the strides (in
// elements) q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, p_b, p_s; then d_pad,
// stages, splits, tiles_per_split and window. q [B, H, D], k and v [B, Sc,
// G, D] bf16 with 16-byte aligned bases, the last dim contiguous and the
// other strides multiples of 8; kv_positions int32, cur_pos [B] int32
// contiguous; H % G == 0, D % 8 == 0, D <= d_pad (64, 128, 192 or 256);
// `splits` kv splits of `tiles_per_split` 16-slot tiles, at most 128 a
// split, with a float32 workspace `ws` of B * G * ceil(H / G / 16) *
// splits * 16 * (D + 4) values and B * G * ceil(H / G / 16) int32
// `counters`, zero, where splits > 1. out [B, H, D] bf16, contiguous.
// Returns the first CUDA error, cudaErrorInvalidValue for arguments outside
// that.
extern "C" cudaError_t repro_decode_attention(const long long* a,
                                              float scale, void* stream) {
  decode::Params p;
  p.q = reinterpret_cast<const __nv_bfloat16*>(a[0]);
  p.k = reinterpret_cast<const __nv_bfloat16*>(a[1]);
  p.v = reinterpret_cast<const __nv_bfloat16*>(a[2]);
  p.pos = reinterpret_cast<const int*>(a[3]);
  p.cur = reinterpret_cast<const int*>(a[4]);
  p.out = reinterpret_cast<__nv_bfloat16*>(a[5]);
  p.ws = reinterpret_cast<float*>(a[6]);
  p.counters = reinterpret_cast<int*>(a[7]);
  p.B = static_cast<int>(a[8]);
  p.Sc = static_cast<int>(a[9]);
  p.H = static_cast<int>(a[10]);
  p.G = static_cast<int>(a[11]);
  p.D = static_cast<int>(a[12]);
  p.q_b = a[13];
  p.q_h = a[14];
  p.k_b = a[15];
  p.k_s = a[16];
  p.k_h = a[17];
  p.v_b = a[18];
  p.v_s = a[19];
  p.v_h = a[20];
  p.p_b = a[21];
  p.p_s = a[22];
  const int d_pad = static_cast<int>(a[23]);
  p.stages = static_cast<int>(a[24]);
  p.splits = static_cast<int>(a[25]);
  p.tiles_per_split = static_cast<int>(a[26]);
  p.window = static_cast<int>(a[27]);
  p.scale = scale;
  if (p.G <= 0 || p.H % p.G != 0) return cudaErrorInvalidValue;
  p.R = p.H / p.G;
  p.rtiles = (p.R + decode::kRows - 1) / decode::kRows;
  return decode::run(p, d_pad, static_cast<cudaStream_t>(stream));
}
