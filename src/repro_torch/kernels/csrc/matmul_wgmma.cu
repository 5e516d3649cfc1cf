// Matmul C = A @ B on Hopper's tensor cores (sm_90a): wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py:matmul, both
// bodies: _matmul_kernel_kinner (pallas_call at :99, k_inner=1) and
// _matmul_kernel_kouter (pallas_call at :115, k_inner=0). It computes what
// those compute, on bf16 operands:
//
//   * A [M, K] and B [K, N] row-major bf16 (B is N-contiguous: "MN-major"
//     for wgmma, read through the transpose flag, never copied); C [M, N]
//     row-major, float32 or bf16. Products are exact and sums are float32,
//     as on the TPU's MXU with preferred_element_type=float32.
//   * k_inner=1, or a float32 output: one float32 sum, stored once in the
//     output dtype.
//   * k_inner=0 with a bf16 output (round_each_block): at every bk boundary
//     out = bf16(float(out) + float(bf16(part))), part = 0, where the TPU
//     kernel's bf16 output block is revisited. The running output is exact
//     bf16 after every round, so it lives in registers as __nv_bfloat162.
//
// Bound on an H100 SXM: the larger of 2MNK / 989 TFLOP/s (bf16 dense) and
// (MK + KN) * 2 + MN * out_bytes over 3.35 TB/s. The LM GEMMs at M = 512
// (RecurrentGemma-2B) are bound by operations; ResNet-18's small-M, long-K
// GEMMs by bytes, and those have too few output tiles to fill 132 SMs.
//
// Design, against that bound:
//   * CTA tile 128 x BN (BN = 128 or 256, chosen by the wrapper) x 64-deep
//     k stages. Warpgroup 0 is the producer: one thread issues TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle) into a ring of kStages stages
//     with a full and an empty mbarrier each. Warpgroups 1 and 2 are the
//     consumers: each owns 64 rows and runs wgmma.mma_async m64nBNk16 on
//     the stage, keeping one wgmma group in flight while it releases the
//     previous stage. setmaxnreg moves registers from producer (40) to
//     consumers (232): a 64 x 256 float32 accumulator is 128 per thread.
//   * Shared memory per stage: A 128 x 64 bf16 = 16 KB, B 64 x BN bf16 = 16
//     or 32 KB (BN / 64 boxes of 64 n x 64 k, each 8 KB, since a swizzled
//     box row is at most 128 bytes). BN = 256: 4 stages x 48 KB = 192 KB;
//     BN = 128: 6 x 32 KB = 192 KB; plus 1 KB of alignment slack and the
//     barriers: 197,696 (BN = 256) and 197,728 bytes (BN = 128) of the
//     232,448 a block may use. The epilogue stores from registers, so it
//     needs no staging. More than half the SM's shared memory also keeps
//     one CTA per SM, which setmaxnreg needs.
//   * The grid is linear, one CTA per (CTA tile, k split), and fills the
//     card rather than following the TPU's tile. The tuned block_m x block_n
//     sets the raster group: the CTA tiles covering one tuned tile get
//     consecutive indices, so they run together and share A and B panels in
//     the 50 MB L2. The result never depends on it.
//   * Split-K where the output tiles are too few for 132 SMs (small-M,
//     long-K GEMMs): split points are multiples of bk (and of 64), each
//     split writes float32 partials to a workspace [splits, M, N], and
//     splitk_reduce adds them in split order and casts: deterministic, no
//     atomics. Only when the output accumulates in float32.
//   * Ragged edges: TMA zero-fills out-of-bounds boxes (M, N and K edges),
//     and the epilogue masks its stores. TMA needs 16-byte row strides, so
//     the wrapper zero-pads K (and N of B) to a multiple of 8 where needed.
//
// Not done yet: persistent CTAs, clusters with TMA multicast, a TMA store
// epilogue. The mbarrier, TMA, descriptor and wgmma helpers live in
// csrc/hopper.cuh, shared with csrc/flash_attention_wgmma.cu.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;       // CTA rows: two consumer warpgroups of 64
constexpr int kBK = 64;        // k depth of a stage: one 128-byte swizzle row
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumerWarps = 8;
constexpr int kBoxBytes = 64 * 64 * 2;  // one 64 x 64 bf16 TMA box

template <int BN>
struct Cfg {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "a block may use at most 227 KB");
  static_assert(kSmem > 232448 / 2, "one CTA per SM (setmaxnreg needs it)");
};

struct Params {
  void* out;
  float* ws;  // [splits, M, N] float32 partials when splits > 1
  int M, N, K, bk;
  int tiles_m, tiles_n, group_m, group_n;
  int split_k;  // k elements per split, a multiple of 64 and of bk
};

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(d, da, db);
  else
    wgmma_m64n128k16(d, da, db);
}

// CTA tile of linear index t: bands of group_m tile-rows, full width; in a
// band, groups of group_n tile-columns; in a group, tiles column by column.
// The tiles covering one tuned tile are numbered consecutively.
__device__ __forceinline__ void raster(int t, const Params& p, int& tm,
                                       int& tn) {
  const int band = t / (p.group_m * p.tiles_n);
  const int rows = min(p.group_m, p.tiles_m - band * p.group_m);
  const int local = t - band * p.group_m * p.tiles_n;
  const int gcol = local / (rows * p.group_n);
  const int off = local - gcol * rows * p.group_n;
  tm = band * p.group_m + off % rows;
  tn = gcol * p.group_n + off / rows;
}

__device__ __forceinline__ void store_pair(float* base, int64_t off, int col,
                                           int N, float v0, float v1) {
  if (col + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<float2*>(base + off) = make_float2(v0, v1);
  } else {
    if (col < N) base[off] = v0;
    if (col + 1 < N) base[off + 1] = v1;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* base, int64_t off,
                                           int col, int N,
                                           __nv_bfloat162 v) {
  if (col + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(base + off) = v;
  } else {
    if (col < N) base[off] = v.x;
    if (col + 1 < N) base[off + 1] = v.y;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* base, int64_t off,
                                           int col, int N, float v0,
                                           float v1) {
  store_pair(base, off, col, N, __floats2bfloat162_rn(v0, v1));
}

// run = bf16(float(run) + float(bf16(part))); part = 0
template <int R>
__device__ __forceinline__ void round_into(__nv_bfloat162 (&run)[R / 2],
                                           float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const float2 o = __bfloat1622float2(run[i]);
    const float2 q =
        __bfloat1622float2(__floats2bfloat162_rn(part[2 * i], part[2 * i + 1]));
    run[i] = __floats2bfloat162_rn(o.x + q.x, o.y + q.y);
    part[2 * i] = 0.f;
    part[2 * i + 1] = 0.f;
  }
}

template <int BN, bool kRound, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, const Params p) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  // TMA boxes with 128-byte swizzle and the wgmma descriptors' zero base
  // offset need 1024-byte aligned stages
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;

  const int n_tiles = p.tiles_m * p.tiles_n;
  const int split = blockIdx.x / n_tiles;
  int tm, tn;
  raster(blockIdx.x - split * n_tiles, p, tm, tn);
  const int m0 = tm * kBM, n0 = tn * BN;
  const int k_lo = split * p.split_k;
  const int k_hi = min(p.K, k_lo + p.split_k);
  const int n_stages = (k_hi - k_lo + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      for (int s = 0; s < n_stages; ++s) {
        const int st = s % C::kStages;
        // round r waits for the consumers' release of round r - 1; the
        // first round passes at once
        mbar_wait(&empty[st], ((s / C::kStages) & 1) ^ 1);
        uint8_t* sa = smem + st * C::kStageBytes;
        uint8_t* sb = sa + C::kABytes;
        const int k0 = k_lo + s * kBK;
        mbar_expect_tx(&full[st], C::kStageBytes);
        tma_load(sa, &map_a, &full[st], k0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(sb + j * kBoxBytes, &map_b, &full[st], n0 + 64 * j, k0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1;  // this warpgroup's 64 rows of the CTA tile
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    __nv_bfloat162 run[kRound ? BN / 4 : 1];
    if constexpr (kRound) {
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) run[i] = __floats2bfloat162_rn(0.f, 0.f);
    }

    for (int s = 0; s < n_stages; ++s) {
      const int st = s % C::kStages;
      mbar_wait(&full[st], (s / C::kStages) & 1);
      // A: K-major 128-byte rows, 8-row swizzle atoms 1024 bytes apart; a
      // k16 step is 32 bytes along the row. B: MN-major boxes of 64 k rows
      // x 64 n (128 bytes), 8-row atoms 1024 bytes apart (SBO), boxes 8 KB
      // apart along n (LBO); a k16 step is 16 rows = 2048 bytes.
      const uint8_t* sa = smem + st * C::kStageBytes + c * 64 * 128;
      const uint8_t* sb = smem + st * C::kStageBytes + C::kABytes;
      if constexpr (!kRound) {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j)
          mma<BN>(acc, smem_desc(sa + 32 * j, 16, 1024),
                  smem_desc(sb + 2048 * j, kBoxBytes, 1024));
        wgmma_commit();
        // the previous stage's group is done: release its buffers
        wgmma_wait<1>();
        fence_regs(acc);
        if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % C::kStages]);
      } else {
        const int k0 = k_lo + s * kBK;
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          const int kk = k0 + 16 * j;
          if (kk > 0 && kk < p.K && kk % p.bk == 0) {
            // a bk boundary: the issued products must land before the
            // accumulators are read
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            round_into<BN / 2>(run, acc);
          }
          fence_regs(acc);
          wgmma_fence();
          mma<BN>(acc, smem_desc(sa + 32 * j, 16, 1024),
                  smem_desc(sb + 2048 * j, kBoxBytes, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (kRound) round_into<BN / 2>(run, acc);

    // accumulator layout of m64nNk16: thread (warp, lane) holds rows
    // 16 warp + lane / 4 (+ 8) and columns 8 i + 2 (lane % 4) (+ 1)
    const int row0 = m0 + c * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
    const bool partial = p.ws != nullptr;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = col0 + 8 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.M || col >= p.N) continue;
        const int64_t off = static_cast<int64_t>(row) * p.N + col;
        if constexpr (kRound) {
          store_pair(static_cast<__nv_bfloat16*>(p.out), off, col, p.N,
                     run[2 * i + h]);
        } else if (partial) {
          store_pair(p.ws + static_cast<int64_t>(split) * p.M * p.N, off, col,
                     p.N, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        } else {
          store_pair(static_cast<TOut*>(p.out), off, col, p.N,
                     acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out = sum of the splits' partials, in split order, cast once
template <typename TOut>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              TOut* __restrict__ out, int64_t mn, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < mn; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    for (int k = 1; k < splits; ++k) s += ws[k * mn + i];
    store_one(out + i, s);
  }
}

// a row-major bf16 matrix [outer, inner] with `ld` elements per row, read
// in 64 x 64 boxes (128-byte rows, 128-byte swizzle); out-of-bounds boxes
// fill with zeros
bool operand_map(CUtensorMap* map, const void* ptr, int inner, int outer,
                 int ld, int box_outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims,
                          strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BN, bool kRound, typename TOut>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb,
                   const Params& p, int ctas, cudaStream_t s) {
  auto kernel = gemm_wgmma<BN, kRound, TOut>;
  // the shared-memory opt-in is per device: once for each
  static uint64_t opted_in = 0;
  const cudaError_t err =
      hopper::opt_in_smem(kernel, Cfg<BN>::kSmem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreads, Cfg<BN>::kSmem, s>>>(ma, mb, p);
  return cudaGetLastError();
}

}  // namespace

// Launches C = A @ B on `stream` without synchronising, as the wrapper's
// plan says (src/repro_torch/kernels/matmul.py:plan). A [M, lda] and B
// [K, ldb] are bf16 with 16-byte aligned bases and rows (lda, ldb multiples
// of 8, >= K and N); C [M, N] is float32 or bf16 (out_bf16). cta_n is 128
// or 256; the raster group is group_m x group_n CTA tiles; splits > 1 sums
// k ranges of split_k elements through the float32 workspace `ws`
// [splits, M, N]. round_each_block rounds the bf16 output at every bk
// boundary (cta_n 128, one split, bk a multiple of 16 or >= K). Returns the
// first CUDA error, cudaErrorInvalidValue for arguments outside that.
extern "C" cudaError_t repro_matmul_wgmma(
    const void* a, const void* b, void* c, void* ws, int M, int N, int K,
    int lda, int ldb, int bk, int cta_n, int group_m, int group_n, int splits,
    int split_k, int round_each_block, int out_bf16, void* stream) {
  const bool round = round_each_block != 0;
  if (M <= 0 || N <= 0 || K <= 0 || lda < K || ldb < N || lda % 8 != 0 ||
      ldb % 8 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 || bk <= 0 ||
      (cta_n != 128 && cta_n != 256) || group_m <= 0 || group_n <= 0 ||
      splits <= 0 || split_k <= 0 || (splits > 1 && split_k % kBK != 0) ||
      static_cast<int64_t>(splits) * split_k < K ||
      static_cast<int64_t>(splits - 1) * split_k >= K ||
      (splits > 1) != (ws != nullptr) ||
      (round && (cta_n != 128 || !out_bf16 || splits != 1 ||
                 (bk % 16 != 0 && bk < K))))
    return cudaErrorInvalidValue;
  Params p;
  p.out = c;
  p.ws = static_cast<float*>(ws);
  p.M = M;
  p.N = N;
  p.K = K;
  p.bk = bk;
  p.tiles_m = (M + kBM - 1) / kBM;
  p.tiles_n = (N + cta_n - 1) / cta_n;
  p.group_m = group_m < p.tiles_m ? group_m : p.tiles_m;
  p.group_n = group_n < p.tiles_n ? group_n : p.tiles_n;
  p.split_k = split_k;
  const int64_t ctas = static_cast<int64_t>(p.tiles_m) * p.tiles_n * splits;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;

  CUtensorMap ma, mb;
  if (!operand_map(&ma, a, K, M, lda, kBM) ||
      !operand_map(&mb, b, N, K, ldb, kBK))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int n = static_cast<int>(ctas);
  if (round)
    err = launch<128, true, __nv_bfloat16>(ma, mb, p, n, s);
  else if (cta_n == 256)
    err = out_bf16 ? launch<256, false, __nv_bfloat16>(ma, mb, p, n, s)
                   : launch<256, false, float>(ma, mb, p, n, s);
  else
    err = out_bf16 ? launch<128, false, __nv_bfloat16>(ma, mb, p, n, s)
                   : launch<128, false, float>(ma, mb, p, n, s);
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t mn = static_cast<int64_t>(M) * N;
  const int blocks = static_cast<int>(mn / 256 + 1 < 4096 ? mn / 256 + 1 : 4096);
  if (out_bf16)
    splitk_reduce<<<blocks, 256, 0, s>>>(p.ws, static_cast<__nv_bfloat16*>(c), mn, splits);
  else
    splitk_reduce<<<blocks, 256, 0, s>>>(p.ws, static_cast<float*>(c), mn, splits);
  return cudaGetLastError();
}
