// Routed-only expert FFN of an MoE layer for Hopper (sm_90a): the gated
// SiLU experts of the capacity dispatch, run only on the experts that the
// dispatch gave rows.
//
// The entry behind it is src/repro_torch/kernels/moe_experts.py:
// moe_experts; on the card it replaces the three torch.bmm of
// src/repro_torch/distributed/expert_parallel.py:_local_dispatch_ffn over
// every expert's capacity buffer for a bf16 decode (C <= 16 rows an
// expert). It replaces no TPU kernel: the reference's _local_dispatch_ffn
// (src/repro/distributed/expert_parallel.py) is plain einsum that XLA
// lowers to batched products over every expert.
//
// What it computes, with the bmm chain's rounding points:
//
//   * x [E, C, d] (the dispatch's capacity buffers), wi and wg [E, d, f],
//     wo [E, f, d], all bf16; fill [E] int32, each expert's rows that may
//     hold a token (rows at or past fill are zero in x). out [E, C, d]
//     bf16, and a bf16 scratch h [E, C, f].
//   * Launch 1 (gate/up): h = bf16(silu(bf16(x wi)) * bf16(x wg)), where
//     silu(a) = bf16(a * bf16(sigmoid(a))) as models/common.py:silu rounds
//     it; products summed in float32. Rows past fill are not written.
//   * Launch 2 (down): out = bf16(h wo) for rows below fill, 0 for the rest
//     and for every row of an expert with fill 0, as the bmm chain gives on
//     the zero rows.
//   * Sums run in a fixed order (no atomics): every run gives the same
//     bits.
//
// Bound on an H100 SXM: the bytes of the filled experts' weights, 3 * d *
// f * 2 each, over 3.35 TB/s (the products are 2 * C flops a weight byte,
// far under the tensor cores' 295). At deepseek-v3-671b's decode (E 256,
// C 1, d 7168, f 2048) about 100 of 256 experts fill a step: 8.8 GB, 2.6
// ms a layer, where the bmm chain reads all 256 (22.5 GB).
//
// Design, against that bound:
//   * Work items are (filled expert, 64-column tile of the output): each
//     CTA first lists the filled experts in shared memory (one warp, one
//     ballot per 32 experts), so no CTA is spent on an empty one, then
//     walks items blockIdx.x, blockIdx.x + gridDim.x, ... (a persistent
//     grid, as many CTAs as fit on the SMs).
//   * The 4 warps of a CTA split an item's rows of weights (d for gate/up,
//     f for down) into 4 contiguous ranges, and stream them straight into
//     registers: 16-byte loads, 8 columns of one row a thread, 4 rows a
//     thread per 16-row step, so a warp's load covers 4 rows x 128 bytes.
//     Each thread keeps `S` - 1 steps of loads in flight ahead of the step
//     it computes (a ring in registers, unrolled so that it stays in
//     registers: S = 2 for gate/up, 3 for down), across item boundaries
//     too, so that the loads of the next item run under this item's
//     epilogue. Three CTAs share an SM, so one CTA's epilogue runs under
//     the others' loads.
//   * The products are mma.sync m16n8k16 with the weights as A (16 output
//     columns by 16 rows) and the tokens as B (n 8, C padded to 8, or two
//     n tiles for C <= 16): a thread's loaded 8 columns x 4 rows are
//     exactly its A fragments of 4 products once each pair of rows is
//     interleaved (one byte permute a register), with the rows of the 16
//     permuted alike in A and B; the token fragments are 8-byte loads of
//     x (L2-resident), zero past fill.
//   * At the end of an item the warps' float32 partial sums meet in shared
//     memory and are added in warp order; then the epilogue rounds and
//     writes.
//   * The down launch also writes the zero rows of the experts with fill
//     0, spread over all CTAs.
//   * Measured on the H100 (PERF.md has the numbers): 8 warps and one CTA
//     an SM read 86-89% of the bound at the zoo's decode shapes; deeper
//     rings (more registers) and an L2 256-byte prefetch hint on the loads
//     read less; more CTAs an SM read more, and 4 warps x 3 CTAs the most,
//     91-93%. A fourth CTA caps the registers at 128, and gate/up with two
//     token tiles spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 64;          // output columns of one item
constexpr int kRedLd = kCols + 2;  // row pitch of the partial sums
constexpr int kMaxExperts = 1024;
constexpr int kMaxRows = 16;
constexpr int kBlocksPerSm = 3;   // CTAs an SM: at most 168 registers a thread

struct Params {
  const __nv_bfloat16* x;  // [E, C, d]
  const int* fill;         // [E]
  const __nv_bfloat16* wi;
  const __nv_bfloat16* wg;
  const __nv_bfloat16* wo;
  __nv_bfloat16* h;        // [E, C, f]
  __nv_bfloat16* out;      // [E, C, d]
  long long wi_e, wi_k, wg_e, wg_k, wo_e, wo_k;  // strides in elements
  int E, C, d, f;
};

// the lists of filled and empty experts, then the partial sums
__host__ __device__ constexpr int list_bytes() {
  return (3 * kMaxExperts + 4) * 4;
}
__host__ __device__ constexpr int smem_bytes(int mats, int nt) {
  return list_bytes() + mats * kWarps * nt * 8 * kRedLd * 4;
}

// one 16-byte load of weights that are read once: not kept in L1
__device__ __forceinline__ uint4 load_stream(const __nv_bfloat16* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// What one thread loads for one 16-row step: 4 rows x 8 columns of each
// weight matrix, and its tokens' 4 values of x at those rows.
template <int MATS, int NT>
struct Step {
  uint4 w[MATS][4];
  uint2 x[NT];
};

// Where one item's loads start for this thread.
template <int MATS>
struct Item {
  const __nv_bfloat16* w[MATS];
  const __nv_bfloat16* x;
  int fill, e, col0;
};

// kGateUp: the gate/up launch (weights wi and wg [E, d, f], tokens x,
// writes h); else the down launch (wo [E, f, d], tokens h, writes out).
// NT: token tiles of 8 (1 for C <= 8, else 2). S: the register ring's
// steps.
template <bool kGateUp, int NT, int S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    experts_kernel(const Params p) {
  constexpr int MATS = kGateUp ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_list = reinterpret_cast<int*>(smem);  // filled experts, in order
  int* s_fill = s_list + kMaxExperts;          // their fills
  int* s_empty = s_fill + kMaxExperts;         // the experts with fill 0
  int* s_count = s_empty + kMaxExperts;        // filled, empty
  float* red = reinterpret_cast<float*>(smem + list_bytes());

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = p.C;
  const int K = kGateUp ? p.d : p.f;  // rows of the weights
  const int N = kGateUp ? p.f : p.d;  // their columns
  const long long w_e[2] = {kGateUp ? p.wi_e : p.wo_e, p.wg_e};
  const long long w_k[2] = {kGateUp ? p.wi_k : p.wo_k, p.wg_k};
  const __nv_bfloat16* w_base[2] = {kGateUp ? p.wi : p.wo, p.wg};
  const __nv_bfloat16* x_base = kGateUp ? p.x : p.h;

  if (warp == 0) {
    int nf = 0, ne = 0;
    const unsigned below = (1u << lane) - 1;
    for (int e0 = 0; e0 < p.E; e0 += 32) {
      const int e = e0 + lane;
      const int fl = e < p.E ? min(max(p.fill[e], 0), C) : 0;
      const unsigned on = __ballot_sync(~0u, fl > 0);
      const unsigned off = __ballot_sync(~0u, fl == 0 && e < p.E);
      if (fl > 0) {
        s_list[nf + __popc(on & below)] = e;
        s_fill[nf + __popc(on & below)] = fl;
      } else if (e < p.E) {
        s_empty[ne + __popc(off & below)] = e;
      }
      nf += __popc(on);
      ne += __popc(off);
    }
    if (lane == 0) {
      s_count[0] = nf;
      s_count[1] = ne;
    }
  }
  __syncthreads();

  if (!kGateUp) {  // the empty experts' rows of out are zero
    const long long per = static_cast<long long>(C) * N / 8;
    const long long chunks = per * s_count[1];
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (long long c = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         c < chunks; c += static_cast<long long>(gridDim.x) * kThreads) {
      const long long e = s_empty[c / per];
      reinterpret_cast<uint4*>(p.out + e * C * N)[c % per] = zero;
    }
  }

  const int tiles = N / kCols;
  const int items = s_count[0] * tiles;
  const int mine = items > static_cast<int>(blockIdx.x)
                       ? (items - 1 - static_cast<int>(blockIdx.x)) /
                                 static_cast<int>(gridDim.x) + 1
                       : 0;
  const int spw = K / (16 * kWarps);  // 16-row steps of a warp an item
  const int total = mine * spw;
  const int row0 = warp * spw * 16 + 4 * t;  // this thread's first row

  auto item_at = [&](int local) {
    Item<MATS> it;
    const int item = static_cast<int>(blockIdx.x) +
                     local * static_cast<int>(gridDim.x);
    const int slot = item / tiles;
    it.e = s_list[slot];
    it.fill = s_fill[slot];
    it.col0 = (item - slot * tiles) * kCols;
#pragma unroll
    for (int m = 0; m < MATS; ++m)
      it.w[m] = w_base[m] + it.e * w_e[m] + row0 * w_k[m] + it.col0 + 8 * g;
    it.x = x_base + static_cast<long long>(it.e) * C * K + row0;
    return it;
  };
  auto load = [&](Step<MATS, NT>& s, const Item<MATS>& it, int j) {
#pragma unroll
    for (int m = 0; m < MATS; ++m) {
      const __nv_bfloat16* w = it.w[m] + static_cast<long long>(j) * 16 *
                                             w_k[m];
#pragma unroll
      for (int r = 0; r < 4; ++r) s.w[m][r] = load_stream(w + r * w_k[m]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int tok = n * 8 + g;
      s.x[n] = tok < it.fill
                   ? __ldg(reinterpret_cast<const uint2*>(
                         it.x + static_cast<long long>(tok) * K + j * 16))
                   : make_uint2(0, 0);
    }
  };

  float acc[MATS][4][NT][4];
#pragma unroll
  for (int m = 0; m < MATS; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][n][i] = 0.f;

  // Virtual k of the 16-row step (the products' order) against real rows:
  // thread t's k pair 2t, 2t+1 is rows 4t, 4t+1, its pair 2t+8, 2t+9 rows
  // 4t+2, 4t+3. Output column 8g + 2c is the product's row g, 8g + 2c + 1
  // its row g + 8 (product c of 4).
  auto compute = [&](const Step<MATS, NT>& s) {
#pragma unroll
    for (int m = 0; m < MATS; ++m) {
      const uint32_t* r0 = reinterpret_cast<const uint32_t*>(&s.w[m][0]);
      const uint32_t* r1 = reinterpret_cast<const uint32_t*>(&s.w[m][1]);
      const uint32_t* r2 = reinterpret_cast<const uint32_t*>(&s.w[m][2]);
      const uint32_t* r3 = reinterpret_cast<const uint32_t*>(&s.w[m][3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t a0 = __byte_perm(r0[c], r1[c], 0x5410);
        const uint32_t a1 = __byte_perm(r0[c], r1[c], 0x7632);
        const uint32_t a2 = __byte_perm(r2[c], r3[c], 0x5410);
        const uint32_t a3 = __byte_perm(r2[c], r3[c], 0x7632);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_bf16(acc[m][c][n], a0, a1, a2, a3, s.x[n].x, s.x[n].y);
      }
    }
  };

  auto epilogue = [&](const Item<MATS>& it) {
    // this warp's partial sums: (token, column) at red[m][warp][token][col]
#pragma unroll
    for (int m = 0; m < MATS; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float* r = red + ((m * kWarps + warp) * NT * 8 + n * 8 + 2 * t) *
                               kRedLd + 8 * g + 2 * c;
          *reinterpret_cast<float2*>(r) =
              make_float2(acc[m][c][n][0], acc[m][c][n][2]);
          *reinterpret_cast<float2*>(r + kRedLd) =
              make_float2(acc[m][c][n][1], acc[m][c][n][3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][c][n][i] = 0.f;
        }
    __syncthreads();
    const int rows = kGateUp ? it.fill : C;
    for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
      const int tok = i / kCols, col = i - tok * kCols;
      float sum[MATS];
#pragma unroll
      for (int m = 0; m < MATS; ++m) {
        sum[m] = 0.f;
        if (tok < it.fill) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            sum[m] += red[((m * kWarps + w) * NT * 8 + tok) * kRedLd + col];
        }
      }
      const long long at =
          (static_cast<long long>(it.e) * C + tok) * N + it.col0 + col;
      if (kGateUp) {
        const float a = round_bf16(sum[0]);
        const float sig = round_bf16(1.f / (1.f + expf(-a)));
        const float gate = round_bf16(a * sig);
        p.h[at] = __float2bfloat16_rn(gate * round_bf16(sum[MATS - 1]));
      } else {
        p.out[at] = __float2bfloat16_rn(sum[0]);  // 0 past fill
      }
    }
    __syncthreads();  // red is the next item's
  };

  Step<MATS, NT> ring[S];
  Item<MATS> ld, cur;
  int ld_local = 0, ld_j = 0;
  if (mine > 0) cur = ld = item_at(0);
  auto advance = [&]() {
    if (++ld_j == spw) {
      ld_j = 0;
      if (++ld_local < mine) ld = item_at(ld_local);
    }
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i)
    if (i < total) {
      load(ring[i], ld, ld_j);
      advance();
    }
  int j = 0, local = 0;
  for (int q0 = 0; q0 < total; q0 += S) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (q0 + i < total) {
        if (q0 + i + S - 1 < total) {
          load(ring[(i + S - 1) % S], ld, ld_j);
          advance();
        }
        compute(ring[i]);
        if (++j == spw) {
          epilogue(cur);
          j = 0;
          if (++local < mine) cur = item_at(local);
        }
      }
    }
  }
}

// Launches one kernel on a persistent grid: as many CTAs as fit on the
// device's SMs (found once a device and kernel), at most one an item.
template <bool kGateUp, int NT, int S>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static int blocks[64] = {};
  constexpr int smem = smem_bytes(kGateUp ? 2 : 1, NT);
  auto kernel = experts_kernel<kGateUp, NT, S>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks[dev] = sms * per_sm;
  }
  const int N = kGateUp ? p.f : p.d;
  const long long items = static_cast<long long>(p.E) * (N / kCols);
  const int grid = static_cast<int>(items < blocks[dev] ? items : blocks[dev]);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t run(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch<true, NT, 2>(p, stream);
  if (err != cudaSuccess) return err;
  return launch<false, NT, 3>(p, stream);
}

}  // namespace

// Launches the two kernels on `stream` without synchronising. The integer
// arguments come packed in one int64 array `a`: the addresses of x, fill,
// wi, wg, wo, h and out; then E, C, d, f; then the strides (in elements)
// wi_e, wi_k, wg_e, wg_k, wo_e, wo_k. x [E, C, d], h [E, C, f] and out
// [E, C, d] contiguous; the weights' rows contiguous, their bases and
// strides multiples of 16 bytes; fill [E] int32. 1 <= C <= 16, E <= 1024,
// d and f multiples of 64. Returns the first CUDA error,
// cudaErrorInvalidValue for arguments outside that.
extern "C" cudaError_t repro_moe_experts(const long long* a, void* stream) {
  Params p;
  p.x = reinterpret_cast<const __nv_bfloat16*>(a[0]);
  p.fill = reinterpret_cast<const int*>(a[1]);
  p.wi = reinterpret_cast<const __nv_bfloat16*>(a[2]);
  p.wg = reinterpret_cast<const __nv_bfloat16*>(a[3]);
  p.wo = reinterpret_cast<const __nv_bfloat16*>(a[4]);
  p.h = reinterpret_cast<__nv_bfloat16*>(a[5]);
  p.out = reinterpret_cast<__nv_bfloat16*>(a[6]);
  p.E = static_cast<int>(a[7]);
  p.C = static_cast<int>(a[8]);
  p.d = static_cast<int>(a[9]);
  p.f = static_cast<int>(a[10]);
  p.wi_e = a[11];
  p.wi_k = a[12];
  p.wg_e = a[13];
  p.wg_k = a[14];
  p.wo_e = a[15];
  p.wo_k = a[16];
  if (p.E < 1 || p.E > kMaxExperts || p.C < 1 || p.C > kMaxRows ||
      p.d % (16 * kWarps) || p.f % (16 * kWarps) || p.d < 1 || p.f < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.C <= 8 ? run<1>(p, s) : run<2>(p, s);
}
