// RG-LRU linear scan h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rg_lru.py:rg_lru (body
// _lru_kernel, pallas_call at :57). It computes what that kernel computes,
// not its block structure:
//
//   * a, x [B, S, W] row-major, both float32 or both bf16, each converted
//     to float32 per element; out [B, S, W] float32.
//   * h_0 = 0 and the carry stays float32 across the whole sequence. The
//     step is a float32 multiply then a float32 add, each rounded
//     (__fmul_rn, __fadd_rn: no FMA contraction), as the plain version
//     computes it, so the two agree bit for bit.
//   * Ragged S and W are masked in the kernel: nothing is padded or copied
//     (the TPU kernel pads a with 1 and x with 0, which leaves the real
//     lanes and steps as they are).
//
// Bound on an H100 SXM: the bytes, 2 * B * S * W * in_bytes + B * S * W * 4,
// over 3.35 TB/s (2 FLOPs per 10 or 12 bytes is far below the ridge point).
// At RecurrentGemma-2B's rg_lru_scan (B = 1, S = 512, W = 2560, bf16) that
// is 3.13 us.
//
// Design, against that bound. The dependence is cheap (one multiply and
// one add, about 8 cycles a step); what costs is waiting on memory with
// too few lanes in flight. So:
//   * Each CTA owns a narrow strip of L lanes of one batch row (L = 32, or
//     16 where B * ceil(W / 32) < 132), so B * W / L CTAs spread over the
//     SMs: 160 at rg_lru_scan.
//   * Warp 1 produces: it keeps a ring of `stages` stages of 64 steps x L
//     lanes of a and x in shared memory, as far ahead as the ring allows
//     (the wrapper sizes it to hold up to 8 stages, at most 64 KB). Where a
//     row of W elements is a multiple of 16 bytes, one thread issues two
//     TMA boxes per stage (3-d maps [B, S, W], zero fill past S and W);
//     otherwise the warp loads the stage with plain loads ("ldg").
//   * Warp 0 walks the dependent steps: lane w reads its 64 steps of a and
//     x out of shared memory into registers, releases the stage, then runs
//     the 64 steps, storing each float32 h; the L lanes of a step store
//     neighbouring words, so the stores coalesce.
//
// Not done: a scan over chunks (combine (a, x) pairs per chunk, then carry
// across chunks). It changes the rounding, and it pays only where B * W /
// 16 < 132 with a long S.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kSteps = 64;     // sequence steps of one ring stage
constexpr int kThreads = 64;   // warp 0 walks, warp 1 loads
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 128 + 64 * 1024 + 2 * kMaxStages * 8;

// shared memory of one CTA; the wrapper's plan computes the same
__host__ __device__ constexpr int smem_bytes(int lanes, int in_bytes,
                                             int stages) {
  return 128 + stages * 2 * kSteps * lanes * in_bytes + 2 * stages * 8;
}

struct Params {
  const void* a;
  const void* x;
  float* out;
  int S, W, nw, stages, tma;
};

// bf16 travels as its 16 bits: float32 is the same bits shifted up
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    lru_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_x, const Params p) {
  constexpr int kTile = kSteps * L;  // elements of a, or x, in one stage
  extern __shared__ uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * 2 * kTile);
  uint64_t* empty = full + p.stages;

  const int b = blockIdx.x / p.nw;
  const int w0 = (blockIdx.x - b * p.nw) * L;
  const int n_stages = (p.S + kSteps - 1) / kSteps;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], p.tma ? 1 : 32);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // producer warp: stage s holds steps [64 s, 64 s + 64) of lanes
    // [w0, w0 + L), a then x
    const int64_t row0 = static_cast<int64_t>(b) * p.S;
    for (int s = 0; s < n_stages; ++s) {
      const int st = s % p.stages;
      T* ta = ring + st * 2 * kTile;
      T* tx = ta + kTile;
      if (p.tma) {
        if (lane == 0) {
          // round r waits for the walker's release of round r - 1; the
          // first round passes at once
          mbar_wait(&empty[st], ((s / p.stages) & 1) ^ 1);
          mbar_expect_tx(&full[st], 2 * kTile * sizeof(T));
          tma_load_3d(ta, &map_a, &full[st], w0, s * kSteps, b);
          tma_load_3d(tx, &map_x, &full[st], w0, s * kSteps, b);
        }
      } else {
        mbar_wait(&empty[st], ((s / p.stages) & 1) ^ 1);
        const T* ga = static_cast<const T*>(p.a);
        const T* gx = static_cast<const T*>(p.x);
#pragma unroll 8
        for (int e = lane; e < kTile; e += 32) {
          const int t = s * kSteps + e / L;
          const int w = w0 + e % L;
          const bool in = t < p.S && w < p.W;
          const int64_t off = (row0 + t) * p.W + w;
          ta[e] = in ? ga[off] : T(0);
          tx[e] = in ? gx[off] : T(0);
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // walker warp: lane w carries h of lane w0 + w
    const int w = w0 + lane;
    const bool live = lane < L && w < p.W;
    const int col = lane < L ? lane : 0;  // lanes past L read, never store
    float* out = p.out + static_cast<int64_t>(b) * p.S * p.W + w;
    float h = 0.f;
    for (int s = 0; s < n_stages; ++s) {
      const int st = s % p.stages;
      mbar_wait(&full[st], (s / p.stages) & 1);
      const T* ta = ring + st * 2 * kTile;
      const T* tx = ta + kTile;
      float av[kSteps], xv[kSteps];
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        av[t] = to_float(ta[t * L + col]);
        xv[t] = to_float(tx[t * L + col]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      const int n = min(kSteps, p.S - s * kSteps);
      float* o = out + static_cast<int64_t>(s) * kSteps * p.W;
      if (!live) continue;
      if (n == kSteps) {
#pragma unroll
        for (int t = 0; t < kSteps; ++t) {
          h = __fadd_rn(__fmul_rn(av[t], h), xv[t]);
          o[static_cast<int64_t>(t) * p.W] = h;
        }
      } else {
#pragma unroll
        for (int t = 0; t < kSteps; ++t) {
          if (t < n) {
            h = __fadd_rn(__fmul_rn(av[t], h), xv[t]);
            o[static_cast<int64_t>(t) * p.W] = h;
          }
        }
      }
    }
  }
}

// a or x [B, S, W] read in boxes of L lanes x 64 steps of one batch row
bool scan_map(CUtensorMap* map, const void* ptr, int B, int S, int W,
              int lanes, bool bf16) {
  const cuuint64_t eb = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * eb,
                                 static_cast<cuuint64_t>(S) * W * eb};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(lanes), kSteps, 1};
  return make_map(map,
                  bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  3, ptr, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename T, int L>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mx,
                   const Params& p, int ctas, cudaStream_t s) {
  auto kernel = lru_kernel<T, L>;
  // the shared-memory opt-in is per device: once for each
  static uint64_t opted_in = 0;
  const cudaError_t err = opt_in_smem(kernel, kMaxSmem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreads, smem_bytes(L, sizeof(T), p.stages), s>>>(ma, mx,
                                                                    p);
  return cudaGetLastError();
}

}  // namespace

// Launches the scan on `stream` without synchronising, as the wrapper's
// plan says (src/repro_torch/kernels/rg_lru.py:plan): `lanes` (16 or 32)
// per CTA, `stages` ring stages of 64 steps, TMA loads (tma = 1: rows of W
// elements a multiple of 16 bytes, 16-byte aligned bases) or plain loads.
// Returns the first CUDA error, cudaErrorInvalidValue for arguments outside
// that.
extern "C" cudaError_t repro_rg_lru(const void* a, const void* x, void* out,
                                    int B, int S, int W, int lanes,
                                    int stages, int tma, int in_bf16,
                                    void* stream) {
  const int eb = in_bf16 ? 2 : 4;
  if (B <= 0 || S <= 0 || W <= 0 || (lanes != 16 && lanes != 32) ||
      stages < 1 || stages > kMaxStages ||
      smem_bytes(lanes, eb, stages) > kMaxSmem ||
      (tma && ((static_cast<int64_t>(W) * eb) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return cudaErrorInvalidValue;
  const int nw = (W + lanes - 1) / lanes;
  const int64_t ctas = static_cast<int64_t>(B) * nw;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.x = x;
  p.out = static_cast<float*>(out);
  p.S = S;
  p.W = W;
  p.nw = nw;
  p.stages = stages;
  p.tma = tma != 0;
  CUtensorMap ma{}, mx{};  // unread on the plain-load route
  if (tma && (!scan_map(&ma, a, B, S, W, lanes, in_bf16 != 0) ||
              !scan_map(&mx, x, B, S, W, lanes, in_bf16 != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(ctas);
  if (in_bf16)
    return lanes == 32 ? launch<uint16_t, 32>(ma, mx, p, n, s)
                       : launch<uint16_t, 16>(ma, mx, p, n, s);
  return lanes == 32 ? launch<float, 32>(ma, mx, p, n, s)
                     : launch<float, 16>(ma, mx, p, n, s);
}
