// Mamba-1 selective scan, float32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per channel d, state n)
//   y_t = sum_n C_t[n] * h_t[n]
// with h_{-1} = h0; returns y (B, S, Di) and h_last = h_{S-1} (B, Di, N).
//
// Replaces the TPU kernel
// src/repro/kernels/selective_scan/kernel.py:selective_scan_kernel.
//
// Bound on the H100: the exponentials and the bytes, about equally.  At
// the serve shape (B 1, S 256, Di 8192, N 16) the kernel must read x and
// dt and write y (25 MB, plus A, h0 and h_last), ~8 us at 3.35 TB/s, and
// compute S * Di * N = 33.5 M exponentials, ~8 us on the SFUs (16 a clock
// on each of 132 SMs).  The time axis is a recurrence, so it stays
// sequential inside a block (a time-chunked two-pass scan would compute
// every exponential twice); the state lives in registers for the whole
// sequence.  The design:
//   - a block owns 32 channels of one batch row (one a lane) and splits
//     their states over kParts = 8 warps (2 states a thread at N 16, 1 at
//     N <= 8): 256 blocks of 256 threads at B 1, Di 8192;
//   - the decay is ex2(dt * a2) with a2 = fl32(A * log2 e) formed once per
//     state: one multiply and one MUFU.EX2 (IEEE expf is ~10 instructions
//     around it).  ex2.approx adds at most 2 ulp; a2's rounding adds
//     |dt * a2| ulp; FTZ flushes only decays below 2^-126;
//   - a thread keeps its partial sums of y (its states' C h in increasing
//     n) for a whole 32-step tile in registers and stores them after the
//     tile's loads (a store between two steps would keep the compiler from
//     hoisting the next step's loads); each warp then folds 4 steps of the
//     tile before it from the 8 parts' rows, in a fixed tree
//     ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)), and stores y in
//     coalesced rows.  No shuffles, and every lane stores;
//   - x, dt, B and C arrive through a ring of kStages tiles: four TMA
//     boxes a tile issued by one thread where the operands allow it (the
//     TMA route: 16-byte aligned, strides of whole 16-byte chunks), each
//     thread's share of 4-byte cp.async copies elsewhere; a step reads dt,
//     x and (broadcast to the warp) its part's B and C;
//   - mbarriers instead of block-wide barriers: a warp waits only for the
//     data it reads (a tile landed, every part's partial sums stored, a
//     buffer folded), so the warps of a block drift apart by up to a tile.
// Ragged S and Di are zero-filled: a step with dt = x = B = 0 leaves h
// exactly as it was, and a channel past Di stays zero.  States past N
// have a2 = 0 and B = C = 0: they stay zero and add zero.  Every step's
// arithmetic is the same wherever its tile starts, so a scan split in
// two through h_last gives the bits of one scan, on either route.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

// The constants below can be overridden at compile time (-DSCAN_TILE=16
// ...) by scripts/scan_variants.py, which builds and times such variants;
// the library is built with the defaults.
#ifndef SCAN_PARTS
#define SCAN_PARTS 8
#endif
#ifndef SCAN_TILE
#define SCAN_TILE 32
#endif
#ifndef SCAN_STAGES
#define SCAN_STAGES 3
#endif

#ifdef SCAN_CLOCK
// The timeline build (scripts/scan_variants.py --clock): each warp's
// clock64 at its start, once A and h0 landed, per tile (stage refilled,
// tile landed, buffer free, tile computed and stored, tile before folded)
// and at its end, for the first 4096 blocks.
constexpr int kClockEvents = 48;
__device__ long long g_scan_clock[4096 * SCAN_PARTS * kClockEvents];
#define SCAN_STAMP(ev)                                                      \
  do {                                                                      \
    const int blk_ = blockIdx.y * gridDim.x + blockIdx.x;                   \
    if (threadIdx.x % 32 == 0 && blk_ < 4096 && (ev) < kClockEvents)        \
      g_scan_clock[(blk_ * SCAN_PARTS + threadIdx.x / 32) * kClockEvents +  \
                   (ev)] = clock64();                                       \
  } while (0)
#else
#define SCAN_STAMP(ev)
#endif

constexpr int kParts = SCAN_PARTS;  // warps a channel's states are split over
constexpr int kChan = 32;           // channels a block, one a lane
constexpr int kThreads = kChan * kParts;
constexpr int kT = SCAN_TILE;       // time steps a ring stage
constexpr int kStages = SCAN_STAGES;
constexpr int kMaxState = 16;
constexpr int kRow = kT + 4;        // a partial-sum row: lanes on distinct banks
constexpr int kFold = kT / kParts;  // steps of a tile each warp folds
static_assert(kParts == 2 || kParts == 4 || kParts == 8,
              "a part holds 1 to 8 of at most 16 states");
static_assert(kStages >= 2 && kT % 8 == 0 && kFold % 2 == 0,
              "a ring of whole 8-step runs, folded in vectors");

// Shared memory, in floats: kStages ring stages (dt and x, kT x kChan
// each; B and C, kT x kMaxState each: TMA boxes, 128-byte aligned); two
// buffers of the parts' partial sums of y (kParts x kChan rows of kRow
// steps); A and h0 of the block's channels; the mbarriers.
constexpr int kStage = 2 * kT * kChan + 2 * kT * kMaxState;
constexpr int kPartial = kParts * kChan * kRow;
constexpr int kBars = (kStages + 6) / 2 * 2;  // mbarriers (2 floats each)
constexpr size_t kSmemBytes =
    sizeof(float) * (kStages * kStage + 2 * kPartial +
                     2 * kChan * kMaxState + 2 * kBars);
constexpr uint32_t kStageBytes = sizeof(float) * kStage;
static_assert(kStageBytes % 128 == 0, "TMA boxes 128-byte aligned");

// y from the parts' partial sums v[0 .. kParts): the upper half added to
// the lower half until one is left, ((v0 + v4) + (v2 + v6)) + ((v1 + v5)
// + (v3 + v7)) for 8 parts
__device__ __forceinline__ void part_tree(float (&v)[kParts][kFold]) {
#pragma unroll
  for (int m = kParts / 2; m >= 1; m /= 2) {
#pragma unroll
    for (int j = 0; j < m; ++j) {
#pragma unroll
      for (int e = 0; e < kFold; ++e) v[j][e] = v[j][e] + v[j + m][e];
    }
  }
}

// Operands of a launch; the tensor maps (dt, x as (Di, S, B) boxes of
// kChan x kT; B, C as (N, S, B) boxes of kMaxState x kT) only on the TMA
// route.
struct ScanArgs {
  const float* x;
  const float* dt;
  const float* bm;
  const float* cm;
  const float* A;
  const float* h0;
  float* y;
  float* h_last;
  int S, Di, N;
  long long b_sb, b_ss, c_sb, c_ss;
};

template <int NPL, bool kTma>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const __grid_constant__ CUtensorMap tdt,
                          const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tb,
                          const __grid_constant__ CUtensorMap tc,
                          const ScanArgs p) {
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;
  float* partial = ring + kStages * kStage;
  float* sA = partial + 2 * kPartial;   // nc x N, then h0 likewise
  float* sh0 = sA + kChan * kMaxState;
  // mbarriers: ring_full[kStages] (the TMA bytes on the TMA route, every
  // thread's copies on the other), init_full (every thread's copies),
  // part_full[2] (every thread, once the parts' partial sums of a tile
  // are stored), part_empty[2] (every thread, once its warp has folded
  // its share of them)
  const uint32_t bars = smem_u32(sh0 + kChan * kMaxState);
  const uint32_t init_full = bars + 8 * kStages;
  const uint32_t part_full = init_full + 8;
  const uint32_t part_empty = part_full + 16;

  const int tid = threadIdx.x;
  SCAN_STAMP(0);
  const int lane = tid % 32;
  const int part = tid / 32;            // the warp: states n0 .. n0 + NPL
  const int n0 = part * NPL;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChan;
  const int c = c0 + lane;
  const int S = p.S, Di = p.Di, N = p.N;
  const int nc = min(kChan, Di - c0);   // channels of this block
  const long long row = static_cast<long long>(b) * S * Di;
  float* yb = p.y + row;
  const int ntiles = (S + kT - 1) / kT;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      mbar_init(bars + 8 * s, kTma ? 1 : kThreads);
    for (int i = kStages; i < kStages + 5; ++i)
      mbar_init(bars + 8 * i, kThreads);
    mbar_fence_init();
  }
  __syncthreads();

  // Tile k into its stage, zeros past S, Di and N: four TMA boxes issued
  // by one thread on the TMA route, every thread's share of 4-byte
  // copies on the other.
  auto load_tile = [&](int k) {
    float* st = ring + (k % kStages) * kStage;
    float* sx = st + kT * kChan;
    float* sB = sx + kT * kChan;
    float* sC = sB + kT * kMaxState;
    const uint32_t bar = bars + 8 * (k % kStages);
    const int t0 = k * kT;
    if constexpr (kTma) {
      if (tid == 0) {
        mbar_expect_tx(bar, kStageBytes);
        tma_load_3d(smem_u32(st), &tdt, c0, t0, b, bar);
        tma_load_3d(smem_u32(sx), &tx, c0, t0, b, bar);
        tma_load_3d(smem_u32(sB), &tb, 0, t0, b, bar);
        tma_load_3d(smem_u32(sC), &tc, 0, t0, b, bar);
      }
    } else {
      const float* xb = p.x + row;
      const float* dtb = p.dt + row;
      for (int i = tid; i < kT * kChan; i += kThreads) {
        const int tt = i / kChan, q = i % kChan;
        const bool ok = t0 + tt < S && q < nc;
        const long long g =
            ok ? static_cast<long long>(t0 + tt) * Di + c0 + q : 0;
        cp_async4(smem_u32(st + i), dtb + g, ok);
        cp_async4(smem_u32(sx + i), xb + g, ok);
      }
      const float* bb = p.bm + b * p.b_sb;
      const float* cb = p.cm + b * p.c_sb;
      for (int i = tid; i < kT * kMaxState; i += kThreads) {
        const int tt = i / kMaxState, n = i % kMaxState, t = t0 + tt;
        const bool ok = t < S && n < N;
        cp_async4(smem_u32(sB + i), bb + (ok ? t * p.b_ss + n : 0), ok);
        cp_async4(smem_u32(sC + i), cb + (ok ? t * p.c_ss + n : 0), ok);
      }
      cp_async_arrive(bar);
    }
  };

  // This warp's share of y of tile k: steps kFold part .. of the block's
  // channels (lane = channel), each the fold of the parts' partial sums.
  auto fold = [&](int k) {
    const float* pk = partial + (k & 1) * kPartial;
    const int t0 = k * kT, T = min(kT, S - t0), tt = kFold * part;
    if (lane < nc && tt < T) {
      float v[kParts][kFold];
#pragma unroll
      for (int w = 0; w < kParts; ++w)
        load_vec<kFold>(v[w], pk + (w * kChan + lane) * kRow + tt);
      part_tree(v);
#pragma unroll
      for (int e = 0; e < kFold; ++e)
        if (tt + e < T)
          yb[static_cast<long long>(t0 + tt + e) * Di + c] = v[0][e];
    }
    mbar_arrive(part_empty + 8 * (k & 1));
  };

  // A and h0 of the block's channels (nc x N floats from row c0 of each),
  // then the first tiles of the ring
  const long long a0 = static_cast<long long>(c0) * N;
  const long long hb0 = (static_cast<long long>(b) * Di + c0) * N;
  for (int i = tid; i < nc * N; i += kThreads) {
    cp_async4(smem_u32(sA + i), p.A + a0 + i, true);
    cp_async4(smem_u32(sh0 + i), p.h0 + hb0 + i, true);
  }
  cp_async_arrive(init_full);
  for (int k = 0; k < kStages && k < ntiles; ++k) load_tile(k);

  // the state and a2 = A log2(e) in registers for the whole sequence
  mbar_wait(init_full, 0);
  SCAN_STAMP(1);
  float h[NPL], a2[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = n0 + j;
    const bool ok = lane < nc && n < N;
    h[j] = ok ? sh0[lane * N + n] : 0.f;
#ifdef SCAN_IEEE_EXP
    a2[j] = ok ? sA[lane * N + n] : 0.f;
#else
    a2[j] = ok ? __fmul_rn(sA[lane * N + n], REPRO_LOG2E) : 0.f;
#endif
  }

  // G steps from step g of a stage: h, and this part's partial sums of y
  // (its states' C h in increasing n) into acc
  auto steps = [&](auto g_steps, const float* st, int g, float* acc) {
    constexpr int G = decltype(g_steps)::value;
    const float* sx = st + kT * kChan;
    const float* sB = sx + kT * kChan;
    const float* sC = sB + kT * kMaxState;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int tt = g + u;
      const float d = st[tt * kChan + lane];
      const float dx = __fmul_rn(d, sx[tt * kChan + lane]);
      // the same B and C for the whole warp: broadcast loads
      float rb[NPL], rc[NPL];
      load_vec<NPL>(rb, sB + tt * kMaxState + n0);
      load_vec<NPL>(rc, sC + tt * kMaxState + n0);
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
#ifdef SCAN_IEEE_EXP
        const float e = expf(__fmul_rn(d, a2[j]));
#else
        const float e = ex2(__fmul_rn(d, a2[j]));
#endif
        h[j] = __fmaf_rn(e, h[j], __fmul_rn(dx, rb[j]));
        acc[u] = j == 0 ? __fmul_rn(rc[0], h[0])
                        : __fmaf_rn(rc[j], h[j], acc[u]);
      }
    }
  };
  // G partial sums as one run of this part's partial-sum row
  auto store = [&](auto g_steps, float* prow, int g, const float* acc) {
    constexpr int G = decltype(g_steps)::value;
#pragma unroll
    for (int u = 0; u < G; u += 4)
      *reinterpret_cast<float4*>(prow + g + u) =
          make_float4(acc[u], acc[u + 1], acc[u + 2], acc[u + 3]);
  };
  using Tile = std::integral_constant<int, kT>;
  using Run = std::integral_constant<int, 8>;

  // No block-wide barrier: a warp waits only for the data it needs, and
  // runs at most one tile ahead of the slowest warp.
  for (int k = 0; k < ntiles; ++k) {
    if (k > 0) {
      // every part has stored tile k - 1, so its stage is free: refill it
      mbar_wait(part_full + 8 * ((k - 1) & 1), ((k - 1) >> 1) & 1);
      if (k - 1 + kStages < ntiles) load_tile(k - 1 + kStages);
    }
    SCAN_STAMP(2 + 5 * k);
    mbar_wait(bars + 8 * (k % kStages), (k / kStages) & 1);
    SCAN_STAMP(3 + 5 * k);
    const float* st = ring + (k % kStages) * kStage;
    float* prow = partial + (k & 1) * kPartial + (part * kChan + lane) * kRow;
    const int T = min(kT, S - k * kT);
    // the buffer of tile k held tile k - 2, folded by every warp in its
    // step k - 1
    if (k >= 2) mbar_wait(part_empty + 8 * (k & 1), ((k - 2) >> 1) & 1);
    SCAN_STAMP(4 + 5 * k);
    if (T == kT) {
      float acc[kT];
      steps(Tile{}, st, 0, acc);
      store(Tile{}, prow, 0, acc);
    } else {
      // the last tile: runs of 8 up to T (steps past S are zeros)
      for (int g = 0; g < T; g += 8) {
        float acc[8];
        steps(Run{}, st, g, acc);
        store(Run{}, prow, g, acc);
      }
    }
    mbar_arrive(part_full + 8 * (k & 1));
    SCAN_STAMP(5 + 5 * k);
    if (k > 0) fold(k - 1);
    SCAN_STAMP(6 + 5 * k);
  }
  if (ntiles > 0) {
    mbar_wait(part_full + 8 * ((ntiles - 1) & 1), ((ntiles - 1) >> 1) & 1);
    fold(ntiles - 1);
  }

#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = n0 + j;
    if (lane < nc && n < N)
      p.h_last[(static_cast<long long>(b) * Di + c) * N + n] = h[j];
  }
  SCAN_STAMP(kClockEvents - 1);
}

template <int NPL, bool kTma>
cudaError_t launch(const CUtensorMap (&maps)[4], const ScanArgs& a, int B,
                   cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  auto kernel = selective_scan_kernel<NPL, kTma>;
  if (allowed < kSmemBytes) {
    // all of the SM's unified memory as shared memory: two blocks a SM
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = allow_smem(kernel, kSmemBytes, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Di + kChan - 1) / kChan, B);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(maps[0], maps[1], maps[2],
                                             maps[3], a);
  return cudaGetLastError();
}

// states a part: ceil(N / kParts), rounded up to a power of two
template <int NPL = 1>
cudaError_t dispatch(bool tma, const CUtensorMap (&maps)[4],
                     const ScanArgs& a, int B, cudaStream_t s) {
  if constexpr (NPL < kMaxState / kParts) {
    if (a.N > NPL * kParts) return dispatch<2 * NPL>(tma, maps, a, B, s);
  }
  return tma ? launch<NPL, true>(maps, a, B, s)
              : launch<NPL, false>(maps, a, B, s);
}

}  // namespace

// The largest state size the kernel takes (the wrapper raises above it).
extern "C" int repro_selective_scan_max_state() { return kMaxState; }

// Dynamic shared memory of a launch (for the record).
extern "C" int repro_selective_scan_smem() {
  return static_cast<int>(kSmemBytes);
}

// x, dt, y: (B, S, Di) contiguous; bm, cm: (B, S, N) with unit stride
// along N and the given batch / time strides; A: (Di, N); h0, h_last:
// (B, Di, N) contiguous.  All float32.  `tma` fills the ring by TMA: it
// needs Di % 4 == 0, 16-byte aligned x, dt, B and C, and B and C strides
// of a multiple of 4 floats (refused otherwise).
extern "C" int repro_selective_scan(const void* x, const void* dt,
                                    const void* bm, const void* cm,
                                    const void* A, const void* h0, void* y,
                                    void* h_last, int B, int S, int Di,
                                    int N, long long b_sb, long long b_ss,
                                    long long c_sb, long long c_ss, int tma,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Di <= 0 || N <= 0) return cudaSuccess;
  if (N > kMaxState || B > 65535) return cudaErrorInvalidValue;
  if (tma && !(Di % 4 == 0 && aligned16(x) && aligned16(dt) &&
                aligned16(bm) && aligned16(cm) &&
                (B == 1 || (b_sb % 4 == 0 && c_sb % 4 == 0)) &&
                (S <= 1 || (b_ss % 4 == 0 && c_ss % 4 == 0))))
    return cudaErrorInvalidValue;
  const ScanArgs a{static_cast<const float*>(x),  static_cast<const float*>(dt),
                   static_cast<const float*>(bm), static_cast<const float*>(cm),
                   static_cast<const float*>(A),  static_cast<const float*>(h0),
                   static_cast<float*>(y),        static_cast<float*>(h_last),
                   S, Di, N, b_sb, b_ss, c_sb, c_ss};
  CUtensorMap maps[4] = {};
  if (tma && S > 0) {
    // a stride of a length-1 axis is never read; TMA still wants a
    // multiple of 16 bytes
    const long long rs = 4LL * Di, ps = rs * S;
    const long long bs1 = S > 1 ? 4 * b_ss : 64, cs1 = S > 1 ? 4 * c_ss : 64;
    const long long bs2 = B > 1 ? 4 * b_sb : bs1 * S;
    const long long cs2 = B > 1 ? 4 * c_sb : cs1 * S;
    cudaError_t err = f32_map(&maps[0], dt, Di, S, B, rs, ps, kChan, kT);
    if (err == cudaSuccess)
      err = f32_map(&maps[1], x, Di, S, B, rs, ps, kChan, kT);
    if (err == cudaSuccess)
      err = f32_map(&maps[2], bm, N, S, B, bs1, bs2, kMaxState, kT);
    if (err == cudaSuccess)
      err = f32_map(&maps[3], cm, N, S, B, cs1, cs2, kMaxState, kT);
    if (err != cudaSuccess) return err;
  }
  return dispatch(tma, maps, a, B, s);
}

#ifdef SCAN_CLOCK
// The timeline of the last launch: 4096 blocks x kParts warps x
// kClockEvents clock64 stamps, into `out`.
extern "C" int repro_selective_scan_clock(long long* out) {
  return cudaMemcpyFromSymbol(out, g_scan_clock, sizeof(g_scan_clock));
}
#endif
