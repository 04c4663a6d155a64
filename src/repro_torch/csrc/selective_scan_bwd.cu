// The backward of the Mamba-1 selective scan (csrc/selective_scan.cu),
// float32.  The forward, per batch row b, channel d and state n:
//   h_t = e_t * h_{t-1} + (dt_t * x_t) * B_t,   e_t = exp(dt_t * A)
//   y_t = sum_n C_t * h_t,                       h_last = h_{S-1}
// Given dy (B, S, Di) and dh_last (B, Di, N, or none), with r_{S-1} =
// dh_last, the reverse scan runs
//   g_t = r_t + C_t * dy_t      (the gradient in h_t)
//   r_{t-1} = e_t * g_t,        dh0 = r_{-1}
// and gives dC_t = sum_d dy_t h_t, dB_t = sum_d g_t dt_t x_t, u_t = sum_n
// g_t B_t, dx_t = u_t dt_t, q_t = g_t h_{t-1} e_t, ddt_t = sum_n q_t A +
// u_t x_t and dA = sum_{b,t} q_t dt_t.
//
// The TPU package has no backward for its Pallas scan (it trains through
// autodiff of models/mamba.py:_ssm_chunked); this kernel supplies the
// gradient of the port's forward kernel, which replaces
// src/repro/kernels/selective_scan/kernel.py:selective_scan_kernel.
//
// Bound on the H100: the bytes (x, dt and dy read, dx and ddt written:
// 0.2 ms at B 2, S 2048, Di 8192, 3.35 TB/s) ahead of the exponentials
// (S * Di * N a row, 0.13 ms on the SFUs).  The time axis is a recurrence
// walked twice (forward to save states, then backward), and every element
// takes ~45 instructions (three decays, the reverse step, its share of
// the sums), so the kernel is held by instruction issue and by waits
// between its warps, not by bytes.  The design, the forward kernel's
// layout throughout:
//   - a block owns 32 channels of one batch row (one a lane) and splits
//     their states over kParts = 4 warps (4 states a thread at N 16, 2 at
//     N <= 8, 1 at N <= 4): 512 blocks of 128 threads at B 2, Di 8192,
//     four a SM (at most 128 registers a thread), one wave;
//   - pass 1 runs the forward recurrence, stores the state before every
//     kT = 8-step tile (global scratch, state-major so that each store of
//     a warp is one 128-byte row; read back by the same thread) and sums
//     dC_t = sum_d dy_t h_t, which needs no reverse quantity;
//   - pass 2 walks the tiles backwards: it recomputes a tile's states into
//     registers from its saved start, with the forward kernel's arithmetic
//     (ex2 of dt * fl32(A log2 e), the same roundings and fused
//     multiply-adds: the forward's bits), then runs the reverse scan over
//     the tile, taking each decay again (registers hold the tile's states,
//     not its decays);
//   - no shuffles.  u and sum_n q A are summed over a thread's states,
//     then over the warps: each thread stores its part's dx and ddt
//     (u_p dt and u_p x + sum q A) for a run of kRun steps into one of
//     kBufs buffers, and each warp folds two steps of the run before it
//     (halfway through the next) from the 4 parts in the forward kernel's
//     fixed tree;
//   - dB and dC are summed over the warp's 32 channels by a transposed
//     fold: a lane stores its products of 32 / NPL steps as a column of 32
//     rows, then each lane adds one row (one state and step) in a fixed
//     tree and writes the block's sum, neighbouring lanes to neighbouring
//     steps (the partials are laid out along S); a second kernel adds the
//     blocks' sums in block order, and dA's batch rows in row order.  No
//     atomics: two launches give the same bits;
//   - dt, x, dy, B (and in pass 2 C) arrive through a ring of kStages
//     tiles (TMA boxes where the operands allow, 4-byte cp.async copies
//     elsewhere: the forward kernel's routes, same bits), pass 1's tiles
//     then pass 2's in reverse; on the TMA route the last warp to leave a
//     stage refills it.  mbarriers only, no block-wide barrier.
// Every global store of a warp is whole rows: a scattered store (lanes a
// row apart) occupies the load/store path per sector; with the saved
// states stored channel-major the kernel took 1.167 ms at B 2, S 2048,
// Di 8192 on an H100, state-major 1.034 (scripts/scan_variants.py --bwd).
// Steps past S and channels past Di read zeros (dt = x = dy = B = C = 0:
// the state and r pass through unchanged and add nothing); states past N
// have A = B = C = 0 and stay zero.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// The constants below can be overridden at compile time
// (-DSCAN_BWD_TILE=8 ...) by scripts/scan_variants.py --bwd, which builds
// and times such variants; the library is built with the defaults.
#ifndef SCAN_BWD_PARTS
#define SCAN_BWD_PARTS 4
#endif
#ifndef SCAN_BWD_TILE
#define SCAN_BWD_TILE 8
#endif
#ifndef SCAN_BWD_STAGES
#define SCAN_BWD_STAGES 3
#endif
#ifndef SCAN_BWD_BUFS
#define SCAN_BWD_BUFS 3
#endif
// SCAN_BWD_KEEP_E: keep a tile's decays in registers from the recompute
// (otherwise the reverse step takes each decay again, the same bits)

#ifdef SCAN_BWD_CLOCK
// The timeline build (scripts/scan_variants.py --bwd --clock): lane 0 of
// each warp adds the clock64 cycles of each phase (kClock* below) into
// shared memory, written out at the end for the first 4096 blocks.
constexpr int kClockEvents = 16;
__device__ long long g_bwd_clock[4096 * 8 * kClockEvents];
#define BWD_TIC(v) const long long v = clock64()
#define BWD_ADD(ev, v)                                \
  do {                                                \
    const long long d_ = clock64() - (v);             \
    if (threadIdx.x % 32 == 0) s_clk[(ev)] += d_;     \
  } while (0)
#else
#define BWD_TIC(v)
#define BWD_ADD(ev, v)
#endif
// phases of the timeline build
enum {
  kClockTotal, kClockPass1, kClockPass1Wait, kClockRefillWait, kClockPass2,
  kClockPass2Wait, kClockRecompute, kClockReverse, kClockPemptyWait,
  kClockFoldRows, kClockFoldRun, kClockPfullWait, kClockInit
};

constexpr int kChan = 32;           // channels a block, one a lane
constexpr int kParts = SCAN_BWD_PARTS;  // warps a channel's states are split over
constexpr int kThreads = kChan * kParts;
constexpr int kT = SCAN_BWD_TILE;   // steps a ring stage, and between saved states
constexpr int kRun = 8;             // steps of a run (the fold over parts)
constexpr int kStages = SCAN_BWD_STAGES;
constexpr int kBufs = SCAN_BWD_BUFS;  // runs of partial sums in flight
constexpr int kMaxState = 16;       // the forward kernel's limit
constexpr int kRowPad = 36;         // a fold row: 32 lanes, float4 reads
constexpr int kFoldSteps = kRun / kParts;  // steps of a run each warp folds
// blocks a SM: the register file's 64 K over 128 registers a thread
constexpr int kMinBlocks = 65536 / (128 * kThreads);
#ifdef SCAN_BWD_KEEP_E
constexpr bool kKeepE = true;
#else
constexpr bool kKeepE = false;
#endif
static_assert(kParts == 2 || kParts == 4 || kParts == 8,
              "2, 4 or 8 parts of at most 16 states");
static_assert(kRun % kParts == 0, "whole steps of a run each warp");
static_assert(kT % kRun == 0, "whole runs a tile");

// Shared memory, in floats: the ring (dt, x, dy: kT x kChan each; B, C:
// kT x kMaxState each; TMA boxes, 128-byte aligned); kBufs buffers of a
// run's dx and ddt partial sums ([2][kParts][kRun][kChan]); each warp's
// 32 fold rows; the mbarriers.  55,392 B at the defaults: four blocks a
// SM.
constexpr int kStage = 3 * kT * kChan + 2 * kT * kMaxState;
constexpr int kPart = 2 * kParts * kRun * kChan;
constexpr int kRows = kParts * 32 * kRowPad;
constexpr int kBars = 2 * kStages + 2 * kBufs;
constexpr size_t kSmemBytes =
    sizeof(float) * (kStages * kStage + kBufs * kPart + kRows) + 8 * kBars;
constexpr uint32_t kStageBytes = sizeof(float) * kStage;
// pass 1 reads dt, x, dy and B
constexpr uint32_t kFwdBytes = sizeof(float) * (3 * kT * kChan + kT * kMaxState);
static_assert(kStageBytes % 128 == 0, "TMA boxes 128-byte aligned");

struct BwdArgs {
  const float* x;
  const float* dt;
  const float* bm;
  const float* cm;
  const float* A;
  const float* h0;
  const float* dy;
  const float* dh_last;  // may be null (zero)
  float* dx;
  float* ddt;
  float* dh0;
  float* hsave;  // (B, nt, N, Di): the state before each tile, state-major
                 // so that a warp's 32 channels are one 128-byte row
  float* pdb;    // (ncb, B, N, S): each block's dB over its channels
  float* pdc;    // (ncb, B, N, S): likewise dC
  float* pda;    // (B, Di, N): dA of each batch row
  int S, Di, N;
  long long b_sb, b_ss, c_sb, c_ss;
};

// a step's operands from a ring stage
template <int NPL>
struct StepIn {
  float d, x, dy, b[NPL], c[NPL];
};

// v[0] = the fixed tree over v[0 .. M): the upper half added to the lower
// half until one is left.  A recursion on M, so that every index is a
// constant and v stays in registers (a loop halving m is not unrolled,
// and kept v in local memory).
template <int M>
__device__ __forceinline__ void half_tree(float* v) {
  if constexpr (M > 1) {
#pragma unroll
    for (int j = 0; j < M / 2; ++j) v[j] = v[j] + v[j + M / 2];
    half_tree<M / 2>(v);
  }
}

template <int NPL, bool kTma>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    selective_scan_bwd_kernel(const __grid_constant__ CUtensorMap tdt,
                              const __grid_constant__ CUtensorMap tx,
                              const __grid_constant__ CUtensorMap tdy,
                              const __grid_constant__ CUtensorMap tb,
                              const __grid_constant__ CUtensorMap tc,
                              const BwdArgs p, const int B) {
  // steps whose products of one gradient (dC in pass 1, dB in pass 2) a
  // warp folds at once: 32 rows, or a tile's
  constexpr int G = 32 / NPL < kT ? 32 / NPL : kT;
  static_assert(kT % G == 0, "whole fold groups a tile");
  extern __shared__ __align__(128) float smem[];
#ifdef SCAN_BWD_CLOCK
  __shared__ long long s_clk_all[kParts][kClockEvents];
  long long* s_clk = s_clk_all[threadIdx.x / 32];
  if (threadIdx.x % 32 < kClockEvents) s_clk[threadIdx.x % 32] = 0;
#endif
  BWD_TIC(t_start);
  float* ring = smem;
  float* part = ring + kStages * kStage;
  float* rows = part + kBufs * kPart;
  // mbarriers: full[kStages] (the TMA bytes, or every thread's copies),
  // empty[kStages] (4-byte route: every thread, once it has read the
  // stage; the TMA route counts warps in s_rel instead), pfull[kBufs]
  // (every thread, once its part's partial sums of a run are stored),
  // pempty[kBufs] (every thread, once its warp has folded its step of them)
  const uint32_t bars = smem_u32(rows + kRows);
  const uint32_t full = bars, empty = bars + 8 * kStages;
  const uint32_t pfull = bars + 16 * kStages;
  const uint32_t pempty = pfull + 8 * kBufs;

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int n0 = w * NPL;               // this warp's states n0 .. n0 + NPL
  const int b = blockIdx.y, cb = blockIdx.x;
  const int c0 = cb * kChan, c = c0 + lane;
  const int S = p.S, Di = p.Di, N = p.N;
  const int nc = min(kChan, Di - c0);
  const int nt = (S + kT - 1) / kT;     // tiles; ring items 0 .. 2 nt
  const long long row = static_cast<long long>(b) * S * Di;

  __shared__ int s_rel[kStages];  // TMA route: warps done with a stage
  if (tid < kStages) s_rel[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kTma ? 1 : kThreads);
      mbar_init(empty + 8 * s, kThreads);
    }
    for (int i = 0; i < 2 * kBufs; ++i) mbar_init(pfull + 8 * i, kThreads);
    mbar_fence_init();
  }
  __syncthreads();

  // Ring item i: tile i of pass 1 (dt, x, dy, B) for i < nt, then tile
  // 2 nt - 1 - i of pass 2 (dt, x, dy, B, C), into stage i % kStages;
  // zeros past S, Di and N.
  auto load_item = [&](int i) {
    const bool rev = i >= nt;
    const int t0 = (rev ? 2 * nt - 1 - i : i) * kT;
    float* st = ring + (i % kStages) * kStage;
    float* sx = st + kT * kChan;
    float* sdy = sx + kT * kChan;
    float* sB = sdy + kT * kChan;
    float* sC = sB + kT * kMaxState;
    const uint32_t bar = full + 8 * (i % kStages);
    if constexpr (kTma) {  // one thread
      mbar_expect_tx(bar, rev ? kStageBytes : kFwdBytes);
      tma_load_3d(smem_u32(st), &tdt, c0, t0, b, bar);
      tma_load_3d(smem_u32(sx), &tx, c0, t0, b, bar);
      tma_load_3d(smem_u32(sdy), &tdy, c0, t0, b, bar);
      tma_load_3d(smem_u32(sB), &tb, 0, t0, b, bar);
      if (rev) tma_load_3d(smem_u32(sC), &tc, 0, t0, b, bar);
    } else {
      for (int k = tid; k < kT * kChan; k += kThreads) {
        const int tt = k / kChan, q = k % kChan;
        const bool ok = t0 + tt < S && q < nc;
        const long long g =
            row + (ok ? static_cast<long long>(t0 + tt) * Di + c0 + q : 0);
        cp_async4(smem_u32(st + k), p.dt + g, ok);
        cp_async4(smem_u32(sx + k), p.x + g, ok);
        cp_async4(smem_u32(sdy + k), p.dy + g, ok);
      }
      const float* bb = p.bm + b * p.b_sb;
      const float* cc = p.cm + b * p.c_sb;
      for (int k = tid; k < kT * kMaxState; k += kThreads) {
        const int tt = k / kMaxState, n = k % kMaxState, t = t0 + tt;
        const bool ok = t < S && n < N;
        cp_async4(smem_u32(sB + k), bb + (ok ? t * p.b_ss + n : 0), ok);
        if (rev)
          cp_async4(smem_u32(sC + k), cc + (ok ? t * p.c_ss + n : 0), ok);
      }
      cp_async_arrive(bar);
    }
  };
  // Item i + kStages goes into the stage of item i once every thread has
  // read item i.  TMA route: each warp counts itself out of the stage
  // (`release`) and the last one issues the boxes at once, so no warp
  // waits for the others to refill.  4-byte route: at item i + 1 every
  // thread waits for the stage to empty, then issues its own copies.
  auto refill = [&](int i) {
    const int k = i - 1 + kStages;
    if (kTma || i < 1 || k >= 2 * nt) return;
    BWD_TIC(t0);
    mbar_wait(empty + 8 * ((i - 1) % kStages), ((i - 1) / kStages) & 1);
    BWD_ADD(kClockRefillWait, t0);
    load_item(k);
  };
  auto acquire = [&](int i) {
    BWD_TIC(t0);
    mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
    BWD_ADD(i < nt ? kClockPass1Wait : kClockPass2Wait, t0);
    return static_cast<const float*>(ring + (i % kStages) * kStage);
  };
  auto release = [&](int i) {
    if constexpr (kTma) {
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();  // this warp's reads of the stage, before
        if (atomicAdd(&s_rel[i % kStages], 1) == kParts - 1) {
          __threadfence_block();  // every warp's count, before the boxes
          s_rel[i % kStages] = 0;
          if (i + kStages < 2 * nt) load_item(i + kStages);
        }
      }
      __syncwarp();
    } else {
      mbar_arrive(empty + 8 * (i % kStages));
    }
  };

  if (!kTma || tid == 0)
    for (int i = 0; i < kStages && i < 2 * nt; ++i) load_item(i);

  // this thread's states
  bool live[NPL];
  float a[NPL], a2[NPL], h[NPL], r[NPL], da[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = n0 + j;
    live[j] = lane < nc && n < N;
    const long long sn = (static_cast<long long>(b) * Di + c) * N + n;
    a[j] = live[j] ? p.A[static_cast<long long>(c) * N + n] : 0.f;
    a2[j] = __fmul_rn(a[j], REPRO_LOG2E);
    h[j] = live[j] ? p.h0[sn] : 0.f;
    r[j] = live[j] && p.dh_last != nullptr ? p.dh_last[sn] : 0.f;
    da[j] = 0.f;
  }
  // this thread's saved states: state n0 + j of tile k at hsv + k *
  // hstride + j * Di (a warp stores and loads whole rows of channels)
  float* hsv = p.hsave + (static_cast<long long>(b) * nt * N + n0) * Di + c;
  const long long hstride = static_cast<long long>(N) * Di;
  auto saved = [&](int k, int j) { return hsv + k * hstride + j * Di; };

  // The warp's products of one gradient for steps t .. t + G, one row a
  // (state, step), state-major: lane L adds row L (state n0 + L / G, step
  // t + L % G) over the 32 channels in a fixed tree and writes the
  // block's sum to dst[t]: G neighbouring lanes write G neighbouring steps.
  float* wrows = rows + w * 32 * kRowPad;
  const int fold_step = lane % G;
  const bool fold_live = lane < NPL * G && n0 + lane / G < N;
  const long long fold_off =
      ((static_cast<long long>(cb) * B + b) * N + n0 + lane / G) * S +
      fold_step;
  float* fdb = p.pdb + fold_off;
  float* fdc = p.pdc + fold_off;
  auto fold_rows = [&](int t, float* dst) {
    BWD_TIC(t0);
    __syncwarp();
    float v[32];
#pragma unroll
    for (int q = 0; q < 32; q += 4) {
      const float4 f =
          *reinterpret_cast<const float4*>(wrows + lane * kRowPad + q);
      v[q] = f.x;
      v[q + 1] = f.y;
      v[q + 2] = f.z;
      v[q + 3] = f.w;
    }
    half_tree<32>(v);
    if (fold_live && t + fold_step < S) dst[t] = v[0];
    __syncwarp();
    BWD_ADD(kClockFoldRows, t0);
  };

  // Pass 1: the forward recurrence (the forward kernel's arithmetic) over
  // the ring's tiles; it stores the state before every tile and folds
  // dC's products (dy_t h_t) of each tile.
  BWD_ADD(kClockInit, t_start);
  BWD_TIC(t_pass1);
  for (int k = 0; k < nt; ++k) {
    refill(k);
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      if (live[j]) *saved(k, j) = h[j];
    const float* st = acquire(k);
#pragma unroll
    for (int u = 0; u < kT; ++u) {
      const float d = st[u * kChan + lane];
      const float dxv = __fmul_rn(d, st[kT * kChan + u * kChan + lane]);
      const float dyv = st[2 * kT * kChan + u * kChan + lane];
      float bv[NPL];
      load_vec<NPL>(bv, st + 3 * kT * kChan + u * kMaxState + n0);
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const float e = ex2(__fmul_rn(d, a2[j]));
        h[j] = __fmaf_rn(e, h[j], __fmul_rn(dxv, bv[j]));
        wrows[(j * G + u % G) * kRowPad + lane] = __fmul_rn(dyv, h[j]);
      }
      if (u % G == G - 1) fold_rows(k * kT + u - (G - 1), fdc);
    }
    release(k);
  }
  BWD_ADD(kClockPass1, t_pass1);

  float* dxc = p.dx + row + c;
  float* ddtc = p.ddt + row + c;
  // Run ri of pass 2 (kRun steps, the runs of the tiles from the top):
  // this warp folds its kFoldSteps steps of it from the parts' partial
  // sums and writes dx and ddt of the block's channels.
  auto fold_run = [&](int ri) {
    BWD_TIC(t_fold);
    mbar_wait(pfull + 8 * (ri % kBufs), (ri / kBufs) & 1);
    BWD_ADD(kClockPfullWait, t_fold);
    const float* pk = part + (ri % kBufs) * kPart;
    const int k = nt - 1 - ri / (kT / kRun);
    const int t0 = k * kT + (kT / kRun - 1 - ri % (kT / kRun)) * kRun;
#pragma unroll
    for (int f = 0; f < kFoldSteps; ++f) {
      const int ur = w * kFoldSteps + f;
      float vx[kParts], vt[kParts];
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        vx[q] = pk[(q * kRun + ur) * kChan + lane];
        vt[q] = pk[((kParts + q) * kRun + ur) * kChan + lane];
      }
      half_tree<kParts>(vx);
      half_tree<kParts>(vt);
      const int t = t0 + ur;
      if (t < S && lane < nc) {
        const long long g = static_cast<long long>(t) * Di;
        dxc[g] = vx[0];
        ddtc[g] = vt[0];
      }
    }
    mbar_arrive(pempty + 8 * (ri % kBufs));
    BWD_ADD(kClockFoldRun, t_fold);
  };

  // step u of a stage: dt, x, dy and this part's B and C
  auto load_in = [&](const float* st, int u, StepIn<NPL>& in) {
    in.d = st[u * kChan + lane];
    in.x = st[kT * kChan + u * kChan + lane];
    in.dy = st[2 * kT * kChan + u * kChan + lane];
    load_vec<NPL>(in.b, st + 3 * kT * kChan + u * kMaxState + n0);
    load_vec<NPL>(in.c, st + 3 * kT * kChan + kT * kMaxState +
                            u * kMaxState + n0);
  };

  // pass 2: the tiles in reverse, each recomputed from its saved state
  // (the forward kernel's arithmetic, as in pass 1), then scanned back
  float hin[NPL], hnext[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j)
    hin[j] = nt > 0 && live[j] ? *saved(nt - 1, j) : 0.f;
  int ri = 0;  // runs stored
  BWD_TIC(t_pass2);
  for (int k = nt - 1; k >= 0; --k) {
    const int i = 2 * nt - 1 - k;
    refill(i);
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      hnext[j] = k > 0 && live[j] ? *saved(k - 1, j) : 0.f;
    const float* st = acquire(i);
    BWD_TIC(t_rec);
    float hs[kT][NPL], es[kKeepE ? kT : 1][NPL];
    {
      float hh[NPL];
#pragma unroll
      for (int j = 0; j < NPL; ++j) hh[j] = hin[j];
#pragma unroll
      for (int u = 0; u < kT; ++u) {
        const float d = st[u * kChan + lane];
        const float dxv = __fmul_rn(d, st[kT * kChan + u * kChan + lane]);
        float bv[NPL];
        load_vec<NPL>(bv, st + 3 * kT * kChan + u * kMaxState + n0);
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const float e = ex2(__fmul_rn(d, a2[j]));
          hh[j] = __fmaf_rn(e, hh[j], __fmul_rn(dxv, bv[j]));
          hs[u][j] = hh[j];
          es[kKeepE ? u : 0][j] = e;
        }
      }
    }
    BWD_ADD(kClockRecompute, t_rec);
    BWD_TIC(t_rev);
    StepIn<NPL> cur;
    load_in(st, kT - 1, cur);
#pragma unroll
    for (int u = kT - 1; u >= 0; --u) {
      // the next step's operands, loaded ahead of this step's stores
      StepIn<NPL> nxt;
      if (u > 0) load_in(st, u - 1, nxt);
      const int ur = u % kRun;
      if (ur == kRun - 1 && ri >= kBufs) {
        BWD_TIC(t0);
        mbar_wait(pempty + 8 * (ri % kBufs), (ri / kBufs - 1) & 1);
        BWD_ADD(kClockPemptyWait, t0);
      }
      const float dxv = __fmul_rn(cur.d, cur.x);
      float ub = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const float e = kKeepE ? es[kKeepE ? u : 0][j]
                               : ex2(__fmul_rn(cur.d, a2[j]));
        const float g = __fmaf_rn(cur.c[j], cur.dy, r[j]);
        const float hp = u > 0 ? hs[u - 1][j] : hin[j];
        r[j] = __fmul_rn(e, g);
        // q = g h_{t-1} e = h_{t-1} r_{t-1}
        const float q = __fmul_rn(hp, r[j]);
        da[j] = __fmaf_rn(q, cur.d, da[j]);
        ub = j == 0 ? __fmul_rn(g, cur.b[0]) : __fmaf_rn(g, cur.b[j], ub);
        s2 = j == 0 ? __fmul_rn(q, a[0]) : __fmaf_rn(q, a[j], s2);
        wrows[(j * G + u % G) * kRowPad + lane] = __fmul_rn(g, dxv);
      }
      float* pk = part + (ri % kBufs) * kPart;
      pk[(w * kRun + ur) * kChan + lane] = __fmul_rn(ub, cur.d);
      pk[((kParts + w) * kRun + ur) * kChan + lane] = __fmaf_rn(ub, cur.x, s2);
      if (u % G == 0) fold_rows(k * kT + u, fdb);
      // the run before, halfway through this one: the other warps have
      // half a run more to store it (the 4-byte route's warps drift)
      if (ur == kRun / 2 && ri > 0) fold_run(ri - 1);
      if (ur == 0) {
        mbar_arrive(pfull + 8 * (ri % kBufs));
        ++ri;
      }
      if (u > 0) cur = nxt;
    }
    release(i);
    BWD_ADD(kClockReverse, t_rev);
#pragma unroll
    for (int j = 0; j < NPL; ++j) hin[j] = hnext[j];
  }
  if (ri > 0) fold_run(ri - 1);
  BWD_ADD(kClockPass2, t_pass2);

#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    if (live[j]) {
      const long long sn = (static_cast<long long>(b) * Di + c) * N + n0 + j;
      p.dh0[sn] = r[j];
      p.pda[sn] = da[j];
    }
  }
  BWD_ADD(kClockTotal, t_start);
#ifdef SCAN_BWD_CLOCK
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (blk < 4096 && threadIdx.x % 32 < kClockEvents)
    g_bwd_clock[(blk * 8 + threadIdx.x / 32) * kClockEvents +
                threadIdx.x % 32] = s_clk[threadIdx.x % 32];
#endif
}

// dB and dC: the blocks' sums in block order, read along S and written
// as (B, S, N); dA: the batch rows' sums in row order (blockIdx.y 0, 1, 2)
__global__ void selective_scan_bwd_reduce(const float* pdb, const float* pdc,
                                          const float* pda, float* db,
                                          float* dc, float* da, int ncb,
                                          long long nbsn, int B, int S,
                                          int N, long long dn) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (blockIdx.y < 2) {
    if (i >= nbsn) return;
    const float* src = blockIdx.y == 0 ? pdb : pdc;
    float s = src[i];
#pragma unroll 8
    for (int k = 1; k < ncb; ++k) s += src[k * nbsn + i];
    const long long t = i % S, bn = i / S;   // bn = b * N + n
    (blockIdx.y == 0 ? db : dc)[(bn / N * S + t) * N + bn % N] = s;
  } else {
    if (i >= dn) return;
    float s = pda[i];
    for (int k = 1; k < B; ++k) s += pda[k * dn + i];
    da[i] = s;
  }
}

template <int NPL, bool kTma>
cudaError_t launch(const CUtensorMap (&maps)[5], const BwdArgs& a, int B,
                   cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  auto kernel = selective_scan_bwd_kernel<NPL, kTma>;
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
                                             maps[3], maps[4], a, B);
  return cudaGetLastError();
}

// states a part: ceil(N / kParts), rounded up to a power of two
template <int NPL = 1>
cudaError_t dispatch(bool tma, const CUtensorMap (&maps)[5],
                     const BwdArgs& a, int B, cudaStream_t s) {
  if constexpr (NPL < kMaxState / kParts) {
    if (a.N > NPL * kParts) return dispatch<2 * NPL>(tma, maps, a, B, s);
  }
  return tma ? launch<NPL, true>(maps, a, B, s)
             : launch<NPL, false>(maps, a, B, s);
}

long long tiles(int S) { return (S + kT - 1) / kT; }
long long blocks(int Di) { return (Di + kChan - 1) / kChan; }

}  // namespace

// Dynamic shared memory of a launch (for the record).
extern "C" int repro_selective_scan_bwd_smem(int N) {
  (void)N;
  return static_cast<int>(kSmemBytes);
}

// Scratch floats a launch needs (the wrapper allocates them): the saved
// tile states, the blocks' dB and dC, the rows' dA.
extern "C" long long repro_selective_scan_bwd_scratch(int B, int S, int Di,
                                                      int N) {
  const long long bdn = static_cast<long long>(B) * Di * N;
  const long long bsn = static_cast<long long>(B) * S * N;
  return bdn * tiles(S) + 2 * blocks(Di) * bsn + bdn;
}

// The forward's operands (x, dt contiguous (B, S, Di); bm, cm (B, S, N)
// with unit stride along N and the given batch / time strides; A (Di, N);
// h0 (B, Di, N)), dy (B, S, Di) and dh_last (B, Di, N, or null for zero),
// all float32.  Writes dx, ddt (B, S, Di), dbm, dcm (B, S, N) contiguous,
// dA (Di, N) and dh0 (B, Di, N); `scratch` holds
// repro_selective_scan_bwd_scratch(B, S, Di, N) floats.  `tma` fills the
// ring by TMA: it needs Di % 4 == 0, 16-byte aligned x, dt, dy, B and C,
// and B and C strides of a multiple of 4 floats (refused otherwise).
extern "C" int repro_selective_scan_bwd(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* A, const void* h0, const void* dy, const void* dh_last,
    void* dx, void* ddt, void* dbm, void* dcm, void* dA, void* dh0,
    void* scratch, int B, int S, int Di, int N, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, int tma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Di <= 0 || N <= 0) return cudaSuccess;
  if (N > kMaxState || B > 65535 || S < 0) return cudaErrorInvalidValue;
  if (tma && !(Di % 4 == 0 && aligned16(x) && aligned16(dt) &&
                aligned16(dy) && aligned16(bm) && aligned16(cm) &&
                (B == 1 || (b_sb % 4 == 0 && c_sb % 4 == 0)) &&
                (S <= 1 || (b_ss % 4 == 0 && c_ss % 4 == 0))))
    return cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  const long long bdn = static_cast<long long>(B) * Di * N;
  const long long bsn = static_cast<long long>(B) * S * N;
  const long long ncb = blocks(Di);
  float* hsave = sc;
  float* pdb = hsave + bdn * tiles(S);
  float* pdc = pdb + ncb * bsn;
  float* pda = pdc + ncb * bsn;
  const BwdArgs a{static_cast<const float*>(x),  static_cast<const float*>(dt),
                  static_cast<const float*>(bm), static_cast<const float*>(cm),
                  static_cast<const float*>(A),  static_cast<const float*>(h0),
                  static_cast<const float*>(dy),
                  static_cast<const float*>(dh_last),
                  static_cast<float*>(dx),       static_cast<float*>(ddt),
                  static_cast<float*>(dh0),      hsave, pdb, pdc, pda,
                  S, Di, N, b_sb, b_ss, c_sb, c_ss};
  CUtensorMap maps[5] = {};
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
      err = f32_map(&maps[2], dy, Di, S, B, rs, ps, kChan, kT);
    if (err == cudaSuccess)
      err = f32_map(&maps[3], bm, N, S, B, bs1, bs2, kMaxState, kT);
    if (err == cudaSuccess)
      err = f32_map(&maps[4], cm, N, S, B, cs1, cs2, kMaxState, kT);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = dispatch(tma != 0, maps, a, B, s);
  if (err != cudaSuccess) return err;
  const long long dn = static_cast<long long>(Di) * N;
  const long long most = bsn > dn ? bsn : dn;
  const dim3 grid(static_cast<unsigned>((most + 255) / 256), 3);
  selective_scan_bwd_reduce<<<grid, 256, 0, s>>>(
      pdb, pdc, pda, static_cast<float*>(dbm), static_cast<float*>(dcm),
      static_cast<float*>(dA), static_cast<int>(ncb), bsn, B, S, N, dn);
  return cudaGetLastError();
}

#ifdef SCAN_BWD_CLOCK
// The phase cycles of the last launch: 4096 blocks x 8 warps x
// kClockEvents, into `out`.
extern "C" int repro_selective_scan_bwd_clock(long long* out) {
  return cudaMemcpyFromSymbol(out, g_bwd_clock, sizeof(g_bwd_clock));
}
#endif
