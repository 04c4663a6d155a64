// Flash attention forward (prefill): online-softmax attention with causal
// and sliding-window masks, a tanh logit softcap, a custom scale and GQA.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_bhsd.
//
// Layout: q, o (B, S, H, hd); k, v (B, Sk, K, hd), read with their strides
// in place (the TPU wrapper transposed to (B, H, S, hd) first).  The kv
// head of q head h is h / (H / K).
//
// Bound on the H100: bytes at the serve shape (S = 288: q, k, v, o read
// or written once, 5.9 MB against 0.68 GFLOP of unmasked q.k pairs at
// 32 heads of 128), operations from S of about 750 up (the train shape,
// B 2, S 2048: 68.7 GFLOP, 0.0695 ms at 989 TFLOP/s).  The softmax state
// (m, l) and the output accumulator stay in registers in fp32; kv tiles
// stream through shared memory only up to the causal bound of the q tile
// (and from the window's lower bound).
//
// bfloat16 (the serving and train paths) runs on Hopper's asynchronous
// units: TMA loads into a two-stage shared ring, wgmma products,
// warp-specialised blocks (see flash_fwd_bf16_wgmma below).  head_dim
// 16-128 take 128-row kv tiles; 256 (gemma-7b, recurrentgemma-2b) takes
// 64-row kv tiles on one consumer warpgroup, its O = P V split in two
// products of 128 columns (the accumulator is 128 registers a thread);
// 80 (hubert-xlarge) is read as a 128-wide tile whose last 48 columns
// TMA fills with zeros (no 80-element row fits a swizzle row), which
// changes no score and no output column, and only its 80 columns are
// stored.  P is rounded
// to bf16 for the second product, as the plain version rounds it.  The
// scale multiplies the fp32 scores (the TPU kernel scales q in fp32
// before its dot; the two differ by fp32 rounding).  float32 runs on the
// CUDA cores (4 threads per q row, operands in shared memory), for the
// small float32 configurations.
//
// Ragged tails are masked, not asserted: S and Sk need not be multiples of
// the tile.  Masked scores get p = 0, so a tile that is fully masked for
// a row leaves that row's state bit-for-bit unchanged — a row's result
// does not depend on S or on the other rows of its tile.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;          // float32: 4 threads per q row
constexpr int CPT = BK / 4;      // float32: score columns per thread

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_f32(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int S, int Sk, int H, int K,
                  float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // BQ x (HD + 1)
  float* Ks = Qs + BQ * (HD + 1);         // BK x (HD + 1)
  float* Vs = Ks + BK * (HD + 1);         // BK x HD
  float* Ps = Vs + BK * HD;               // BQ x (BK + 1)

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int row = tid >> 2, sub = tid & 3;
  const int q_lo = qt * BQ;
  const int qpos = q_lo + row;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(K) * HD;
  const long long q_base = static_cast<long long>(b) * S * q_row +
                           static_cast<long long>(h) * HD;
  const long long kv_base = static_cast<long long>(b) * Sk * kv_row +
                            static_cast<long long>(kh) * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, s = q_lo + r;
    Qs[r * (HD + 1) + d] =
        s < S ? to_f32(q[q_base + s * q_row + d]) * scale : 0.f;
  }

  float m = REPRO_NEG_INF, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  const int nk = (Sk + BK - 1) / BK;
  int hi = nk;
  if (causal) hi = min(nk, (min(q_lo + BQ, S) - 1) / BK + 1);
  const int lo = window > 0 ? max(0, q_lo - window + 1) / BK : 0;

  for (int j = lo; j < hi; ++j) {
    const int k_lo = j * BK;
    __syncthreads();            // Qs written / previous tile consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, t = k_lo + r;
      float kx = 0.f, vx = 0.f;
      if (t < Sk) {
        const long long off = kv_base + t * kv_row + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[r * (HD + 1) + d] = kx;
      Vs[r * HD + d] = vx;
    }
    __syncthreads();

    float sc[CPT];
    unsigned ok_bits = 0u;
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int c = sub + 4 * jj;
      const float* qr = Qs + row * (HD + 1);
      const float* kr = Ks + c * (HD + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += qr[d] * kr[d];
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int kpos = k_lo + c;
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      s = ok ? s : REPRO_NEG_INF;
      ok_bits |= (ok ? 1u : 0u) << jj;
      sc[jj] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const float p = (ok_bits >> jj) & 1u ? expf(sc[jj] - m_new) : 0.f;
      Ps[row * (BK + 1) + sub + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();               // a row's 4 threads share one warp

    const float* pr = Ps + row * (BK + 1);
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      const int d = sub + 4 * i;
      float pv = 0.f;
#pragma unroll 16
      for (int c = 0; c < BK; ++c) pv += pr[c] * Vs[c * HD + d];
      acc[i] = acc[i] * corr + pv;
    }
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + q_base + qpos * q_row;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i)
      orow[sub + 4 * i] = from_f32<T>(acc[i] * inv);
    if (lse != nullptr && sub == 0)
      lse[(static_cast<long long>(b) * H + h) * S + qpos] = m + logf(l);
  }
}

// ---- bfloat16: wgmma fed by a TMA ring ----------------------------------------
//
// One block a (q tile of BQ = 64 NWG rows, q head, batch): NWG consumer
// warpgroups and one producer warp (the last), one thread of which keeps
// TMA loads of the K and V tiles in flight, FWD_STAGES deep, each stage
// with a K-full, a V-full and an empty barrier.  Each consumer warpgroup
// owns 64 q rows:
// S = Q K^T (m64nBKk16, Q and K from shared memory), the online softmax
// in registers, O += P V (P as the register A operand, V through the
// transposed-B descriptor).  K and V tiles are BK rows (fwd_bk: a
// function of HD alone) whatever S, B or BQ, visited in ascending order,
// so a row's result does not depend on the sequence length or the tile
// it sits in (serving's token-identical retries).  HD is the tile's
// width, RD <= HD the head's (RD < HD: the zero-filled columns above).  Masks: only a tile that crosses the
// diagonal, the window's lower edge or the end of Sk tests its elements;
// a tile fully masked for a warpgroup is skipped (it would leave the
// row's state bit-for-bit as it is).
//
// Schedule: the block index runs over heads first, then batches, then q
// tiles from the last (heaviest under causal: the most kv tiles) to the
// first, so the long blocks start in the first wave and the short ones
// fill the tail.  A persistent grid walking the same list would also
// overlap one tile's epilogue with the next tile's loads; reversing the
// launch order gets the balance without a scheduler.
constexpr int FWD_STAGES = 2;

// kv rows a tile: 128, or 64 at head_dim 256 (64-row tiles of 32 KB keep
// the Q tile and two K and V stages in 161 KB of shared memory, and the
// 64 x 64 scores in 32 registers beside the 128 of the accumulator)
__host__ __device__ constexpr int fwd_bk(int hd) { return hd > 128 ? 64 : 128; }

template <int HD, int NWG>
constexpr size_t smem_fwd() {
  return 1024 + Tile<HD>::bytes(64 * NWG) +
         2 * FWD_STAGES * Tile<HD>::bytes(fwd_bk(HD)) +
         8 * (1 + 3 * FWD_STAGES);
}

// Registers: ptxas (CUDA 12.9) holds a block with two consumer
// warpgroups to 168 registers a thread, as for 384 threads, and gives a
// block with one up to 255; the forward's consumers fit 168.  A producer
// warpgroup handing its registers to the consumers with setmaxnreg (24 /
// 240) was tried: ptxas still held the consumer code to 168, and the
// backward then spilled around in-flight wgmma products.  So the producer
// is one warp and nothing is rebalanced.
__host__ __device__ constexpr int fwd_threads(int nwg) {
  return 128 * nwg + 32;
}

template <int HD, int NWG, int RD>
__global__ void __launch_bounds__(fwd_threads(NWG), 1)
    flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int B, int S, int Sk,
                         int H, int K, float scale, int causal, int window,
                         float softcap) {
  using T = Tile<HD>;
  constexpr int BQ = 64 * NWG, BK = fwd_bk(HD), ST = FWD_STAGES;
  constexpr uint32_t QB = T::bytes(BQ), KB = T::bytes(BK);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem), sK = sQ + QB, sV = sK + ST * KB;
  const uint32_t bars = sV + ST * KB;       // q_full, k_full[ST], v_full[ST],
  const uint32_t q_full = bars;             // empty[ST]
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };

  const int nq = (S + BQ - 1) / BQ;
  int id = blockIdx.x;
  const int h = id % H;
  id /= H;
  const int b = id % B;
  const int q_lo = (nq - 1 - id / B) * BQ;   // heaviest q tile first
  const int kh = h / (H / K);
  const int nk = (Sk + BK - 1) / BK;
  const int hi = causal ? min(nk, (min(q_lo + BQ, S) - 1) / BK + 1) : nk;
  const int lo = window > 0 ? min(hi, max(0, q_lo - window + 1) / BK) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * NWG);          // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;          // NWG: the producer warp
  if (wg == NWG) {
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(q_full, QB);
#pragma unroll
      for (int a = 0; a < T::NA; ++a)
        tma_load_4d(sQ + a * BQ * T::RB, &tq, a * T::SW, h, q_lo, b, q_full);
      int i = 0;
      for (int j = lo; j < hi; ++j, ++i) {
        const int s = i % ST;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        mbar_expect_tx(k_full(s), KB);
#pragma unroll
        for (int a = 0; a < T::NA; ++a)
          tma_load_4d(sK + s * KB + a * BK * T::RB, &tk, a * T::SW, kh,
                      j * BK, b, k_full(s));
        mbar_expect_tx(v_full(s), KB);
#pragma unroll
        for (int a = 0; a < T::NA; ++a)
          tma_load_4d(sV + s * KB + a * BK * T::RB, &tv, a * T::SW, kh,
                      j * BK, b, v_full(s));
      }
      // the consumers' last releases: a consumer that never arrives makes
      // this wait trap instead of leaving the launch hung
      for (int n = 0; n < ST; ++n, ++i)
        mbar_wait(empty(i % ST), ((i / ST) & 1) ^ 1);
    }
  } else {
    const int cw = wg;                         // consumer warpgroup
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int wq_lo = q_lo + 64 * cw;          // this warpgroup's rows
    const int row0 = wq_lo + 16 * warp + (lane >> 2);   // and row0 + 8
    // x = the score in base 2: s * scale * log2 e, or under the softcap
    // cap * tanh(s * scale / cap) * log2 e.  __fmul_rn keeps the compiler
    // from fusing it differently on edge and interior tiles.
    const float c_out = (softcap > 0.f ? softcap : scale) * REPRO_LOG2E;
    const float c_in = softcap > 0.f ? scale / softcap : 0.f;

    float acc[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    int i = 0;
    for (int j = lo; j < hi; ++j, ++i) {
      const int s = i % ST;
      const uint32_t ph = (i / ST) & 1;
      const int k_lo = j * BK;
      const bool skip = (causal && k_lo > wq_lo + 63) ||
                        (window > 0 && wq_lo - (k_lo + BK - 1) >= window);
      if (!skip) {
        mbar_wait(k_full(s), ph);
        float sc[BK / 2];
        const uint64_t qd = T::kdesc(sQ + 64 * cw * T::RB);
        const uint64_t kd = T::kdesc(sK + s * KB);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<BK>(sc, T::kstep(qd, BQ, kk), T::kstep(kd, BK, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          sc[e] = softcap > 0.f ? __fmul_rn(tanhf(__fmul_rn(sc[e], c_in)), c_out)
                                : __fmul_rn(sc[e], c_out);
        const bool edge = (causal && k_lo + BK - 1 > wq_lo) ||
                          (window > 0 && wq_lo + 63 - k_lo >= window) ||
                          k_lo + BK > Sk;
        if (edge) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const int qpos = row0 + 8 * ((e >> 1) & 1);
            const int kpos = k_lo + 8 * (e >> 2) + 2 * t + (e & 1);
            bool ok = kpos < Sk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && qpos - kpos < window;
            if (!ok) sc[e] = -INFINITY;
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        float corr[2], base[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          // a row with nothing unmasked yet keeps m = -inf: exponentiate
          // against 0 then (every p is 0), and leave an unchanged max's
          // state exactly as it is
          base[r] = m_new == -INFINITY ? 0.f : m_new;
          corr[r] = m_new == m[r] ? 1.f : ex2(m[r] - base[r]);
          m[r] = m_new;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const float p = ex2(sc[e] - base[(e >> 1) & 1]);
          sc[e] = p;
          rs[(e >> 1) & 1] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
        for (int e = 0; e < HD / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
        unsigned pa[BK / 16][4];
        acc_to_a<BK>(pa, sc);

        mbar_wait(v_full(s), ph);
        const uint64_t vd = T::mndesc(sV + s * KB, BK);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_wide<HD, BK>(acc, pa[kk], T::mnstep(vd, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // epilogue: l over the row's four lanes; O through this warpgroup's own
    // Q rows (no product reads them any more) to 16-byte stores
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
      const int row = row0 + 8 * r;
      if (lse != nullptr && t == 0 && row < S)
        lse[(static_cast<long long>(b) * H + h) * S + row] =
            (m[r] + log2f(l[r])) * REPRO_LN2;
    }
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] *= inv[(e >> 1) & 1];
    uint8_t* slice = smem + 64 * cw * T::RB;
    stage_acc<HD>(slice, BQ, acc, 1.f);
    named_bar_sync(1 + cw, 128);
    const long long ld = static_cast<long long>(H) * RD;
    store_slice<HD, RD>(o + static_cast<long long>(b) * S * ld + h * RD, ld,
                        slice, BQ, wq_lo, S, threadIdx.x & 127);
  }
}

template <int HD, int NWG, int RD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int S, int Sk, int H,
                         int K, float scale, int causal, int window,
                         float softcap, cudaStream_t stream) {
  constexpr int BQ = 64 * NWG, BK = fwd_bk(HD);
  CUtensorMap tq, tk, tv;
  cudaError_t err = head_map4<HD>(&tq, q, B, S, H, RD, BQ);
  if (err == cudaSuccess) err = head_map4<HD>(&tk, k, B, Sk, K, RD, BK);
  if (err == cudaSuccess) err = head_map4<HD>(&tv, v, B, Sk, K, RD, BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_bf16_wgmma<HD, NWG, RD>;
  constexpr size_t bytes = smem_fwd<HD, NWG>();
  static size_t allowed = 48 * 1024;     // per instantiation
  err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((S + BQ - 1) / BQ) * H * B;
  kernel<<<static_cast<unsigned>(blocks), fwd_threads(NWG), bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, S, Sk, H, K,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

// two consumer warpgroups (BQ = 128) when that grid fills the card, else
// one (BQ = 64): a B = 1 prefill of 288 rows gives 96 blocks at 128.  At
// HD 256 always one: two would hold 256 accumulator registers a thread.
// RD: the head's width (80 on a 128-wide tile), else HD.
template <int HD, int RD = HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int S, int Sk, int H, int K,
                        float scale, int causal, int window, float softcap,
                        cudaStream_t stream) {
  if constexpr (HD <= 128) {
    if (static_cast<long long>((S + 127) / 128) * H * B >= sm_count())
      return launch_wgmma<HD, 2, RD>(q, k, v, o, lse, B, S, Sk, H, K, scale,
                                     causal, window, softcap, stream);
  }
  return launch_wgmma<HD, 1, RD>(q, k, v, o, lse, B, S, Sk, H, K, scale,
                                 causal, window, softcap, stream);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int Sk, int H, int K,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_f32<T, HD>;
  const size_t bytes = smem_bytes<HD>();
  static size_t allowed = 48 * 1024;     // per instantiation
  cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Sk, H, K, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

// HD: the head's width; the bf16 tile's (TD) is 128 for a head of 80
template <int HD, int TD = HD>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, void* o, float* lse, int B, int S,
                         int Sk, int H, int K, float scale, int causal,
                         int window, float softcap, cudaStream_t s) {
  if (dtype == DT_BF16)
    return launch_bf16<TD, HD>(q, k, v, o, lse, B, S, Sk, H, K, scale,
                               causal, window, softcap, s);
  if (dtype == DT_F32)
    return launch<float, HD>(q, k, v, o, lse, B, S, Sk, H, K, scale, causal,
                             window, softcap, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, Sk, K, hd); contiguous, one dtype.
// lse: (B, H, S) float32, the log-sum-exp of each row's (scaled, capped)
// scores for the backward, or null (serving).  hd in {16, 32, 64, 80, 128,
// 256}.
// Returns the cudaError_t of the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int S, int Sk, int H, int K,
                                         int hd, float scale, int causal,
                                         int window, float softcap,
                                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return cudaSuccess;
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 16: return launch_dtype<16>(dtype, q, k, v, o, l, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 32: return launch_dtype<32>(dtype, q, k, v, o, l, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 64: return launch_dtype<64>(dtype, q, k, v, o, l, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 80: return launch_dtype<80, 128>(dtype, q, k, v, o, l, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 128: return launch_dtype<128>(dtype, q, k, v, o, l, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 256: return launch_dtype<256>(dtype, q, k, v, o, l, B, S, Sk, H, K, scale, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}
