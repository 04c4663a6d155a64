// Flash attention backward: dq, dk, dv of the forward in
// flash_attention.cu (causal and sliding-window masks, a tanh logit
// softcap, a custom scale, GQA), from q, k, v, the output o, its gradient
// do and the forward's per-row log-sum-exp.
//
// The TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bhsd has no backward (the JAX train step differentiates
// its jnp einsum path instead); this is the backward of its port.
//
// With s = scale * q.k, z = softcap ? cap * tanh(s / cap) : s and
// P = exp(z - lse) (recomputed tile by tile, never stored):
//   dV = P^T dO,  dP = dO V^T,  dZ = P * (dP - D) with D = rowsum(dO * O),
//   dS = dZ * (1 - tanh^2) under the softcap, else dZ,
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// Masked scores (causal, window, ragged tails past S or Sk) get P = 0, as
// in the forward, so they contribute nothing.
//
// Deterministic, with no float atomics: pass 1 writes dK and dV with one
// block per (k tile, kv head, batch), summing the G query heads of the
// group and their q tiles in a fixed order; pass 2 writes dQ with one
// block per (q tile, q head, batch), summing k tiles in a fixed order.  A
// first small kernel computes D.
//
// Bound on the H100 at the train shape (S = 2048, 32/8 heads of 128,
// bf16): operations, ~10 * hd flops per unmasked (q, k) pair.  Head dims
// 16, 32, 64, 80, 128 and 256, those of the forward.
//
// bfloat16 (the train path) runs on Hopper's asynchronous units: TMA rings
// in shared memory, wgmma products, warp-specialised blocks (see the
// bf16 section below).  P and dS are rounded to bf16 for the products that
// consume them, as the forward rounds P.  float32 runs on the CUDA cores:
// 64-row tiles (32 at head_dim 256) of q, k, v, dO in shared memory as
// float32 (padded rows), each of 256 threads owning a 4 x 4 (2 x 2) block
// of the score tile and 4 (2) rows of hd / 16 columns of the accumulators
// in registers.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NTB = 256;         // a 16 x 16 thread grid

// float32 tile rows (q and k): 64, or 32 at head_dim 256, where four
// 64-row tiles of 257 floats alone would take 263 KB of shared memory.
// Each thread owns a RI x RI block of the BT x BT score tile (RI = BT /
// 16) and RI x HD / 16 of each accumulator.
template <int HD>
__host__ __device__ constexpr int f32_bt() { return HD > 128 ? 32 : 64; }

template <int HD>
constexpr size_t smem_dkdv() {
  constexpr int BT = f32_bt<HD>();
  return sizeof(float) * (4 * BT * (HD + 1) + 2 * BT * (BT + 1) + 2 * BT);
}

template <int HD>
constexpr size_t smem_dq() {
  constexpr int BT = f32_bt<HD>();
  return sizeof(float) * (4 * BT * (HD + 1) + BT * (BT + 1) + 2 * BT);
}

// D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]; one warp per row.
template <typename T, int HD>
__global__ void flash_bwd_rowdot(const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 float* __restrict__ dvec, int B, int S,
                                 int H) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (NTB / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(B) * S * H) return;
  const T* orow = o + row * HD;
  const T* grow = dout + row * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32)
    acc += to_f32(orow[d]) * to_f32(grow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = row / (static_cast<long long>(S) * H);
    const long long rem = row % (static_cast<long long>(S) * H);
    const long long s = rem / H, h = rem % H;
    dvec[(b * H + h) * S + s] = acc;
  }
}

// Rows [row0, row0 + BT) of one head (row stride `stride` elements) as
// float32 into a (BT, HD + 1) shared tile; rows at or past `rows` are 0.
template <typename T, int HD, int BT>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < BT * HD; i += NTB) {
    const int r = i / HD, d = i % HD, s = row0 + r;
    dst[r * (HD + 1) + d] =
        s < rows ? to_f32(src[static_cast<long long>(s) * stride + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d] over (BT, HD + 1)
// shared tiles.
template <int HD, int RI>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         float acc[RI][RI], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[RI], b[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < RI; ++j) b[j] = Bm[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) acc[i][j] += a[i] * b[j];
  }
}

// P and dS of one (q tile, k tile) pair from the raw dot products s = q.k
// and dp = dO.v; rows ty + 16 i of the q tile, columns tx + 16 j of the k
// tile.  Writes P (when Ps is not null) and dS into (BT, BT + 1) tiles.
template <int RI>
__device__ __forceinline__ void probs_and_dscores(
    const float s[RI][RI], const float dp[RI][RI], const float* Ls,
    const float* Ds, float* Ps, float* dSs, int q_lo, int k_lo, int S,
    int Sk, float scale, int causal, int window, float softcap, int ty,
    int tx) {
  constexpr int LDP = 16 * RI + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, qpos = q_lo + r;
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int c = tx + 16 * j, kpos = k_lo + c;
      bool ok = qpos < S && kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      const float sc = s[i][j] * scale;
      float t = 0.f, z = sc;
      if (softcap > 0.f) {
        t = tanhf(sc / softcap);
        z = t * softcap;
      }
      const float p = ok ? expf(z - Ls[r]) : 0.f;
      float ds = p * (dp[i][j] - Ds[r]);
      if (softcap > 0.f) ds *= 1.f - t * t;
      if (Ps != nullptr) Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = ds;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTB)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, T* __restrict__ dk,
                   T* __restrict__ dv, int S, int Sk, int H, int K,
                   float scale, int causal, int window, float softcap) {
  constexpr int BT = f32_bt<HD>(), RI = BT / 16, LDP = BT + 1;
  constexpr int LD = HD + 1;
  constexpr int NM = HD / 16;             // accumulator columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* Ps = dOs + BT * LD;
  float* dSs = Ps + BT * LDP;
  float* Ls = dSs + BT * LDP;
  float* Ds = Ls + BT;

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k_lo = kt * BT;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(K) * HD;
  const long long kv_off = static_cast<long long>(b) * Sk * kv_row +
                           static_cast<long long>(kh) * HD;

  load_rows<T, HD, BT>(Ks, k + kv_off, kv_row, k_lo, Sk);
  load_rows<T, HD, BT>(Vs, v + kv_off, kv_row, k_lo, Sk);

  float dk_acc[RI][NM], dv_acc[RI][NM];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int m = 0; m < NM; ++m) dk_acc[i][m] = dv_acc[i][m] = 0.f;

  // q tiles that can see this k tile: q >= k (causal) and
  // q <= k + window - 1 (window)
  const int nq = (S + BT - 1) / BT;
  const int qlo = causal ? min(nq, k_lo / BT) : 0;
  const int qhi = window > 0
                      ? min(nq, (k_lo + BT - 1 + window - 1) / BT + 1)
                      : nq;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long q_off = static_cast<long long>(b) * S * q_row +
                            static_cast<long long>(h) * HD;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * S;
    const float* d_h = dvec + (static_cast<long long>(b) * H + h) * S;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q_lo = qt * BT;
      __syncthreads();                    // previous tile consumed
      load_rows<T, HD, BT>(Qs, q + q_off, q_row, q_lo, S);
      load_rows<T, HD, BT>(dOs, dout + q_off, q_row, q_lo, S);
      if (threadIdx.x < BT) {
        const int s = q_lo + threadIdx.x;
        Ls[threadIdx.x] = s < S ? lse_h[s] : 0.f;
        Ds[threadIdx.x] = s < S ? d_h[s] : 0.f;
      }
      __syncthreads();

      float s[RI][RI], dp[RI][RI];
      tile_dot<HD, RI>(Qs, Ks, s, ty, tx);
      tile_dot<HD, RI>(dOs, Vs, dp, ty, tx);
      probs_and_dscores<RI>(s, dp, Ls, Ds, Ps, dSs, q_lo, k_lo, S, Sk,
                            scale, causal, window, softcap, ty, tx);
      __syncthreads();

      // dV[c] += sum_r P[r][c] dO[r];  dK[c] += sum_r dS[r][c] Q[r]
      for (int r = 0; r < BT; ++r) {
        float pc[RI], dsc[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pc[i] = Ps[r * LDP + ty + 16 * i];
          dsc[i] = dSs[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const float dov = dOs[r * LD + tx + 16 * m];
          const float qv = Qs[r * LD + tx + 16 * m];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            dv_acc[i][m] += pc[i] * dov;
            dk_acc[i][m] += dsc[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int c = k_lo + ty + 16 * i;
    if (c >= Sk) continue;
    const long long off = kv_off + static_cast<long long>(c) * kv_row;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      dk[off + tx + 16 * m] = from_f32<T>(dk_acc[i][m] * scale);
      dv[off + tx + 16 * m] = from_f32<T>(dv_acc[i][m]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTB)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dvec, T* __restrict__ dq, int S,
                 int Sk, int H, int K, float scale, int causal, int window,
                 float softcap) {
  constexpr int BT = f32_bt<HD>(), RI = BT / 16, LDP = BT + 1;
  constexpr int LD = HD + 1;
  constexpr int NM = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * LD;
  float* Ks = dOs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* dSs = Vs + BT * LD;
  float* Ls = dSs + BT * LDP;
  float* Ds = Ls + BT;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q_lo = qt * BT;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(K) * HD;
  const long long q_off = static_cast<long long>(b) * S * q_row +
                          static_cast<long long>(h) * HD;
  const long long kv_off = static_cast<long long>(b) * Sk * kv_row +
                           static_cast<long long>(kh) * HD;
  const float* lse_h = lse + (static_cast<long long>(b) * H + h) * S;
  const float* d_h = dvec + (static_cast<long long>(b) * H + h) * S;

  load_rows<T, HD, BT>(Qs, q + q_off, q_row, q_lo, S);
  load_rows<T, HD, BT>(dOs, dout + q_off, q_row, q_lo, S);
  if (threadIdx.x < BT) {
    const int s = q_lo + threadIdx.x;
    Ls[threadIdx.x] = s < S ? lse_h[s] : 0.f;
    Ds[threadIdx.x] = s < S ? d_h[s] : 0.f;
  }

  float dq_acc[RI][NM];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int m = 0; m < NM; ++m) dq_acc[i][m] = 0.f;

  // the forward's k-tile range for this q tile
  const int nk = (Sk + BT - 1) / BT;
  const int khi = causal ? min(nk, (min(q_lo + BT, S) - 1) / BT + 1) : nk;
  const int klo = window > 0 ? max(0, q_lo - window + 1) / BT : 0;

  for (int kt = klo; kt < khi; ++kt) {
    const int k_lo = kt * BT;
    __syncthreads();                      // previous tile consumed
    load_rows<T, HD, BT>(Ks, k + kv_off, kv_row, k_lo, Sk);
    load_rows<T, HD, BT>(Vs, v + kv_off, kv_row, k_lo, Sk);
    __syncthreads();

    float s[RI][RI], dp[RI][RI];
    tile_dot<HD, RI>(Qs, Ks, s, ty, tx);
    tile_dot<HD, RI>(dOs, Vs, dp, ty, tx);
    probs_and_dscores<RI>(s, dp, Ls, Ds, nullptr, dSs, q_lo, k_lo, S, Sk,
                          scale, causal, window, softcap, ty, tx);
    __syncthreads();

    // dQ[r] += sum_c dS[r][c] K[c]
    for (int c = 0; c < BT; ++c) {
      float dsr[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsr[i] = dSs[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float kv = Ks[c * LD + tx + 16 * m];
#pragma unroll
        for (int i = 0; i < RI; ++i) dq_acc[i][m] += dsr[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q_lo + ty + 16 * i;
    if (r >= S) continue;
    const long long off = q_off + static_cast<long long>(r) * q_row;
#pragma unroll
    for (int m = 0; m < NM; ++m)
      dq[off + tx + 16 * m] = from_f32<T>(dq_acc[i][m] * scale);
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* dvec, void* dq, void* dk, void* dv, int B,
                       int S, int Sk, int H, int K, float scale, int causal,
                       int window, float softcap, cudaStream_t stream) {
  constexpr int BT = f32_bt<HD>();
  const long long rows = static_cast<long long>(B) * S * H;
  flash_bwd_rowdot<T, HD>
      <<<static_cast<unsigned>((rows + NTB / 32 - 1) / (NTB / 32)), NTB, 0,
         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                   dvec, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv<T, HD>;
  static size_t allowed_dkdv = 48 * 1024;   // per instantiation
  err = allow_smem(dkdv, smem_dkdv<HD>(), allowed_dkdv);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Sk + BT - 1) / BT, K, B), NTB, smem_dkdv<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
      static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, H, K, scale, causal,
      window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq<T, HD>;
  static size_t allowed_dq = 48 * 1024;
  err = allow_smem(dqk, smem_dq<HD>(), allowed_dq);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((S + BT - 1) / BT, H, B), NTB, smem_dq<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
      static_cast<T*>(dq), S, Sk, H, K, scale, causal, window, softcap);
  return cudaGetLastError();
}

// ---- bfloat16: wgmma fed by TMA rings ------------------------------------------
//
// Three launches, deterministic, no float atomics:
//   prep:   D = rowsum(dO * O) and L2 = lse * log2 e, (B, H, Sp) each with
//           Sp = S rounded up to 128, padded with D = 0, L2 = +inf (P = 0);
//   pass 1: dK, dV.  One block a (64-row k tile, kv head, batch) and, at
//           head_dim 256, column half: K and V stay in shared memory; the
//           G q heads of the group and their 64-row q tiles stream through
//           a TMA ring (Q, dO, and L2, D by bulk copy) in a fixed order,
//           and one consumer warpgroup sums into registers
//             S^T = K Q^T, dP^T = V dO^T      (wgmma, both from shared,
//                                              over every column)
//             P^T, dS^T elementwise           (edge tiles masked)
//             dV += P^T dO, dK += dS^T Q      (P^T, dS^T as register A,
//                                              dO, Q transposed-B; the
//                                              block's columns only);
//   pass 2: dQ.  One block a (64 NWG-row q tile, q head, batch): Q and dO
//           stay in shared memory, 64-row K and V tiles stream through the
//           ring in ascending order; S = Q K^T, dP = dO V^T, dQ += dS K.
// Pass 2 recomputes S and dP (7 products a tile pair where a backward with
// atomic dQ needs 5): the price of a fixed summation order, which bit-equal
// repeated steps and bit-exact recovery rest on.
//
// Tiles are read through the 4-D tensor maps of the forward (head_map4):
// a tile is HD columns wide and the head RD <= HD; at head_dim 80 TMA
// fills columns 80-127 of a 128-wide tile with zeros (no score, dP or
// gradient column changes), and only 80 columns are stored.
//
// Head_dim 256: a 64 x 256 fp32 accumulator is 128 registers a thread, so
// pass 1 holding both dK and dV would need 256.  Each pass-1 block
// instead keeps one 128-column half of dK and dV (the registers of head_dim
// 128) and recomputes S^T and dP^T over all 256 columns, as its twin for
// the other half does: a tile pair's products come to 6 M multiply-adds
// (S^T and dP^T 1 M each, twice; dV and dK 0.5 M a half each) against
// the 4 M of an unsplit pass, 1.5x.  Pass 2 runs one consumer warpgroup
// on 64-row q tiles (Q and dO at 128 rows and two K, V stages would take
// 256 KB of shared memory, and two warpgroups of 128 accumulator
// registers exceed their 168), dQ += dS K as two 128-column products.
//
// Schedule (both passes: one block an output tile, heaviest first): pass 1
// runs k tiles in ascending order (under causal k tile 0 sees every q
// tile), pass 2 q tiles in descending order; halves, heads and batches
// vary fastest.  Registers: pass 1 holds dK and dV (2 x 64 fp32 a thread
// at 128 columns) and the 64 x 64 S^T and dP^T tiles (2 x 32) with their
// bf16 copies: 255 registers, no spill (one consumer warpgroup, below).
constexpr int P1_BK = 64;        // pass 1: k rows a block (one warpgroup)
constexpr int P1_BQ = 64;        // pass 1: streamed q rows
constexpr int P2_BK = 64;        // pass 2: streamed k rows
constexpr int BWD_STAGES = 2;
constexpr int PAD = 128;         // Sp = S rounded up to PAD

// pass 1: column halves of dK and dV a (k tile, kv head, batch)
__host__ __device__ constexpr int p1_halves(int hd) { return hd > 128 ? 2 : 1; }
// pass 2: consumer warpgroups (64 q rows each)
__host__ __device__ constexpr int p2_nwg(int hd) { return hd > 128 ? 1 : 2; }

template <int HD>
constexpr size_t smem_p1() {
  return 1024 + 2 * Tile<HD>::bytes(P1_BK) +
         BWD_STAGES * (2 * Tile<HD>::bytes(P1_BQ) + 1024) +
         8 * (1 + 2 * BWD_STAGES);
}

template <int HD>
constexpr size_t smem_p2() {
  return 1024 + 2 * Tile<HD>::bytes(64 * p2_nwg(HD)) +
         2 * BWD_STAGES * Tile<HD>::bytes(P2_BK) + 8 * (1 + 3 * BWD_STAGES);
}

// lanes of the prep kernel a row: RD / 8 rounded up to a power of 2 (80
// columns: 10 lanes of 16-byte loads, in groups of 16)
__host__ __device__ constexpr int prep_lanes(int rd) {
  return rd <= 16 ? 2 : rd <= 32 ? 4 : rd <= 64 ? 8 : rd <= 128 ? 16 : 32;
}

// D and L2 of each row (b, h, s), s < Sp: prep_lanes(RD) lanes a row,
// each with one 16-byte load of O and of dO (lanes past the head's RD
// columns load nothing); rows ordered (b, s, h), so that a warp reads
// consecutive heads of one position, contiguous in memory.
template <int RD>
__global__ void flash_bwd_prep(const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               float* __restrict__ dvec,
                               float* __restrict__ l2, int B, int S, int H,
                               int Sp) {
  constexpr int LPR = prep_lanes(RD);          // lanes a row
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const long long row =
      (static_cast<long long>(blockIdx.x) * (NTB / 32) + (threadIdx.x >> 5)) *
          (32 / LPR) + lane / LPR;
  const bool live = row < static_cast<long long>(B) * Sp * H;
  const int h = static_cast<int>(row % H);
  const long long bs = row / H;
  const int s = static_cast<int>(bs % Sp), b = static_cast<int>(bs / Sp);
  float acc = 0.f;
  if (live && s < S && sub * 8 < RD) {
    const long long off = ((static_cast<long long>(b) * S + s) * H + h) * RD +
                          sub * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]);
      const float2 gf = __bfloat1622float2(g2[i]);
      acc += of.x * gf.x;
      acc += of.y * gf.y;
    }
  }
#pragma unroll
  for (int w = LPR / 2; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (live && sub == 0) {
    const long long bh = static_cast<long long>(b) * H + h;
    dvec[bh * Sp + s] = acc;
    l2[bh * Sp + s] =
        s < S ? __fmul_rn(lse[bh * S + s], REPRO_LOG2E) : INFINITY;
  }
}

// Pass 2: NWG consumer warpgroups and one producer warp, one block a SM.
// ptxas holds a block with two warpgroups of wgmma products to 168
// registers a thread (65536 / 384, with or without setmaxnreg: see
// flash_fwd_bf16_wgmma), too few for pass 1's dK and dV (128 a thread)
// beside its S^T and dP^T tiles; pass 1 runs one consumer warpgroup and
// its producer warp, 160 threads of up to 255 registers.
constexpr int P1_THREADS = 160;
__host__ __device__ constexpr int p2_threads(int nwg) { return 128 * nwg + 32; }

// The base-2 score x of a raw dot product s, and the softcap's derivative
// factor 1 - tanh^2 (1 without a cap).
struct Scores {
  float c_out, c_in;
  int cap;
  __device__ __forceinline__ Scores(float scale, float softcap)
      : c_out((softcap > 0.f ? softcap : scale) * REPRO_LOG2E),
        c_in(softcap > 0.f ? scale / softcap : 0.f), cap(softcap > 0.f) {}
  __device__ __forceinline__ float x(float s, float& dz) const {
    if (!cap) {
      dz = 1.f;
      return __fmul_rn(s, c_out);
    }
    const float th = tanhf(__fmul_rn(s, c_in));
    dz = 1.f - th * th;
    return __fmul_rn(th, c_out);
  }
};

// HD: the tile's width; RD <= HD: the head's (80 on a 128-wide tile)
template <int HD, int RD>
__global__ void __launch_bounds__(P1_THREADS, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ dvec,
                         const float* __restrict__ l2,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int B, int S, int Sk,
                         int H, int K, int Sp, float scale, int causal,
                         int window, float softcap) {
  using T = Tile<HD>;
  constexpr int BK = P1_BK, BQ = P1_BQ, ST = BWD_STAGES;
  constexpr int NH = p1_halves(HD), CW = HD / NH;   // columns a block keeps
  constexpr uint32_t KB = T::bytes(BK), QB = T::bytes(BQ);
  // a stage: Q, dO, then L2 and D (2 x 4 BQ bytes) in a 1024-byte slot, so
  // that every stage's tiles stay 1024-byte aligned
  constexpr uint32_t STAGE = 2 * QB + 1024;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + KB, sS = sV + KB;
  auto sQ = [&](int s) { return sS + s * STAGE; };
  auto sdO = [&](int s) { return sS + s * STAGE + QB; };
  auto sL = [&](int s) {
    return reinterpret_cast<const float*>(smem + 2 * KB + s * STAGE + 2 * QB);
  };
  const uint32_t bars = sS + ST * STAGE;   // kv_full, full[ST], empty[ST]
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  int id = blockIdx.x;
  const int half = id % NH;
  id /= NH;
  const int kh = id % K;
  id /= K;
  const int b = id % B;
  const int k_lo = (id / B) * BK;            // k tile 0 (the heaviest) first
  const int G = H / K;
  const int nq = (S + BQ - 1) / BQ;
  const int qlo = causal ? min(nq, k_lo / BQ) : 0;
  const int qhi =
      window > 0 ? min(nq, (k_lo + BK - 1 + window - 1) / BQ + 1) : nq;
  const int nt = G * max(0, qhi - qlo);      // tiles: (g, q tile), g slowest

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);                // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;          // 1: the producer warp
  if (wg == 1) {
    if (threadIdx.x == 128) {
      mbar_expect_tx(kv_full, 2 * KB);
#pragma unroll
      for (int a = 0; a < T::NA; ++a) {
        tma_load_4d(sK + a * BK * T::RB, &tk, a * T::SW, kh, k_lo, b,
                    kv_full);
        tma_load_4d(sV + a * BK * T::RB, &tv, a * T::SW, kh, k_lo, b,
                    kv_full);
      }
      int i = 0;
      for (; i < nt; ++i) {
        const int h = kh * G + i / (qhi - qlo);
        const int q_lo = (qlo + i % (qhi - qlo)) * BQ;
        const int s = i % ST;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * QB + 2 * BQ * 4);
#pragma unroll
        for (int a = 0; a < T::NA; ++a) {
          tma_load_4d(sQ(s) + a * BQ * T::RB, &tq, a * T::SW, h, q_lo, b,
                      full(s));
          tma_load_4d(sdO(s) + a * BQ * T::RB, &tdo, a * T::SW, h, q_lo, b,
                      full(s));
        }
        const long long off = (static_cast<long long>(b) * H + h) * Sp + q_lo;
        bulk_load(sdO(s) + QB, l2 + off, BQ * 4, full(s));
        bulk_load(sdO(s) + QB + BQ * 4, dvec + off, BQ * 4, full(s));
      }
      for (int n = 0; n < ST; ++n, ++i)
        mbar_wait(empty(i % ST), ((i / ST) & 1) ^ 1);
    }
  } else {
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int wk_lo = k_lo;                    // the consumers' k rows
    const int krow0 = wk_lo + 16 * warp + (lane >> 2);   // and krow0 + 8
    const Scores sco(scale, softcap);
    // this block's columns of dO and Q as the MN-major B operand: column
    // blocks of SW elements at BQ * RB bytes from one another
    const uint32_t cols = half * (CW / T::SW) * BQ * T::RB;

    float dk_acc[CW / 2], dv_acc[CW / 2];
#pragma unroll
    for (int e = 0; e < CW / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < nt; ++i) {
      const int q_lo = (qlo + i % (qhi - qlo)) * BQ;
      const int s = i % ST;
      const bool skip = (causal && q_lo + BQ - 1 < wk_lo) ||
                        (window > 0 && q_lo - (wk_lo + 63) >= window);
      if (!skip) {
        mbar_wait(full(s), (i / ST) & 1);
        float st[BQ / 2], dpt[BQ / 2];
        const uint64_t kd = T::kdesc(sK);
        const uint64_t qd = T::kdesc(sQ(s));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<BQ>(st, T::kstep(kd, BK, kk), T::kstep(qd, BQ, kk), kk > 0);
        const uint64_t vd = T::kdesc(sV);
        const uint64_t od = T::kdesc(sdO(s));
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<BQ>(dpt, T::kstep(vd, BK, kk), T::kstep(od, BQ, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        const float* Ls = sL(s);
        const float* Ds = Ls + BQ;
        const bool edge = (causal && wk_lo + 63 > q_lo) ||
                          (window > 0 && q_lo + BQ - 1 - wk_lo >= window) ||
                          q_lo + BQ > S;
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int qc = 8 * (e >> 2) + 2 * t + (e & 1);   // column: q
          float dz;
          const float x = sco.x(st[e], dz);
          float p = ex2(x - Ls[qc]);
          if (edge) {
            const int qpos = q_lo + qc, kpos = krow0 + 8 * ((e >> 1) & 1);
            bool ok = qpos < S;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && qpos - kpos < window;
            if (!ok) p = 0.f;
          }
          st[e] = p;
          dpt[e] = p * (dpt[e] - Ds[qc]) * dz;
        }
        unsigned pa[BQ / 16][4], da[BQ / 16][4];
        acc_to_a<BQ>(pa, st);
        acc_to_a<BQ>(da, dpt);
        const uint64_t otd = T::mndesc(sdO(s) + cols, BQ);
        const uint64_t qtd = T::mndesc(sQ(s) + cols, BQ);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<CW>(dv_acc, pa[kk], T::mnstep(otd, kk));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<CW>(dk_acc, da[kk], T::mnstep(qtd, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // dK and dV through this warpgroup's own K and V rows (a CW-column
    // slice fits the first CW / HD of each tile)
    uint8_t* k_slice = smem;
    uint8_t* v_slice = smem + KB;
    stage_acc<CW>(k_slice, BK, dk_acc, scale);
    stage_acc<CW>(v_slice, BK, dv_acc, 1.f);
    named_bar_sync(1, 128);
    constexpr int NC = NH > 1 ? CW : RD;       // columns stored
    const long long ld = static_cast<long long>(K) * RD;
    const long long base =
        static_cast<long long>(b) * Sk * ld + kh * RD + half * CW;
    store_slice<CW, NC>(dk + base, ld, k_slice, BK, wk_lo, Sk,
                        threadIdx.x & 127);
    store_slice<CW, NC>(dv + base, ld, v_slice, BK, wk_lo, Sk,
                        threadIdx.x & 127);
  }
}

template <int HD, int RD>
__global__ void __launch_bounds__(p2_threads(p2_nwg(HD)), 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const float* __restrict__ dvec,
                       const float* __restrict__ l2,
                       __nv_bfloat16* __restrict__ dq, int B, int S, int Sk,
                       int H, int K, int Sp, float scale, int causal,
                       int window, float softcap) {
  using T = Tile<HD>;
  constexpr int NWG = p2_nwg(HD);
  constexpr int BQ = 64 * NWG, BK = P2_BK, ST = BWD_STAGES;
  constexpr uint32_t QB = T::bytes(BQ), KB = T::bytes(BK);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t sQ = smem_u32(smem), sdO = sQ + QB, sK = sdO + QB,
                 sV = sK + ST * KB;
  const uint32_t bars = sV + ST * KB;   // q_full, k_full[ST], v_full[ST],
  const uint32_t q_full = bars;         // empty[ST]
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
  const int khi = causal ? min(nk, (min(q_lo + BQ, S) - 1) / BK + 1) : nk;
  const int klo = window > 0 ? min(khi, max(0, q_lo - window + 1) / BK) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;          // NWG: the producer warp
  if (wg == NWG) {
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(q_full, 2 * QB);
#pragma unroll
      for (int a = 0; a < T::NA; ++a) {
        tma_load_4d(sQ + a * BQ * T::RB, &tq, a * T::SW, h, q_lo, b, q_full);
        tma_load_4d(sdO + a * BQ * T::RB, &tdo, a * T::SW, h, q_lo, b,
                    q_full);
      }
      int i = 0;
      for (int j = klo; j < khi; ++j, ++i) {
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
      for (int n = 0; n < ST; ++n, ++i)
        mbar_wait(empty(i % ST), ((i / ST) & 1) ^ 1);
    }
  } else {
    const int cw = wg;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int wq_lo = q_lo + 64 * cw;
    const int row0 = wq_lo + 16 * warp + (lane >> 2);   // and row0 + 8
    const Scores sco(scale, softcap);
    const long long off = (static_cast<long long>(b) * H + h) * Sp + row0;
    const float L[2] = {l2[off], l2[off + 8]};          // rows < Sp
    const float D[2] = {dvec[off], dvec[off + 8]};

    float dq_acc[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dq_acc[e] = 0.f;
    mbar_wait(q_full, 0);

    int i = 0;
    for (int j = klo; j < khi; ++j, ++i) {
      const int s = i % ST;
      const uint32_t ph = (i / ST) & 1;
      const int k_lo = j * BK;
      const bool skip = (causal && k_lo > wq_lo + 63) ||
                        (window > 0 && wq_lo - (k_lo + BK - 1) >= window);
      if (!skip) {
        float sc[BK / 2], dp[BK / 2];
        mbar_wait(k_full(s), ph);
        const uint64_t qd = T::kdesc(sQ + 64 * cw * T::RB);
        const uint64_t kd = T::kdesc(sK + s * KB);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<BK>(sc, T::kstep(qd, BQ, kk), T::kstep(kd, BK, kk), kk > 0);
        wgmma_commit();
        mbar_wait(v_full(s), ph);
        const uint64_t od = T::kdesc(sdO + 64 * cw * T::RB);
        const uint64_t vd = T::kdesc(sV + s * KB);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<BK>(dp, T::kstep(od, BQ, kk), T::kstep(vd, BK, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        const bool edge = (causal && k_lo + BK - 1 > wq_lo) ||
                          (window > 0 && wq_lo + 63 - k_lo >= window) ||
                          k_lo + BK > Sk;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int r = (e >> 1) & 1;
          float dz;
          const float x = sco.x(sc[e], dz);
          float p = ex2(x - L[r]);
          if (edge) {
            const int qpos = row0 + 8 * r;
            const int kpos = k_lo + 8 * (e >> 2) + 2 * t + (e & 1);
            bool ok = kpos < Sk;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && qpos - kpos < window;
            if (!ok) p = 0.f;
          }
          dp[e] = p * (dp[e] - D[r]) * dz;
        }
        unsigned da[BK / 16][4];
        acc_to_a<BK>(da, dp);
        const uint64_t ktd = T::mndesc(sK + s * KB, BK);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_wide<HD, BK>(dq_acc, da[kk], T::mnstep(ktd, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    uint8_t* slice = smem + 64 * cw * T::RB;   // this warpgroup's Q rows
    stage_acc<HD>(slice, BQ, dq_acc, scale);
    named_bar_sync(1 + cw, 128);
    const long long ld = static_cast<long long>(H) * RD;
    store_slice<HD, RD>(dq + static_cast<long long>(b) * S * ld + h * RD, ld,
                        slice, BQ, wq_lo, S, threadIdx.x & 127);
  }
}

// HD: the tile's width; RD: the head's (80 on a 128-wide tile), else HD
template <int HD, int RD>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* lse,
                            float* dvec, void* dq, void* dk, void* dv, int B,
                            int S, int Sk, int H, int K, float scale,
                            int causal, int window, float softcap,
                            cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int Sp = (S + PAD - 1) / PAD * PAD;
  float* l2 = dvec + static_cast<long long>(B) * H * Sp;
  const long long rows = static_cast<long long>(B) * H * Sp;
  const long long per_block = NTB / 32 * (32 / prep_lanes(RD));
  flash_bwd_prep<RD>
      <<<static_cast<unsigned>((rows + per_block - 1) / per_block), NTB, 0,
         stream>>>(static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                   lse, dvec, l2, B, S, H, Sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap tq, tdo, tk, tv;
  err = head_map4<HD>(&tq, q, B, S, H, RD, P1_BQ);
  if (err == cudaSuccess) err = head_map4<HD>(&tdo, dout, B, S, H, RD, P1_BQ);
  if (err == cudaSuccess) err = head_map4<HD>(&tk, k, B, Sk, K, RD, P1_BK);
  if (err == cudaSuccess) err = head_map4<HD>(&tv, v, B, Sk, K, RD, P1_BK);
  if (err != cudaSuccess) return err;
  auto dkdv = flash_bwd_dkdv_wgmma<HD, RD>;
  static size_t allowed_dkdv = 48 * 1024;   // per instantiation
  err = allow_smem(dkdv, smem_p1<HD>(), allowed_dkdv);
  if (err != cudaSuccess) return err;
  const long long b1 = static_cast<long long>((Sk + P1_BK - 1) / P1_BK) * K *
                       B * p1_halves(HD);
  dkdv<<<static_cast<unsigned>(b1), P1_THREADS, smem_p1<HD>(), stream>>>(
      tq, tdo, tk, tv, dvec, l2, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, S, Sk, H, K, Sp, scale, causal, window,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int BQ2 = 64 * p2_nwg(HD);
  err = head_map4<HD>(&tq, q, B, S, H, RD, BQ2);
  if (err == cudaSuccess) err = head_map4<HD>(&tdo, dout, B, S, H, RD, BQ2);
  if (err == cudaSuccess) err = head_map4<HD>(&tk, k, B, Sk, K, RD, P2_BK);
  if (err == cudaSuccess) err = head_map4<HD>(&tv, v, B, Sk, K, RD, P2_BK);
  if (err != cudaSuccess) return err;
  auto dqk = flash_bwd_dq_wgmma<HD, RD>;
  static size_t allowed_dq = 48 * 1024;
  err = allow_smem(dqk, smem_p2<HD>(), allowed_dq);
  if (err != cudaSuccess) return err;
  const long long b2 = static_cast<long long>((S + BQ2 - 1) / BQ2) * H * B;
  dqk<<<static_cast<unsigned>(b2), p2_threads(p2_nwg(HD)), smem_p2<HD>(),
        stream>>>(tq, tdo, tk, tv, dvec, l2, static_cast<bf16*>(dq), B, S,
                  Sk, H, K, Sp, scale, causal, window, softcap);
  return cudaGetLastError();
}

// HD: the head's width; the bf16 tile's (TD) is 128 for a head of 80
template <int HD, int TD = HD>
cudaError_t launch_bwd_dtype(int dtype, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const float* lse, float* dvec, void* dq,
                             void* dk, void* dv, int B, int S, int Sk, int H,
                             int K, float scale, int causal, int window,
                             float softcap, cudaStream_t s) {
  if (dtype == DT_BF16)
    return launch_bwd_bf16<TD, HD>(q, k, v, o, dout, lse, dvec, dq, dk, dv,
                                   B, S, Sk, H, K, scale, causal, window,
                                   softcap, s);
  if (dtype == DT_F32)
    return launch_bwd<float, HD>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B,
                                 S, Sk, H, K, scale, causal, window, softcap,
                                 s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, Sk, K, hd); contiguous,
// one dtype.  lse: (B, H, S) float32 from the forward; dvec: float32
// scratch of 2 B H Sp elements, Sp = S rounded up to 128.  hd in {16, 32,
// 64, 80, 128, 256}.  Returns the cudaError_t of the launches.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* dq, void* dk,
    void* dv, int B, int S, int Sk, int H, int K, int hd, float scale,
    int causal, int window, float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Sk <= 0) return cudaSuccess;
  const float* l = static_cast<const float*>(lse);
  float* dv_ = static_cast<float*>(dvec);
  switch (hd) {
    case 16: return launch_bwd_dtype<16>(dtype, q, k, v, o, dout, l, dv_, dq, dk, dv, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 32: return launch_bwd_dtype<32>(dtype, q, k, v, o, dout, l, dv_, dq, dk, dv, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 64: return launch_bwd_dtype<64>(dtype, q, k, v, o, dout, l, dv_, dq, dk, dv, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 80: return launch_bwd_dtype<80, 128>(dtype, q, k, v, o, dout, l, dv_, dq, dk, dv, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 128: return launch_bwd_dtype<128>(dtype, q, k, v, o, dout, l, dv_, dq, dk, dv, B, S, Sk, H, K, scale, causal, window, softcap, s);
    case 256: return launch_bwd_dtype<256>(dtype, q, k, v, o, dout, l, dv_, dq, dk, dv, B, S, Sk, H, K, scale, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}
