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
// bf16): operations, ~10 * hd flops per unmasked (q, k) pair.
//
// bfloat16 (the train path) runs on the tensor cores: 4 warps a block, each
// owning 16 rows of the block's 64-row tile (k rows in pass 1, q rows in
// pass 2); the four products a tile pair needs (S^T = K Q^T, dP^T =
// V dO^T, dV += P^T dO, dK += dS^T Q in pass 1; S = Q K^T, dP = dO V^T,
// dQ += dS K in pass 2) are mma.sync m16n8k16 with fp32 accumulation,
// fed by ldmatrix from padded shared tiles — the forward's two patterns.
// P and dS are rounded to bf16 for the products that consume them, as
// the forward rounds P.  float32 runs on the CUDA cores: 64-row tiles of
// q, k, v, dO in shared memory as float32 (padded rows), each of 256
// threads owning a 4 x 4 block of the 64 x 64 score tile and a 4 x hd/16
// block of the accumulators in registers.  cp.async/TMA double buffering
// and wgmma are later work.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BT = 64;           // q and k tile rows
constexpr int NTB = 256;         // a 16 x 16 thread grid
constexpr int LDP = BT + 1;      // padded score-tile row

template <int HD>
constexpr size_t smem_dkdv() {
  return sizeof(float) * (4 * BT * (HD + 1) + 2 * BT * LDP + 2 * BT);
}

template <int HD>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * BT * (HD + 1) + BT * LDP + 2 * BT);
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
template <typename T, int HD>
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
template <int HD>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         float acc[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// P and dS of one (q tile, k tile) pair from the raw dot products s = q.k
// and dp = dO.v; rows ty + 16 i of the q tile, columns tx + 16 j of the k
// tile.  Writes P (when Ps is not null) and dS into (BT, LDP) tiles.
__device__ __forceinline__ void probs_and_dscores(
    const float s[4][4], const float dp[4][4], const float* Ls,
    const float* Ds, float* Ps, float* dSs, int q_lo, int k_lo, int S,
    int Sk, float scale, int causal, int window, float softcap, int ty,
    int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q_lo + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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

  load_rows<T, HD>(Ks, k + kv_off, kv_row, k_lo, Sk);
  load_rows<T, HD>(Vs, v + kv_off, kv_row, k_lo, Sk);

  float dk_acc[4][NM], dv_acc[4][NM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
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
      load_rows<T, HD>(Qs, q + q_off, q_row, q_lo, S);
      load_rows<T, HD>(dOs, dout + q_off, q_row, q_lo, S);
      if (threadIdx.x < BT) {
        const int s = q_lo + threadIdx.x;
        Ls[threadIdx.x] = s < S ? lse_h[s] : 0.f;
        Ds[threadIdx.x] = s < S ? d_h[s] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<HD>(Qs, Ks, s, ty, tx);
      tile_dot<HD>(dOs, Vs, dp, ty, tx);
      probs_and_dscores(s, dp, Ls, Ds, Ps, dSs, q_lo, k_lo, S, Sk, scale,
                        causal, window, softcap, ty, tx);
      __syncthreads();

      // dV[c] += sum_r P[r][c] dO[r];  dK[c] += sum_r dS[r][c] Q[r]
      for (int r = 0; r < BT; ++r) {
        float pc[4], dsc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pc[i] = Ps[r * LDP + ty + 16 * i];
          dsc[i] = dSs[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const float dov = dOs[r * LD + tx + 16 * m];
          const float qv = Qs[r * LD + tx + 16 * m];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][m] += pc[i] * dov;
            dk_acc[i][m] += dsc[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

  load_rows<T, HD>(Qs, q + q_off, q_row, q_lo, S);
  load_rows<T, HD>(dOs, dout + q_off, q_row, q_lo, S);
  if (threadIdx.x < BT) {
    const int s = q_lo + threadIdx.x;
    Ls[threadIdx.x] = s < S ? lse_h[s] : 0.f;
    Ds[threadIdx.x] = s < S ? d_h[s] : 0.f;
  }

  float dq_acc[4][NM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < NM; ++m) dq_acc[i][m] = 0.f;

  // the forward's k-tile range for this q tile
  const int nk = (Sk + BT - 1) / BT;
  const int khi = causal ? min(nk, (min(q_lo + BT, S) - 1) / BT + 1) : nk;
  const int klo = window > 0 ? max(0, q_lo - window + 1) / BT : 0;

  for (int kt = klo; kt < khi; ++kt) {
    const int k_lo = kt * BT;
    __syncthreads();                      // previous tile consumed
    load_rows<T, HD>(Ks, k + kv_off, kv_row, k_lo, Sk);
    load_rows<T, HD>(Vs, v + kv_off, kv_row, k_lo, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<HD>(Qs, Ks, s, ty, tx);
    tile_dot<HD>(dOs, Vs, dp, ty, tx);
    probs_and_dscores(s, dp, Ls, Ds, nullptr, dSs, q_lo, k_lo, S, Sk,
                      scale, causal, window, softcap, ty, tx);
    __syncthreads();

    // dQ[r] += sum_c dS[r][c] K[c]
    for (int c = 0; c < BT; ++c) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = dSs[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float kv = Ks[c * LD + tx + 16 * m];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][m] += dsr[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
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

constexpr int BT_MMA = 64;       // bf16: k and q tile rows
constexpr int NT_MMA = 128;      // bf16: 4 warps x 16 tile rows

template <int HD>
constexpr size_t smem_mma() {
  return sizeof(__nv_bfloat16) * 4 * BT_MMA * (HD + 8) +
         sizeof(float) * 2 * BT_MMA;
}

// P (and dS) of one score fragment s (16 x 8 n-tiles over a 64-row tile):
// `rows_are_k` says whether the fragment's rows are keys (pass 1, S^T)
// or queries (pass 2, S).  Ls/Ds are indexed by the query within its tile.
// NT is a template argument so that the fragments stay in registers.
template <int NT>
__device__ __forceinline__ void mma_probs(float (*s)[4], float (*dp)[4],
                                          const float* Ls, const float* Ds,
                                          int row_pos0, int row_loc0,
                                          int col_pos0, bool rows_are_k,
                                          int S, int Sk, float scale,
                                          int causal, int window,
                                          float softcap) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rpos = row_pos0 + (lane >> 2) + (e >> 1) * 8;
      const int cpos = col_pos0 + t * 8 + (lane & 3) * 2 + (e & 1);
      const int qpos = rows_are_k ? cpos : rpos;
      const int kpos = rows_are_k ? rpos : cpos;
      const int qloc = rows_are_k ? t * 8 + (lane & 3) * 2 + (e & 1)
                                  : row_loc0 + (lane >> 2) + (e >> 1) * 8;
      bool ok = qpos < S && kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      const float sc = s[t][e] * scale;
      float th = 0.f, z = sc;
      if (softcap > 0.f) {
        th = tanhf(sc / softcap);
        z = th * softcap;
      }
      const float p = ok ? expf(z - Ls[qloc]) : 0.f;
      float ds = p * (dp[t][e] - Ds[qloc]);
      if (softcap > 0.f) ds *= 1.f - th * th;
      s[t][e] = p;
      dp[t][e] = ds;
    }
  }
}

// Stores a warp's 16 x HD accumulator (rows row0 + g, row0 + g + 8 of a
// (rows, stride) head view) as bf16, times `mul`.
template <int HD>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* base,
                                                long long stride,
                                                const float (*acc)[4],
                                                int row0, int rows,
                                                float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + r * 8;
    if (row >= rows) continue;
    __nv_bfloat16* out = base + static_cast<long long>(row) * stride;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + i * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[i][2 * r] * mul,
                                acc[i][2 * r + 1] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT_MMA)
    flash_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int S, int Sk, int H,
                       int K, float scale, int causal, int window,
                       float softcap) {
  constexpr int LD = HD + 8;
  constexpr int NQ = BT_MMA / 8;          // score n-tiles (q columns)
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf[];
  __nv_bfloat16* Ks = smem_bf;
  __nv_bfloat16* Vs = Ks + BT_MMA * LD;
  __nv_bfloat16* Qs = Vs + BT_MMA * LD;
  __nv_bfloat16* dOs = Qs + BT_MMA * LD;
  float* Ls = reinterpret_cast<float*>(dOs + BT_MMA * LD);
  float* Ds = Ls + BT_MMA;

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k_lo = kt * BT_MMA;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(K) * HD;
  const long long kv_off = static_cast<long long>(b) * Sk * kv_row +
                           static_cast<long long>(kh) * HD;
  load_rows_bf16<HD, BT_MMA, NT_MMA>(Ks, k + kv_off, kv_row, k_lo, Sk);
  load_rows_bf16<HD, BT_MMA, NT_MMA>(Vs, v + kv_off, kv_row, k_lo, Sk);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int nq = (S + BT_MMA - 1) / BT_MMA;
  const int qlo = causal ? min(nq, k_lo / BT_MMA) : 0;
  const int qhi = window > 0
                      ? min(nq, (k_lo + BT_MMA - 1 + window - 1) / BT_MMA + 1)
                      : nq;
  const __nv_bfloat16* ka_base = Ks + (warp * 16 + (lane & 15)) * LD +
                                 (lane >> 4) * 8;
  const __nv_bfloat16* va_base = Vs + (warp * 16 + (lane & 15)) * LD +
                                 (lane >> 4) * 8;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long q_off = static_cast<long long>(b) * S * q_row +
                            static_cast<long long>(h) * HD;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * S;
    const float* d_h = dvec + (static_cast<long long>(b) * H + h) * S;
    for (int qt = qlo; qt < qhi; ++qt) {
      const int q_lo = qt * BT_MMA;
      __syncthreads();                    // previous tile consumed
      load_rows_bf16<HD, BT_MMA, NT_MMA>(Qs, q + q_off, q_row, q_lo, S);
      load_rows_bf16<HD, BT_MMA, NT_MMA>(dOs, dout + q_off, q_row, q_lo,
                                         S);
      for (int i = threadIdx.x; i < BT_MMA; i += NT_MMA) {
        const int s = q_lo + i;
        Ls[i] = s < S ? lse_h[s] : 0.f;
        Ds[i] = s < S ? d_h[s] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 k rows x 64 q
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int t = 0; t < NQ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned ka[4], va[4];
        ldmatrix_x4(ka, ka_base + kk * 16);
        ldmatrix_x4(va, va_base + kk * 16);
#pragma unroll
        for (int jn = 0; jn < NQ / 2; ++jn) {
          const int off = (jn * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          unsigned qb4[4], ob4[4];
          ldmatrix_x4(qb4, Qs + off);
          ldmatrix_x4(ob4, dOs + off);
          mma_16816(st[2 * jn], ka, qb4[0], qb4[1]);
          mma_16816(st[2 * jn + 1], ka, qb4[2], qb4[3]);
          mma_16816(dpt[2 * jn], va, ob4[0], ob4[1]);
          mma_16816(dpt[2 * jn + 1], va, ob4[2], ob4[3]);
        }
      }
      mma_probs<NQ>(st, dpt, Ls, Ds, k_lo + warp * 16, 0, q_lo, true, S,
                    Sk, scale, causal, window, softcap);

      // dV += P^T dO and dK += dS^T Q over the tile's 64 q rows
#pragma unroll
      for (int kk = 0; kk < BT_MMA / 16; ++kk) {
        unsigned pa[4], da[4];
        c_to_a(pa, st, kk);
        c_to_a(da, dpt, kk);
#pragma unroll
        for (int dn = 0; dn < HD / 16; ++dn) {
          const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LD + dn * 16 + (lane >> 4) * 8;
          unsigned ob4[4], qb4[4];
          ldmatrix_x4_trans(ob4, dOs + off);
          ldmatrix_x4_trans(qb4, Qs + off);
          mma_16816(dv_acc[2 * dn], pa, ob4[0], ob4[1]);
          mma_16816(dv_acc[2 * dn + 1], pa, ob4[2], ob4[3]);
          mma_16816(dk_acc[2 * dn], da, qb4[0], qb4[1]);
          mma_16816(dk_acc[2 * dn + 1], da, qb4[2], qb4[3]);
        }
      }
    }
  }
  store_rows_bf16<HD>(dk + kv_off, kv_row, dk_acc, k_lo + warp * 16, Sk,
                      scale);
  store_rows_bf16<HD>(dv + kv_off, kv_row, dv_acc, k_lo + warp * 16, Sk,
                      1.f);
}

template <int HD>
__global__ void __launch_bounds__(NT_MMA)
    flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec,
                     __nv_bfloat16* __restrict__ dq, int S, int Sk, int H,
                     int K, float scale, int causal, int window,
                     float softcap) {
  constexpr int LD = HD + 8;
  constexpr int NK = BT_MMA / 8;          // score n-tiles (k columns)
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf[];
  __nv_bfloat16* Qs = smem_bf;
  __nv_bfloat16* dOs = Qs + BT_MMA * LD;
  __nv_bfloat16* Ks = dOs + BT_MMA * LD;
  __nv_bfloat16* Vs = Ks + BT_MMA * LD;
  float* Ls = reinterpret_cast<float*>(Vs + BT_MMA * LD);
  float* Ds = Ls + BT_MMA;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_lo = qt * BT_MMA;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(K) * HD;
  const long long q_off = static_cast<long long>(b) * S * q_row +
                          static_cast<long long>(h) * HD;
  const long long kv_off = static_cast<long long>(b) * Sk * kv_row +
                           static_cast<long long>(kh) * HD;
  const float* lse_h = lse + (static_cast<long long>(b) * H + h) * S;
  const float* d_h = dvec + (static_cast<long long>(b) * H + h) * S;

  load_rows_bf16<HD, BT_MMA, NT_MMA>(Qs, q + q_off, q_row, q_lo, S);
  load_rows_bf16<HD, BT_MMA, NT_MMA>(dOs, dout + q_off, q_row, q_lo, S);
  for (int i = threadIdx.x; i < BT_MMA; i += NT_MMA) {
    const int s = q_lo + i;
    Ls[i] = s < S ? lse_h[s] : 0.f;
    Ds[i] = s < S ? d_h[s] : 0.f;
  }

  float dq_acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.f;

  const int nk = (Sk + BT_MMA - 1) / BT_MMA;
  const int khi =
      causal ? min(nk, (min(q_lo + BT_MMA, S) - 1) / BT_MMA + 1) : nk;
  const int klo = window > 0 ? max(0, q_lo - window + 1) / BT_MMA : 0;
  const __nv_bfloat16* qa_base = Qs + (warp * 16 + (lane & 15)) * LD +
                                 (lane >> 4) * 8;
  const __nv_bfloat16* oa_base = dOs + (warp * 16 + (lane & 15)) * LD +
                                 (lane >> 4) * 8;

  for (int kt = klo; kt < khi; ++kt) {
    const int k_lo = kt * BT_MMA;
    __syncthreads();                      // previous tile consumed
    load_rows_bf16<HD, BT_MMA, NT_MMA>(Ks, k + kv_off, kv_row, k_lo, Sk);
    load_rows_bf16<HD, BT_MMA, NT_MMA>(Vs, v + kv_off, kv_row, k_lo, Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x 64 k
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int t = 0; t < NK; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned qa[4], oa[4];
      ldmatrix_x4(qa, qa_base + kk * 16);
      ldmatrix_x4(oa, oa_base + kk * 16);
#pragma unroll
      for (int jn = 0; jn < NK / 2; ++jn) {
        const int off = (jn * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        unsigned kb4[4], vb4[4];
        ldmatrix_x4(kb4, Ks + off);
        ldmatrix_x4(vb4, Vs + off);
        mma_16816(s[2 * jn], qa, kb4[0], kb4[1]);
        mma_16816(s[2 * jn + 1], qa, kb4[2], kb4[3]);
        mma_16816(dp[2 * jn], oa, vb4[0], vb4[1]);
        mma_16816(dp[2 * jn + 1], oa, vb4[2], vb4[3]);
      }
    }
    mma_probs<NK>(s, dp, Ls, Ds, q_lo + warp * 16, warp * 16, k_lo,
                  false, S, Sk, scale, causal, window, softcap);

    // dQ += dS K over the tile's 64 k rows
#pragma unroll
    for (int kk = 0; kk < BT_MMA / 16; ++kk) {
      unsigned da[4];
      c_to_a(da, dp, kk);
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        unsigned kb4[4];
        ldmatrix_x4_trans(kb4, Ks + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LD +
                                   dn * 16 + (lane >> 4) * 8);
        mma_16816(dq_acc[2 * dn], da, kb4[0], kb4[1]);
        mma_16816(dq_acc[2 * dn + 1], da, kb4[2], kb4[3]);
      }
    }
  }
  store_rows_bf16<HD>(dq + q_off, q_row, dq_acc, q_lo + warp * 16, S,
                      scale);
}

template <int HD>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* dvec, void* dq, void* dk, void* dv, int B,
                           int S, int Sk, int H, int K, float scale,
                           int causal, int window, float softcap,
                           cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const long long rows = static_cast<long long>(B) * S * H;
  flash_bwd_rowdot<bf16, HD>
      <<<static_cast<unsigned>((rows + NTB / 32 - 1) / (NTB / 32)), NTB, 0,
         stream>>>(static_cast<const bf16*>(o),
                   static_cast<const bf16*>(dout), dvec, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t bytes = smem_mma<HD>();

  auto dkdv = flash_bwd_dkdv_mma<HD>;
  static size_t allowed_dkdv = 48 * 1024;   // per instantiation
  err = allow_smem(dkdv, bytes, allowed_dkdv);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Sk + BT_MMA - 1) / BT_MMA, K, B), NT_MMA, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dvec,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Sk, H, K, scale,
      causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_mma<HD>;
  static size_t allowed_dq = 48 * 1024;
  err = allow_smem(dqk, bytes, allowed_dq);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((S + BT_MMA - 1) / BT_MMA, H, B), NT_MMA, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dvec,
      static_cast<bf16*>(dq), S, Sk, H, K, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_dtype(int dtype, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             const float* lse, float* dvec, void* dq,
                             void* dk, void* dv, int B, int S, int Sk, int H,
                             int K, float scale, int causal, int window,
                             float softcap, cudaStream_t s) {
  if (dtype == DT_BF16)
    return launch_bwd_mma<HD>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, S,
                              Sk, H, K, scale, causal, window, softcap, s);
  if (dtype == DT_F32)
    return launch_bwd<float, HD>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B,
                                 S, Sk, H, K, scale, causal, window, softcap,
                                 s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, Sk, K, hd); contiguous,
// one dtype.  lse: (B, H, S) float32 from the forward; dvec: (B, H, S)
// float32 scratch.  hd in {16, 32, 64, 128}.  Returns the cudaError_t of
// the launches.
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
    case 16:
      return launch_bwd_dtype<16>(dtype, q, k, v, o, dout, l, dv_, dq, dk,
                                  dv, B, S, Sk, H, K, scale, causal, window,
                                  softcap, s);
    case 32:
      return launch_bwd_dtype<32>(dtype, q, k, v, o, dout, l, dv_, dq, dk,
                                  dv, B, S, Sk, H, K, scale, causal, window,
                                  softcap, s);
    case 64:
      return launch_bwd_dtype<64>(dtype, q, k, v, o, dout, l, dv_, dq, dk,
                                  dv, B, S, Sk, H, K, scale, causal, window,
                                  softcap, s);
    case 128:
      return launch_bwd_dtype<128>(dtype, q, k, v, o, dout, l, dv_, dq, dk,
                                   dv, B, S, Sk, H, K, scale, causal, window,
                                   softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}
