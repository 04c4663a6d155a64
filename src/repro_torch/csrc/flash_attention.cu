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
// Bound on the H100 at prefill shapes: bytes at S = 288 (q, k, v, o read
// or written once: 5.9 MB against 0.68 GFLOP of unmasked q.k pairs at
// 32 heads of 128), operations from S of about 750 up.  Design: one block
// per (64-row q tile, q head, batch); kv tiles of 64 rows stream through
// shared memory only up to the causal bound of the q tile (and from the
// window's lower bound); the softmax state (m, l) and the output
// accumulator stay in registers in fp32.
//
// bfloat16 (the serving path) runs on the tensor cores: 4 warps of 16 q
// rows each; S = Q K^T and O += P V are mma.sync m16n8k16 products with
// fp32 accumulation, fed by ldmatrix from padded (conflict-free) shared
// tiles; P is rounded to bf16 for the second product, as the plain
// version rounds it.  The scale multiplies the fp32 scores (the TPU kernel
// scales q in fp32 before its dot; the two differ by fp32 rounding).
// float32 runs on the CUDA cores (4 threads per q row, operands in shared
// memory), for the small float32 configurations; wgmma/TMA tiles are
// later work.
//
// Ragged tails are masked, not asserted: S and Sk need not be multiples of
// the tile.  Masked scores get p = 0 explicitly, so a tile that is fully
// masked for a row leaves that row's state bit-for-bit unchanged — a
// row's result does not depend on S or on the other rows of its tile.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;          // float32: 4 threads per q row
constexpr int CPT = BK / 4;      // float32: score columns per thread
constexpr int NT_MMA = 128;      // bfloat16: 4 warps x 16 q rows

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

template <int HD>
constexpr size_t smem_bytes_mma() {
  return sizeof(__nv_bfloat16) * 3 * BQ * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(NT_MMA)
    flash_fwd_bf16_mma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int S, int Sk, int H, int K,
                       float scale, int causal, int window, float softcap) {
  constexpr int LD = HD + 8;            // padded row: ldmatrix conflict-free
  constexpr int KS = HD / 16;           // k-steps of Q K^T
  constexpr int NS = BK / 8;            // score n-tiles per warp
  constexpr int ND = HD / 8;            // output n-tiles per warp
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf[];
  __nv_bfloat16* Qs = smem_bf;
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_lo = qt * BQ;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(K) * HD;
  const __nv_bfloat16* qb = q + static_cast<long long>(b) * S * q_row +
                            static_cast<long long>(h) * HD;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * Sk * kv_row +
                            static_cast<long long>(kh) * HD;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * Sk * kv_row +
                            static_cast<long long>(kh) * HD;

  load_rows_bf16<HD, BQ, NT_MMA>(Qs, qb, q_row, q_lo, S);
  __syncthreads();
  unsigned qa[KS][4];                   // this warp's 16 q rows, A operand
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);

  // this thread's two rows of the warp's 16: r0 and r0 + 8
  const int row0 = q_lo + warp * 16 + (lane >> 2);
  const int rows[2] = {row0, row0 + 8};
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int nk = (Sk + BK - 1) / BK;
  int hi = nk;
  if (causal) hi = min(nk, (min(q_lo + BQ, S) - 1) / BK + 1);
  const int lo = window > 0 ? max(0, q_lo - window + 1) / BK : 0;

  for (int j = lo; j < hi; ++j) {
    const int k_lo = j * BK;
    __syncthreads();            // previous tile consumed
    load_rows_bf16<HD, BK, NT_MMA>(Ks, kb, kv_row, k_lo, Sk);
    load_rows_bf16<HD, BK, NT_MMA>(Vs, vb, kv_row, k_lo, Sk);
    __syncthreads();

    float sc[NS][4];
#pragma unroll
    for (int t = 0; t < NS; ++t)
      sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jn = 0; jn < NS / 2; ++jn) {
        unsigned kb4[4];
        ldmatrix_x4(kb4, Ks + (jn * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                             kk * 16 + ((lane >> 3) & 1) * 8);
        mma_16816(sc[2 * jn], qa[kk], kb4[0], kb4[1]);
        mma_16816(sc[2 * jn + 1], qa[kk], kb4[2], kb4[3]);
      }
    }

    unsigned ok_bits = 0u;              // bit 4 * t + e: score (t, e) kept
    float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
    for (int t = 0; t < NS; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = rows[e >> 1];
        const int kpos = k_lo + t * 8 + (lane & 3) * 2 + (e & 1);
        float s = sc[t][e] * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        sc[t][e] = ok ? s : REPRO_NEG_INF;
        ok_bits |= (ok ? 1u : 0u) << (4 * t + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][e]);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int t = 0; t < NS; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok_bits >> (4 * t + e)) & 1u
                            ? expf(sc[t][e] - m[e >> 1]) : 0.f;
        sc[t][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned pa[4];
      c_to_a(pa, sc, kk);
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        unsigned vb4[4];
        ldmatrix_x4_trans(vb4, Vs + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LD +
                                   dn * 16 + (lane >> 4) * 8);
        mma_16816(acc[2 * dn], pa, vb4[0], vb4[1]);
        mma_16816(acc[2 * dn + 1], pa, vb4[2], vb4[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<long long>(b) * H + h) * S + rows[r]] =
          m[r] + logf(l[r]);
    __nv_bfloat16* orow = o + static_cast<long long>(b) * S * q_row +
                          rows[r] * q_row + static_cast<long long>(h) * HD;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int Sk, int H, int K,
                       float scale, int causal, int window, float softcap,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_bf16_mma<HD>;
  const size_t bytes = smem_bytes_mma<HD>();
  static size_t allowed = 48 * 1024;     // per instantiation
  cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT_MMA, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, S, Sk, H, K, scale, causal, window, softcap);
  return cudaGetLastError();
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

template <int HD>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, void* o, float* lse, int B, int S,
                         int Sk, int H, int K, float scale, int causal,
                         int window, float softcap, cudaStream_t s) {
  if (dtype == DT_BF16)
    return launch_mma<HD>(q, k, v, o, lse, B, S, Sk, H, K, scale, causal,
                          window, softcap, s);
  if (dtype == DT_F32)
    return launch<float, HD>(q, k, v, o, lse, B, S, Sk, H, K, scale, causal,
                             window, softcap, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, Sk, K, hd); contiguous, one dtype.
// lse: (B, H, S) float32, the log-sum-exp of each row's (scaled, capped)
// scores for the backward, or null (serving).  hd in {16, 32, 64, 128}.
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
    case 128: return launch_dtype<128>(dtype, q, k, v, o, l, B, S, Sk, H, K, scale, causal, window, softcap, s);
    default: return cudaErrorInvalidValue;
  }
}
