// Checksum-extended float32 matmul for ABFT (algorithm-based fault
// tolerance): C_full = A_ext @ B_ext.
//
// Replaces the TPU kernel src/repro/kernels/abft_matmul/kernel.py:
// matmul_f32 (_kernel).  A_ext is A (M, K) with its column-checksum row
// a_sum (K,) appended as row M; B_ext is B (K, N) with its row-checksum
// column b_sum (K,) appended as column N; C_full is (M + 1, N + 1),
// row-major.  The checksums flow through the same multiply as the data,
// which is the point: an error in one output element shows in its row
// and column residuals (kernels/abft_matmul/ops.py).  Every element of
// C_full is held to 32 float32 ulps of its absolute mass (|A_ext| @
// |B_ext|), which a TF32 product misses.
//
// Two routes, chosen by the wrapper before launch (kernel.py: tc_route).
//
// Tensor cores (abft_wgmma; at least one operand bfloat16, every bf16
// operand readable by TMA in place).  A bf16 x bf16 product is exact in
// float32, and a float32 value x is the exact sum of three bf16 pieces
// (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); exact for
// 2^-103 <= |x| < 2^128 (1 - 2^-9), ref.split_bf16x3), so a bf16 wgmma
// with a float32 accumulator computes the same exact products as a
// float32 FFMA loop; only the accumulation rounds.  A float32 operand
// (the backward's gradient) is split by abft_split into three bf16
// planes along K, each padded to Kp = K rounded up to 64: [A_hi | A_mid |
// A_lo] (M, 3 Kp), or [B_hi; B_mid; B_lo] (3 Kp, N), with its checksum's
// planes as one more row (column) at Rx = M rounded up to 8 (Cx = N
// rounded up to 8); the bf16 partner is read three times, at k mod Kp.
// A bf16 operand is read in place, and its float32 checksum enters as
// three bf16 rows (columns) Rx..Rx+2 (Cx..Cx+2), pieces from abft_pieces
// written into the swizzled tile after its TMA load.  So the checksums
// go through the same tensor-core mainloop, in the same launch, as the
// data; the epilogue folds the three rows (columns) into row M (column
// N), (p0 + p1) + p2, and the corner likewise over rows of column folds.
// Partial sums are promoted: every kChunk = 8 k-tiles (512 k) the wgmma
// accumulator starts afresh and is added into a float32 total with
// ordinary FADDs, in k order, since the tensor cores do not round their
// internal additions as an IEEE FADD does: with the whole K in the
// accumulator dx and dw missed the bound, promoted every 1 to 8 k-tiles
// all three contractions read as the SGEMM does (PERF.md).
//
// Design: 128 x 128 output tiles, two consumer warpgroups (64 rows each,
// m64n128k16 products, both operands from shared memory, K-major or
// MN-major as the operand lies in memory) and one producer warp keeping
// a four-stage ring of 64-wide k-tiles loaded by TMA (128-byte swizzle,
// mbarrier pairs).  Tiles run with m fastest when A is the smaller
// operand (it stays in L2 while B streams once), else n fastest.  The
// epilogue stages C through the ring's shared memory and writes whole
// rows.  Bound: operations, 2 (M + 1) (N + 1) K bf16 FLOPs a plane (one
// plane for bf16 x bf16, three with a float32 operand) at the tensor
// cores' 989 TFLOP/s.
//
// CUDA cores (abft_sgemm; float32 x float32, and operands TMA cannot read:
// a base off 16 bytes or a row pitch off a multiple of 8 elements):
// the classic register-tiled SGEMM, true float32 FFMA.  A CUDA block of
// 256 threads computes a 128 x 128 tile of C, each thread an 8 x 8
// sub-tile in registers, over K in steps of 8 staged in double-buffered
// shared memory; A and B are read in place through their layouts and
// dtypes (bf16 widened in registers, which is exact), the checksum row and
// column come from their vectors, and the ragged edges are masked.
//
// Both routes sum each output element's products in one fixed order with
// no split-K and no atomics, so two identical calls give the same bits.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kThreads = 256;
constexpr int kPadA = 4;     // As rows of 132 floats: loader stores spread

template <typename T, bool kRowMajor>
__device__ __forceinline__ float load_a(const T* __restrict__ a,
                                        const float* __restrict__ a_sum,
                                        int m, int k, int M, int K,
                                        long long lda) {
  if (k >= K || m > M) return 0.f;
  if (m == M) return a_sum[k];
  return to_f32(kRowMajor ? a[m * lda + k] : a[k * lda + m]);
}

template <typename T, bool kRowMajor>
__device__ __forceinline__ float load_b(const T* __restrict__ b,
                                        const float* __restrict__ b_sum,
                                        int k, int n, int N, int K,
                                        long long ldb) {
  if (k >= K || n > N) return 0.f;
  if (n == N) return b_sum[k];
  return to_f32(kRowMajor ? b[k * ldb + n] : b[n * ldb + k]);
}

// Loads this thread's 4 elements of the A tile (rows m0.., k0..) and of
// the B tile (k0.., columns n0..) into registers.  The thread-to-element
// map follows each operand's contiguous axis, so a warp reads
// neighbouring addresses.
template <typename TA, bool kARow, typename TB, bool kBRow>
__device__ __forceinline__ void load_tiles(
    const TA* __restrict__ a, const float* __restrict__ a_sum,
    const TB* __restrict__ b, const float* __restrict__ b_sum, int M, int N,
    int K, long long lda, long long ldb, int m0, int n0, int k0, float* ra,
    float* rb) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kARow)      // k fastest: row m = t / 2, k = (t % 2) * 4 + i
      ra[i] = load_a<TA, true>(a, a_sum, m0 + (t >> 1), k0 + (t & 1) * 4 + i,
                               M, K, lda);
    else            // m fastest: k = t / 32, m = (t % 32) * 4 + i
      ra[i] = load_a<TA, false>(a, a_sum, m0 + (t & 31) * 4 + i, k0 + (t >> 5),
                                M, K, lda);
    if (kBRow)      // n fastest: k = t / 32, n = (t % 32) * 4 + i
      rb[i] = load_b<TB, true>(b, b_sum, k0 + (t >> 5), n0 + (t & 31) * 4 + i,
                               N, K, ldb);
    else            // k fastest: column n = t / 2, k = (t % 2) * 4 + i
      rb[i] = load_b<TB, false>(b, b_sum, k0 + (t & 1) * 4 + i, n0 + (t >> 1),
                                N, K, ldb);
  }
}

template <bool kARow, bool kBRow>
__device__ __forceinline__ void store_tiles(float (*as)[kBM + kPadA],
                                            float (*bs)[kBN],
                                            const float* ra,
                                            const float* rb) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kARow) as[(t & 1) * 4 + i][t >> 1] = ra[i];
    else as[t >> 5][(t & 31) * 4 + i] = ra[i];
    if (kBRow) bs[t >> 5][(t & 31) * 4 + i] = rb[i];
    else bs[(t & 1) * 4 + i][t >> 1] = rb[i];
  }
}

template <typename TA, bool kARow, typename TB, bool kBRow>
__global__ void __launch_bounds__(kThreads)
    abft_sgemm(const TA* __restrict__ a, const float* __restrict__ a_sum,
               const TB* __restrict__ b, const float* __restrict__ b_sum,
               float* __restrict__ c, int M, int N, int K, long long lda,
               long long ldb) {
  __shared__ __align__(16) float as[2][kBK][kBM + kPadA];
  __shared__ __align__(16) float bs[2][kBK][kBN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[4], rb[4];
  load_tiles<TA, kARow, TB, kBRow>(a, a_sum, b, b_sum, M, N, K, lda, ldb, m0,
                                   n0, 0, ra, rb);
  store_tiles<kARow, kBRow>(as[0], bs[0], ra, rb);
  __syncthreads();

  const int steps = (K + kBK - 1) / kBK;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps)          // next tile's loads overlap this tile's math
      load_tiles<TA, kARow, TB, kBRow>(a, a_sum, b, b_sum, M, N, K, lda, ldb,
                                       m0, n0, (s + 1) * kBK, ra, rb);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[cur][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (s + 1 < steps) {
      store_tiles<kARow, kBRow>(as[cur ^ 1], bs[cur ^ 1], ra, rb);
      __syncthreads();
    }
  }

  const long long ldc = N + 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m > M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n <= N) c[m * ldc + n] = acc[i][j];
    }
  }
}

template <typename TA, bool kARow, typename TB, bool kBRow>
cudaError_t launch(const void* a, const void* a_sum, const void* b,
                   const void* b_sum, void* c, int M, int N, int K,
                   long long lda, long long ldb, cudaStream_t s) {
  const dim3 grid((N + 1 + kBN - 1) / kBN, (M + 1 + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  abft_sgemm<TA, kARow, TB, kBRow><<<grid, kThreads, 0, s>>>(
      static_cast<const TA*>(a), static_cast<const float*>(a_sum),
      static_cast<const TB*>(b), static_cast<const float*>(b_sum),
      static_cast<float*>(c), M, N, K, lda, ldb);
  return cudaGetLastError();
}

template <typename TA, bool kARow>
cudaError_t launch_b(const void* a, const void* a_sum, const void* b,
                     const void* b_sum, void* c, int M, int N, int K,
                     long long lda, long long ldb, int b_dtype, int b_row,
                     cudaStream_t s) {
  if (b_dtype == DT_F32)
    return b_row ? launch<TA, kARow, float, true>(a, a_sum, b, b_sum, c, M, N,
                                                  K, lda, ldb, s)
                 : launch<TA, kARow, float, false>(a, a_sum, b, b_sum, c, M,
                                                   N, K, lda, ldb, s);
  if (b_dtype == DT_BF16)
    return b_row ? launch<TA, kARow, __nv_bfloat16, true>(a, a_sum, b, b_sum,
                                                          c, M, N, K, lda,
                                                          ldb, s)
                 : launch<TA, kARow, __nv_bfloat16, false>(a, a_sum, b, b_sum,
                                                           c, M, N, K, lda,
                                                           ldb, s);
  return cudaErrorInvalidValue;
}

// ---- the tensor-core route -------------------------------------------------

constexpr int TBM = 128, TBN = 128, TBK = 64, TST = 4;
constexpr int kTcThreads = 288;                  // 2 consumer warpgroups + 1 warp
constexpr uint32_t kTileBytes = 128 * TBK * 2;   // an A or a B tile: 16 KB
constexpr uint32_t kStageBytes = 2 * kTileBytes;
constexpr int kStageLd = TBN + 4;                // epilogue row, floats
constexpr int kChunk = 8;                        // k-tiles a promoted partial sum
constexpr size_t kTcSmem = 1024 + TST * kStageBytes + 16 * TST;
static_assert(TBM * kStageLd * 4 <= TST * kStageBytes, "staging fits the ring");

__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// hi, mid, lo: x = hi + mid + lo exactly (see the header)
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(r - __bfloat162float(p[1]));
}

// The float32 operand as three bf16 planes with its checksum's planes at
// index X: value v(r, k) = src[r s_r + k s_k] for r < R, sum[k] at r = X,
// 0 elsewhere (r <= X, k < Kp; 0 past K), piece j stored at dst + r d_r +
// k d_k + j d_p.  `inner` runs along src's unit stride (k when k_fast,
// else r), so both the reads and the writes are coalesced.
struct SplitArgs {
  const float* src;
  const float* sum;
  __nv_bfloat16* dst;
  long long s_r, s_k, d_r, d_k, d_p;
  int R, K, X, Kp, k_fast;
};

__global__ void __launch_bounds__(256) abft_split(const SplitArgs p) {
  const long long n_in = p.k_fast ? p.Kp : p.X + 1;
  const long long n_out = p.k_fast ? p.X + 1 : p.Kp;
  for (long long o = blockIdx.y; o < n_out; o += gridDim.y)
    for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n_in;
         i += gridDim.x * 256ll) {
      const long long r = p.k_fast ? o : i, k = p.k_fast ? i : o;
      float v = 0.f;
      if (k < p.K) {
        if (r < p.R) v = p.src[r * p.s_r + k * p.s_k];
        else if (r == p.X) v = p.sum[k];
      }
      __nv_bfloat16 q[3];
      split3(v, q);
      __nv_bfloat16* d = p.dst + r * p.d_r + k * p.d_k;
      d[0] = q[0];
      d[p.d_p] = q[1];
      d[2 * p.d_p] = q[2];
    }
}

// The pieces of a checksum read in place beside a bf16 operand: x (3, Kp),
// row j piece j of sum[k] (0 past K).  blockIdx.y: 0 a_sum, 1 b_sum.
__global__ void __launch_bounds__(256)
    abft_pieces(const float* __restrict__ sa, __nv_bfloat16* __restrict__ xa,
                const float* __restrict__ sb, __nv_bfloat16* __restrict__ xb,
                int K, int Kp) {
  const float* sum = blockIdx.y ? sb : sa;
  __nv_bfloat16* x = blockIdx.y ? xb : xa;
  if (x == nullptr) return;
  for (int k = blockIdx.x * 256 + threadIdx.x; k < Kp; k += gridDim.x * 256) {
    __nv_bfloat16 q[3];
    split3(k < K ? sum[k] : 0.f, q);
    x[k] = q[0];
    x[Kp + k] = q[1];
    x[2 * Kp + k] = q[2];
  }
}

struct TcArgs {
  float* c;                      // (M + 1, N + 1), row-major
  const __nv_bfloat16* xa;       // (3, Kp) checksum pieces of an in-place A,
  const __nv_bfloat16* xb;       // of an in-place B; null for a split side
  int M, N, Rx, Cx, nr, nc;      // checksum rows Rx.. (nr), columns Cx.. (nc)
  int Kp, kt_total, kt_plane;    // k-tiles of the product, of one plane
  int a_split, b_split;          // that side's k runs over all planes
  int m_tiles, n_tiles, m_fast;
};

// byte offset of element (r, k) of a K-major tile (rows of 64 k, 128 B),
// or of element (k, r) of an MN-major one (64 k rows of column blocks of
// 64 r, 8 KB each); 128-byte swizzle, 1024-byte aligned tiles
template <bool kKMajor>
__device__ __forceinline__ uint32_t tile_off(int r, int k) {
  if (kKMajor) return r * 128 + ((((k >> 3) ^ (r & 7))) << 4) + (k & 7) * 2;
  return (r >> 6) * 8192 + k * 128 + ((((r & 63) >> 3) ^ (k & 7)) << 4) +
         (r & 7) * 2;
}

// Writes the three checksum pieces at k-offset kp (k-tile columns 0..63)
// as tile rows (A) or columns (B) r0..r0+2; `tid` 0..255 over the
// consumer threads.
template <bool kKMajor>
__device__ __forceinline__ void patch_tile(uint8_t* tile,
                                           const __nv_bfloat16* x, int Kp,
                                           int kp, int r0, int tid) {
  for (int i = tid; i < 3 * TBK; i += 256) {
    const int j = i / TBK, k = i % TBK;
    *reinterpret_cast<__nv_bfloat16*>(tile + tile_off<kKMajor>(r0 + j, k)) =
        x[j * Kp + kp + k];
  }
}

__device__ __forceinline__ float fold3(const float* v, int stride, int n) {
  return n == 1 ? v[0] : (v[0] + v[stride]) + v[2 * stride];
}

// kAK / kBK: the A / B tiles are K-major (else MN-major)
template <bool kAK, bool kBK>
__global__ void __launch_bounds__(kTcThreads, 1)
    abft_wgmma(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, const TcArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t s0 = smem_u32(smem);
  const uint32_t bars = s0 + TST * kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (TST + s); };

  const int bid = blockIdx.x;
  const int mt = p.m_fast ? bid % p.m_tiles : bid / p.n_tiles;
  const int nt = p.m_fast ? bid / p.m_tiles : bid % p.n_tiles;
  const int m0 = mt * TBM, n0 = nt * TBN;
  const int KT = p.kt_total;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);                // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;           // 2: the producer warp
  if (wg == 2) {
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % TST;
        const uint32_t sa = s0 + s * kStageBytes, sb = sa + kTileBytes;
        mbar_wait(empty(s), ((kt / TST) & 1) ^ 1);
        mbar_expect_tx(full(s), kStageBytes);
        const int kp = (kt % p.kt_plane) * TBK;
        const int ka = p.a_split ? kt * TBK : kp;
        const int kb = p.b_split ? kt * TBK : kp;
        if (kAK) {
          tma_load_2d(sa, &ta, ka, m0, full(s));
        } else {
          tma_load_2d(sa, &ta, m0, ka, full(s));
          tma_load_2d(sa + 8192, &ta, m0 + 64, ka, full(s));
        }
        if (kBK) {
          tma_load_2d(sb, &tb, kb, n0, full(s));
        } else {
          tma_load_2d(sb, &tb, n0, kb, full(s));
          tma_load_2d(sb + 8192, &tb, n0 + 64, kb, full(s));
        }
      }
      // the consumers' last releases: a consumer that never arrives makes
      // this wait trap instead of leaving the launch hung
      for (int kt = KT; kt < KT + TST; ++kt)
        mbar_wait(empty(kt % TST), ((kt / TST) & 1) ^ 1);
    }
    return;
  }

  const int tid = threadIdx.x;               // 0..255
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  // does this tile hold the checksum rows of an in-place A, or columns
  // of an in-place B?  (uniform across the block)
  const bool patch_a = p.xa != nullptr && p.Rx >= m0 && p.Rx < m0 + TBM;
  const bool patch_b = p.xb != nullptr && p.Cx >= n0 && p.Cx < n0 + TBN;

  float acc[64];                             // the chunk's partial sum
  float tot[64];                             // the promoted total
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 64; ++e) tot[e] = 0.f;

  int done = 0;                              // k-tiles released
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % TST;
    const uint32_t sa = s0 + s * kStageBytes, sb = sa + kTileBytes;
    mbar_wait(full(s), (kt / TST) & 1);
    if (patch_a || patch_b) {
      const int kp = (kt % p.kt_plane) * TBK;
      if (patch_a)
        patch_tile<kAK>(smem + s * kStageBytes, p.xa, p.Kp, kp, p.Rx - m0,
                        tid);
      if (patch_b)
        patch_tile<kBK>(smem + s * kStageBytes + kTileBytes, p.xb, p.Kp, kp,
                        p.Cx - n0, tid);
      fence_proxy_async();
      named_bar_sync(1, 256);
    }
    // K-major: rows of 128 B, 8-row groups at 1024 B, a k-step of 16
    // elements 32 B into the row; MN-major: column blocks of 64 at LBO
    // 8 KB, 8 k-rows at 1024 B, a k-step of 16 rows 2 KB
    const uint64_t da = opaque(make_desc(
        kAK ? sa + 64 * wg * 128 : sa + wg * 8192, kAK ? 16 : 8192, 1024, 1));
    const uint64_t db = opaque(make_desc(sb, kBK ? 16 : 8192, 1024, 1));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      const int first = kk == 0 && kt % kChunk == 0;
      wgmma_ss_n128_t<kAK ? 0 : 1, kBK ? 0 : 1>(
          acc, da + ((kAK ? 32 * kk : 2048 * kk) >> 4),
          db + ((kBK ? 32 * kk : 2048 * kk) >> 4), !first);
    }
    wgmma_commit();
    int ready;                               // k-tiles whose products are done
    if ((kt + 1) % kChunk == 0 || kt + 1 == KT) {
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < 64; ++e) tot[e] += acc[e];
      ready = kt + 1;
    } else {
      wgmma_wait<1>();
      ready = kt;
    }
    for (; done < ready; ++done) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(done % TST));
    }
  }
  // The last chunk waited for every product already; this wait and fence
  // (with acc and tot zeroed in separate loops) keep ptxas's schedule:
  // without both the mainloop ran 15 % slower (PERF.md).
  wgmma_wait<0>();
  fence_regs(acc);
  for (; done < KT; ++done) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(done % TST));
  }

  // epilogue: both warpgroups are past the ring, which now stages the tile
  named_bar_sync(1, 256);
  float* st = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + 16 * warp + g + 8 * h, cc = 8 * j + 2 * t;
        const int e = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(st + r * kStageLd + cc) =
            make_float2(tot[e], tot[e + 1]);
      }
  }
  named_bar_sync(2 + wg, 128);               // this warpgroup's rows staged
  const long long ldc = static_cast<long long>(p.N) + 1;
  const int rx = p.Rx - m0, cx = p.Cx - n0;
  const bool has_cx = cx >= 0 && cx < TBN;
  for (int r = 64 * wg + warp; r < 64 * wg + 64; r += 4) {
    const int m = m0 + r;
    const float* row = st + r * kStageLd;
    if (m < p.M) {
      float* out = p.c + m * ldc;
      for (int cc = lane; cc < TBN && n0 + cc < p.N; cc += 32)
        out[n0 + cc] = row[cc];
      if (has_cx && lane == 0) out[p.N] = fold3(row + cx, 1, p.nc);
    } else if (r == rx) {                    // the checksum row M
      float* out = p.c + p.M * ldc;
      for (int cc = lane; cc < TBN && n0 + cc < p.N; cc += 32)
        out[n0 + cc] = fold3(row + cc, kStageLd, p.nr);
      if (has_cx && lane == 0) {
        float f[3];
        for (int i = 0; i < p.nr; ++i)
          f[i] = fold3(row + i * kStageLd + cx, 1, p.nc);
        out[p.N] = fold3(f, 1, p.nr);
      }
    }
  }
}

template <bool kAK, bool kBK>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                         const TcArgs& args, cudaStream_t s) {
  auto kernel = abft_wgmma<kAK, kBK>;
  static size_t allowed = 48 * 1024;     // per instantiation
  cudaError_t err = allow_smem(kernel, kTcSmem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(args.m_tiles) * args.n_tiles, kTcThreads,
           kTcSmem, s>>>(ta, tb, args);
  return cudaGetLastError();
}

// the scratch of the tensor-core route, in bytes from its base: the split
// planes of a float32 operand, then the (3, Kp) pieces of the in-place
// checksums (each region 256-byte aligned)
struct TcLayout {
  int Kp, Rx, Cx;
  long long ld3;                 // row pitch of the planes (at offset 0)
  long long xa, xb, bytes;
};

TcLayout tc_layout(int M, int N, int K, int a_dtype, int b_dtype) {
  TcLayout l;
  l.Kp = static_cast<int>(round_up(K, TBK));
  l.Rx = static_cast<int>(round_up(M, 8));
  l.Cx = static_cast<int>(round_up(N, 8));
  long long n = 0;
  if (a_dtype == DT_F32) {               // [A_hi | A_mid | A_lo], Rx + 1 rows
    l.ld3 = 3ll * l.Kp;
    n = (l.Rx + 1ll) * l.ld3;
  } else if (b_dtype == DT_F32) {        // [B_hi; B_mid; B_lo], Cx + 1 columns
    l.ld3 = l.Cx + 8ll;
    n = 3ll * l.Kp * l.ld3;
  } else {
    l.ld3 = 0;
  }
  long long at = round_up(2 * n, 256);
  l.xa = a_dtype == DT_BF16 ? at : -1;
  if (l.xa >= 0) at = round_up(at + 6ll * l.Kp, 256);
  l.xb = b_dtype == DT_BF16 ? at : -1;
  if (l.xb >= 0) at = round_up(at + 6ll * l.Kp, 256);
  l.bytes = at;
  return l;
}

bool tma_ok(const void* base, long long ld) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && ld % 8 == 0;
}

cudaError_t launch_tc(const void* a, const void* a_sum, const void* b,
                      const void* b_sum, void* c, void* scratch, int M, int N,
                      int K, long long lda, long long ldb, int a_dtype,
                      int a_row, int b_dtype, int b_row, cudaStream_t s) {
  const bool a_split = a_dtype == DT_F32, b_split = b_dtype == DT_F32;
  if ((a_dtype != DT_F32 && a_dtype != DT_BF16) ||
      (b_dtype != DT_F32 && b_dtype != DT_BF16) || (a_split && b_split) ||
      M <= 0 || N <= 0 || K <= 0 || (!a_split && !tma_ok(a, lda)) ||
      (!b_split && !tma_ok(b, ldb)))
    return cudaErrorInvalidValue;
  const TcLayout l = tc_layout(M, N, K, a_dtype, b_dtype);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  auto* planes = reinterpret_cast<__nv_bfloat16*>(base);
  auto* xa = a_split ? nullptr
                     : reinterpret_cast<__nv_bfloat16*>(base + l.xa);
  auto* xb = b_split ? nullptr
                     : reinterpret_cast<__nv_bfloat16*>(base + l.xb);
  const auto* fa = static_cast<const float*>(a_sum);
  const auto* fb = static_cast<const float*>(b_sum);

  if (a_split || b_split) {
    SplitArgs sp;
    sp.dst = planes;
    sp.K = K;
    sp.Kp = l.Kp;
    if (a_split) {                       // v(m, k) of A; planes along columns
      sp.src = static_cast<const float*>(a);
      sp.sum = fa;
      sp.s_r = a_row ? lda : 1;
      sp.s_k = a_row ? 1 : lda;
      sp.d_r = l.ld3;
      sp.d_k = 1;
      sp.d_p = l.Kp;
      sp.R = M;
      sp.X = l.Rx;
    } else {                             // v(n, k) of B; planes along rows
      sp.src = static_cast<const float*>(b);
      sp.sum = fb;
      sp.s_r = b_row ? 1 : ldb;
      sp.s_k = b_row ? ldb : 1;
      sp.d_r = 1;
      sp.d_k = l.ld3;
      sp.d_p = l.Kp * l.ld3;
      sp.R = N;
      sp.X = l.Cx;
    }
    sp.k_fast = sp.s_k == 1;
    const long long n_in = sp.k_fast ? l.Kp : sp.X + 1ll;
    const long long n_out = sp.k_fast ? sp.X + 1ll : l.Kp;
    const dim3 grid(static_cast<unsigned>(std::min<long long>(
                        (n_in + 255) / 256, 1024)),
                    static_cast<unsigned>(std::min<long long>(n_out, 65535)));
    abft_split<<<grid, 256, 0, s>>>(sp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  abft_pieces<<<dim3((l.Kp + 255) / 256, 2), 256, 0, s>>>(fa, xa, fb, xb, K,
                                                          l.Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  TcArgs args;
  args.c = static_cast<float*>(c);
  args.xa = xa;
  args.xb = xb;
  args.M = M;
  args.N = N;
  args.Rx = l.Rx;
  args.Cx = l.Cx;
  args.nr = a_split ? 1 : 3;
  args.nc = b_split ? 1 : 3;
  args.Kp = l.Kp;
  args.kt_plane = l.Kp / TBK;
  args.kt_total = (a_split || b_split ? 3 : 1) * args.kt_plane;
  args.a_split = a_split;
  args.b_split = b_split;
  args.m_tiles = static_cast<int>((l.Rx + args.nr + TBM - 1) / TBM);
  args.n_tiles = static_cast<int>((l.Cx + args.nc + TBN - 1) / TBN);
  // A's bytes against B's: the smaller one is read again by each wave
  const double a_bytes = a_split ? (l.Rx + 1.0) * l.ld3 : 1.0 * M * K;
  const double b_bytes = b_split ? 3.0 * l.Kp * (l.Cx + 1.0) : 1.0 * K * N;
  args.m_fast = a_bytes <= b_bytes;
  if (static_cast<long long>(args.m_tiles) * args.n_tiles >= (1ll << 31))
    return cudaErrorInvalidValue;

  CUtensorMap ta, tb;
  const bool ak = a_split || a_row, bk = !b_split && !b_row;
  if (a_split)
    err = matrix_map(&ta, planes, l.ld3, l.Rx + 1ll, l.ld3, TBM);
  else if (a_row)
    err = matrix_map(&ta, a, K, M, lda, TBM);
  else
    err = matrix_map(&ta, a, M, K, lda, 64);
  if (err != cudaSuccess) return err;
  if (b_split)
    err = matrix_map(&tb, planes, l.Cx + 1ll, 3ll * l.Kp, l.ld3, 64);
  else if (b_row)
    err = matrix_map(&tb, b, N, K, ldb, 64);
  else
    err = matrix_map(&tb, b, K, N, ldb, TBN);
  if (err != cudaSuccess) return err;
  if (ak && bk) return launch_wgmma<true, true>(ta, tb, args, s);
  if (ak) return launch_wgmma<true, false>(ta, tb, args, s);
  if (bk) return launch_wgmma<false, true>(ta, tb, args, s);
  return launch_wgmma<false, false>(ta, tb, args, s);
}

}  // namespace

// Scratch bytes the tensor-core route needs for this product (the wrapper
// allocates them; 0 is never returned for a valid route-1 product).
extern "C" long long repro_abft_scratch_bytes(int M, int N, int K,
                                              int a_dtype, int b_dtype) {
  return tc_layout(M, N, K, a_dtype, b_dtype).bytes;
}

// a: A (M, K), element (m, k) at a[m * lda + k] when a_row, else at
// a[k * lda + m]; b: B (K, N), element (k, n) at b[k * ldb + n] when
// b_row, else at b[n * ldb + k]; dtypes 0 float32, 1 bfloat16.
// a_sum: (K,) float32, row M of A_ext; b_sum: (K,) float32, column N of
// B_ext.  c: (M + 1, N + 1) float32, row-major, fully written.
// route 0: the CUDA-core SGEMM (any operands; scratch unused); route 1:
// the tensor cores (at least one bf16 operand, each bf16 one with a
// 16-byte aligned base and ld a multiple of 8; M, N, K > 0), scratch of
// repro_abft_scratch_bytes bytes, 256-byte aligned.  Returns the
// cudaError_t of the launches.
extern "C" int repro_abft_matmul(const void* a, const void* a_sum,
                                 const void* b, const void* b_sum, void* c,
                                 void* scratch, int M, int N, int K,
                                 long long lda, long long ldb, int a_dtype,
                                 int a_row, int b_dtype, int b_row,
                                 int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
  if (route == 1)
    return launch_tc(a, a_sum, b, b_sum, c, scratch, M, N, K, lda, ldb,
                     a_dtype, a_row, b_dtype, b_row, s);
  if (route != 0) return cudaErrorInvalidValue;
  if (a_dtype == DT_F32)
    return a_row ? launch_b<float, true>(a, a_sum, b, b_sum, c, M, N, K, lda,
                                         ldb, b_dtype, b_row, s)
                 : launch_b<float, false>(a, a_sum, b, b_sum, c, M, N, K, lda,
                                          ldb, b_dtype, b_row, s);
  if (a_dtype == DT_BF16)
    return a_row ? launch_b<__nv_bfloat16, true>(a, a_sum, b, b_sum, c, M, N,
                                                 K, lda, ldb, b_dtype, b_row,
                                                 s)
                 : launch_b<__nv_bfloat16, false>(a, a_sum, b, b_sum, c, M, N,
                                                  K, lda, ldb, b_dtype, b_row,
                                                  s);
  return cudaErrorInvalidValue;
}
