// Checksum-extended float32 matmul for ABFT (algorithm-based fault
// tolerance): C_full = A_ext @ B_ext.
//
// Replaces the TPU kernel src/repro/kernels/abft_matmul/kernel.py:
// matmul_f32 (_kernel).  A_ext is A (M, K) with its column-checksum row
// a_sum (K,) appended as row M; B_ext is B (K, N) with its row-checksum
// column b_sum (K,) appended as column N; C_full is (M + 1, N + 1),
// row-major.  The checksums flow through the same multiply as the data,
// which is the point: an error in one output element shows in its row
// and column residuals (kernels/abft_matmul/ops.py).
//
// Bound on the H100: operations.  2 (M + 1) (N + 1) K float32 FLOPs on the
// CUDA cores (67 TFLOP/s on the SXM part); true float32 FFMA, no TF32,
// since the residuals are held to 1e-4 of the rows' L1 mass and TF32
// rounding would flag clean products.  Design: the classic register-tiled
// SGEMM.  A CUDA block of 256 threads computes a 128 x 128 tile of C, each
// thread an 8 x 8 sub-tile in registers (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise by tx), over K in steps of 8 staged
// in double-buffered shared memory (A stored k-major, so both operands are
// read as float4 broadcasts).  Each output element sums its K products in
// one fixed order with no split-K and no atomics, so two identical calls
// give the same bits.  A and B are read in place through their layouts
// (row- or column-major) and dtypes (float32, or bfloat16 widened in
// registers, which is exact), so the backward's transposed operands and
// the bf16 weights need no copy; the checksum row and column come from
// their vectors, and the ragged edges are masked (no padding).
#include <stdint.h>

#include "common.cuh"

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

}  // namespace

// a: A (M, K), element (m, k) at a[m * lda + k] when a_row, else at
// a[k * lda + m]; b: B (K, N), element (k, n) at b[k * ldb + n] when
// b_row, else at b[n * ldb + k]; dtypes 0 float32, 1 bfloat16.
// a_sum: (K,) float32, row M of A_ext; b_sum: (K,) float32, column N of
// B_ext.  c: (M + 1, N + 1) float32, row-major, fully written.
// Returns the cudaError_t of the launch.
extern "C" int repro_abft_matmul(const void* a, const void* a_sum,
                                 const void* b, const void* b_sum, void* c,
                                 int M, int N, int K, long long lda,
                                 long long ldb, int a_dtype, int a_row,
                                 int b_dtype, int b_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
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
