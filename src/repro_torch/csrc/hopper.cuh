// Hopper building blocks shared by the bf16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu) and the ABFT product
// (abft_matmul.cu), the cp.async rings of rmsnorm.cu and
// paged_attention.cu, and the rings of the selective scan and its
// backward: TMA tile loads into a
// 128/64/32-byte swizzled shared layout, mbarrier rings, wgmma products
// with fp32 accumulation, and the host-side encoding of the tensor maps.
//
// Shared tiles.  A (rows x hd) bf16 tile is stored as NA = hd / SW
// column blocks of SW = min(hd, 64) elements; block a holds rows of RB =
// 2 SW bytes at offset a * rows * RB, with TMA's swizzle of the same width
// (16-byte chunk c of row r lands at chunk c ^ (r % (RB / 16)); every tile
// starts 1024-byte aligned).  wgmma reads such a tile two ways:
//   * K-major (the reduction runs along hd: Q, K, V, dO as the operands of
//     Q K^T, K Q^T, dO V^T, V dO^T): rows at RB bytes, 8-row groups at
//     SBO = 8 RB; a k-step of 16 elements advances the start address by
//     32 bytes inside the swizzle row (descriptor's LBO unused);
//   * MN-major (the reduction runs along the rows: V in P V, dO and Q in
//     P^T dO and dS^T Q, K in dS K; the `trans-b` flag): 8-row groups along
//     the reduction at SBO = 8 RB, column blocks along hd at LBO = rows x RB;
//     a k-step of 16 rows advances the start address by 16 RB.
// (PTX ISA, "Matrix Descriptor Format"; the canonical layouts of
// cute/atom/mma_traits_sm90_gmma.hpp.)
//
// Fragments.  A warpgroup's m64nN fp32 accumulator d[N / 2] holds, for
// warp w, lane = 4 g + t and n-tile j = e / 4: row 16 w + g (+ 8 when
// e & 2) and column 8 j + 2 t (+ 1 when e & 1) — the mma.sync C layout
// repeated over N / 8 n-tiles.  The register A operand of an m64k16 step
// is the mma.sync A layout, so the fp32 accumulator of one product,
// rounded to bf16 and packed in pairs, is the A operand of the next
// (acc_to_a).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_LOG2E 1.4426950408889634f
#define REPRO_LN2 0.6931471805599453f

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (swizzled tiles need it; the
// launchers request 1024 bytes of slack)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- cp.async: 16-byte copies into shared memory, in commit groups -----------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- cp.async: 4-byte copies completing on an mbarrier (the scan rings) ------

// 4 bytes from global to shared, or 4 zero bytes when !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// the mbarrier at `bar` takes one arrival of this thread once all of its
// earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// K consecutive floats of shared memory: one load of 4 K bytes (K <= 4),
// or K / 4 loads of 16 bytes
template <int K>
__device__ __forceinline__ void load_vec(float* r, const float* p) {
  if constexpr (K == 1) {
    r[0] = *p;
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x;
      r[i + 1] = v.y;
      r[i + 2] = v.z;
      r[i + 3] = v.w;
    }
  }
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrives once and adds `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A barrier that
// does not complete within ~2^35 clocks (~17 s) is a bug in the ring:
// trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (int n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 64) start = clock64();
    if (n > 64 && (n & 1023) == 0 && clock64() - start > (1ll << 35))
      __trap();
  }
}

// ---- TMA ----------------------------------------------------------------------

// box (c0, c1, c2) of a 3-D tensor map into shared memory at `dst`,
// completing `bytes` (the full box) on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// box (c0, c1, c2, c3) of a 4-D tensor map into shared memory at `dst`,
// completing `bytes` (the full box) on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// box (c0, c1) of a 2-D tensor map into shared memory at `dst`, completing
// `bytes` (the full box) on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Makes this thread's ordinary stores to shared memory visible to the
// asynchronous proxy (wgmma operands, TMA); a barrier after it hands them
// to the other threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned ends) from global to shared
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- warpgroups ---------------------------------------------------------------

// barrier `id` (1-15; 0 is __syncthreads) over `n` threads
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- wgmma --------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After wgmma_wait: the registers an asynchronous product wrote (or read)
// are touched here, so that the compiler neither reads them before the
// wait nor reuses them while the product is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// x, opaque to the compiler (neither hoisted nor folded)
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// descriptor of a shared-memory operand (byte address, byte offsets)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// geometry of a (rows x HD) swizzled tile
template <int HD>
struct Tile {
  static constexpr int SW = HD < 64 ? HD : 64;   // elements a swizzle row
  static constexpr int RB = 2 * SW;              // bytes a swizzle row
  static constexpr int NA = HD / SW;             // column blocks
  static constexpr int CH = RB / 16;             // 16-byte chunks a row
  // descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint32_t LAYOUT = RB == 128 ? 1u : RB == 64 ? 2u : 3u;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr __host__ __device__ int bytes(int rows) {
    return rows * HD * 2;
  }

  // Descriptors are built once a tile from the operand's first row (the
  // base passes through an empty asm, so that the compiler keeps one
  // 64-bit base live instead of hoisting every k-step's descriptor out of
  // the loop), and a k-step adds its compile-time byte offset to the start
  // address field (addresses stay below 2^18: no carry out of the field).
  //
  // K-major operand whose rows start at `addr` (row r0 of a tile: tile +
  // r0 RB); k-step kk covers elements 16 kk .. 16 kk + 15 of hd
  static __device__ __forceinline__ uint64_t kdesc(uint32_t addr) {
    return opaque(make_desc(addr, 16, 8 * RB, LAYOUT));
  }
  static __device__ __forceinline__ uint64_t kstep(uint64_t d, int R,
                                                   int kk) {
    const int e = 16 * kk;
    return d + static_cast<uint64_t>(((e / SW) * R * RB + (e % SW) * 2) >> 4);
  }
  // MN-major operand (N = HD) of a tile of R rows at `tile`; k-step kk
  // covers rows 16 kk .. 16 kk + 15
  static __device__ __forceinline__ uint64_t mndesc(uint32_t tile, int R) {
    return opaque(make_desc(tile, R * RB, 8 * RB, LAYOUT));
  }
  static __device__ __forceinline__ uint64_t mnstep(uint64_t d, int kk) {
    return d + static_cast<uint64_t>((kk * 16 * RB) >> 4);
  }
  // byte offset of element pair (r, c), c even, of a 64-row slice (rows of
  // one warpgroup) staged for a 16-byte-store epilogue: the same column
  // blocks, chunk c / 8 of row r at chunk (c / 8) ^ (r % CH)
  static __device__ __forceinline__ uint32_t stage_off(int R, int r, int c) {
    const int a = c / SW, cc = c % SW;
    return a * R * RB + r * RB + (((cc >> 3) ^ (r % CH)) << 4) + (cc & 7) * 2;
  }
};

// the A operand of k-step kk from an m64nN accumulator (columns 16 kk ..
// 16 kk + 15), rounded to bf16
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

template <int N>
__device__ __forceinline__ void acc_to_a(unsigned (&a)[N / 16][4],
                                         const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// 2^x.  The bf16 kernels take softmax in base 2 on scores pre-multiplied
// by log2(e), with the hardware's ex2.approx (max relative error ~2^-22):
// P is rounded to bf16 (8 bits) before it meets V or dO, and the LSE goes
// back to natural log once a row (m2 + log2 l) ln 2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copies a warpgroup's staged 64-row slice (rows r0 .. r0 + 63 of the
// output, slice at shared `slice` in a tile of R rows) to global rows of
// stride `ld` elements, 16 bytes a thread a step; rows at or past `rows`
// are not written, nor columns at or past NC (a head of NC < HD
// elements, padded to HD in shared memory).  `tid` is the thread's index
// in its warpgroup.
template <int HD, int NC = HD>
__device__ __forceinline__ void store_slice(__nv_bfloat16* __restrict__ out,
                                            long long ld, const uint8_t* slice,
                                            int R, int r0, int rows,
                                            int tid) {
  using T = Tile<HD>;
  static_assert(NC % 8 == 0 && NC <= HD, "store_slice: NC");
  constexpr int CPR = NC / 8;                    // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < 64 * CPR; i += 128) {
    const int r = i / CPR, c = (i % CPR) * 8;
    if (r0 + r >= rows) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        slice + T::stage_off(R, r, c));
    *reinterpret_cast<uint4*>(out + (r0 + r) * ld + c) = v;
  }
}

// Writes a warpgroup's m64nHD accumulator, times `mul`, as bf16 into its
// staged slice (see store_slice).
template <int HD>
__device__ __forceinline__ void stage_acc(uint8_t* slice, int R,
                                          const float (&d)[HD / 2],
                                          float mul) {
  using T = Tile<HD>;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(
          slice + T::stage_off(R, r, 8 * j + 2 * t)) =
          __floats2bfloat162_rn(d[4 * j + 2 * h] * mul,
                                d[4 * j + 2 * h + 1] * mul);
    }
}

// ---- host: tensor maps -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a bf16 (B, rows, heads, hd) tensor read in place as
// 4-D (hd, heads, rows, B), boxes of (SW, 1, box_rows, 1) into a tile of
// HD >= hd columns: TMA zero-fills a box past `rows` (a ragged tile stops
// at its sequence's end) and the columns from hd to the box's end, so a
// head of hd = 80 lands as a 128-wide tile whose last 48 columns are 0.
template <int HD>
static inline cudaError_t head_map4(CUtensorMap* map, const void* base, int B,
                                    int rows, int heads, int hd,
                                    int box_rows) {
  using T = Tile<HD>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = 2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {hd * e, hd * e * heads, hd * e * heads * rows};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(T::SW), 1u,
                       static_cast<cuuint32_t>(box_rows), 1u};
  cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, T::SWIZZLE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a bf16 matrix read in place: `outer` rows of `inner`
// elements, rows `ld` elements apart (ld * 2 a multiple of 16, the base
// 16-byte aligned), boxes of (64, box_outer) elements with the 128-byte
// swizzle (a box row is one swizzle row).  TMA zero-fills a box past
// either extent.
static inline cudaError_t matrix_map(CUtensorMap* map, const void* base,
                                     long long inner, long long outer,
                                     long long ld, int box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                        static_cast<cuuint64_t>(outer)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  cuuint32_t box[2] = {64u, static_cast<cuuint32_t>(box_outer)};
  cuuint32_t elem[2] = {1u, 1u};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a float32 (d0, d1, d2) tensor read in place, rows of
// d0 elements s1 bytes apart, planes s2 bytes apart (both multiples of
// 16), boxes of (box0, box1, 1) without swizzle; TMA zero-fills a box
// past any extent.  The selective scan's operands.
static inline cudaError_t f32_map(CUtensorMap* map, const void* base,
                                  long long d0, long long d1, long long d2,
                                  long long s1, long long s2, int box0,
                                  int box1) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                        static_cast<cuuint64_t>(d1),
                        static_cast<cuuint64_t>(d2)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1),
                           static_cast<cuuint64_t>(s2)};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(box0),
                       static_cast<cuuint32_t>(box1), 1u};
  cuuint32_t elem[3] = {1u, 1u, 1u};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                  const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

static inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// ---- wgmma products (m64nNk16, bf16 in, fp32 accumulate) ------------------------
// d (64 x 64 fp32) = (scale_d ? d : 0) + A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 fp32) = (scale_d ? d : 0) + A (64 x 16, shared) * B (16 x 128,
// shared); TA / TB = 1 when that operand's tile is MN-major (the transpose
// flags), 0 when it is K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128_t(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// both operands K-major: d = (scale_d ? d : 0) + A * B^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_ss_n128_t<0, 0>(d, da, db, scale_d);
}

// d (64 x 16 fp32) += A (64 x 16 bf16, registers) * B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32 fp32) += A (64 x 16 bf16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const unsigned (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_rs: N is 16, 32, 64 or 128");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// d (m64nHD fp32) += A (64 x 16, registers) * B (16 x HD, shared, MN-major;
// a tile of R rows): one product, or at HD 256 one of 128 columns per half
// of the accumulator (a wgmma's N is at most 256, and n128 keeps the
// instruction's operand list at the size the others have)
template <int HD, int R>
__device__ __forceinline__ void wgmma_rs_wide(float (&d)[HD / 2],
                                              const unsigned (&a)[4],
                                              uint64_t db) {
  if constexpr (HD <= 128) {
    wgmma_rs<HD>(d, a, db);
  } else {
#pragma unroll
    for (int half = 0; half < HD / 128; ++half)
      wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(&d[64 * half]), a,
                    db + ((half * 2 * R * Tile<HD>::RB) >> 4));
  }
}
