// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * w, fp32 math, stored
// in x's dtype; and its backward (below), which the TPU kernel never had.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py:rms_norm_2d.
//
// Bound on the H100: memory at the train shape ((4096, 4096): each row
// read and written once, a few operations a byte); latency at the serve
// shape ((8, 4096): 64 KB, 41.6 ns of memory time, far below one launch).
// Design (rmsnorm_row_kernel): one block of 256 threads a row; each
// thread loads its NC 16-byte chunks of w and then of x (chunk c of the
// row at thread c % 256, NC = D / (256 V) rounded up to 1, 2, 4 or 8, V
// elements a chunk) into registers with one read, so all its loads are in
// flight together; the fp32 sum of squares is reduced by warp shuffles,
// one barrier publishes the eight warp sums, and every warp adds them in
// the same order itself; then y is computed from the registers.  The
// reduction order depends on D alone, so a row's bits do not depend on
// the number of rows.  Rows of more than 2048 chunks, or whose length is
// not a multiple of V, take rmsnorm_kernel (two passes over the row, a
// block reduction with two barriers), chosen by D before the launch.
// Both are launched with programmatic dependent launch (common.cuh):
// each waits for the previous kernel before it reads x or w or writes y,
// then lets the next kernel launch.
// The TPU kernel's `rows = ROWS if R % ROWS == 0 else 1` tiling is a VMEM
// artifact and does not carry over: every row is its own block.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  __shared__ float total;
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = warp_sum(lane < kWarps ? warp_sums[lane] : 0.f);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

// NC 16-byte chunks a thread, the whole row in registers.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_row_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ y, float* __restrict__ rstd, int D,
                       float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float warp_sums[kWarps];
  const int nch = D / V;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row = blockIdx.x;
  const uint4* wc = reinterpret_cast<const uint4*>(w);
  const uint4* xc = reinterpret_cast<const uint4*>(x) + row * nch;
  uint4* yc = reinterpret_cast<uint4*>(y) + row * nch;

  griddep_wait();
  griddep_launch_dependents();
  uint4 wv[NC], xv[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = tid + j * kThreads;
    wv[j] = c < nch ? wc[c] : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = tid + j * kThreads;
    xv[j] = c < nch ? xc[c] : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const T* e = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float f = to_f32(e[k]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) total += warp_sums[k];
  const float r = rsqrtf(total / static_cast<float>(D) + eps);
  // the training path keeps r for the backward; serving passes null
  if (rstd != nullptr && tid == 0) rstd[row] = r;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = tid + j * kThreads;
    if (c >= nch) continue;
    const T* xe = reinterpret_cast<const T*>(&xv[j]);
    const T* we = reinterpret_cast<const T*>(&wv[j]);
    uint4 out;
    T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < V; ++k)
      oe[k] = from_f32<T>((to_f32(xe[k]) * r) * to_f32(we[k]));
    yc[c] = out;
  }
}

// Any D: two passes over the row (the second from L1/L2).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, float* __restrict__ rstd, int D,
                   float eps) {
  constexpr int V = 16 / sizeof(T);
  const T* xr = x + static_cast<long long>(blockIdx.x) * D;
  T* yr = y + static_cast<long long>(blockIdx.x) * D;
  // the wrapper passes 16-byte aligned base pointers; rows stay aligned
  // when D is a multiple of the vector width
  const bool vec = (D % V) == 0;

  griddep_wait();
  griddep_launch_dependents();
  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * V; i < D; i += kThreads * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* xv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(xv[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = block_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  if (rstd != nullptr && threadIdx.x == 0) rstd[blockIdx.x] = r;

  if (vec) {
    for (int i = threadIdx.x * V; i < D; i += kThreads * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const uint4 wraw = *reinterpret_cast<const uint4*>(w + i);
      const T* xv = reinterpret_cast<const T*>(&raw);
      const T* wv = reinterpret_cast<const T*>(&wraw);
      uint4 out;
      T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        ov[j] = from_f32<T>((to_f32(xv[j]) * r) * to_f32(wv[j]));
      *reinterpret_cast<uint4*>(yr + i) = out;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads)
      yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
  }
}

template <typename T>
cudaError_t launch_fwd(const void* xp, const void* wp, void* yp, void* rp,
                       int rows, int D, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  T* y = static_cast<T*>(yp);
  float* rstd = static_cast<float*>(rp);
  const int nch = D / V;
  const dim3 grid(rows), block(kThreads);
  if (D % V == 0) {
    if (nch <= kThreads)
      return launch_kernel(true, rmsnorm_row_kernel<T, 1>, grid, block, 0,
                           s, x, w, y, rstd, D, eps);
    if (nch <= 2 * kThreads)
      return launch_kernel(true, rmsnorm_row_kernel<T, 2>, grid, block, 0,
                           s, x, w, y, rstd, D, eps);
    if (nch <= 4 * kThreads)
      return launch_kernel(true, rmsnorm_row_kernel<T, 4>, grid, block, 0,
                           s, x, w, y, rstd, D, eps);
    if (nch <= 8 * kThreads)
      return launch_kernel(true, rmsnorm_row_kernel<T, 8>, grid, block, 0,
                           s, x, w, y, rstd, D, eps);
  }
  return launch_kernel(true, rmsnorm_kernel<T>, grid, block, 0, s, x, w, y,
                       rstd, D, eps);
}

}  // namespace

// x, y: (rows, D) contiguous; w: (D,), all of one dtype; rstd: (rows,)
// float32 or null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rmsnorm_fwd(const void* x, const void* w, void* y,
                                 void* rstd, int rows, int D, float eps,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (dtype == DT_BF16)
    return launch_fwd<__nv_bfloat16>(x, w, y, rstd, rows, D, eps, s);
  if (dtype == DT_F32)
    return launch_fwd<float>(x, w, y, rstd, rows, D, eps, s);
  return cudaErrorInvalidValue;
}

// Programmatic dependent launch on (1, the default) or off for every
// launch of the library that asks for it: for measurements.
extern "C" void repro_set_pdl(int on) { pdl_flag() = on != 0; }

// ---------------------------------------------------------------------------
// Backward.  With g = dL/dy and r = rsqrt(mean(x^2) + eps) per row:
//   dx = r * (g * w) - x * r^3 * mean(g * w * x)
//   dw = sum over rows of g * x * r
// r comes from the forward's saved rstd (the serving path passes no rstd
// and runs no backward).
//
// Bound: memory, g and x read once and dx written once (3 R D elements;
// w, rstd and dw are small).  Design: one fused pass.  A block owns a
// fixed group of kRowsPerGroup rows, so the number of groups is a function
// of R alone (the same partial sums, and so the same dw bits, on any
// card).  Each thread owns fixed 16-byte chunks of the columns (NC of
// them, w kept in registers) and keeps their dw sums in float32
// registers over the group's rows.  The rows stream through a ring in
// shared memory by cp.async, several steps ahead of the arithmetic (16
// chunks of g and of x a thread in flight); a step's RP rows share one
// block reduction of their dot products (warp shuffles, then the warps'
// sums in a fixed order), and each step's rstd is loaded a step ahead,
// so no load waits behind a step's barrier.  Each group writes
// its dw partial row; rmsnorm_bwd_dw_reduce_kernel adds the partials in a
// fixed association.  No float atomics: two identical calls give the same
// bits.
// ---------------------------------------------------------------------------
namespace {

constexpr int kRowsPerGroup = 32;
constexpr int kBwdThreads = 256;
constexpr int kPartsPerSlice = 8;      // the reduce: dw partials a thread sums

template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

// Rows of a step (RP) and steps in flight (ST) for NC chunks a thread:
// RP * NC * ST = 16 chunks of g and 16 of x a thread in flight (128 KB of
// shared memory a block), at least two stages.
template <int NC>
struct BwdRing {
  static constexpr int RP = NC >= 4 ? 1 : 4 / NC;
  static constexpr int ST = 16 / (RP * NC);
  static constexpr size_t bytes = 2ull * ST * RP * NC * kBwdThreads * 16;
};

// V: elements a chunk (16 bytes, or 1 when the rows are not 16-byte
// multiples); NC: chunks a thread (chunk c of a row at thread c % 256).
// 16-byte chunks stream through a ring in shared memory by cp.async, ST
// steps deep: each thread copies and reads back its own chunks, so the
// ring needs no barrier, and the loads of the next steps stay in flight
// through a step's reduction.  1-element chunks (odd D) are read from
// global memory where they are used.
template <typename T, int V, int NC>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_fused(const T* __restrict__ g, const T* __restrict__ x,
                      const T* __restrict__ w, const float* __restrict__ rstd,
                      T* __restrict__ dx, float* __restrict__ partial,
                      int rows, int D) {
  using C = Chunk<T, V>;
  constexpr bool kRing = sizeof(C) == 16;
  constexpr int RP = BwdRing<NC>::RP, ST = BwdRing<NC>::ST;
  constexpr int NW = kBwdThreads / 32;
  extern __shared__ uint4 ring[];               // [ST][RP][2][NC][threads]
  __shared__ float red[2][RP][NW];
  const int nch = D / V;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kRowsPerGroup;
  const int r1 = min(rows, r0 + kRowsPerGroup);
  const int steps = (r1 - r0 + RP - 1) / RP;
  const C* gc = reinterpret_cast<const C*>(g);
  const C* xc = reinterpret_cast<const C*>(x);
  C* dxc = reinterpret_cast<C*>(dx);

  // chunk j of row i of step s, of g (t = 0) or x (t = 1)
  auto slot = [&](int s, int i, int t, int j) -> uint4* {
    return ring + ((((s % ST) * RP + i) * 2 + t) * NC + j) * kBwdThreads +
           tid;
  };
  auto chunk = [&](int s, int i, int t, int j) -> C {
    if constexpr (kRing) {
      return *reinterpret_cast<const C*>(slot(s, i, t, j));
    } else {
      const long long off =
          static_cast<long long>(r0 + s * RP + i) * nch + tid + j * kBwdThreads;
      return t == 0 ? gc[off] : xc[off];
    }
  };
  auto issue = [&](int s) {
    if constexpr (kRing) {
      if (s < steps)
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const int row = r0 + s * RP + i, c = tid + j * kBwdThreads;
            if (row < r1 && c < nch) {
              const long long off = static_cast<long long>(row) * nch + c;
              cp_async16(smem_u32(slot(s, i, 0, j)), gc + off);
              cp_async16(smem_u32(slot(s, i, 1, j)), xc + off);
            }
          }
      cp_async_commit();                      // one group a step, maybe empty
    }
  };

  C wv[NC];
  float dw[NC][V];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = tid + j * kBwdThreads;
    if (c < nch) wv[j] = reinterpret_cast<const C*>(w)[c];
#pragma unroll
    for (int e = 0; e < V; ++e) dw[j][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(s);
  float rs[RP];                               // this step's rstd
#pragma unroll
  for (int i = 0; i < RP; ++i) rs[i] = r0 + i < r1 ? rstd[r0 + i] : 0.f;
  for (int s = 0; s < steps; ++s) {
    issue(s + ST - 1);                        // into the slot of step s - 1
    if constexpr (kRing) cp_async_wait<ST - 1>();
    const int row0 = r0 + s * RP;
    float rs_next[RP];                        // the next step's, in flight
#pragma unroll
    for (int i = 0; i < RP; ++i)
      rs_next[i] = row0 + RP + i < r1 ? rstd[row0 + RP + i] : 0.f;
    float dot[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      dot[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (row0 + i < r1 && tid + j * kBwdThreads < nch) {
          const C gv = chunk(s, i, 0, j), xv = chunk(s, i, 1, j);
#pragma unroll
          for (int e = 0; e < V; ++e)
            dot[i] += to_f32(gv.v[e]) * to_f32(wv[j].v[e]) * to_f32(xv.v[e]);
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
      if (lane == 0) red[s & 1][i][warp] = dot[i];
    }
    // one barrier a step: the buffer written here is written again two
    // steps on, after every thread has passed the next step's barrier
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int row = row0 + i;
      if (row >= r1) continue;
      float total = 0.f;
#pragma unroll
      for (int k = 0; k < NW; ++k) total += red[s & 1][i][k];
      const float r = rs[i];
      const float cf = r * r * r * (total / static_cast<float>(D));
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tid + j * kBwdThreads;
        if (c >= nch) continue;
        const C gv = chunk(s, i, 0, j), xv = chunk(s, i, 1, j);
        C out;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float gf = to_f32(gv.v[e]), xf = to_f32(xv.v[e]);
          out.v[e] = from_f32<T>(r * (gf * to_f32(wv[j].v[e])) - xf * cf);
          dw[j][e] += gf * xf * r;
        }
        dxc[static_cast<long long>(row) * nch + c] = out;
      }
    }
#pragma unroll
    for (int i = 0; i < RP; ++i) rs[i] = rs_next[i];
  }
  float* part = partial + static_cast<long long>(blockIdx.x) * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = tid + j * kBwdThreads;
    if (c < nch)
#pragma unroll
      for (int e = 0; e < V; ++e) part[c * V + e] = dw[j][e];
  }
}

// dw = the sum of the groups' partials, in one fixed association that
// depends on the partials alone: slice s sums partials 8 s .. 8 s + 7 in
// order, thread ty of a column adds its slices s = ty, ty + 8, ... in
// order, and the column's eight thread sums are added in order.  Zero
// partials appended at the end (a batch cut at a group boundary, padded
// back) leave dw's bits unchanged.  A block: 32 columns x 8 slice lanes.
template <typename T>
__global__ void __launch_bounds__(256)
    rmsnorm_bwd_dw_reduce_kernel(const float* __restrict__ partial,
                                 T* __restrict__ dw, int nparts, int D) {
  __shared__ float sums[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (col < D) {
    for (int s0 = ty * kPartsPerSlice; s0 < nparts;
         s0 += 8 * kPartsPerSlice) {
      float v[kPartsPerSlice];
#pragma unroll
      for (int p = 0; p < kPartsPerSlice; ++p)
        v[p] = s0 + p < nparts
                   ? partial[static_cast<long long>(s0 + p) * D + col]
                   : 0.f;
      float slice = v[0];
#pragma unroll
      for (int p = 1; p < kPartsPerSlice; ++p) slice += v[p];
      acc += slice;
    }
  }
  sums[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < D) {
    float total = sums[0][tx];
#pragma unroll
    for (int k = 1; k < 8; ++k) total += sums[k][tx];
    dw[col] = from_f32<T>(total);
  }
}

template <typename T, int V, int NC>
cudaError_t launch_nc(const T* g, const T* x, const T* w, const float* rstd,
                      T* dx, float* partial, int rows, int D,
                      cudaStream_t s) {
  auto kernel = rmsnorm_bwd_fused<T, V, NC>;
  // the ring only for 16-byte chunks
  const size_t bytes = V * sizeof(T) == 16 ? BwdRing<NC>::bytes : 0;
  static size_t allowed = 48 * 1024;      // per instantiation
  cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return err;
  const int groups = (rows + kRowsPerGroup - 1) / kRowsPerGroup;
  kernel<<<groups, kBwdThreads, bytes, s>>>(g, x, w, rstd, dx, partial, rows,
                                            D);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_fused(const T* g, const T* x, const T* w,
                         const float* rstd, T* dx, float* partial, int rows,
                         int D, cudaStream_t s) {
  const int nch = D / V;
  if (nch <= kBwdThreads)
    return launch_nc<T, V, 1>(g, x, w, rstd, dx, partial, rows, D, s);
  if (nch <= 2 * kBwdThreads)
    return launch_nc<T, V, 2>(g, x, w, rstd, dx, partial, rows, D, s);
  if (nch <= 4 * kBwdThreads)
    return launch_nc<T, V, 4>(g, x, w, rstd, dx, partial, rows, D, s);
  if (nch <= 8 * kBwdThreads)
    return launch_nc<T, V, 8>(g, x, w, rstd, dx, partial, rows, D, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const void* w,
                       const void* rstd, void* dx, void* dw, void* partial,
                       int rows, int D, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* rs = static_cast<const float*>(rstd);
  T* dxt = static_cast<T*>(dx);
  float* part = static_cast<float*>(partial);
  // the wrapper passes 16-byte aligned bases; rows stay aligned when D
  // is a multiple of the vector width
  cudaError_t err =
      D % V == 0 ? launch_fused<T, V>(gt, xt, wt, rs, dxt, part, rows, D, s)
                 : launch_fused<T, 1>(gt, xt, wt, rs, dxt, part, rows, D, s);
  if (err != cudaSuccess) return err;
  const int nparts = (rows + kRowsPerGroup - 1) / kRowsPerGroup;
  rmsnorm_bwd_dw_reduce_kernel<T><<<(D + 31) / 32, 256, 0, s>>>(
      part, static_cast<T*>(dw), nparts, D);
  return cudaGetLastError();
}

}  // namespace

// Number of float32 partial rows the backward needs as scratch: the
// wrapper allocates (repro_rmsnorm_bwd_parts(rows), D).
extern "C" int repro_rmsnorm_bwd_parts(int rows) {
  return (rows + kRowsPerGroup - 1) / kRowsPerGroup;
}

// g, x, dx: (rows, D); w, dw: (D,), all of one dtype; rstd: (rows,)
// float32 from the forward; partial: (repro_rmsnorm_bwd_parts(rows), D)
// float32 scratch.  D up to 2048 chunks of 16 bytes (16384 bf16, 8192
// float32), or 2048 when D is not a multiple of 16 bytes; larger D is
// refused (cudaErrorInvalidValue).
extern "C" int repro_rmsnorm_bwd(const void* g, const void* x, const void* w,
                                 const void* rstd, void* dx, void* dw,
                                 void* partial, int rows, int D, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return cudaSuccess;
  if (dtype == DT_BF16)
    return launch_bwd<__nv_bfloat16>(g, x, w, rstd, dx, dw, partial, rows,
                                     D, s);
  if (dtype == DT_F32)
    return launch_bwd<float>(g, x, w, rstd, dx, dw, partial, rows, D, s);
  return cudaErrorInvalidValue;
}
