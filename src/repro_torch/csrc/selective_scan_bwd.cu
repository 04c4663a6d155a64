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
// (S * Di * N a row, 0.13 ms on the SFUs).  This first version is simple
// and right, not fast:
//   - a thread owns one (channel, state) of one batch row: a block is 32
//     channels x NS threads (NS = N rounded up to a power of two), the
//     states of a channel in NS neighbouring lanes;
//   - pass 1 runs the forward recurrence over the whole sequence and
//     stores the state at the start of every 32-step chunk (global
//     scratch, read back by the same thread);
//   - pass 2 walks the chunks backwards: it recomputes the chunk's states
//     from its saved start into registers, then runs the reverse scan
//     over the chunk.  The recompute uses the forward kernel's arithmetic
//     (ex2 of dt * fl32(A log2 e), the same roundings and fused
//     multiply-adds), so its states are the forward's bits;
//   - sums over a channel's states (u_t, sum_n q_t A) are fixed shuffle
//     butterflies; dB and dC are summed over the warp's channels by
//     shuffles, over the block's warps in warp order, and over the
//     blocks by a second kernel in block order; dA over the batch rows in
//     row order (a thread sums its own steps in reverse time).  No
//     atomics: two launches on the same inputs give the same bits.
// Steps past S and channels past Di read zeros (dt = x = dy = B = C = 0:
// the state and r pass through unchanged and add nothing); states past N
// have A = B = C = 0 and stay zero.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kChan = 32;      // channels a block
constexpr int kQ = 32;         // steps a chunk
constexpr int kMaxState = 16;  // the forward kernel's limit

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
  float* hsave;  // (B, nk, Di, N): the state before each chunk
  float* pdb;    // (ncb, B, S, N): each block's dB over its channels
  float* pdc;    // (ncb, B, S, N): likewise dC
  float* pda;    // (B, Di, N): dA of each batch row
  int B, S, Di, N;
  long long b_sb, b_ss, c_sb, c_ss;
};

// shared floats of a block with NS threads a channel
constexpr int smem_floats(int ns) {
  return 5 * kQ * kChan + 2 * kQ * ns + 2 * kQ * ns * ns;
}

template <int NS>
__global__ void __launch_bounds__(kChan * NS)
    selective_scan_bwd_kernel(const BwdArgs p) {
  constexpr int kThreads = kChan * NS;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float smem[];
  float* s_dt = smem;                     // [kQ][kChan] the chunk's inputs
  float* s_x = s_dt + kQ * kChan;
  float* s_dy = s_x + kQ * kChan;
  float* s_dx = s_dy + kQ * kChan;        // [kQ][kChan] its outputs
  float* s_ddt = s_dx + kQ * kChan;
  float* s_b = s_ddt + kQ * kChan;        // [kQ][NS]
  float* s_c = s_b + kQ * NS;
  float* s_pb = s_c + kQ * NS;            // [kQ][kWarps][NS] warp sums
  float* s_pc = s_pb + kQ * kWarps * NS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = tid % NS;
  const int ch = tid / NS;                // the channel in the block
  const int b = blockIdx.y, cb = blockIdx.x;
  const int c0 = cb * kChan, c = c0 + ch;
  const int S = p.S, Di = p.Di, N = p.N;
  const int nc = min(kChan, Di - c0);
  const bool live = ch < nc && n < N;
  const int nk = (S + kQ - 1) / kQ;
  const long long row = static_cast<long long>(b) * S * Di;
  const long long sn = (static_cast<long long>(b) * Di + c) * N + n;
  auto saved = [&](int k) {
    return p.hsave + ((static_cast<long long>(b) * nk + k) * Di + c) * N + n;
  };

  const float a = live ? p.A[static_cast<long long>(c) * N + n] : 0.f;
  const float a2 = __fmul_rn(a, REPRO_LOG2E);

  // chunk k's dt, x (and dy), B (and C) into shared memory, zeros past S,
  // Di and N
  auto load = [&](int k, bool grads) {
    const int t0 = k * kQ;
    for (int i = tid; i < kQ * kChan; i += kThreads) {
      const int u = i / kChan, q = i % kChan, t = t0 + u;
      const bool ok = t < S && q < nc;
      const long long g = row + static_cast<long long>(t) * Di + c0 + q;
      s_dt[i] = ok ? p.dt[g] : 0.f;
      s_x[i] = ok ? p.x[g] : 0.f;
      if (grads) s_dy[i] = ok ? p.dy[g] : 0.f;
    }
    for (int i = tid; i < kQ * NS; i += kThreads) {
      const int u = i / NS, m = i % NS, t = t0 + u;
      const bool ok = t < S && m < N;
      s_b[i] = ok ? p.bm[b * p.b_sb + t * p.b_ss + m] : 0.f;
      if (grads) s_c[i] = ok ? p.cm[b * p.c_sb + t * p.c_ss + m] : 0.f;
    }
  };

  // one forward step: the forward kernel's arithmetic
  auto step = [&](int u, float h, float& e) {
    const float d = s_dt[u * kChan + ch];
    const float dxv = __fmul_rn(d, s_x[u * kChan + ch]);
    e = ex2(__fmul_rn(d, a2));
    return __fmaf_rn(e, h, __fmul_rn(dxv, s_b[u * NS + n]));
  };

  // pass 1: the state before every chunk
  float h = live ? p.h0[sn] : 0.f;
  for (int k = 0; k < nk; ++k) {
    if (live) *saved(k) = h;
    __syncthreads();  // the previous chunk is read
    load(k, false);
    __syncthreads();
#pragma unroll 8
    for (int u = 0; u < kQ; ++u) {
      float e;
      h = step(u, h, e);
    }
  }

  // pass 2: the chunks in reverse, each recomputed, then scanned back
  float r = (live && p.dh_last != nullptr) ? p.dh_last[sn] : 0.f;
  float da = 0.f;
  for (int k = nk - 1; k >= 0; --k) {
    const int t0 = k * kQ;
    __syncthreads();  // the previous chunk's outputs are stored
    load(k, true);
    const float h_in = live ? *saved(k) : 0.f;
    __syncthreads();
    float hs[kQ], es[kQ];
    h = h_in;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      h = step(u, h, es[u]);
      hs[u] = h;
    }
#pragma unroll
    for (int u = kQ - 1; u >= 0; --u) {
      const float d = s_dt[u * kChan + ch];
      const float xv = s_x[u * kChan + ch];
      const float dyv = s_dy[u * kChan + ch];
      const float g = __fmaf_rn(s_c[u * NS + n], dyv, r);
      float pc = __fmul_rn(dyv, hs[u]);
      float pb = __fmul_rn(g, __fmul_rn(d, xv));
      float s1 = __fmul_rn(g, s_b[u * NS + n]);
      const float hp = u > 0 ? hs[u - 1] : h_in;
      const float q = __fmul_rn(__fmul_rn(g, hp), es[u]);
      da = __fmaf_rn(q, d, da);
      float s2 = __fmul_rn(q, a);
      r = __fmul_rn(es[u], g);
      // over the channel's states: a fixed butterfly in its NS lanes
#pragma unroll
      for (int off = NS / 2; off >= 1; off /= 2) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      // over the warp's channels (lanes NS apart)
#pragma unroll
      for (int off = 16; off >= NS; off /= 2) {
        pb += __shfl_xor_sync(0xffffffffu, pb, off);
        pc += __shfl_xor_sync(0xffffffffu, pc, off);
      }
      if (n == 0) {
        s_dx[u * kChan + ch] = __fmul_rn(s1, d);
        s_ddt[u * kChan + ch] = __fmaf_rn(s1, xv, s2);
      }
      if (lane < NS) {
        s_pb[(u * kWarps + warp) * NS + n] = pb;
        s_pc[(u * kWarps + warp) * NS + n] = pc;
      }
    }
    __syncthreads();
    // the chunk's dx and ddt in rows; the block's dB and dC, its warps'
    // sums added in warp order
    for (int i = tid; i < kQ * kChan; i += kThreads) {
      const int u = i / kChan, q = i % kChan, t = t0 + u;
      if (t < S && q < nc) {
        const long long g = row + static_cast<long long>(t) * Di + c0 + q;
        p.dx[g] = s_dx[i];
        p.ddt[g] = s_ddt[i];
      }
    }
    for (int i = tid; i < kQ * NS; i += kThreads) {
      const int u = i / NS, m = i % NS, t = t0 + u;
      if (t < S && m < N) {
        float sb = s_pb[u * kWarps * NS + m];
        float sc = s_pc[u * kWarps * NS + m];
        for (int w = 1; w < kWarps; ++w) {
          sb += s_pb[(u * kWarps + w) * NS + m];
          sc += s_pc[(u * kWarps + w) * NS + m];
        }
        const long long o =
            ((static_cast<long long>(cb) * p.B + b) * S + t) * N + m;
        p.pdb[o] = sb;
        p.pdc[o] = sc;
      }
    }
  }
  if (live) {
    p.dh0[sn] = r;
    p.pda[sn] = da;
  }
}

// dB and dC: the blocks' sums in block order; dA: the batch rows' sums in
// row order (blockIdx.y 0, 1, 2)
__global__ void selective_scan_bwd_reduce(const float* pdb, const float* pdc,
                                          const float* pda, float* db,
                                          float* dc, float* da, int ncb,
                                          long long nbsn, int B,
                                          long long dn) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (blockIdx.y < 2) {
    if (i >= nbsn) return;
    const float* src = blockIdx.y == 0 ? pdb : pdc;
    float s = src[i];
    for (int k = 1; k < ncb; ++k) s += src[k * nbsn + i];
    (blockIdx.y == 0 ? db : dc)[i] = s;
  } else {
    if (i >= dn) return;
    float s = pda[i];
    for (int k = 1; k < B; ++k) s += pda[k * dn + i];
    da[i] = s;
  }
}

template <int NS>
cudaError_t launch(const BwdArgs& a, cudaStream_t s) {
  static size_t allowed = 48 * 1024;
  auto kernel = selective_scan_bwd_kernel<NS>;
  const size_t smem = sizeof(float) * smem_floats(NS);
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Di + kChan - 1) / kChan, a.B);
  kernel<<<grid, kChan * NS, smem, s>>>(a);
  return cudaGetLastError();
}

// NS: N rounded up to a power of two
template <int NS = 1>
cudaError_t dispatch(const BwdArgs& a, cudaStream_t s) {
  if constexpr (NS < kMaxState) {
    if (a.N > NS) return dispatch<2 * NS>(a, s);
  }
  return launch<NS>(a, s);
}

long long chunks(int S) { return (S + kQ - 1) / kQ; }
long long blocks(int Di) { return (Di + kChan - 1) / kChan; }

}  // namespace

// Dynamic shared memory of a launch at state size N (for the record).
extern "C" int repro_selective_scan_bwd_smem(int N) {
  int ns = 1;
  while (ns < N) ns *= 2;
  return static_cast<int>(sizeof(float)) * smem_floats(ns);
}

// Scratch floats a launch needs (the wrapper allocates them): the saved
// chunk states, the blocks' dB and dC, the rows' dA.
extern "C" long long repro_selective_scan_bwd_scratch(int B, int S, int Di,
                                                      int N) {
  const long long bdn = static_cast<long long>(B) * Di * N;
  const long long bsn = static_cast<long long>(B) * S * N;
  return bdn * chunks(S) + 2 * blocks(Di) * bsn + bdn;
}

// The forward's operands (x, dt contiguous (B, S, Di); bm, cm (B, S, N)
// with unit stride along N and the given batch / time strides; A (Di, N);
// h0 (B, Di, N)), dy (B, S, Di) and dh_last (B, Di, N, or null for zero),
// all float32.  Writes dx, ddt (B, S, Di), dbm, dcm (B, S, N) contiguous,
// dA (Di, N) and dh0 (B, Di, N); `scratch` holds
// repro_selective_scan_bwd_scratch(B, S, Di, N) floats.
extern "C" int repro_selective_scan_bwd(
    const void* x, const void* dt, const void* bm, const void* cm,
    const void* A, const void* h0, const void* dy, const void* dh_last,
    void* dx, void* ddt, void* dbm, void* dcm, void* dA, void* dh0,
    void* scratch, int B, int S, int Di, int N, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Di <= 0 || N <= 0) return cudaSuccess;
  if (N > kMaxState || B > 65535 || S < 0) return cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  const long long bdn = static_cast<long long>(B) * Di * N;
  const long long bsn = static_cast<long long>(B) * S * N;
  const long long ncb = blocks(Di);
  BwdArgs a{static_cast<const float*>(x),  static_cast<const float*>(dt),
            static_cast<const float*>(bm), static_cast<const float*>(cm),
            static_cast<const float*>(A),  static_cast<const float*>(h0),
            static_cast<const float*>(dy),
            static_cast<const float*>(dh_last),
            static_cast<float*>(dx),       static_cast<float*>(ddt),
            static_cast<float*>(dh0),
            sc,                            sc + bdn * chunks(S),
            sc + bdn * chunks(S) + ncb * bsn,
            sc + bdn * chunks(S) + 2 * ncb * bsn,
            B, S, Di, N, b_sb, b_ss, c_sb, c_ss};
  cudaError_t err = dispatch(a, s);
  if (err != cudaSuccess) return err;
  const long long dn = static_cast<long long>(Di) * N;
  const long long most = bsn > dn ? bsn : dn;
  const dim3 grid(static_cast<unsigned>((most + 255) / 256), 3);
  selective_scan_bwd_reduce<<<grid, 256, 0, s>>>(
      a.pdb, a.pdc, a.pda, static_cast<float*>(dbm), static_cast<float*>(dcm),
      static_cast<float*>(dA), static_cast<int>(ncb), bsn, B, dn);
  return cudaGetLastError();
}
