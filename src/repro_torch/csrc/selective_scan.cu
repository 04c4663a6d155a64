// Mamba-1 selective scan, float32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per channel d, state n)
//   y_t = sum_n C_t[n] * h_t[n]
// with h_{-1} = h0; returns y (B, S, Di) and h_last = h_{S-1} (B, Di, N).
//
// Replaces the TPU kernel
// src/repro/kernels/selective_scan/kernel.py:selective_scan_kernel.
//
// Bound on the H100: the exponentials and the bytes, about equally.  At
// the serve shape (B 1, S 256, Di 8192, N 16) the kernel must read x and
// dt and write y (25 MB, plus A, h0 and h_last), ~8 us at 3.35 TB/s, and
// compute S * Di * N = 33.5 M exponentials, ~8 us on the SFUs (16 a clock
// on each of 132 SMs).  The TPU kernel's (B, channel blocks, time chunks)
// grid keeps the state in VMEM between sequential grid steps; blocks on
// the card run in no order, so the time loop lives inside the block and
// the state lives in registers for the whole sequence:
//   - a block owns kChan channels of one batch row; each channel is owned
//     by kLanes neighbouring threads, each holding NPL = ceil(N / kLanes)
//     states (N split over lanes: at B 1, Di 8192 this gives 256 blocks
//     of 128 threads rather than 64 blocks with a thread per channel);
//   - a tile of kT time steps of x and dt (coalesced along Di) and of B
//     and C (shared by every channel, read through their strides in
//     place) is staged in shared memory, then every thread steps through
//     it (four steps unrolled: only h chains from step to step); y is
//     gathered in shared memory and stored coalesced;
//   - y_t is summed over a lane's states in increasing n, then across the
//     kLanes lanes by shuffles (lane 0 + lane 1, lane 2 + lane 3, then
//     the two pairs);
//   - ragged S and Di are masked, and N up to kLanes * 4 = 16 is
//     supported (states past N are zero-padded and stay zero).
// No fast math: expf is IEEE-accurate to 2 ulp, as torch.exp on the card.
#include "common.cuh"

namespace {

constexpr int kLanes = 4;      // threads per channel
constexpr int kChan = 32;      // channels per block
constexpr int kThreads = kLanes * kChan;
constexpr int kT = 64;         // time steps per shared-memory tile
constexpr int kMaxNPL = 4;     // states per lane: N <= 16
static_assert(kT * kChan % kThreads == 0 && kT * kLanes % kThreads == 0,
              "the staging loops divide the tile evenly");

template <int NPL>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ A,
                          const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ h_last,
                          int S, int Di, int N, long long b_sb,
                          long long b_ss, long long c_sb, long long c_ss) {
  constexpr int NP = kLanes * NPL;  // states padded to the lanes
  __shared__ float sx[kT][kChan];
  __shared__ float sdt[kT][kChan];
  __shared__ float sy[kT][kChan];
  __shared__ __align__(16) float sB[kT][NP];
  __shared__ __align__(16) float sC[kT][NP];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChan;
  const int cl = threadIdx.x / kLanes;       // channel within the block
  const int sub = threadIdx.x % kLanes;      // lane within the channel
  const int c = c0 + cl;
  const bool live = c < Di;
  const int n0 = sub * NPL;

  const long long row = static_cast<long long>(b) * S * Di;
  const float* bb = bm + b * b_sb;
  const float* cb = cm + b * c_sb;

  float h[NPL], a[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = n0 + j;
    const bool ok = live && n < N;
    const long long hi = (static_cast<long long>(b) * Di + c) * N + n;
    h[j] = ok ? h0[hi] : 0.f;
    a[j] = ok ? A[static_cast<long long>(c) * N + n] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int T = min(kT, S - t0);
    // stage the tile: x and dt row by row (a warp reads 32 neighbouring
    // channels of one time step), B and C through their strides; past
    // S, Di and N the tile holds zeros.  The loops have a fixed count, so
    // they unroll and every load of the tile is in flight at once.
#pragma unroll
    for (int k = 0; k < kT * kChan / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int tt = i / kChan, cc = i % kChan;
      const bool ok = tt < T && c0 + cc < Di;
      const long long g = row + static_cast<long long>(t0 + tt) * Di + c0 + cc;
      sx[tt][cc] = ok ? x[g] : 0.f;
      sdt[tt][cc] = ok ? dt[g] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kT * NP / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int tt = i / NP, n = i % NP;
      const bool ok = tt < T && n < N;
      sB[tt][n] = ok ? bb[(t0 + tt) * b_ss + n] : 0.f;
      sC[tt][n] = ok ? cb[(t0 + tt) * c_ss + n] : 0.f;
    }
    __syncthreads();

    // unrolled: the exponentials and the y sums of neighbouring steps do
    // not depend on each other (only h does, one multiply-add a step)
#pragma unroll 4
    for (int tt = 0; tt < T; ++tt) {
      const float d = sdt[tt][cl];
      const float dx = d * sx[tt][cl];
      float acc = 0.f;
      // a state past N has a = 0 and B = C = 0: it stays 0 and adds 0,
      // so the loop carries no branch
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        h[j] = expf(d * a[j]) * h[j] + dx * sB[tt][n0 + j];
        acc += h[j] * sC[tt][n0 + j];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (sub == 0) sy[tt][cl] = acc;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < T * kChan; i += kThreads) {
      const int tt = i / kChan, cc = i % kChan;
      if (c0 + cc < Di)
        y[row + static_cast<long long>(t0 + tt) * Di + c0 + cc] = sy[tt][cc];
    }
    // the next tile overwrites sx/sdt/sB/sC/sy only after every thread
    // has read them
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = n0 + j;
    if (live && n < N)
      h_last[(static_cast<long long>(b) * Di + c) * N + n] = h[j];
  }
}

template <int NPL>
cudaError_t launch(const float* x, const float* dt, const float* bm,
                   const float* cm, const float* A, const float* h0,
                   float* y, float* h_last, int B, int S, int Di, int N,
                   long long b_sb, long long b_ss, long long c_sb,
                   long long c_ss, cudaStream_t s) {
  const dim3 grid((Di + kChan - 1) / kChan, B);
  selective_scan_kernel<NPL><<<grid, kThreads, 0, s>>>(
      x, dt, bm, cm, A, h0, y, h_last, S, Di, N, b_sb, b_ss, c_sb, c_ss);
  return cudaGetLastError();
}

}  // namespace

// The largest state size the kernel takes (the wrapper raises above it).
extern "C" int repro_selective_scan_max_state() { return kLanes * kMaxNPL; }

// x, dt, y: (B, S, Di) contiguous; bm, cm: (B, S, N) with unit stride
// along N and the given batch / time strides; A: (Di, N); h0, h_last:
// (B, Di, N) contiguous.  All float32.
extern "C" int repro_selective_scan(const void* x, const void* dt,
                                    const void* bm, const void* cm,
                                    const void* A, const void* h0, void* y,
                                    void* h_last, int B, int S, int Di,
                                    int N, long long b_sb, long long b_ss,
                                    long long c_sb, long long c_ss,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Di <= 0 || N <= 0) return cudaSuccess;
  if (N > kLanes * kMaxNPL || B > 65535) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  const float* af = static_cast<const float*>(A);
  const float* hf = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hl = static_cast<float*>(h_last);
  switch ((N + kLanes - 1) / kLanes) {
    case 1:
      return launch<1>(xf, dtf, bf, cf, af, hf, yf, hl, B, S, Di, N, b_sb,
                       b_ss, c_sb, c_ss, s);
    case 2:
      return launch<2>(xf, dtf, bf, cf, af, hf, yf, hl, B, S, Di, N, b_sb,
                       b_ss, c_sb, c_ss, s);
    case 3:
      return launch<3>(xf, dtf, bf, cf, af, hf, yf, hl, B, S, Di, N, b_sb,
                       b_ss, c_sb, c_ss, s);
    default:
      return launch<4>(xf, dtf, bf, cf, af, hf, yf, hl, B, S, Di, N, b_sb,
                       b_ss, c_sb, c_ss, s);
  }
}
