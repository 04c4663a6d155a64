// Paged decode attention: one query token per request attends its KV
// history through the request's page table (softmax over the attended
// positions, `kpos <= len` and sliding-window masks, tanh logit softcap).
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention/kernel.py:paged_attention_rkgd.
//
// Layout: q, o (R, H, hd) with H = K * G (q head h = kh * G + g);
// k_pages, v_pages in the serve layout (P, ps, K, hd), read in place —
// the TPU wrapper transposed the whole pool to (P, K, ps, hd) on every
// call; page_tables (R, MPR) int32; lengths (R,) int32, the query's
// position (it attends positions 0..lengths[r]).
//
// Bound on the H100: memory.  Each request reads (len + 1) * hd * 2
// values of K and V per kv head and does 4 * G flops per value pair, far
// below the card's operations-per-byte ridge; at decode width the bytes
// are few (1.1 us at the serve shape), so what counts is how many loads
// are in flight at once.  Design: two kernels.
//   * paged_split_kernel: a row's positions are cut into fixed splits of
//     C positions counted from position 0 (split s is [s C, (s + 1) C);
//     C = split_positions(hd, dtype) in kernels/paged_attention/ref.py,
//     passed in by the wrapper).  One block of 128 threads per (row, kv
//     head, split, group tile) holds GT of that head's G query rows (GT =
//     min(G, 1024 / hd): the whole group up to G hd = 1024, so each K/V
//     row is read from device memory once for all G rows; a wider group,
//     recurrentgemma-2b's 16 padded q heads of 256 on one kv head, is cut
//     into G / GT tiles of blocks that read the split's K/V rows again,
//     mostly from L2, and keep a block's shared memory what it is at G hd
//     = 1024).  Every thread issues
//     cp.async copies of its 16-byte chunks of the split's live K rows,
//     then of its V rows, before any arithmetic (four of each a thread
//     at hd 128 in bf16, C = 32); the page ids are loaded with the row's
//     length, and the scores run while V is in flight.  It writes the
//     split's fp32 triple: m (the max score), l (the sum of exp(score -
//     m)) and acc (the p-weighted sum of V rows), for each of the G rows,
//     into float32 partials the wrapper allocates.  A row's arithmetic is
//     the same whatever tile it sits in: GT changes no bit.  Both kernels are
//     templated on hd (64, 128, 256; any other hd at run time): a block's
//     time is a chain of latencies, and index arithmetic at run time
//     lengthened it by half.
//   * paged_combine_kernel: one block per (row, kv head, 512 outputs of
//     the group: G hd / 512 of them, 8 at G hd 4096, where one block a
//     head took 9x the split pass) folds the row's live splits in
//     ascending split order — m is their max M, l and acc
//     the sums of l_s exp(m_s - M) and acc_s exp(m_s - M) taken from the
//     lowest split up — and divides by l once.  It issues the loads of
//     up to 16 splits at once, the first 16 together with the row's
//     length.
// Dead positions (past lengths[r], before the window's start, or past
// the table's reach) are neither loaded nor used: their scores are
// masked and get p = 0 explicitly, and the P V loop runs over the live
// positions only.  A split with no live position writes nothing and the
// combine skips it, so it never adds an exp(0) = 1 term.  The combine is
// launched with programmatic dependent launch (common.cuh): its launch
// overlaps the split pass, and it waits for the split pass's writes.
//
// Determinism: a row's result depends only on its query, its length and
// the contents of its pages — not on its row index, R, MPR, its physical
// page ids or the other rows.  The splits are fixed position ranges (not
// pages, not a function of R, MPR or the card), each split's arithmetic
// runs in a fixed order over its positions, and the fold's order is the
// split order; no atomics touch a value.  Token-identical retries after a
// replica failover rely on this.  Inactive rows (length 0, zeroed table)
// touch only the null page.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;

// C, the positions of a split, for rows of hd elements of esize bytes:
// about 8 KB of K rows, a power of two from 16 to 256 — the rule of
// split_positions in kernels/paged_attention/ref.py, which the entry point
// checks the wrapper's C against.
__host__ __device__ constexpr int split_c(int hd, int esize) {
  int c = 16;
  while (c < 256 && 2 * c * hd * esize <= 8192) c *= 2;
  return c;
}

// The positions [lo, hi] a row attends: the window's start, and the query's
// position clamped to the table's reach (MPR * ps positions).
__device__ __forceinline__ void attended(int cur, int window, int reach,
                                         int& lo, int& hi) {
  lo = window > 0 ? max(0, cur - window + 1) : 0;
  hi = min(cur, reach - 1);
}

// 16-byte chunks of one K/V row, and the row stride in shared memory: one
// padding chunk a row, so that eight consecutive rows at the same chunk
// fall in eight different bank groups.
inline int row_chunks(int hd, int esize) { return hd * esize / 16; }

inline size_t split_smem_bytes(int G, int hd, int C, int esize) {
  const size_t rs = row_chunks(hd, esize) + 1;
  return 2 * C * rs * 16 +
         sizeof(float) * (static_cast<size_t>(G) * hd + G * C + 2 * G);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(b[j]);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 raw;
  __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Partials, float32: acc (R, K, NS, G, hd), then m and l (R, K, NS, G)
// each (kernels/paged_attention/kernel.py allocates them in one buffer).
// HD: hd at compile time (64, 128, 256), so that C, the chunk counts and
// the index arithmetic are constants; 0 takes hd and C at run time.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ page_tables,
                       const int* __restrict__ lengths,
                       float* __restrict__ pacc, float* __restrict__ pm,
                       float* __restrict__ pl, int K, int G, int GT,
                       int hd_arg, int ps, int MPR, int C_arg, float scale,
                       int window, float softcap) {
  constexpr int V = 16 / sizeof(T);       // elements a 16-byte chunk
  constexpr int CC = HD ? split_c(HD, sizeof(T)) : 0;
  const int hd = HD ? HD : hd_arg, C = HD ? CC : C_arg;
  const int nch = hd / V, rs = nch + 1;
  // page size a power of two (the usual case): shifts, not divisions
  const int ps_shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  extern __shared__ uint4 smem[];
  uint4* Ks = smem;                                        // C x rs
  uint4* Vs = Ks + C * rs;                                 // C x rs
  float* Qs = reinterpret_cast<float*>(Vs + C * rs);      // GT x hd, scaled
  float* Ss = Qs + GT * hd;                                // GT x C: s, then p
  float* m_s = Ss + GT * C;                                // GT
  float* l_s = m_s + GT;                                   // GT

  // this block's query rows: g0 .. g0 + Gb - 1 of the kv head's G
  const int NG = (G + GT - 1) / GT;
  const int r = blockIdx.x, kh = blockIdx.y / NG, s = blockIdx.z;
  const int g0 = (blockIdx.y % NG) * GT, Gb = min(GT, G - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = s * C;
  const int reach = MPR * ps;
  const int* table = page_tables + static_cast<long long>(r) * MPR;
  const long long tok_stride = static_cast<long long>(K) * hd;

  griddep_launch_dependents();  // the combine may launch now
  // chunk i = tid + k NT of the split (row t = i / nch): its page id is
  // loaded together with the row's length, so the copies wait for one
  // round trip only
  constexpr int MAXI = 8;     // chunks of K a thread: C * nch <= 8 NT
  int page[MAXI];
#pragma unroll
  for (int k = 0; k < MAXI; ++k) {
    const int pos = s0 + (tid + k * NT) / nch;
    const int j = ps_shift >= 0 ? pos >> ps_shift : pos / ps;
    page[k] = tid + k * NT < C * nch && pos < reach ? table[j] : 0;
  }
  int lo, hi;
  attended(lengths[r], window, reach, lo, hi);
  const int t_lo = max(lo - s0, 0), t_hi = min(hi - s0, C - 1);
  if (t_lo > t_hi) return;    // a dead split: the combine skips it

  // every copy of the split's live K rows, then of its V rows, in flight
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? kp : vp;
    uint4* dst = pass == 0 ? Ks : Vs;
#pragma unroll
    for (int k = 0; k < MAXI; ++k) {
      const int i = tid + k * NT, t = i / nch, c = i % nch, pos = s0 + t;
      if (i < C * nch && t >= t_lo && t <= t_hi) {
        const int slot = ps_shift >= 0 ? pos & (ps - 1) : pos % ps;
        const long long off =
            (static_cast<long long>(page[k]) * ps + slot) * tok_stride +
            static_cast<long long>(kh) * hd + c * V;
        cp_async16(smem_u32(dst + t * rs + c), src + off);
      }
    }
    cp_async_commit();
  }
  const long long q_off =
      ((static_cast<long long>(r) * K + kh) * G + g0) *
      static_cast<long long>(hd);
  for (int i = tid; i < Gb * hd; i += NT)
    Qs[i] = to_f32(q[q_off + i]) * scale;
  cp_async_wait<1>();         // this thread's K copies have landed
  __syncthreads();            // and everyone's, and Qs

  // scores: position t of the split, query rows g = gg, gg + ngrp, ...
  // (the lanes of a warp share g, read q as a broadcast and consecutive K
  // rows)
  const int ngrp = C < NT ? NT / C : 1;
  for (int i = tid; i < C * ngrp; i += NT) {
    const int t = i % C, gg = i / C;
    const bool live = t >= t_lo && t <= t_hi;
    const uint4* kr = Ks + t * rs;
    for (int g = gg; g < Gb; g += ngrp) {
      float sc = -INFINITY;   // marks a dead position
      if (live) {
        const float4* q4 = reinterpret_cast<const float4*>(Qs + g * hd);
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
        for (int c = 0; c < nch; ++c) {
          const uint4 raw = kr[c];
          const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            const float4 qv = q4[(c * V + e) / 4];
            a[0] += qv.x * to_f32(kv[e]);
            a[1] += qv.y * to_f32(kv[e + 1]);
            a[2] += qv.z * to_f32(kv[e + 2]);
            a[3] += qv.w * to_f32(kv[e + 3]);
          }
        }
        sc = (a[0] + a[1]) + (a[2] + a[3]);
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      }
      Ss[g * C + t] = sc;
    }
  }
  __syncthreads();

  // the split's softmax state, one warp a query row
  for (int g = warp; g < Gb; g += NWARPS) {
    float* sr = Ss + g * C;
    float mx = -INFINITY;
    for (int t = lane; t < C; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int t = lane; t < C; t += 32) {
      const float p = sr[t] == -INFINITY ? 0.f : expf(sr[t] - mx);
      sr[t] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  cp_async_wait<0>();         // this thread's V copies
  __syncthreads();

  // acc = p V over the live positions, four consecutive outputs a thread
  const long long base =
      ((static_cast<long long>(r) * K + kh) * gridDim.z + s) * G + g0;
  for (int e0 = tid * 4; e0 < Gb * hd; e0 += NT * 4) {
    const int g = e0 / hd, d = e0 % hd;
    const float* pr = Ss + g * C;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int t = t_lo; t <= t_hi; ++t) {
      const float p = pr[t];
      float v[4];
      load4(reinterpret_cast<const T*>(Vs + t * rs) + d, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] += p * v[j];
    }
    store4(pacc + base * hd + e0, a);
  }
  if (tid < Gb) {
    pm[base + tid] = m_s[tid];
    pl[base + tid] = l_s[tid];
  }
}

// B splits a batch: their loads are in flight together.  The first
// batch (splits 0 .. B - 1) is loaded with the row's length, before the
// live splits are known (a dead split's slot is read but never used), so
// a row whose live splits all lie in it waits for one round trip to the
// partials.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    paged_combine_kernel(const float* __restrict__ pacc,
                         const float* __restrict__ pm,
                         const float* __restrict__ pl,
                         const int* __restrict__ lengths, T* __restrict__ o,
                         int K, int G, int hd_arg, int ps, int MPR, int C,
                         int NS, int window) {
  constexpr int B = 16;
  const int hd = HD ? HD : hd_arg;
  const int r = blockIdx.x, kh = blockIdx.y;
  griddep_wait();             // the split pass has finished
  griddep_launch_dependents();
  const int cur = lengths[r];
  const long long base = (static_cast<long long>(r) * K + kh) * NS;
  const long long o_off = (static_cast<long long>(r) * K + kh) * G * hd;
  for (int e0 = (blockIdx.z * NT + threadIdx.x) * 4; e0 < G * hd;
       e0 += gridDim.z * NT * 4) {
    const int g = e0 / hd, d = e0 % hd;
    float mv[B], lv[B], av[B][4];
    auto load_batch = [&](int s1, int s_end) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const long long i = (base + s1 + b) * G + g;
        if (s1 + b <= s_end) {
          mv[b] = pm[i];
          lv[b] = pl[i];
          load4(pacc + i * hd + d, av[b]);
        }
      }
    };
    load_batch(0, min(B, NS) - 1);
    int lo, hi;
    attended(cur, window, MPR * ps, lo, hi);
    // the live splits, lo / C .. hi / C (none when hi < lo)
    const int s_lo = lo / C, s_hi = hi >= lo ? hi / C : s_lo - 1;
    float mx = -INFINITY;
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (b >= s_lo && b <= s_hi) mx = fmaxf(mx, mv[b]);
    for (int s = max(s_lo, B); s <= s_hi; ++s)
      mx = fmaxf(mx, pm[(base + s) * G + g]);
    float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s1 = s_lo; s1 <= s_hi; s1 += B) {   // ascending split order
      if (s1 != 0) load_batch(s1, s_hi);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (s1 + b > s_hi) break;
        const float wgt = expf(mv[b] - mx);
        l += lv[b] * wgt;
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] += av[b][j] * wgt;
      }
    }
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = a[j] / den;
    store4(o + o_off + e0, a);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* kp, const void* vp,
                      const int* pt, const int* len, void* o,
                      float* partials, int R, int K, int G, int hd, int ps,
                      int MPR, int C, float scale, int window, float softcap,
                      cudaStream_t s) {
  const int NS = (MPR * ps + C - 1) / C;
  const long long slots = static_cast<long long>(R) * K * NS * G;
  float* pacc = partials;
  float* pm = pacc + slots * hd;
  float* pl = pm + slots;
  auto split = paged_split_kernel<T, HD>;
  const int GT = max(1, min(G, 1024 / hd));   // query rows a block
  const int NG = (G + GT - 1) / GT;
  const size_t bytes = split_smem_bytes(GT, hd, C, sizeof(T));
  static size_t allowed = 48 * 1024;     // per instantiation
  cudaError_t err = allow_smem(split, bytes, allowed);
  if (err != cudaSuccess) return err;
  // the split pass is launched plainly, after the kernel before it (which
  // wrote this step's K/V) has finished: launched early behind a previous
  // call's combine it measured slower.  The combine is launched early and
  // waits for the split pass in griddep_wait.
  err = launch_kernel(false, split, dim3(R, K * NG, NS), dim3(NT), bytes, s,
                   static_cast<const T*>(q), static_cast<const T*>(kp),
                   static_cast<const T*>(vp), pt, len, pacc, pm, pl, K, G,
                   GT, hd, ps, MPR, C, scale, window, softcap);
  if (err != cudaSuccess) return err;
  const int NE = (G * hd + 4 * NT - 1) / (4 * NT);   // output chunks
  return launch_kernel(true, paged_combine_kernel<T, HD>, dim3(R, K, NE),
                       dim3(NT), 0, s, static_cast<const float*>(pacc),
                       static_cast<const float*>(pm),
                       static_cast<const float*>(pl), len,
                       static_cast<T*>(o), K, G, hd, ps, MPR, C, NS, window);
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* len, void* o, float* partials,
                   int R, int K, int G, int hd, int ps, int MPR, int C,
                   float scale, int window, float softcap, cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch_hd<T, 64>(q, kp, vp, pt, len, o, partials, R, K, G, hd,
                              ps, MPR, C, scale, window, softcap, s);
    case 128:
      return launch_hd<T, 128>(q, kp, vp, pt, len, o, partials, R, K, G, hd,
                               ps, MPR, C, scale, window, softcap, s);
    case 256:
      return launch_hd<T, 256>(q, kp, vp, pt, len, o, partials, R, K, G, hd,
                               ps, MPR, C, scale, window, softcap, s);
    default:
      return launch_hd<T, 0>(q, kp, vp, pt, len, o, partials, R, K, G, hd,
                             ps, MPR, C, scale, window, softcap, s);
  }
}

}  // namespace

// q, o: (R, K*G, hd); k_pages, v_pages: (P, ps, K, hd); page_tables:
// (R, MPR) int32; lengths: (R,) int32; partials: R * K * NS * G * (hd + 2)
// float32 with NS = ceil(MPR * ps / C); contiguous, q/pages of one dtype,
// 16-byte aligned.  Requires C = split_c(hd, element size), hd % 8 == 0,
// C * hd * (element size) <= 8 * 128 * 16 bytes (eight chunks of K a
// thread) and K * ceil(G / GT), NS <= 65535 (GT = min(G, 1024 / hd)).
// Returns the cudaError_t of the launches.
extern "C" int repro_paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_tables, const void* lengths, void* o, void* partials,
    int R, int K, int G, int hd, int ps, int MPR, int C, float scale,
    int window, float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0) return cudaSuccess;
  if (dtype != DT_BF16 && dtype != DT_F32) return cudaErrorInvalidValue;
  const int esize = dtype == DT_BF16 ? 2 : 4;
  const long long NS = (static_cast<long long>(MPR) * ps + C - 1) / C;
  const int GT = max(1, min(G, 1024 / hd));
  if (C != split_c(hd, esize) || hd % 8 || G < 1 ||
      C * row_chunks(hd, esize) > 8 * NT ||
      static_cast<long long>(K) * ((G + GT - 1) / GT) > 65535 || NS > 65535 ||
      NS < 1)
    return cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_tables);
  const int* len = static_cast<const int*>(lengths);
  float* part = static_cast<float*>(partials);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, pt, len, o, part, R,
                                 K, G, hd, ps, MPR, C, scale, window,
                                 softcap, s);
  return launch<float>(q, k_pages, v_pages, pt, len, o, part, R, K, G, hd,
                       ps, MPR, C, scale, window, softcap, s);
}
