// Paged decode attention: one query token per request attends its KV
// history through the request's page table (online softmax over pages,
// `kpos <= len` and sliding-window masks, tanh logit softcap).
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
// below the card's operations-per-byte ridge.  Design: one block of 256
// threads per (request, kv head) holding that head's G query rows, so each
// K/V tile is read from device memory once for all G rows.  The block
// walks page_tables[r, j] only up to the page that holds position
// lengths[r] (and from the window's first page), never out to MPR, in
// tiles of up to 64 tokens (whole pages) staged in shared memory in fp32
// with 16-byte loads: one score per thread, one warp per query row for
// the softmax, up to four output elements per thread.  Positions outside
// [window start, lengths[r]] are stored as zeros and get p = 0
// explicitly, so neither a dead page (exp(0) = 1) nor stale pool data can
// reach the sum.
//
// Determinism: a row's result depends only on its query, its length and
// the contents of its pages — not on its row index, its physical page ids
// or the other rows; tiles start at the row's first attended page.  No
// atomics, no split over pages whose order depends on placement:
// token-identical retries after a replica failover rely on this.
// Inactive rows (length 0, zeroed table) touch only the null page.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int MAXA = 4;          // output elements per thread: G*hd <= 1024
constexpr int TILE = 64;         // tokens per tile (whole pages)

inline int tile_pages(int ps) { return ps >= TILE ? 1 : TILE / ps; }

inline size_t smem_bytes(int G, int hd, int ps) {
  const size_t ntok = static_cast<size_t>(tile_pages(ps)) * ps;
  return sizeof(float) * (static_cast<size_t>(G) * hd + ntok * (hd + 1) +
                          ntok * hd + G * ntok + 3 * G);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ page_tables,
                        const int* __restrict__ lengths, T* __restrict__ o,
                        int K, int G, int hd, int ps, int MPR, int tp,
                        float scale, int window, float softcap) {
  constexpr int V = 16 / sizeof(T);       // elements per 16-byte load
  const int ntok = tp * ps;
  extern __shared__ float smem[];
  float* Qs = smem;                         // G x hd
  float* Ks = Qs + G * hd;                  // ntok x (hd + 1)
  float* Vs = Ks + ntok * (hd + 1);         // ntok x hd
  float* Ss = Vs + ntok * hd;               // G x ntok: scores, then p
  float* m_s = Ss + G * ntok;               // G
  float* l_s = m_s + G;                     // G
  float* c_s = l_s + G;                     // G: this tile's correction

  const int r = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long q_off =
      (static_cast<long long>(r) * K * G + static_cast<long long>(kh) * G) *
      hd;
  const int GH = G * hd;
  for (int i = tid; i < GH; i += NT) Qs[i] = to_f32(q[q_off + i]) * scale;
  if (tid < G) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAXA];
#pragma unroll
  for (int a = 0; a < MAXA; ++a) acc[a] = 0.f;

  const int cur = lengths[r];
  const int lo_pos = window > 0 ? max(0, cur - window + 1) : 0;
  const int last = min(cur / ps, MPR - 1);
  const int first = lo_pos / ps;
  const int* table = page_tables + static_cast<long long>(r) * MPR;
  const long long tok_stride = static_cast<long long>(K) * hd;
  const int vecs = hd / V;                  // 16-byte vectors per token row

  for (int j0 = first; j0 <= last; j0 += tp) {
    const int pos0 = j0 * ps;
    __syncthreads();            // Qs written / previous tile consumed
    for (int i = tid; i < ntok * vecs; i += NT) {
      const int t = i / vecs, d = (i % vecs) * V;
      const int j = j0 + t / ps, kpos = pos0 + t;
      float kx[V], vx[V];
      if (j <= last && kpos >= lo_pos && kpos <= cur) {
        const long long off =
            (static_cast<long long>(table[j]) * ps + t % ps) * tok_stride +
            static_cast<long long>(kh) * hd + d;
        const uint4 kraw = *reinterpret_cast<const uint4*>(kp + off);
        const uint4 vraw = *reinterpret_cast<const uint4*>(vp + off);
        const T* kv = reinterpret_cast<const T*>(&kraw);
        const T* vv = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          kx[e] = to_f32(kv[e]);
          vx[e] = to_f32(vv[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        Ks[t * (hd + 1) + d + e] = kx[e];
        Vs[t * hd + d + e] = vx[e];
      }
    }
    __syncthreads();
    for (int i = tid; i < G * ntok; i += NT) {
      const int g = i / ntok, t = i % ntok;
      const float* qr = Qs + g * hd;
      const float* kr = Ks + t * (hd + 1);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int d = 0; d < hd; d += 4) {
        s0 += qr[d] * kr[d];
        s1 += qr[d + 1] * kr[d + 1];
        s2 += qr[d + 2] * kr[d + 2];
        s3 += qr[d + 3] * kr[d + 3];
      }
      float s = (s0 + s1) + (s2 + s3);
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int kpos = pos0 + t;
      const bool ok = j0 + t / ps <= last && kpos >= lo_pos && kpos <= cur;
      Ss[i] = ok ? s : -INFINITY;      // -inf marks a masked position
    }
    __syncthreads();
    for (int g = warp; g < G; g += NWARPS) {
      float* sr = Ss + g * ntok;
      float mx = REPRO_NEG_INF;
      for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = lane; t < ntok; t += 32) {
        const float p = sr[t] == -INFINITY ? 0.f : expf(sr[t] - m_new);
        sr[t] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      const int e = tid + a * NT;
      if (e < GH) {
        const int g = e / hd, d = e % hd;
        const float* pr = Ss + g * ntok;
        float pv = 0.f;
        for (int t = 0; t < ntok; ++t) pv += pr[t] * Vs[t * hd + d];
        acc[a] = acc[a] * c_s[g] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < MAXA; ++a) {
    const int e = tid + a * NT;
    if (e < GH) {
      const int g = e / hd;
      o[q_off + e] = from_f32<T>(acc[a] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* pt, const int* len, void* o, int R, int K,
                   int G, int hd, int ps, int MPR, float scale, int window,
                   float softcap, cudaStream_t s) {
  auto kernel = paged_decode_kernel<T>;
  const size_t bytes = smem_bytes(G, hd, ps);
  static size_t allowed = 48 * 1024;     // per instantiation
  cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(R, K);
  kernel<<<grid, NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, len, static_cast<T*>(o), K, G, hd, ps,
      MPR, tile_pages(ps), scale, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// q, o: (R, K*G, hd); k_pages, v_pages: (P, ps, K, hd); page_tables:
// (R, MPR) int32; lengths: (R,) int32; contiguous, q/pages of one dtype,
// 16-byte aligned.  Requires G * hd <= 1024 and hd % 8 == 0.  Returns the
// cudaError_t of the launch.
extern "C" int repro_paged_attention_fwd(const void* q, const void* k_pages,
                                         const void* v_pages,
                                         const void* page_tables,
                                         const void* lengths, void* o, int R,
                                         int K, int G, int hd, int ps,
                                         int MPR, float scale, int window,
                                         float softcap, int dtype,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0) return cudaSuccess;
  if (G * hd > MAXA * NT || hd % 8) return cudaErrorInvalidValue;
  const int* pt = static_cast<const int*>(page_tables);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, pt, len, o, R, K, G,
                                 hd, ps, MPR, scale, window, softcap, s);
  if (dtype == DT_F32)
    return launch<float>(q, k_pages, v_pages, pt, len, o, R, K, G, hd, ps,
                         MPR, scale, window, softcap, s);
  return cudaErrorInvalidValue;
}
