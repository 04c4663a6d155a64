// Per-block position-weighted hash mod 2^32, many leaves in one launch.
//
// Replaces the TPU kernel src/repro/kernels/block_hash/kernel.py:hash_rows
// (_hash_kernel).  A leaf is viewed as a flat run of storage words (1- and
// 2-byte elements zero-extend to one word each, 4-byte elements are one
// word, 8-byte elements are two words, low word first); block b of a leaf
// holds words [b * W, (b + 1) * W) with W = block_elems * words-an-element,
// the ragged last block zero-filled.  Its hash is
//   sum_j word_j * (2j + 1)  mod 2^32
// (j the word's index within the block), the same uint32 value as the
// plain version (kernels/block_hash/ref.py) and the reference's numpy
// oracle.  uint32 arithmetic wraps, and addition mod 2^32 is associative
// and commutative, so any split of a block across threads gives the exact
// hash.
//
// Bound on the H100: memory.  Every byte of every leaf is read once and 4
// bytes a block are written; the arithmetic is one multiply-add a word.
// Design: one CUDA block of 256 threads a hash block, found by a binary
// search over the launch's table of leaves (one entry a leaf: pointer,
// element count, element size, first output block), so a save or a scrub
// hashes its whole state in one launch.  The table travels as a kernel
// parameter (__grid_constant__, up to kMaxLeaves leaves a launch): no
// copy to the device and no stream sync before the launch, and the launch
// can be captured in a CUDA graph.  Each thread reads 16 bytes at a
// time in place (no padded or widened copy of a leaf exists), the words'
// weights come from their index; the ragged tail and unaligned blocks
// take a scalar path.  The partial sums meet in a warp-shuffle and
// shared-memory reduction.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 120;     // 3840 bytes: within the 4 KB of params

struct LeafEntry {           // one row of the int64 table, see below
  long long ptr;
  long long n_elems;
  long long elem_size;
  long long first_block;
};

struct LeafTable {
  LeafEntry e[kMaxLeaves];
};

// word j of a 16-byte chunk holding 16 / unit units
__device__ __forceinline__ uint32_t chunk_sum(const uint4 v, int unit,
                                              uint32_t j0) {
  uint32_t s = 0;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (unit == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s += w[i] * (2u * (j0 + i) + 1u);
  } else if (unit == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += (w[i] & 0xffffu) * (2u * (j0 + 2 * i) + 1u);
      s += (w[i] >> 16) * (2u * (j0 + 2 * i + 1) + 1u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        s += ((w[i] >> (8 * b)) & 0xffu) * (2u * (j0 + 4 * i + b) + 1u);
    }
  }
  return s;
}

__device__ __forceinline__ uint32_t load_unit(const unsigned char* p,
                                              long long u, int unit) {
  if (unit == 4) return reinterpret_cast<const uint32_t*>(p)[u];
  if (unit == 2) return reinterpret_cast<const uint16_t*>(p)[u];
  return p[u];
}

__global__ void __launch_bounds__(kThreads)
    hash_kernel(const __grid_constant__ LeafTable table, int n_leaves,
                long long block_base, long long block_elems,
                uint32_t* __restrict__ out) {
  const long long b = block_base + blockIdx.x;
  // the leaf holding output block b: the last entry with first_block <= b
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.e[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  const LeafEntry e = table.e[lo];
  const int unit = e.elem_size == 8 ? 4 : static_cast<int>(e.elem_size);
  const long long upe = e.elem_size == 8 ? 2 : 1;       // units an element
  const long long block_units = block_elems * upe;
  const long long u0 = (b - e.first_block) * block_units;
  long long n_units = e.n_elems * upe - u0;
  if (n_units > block_units) n_units = block_units;
  const unsigned char* p =
      reinterpret_cast<const unsigned char*>(e.ptr) + u0 * unit;

  uint32_t acc = 0;
  long long done = 0;                                   // units in chunks
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int per = 16 / unit;
    const long long chunks = n_units / per;
    const uint4* p16 = reinterpret_cast<const uint4*>(p);
#pragma unroll 4
    for (long long c = threadIdx.x; c < chunks; c += kThreads)
      acc += chunk_sum(__ldg(p16 + c), unit,
                       static_cast<uint32_t>(c * per));
    done = chunks * per;
  }
  for (long long u = done + threadIdx.x; u < n_units; u += kThreads)
    acc += load_unit(p, u, unit) * (2u * static_cast<uint32_t>(u) + 1u);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ uint32_t part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += part[w];
    out[b] = s;
  }
}

}  // namespace

// Leaves a launch: more leaves take ceil(n_leaves / this) launches.
extern "C" int repro_block_hash_max_leaves() { return kMaxLeaves; }

// table: n_leaves rows of 4 int64 in host memory, {pointer, element
// count, element size in bytes (1, 2, 4 or 8), first output block}, in
// order of first block, every leaf non-empty and contiguous on the
// device; out: uint32 on the device, leaf l filling [first_block,
// first_block + ceil(n / block_elems)).  Returns the cudaError_t of the
// launches.
extern "C" int repro_block_hash(const long long* table, int n_leaves,
                                long long block_elems, void* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_elems <= 0) return cudaErrorInvalidValue;
  for (int l0 = 0; l0 < n_leaves; l0 += kMaxLeaves) {
    const int n = n_leaves - l0 < kMaxLeaves ? n_leaves - l0 : kMaxLeaves;
    LeafTable t;
    for (int i = 0; i < n; ++i) {
      const long long* r = table + 4 * (l0 + i);
      t.e[i] = LeafEntry{r[0], r[1], r[2], r[3]};
    }
    const LeafEntry& last = t.e[n - 1];
    const long long end =
        last.first_block + (last.n_elems + block_elems - 1) / block_elems;
    const long long blocks = end - t.e[0].first_block;
    if (blocks <= 0) continue;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t, n, t.e[0].first_block, block_elems, static_cast<uint32_t*>(out));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
