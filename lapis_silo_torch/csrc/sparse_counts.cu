// K3: the sparse-tier Mutations reduction over the CSR stream,
//   counts[l] = sum_p sum_{e in segment(l, p)} popc(words[e] & filter[idx[e]]),
// where leaf l's entries are n_per_leaf contiguous stream segments (one per
// partition, starts/lens [L, P]) and idx holds global word indices.
//
// Replaces sparse_filter_popcount (lapis_silo_tpu/ops/pallas_kernels.py:438,
// kernel _sparse_vals_kernel :352) together with what its callers compute
// around it (_sparse_mutation_counts_pallas_jit,
// lapis_silo_tpu/ops/reductions.py:81-96: boundary sums per segment, then a
// sum over partitions). The TPU kernel walked the filter's hi-rows band by
// band because Mosaic had no general gather, and wrote a per-entry vals
// array to HBM for an XLA cumsum; here the filter lookup is a plain load
// (the filter is PW words, 256 KB at 2 M sequences, so it stays in L2) and
// the segment sums happen in registers: vals never reach device memory.
//
// What bounds it on an H100: reading the stream once, 8 bytes per entry
// (about 0.5 GB at 2,097,152 sequences in 8 partitions), plus one filter
// gather per entry from L2. One warp per leaf: lanes stride each segment
// with coalesced 4-byte loads of idx and words, a warp reduction gives the
// leaf's count, and one lane stores it. The count fits int32 (at most the
// sequence count), so no atomics and no second pass. Entries outside the
// stream or with a word index outside [0, pw) count nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeavesPerBlock = 8;  // one warp per leaf
constexpr int kThreads = 32 * kLeavesPerBlock;

__global__ void __launch_bounds__(kThreads) sparse_counts_kernel(
    const int32_t* __restrict__ idx, const uint32_t* __restrict__ words,
    const uint32_t* __restrict__ filter, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ lens, int64_t n_leaves, int n_per_leaf,
    int64_t pw, int64_t n_entries, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t leaf =
      (int64_t)blockIdx.x * kLeavesPerBlock + (threadIdx.x >> 5);
  if (leaf >= n_leaves) return;  // the whole warp leaves together
  uint32_t acc = 0;
  for (int p = 0; p < n_per_leaf; ++p) {
    const int64_t seg = leaf * n_per_leaf + p;
    const int64_t start = __ldg(starts + seg);
    const int64_t lo = start < 0 ? 0 : start;
    int64_t hi = start + __ldg(lens + seg);
    hi = hi < n_entries ? hi : n_entries;
    for (int64_t e = lo + lane; e < hi; e += 32) {
      const int32_t i = __ldg(idx + e);
      if (i >= 0 && i < pw) acc += __popc(__ldg(words + e) & __ldg(filter + i));
    }
  }
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) out[leaf] = (int32_t)acc;
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py).
// Returns cudaGetLastError() after the launch.
extern "C" int lapis_sparse_counts(const void* idx, const void* words,
                                   const void* filter, const void* starts,
                                   const void* lens, long long n_leaves,
                                   int n_per_leaf, long long pw,
                                   long long n_entries, void* out,
                                   void* stream) {
  if (n_leaves <= 0) return (int)cudaGetLastError();
  const unsigned grid =
      (unsigned)((n_leaves + kLeavesPerBlock - 1) / kLeavesPerBlock);
  sparse_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint32_t*)words, (const uint32_t*)filter,
      (const int32_t*)starts, (const int32_t*)lens, n_leaves, n_per_leaf, pw,
      n_entries, (int32_t*)out);
  return (int)cudaGetLastError();
}
