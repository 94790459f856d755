// K4 and K5: densify sparse-tier leaves into dense rows of pw words.
//
// For each of K leaves, the row is zeroed and then every entry of the leaf's
// n_per_leaf stream segments (starts/lens [K, n_per_leaf]) whose global word
// index lies in the window [w_off, w_off + pw) is stored at its place in the
// window: row[idx[e] - w_off] = words[e].
//   - K4, lapis_densify_rows, writes row k of out [K, pw]. It replaces
//     densify_rows (lapis_silo_tpu/ops/pallas_kernels.py:850).
//   - K5, lapis_densify_rows_into_pool, writes row slots[k] of the hot-leaf
//     pool [C + 1, pw] in place and leaves every other row untouched. It
//     replaces densify_rows_into_pool (pallas_kernels.py:1252), which had to
//     build the rows and then scatter them with XLA: Mosaic could not write
//     output rows chosen by data (pallas_kernels.py:1265-1269).
// With w_off = 0 and pw the whole flat word axis, a row is a leaf's global
// row (one device). A word shard passes its own window, as the reference's
// window-local scatter does under shard_map (_densify_one with w_off and
// local_words, lapis_silo_tpu/ops/vm.py:390-431): every shard reads the
// replicated stream and writes only its own words, so no copy crosses
// shards. The caller may pass only the segments of the partitions that
// overlap the window; the others would store nothing.
//
// A leaf's indices are unique within a segment and partitions own disjoint
// word windows, so plain stores are exact (scatter = OR = sum) and need no
// atomics. The TPU forms are dropped: the windowed DMA over a
// block-interleaved stream, the MXU one-hot scatter, the bounded-tile part_h0
// bases and the SMEM caps on starts/lens.
//
// What bounds it on an H100: the zero fill, K x pw x 4 bytes of stores
// (256 MB for 1,024 leaves at pw = 65,536), then scattered 4-byte stores, one
// per entry (a few hundred per leaf and partition at the synthetic corpus'
// density). One CTA per leaf: 16-byte stores zero the row where it is 16-byte
// aligned, __syncthreads() orders the zeros before the scatter (a reused pool
// slot holds the previous leaf's words), then the threads stride each
// segment with coalesced loads of idx and words. Row offsets and window
// positions are int64 (8,192 slots x 327,680 words is past 2^31). Entries
// outside the stream, or whose word index lies outside the window, are
// skipped, so a bad stream cannot write outside the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) densify_kernel(
    const int32_t* __restrict__ idx, const uint32_t* __restrict__ words,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
    int n_per_leaf, int64_t pw, int64_t w_off, int64_t n_entries,
    const int32_t* __restrict__ slots, int vectorized,
    uint32_t* __restrict__ out) {
  const int64_t k = blockIdx.x;
  const int64_t row = slots != nullptr ? (int64_t)__ldg(slots + k) : k;
  uint32_t* dst = out + row * pw;
  if (vectorized) {
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int64_t j = threadIdx.x; j < (pw >> 2); j += kThreads) dst4[j] = zero;
  } else {
    for (int64_t j = threadIdx.x; j < pw; j += kThreads) dst[j] = 0u;
  }
  __syncthreads();
  for (int p = 0; p < n_per_leaf; ++p) {
    const int64_t seg = k * n_per_leaf + p;
    const int64_t start = __ldg(starts + seg);
    const int64_t lo = start < 0 ? 0 : start;
    int64_t hi = start + __ldg(lens + seg);
    hi = hi < n_entries ? hi : n_entries;
    for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
      const int64_t i = (int64_t)__ldg(idx + e) - w_off;
      if (i >= 0 && i < pw) dst[i] = __ldg(words + e);
    }
  }
}

int launch(const void* idx, const void* words, const void* starts,
           const void* lens, long long n_leaves, int n_per_leaf,
           long long pw, long long w_off, long long n_entries,
           const void* slots, void* out, void* stream) {
  if (n_leaves <= 0 || pw <= 0) return (int)cudaGetLastError();
  const int vectorized = (pw % 4 == 0) && ((uintptr_t)out % 16 == 0);
  densify_kernel<<<(unsigned)n_leaves, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint32_t*)words, (const int32_t*)starts,
      (const int32_t*)lens, n_per_leaf, pw, w_off, n_entries,
      (const int32_t*)slots, vectorized, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py). Each
// returns cudaGetLastError() after the launch.
extern "C" int lapis_densify_rows(const void* idx, const void* words,
                                  const void* starts, const void* lens,
                                  long long n_leaves, int n_per_leaf,
                                  long long pw, long long w_off,
                                  long long n_entries, void* out,
                                  void* stream) {
  return launch(idx, words, starts, lens, n_leaves, n_per_leaf, pw, w_off,
                n_entries, nullptr, out, stream);
}

// `slots` [n_leaves] must be distinct rows of the pool (the wrapper checks).
extern "C" int lapis_densify_rows_into_pool(const void* idx, const void* words,
                                            const void* starts,
                                            const void* lens, long long n_leaves,
                                            int n_per_leaf, long long pw,
                                            long long w_off,
                                            long long n_entries,
                                            const void* slots, void* pool,
                                            void* stream) {
  return launch(idx, words, starts, lens, n_leaves, n_per_leaf, pw, w_off,
                n_entries, slots, pool, stream);
}
