// K3: the sparse-tier Mutations reduction over the CSR stream, for the rows
// of one alphabet, in the partitions where the filter has a set bit:
//   out[r - row_base] = sum over the segments s of row r listed in blocks
//     whose partition p has a set bit in filter[p * part_words, +part_words)
//     of sum_{e in [seg_starts[s], seg_starts[s + 1])}
//     popc(words[e] & filter[idx[e]]),
//   out[n_rows] = the entries of those segments, what the launch read.
// The stream is partition-major, so its non-empty (row, partition)
// segments form one list in stream order (seg_rows, seg_starts, the latter
// with the end of the last segment after it), in which each partition's
// segments of one alphabet are contiguous. blocks[b] = (partition, first,
// end) cuts one alphabet's segments of one partition into the grid's
// blocks; idx holds global word indices.
//
// Replaces sparse_filter_popcount (lapis_silo_tpu/ops/pallas_kernels.py:438,
// kernel _sparse_vals_kernel :352) together with what its callers compute
// around it (_sparse_mutation_counts_pallas_jit,
// lapis_silo_tpu/ops/reductions.py:81-96: boundary sums per segment, then a
// sum over partitions). The TPU kernel walked the filter's hi-rows band by
// band because Mosaic had no general gather, and wrote a per-entry vals
// array to HBM for an XLA cumsum; here the filter lookup is a plain load
// from L2 and the segment sums happen in registers. It also replaces this
// file's first design, one warp per sparse row of both alphabets over its
// [L, P] bounds: every query read the whole stream and every bound, most of
// them of empty segments, with one or two of 32 lanes busy on each.
//
// What bounds it on an H100: the selected entries at 8 bytes (index and
// word) plus their segments at 8 bytes (row id and start), and a filter
// gather per entry from L2: at 524,288 lineage-partitioned genomes a query
// selects about a fifth of the 12.7 M entries. How the design meets it: a
// block first reads its partition's filter words (L2) and leaves where
// all are zero, so a query reads only its alphabet's segments in the
// partitions it reaches; neighbouring lanes take neighbouring segments
// (about 4.5 entries each there), so their index and word loads fall in
// the same sectors; the host cuts a segment into pieces of at most 16
// entries (kernels.SPARSE_PIECE_ENTRIES), a lane each, since a few hold
// most of their partition's words and one lane over them would set the
// launch's time (median 2 entries, 99th percentile 16, longest 670); a lane keeps four entries' loads in flight; one int32
// atomic per non-zero piece sum (integer sums: any order gives the same
// count) and one per warp for the entries read. Entries outside
// the stream or with a word index outside [0, pw), and rows outside
// [row_base, row_base + n_rows), count nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads) sparse_counts_kernel(
    const int32_t* __restrict__ idx, const uint32_t* __restrict__ words,
    const uint32_t* __restrict__ filter, const int32_t* __restrict__ seg_rows,
    const int32_t* __restrict__ seg_starts, const int32_t* __restrict__ blocks,
    int64_t n_segments, int64_t part_words, int64_t pw, int64_t n_entries,
    int32_t row_base, int32_t n_rows, int32_t* __restrict__ out) {
  const int32_t* block = blocks + 3 * (int64_t)blockIdx.x;
  const int64_t part = __ldg(block);
  int64_t first = __ldg(block + 1);
  int64_t end = __ldg(block + 2);
  first = first < 0 ? 0 : first;
  end = end < n_segments ? end : n_segments;
  // the partition's filter words: where all are zero, nothing it holds can
  // count, and the block leaves before it reads the stream
  const int64_t w_lo = part * part_words;
  int64_t w_hi = w_lo + part_words;
  w_hi = w_hi < pw ? w_hi : pw;
  int any = 0;
  if (part >= 0)
    for (int64_t w = w_lo + threadIdx.x; w < w_hi; w += kThreads)
      any |= __ldg(filter + w) != 0u;
  if (!__syncthreads_or(any)) return;
  uint32_t read = 0;
  for (int64_t s = first + threadIdx.x; s < end; s += kThreads) {
    int64_t lo = __ldg(seg_starts + s);
    int64_t hi = __ldg(seg_starts + s + 1);
    lo = lo < 0 ? 0 : lo;
    hi = hi < n_entries ? hi : n_entries;
    uint32_t acc = 0;
    int64_t e = lo;
    // four entries at a time: their index and word loads all in flight,
    // then their filter gathers
    for (; e + kUnroll <= hi; e += kUnroll) {
      int32_t i[kUnroll];
      uint32_t w[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        i[k] = __ldg(idx + e + k);
        w[k] = __ldg(words + e + k);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (i[k] >= 0 && i[k] < pw) acc += __popc(w[k] & __ldg(filter + i[k]));
    }
    for (; e < hi; ++e) {
      const int32_t i = __ldg(idx + e);
      if (i >= 0 && i < pw) acc += __popc(__ldg(words + e) & __ldg(filter + i));
    }
    if (hi > lo) read += (uint32_t)(hi - lo);
    if (acc) {
      const int64_t r = (int64_t)__ldg(seg_rows + s) - row_base;
      if (r >= 0 && r < n_rows) atomicAdd(out + r, (int32_t)acc);
    }
  }
  read = __reduce_add_sync(0xffffffffu, read);
  if ((threadIdx.x & 31) == 0 && read) atomicAdd(out + n_rows, (int32_t)read);
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py). `out`
// [n_rows + 1] must be zero. Returns cudaGetLastError() after the launch.
extern "C" int lapis_sparse_counts(
    const void* idx, const void* words, const void* filter,
    const void* seg_rows, const void* seg_starts, const void* blocks,
    long long n_blocks, long long n_segments, long long part_words,
    long long pw, long long n_entries, int row_base, int n_rows, void* out,
    void* stream) {
  if (n_blocks <= 0) return (int)cudaGetLastError();
  sparse_counts_kernel<<<(unsigned)n_blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint32_t*)words, (const uint32_t*)filter,
      (const int32_t*)seg_rows, (const int32_t*)seg_starts,
      (const int32_t*)blocks, n_segments, part_words, pw, n_entries, row_base,
      n_rows, (int32_t*)out);
  return (int)cudaGetLastError();
}
