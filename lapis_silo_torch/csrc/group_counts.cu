// K9: the group-by reduction of a filter's words over per-sequence group
// codes,
//   counts[p, g] = number of set bits b of word w with
//                  min(codes[w*32 + b], G - 1) == g,
// where p is the partition of word w. A word shard passes its own window of
// the flat global word axis: words [n] and codes [n * 32] of the global
// words [w_off, w_off + n), partition p owning the global words
// [p * part_words, (p + 1) * part_words). Padding sequences carry the code
// n_groups, which G - 1 (the bucket's last segment) absorbs; negative codes
// count nowhere (the segment sum drops them too).
//
// Replaces the XLA reduction _group_counts_jit
// (lapis_silo_tpu/ops/reductions.py:23-40), no Pallas kernel: it expanded
// every word into 32 int32 bits (32x the filter's bytes) and segment-summed
// them per partition. Here nothing is expanded.
//
// What bounds it on an H100: reading the words once and the code of each set
// bit once (4 bytes per set bit: all of the codes for a filter that keeps
// every sequence, few for a selective one), and writing [P, G]. So a warp
// loads 32 words at once, skips each run of eight that are all zero (a
// ballot), and for each word reads the codes of its set bits with one
// coalesced load (lane b reads the code of bit b; only the sectors of set
// bits are fetched), eight words' loads in flight at once, since each SM
// holds few warps. Lanes whose
// codes agree are merged by __match_any_sync, so a run of sequences of one
// group costs one atomic, not 32. One CTA of 256 threads per (partition,
// block of words): while G fits in shared memory (up to 49,152 bins, 192
// KB) the CTA keeps a [G] histogram there and adds each non-zero bin to
// counts with one global atomic at its end; past that (the 2^20 + 1 bucket)
// it adds straight to counts in device memory. Blocks hold at least G / 32
// words, so zeroing and flushing the histogram stays below the words' own
// work, and grow until the grid has at most 4,096 CTAs. `counts` must be
// zeroed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kSmemMaxBins = 49152;  // 192 KB of int32 bins
constexpr long long kMaxCtas = 4096;
constexpr int kGroup = 8;  // words whose codes a warp loads at once

__global__ void __launch_bounds__(kThreads) group_counts_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ codes,
    long long n, long long w_off, long long part_words, int p_lo, int n_groups,
    long long blk, int use_smem, int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p = (long long)p_lo + blockIdx.y;
  // this partition's words inside the window, in window coordinates
  const long long part_lo = p * part_words - w_off;
  const long long a = part_lo > 0 ? part_lo : 0;
  const long long part_hi = part_lo + part_words;
  const long long b = part_hi < n ? part_hi : n;
  const long long lo = a + (long long)blockIdx.x * blk;
  if (lo >= b) return;  // the whole CTA, before any barrier
  const long long hi = lo + blk < b ? lo + blk : b;
  int32_t* const out = counts + p * n_groups;
  int32_t* const target = use_smem ? hist : out;
  if (use_smem) {
    for (int i = threadIdx.x; i < n_groups; i += kThreads) hist[i] = 0;
    __syncthreads();
  }
  for (long long base = lo + 32LL * warp; base < hi; base += 32LL * kWarps) {
    const long long w = base + lane;
    const uint32_t word = w < hi ? __ldg(words + w) : 0u;
    const unsigned nonzero = __ballot_sync(0xffffffffu, word != 0u);
    for (int j0 = 0; j0 < 32; j0 += kGroup) {
      if (!((nonzero >> j0) & ((1u << kGroup) - 1))) continue;  // uniform
      // the codes of kGroup words' set bits, loaded before any is used so
      // that the loads are in flight together
      int32_t code[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const uint32_t wj = __shfl_sync(0xffffffffu, word, j0 + k);
        code[k] = (wj >> lane) & 1u
                      ? __ldg(codes + (base + j0 + k) * 32 + lane)
                      : -1;
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const bool counted = code[k] >= 0;
        const unsigned active = __ballot_sync(0xffffffffu, counted);
        if (counted) {
          const int g = code[k] < n_groups - 1 ? code[k] : n_groups - 1;
          const unsigned peers = __match_any_sync(active, g);
          if (lane == __ffs(peers) - 1) atomicAdd(target + g, __popc(peers));
        }
      }
    }
  }
  if (use_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_groups; i += kThreads) {
      const int32_t v = hist[i];
      if (v) atomicAdd(out + i, v);
    }
  }
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py). The
// window overlaps the partitions [p_lo, p_lo + n_parts); counts is int32
// [P, n_groups], zeroed by the caller. Returns cudaGetLastError() after the
// launch.
extern "C" int lapis_group_counts(const void* words, const void* codes,
                                  long long n, long long w_off,
                                  long long part_words, int p_lo, int n_parts,
                                  int n_groups, void* counts, void* stream) {
  if (n <= 0 || n_parts <= 0 || n_groups <= 0 || part_words <= 0) {
    return (int)cudaGetLastError();
  }
  if (n_parts > 65535) return (int)cudaErrorInvalidConfiguration;
  const int use_smem = n_groups <= kSmemMaxBins;
  const long long span = part_words < n ? part_words : n;
  long long blk = 256;
  while (use_smem && blk < 8192 && blk * 32 < n_groups) blk *= 2;
  long long nx = (span + blk - 1) / blk;
  while (nx * n_parts > kMaxCtas && blk < (1LL << 30)) {
    blk *= 2;
    nx = (span + blk - 1) / blk;
  }
  const size_t smem = use_smem ? sizeof(int32_t) * (size_t)n_groups : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)nx, (unsigned)n_parts);
  group_counts_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)codes, n, w_off, part_words,
      p_lo, n_groups, blk, use_smem, (int32_t*)counts);
  return (int)cudaGetLastError();
}
