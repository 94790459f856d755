// K9: the group-by reduction of a filter's words over per-sequence group
// codes,
//   counts[p, g] = number of set bits b of word w with
//                  min(codes[w*32 + b], G - 1) == g,
// where p is the partition of word w. Padding sequences carry the code
// n_groups, which G - 1 (the bucket's last segment) absorbs; negative codes
// count nowhere (the segment sum drops them too). Codes are uint8, int16 or
// int32 (the narrowest type that holds the column list's codes and the
// padding code), so a code-typed kernel needs only H = min(G, 256) bins for
// uint8 and min(G, 32,768) for int16: no code reaches a bin past them.
//
// Replaces the XLA reduction _group_counts_jit
// (lapis_silo_tpu/ops/reductions.py:23-40), no Pallas kernel: it expanded
// every word into 32 int32 bits (32x the filter's bytes) and segment-summed
// them per partition. Here nothing is expanded.
//
// What bounds it on an H100: at the main path's size (2^20 sequences, one
// byte a code) the bytes take under 1 us, so latency does: the launch, the
// chain of dependent loads, the serial steps of a warp. The design cuts
// each:
// - one launch per card over every word shard of that card, the shard table
//   (each shard's words and codes addresses, width, first CTA and first
//   partition's numbers, kernels.k9_layout) passed by value as a
//   __grid_constant__ kernel parameter (read in place, never copied to
//   local memory), so no copy to the card precedes the launch; each CTA
//   finds its shard, then its partition and its run of at most `blk` words
//   inside that partition (k9_cta below, which
//   tests/test_torch_groupby_cards.py holds to the split listed there);
// - a lane owns one 16-byte quad of codes (16, 8 or 4 codes at 1, 2 or 4
//   bytes a code) and the bits of its word that the quad covers: it loads
//   the word, then the quad if one of those bits is set, one instruction a
//   warp, so a CTA waits for two DRAM round trips in all and a warp walks
//   16, 8 or 4 bit positions, each lane testing its bits in registers; a
//   warp of all-zero bits loads no codes;
// - for each bit position, when every counted lane has the same group (a
//   run of a sorted column) the first adds the lot with one shared-memory
//   atomic; otherwise each counted lane adds one, which costs less than
//   merging equal codes with __match_any_sync for codes in no order
//   (scripts/torch_groupby_ab.py);
// - counts arrives zeroed and its non-zero [H] bins are added into it, one
//   device-scope atomic each, at the CTA's end: the wrapper hands the
//   launch the output that the previous launch on the same stream zeroed,
//   and the CTAs together zero the next one (`spare`) with plain stores, so
//   no fill and no reduction across CTAs precede or follow the kernel.
//   Past 49,152 bins (int32 codes in the 2^20 + 1 bucket) the lanes add
//   straight into counts in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr long long kSmemMaxBins = 49152;  // 192 KB of int32 bins
#define K9_MAX_SHARDS 32  // shards of one card (kernels.K9_MAX_SHARDS)

struct Shard {
  long long words;  // address of the shard's words
  long long codes;  // address of its codes
  long long n;      // its words
  long long len0;   // its words in its first partition
  int cta_lo;       // its first CTA
  int c0;           // its CTAs in its first partition, ceil(len0 / blk)
  int p_lo;         // its first partition
};

struct Table {
  Shard shard[K9_MAX_SHARDS];
  int n_shards;
  int cf;  // CTAs of a whole partition, ceil(part_words / blk)
};

// CTA `cta`'s shard s, partition p and shard-local words [lo, hi): inside
// the shard's window the first partition's (partial) piece of c0 CTAs,
// then whole partitions of cf CTAs each (the last cut at the shard's end),
// blk words a CTA; the host's numbers (kernels.k9_layout) spare the
// divisions but one.
struct Run {
  int s;
  int p;
  long long lo;
  long long hi;
};

__device__ __forceinline__ Run k9_cta(const Table& t, int cta,
                                      long long part_words, int blk) {
  int s = 0;
  while (s + 1 < t.n_shards && t.shard[s + 1].cta_lo <= cta) ++s;
  const Shard& sh = t.shard[s];
  const int local = cta - sh.cta_lo;
  Run r;
  r.s = s;
  if (local < sh.c0) {
    r.p = sh.p_lo;
    r.lo = (long long)local * blk;
    r.hi = r.lo + blk < sh.len0 ? r.lo + blk : sh.len0;
    return r;
  }
  const unsigned k = (unsigned)(local - sh.c0);
  const unsigned q = k / (unsigned)t.cf;
  const long long start = sh.len0 + (long long)q * part_words;
  r.p = sh.p_lo + 1 + (int)q;
  r.lo = start + (long long)(k - q * (unsigned)t.cf) * blk;
  const long long hi = r.lo + blk < start + part_words ? r.lo + blk
                                                       : start + part_words;
  r.hi = hi < sh.n ? hi : sh.n;
  return r;
}

// Code b of a quad of codes held in four registers (b is a constant once
// the loop over bits is unrolled).
template <typename Code>
__device__ __forceinline__ int code_at(const uint32_t* r, int b) {
  if constexpr (sizeof(Code) == 1) {
    return (int)((r[b >> 2] >> (8 * (b & 3))) & 0xFFu);
  } else if constexpr (sizeof(Code) == 2) {
    return (int)(int16_t)(r[b >> 1] >> (16 * (b & 1)));
  } else {
    return (int)r[b];
  }
}

// counts: int32 [P, G], zero at the launch; spare: int32 [P, G] that the
// launch zeroes for the next one, or null; smem: bins in shared memory.
template <typename Code>
__global__ void __launch_bounds__(kMaxThreads) group_counts_kernel(
    const __grid_constant__ Table table, long long part_words, int blk,
    int n_groups, int n_bins, int n_partitions, int smem,
    int32_t* __restrict__ counts, int32_t* __restrict__ spare) {
  constexpr int kQuadCodes = 16 / (int)sizeof(Code);  // codes of a quad
  constexpr int kWordQuads = 32 / kQuadCodes;         // quads of a word
  constexpr uint32_t kMask = (1u << kQuadCodes) - 1u;
  extern __shared__ int32_t hist[];
  const int lane = threadIdx.x & 31;
  const Run run = k9_cta(table, blockIdx.x, part_words, blk);
  const Shard& sh = table.shard[run.s];
  const uint32_t* const words =
      reinterpret_cast<const uint32_t*>(sh.words) + run.lo;
  const uint4* const quads =
      reinterpret_cast<const uint4*>(sh.codes) + run.lo * kWordQuads;
  const long long n_quads = (run.hi - run.lo) * kWordQuads;
  int32_t* const out = counts + (long long)run.p * n_groups;
  int32_t* const bins = smem ? hist : out;
  if (smem) {
    for (int i = threadIdx.x; i < n_bins; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  if (spare != nullptr) {
    const long long n_out = (long long)n_partitions * n_groups;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_out; i += (long long)gridDim.x * blockDim.x) {
      spare[i] = 0;
    }
  }
  for (long long base = threadIdx.x & ~31; base < n_quads;
       base += blockDim.x) {
    const long long i = base + lane;
    const uint32_t bits =
        i < n_quads ? (__ldg(words + i / kWordQuads) >>
                       (i % kWordQuads * kQuadCodes)) & kMask
                    : 0u;
    if (!__any_sync(kFull, bits != 0u)) continue;  // uniform
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (bits) v = __ldg(quads + i);
    const uint32_t r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < kQuadCodes; ++b) {
      const int code = code_at<Code>(r, b);
      const bool counted = ((bits >> b) & 1u) && code >= 0;
      const unsigned active = __ballot_sync(kFull, counted);
      if (!active) continue;  // uniform
      const int g = code < n_groups - 1 ? code : n_groups - 1;
#ifdef K9_MATCH_ANY
      // the first design, built only by scripts/torch_groupby_ab.py to
      // compare: lanes of equal groups merged by __match_any_sync
      if (counted) {
        const unsigned peers = __match_any_sync(active, g);
        if (lane == __ffs(peers) - 1) atomicAdd(bins + g, __popc(peers));
      }
#else
      // a run of one group (a sorted column) adds once from its first
      // lane; otherwise each counted lane adds one
      const int first = __ffs(active) - 1;
      const int g0 = __shfl_sync(kFull, g, first);
      if (__all_sync(kFull, !counted || g == g0)) {
        if (lane == first) atomicAdd(bins + g0, __popc(active));
      } else if (counted) {
        atomicAdd(bins + g, 1);
      }
#endif
    }
  }
  if (!smem) return;
  __syncthreads();
  for (int g = threadIdx.x; g < n_bins; g += blockDim.x) {
    const int32_t v = hist[g];
    if (v) atomicAdd(out + g, v);
  }
}

template <typename Code>
int launch(const Table& table, int n_ctas, long long part_words, int blk,
           int threads, int n_groups, int n_bins, int n_partitions,
           void* counts, void* spare, cudaStream_t stream) {
  const int smem = n_bins <= kSmemMaxBins;
  const size_t smem_bytes = smem ? sizeof(int32_t) * (size_t)n_bins : 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_counts_kernel<Code>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  group_counts_kernel<Code><<<n_ctas, threads, smem_bytes, stream>>>(
      table, part_words, blk, n_groups, n_bins, n_partitions, smem,
      (int32_t*)counts, (int32_t*)spare);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py). shards
// is a HOST int64 array [n_shards, 7] (kernels.k9_table: words address,
// codes address, width, words in the first partition, first CTA, CTAs in
// the first partition, first partition), cf the CTAs of a whole partition,
// n_ctas the launch's CTAs at `blk` words a CTA; code_bytes 1, 2
// or 4 (uint8, int16, int32); n_bins H as above; counts int32 [P,
// n_groups], zero; spare int32 [P, n_groups] to be zeroed, or null.
// Returns cudaGetLastError() after the launch.
extern "C" int lapis_group_counts(const long long* shards, int n_shards,
                                  int cf, int n_ctas, long long part_words,
                                  int blk, int threads, int code_bytes,
                                  int n_groups, int n_bins, int n_partitions,
                                  void* counts, void* spare, void* stream) {
  if (n_ctas <= 0) return (int)cudaGetLastError();
  if (n_shards <= 0 || n_shards > K9_MAX_SHARDS || cf <= 0 ||
      part_words <= 0 || blk <= 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 || n_groups <= 0 || n_bins <= 0 || n_bins > n_groups ||
      n_partitions <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Table table = {};
  table.n_shards = n_shards;
  table.cf = cf;
  for (int s = 0; s < n_shards; ++s) {
    const long long* row = shards + 7 * s;
    table.shard[s] = Shard{row[0], row[1], row[2], row[3], (int)row[4],
                           (int)row[5], (int)row[6]};
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code_bytes) {
    case 1:
      return launch<uint8_t>(table, n_ctas, part_words, blk, threads,
                             n_groups, n_bins, n_partitions, counts, spare,
                             st);
    case 2:
      return launch<int16_t>(table, n_ctas, part_words, blk, threads,
                             n_groups, n_bins, n_partitions, counts, spare,
                             st);
    case 4:
      return launch<int32_t>(table, n_ctas, part_words, blk, threads,
                             n_groups, n_bins, n_partitions, counts, spare,
                             st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
