// The compaction of words into a shard's block, shared by K10
// (csrc/compact.cu) and the VM launches that compact the filter they write
// (K1 in csrc/vm_run.cu, K6 in csrc/vm_run_sharded.cu).
//
// A shard's block is int32 [1 + 2 cap]: [0] the count of its non-zero
// words, not capped; [1, 1 + cap) the global indices of the first `cap` of
// them, ascending; [1 + cap, 1 + 2 cap) their words; slots past the count
// hold index `offset` (the shard's word 0) and that word (0 for an empty
// shard): the reference's fill value 0 (lapis_silo_tpu/ops/vm.py:505-514).
//
// A CTA ranks a tile of consecutive words of one shard. Its threads hold
// the words in "groups": group g holds 32 lanes x E consecutive words,
// lane-major, and the groups follow each other in word order. Each group
// is one warp's round r, at index r * round_stride + warp * warp_stride
// (at most 32 groups):
//   1. count_groups: per group one __ballot_sync per word of a lane, each
//      lane's count of non-zero words of the lanes below it, each group's
//      total into shared memory;
//   2. scan_groups (one warp): the group totals into exclusive prefixes;
//   3. scan_and_look_back: the tile's prefix within its shard, by a
//      single-pass decoupled look-back: the tile publishes its total (flag
//      A), reads its predecessors 32 at a time with one warp until it
//      meets an inclusive prefix (flag P), then publishes its own. A
//      descriptor is one 64-bit word (flag, value), written and read whole,
//      so no fence orders a flag against its value. The tile numbers come
//      from an atomic ticket, not blockIdx, so every predecessor of a tile
//      has started and the walk never waits on a CTA that cannot run;
//   4. write_ranks: each non-zero word below cap to its slot.
// The descriptors (one u64 per tile after the ticket) arrive zeroed: the
// launch before on the same stream zeroed them (zero_spare). The slots
// past a shard's count are filled by the shard's last tile (K10) or, in a
// VM launch, by fill CTAs whose tickets come after every tile's
// (fill_shard).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lapis_compact {

constexpr unsigned kFull = 0xffffffffu;
// descriptor flags, in the high 32 bits; the low 32 hold the value
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr unsigned long long kFlagMask = ~0xffffffffull;

__device__ __forceinline__ void publish(unsigned long long* d,
                                        unsigned long long flag,
                                        unsigned value) {
  atomicExch(d, flag | value);
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* d) {
  return *reinterpret_cast<const volatile unsigned long long*>(d);
}

// The tile's number: an atomic ticket on scratch[0], broadcast to the CTA.
__device__ __forceinline__ int take_ticket(unsigned long long* scratch,
                                           int* s_ticket) {
  if (threadIdx.x == 0) *s_ticket = (int)atomicAdd(scratch, 1ull);
  __syncthreads();
  return *s_ticket;
}

// spare[0, n) = 0 by every thread of the grid: the next launch's zeroed
// scratch, with plain stores.
__device__ __forceinline__ void zero_spare(unsigned long long* spare,
                                           long long n) {
  if (spare == nullptr) return;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    spare[i] = 0ull;
  }
}

// Step 1 for this thread's kRounds groups of kE words w (0 outside the
// shard): before[r] = the non-zero words of round r in the lanes below
// this one; lane 0 stores each group's total at s_group[group].
template <int kRounds, int kE>
__device__ __forceinline__ void count_groups(
    const uint32_t (&w)[kRounds][kE], int round_stride, int warp_stride,
    int* s_group, int (&before)[kRounds]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    int total = 0;
    int under = 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const unsigned m = __ballot_sync(kFull, w[r][e] != 0u);
      total += __popc(m);
      under += __popc(m & below);
    }
    before[r] = under;
    if (lane == 0) s_group[r * round_stride + warp * warp_stride] = total;
  }
}

// Step 2, by all 32 lanes of one warp after a barrier: s_group[0, n_groups)
// becomes exclusive prefixes within the tile; returns the tile's total.
__device__ __forceinline__ unsigned scan_groups(int n_groups, int* s_group) {
  const int lane = threadIdx.x & 31;
  const int x = lane < n_groups ? s_group[lane] : 0;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane < n_groups) s_group[lane] = incl - x;
  return (unsigned)__shfl_sync(kFull, incl, 31);
}

// Steps 2 and 3, by all 32 lanes of one warp after a barrier: the groups
// scanned; `tile` (whose shard's first tile is `tile_lo`) publishes
// its descriptor in desc[] and finds its prefix within the shard; *s_excl
// and *s_incl get the tile's exclusive and inclusive prefixes.
__device__ __forceinline__ void scan_and_look_back(
    int n_groups, int* s_group, unsigned long long* desc, int tile,
    int tile_lo, unsigned* s_excl, unsigned* s_incl) {
  const int lane = threadIdx.x & 31;
  const unsigned total = scan_groups(n_groups, s_group);
  unsigned excl = 0u;
  if (tile == tile_lo) {
    if (lane == 0) publish(desc + tile, kPrefix, total);
  } else {
    if (lane == 0) publish(desc + tile, kAggregate, total);
    // lane i reads tile look - i; tiles before the shard's first count as
    // a prefix of 0 (the first tile itself always publishes a prefix, so
    // the walk stops there at the latest)
    int look = tile - 1;
    while (true) {
      const int pred = look - lane;
      const unsigned long long d =
          pred >= tile_lo ? peek(desc + pred) : kPrefix;
      const unsigned long long flag = d & kFlagMask;
      const unsigned prefixes = __ballot_sync(kFull, flag == kPrefix);
      const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
      const unsigned window = stop == 31 ? kFull : (2u << stop) - 1u;
      if (__ballot_sync(kFull, flag == 0ull) & window) continue;
      excl += __reduce_add_sync(kFull, lane <= stop ? (unsigned)d : 0u);
      if (prefixes) break;
      look -= 32;
    }
    if (lane == 0) publish(desc + tile, kPrefix, excl + total);
  }
  if (lane == 0) {
    *s_excl = excl;
    *s_incl = excl + total;
  }
}

// Step 4 after a barrier: this thread's non-zero words to their ranks below
// cap in `out` (the shard's block), the tile's words starting at rank
// `excl`, group r's words being the global words first[r] + e.
template <int kRounds, int kE>
__device__ __forceinline__ void write_ranks(
    const uint32_t (&w)[kRounds][kE], const long long (&first)[kRounds],
    const int (&before)[kRounds], const int* s_group, int round_stride,
    int warp_stride, unsigned excl, int cap, int32_t* out) {
  if (excl >= (unsigned)cap) return;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    unsigned rank = excl +
                    (unsigned)s_group[r * round_stride + warp * warp_stride] +
                    (unsigned)before[r];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (w[r][e] != 0u) {
        if (rank < (unsigned)cap) {
          out[1 + rank] = (int32_t)(first[r] + e);
          out[1 + cap + rank] = (int32_t)w[r][e];
        }
        ++rank;
      }
    }
  }
}

// p[0, n) = v by every thread of the CTA: single words up to p's first
// 16-byte boundary and after the last, 16-byte stores between (a block's
// rows start at any word).
__device__ __forceinline__ void fill_run(int32_t* p, long long n, int32_t v) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (n <= 0) return;
  const unsigned misaligned = (unsigned)((uintptr_t)p & 15u);
  long long head = (long long)(((16u - misaligned) & 15u) >> 2);
  if (head > n) head = n;
  if (tid < head) p[tid] = v;
  int4* const q = reinterpret_cast<int4*>(p + head);
  const long long n4 = (n - head) >> 2;
  const int4 v4 = make_int4(v, v, v, v);
  for (long long i = tid; i < n4; i += nt) q[i] = v4;
  const long long done = head + 4 * n4;
  if (tid < n - done) p[done + tid] = v;
}

// A fill CTA of a VM launch that compacts (its ticket past the launch's
// tiles, so every tile has started): for a shard whose tiles are
// [tile_lo, tile_lo + n_tiles), wait for its first tile's prefix (its word
// 0 is then visible: that tile fences its words before publishing) and its
// last tile's (the shard's count), then fill part `part` of `n_parts` of
// the slots past the count. `words` is the shard's words as the launch
// wrote them (n of them). Every thread of the CTA calls it.
__device__ __forceinline__ void fill_shard(
    const unsigned long long* desc, int tile_lo, int n_tiles,
    const uint32_t* words, long long n, int32_t* out, long long offset,
    int cap, int part, int n_parts, unsigned* s_count, int32_t* s_word0) {
  if (threadIdx.x == 0) {
    const int last = tile_lo + n_tiles - 1;
    unsigned long long d;
    while ((peek(desc + tile_lo) & kFlagMask) != kPrefix ||
           ((d = peek(desc + last)) & kFlagMask) != kPrefix) {
    }
    __threadfence();
    *s_count = (unsigned)d;
    *s_word0 = n > 0 ? (int32_t)__ldcg(words) : 0;
  }
  __syncthreads();
  const unsigned count = *s_count;
  if (count >= (unsigned)cap) return;
  const long long m = cap - (long long)count;
  const long long chunk = (m + n_parts - 1) / n_parts;
  const long long lo = count + (long long)part * chunk;
  const long long len = lo >= cap ? 0 : (cap - lo < chunk ? cap - lo : chunk);
  fill_run(out + 1 + lo, len, (int32_t)offset);
  fill_run(out + 1 + cap + lo, len, *s_word0);
}

}  // namespace lapis_compact
