// K4 and K5: densify sparse-tier leaves into dense rows of pw words.
//
// For each of K leaves, every entry of the leaf's n_per_leaf stream segments
// (starts/lens [K, n_per_leaf]) whose global word index lies in the window
// [w_off, w_off + pw) is stored at its place in the window, and every other
// word of the row is zero: row[idx[e] - w_off] = words[e].
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
// shards.
//
// The stream's contract: within each (leaf, partition) segment the word
// indices strictly ascend (the engine's stream does by construction and
// checks it at build, device_engine._check_stream). Partitions own disjoint
// word windows, so plain stores are exact (scatter = OR = sum) and need no
// atomics. The TPU forms are dropped: the windowed DMA over a
// block-interleaved stream, the MXU one-hot scatter, the bounded-tile
// part_h0 bases and the SMEM caps on starts/lens.
//
// What bounds it on an H100: the rows it writes, K x pw x 4 bytes (268 MB
// for 1,024 leaves at pw = 65,536, 1.07 GB for a 4,096-leaf pool update),
// against 8 bytes read per entry (a few hundred per leaf and partition at
// the synthetic corpus' density: under 3% of the bytes). So each output
// word is written once, as part of whole sectors: one CTA of 256 threads
// per (leaf, tile of 8,192 words of the window) zeroes its tile in shared
// memory, finds in each of the leaf's segments the entries that fall in the
// tile (a warp per segment; a 32-ary search over the ascending indices,
// both ends at once: one dependent load for a segment outside the tile or
// of up to 32 entries, two up to 1,024), stores them into the tile, and
// writes the tile to its row by one bulk copy (TMA), or, where the output
// is not 16-byte aligned or the tile's width not a multiple of 4 words, by
// 16-byte stores with scalars at the edges. The grid of K x ceil(pw / 8,192)
// CTAs, a leaf's tiles side by side, fills the 132 SMs evenly whatever the
// skew of entries per leaf, and 6 CTAs share an SM (33 KB of shared memory
// each), so their searches hide each other's latency. (Measured beside it:
// 16-byte stores for every tile, tiles of 4,096 words with 128 or 256
// threads, and persistent CTAs that build one tile while the bulk copy of
// another drains were all slower; PERF.md.) Row offsets and window
// positions are int64 (8,192 slots x 327,680 words is past 2^31). Entries
// outside the stream or the window are skipped, a K5 slot outside the
// pool's rows writes nothing, and an entry the search brings in from a
// stream that breaks the contract is stored only inside the tile, so no
// stream can write outside the row or the tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8192;     // words of one CTA's tile (32 KB)
constexpr int kSegBatch = 64;   // segments searched per scatter pass

// [l, r) of a search for the first entry whose index is >= a target (r if
// none): the answer lies in [l, r] and the search ends when l == r.
struct Search {
  int64_t l, r;
};

// Lane i's sample of [l, r): lane 0 the first entry, lane 31 the last, the
// others evenly between.
__device__ __forceinline__ int64_t sample_at(const Search& s, int i) {
  return s.l + ((int64_t)i * (s.r - s.l - 1)) / 31;
}

// One step of a warp's search, after each lane loaded its sample's index v:
// the ballot narrows [l, r) to the gap before the first sample that is >=
// the target, so a segment wholly below or above the target, or one of up
// to 32 entries, resolves in one step. Uniform across the warp.
__device__ __forceinline__ void search_step(Search& s, int32_t v,
                                            int64_t target) {
  const bool live = s.l < s.r;
  const unsigned ball =
      __ballot_sync(0xFFFFFFFFu, live && (int64_t)v >= target);
  if (!live) return;
  if (ball == 0u) {
    s.l = s.r;
    return;
  }
  const int j = __ffs(ball) - 1;
  if (j == 0) {
    s.r = s.l;
    return;
  }
  const int64_t at = sample_at(s, j);
  s.l = sample_at(s, j - 1) + 1;
  s.r = at;
}

// The entries [first, last) of segment [lo, hi) whose index lies in
// [g_lo, g_hi), by the whole warp: the two searches step together, so
// their loads are in flight at once.
__device__ __forceinline__ void segment_range(const int32_t* __restrict__ idx,
                                              int64_t lo, int64_t hi,
                                              int64_t g_lo, int64_t g_hi,
                                              int lane, int64_t* first,
                                              int64_t* last) {
  Search a{lo, hi}, b{lo, hi};
  while (a.l < a.r || b.l < b.r) {
    const int32_t va = a.l < a.r ? __ldg(idx + sample_at(a, lane)) : 0;
    const int32_t vb = b.l < b.r ? __ldg(idx + sample_at(b, lane)) : 0;
    search_step(a, va, g_lo);
    search_step(b, vb, g_hi);
  }
  *first = a.l;
  *last = b.l;
}

// Leaf k's words [g_lo, g_lo + n) into `tile` in shared memory: zeroed,
// then each segment's entries in the range found (a warp per segment) and
// stored. Ends with the tile complete and visible to the CTA.
__device__ __forceinline__ void build_tile(
    uint32_t* tile, int64_t* seg_first, int64_t* seg_last,
    const int32_t* __restrict__ idx, const uint32_t* __restrict__ words,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
    int n_per_leaf, int64_t n_entries, int64_t k, int64_t g_lo, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  for (int j = threadIdx.x; j < kTile / 4; j += kThreads)
    tile4[j] = make_uint4(0u, 0u, 0u, 0u);
  for (int p0 = 0; p0 < n_per_leaf; p0 += kSegBatch) {
    const int nb = n_per_leaf - p0 < kSegBatch ? n_per_leaf - p0 : kSegBatch;
    for (int s = threadIdx.x; s < nb; s += kThreads) {
      const int64_t seg = k * n_per_leaf + p0 + s;
      const int64_t start = __ldg(starts + seg);
      const int64_t lo = start < 0 ? 0 : start;
      int64_t hi = start + __ldg(lens + seg);
      hi = hi < n_entries ? hi : n_entries;
      seg_first[s] = lo;
      seg_last[s] = hi < lo ? lo : hi;
    }
    __syncthreads();
    for (int s = warp; s < nb; s += kWarps) {
      int64_t first, last;
      segment_range(idx, seg_first[s], seg_last[s], g_lo, g_lo + n, lane,
                    &first, &last);
      __syncwarp();  // every lane has read the segment's bounds
      if (lane == 0) {
        seg_first[s] = first;
        seg_last[s] = last;
      }
    }
    __syncthreads();  // the ranges, and the zeroed tile
    for (int s = 0; s < nb; ++s) {
      const int64_t last = seg_last[s];
      for (int64_t e = seg_first[s] + threadIdx.x; e < last; e += kThreads) {
        const int64_t i = (int64_t)__ldg(idx + e) - g_lo;
        if (i >= 0 && i < n) tile[i] = __ldg(words + e);
      }
    }
    __syncthreads();  // seg_first/seg_last free again
  }
  __syncthreads();  // the tile (also where the leaf has no segment)
}

// The tile's n words to dst: one bulk copy (TMA) issued by thread 0 where dst
// is 16-byte aligned and n a multiple of 4 (then true: a bulk group is
// committed, and the tile may be overwritten only once it has been read);
// else 16-byte stores by every thread, scalars at the edges.
__device__ __forceinline__ bool store_tile(const uint32_t* tile, uint32_t* dst,
                                           int n) {
  if (((uintptr_t)dst & 15u) == 0 && (n & 3) == 0) {
    // the threads' shared-memory stores made visible to the bulk copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t src = (uint32_t)__cvta_generic_to_shared(tile);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          :: "l"(dst), "r"(src), "r"(n * 4) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    return true;
  }
  int head = (int)(((16u - ((uintptr_t)dst & 15u)) & 15u) >> 2);
  head = head < n ? head : n;
  const int n4 = (n - head) >> 2;
  if ((int)threadIdx.x < head) dst[threadIdx.x] = tile[threadIdx.x];
  uint4* dst4 = reinterpret_cast<uint4*>(dst + head);
  for (int j = threadIdx.x; j < n4; j += kThreads) {
    const uint32_t* src = tile + head + 4 * j;
    dst4[j] = make_uint4(src[0], src[1], src[2], src[3]);
  }
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += kThreads)
    dst[i] = tile[i];
  return false;
}

// One CTA per (leaf, tile).
__global__ void __launch_bounds__(kThreads) densify_kernel(
    const int32_t* __restrict__ idx, const uint32_t* __restrict__ words,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ lens,
    int n_per_leaf, int64_t pw, int64_t w_off, int64_t n_entries,
    int n_tiles, const int32_t* __restrict__ slots, int64_t n_rows,
    uint32_t* __restrict__ out) {
  __shared__ __align__(128) uint32_t tile[kTile];
  __shared__ int64_t seg_first[kSegBatch], seg_last[kSegBatch];
  const int64_t k = blockIdx.x / n_tiles;
  const int64_t t = blockIdx.x % n_tiles;
  const int64_t row = slots != nullptr ? (int64_t)__ldg(slots + k) : k;
  if (row < 0 || row >= n_rows) return;  // the whole CTA
  const int64_t base = t * kTile;
  const int n = (int)(pw - base < kTile ? pw - base : kTile);
  build_tile(tile, seg_first, seg_last, idx, words, starts, lens, n_per_leaf,
             n_entries, k, w_off + base, n);
  if (store_tile(tile, out + row * pw + base, n) && threadIdx.x == 0) {
    // the tile's shared memory must outlive the copy's reads of it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

int launch(const void* idx, const void* words, const void* starts,
           const void* lens, long long n_leaves, int n_per_leaf,
           long long pw, long long w_off, long long n_entries,
           const void* slots, long long n_rows, void* out, void* stream) {
  if (n_leaves <= 0 || pw <= 0) return (int)cudaGetLastError();
  const long long n_tiles = (pw + kTile - 1) / kTile;
  if (n_leaves * n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  densify_kernel<<<(unsigned)(n_leaves * n_tiles), kThreads, 0,
                   (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const uint32_t*)words, (const int32_t*)starts,
      (const int32_t*)lens, n_per_leaf, pw, w_off, n_entries, (int)n_tiles,
      (const int32_t*)slots, n_rows, (uint32_t*)out);
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
                n_entries, nullptr, n_leaves, out, stream);
}

// `slots` [n_leaves] must be distinct rows of the pool's n_rows (the wrapper
// or the engine checks); a slot outside them writes nothing.
extern "C" int lapis_densify_rows_into_pool(const void* idx, const void* words,
                                            const void* starts,
                                            const void* lens, long long n_leaves,
                                            int n_per_leaf, long long pw,
                                            long long w_off,
                                            long long n_entries,
                                            const void* slots,
                                            long long n_rows, void* pool,
                                            void* stream) {
  return launch(idx, words, starts, lens, n_leaves, n_per_leaf, pw, w_off,
                n_entries, slots, n_rows, pool, stream);
}
