// K10 and K11: the compact extraction and the word popcount over every word
// shard of one card, one launch each.
//
// The engine's routes take both from the VM launch that writes the filter
// (csrc/vm_run.cu, csrc/vm_run_sharded.cu), which ranks its tiles with the
// same device code (csrc/compact_tile.cuh); these launches serve words that
// are already on the card (kernels.compact_nonzero_sharded,
// kernels.popcount_words_sharded).
//
// K10 compact_nonzero: for each shard (its words [n], its word 0 being
// global word `offset`) one int32 block [1 + 2 cap]:
//   [0]                  the count of non-zero words, not capped;
//   [1, 1 + cap)         the global indices of the first `cap` of them,
//                        ascending;
//   [1 + cap, 1 + 2 cap) their words;
// slots past the count hold index `offset` and the shard's word 0 (0 for an
// empty shard): the reference's fill value 0. Replaces the compact output of
// the XLA interpreter's finish (lapis_silo_tpu/ops/vm.py:505-514: a sum,
// jnp.nonzero(size=cap, fill_value=0) and a gather), no Pallas kernel; its
// plain version is reductions.compact_nonzero.
//
// K11 popcount_words: the total population count of the card's shards'
// words, into an int64. Replaces _popcount_words_jit
// (lapis_silo_tpu/ops/reductions.py:19-20, XLA), no Pallas kernel; its
// plain version is reductions.popcount_words.
//
// What bounds them on an H100: both read each word once, and K10 writes
// 4 (1 + 2 cap) bytes a shard. At the main path's sizes (32,768 flat words,
// cap 16,384) the bytes take about 0.2 us, so latency does: the launch and
// the chain of dependent memory trips. The design cuts both:
// - one launch per card over every word shard of that card; the shard
//   table (each shard's words and block addresses, width, offset, first
//   tile and tiles, kernels.compact_layout / compact_table) is passed by
//   value as a __grid_constant__ parameter, so no copy precedes the launch;
// - a CTA of 256 threads takes a tile of 1,024 16-byte quads (4,096 words)
//   and each thread loads its 4 quads at once, neighbouring lanes on
//   neighbouring quads. The quads are aligned down to 16 bytes from the
//   shard's first word, so a shard may start at any word (a view into a
//   larger tensor); words of an edge quad outside the shard are masked to
//   0. Such a quad never crosses a 16-byte boundary, hence never a page;
// - K10 ranks a tile's non-zero words (csrc/compact_tile.cuh) with one
//   __ballot_sync per word of a quad (the lanes below count by __popc), and
//   one warp scans the 32 per-warp totals of the tile (8 warps x 4 quads).
//   Tiles of a shard are ordered by a single-pass decoupled look-back: each
//   tile publishes its total (flag A), then walks its predecessors 32 at a
//   time with one warp until it meets an inclusive prefix (flag P), then
//   publishes its own.
//   A descriptor is one 64-bit word (flag, value), written and read whole.
//   Tile ids come from an atomic ticket, not blockIdx: CTAs are not
//   scheduled in order, and a look-back waiting on a tile whose CTA has
//   not started could deadlock; with the ticket every predecessor is
//   running. Tiles whose prefix is at or past cap write nothing but their
//   descriptor; the shard's last tile writes the count and the fill, by
//   16-byte stores;
// - K10's scratch (the ticket, then one descriptor a tile) and K11's total
//   arrive zeroed: the wrapper keeps a spare of each per stream, and the
//   launch zeroes the spare for the next launch on that stream with plain
//   stores (K9's scheme), so no fill precedes the kernel;
// - K11 sums a CTA's 4,096 words by a warp reduction (__reduce_add_sync)
//   and one in shared memory, then adds it with one 64-bit atomicAdd.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_tile.cuh"

namespace {

using namespace lapis_compact;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 4;                        // quads a thread
constexpr long long kTileQuads = kThreads * kQuads;  // 1,024 quads a tile
#define COMPACT_MAX_SHARDS 32  // kernels.COMPACT_MAX_SHARDS

struct Shard {
  long long words;   // address of the shard's words (4-byte aligned)
  long long out;     // address of its block, int32 [1 + 2 cap] (K10)
  long long n;       // its words
  long long offset;  // the global index of its word 0
  int tile_lo;       // its first tile
  int n_tiles;       // its tiles, at least 1
};

struct Table {
  Shard shard[COMPACT_MAX_SHARDS];
  int n_shards;
};

// A tile's shard and its quads: quad q holds the shard's words
// [4 q - head, 4 q - head + 4), head being the shard's first word's place in
// its 16-byte quad.
struct Tile {
  int s;
  int local;  // the tile's index within its shard
  int head;
  const uint4* quads;
  long long n_quads;
};

__device__ __forceinline__ Tile find_tile(const Table& t, int tile) {
  int s = 0;
  while (s + 1 < t.n_shards && t.shard[s + 1].tile_lo <= tile) ++s;
  const Shard& sh = t.shard[s];
  Tile r;
  r.s = s;
  r.local = tile - sh.tile_lo;
  r.head = (int)((sh.words & 15) >> 2);
  r.quads = reinterpret_cast<const uint4*>(sh.words - 4 * r.head);
  r.n_quads = (r.head + sh.n + 3) >> 2;
  return r;
}

// Quad q of the tile's shard into w[4], words outside [0, n) as 0.
__device__ __forceinline__ void load_quad(const Tile& t, long long n,
                                          long long q, uint32_t* w) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (q < t.n_quads) v = __ldg(t.quads + q);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
  const long long first = 4 * q - t.head;
  if (first < 0 || first + 4 > n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (first + j < 0 || first + j >= n) w[j] = 0u;
    }
  }
}

// scratch: [0] the ticket, [1 + t] tile t's descriptor, zero at the launch;
// spare: `spare_len` entries the launch zeroes for the next one, or null.
__global__ void __launch_bounds__(kThreads) compact_kernel(
    const __grid_constant__ Table table, int cap,
    unsigned long long* __restrict__ scratch,
    unsigned long long* __restrict__ spare, int spare_len) {
  __shared__ int s_tile;
  __shared__ int s_group[kQuads * kWarps];  // group counts, then prefixes
  __shared__ unsigned s_excl;               // the tile's prefix in its shard
  __shared__ unsigned s_count;              // the shard's count (last tile)
  const int tid = threadIdx.x;
  zero_spare(spare, spare_len);
  const int tile = take_ticket(scratch, &s_tile);
  unsigned long long* const desc = scratch + 1;
  const Tile t = find_tile(table, tile);
  const Shard& sh = table.shard[t.s];
  uint32_t w[kQuads][4];
  long long first[kQuads];  // the global index of each quad's first word
  int before[kQuads];  // non-zero words of the warp's lanes under this one
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const long long q = t.local * kTileQuads + k * kThreads + tid;
    load_quad(t, sh.n, q, w[k]);
    first[k] = sh.offset + 4 * q - t.head;
  }
  // quad k of warp w is group k * kWarps + w: the 32 groups in word order
  count_groups<kQuads, 4>(w, kWarps, 1, s_group, before);
  __syncthreads();
  if ((tid >> 5) == 0) {
    scan_and_look_back(kQuads * kWarps, s_group, desc, tile, sh.tile_lo,
                       &s_excl, &s_count);
  }
  __syncthreads();
  int32_t* const out = reinterpret_cast<int32_t*>(sh.out);
  write_ranks<kQuads, 4>(w, first, before, s_group, kWarps, 1, s_excl, cap,
                         out);
  if (t.local != sh.n_tiles - 1) return;
  const unsigned count = s_count;
  if (tid == 0) out[0] = (int32_t)count;
  if (count >= (unsigned)cap) return;
  const int32_t word0 =
      sh.n > 0 ? __ldg(reinterpret_cast<const int32_t*>(sh.words)) : 0;
  fill_run(out + 1 + count, cap - (long long)count, (int32_t)sh.offset);
  fill_run(out + 1 + cap + count, cap - (long long)count, word0);
}

// total: uint64, zero at the launch; spare: uint64 the launch zeroes for the
// next one, or null.
__global__ void __launch_bounds__(kThreads) popcount_kernel(
    const __grid_constant__ Table table,
    unsigned long long* __restrict__ total,
    unsigned long long* __restrict__ spare) {
  __shared__ unsigned s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (spare != nullptr && blockIdx.x == 0 && tid == 0) *spare = 0ull;
  const Tile t = find_tile(table, blockIdx.x);
  const long long n = table.shard[t.s].n;
  uint32_t w[kQuads][4];
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    load_quad(t, n, t.local * kTileQuads + k * kThreads + tid, w[k]);
  }
  unsigned c = 0u;
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c += __popc(w[k][j]);
  }
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) s_warp[tid >> 5] = c;
  __syncthreads();
  if (tid >= 32) return;
  c = __reduce_add_sync(kFull, lane < kWarps ? s_warp[lane] : 0u);
  if (lane == 0 && c) atomicAdd(total, (unsigned long long)c);
}

int read_table(const long long* shards, int n_shards, int n_tiles,
               Table* table) {
  if (n_shards <= 0 || n_shards > COMPACT_MAX_SHARDS || n_tiles <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  *table = Table{};
  table->n_shards = n_shards;
  int next = 0;
  for (int s = 0; s < n_shards; ++s) {
    const long long* row = shards + 6 * s;
    const Shard sh{row[0], row[1], row[2], row[3], (int)row[4], (int)row[5]};
    if (sh.words % 4 || sh.n < 0 || sh.tile_lo != next || sh.n_tiles < 1 ||
        (long long)sh.n_tiles * kTileQuads <
            ((sh.words & 15) / 4 + sh.n + 3) / 4) {
      return (int)cudaErrorInvalidValue;
    }
    next += sh.n_tiles;
    table->shard[s] = sh;
  }
  return next == n_tiles ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py). shards
// is a HOST int64 array [n_shards, 6] (kernels.compact_table: words address,
// block address, width, offset, first tile, tiles; the tiles consecutive
// from 0 and covering each shard's quads), n_tiles the launch's tiles
// (CTAs). Each returns cudaGetLastError() after the launch.
//
// K10: cap >= 0; scratch uint64 [1 + n_tiles], zero; spare uint64
// [spare_len] to be zeroed, or null.
extern "C" int lapis_compact_nonzero(const long long* shards, int n_shards,
                                     int n_tiles, int cap, void* scratch,
                                     void* spare, int spare_len,
                                     void* stream) {
  Table table;
  const int bad = read_table(shards, n_shards, n_tiles, &table);
  if (bad) return bad;
  if (cap < 0 || scratch == nullptr || spare_len < 0) {
    return (int)cudaErrorInvalidValue;
  }
  compact_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      table, cap, (unsigned long long*)scratch, (unsigned long long*)spare,
      spare == nullptr ? 0 : spare_len);
  return (int)cudaGetLastError();
}

// K11: total uint64, zero; spare uint64 to be zeroed, or null.
extern "C" int lapis_popcount_words(const long long* shards, int n_shards,
                                    int n_tiles, void* total, void* spare,
                                    void* stream) {
  Table table;
  const int bad = read_table(shards, n_shards, n_tiles, &table);
  if (bad) return bad;
  if (total == nullptr) return (int)cudaErrorInvalidValue;
  popcount_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      table, (unsigned long long*)total, (unsigned long long*)spare);
  return (int)cudaGetLastError();
}
