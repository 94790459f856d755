// K6: the filter VM over every word shard of one card, in one launch.
//
// Replaces the Mosaic kernel vm_run_sharded
// (lapis_silo_tpu/ops/pallas_kernels.py:741): K1's register machine
// (csrc/vm_run.cu, whose header gives the ISA and its clamping) on each word
// shard, and the shards' EMIT counts summed (the psum of :763). It computes
// what kernels.vm_run_sharded_plain computes, bit for bit:
//   - each segment runs on a zeroed register file, and reg[0] words are the
//     last segment's (zeros where the last segment is empty);
//   - inside a segment an EMIT_COUNT SETS its slot, so only the segment's
//     last EMIT per slot counts; counts add over segments, word blocks and
//     shards (int32, wrapping as the reference's int32 psum does).
// The host resolves the second rule before the launch (kernels.k6_program):
// each EMIT carries the slot it adds to, or none where a later EMIT of its
// segment sets the same slot or its operand is out of range.
//
// What bounds it on an H100: the bytes, at best. Each instruction reads one
// row word per word of the axis; the least traffic is each distinct row once
// (chip_smoke.py's vm_work). A batch's segments are short (3 to 42
// instructions, about 6 row reads each, in the 512-query batch), and K1's
// layout, a warp per (segment, word block), pays a fixed cost per segment
// (the code fetched, the register file zeroed, the EMIT list flushed) with
// few loads in flight. Measured on the card (scripts/torch_vm_ab.py, PERF.md),
// that fixed cost was not what held K1 back: its warps spend their time
// issuing the VM's own instructions (decode, register-file traffic in
// shared memory, branches on the mode), so the design cuts instructions per
// word as much as it keeps loads in flight:
//   - the host groups consecutive whole segments into ranges of about the
//     same instruction count, and a CTA of 4 warps runs one range over 4
//     word blocks: each warp walks every segment of the range, the code
//     tile is loaded into shared memory once for the CTA (padded so that no
//     step checks the tile's end), and a segment boundary costs only the
//     zeroing of the warp's registers;
//   - the wide form gives a lane 8 words, so decoding an instruction and
//     its branches are shared by 8 words; where every row, mask and output
//     of the card's shards is 16-byte aligned, a lane loads them as 2 runs
//     of 4 words (16-byte loads), and its registers sit in shared memory as
//     runs of 4 words (16-byte accesses, each bank once per 8 lanes);
//   - the row words of the next kPrefetch instructions (B_FULL reads the
//     full mask as a row) are loaded while the current kPrefetch run, across
//     segment boundaries (row operands do not depend on the registers);
//   - EMIT totals (a warp reduction each) add into a per-CTA accumulator in
//     shared memory, one entry per distinct slot of the range, and each
//     entry is flushed once per CTA with atomicAdd into the card's counts;
//   - every shard of the card runs in the same grid: a table of the shards'
//     pointers and widths (ragged widths included) travels with the code in
//     one copy, and a warp finds its shard from its word block. A word block
//     at a shard's ragged edge loads nothing past that shard's width.
// Two forms, as K1: wide (8 words a lane) when the card's word blocks times
// its segments fill the card and for a compaction, narrow (1) otherwise;
// the host chooses it.
//
// The filter's epilogue (kTail; a single program, one range), as K1's
// (csrc/vm_run.cu): the total popcount of the card's shards' reg[0] words,
// one 64-bit atomicAdd a CTA, and with a cap each shard's compact block
// (csrc/compact_tile.cuh), in place of the launches of K11 and K10 that
// ran after the VM. A CTA's 4 word blocks then lie in one shard: each
// shard's blocks are rounded up to whole CTAs (tiles), numbered shard after
// shard (kernels.tail_layout); with a cap a CTA's number comes from an
// atomic ticket, each tile ranks its words and finds its prefix among its
// shard's tiles by the look-back, and each shard has fill CTAs of its own
// (numbered shard after shard, their tickets after every tile's), so the
// shards' fills run side by side. The counts, the total, the ticket and
// the descriptors arrive zeroed in one buffer that the launch before on
// the same stream zeroed. A batch runs without it (kTail off).

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_tile.cuh"

namespace {

using lapis_compact::count_groups;
using lapis_compact::fill_shard;
using lapis_compact::scan_and_look_back;
using lapis_compact::take_ticket;
using lapis_compact::write_ranks;
using lapis_compact::zero_spare;

constexpr int kWarps = 4;         // word blocks (warps) per CTA
constexpr int kPrefetch = 2;      // instructions whose row words load ahead
constexpr int kTile = 256;        // instructions of code in shared memory
// the host's words per instruction (kernels.k6_program): operand, packed
// word, the byte offsets of registers ra and rb (bits 0-15, 16-31) in the
// warp's register file, and aux: 1 + the range-local slot of a counted EMIT
// (bits 0-12), the first instruction of a segment (bit 13), the byte offset
// of the destination register (bits 14-30); ra and rb clamped to
// n_regs - 1, the destination to the trash register n_regs
constexpr int kSlotMask = 0x1FFF;
constexpr int kSegStart = 1 << 13;
constexpr int kDstShift = 14;

// one shard, as kernels.shard_table packs it (ten int64 fields)
struct Shard {
  const uint32_t* bank;
  int64_t n_rows;
  const uint32_t* dyn;
  int64_t n_dyn;
  const uint32_t* sparse;
  int64_t n_sparse;
  const uint32_t* full;
  uint32_t* words;
  int64_t pw;
  int64_t unused;
};
static_assert(sizeof(Shard) == 80, "kernels.SHARD_FIELDS int64 per shard");

// one shard's epilogue, as kernels.tail_table packs it (six int64 fields):
// its compact block [1 + 2 cap] (0 without a cap), the global index of its
// word 0, its first tile and its tiles, its first fill CTA and its fill
// CTAs (0 without a cap)
struct TailShard {
  int64_t out;
  int64_t offset;
  int64_t tile_lo;
  int64_t n_tiles;
  int64_t fill_lo;
  int64_t n_fill;
};
static_assert(sizeof(TailShard) == 48, "kernels.TAIL_FIELDS int64 per shard");

// The epilogue of a single-program launch (kTail). `buf` arrives zeroed:
// [0] the total popcount of the words, [1] the ticket, [2 + t] tile t's
// descriptor; `spare` (spare_len entries, or null) is the next launch's
// buf, zeroed here. With cap >= 0 the launch compacts: n_tiles CTAs run
// the VM, n_fill more fill.
struct Tail {
  unsigned long long* buf;
  unsigned long long* spare;
  long long spare_len;
  const TailShard* shards;
  int cap;
  int n_tiles;
  int n_fill;
};

// The CTA's tile: blockIdx.x, or with a cap its ticket; a CTA whose ticket
// is past the tiles fills its part of its shard and gets -1.
__device__ __forceinline__ int tail_begin(const Tail& tail,
                                          const Shard* shards, int n_shards) {
  __shared__ int s_ticket;
  __shared__ unsigned s_count;
  __shared__ int32_t s_word0;
  zero_spare(tail.spare, tail.spare_len);
  if (tail.cap < 0) return blockIdx.x;
  const int tile = take_ticket(tail.buf + 1, &s_ticket);
  if (tile < tail.n_tiles) return tile;
  const int fill = tile - tail.n_tiles;
  int s = 0;
  while (s + 1 < n_shards && tail.shards[s + 1].fill_lo <= fill) ++s;
  const TailShard ts = tail.shards[s];
  fill_shard(tail.buf + 2, (int)ts.tile_lo, (int)ts.n_tiles, shards[s].words,
             shards[s].pw, (int32_t*)ts.out, ts.offset, tail.cap,
             fill - (int)ts.fill_lo, (int)ts.n_fill, &s_count, &s_word0);
  return -1;
}

// wire layout (vm.pack_wire)
__device__ __forceinline__ int wire_mode(int32_t s) { return (s >> 18) & 0xF; }
__device__ __forceinline__ int wire_bsrc(int32_t s) { return (s >> 22) & 0xF; }

// a lane's L words of one register in shared memory: L / 4 runs of 4 words
// (one 16-byte access each), run j of every lane side by side at 128 j
// words, so a warp's access to one run touches each bank once per 8 lanes
template <int L>
struct Vec {
  uint32_t w[L];
};

template <int L>
__device__ __forceinline__ Vec<L> load_vec(const uint32_t* p) {
  Vec<L> v;
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int j = 0; j < L / 4; ++j) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + 128 * j);
      v.w[4 * j] = q.x, v.w[4 * j + 1] = q.y, v.w[4 * j + 2] = q.z,
      v.w[4 * j + 3] = q.w;
    }
  } else {
    v.w[0] = p[0];
  }
  return v;
}

template <int L>
__device__ __forceinline__ void store_vec(uint32_t* p, const Vec<L>& v) {
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int j = 0; j < L / 4; ++j) {
      *reinterpret_cast<uint4*>(p + 128 * j) = make_uint4(
          v.w[4 * j], v.w[4 * j + 1], v.w[4 * j + 2], v.w[4 * j + 3]);
    }
  } else {
    p[0] = v.w[0];
  }
}

// A lane's L words of a word block of 32 L: L / V runs of V contiguous
// words, run j at w0 + 32 V j (w0 = the block's first word + V lane), so
// each load of the warp reads 128 V contiguous bytes. V = 4 takes 16-byte
// loads (every row, mask and output 16-byte aligned, widths multiples of
// 4), V = 1 any width; a run past the shard's ragged edge loads nothing.
template <int L, int V>
__device__ __forceinline__ Vec<L> load_words(const uint32_t* p,
                                             const bool (&live)[L / V]) {
  Vec<L> v;
#pragma unroll
  for (int j = 0; j < L / V; ++j) {
    if constexpr (V == 4) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (live[j]) q = __ldg(reinterpret_cast<const uint4*>(p + 128 * j));
      v.w[4 * j] = q.x, v.w[4 * j + 1] = q.y, v.w[4 * j + 2] = q.z,
      v.w[4 * j + 3] = q.w;
    } else {
      v.w[j] = live[j] ? __ldg(p + 32 * j) : 0u;
    }
  }
  return v;
}

// the b-operand words of instructions [base, base + kPrefetch) of the tile
// (code: operand, packed word, aux, 0): a row's words for bank/dyn/sparse
// sources and the full mask for B_FULL (`bank`, `dyn`, `sparse`, `full`
// already at the lane's w0), 0 otherwise. No branch: the code reads,
// addresses and loads of all kPrefetch issue together.
template <int L, int V>
__device__ __forceinline__ void load_chunk(
    Vec<L> (&b)[kPrefetch], const int4* code, int base, const uint32_t* bank,
    const uint32_t* dyn, const uint32_t* sparse, const uint32_t* full,
    int n_rows, int n_dyn, int n_sparse, uint32_t row_bytes,
    const bool (&live)[L / V]) {
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u) {
    const int2 c = reinterpret_cast<const int2*>(code + base + u)[0];
    const int bsrc = wire_bsrc(c.y);  // uniform across the warp
    const bool is_row = bsrc >= 1 && bsrc <= 4;  // the full mask as a row
    const uint32_t* src = bsrc == 1 ? bank : bsrc == 2 ? dyn
                          : bsrc == 3 ? sparse : full;
    const int n_src = bsrc == 1 ? n_rows : bsrc == 2 ? n_dyn
                      : bsrc == 3 ? n_sparse : 1;
    const uint32_t r = (uint32_t)min(max(c.x, 0), n_src - 1);
    bool row_live[L / V];
#pragma unroll
    for (int j = 0; j < L / V; ++j) row_live[j] = is_row && live[j];
    b[u] = load_words<L, V>(
        (const uint32_t*)((const char*)src + (uint64_t)r * row_bytes),
        row_live);
  }
}

// run instructions [base, base + kPrefetch) of the tile on the warp's
// registers (`regs`: the lane's first run of register 0; register r is
// 32 L r words further)
template <int L>
__device__ __forceinline__ void exec_chunk(
    const Vec<L> (&bv)[kPrefetch], const int4* code, int base,
    uint32_t* regs, int n_regs, const Vec<L>& fw, int lane, int32_t* acc) {
  constexpr int kBlockW = 32 * L;
  char* const file = reinterpret_cast<char*>(regs);
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u) {
    const int4 c = code[base + u];
    const int32_t s = c.y;
    if (c.w & kSegStart) {  // fresh registers (the trash one is never read)
      const Vec<L> zero = {};
#pragma unroll 1
      for (int r = 0; r < n_regs; ++r) store_vec<L>(regs + r * kBlockW, zero);
    }
    const Vec<L> a = load_vec<L>(
        reinterpret_cast<const uint32_t*>(file + (c.z & 0xFFFF)));
    const Vec<L> b = wire_bsrc(s) == 0
        ? load_vec<L>(reinterpret_cast<const uint32_t*>(
              file + ((uint32_t)c.z >> 16)))
        : bv[u];
    Vec<L> val;
    switch (wire_mode(s)) {  // uniform across the warp
      case 0:
        val = b;
        break;
      case 1:
#pragma unroll
        for (int k = 0; k < L; ++k) val.w[k] = a.w[k] & b.w[k];
        break;
      case 2:
#pragma unroll
        for (int k = 0; k < L; ++k) val.w[k] = a.w[k] | b.w[k];
        break;
      case 3:
#pragma unroll
        for (int k = 0; k < L; ++k) val.w[k] = a.w[k] ^ b.w[k];
        break;
      default:
#pragma unroll
        for (int k = 0; k < L; ++k) val.w[k] = a.w[k] & (b.w[k] ^ fw.w[k]);
        break;
    }
    store_vec<L>(reinterpret_cast<uint32_t*>(file + (c.w >> kDstShift)), val);
    if (c.w & kSlotMask) {  // a counted EMIT: popcount(a) before the write
      int bits = 0;
#pragma unroll
      for (int k = 0; k < L; ++k) bits += __popc(a.w[k]);
      const int32_t total = __reduce_add_sync(0xffffffffu, bits);
      if (lane == 0 && total) atomicAdd(acc + (c.w & kSlotMask) - 1, total);
    }
  }
}

// After the VM, by every thread of tile `tile` (of the shard whose tail is
// `ts`): the lane's reg[0] words (`last`, those not live or with
// zero_words as 0; the lane's run j is the shard's words w0 + 32 V j, V of
// them) into the total and, with a cap, ranked and written. Run j of the
// lane is group warp * (L / V) + j of the tile.
template <int L, int V>
__device__ __forceinline__ void tail_end(const Tail& tail,
                                         const TailShard& ts,
                                         const Vec<L>& last,
                                         const bool (&live)[L / V], int w0,
                                         int zero_words, int tile) {
  constexpr int kRuns = L / V;
  __shared__ unsigned s_pop[kWarps];
  __shared__ int s_group[kWarps * kRuns];
  __shared__ unsigned s_excl, s_incl;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t w[kRuns][V];
  long long first[kRuns];
  int before[kRuns];
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      w[j][i] = live[j] && !zero_words ? last.w[V * j + i] : 0u;
      bits += __popc(w[j][i]);
    }
    first[j] = ts.offset + w0 + 32 * V * j;
  }
  bits = __reduce_add_sync(0xffffffffu, bits);
  if (lane == 0) s_pop[warp] = bits;
  const bool compact = tail.cap >= 0;
  if (compact) {
    // the fill CTAs read word 0 once the shard's first tile's prefix is out
    if (tile == ts.tile_lo) __threadfence();
    count_groups<kRuns, V>(w, 1, kRuns, s_group, before);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += s_pop[i];
    if (sum) atomicAdd(tail.buf, (unsigned long long)sum);
  }
  if (!compact) return;
  if (warp == 0) {
    scan_and_look_back(kWarps * kRuns, s_group, tail.buf + 2, tile,
                       (int)ts.tile_lo, &s_excl, &s_incl);
  }
  __syncthreads();
  int32_t* const out = (int32_t*)ts.out;
  write_ranks<kRuns, V>(w, first, before, s_group, 1, kRuns, s_excl,
                        tail.cap, out);
  if (tile == ts.tile_lo + ts.n_tiles - 1 && threadIdx.x == 0) {
    out[0] = (int32_t)s_incl;
  }
}

template <int L, int V, bool kTail>
__global__ void __launch_bounds__(32 * kWarps) vm_run_sharded_kernel(
    const Shard* __restrict__ shards, int n_shards,
    const int32_t* __restrict__ code, int n_instr,
    const int32_t* __restrict__ range_lo,
    const int32_t* __restrict__ slot_off,
    const int32_t* __restrict__ range_slots, int n_wgroups,
    int64_t n_wblocks, int acc_words, int n_regs, int zero_words,
    int32_t* __restrict__ counts, const Tail tail) {
  constexpr int kBlockW = 32 * L;  // words per warp
  // the code tile apart from the registers, so its reads are known not to
  // alias their writes
  __shared__ int4 s_code[kTile + 3 * kPrefetch];
  extern __shared__ int4 smem[];
  int32_t* acc = (int32_t*)smem;  // [acc_words], a multiple of 4
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this lane's L words of register 0; register r is r * kBlockW further
  uint32_t* regs = (uint32_t*)(acc + acc_words) +
                   (size_t)warp * (n_regs + 1) * kBlockW +
                   lane * (L % 4 ? 1 : 4);
  int tile = blockIdx.x;
  if constexpr (kTail) {
    tile = tail_begin(tail, shards, n_shards);
    if (tile < 0) return;  // a fill CTA, done
  }
  const int range = kTail ? 0 : blockIdx.x / n_wgroups;
  // the warp's shard and its word block there (uniform across the warp)
  int s = 0;
  int64_t wblock;
  bool active;  // no early return: barriers follow
  if constexpr (kTail) {
    // the tile's shard, and the tile's 4 word blocks in it
    while (s + 1 < n_shards && tail.shards[s + 1].tile_lo <= tile) ++s;
    wblock = (tile - tail.shards[s].tile_lo) * kWarps + warp;
    active = wblock < (shards[s].pw + kBlockW - 1) / kBlockW;
  } else {
    // word blocks vary fastest: neighbouring CTAs share the range's code
    const int64_t g = (int64_t)(blockIdx.x % n_wgroups) * kWarps + warp;
    active = g < n_wblocks;
    wblock = g;
    for (; s < n_shards - 1; ++s) {
      const int64_t nb = (shards[s].pw + kBlockW - 1) / kBlockW;
      if (wblock < nb) break;
      wblock -= nb;
    }
  }
  const Shard sh = shards[s];
  // row counts fit int32 and rows 4 GB (kernels.shard_table checks)
  const int n_rows = (int)sh.n_rows, n_dyn = (int)sh.n_dyn;
  const int n_sparse = (int)sh.n_sparse, pw = (int)sh.pw;
  const uint32_t row_bytes = 4u * (uint32_t)pw;
  const int w0 = (int)wblock * kBlockW + V * lane;
  bool live[L / V];
#pragma unroll
  for (int j = 0; j < L / V; ++j) live[j] = active && w0 + 32 * V * j < pw;
  const Vec<L> fw = load_words<L, V>(sh.full + w0, live);
  for (int i = threadIdx.x; i < acc_words; i += blockDim.x) acc[i] = 0;

  // the range's code in tiles of kTile instructions (a batch's range is
  // one tile; a long segment streams through several)
  const int lo = range_lo[range];
  const int hi = range_lo[range + 1];
  for (int t = lo; t < hi; t += kTile) {
    const int n = min(kTile, hi - t);
    // padded to whole pairs of chunks and one chunk more (the last
    // prefetch) with instructions that write only the trash register
    const int n_pad =
        (n + 2 * kPrefetch - 1) / (2 * kPrefetch) * (2 * kPrefetch) + kPrefetch;
    __syncthreads();  // every warp is done with the tile before
    for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
      // a pad reads register 0 and writes the trash register
      s_code[i] = i < n ? make_int4(code[t + i], code[n_instr + t + i],
                                    code[2 * n_instr + t + i],
                                    code[3 * n_instr + t + i])
                        : make_int4(0, 0, 0,
                                    (n_regs * kBlockW * 4) << kDstShift);
    }
    __syncthreads();
    if (active) {
      // two buffers: one chunk's row words load while the other's run
      Vec<L> b0[kPrefetch], b1[kPrefetch];
      load_chunk<L, V>(b0, s_code, 0, sh.bank + w0, sh.dyn + w0,
                       sh.sparse + w0, sh.full + w0, n_rows, n_dyn, n_sparse,
                       row_bytes, live);
      for (int base = 0; base < n; base += 2 * kPrefetch) {
        load_chunk<L, V>(b1, s_code, base + kPrefetch, sh.bank + w0,
                         sh.dyn + w0, sh.sparse + w0, sh.full + w0, n_rows,
                         n_dyn, n_sparse, row_bytes, live);
        exec_chunk<L>(b0, s_code, base, regs, n_regs, fw, lane, acc);
        load_chunk<L, V>(b0, s_code, base + 2 * kPrefetch, sh.bank + w0,
                         sh.dyn + w0, sh.sparse + w0, sh.full + w0, n_rows,
                         n_dyn, n_sparse, row_bytes, live);
        exec_chunk<L>(b1, s_code, base + kPrefetch, regs, n_regs, fw, lane,
                      acc);
      }
    }
  }
  __syncthreads();
  // each of the range's slots once per CTA
  const int32_t* slots = range_slots + slot_off[range];
  const int n_slots = slot_off[range + 1] - slot_off[range];
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    if (acc[i]) atomicAdd(counts + slots[i], acc[i]);
  }
  // reg[0] of the program's last segment, which the last range ran
  if (kTail || range == gridDim.x / n_wgroups - 1) {
    const Vec<L> last = load_vec<L>(regs);
#pragma unroll
    for (int j = 0; j < L / V; ++j) {
      if (!live[j]) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sh.words[w0 + 32 * V * j + i] = zero_words ? 0u : last.w[V * j + i];
      }
    }
  }
  if constexpr (kTail) {
    tail_end<L, V>(tail, tail.shards[s], load_vec<L>(regs), live, w0,
                   zero_words, tile);
  }
}

template <int L, int V, bool kTail>
int launch(const void* shards, int n_shards, const void* code, int n_instr,
           const void* range_lo, const void* slot_off, const void* range_slots,
           int n_ranges, long long n_wblocks, int max_slots, int n_regs,
           int zero_words, void* counts, const Tail& tail,
           cudaStream_t stream) {
  const long long n_wgroups = (n_wblocks + kWarps - 1) / kWarps;
  if (n_wgroups * n_ranges > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  // with the epilogue: its tiles, and the fill CTAs of a compaction
  const long long n_ctas =
      kTail ? tail.n_tiles + (tail.cap >= 0 ? tail.n_fill : 0)
            : n_wgroups * n_ranges;
  // a multiple of 4, so the registers after it stay 16-byte aligned
  const int acc_words = (max_slots + 3) / 4 * 4;
  const size_t smem = sizeof(int32_t) * (size_t)acc_words +
                      sizeof(uint32_t) * kWarps * (size_t)(n_regs + 1) * 32 * L;
  // 48 KB with the static code tile (and the epilogue's shared words)
  if (smem > 40 * 1024 - (kTail ? 1024 : 0)) {
    const cudaError_t err = cudaFuncSetAttribute(
        vm_run_sharded_kernel<L, V, kTail>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  vm_run_sharded_kernel<L, V, kTail>
      <<<(unsigned)n_ctas, 32 * kWarps, smem, stream>>>(
          (const Shard*)shards, n_shards, (const int32_t*)code, n_instr,
          (const int32_t*)range_lo, (const int32_t*)slot_off,
          (const int32_t*)range_slots, (int)n_wgroups, n_wblocks, acc_words,
          n_regs, zero_words, (int32_t*)counts, tail);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py), for the
// shards of one card. All pointers are on the card (kernels.k6_block lays
// them out in one block):
//   shards       Shard [n_shards], 8-byte aligned (kernels.shard_table);
//   code         int32 [4][n_instr]: the operands, the packed words, the
//                register offsets and the aux words (kSlotMask above);
//   range_lo     int32 [n_ranges + 1]: the ranges' first instructions, then
//                n_instr; each range is whole non-empty segments;
//   slot_off     int32 [n_ranges + 1] and range_slots: range r's counted
//                slots are range_slots[slot_off[r], slot_off[r + 1]), at
//                most max_slots of them;
//   counts       int32 [4096], zeroed; the card's shards' EMIT totals are
//                added into it.
// lane_words is 8 (wide) or 1 (narrow), vec 1 for 16-byte loads (wide only:
// every shard's rows, masks and outputs 16-byte aligned, widths multiples
// of 4), n_wblocks the card's word blocks of 32 x lane_words words summed
// over its shards, zero_words 1 where reg[0] comes out 0 (no instruction,
// or an empty last segment).
// A batch passes no `tails` and no `tail`. With them the launch runs one
// program (one range) with the filter's epilogue: `tails` is TailShard
// [n_shards] (kernels.tail_table: each shard's block, offset, first tile,
// tiles, first fill CTA and fill CTAs; each shard's word blocks rounded up
// to whole tiles of 4, so n_wblocks is 4 x the tiles, numbered from 0;
// with a cap the fill CTAs numbered from 0, at least one a shard); `tail`
// is uint64 [tail_len], zero: [0] the total popcount of the card's words,
// [1] the ticket, [2 + t] tile t's descriptor; `spare` (uint64
// [spare_len], or null) is zeroed for the next launch. With cap >= 0 every
// shard's block is written. Returns cudaGetLastError() after the launch.
extern "C" int lapis_vm_run_sharded(
    const void* shards, const void* tails, int n_shards, const void* code,
    int n_instr, const void* range_lo, const void* slot_off,
    const void* range_slots, int n_ranges, int lane_words, int vec,
    long long n_wblocks, int max_slots, int n_regs, int zero_words,
    void* counts, void* tail, long long tail_len, void* spare,
    long long spare_len, int cap, int n_fill, void* stream) {
  if (n_wblocks <= 0 || n_ranges <= 0) return (int)cudaGetLastError();
  const long long n_tiles = n_wblocks / kWarps;
  if (!(lane_words == 8 || (lane_words == 1 && !vec)) ||
      (tails == nullptr) != (tail == nullptr) ||
      (tail != nullptr &&
       (n_ranges != 1 || n_wblocks % kWarps || n_tiles > 0x7FFFFFFFLL ||
        tail_len < 2 + (cap >= 0 ? n_tiles : 0) ||
        (cap >= 0 && n_fill < 1)))) {
    return (int)cudaErrorInvalidValue;
  }
  const Tail epilogue{(unsigned long long*)tail, (unsigned long long*)spare,
                      spare == nullptr ? 0 : spare_len,
                      (const TailShard*)tails, cap, (int)n_tiles, n_fill};
  const auto run =
      tail == nullptr
          ? (lane_words == 1 ? launch<1, 1, false>
             : vec           ? launch<8, 4, false>
                             : launch<8, 1, false>)
          : (lane_words == 1 ? launch<1, 1, true>
             : vec           ? launch<8, 4, true>
                             : launch<8, 1, true>);
  return run(shards, n_shards, code, n_instr, range_lo, slot_off,
             range_slots, n_ranges, n_wblocks, max_slots, n_regs, zero_words,
             counts, epilogue, (cudaStream_t)stream);
}
