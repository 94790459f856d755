// K2: the Mutations reduction over the dense bank, for the rows
// [start, start + n_rows), in the pieces of the row where the filter has a
// set bit:
//   out[r] = sum over the pieces [lo, hi) of `pieces` whose filter words
//     filter[lo, hi) are not all zero of
//     sum_{w in [lo, hi)} popc(bank[start + r, w] & filter[w]),
//   out[n_rows] = the sum of hi - lo over those pieces: the words of each
//     row the launch read (it read n_rows times as many).
// A piece is part of one partition's own words (its genomes' words, not the
// padding up to the widest partition), clipped to the bank's word window,
// at most kPieceWords long (kernels.K2_PIECE_WORDS; kernels.dense_pieces
// builds the table); words outside every piece count nothing.
//
// Replaces the naive form of mutation_counts_banked
// (lapis_silo_tpu/ops/pallas_kernels.py:150). The TPU kernel streamed
// 256-row x 2048-word tiles through VMEM with a row_block-aligned start; here
// `start` is any row and rows need no bucketing. A lineage-partitioned
// deployment has few dense rows a segment over many partitions (29 of
// about 565 own words in 1,000 at lineage1m), and a query's filter reaches
// about a third of them: one warp per row over the whole flat axis would
// make a few blocks that each walk 29,000 words, the padding and the
// unreached partitions included.
//
// What bounds it on an H100: reading the rows' words in the reached
// pieces, once each (one popcount and one AND per 4 bytes). How the design
// meets it: a block takes one piece and a tile of kRowsPerBlock rows (8, a
// warp each: of 8, 16 and 32 the fastest at both the lineage and the
// bring-up shapes, PERF.md); it first loads the piece's filter words into
// shared memory (from L2: every tile of the piece reads them) and leaves
// where all are zero, so a query reads only the partitions its filter
// reaches; its warps then stream their
// rows' slices of the piece with 16-byte loads where every row starts
// 16-byte aligned (pw % 4 == 0; the slice is widened to whole quads, the
// filter's copy zero outside the piece), 4-byte loads otherwise, AND them
// with the shared copy (a lane's kBatch loads of a row all in flight before
// the first is used), reduce with a warp shuffle and add the sum into
// out[r] with one int32 atomic per non-zero (row, piece) sum (integer sums:
// any order gives the same count). Many rows or many pieces both make many
// blocks, so a wide bank of one partition and a few rows over many
// partitions both fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerBlock = 8;
constexpr int kBatch = 8;
constexpr int64_t kPieceWords = 2048;
// the widened slice: a piece and up to 3 words on either side
constexpr int kSharedWords = (int)kPieceWords + 8;

__device__ __forceinline__ uint32_t popc_and4(uint4 x, uint4 f) {
  return __popc(x.x & f.x) + __popc(x.y & f.y) + __popc(x.z & f.z) +
         __popc(x.w & f.w);
}

__global__ void __launch_bounds__(kThreads) mutation_counts_kernel(
    const uint32_t* __restrict__ bank, const uint32_t* __restrict__ filter,
    const int32_t* __restrict__ pieces, int64_t n_pieces, int64_t start,
    int64_t n_rows, int64_t pw, int vectorized, int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t shared_filter[kSharedWords];
  const int64_t piece = blockIdx.x % n_pieces;
  const int64_t tile = blockIdx.x / n_pieces;
  int64_t lo = __ldg(pieces + 2 * piece);
  int64_t hi = __ldg(pieces + 2 * piece + 1);
  lo = lo < 0 ? 0 : (lo < pw ? lo : pw);
  hi = hi < lo ? lo : (hi < pw ? hi : pw);
  hi = hi - lo < kPieceWords ? hi : lo + kPieceWords;
  // the slice each row reads: whole quads around the piece where the rows
  // are 16-byte aligned (pw % 4 == 0, so the last quad ends inside the row)
  const int64_t base = vectorized ? (lo & ~(int64_t)3) : lo;
  const int64_t end = vectorized ? ((hi + 3) & ~(int64_t)3) : hi;
  const int n = (int)(end - base);
  int any = 0;
  // every load of the piece's filter words in flight at once (at most
  // kSharedWords / kThreads = 9 a thread)
#pragma unroll
  for (int k = 0; k < (kSharedWords + kThreads - 1) / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int64_t w = base + i;
    const uint32_t word =
        (i < n && w >= lo && w < hi) ? __ldg(filter + w) : 0u;
    if (i < n) shared_filter[i] = word;
    any |= word != 0u;
  }
  // a piece where the filter is all zero adds 0 to every row: leave
  // before reading the bank
  if (!__syncthreads_or(any)) return;
  if (tile == 0 && threadIdx.x == 0) atomicAdd(out + n_rows, (int32_t)(hi - lo));
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < kRowsPerBlock; t += kWarps) {
    const int64_t r = tile * kRowsPerBlock + t;
    if (r >= n_rows) break;  // the whole warp leaves together
    const uint32_t* row = bank + (start + r) * pw + base;
    uint32_t acc = 0;
    // kBatch loads of a lane in flight before the first is used: a row's
    // slice of a lineage partition (about 565 words) is one batch
    if (vectorized) {
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      const uint4* filter4 = reinterpret_cast<const uint4*>(shared_filter);
      const int n4 = n >> 2;
      for (int j0 = lane; j0 < n4; j0 += 32 * kBatch) {
        uint4 x[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          x[k] = j0 + 32 * k < n4 ? __ldg(row4 + j0 + 32 * k)
                                  : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (j0 + 32 * k < n4) acc += popc_and4(x[k], filter4[j0 + 32 * k]);
      }
    } else {
      for (int j0 = lane; j0 < n; j0 += 32 * kBatch) {
        uint32_t x[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          x[k] = j0 + 32 * k < n ? __ldg(row + j0 + 32 * k) : 0u;
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (j0 + 32 * k < n) acc += __popc(x[k] & shared_filter[j0 + 32 * k]);
      }
    }
    acc = __reduce_add_sync(0xffffffffu, acc);
    if (lane == 0 && acc) atomicAdd(out + r, (int32_t)acc);
  }
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py). `out`
// [n_rows + 1] must be zero. Returns cudaGetLastError() after the launch.
extern "C" int lapis_mutation_counts(const void* bank, const void* filter,
                                     const void* pieces, long long n_pieces,
                                     long long start, long long n_rows,
                                     long long pw, void* out, void* stream) {
  if (n_rows <= 0 || n_pieces <= 0) return (int)cudaGetLastError();
  const int vectorized = (pw % 4 == 0) && ((uintptr_t)bank % 16 == 0);
  const long long n_tiles = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  mutation_counts_kernel<<<(unsigned)(n_tiles * n_pieces), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)bank, (const uint32_t*)filter, (const int32_t*)pieces,
      n_pieces, start, n_rows, pw, vectorized, (int32_t*)out);
  return (int)cudaGetLastError();
}
