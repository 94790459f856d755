// K1: the filter VM, a register machine over the flat global word axis.
//
// Replaces the Mosaic kernel vm_run (lapis_silo_tpu/ops/pallas_kernels.py:526)
// and computes what the XLA interpreter computes
// (build_run_one_with_emit, lapis_silo_tpu/ops/vm.py:610-712), which is the
// form the reference's tests run:
//   - every instruction writes reg[min(dst, n_regs)], NOPs and EMITs too
//     (they target the trash register n_regs);
//   - ra and rb clamp to n_regs-1, row operands clip to [0, rows-1];
//   - mode 0..3 = MOVB/AND/OR/XOR, any other mode = ANDN (a & (b ^ full));
//     bsrc 0..4 = reg/bank/dyn/sparse/full, any other bsrc = 0;
//   - EMIT_COUNT SETS counts[operand] to popcount(reg[ra]) read before the
//     write; an operand in [-4096, 0) wraps by 4096 as the XLA scatter does,
//     any other operand outside [0, 4096) is dropped.
//
// Segments: the program comes split into segments (seg_starts [n_seg + 1];
// one segment [0, n_instr] is the whole program). Each segment runs on a
// zeroed register file and its EMIT counts add to the other segments'; reg[0]
// is the last segment's. A batch of independent queries
// (DeviceEngine.batch_args) gives each self-contained query its own segment,
// so this equals the serial run of the whole program.
//
// Layout: one warp per (segment, block of 32 x L words), each lane holding L
// words (lane, lane + 32, ... of the block, so every row load of the warp
// reads 128 contiguous bytes). A warp's register file lives in its own slice
// of shared memory as [n_regs + 1][L][32] u32; a lane touches only its own
// columns, and the warps of a CTA share nothing, so the kernel has no CTA
// barrier. The warp reads its segment's code 32 instructions at a time, one
// per lane, and broadcasts each with __shfl_sync; the next 32 are loaded
// while these run.
//
// Two forms, 4 warps a CTA, chosen per launch from the grid against the
// card's SM count:
//   - wide (L = 4) when the grid gives every SM a CTA: a 512-query batch at
//     2,048 words runs 449 x 16 warps. Decoding an instruction, and its
//     branches on the b-source and the mode (uniform across the warp), are
//     shared by a lane's 4 words, which keeps the issue slots for loads and
//     the ALU;
//   - narrow (L = 1) otherwise: one long segment (a single program, or a
//     batch run serially) at 2,048 words is 64 warps on 16 SMs instead of 16
//     warps on 4, each walking the chain of instructions with a quarter of
//     the work.
//
// What bounds it on an H100: each instruction reads one row word per word of
// the axis, so the least traffic is each distinct row read once (the rows of a
// batch repeat across queries and mostly hit the 50 MB L2); each segment is a
// serial chain, so a naive loop pays the full load latency on every
// instruction. The loop loads the memory operands of kPrefetch instructions
// first (they do not depend on the registers) and then executes them, so one
// latency is paid per kPrefetch instructions, and a wide grid holds enough
// warps to hide it behind other segments.
// EMIT_COUNT is a warp reduction; lane 0 keeps the warp's list of (slot,
// count) pairs with "set" semantics (a bit per slot says whether the list
// holds it: a new slot is appended, a repeated one found by a ballot over 32
// entries at a time and overwritten), and at the end the warp adds
// each entry into the global counts with atomicAdd: the sum over word blocks
// of a segment's last value per slot, plus the other segments'. The list has
// one entry per instruction of the longest segment at most (4,096 slots at
// most), so a warp of a batch segment keeps a handful of entries instead of a
// 4,096-slot table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                     // warps (segment blocks) per CTA
constexpr int kMaxBatch = 4096;               // EMIT_COUNT slots (vm.MAX_BATCH_QUERIES)
constexpr int kPrefetch = 8;                  // memory operands loaded ahead per chunk

// wire layout (vm.pack_wire)
__device__ __forceinline__ int wire_dst(int32_t s) { return s & 0x3F; }
__device__ __forceinline__ int wire_ra(int32_t s) { return (s >> 6) & 0x3F; }
__device__ __forceinline__ int wire_rb(int32_t s) { return (s >> 12) & 0x3F; }
__device__ __forceinline__ int wire_mode(int32_t s) { return (s >> 18) & 0xF; }
__device__ __forceinline__ int wire_bsrc(int32_t s) { return (s >> 22) & 0xF; }
__device__ __forceinline__ int wire_opcode(int32_t s) { return (s >> 26) & 0x3; }

__device__ __forceinline__ int64_t clip_row(int32_t operand, int64_t n_rows) {
  const int64_t r = operand < 0 ? 0 : (int64_t)operand;
  return r < n_rows ? r : n_rows - 1;
}

template <int kLaneWords>  // words per lane
__global__ void __launch_bounds__(32 * kWarps) vm_run_kernel(
    const int32_t* __restrict__ opers, const int32_t* __restrict__ specs,
    const int32_t* __restrict__ seg_starts, int n_seg,
    int list_cap, int64_t n_wblocks, const uint32_t* __restrict__ bank,
    int64_t n_rows, const uint32_t* __restrict__ dyn, int64_t n_dyn,
    const uint32_t* __restrict__ sparse, int64_t n_sparse,
    const uint32_t* __restrict__ full, int64_t pw, int n_regs,
    uint32_t* __restrict__ words, int32_t* __restrict__ counts) {
  constexpr int kBlockW = 32 * kLaneWords;  // words per warp
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t unit = (int64_t)blockIdx.x * kWarps + warp;
  if (unit >= n_wblocks * n_seg) return;  // no CTA barrier follows
  // word blocks vary fastest: a CTA's warps share the segment's code and
  // read neighbouring words of the same rows
  const int64_t wblock = unit % n_wblocks;
  const int seg = (int)(unit / n_wblocks);
  const int lo = seg_starts[seg];
  const int hi = seg_starts[seg + 1];

  // this warp's slice: registers [(n_regs + 1) * kBlockW], the list, and a
  // bit per EMIT slot, set once the list holds it
  uint32_t* regs = smem + (size_t)warp * ((n_regs + 1) * kBlockW +
                                          2 * list_cap + kMaxBatch / 32);
  int32_t* list_slot = (int32_t*)(regs + (n_regs + 1) * kBlockW);
  int32_t* list_val = list_slot + list_cap;
  uint32_t* listed = (uint32_t*)(list_val + list_cap);
  int list_len = 0;  // the same in every lane

  // the lane's words are w0 + 32 k; those past the ragged edge load
  // nothing, so their registers stay 0
  const int64_t w0 = wblock * kBlockW + lane;
  bool live[kLaneWords];
  uint32_t fw[kLaneWords];
#pragma unroll
  for (int k = 0; k < kLaneWords; ++k) {
    live[k] = w0 + k * 32 < pw;
    fw[k] = live[k] ? full[w0 + k * 32] : 0u;
  }
  for (int i = lane; i < (n_regs + 1) * kBlockW; i += 32) regs[i] = 0u;
  for (int i = lane; i < kMaxBatch / 32; i += 32) listed[i] = 0u;
  __syncwarp();

  // the code of a tile of 32 instructions, one per lane; the next tile's is
  // loaded while this one runs
  int32_t my_oper = lane < hi - lo ? opers[lo + lane] : 0;
  int32_t my_spec = lane < hi - lo ? specs[lo + lane] : 0;
  for (int tile = lo; tile < hi; tile += 32) {
    const int n_tile = min(32, hi - tile);
    const int next = tile + 32 + lane;
    const int32_t next_oper = next < hi ? opers[next] : 0;
    const int32_t next_spec = next < hi ? specs[next] : 0;
    for (int base = 0; base < n_tile; base += kPrefetch) {
      int32_t oper[kPrefetch], spec[kPrefetch];
      uint32_t bv[kPrefetch][kLaneWords];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        oper[u] = __shfl_sync(0xffffffffu, my_oper, (base + u) & 31);
        spec[u] = __shfl_sync(0xffffffffu, my_spec, (base + u) & 31);
        // every branch here and below is uniform across the warp
        const int bsrc = base + u < n_tile ? wire_bsrc(spec[u]) : 0;
        if (bsrc >= 1 && bsrc <= 3) {
          const uint32_t* row =
              bsrc == 1 ? bank + clip_row(oper[u], n_rows) * pw
              : bsrc == 2 ? dyn + clip_row(oper[u], n_dyn) * pw
                          : sparse + clip_row(oper[u], n_sparse) * pw;
#pragma unroll
          for (int k = 0; k < kLaneWords; ++k) {
            bv[u][k] = live[k] ? __ldg(row + w0 + k * 32) : 0u;
          }
        } else {
#pragma unroll
          for (int k = 0; k < kLaneWords; ++k) bv[u][k] = bsrc == 4 ? fw[k] : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        if (base + u >= n_tile) break;  // uniform across the warp
        const int32_t s = spec[u];
        const uint32_t* ra = regs + min(wire_ra(s), n_regs - 1) * kBlockW + lane;
        const uint32_t* rb = regs + min(wire_rb(s), n_regs - 1) * kBlockW + lane;
        uint32_t* rd = regs + min(wire_dst(s), n_regs) * kBlockW + lane;
        uint32_t a[kLaneWords], b[kLaneWords];
#pragma unroll
        for (int k = 0; k < kLaneWords; ++k) {
          a[k] = ra[k * 32];
          b[k] = wire_bsrc(s) == 0 ? rb[k * 32] : bv[u][k];
        }
        uint32_t val[kLaneWords];
        switch (wire_mode(s)) {
          case 0:
#pragma unroll
            for (int k = 0; k < kLaneWords; ++k) val[k] = b[k];
            break;
          case 1:
#pragma unroll
            for (int k = 0; k < kLaneWords; ++k) val[k] = a[k] & b[k];
            break;
          case 2:
#pragma unroll
            for (int k = 0; k < kLaneWords; ++k) val[k] = a[k] | b[k];
            break;
          case 3:
#pragma unroll
            for (int k = 0; k < kLaneWords; ++k) val[k] = a[k] ^ b[k];
            break;
          default:
#pragma unroll
            for (int k = 0; k < kLaneWords; ++k) val[k] = a[k] & (b[k] ^ fw[k]);
            break;
        }
#pragma unroll
        for (int k = 0; k < kLaneWords; ++k) rd[k * 32] = val[k];
        if (wire_opcode(s) == 1) {  // EMIT_COUNT, uniform across the warp
          int bits = 0;
#pragma unroll
          for (int k = 0; k < kLaneWords; ++k) bits += __popc(a[k]);
          const int32_t total = __reduce_add_sync(0xffffffffu, bits);
          const int32_t oi = oper[u] < 0 ? oper[u] + kMaxBatch : oper[u];
          if (oi >= 0 && oi < kMaxBatch) {
            // a slot emitted before is found by a ballot over the list, 32
            // entries at a time; a new one (the usual case) is appended
            int found = -1;
            const bool again = (listed[oi >> 5] >> (oi & 31)) & 1u;
            for (int k0 = 0; again && k0 < list_len; k0 += 32) {
              const unsigned hit = __ballot_sync(
                  0xffffffffu,
                  k0 + lane < list_len && list_slot[k0 + lane] == oi);
              if (hit) {
                found = k0 + __ffs(hit) - 1;
                break;
              }
            }
            if (found < 0) found = list_len++;
            if (lane == 0) {
              list_slot[found] = oi;
              list_val[found] = total;
              listed[oi >> 5] |= 1u << (oi & 31);
            }
            __syncwarp();
          }
        }
      }
    }
    my_oper = next_oper;
    my_spec = next_spec;
  }
  __syncwarp();
  if (seg == n_seg - 1) {
#pragma unroll
    for (int k = 0; k < kLaneWords; ++k) {
      if (live[k]) words[w0 + k * 32] = regs[k * 32 + lane];
    }
  }
  for (int k = lane; k < list_len; k += 32) {
    const int32_t v = list_val[k];
    if (v) atomicAdd(counts + list_slot[k], v);
  }
}

template <int kLaneWords>
int launch(const int32_t* block, int n_instr, int n_seg, int list_cap,
           const void* bank, long long n_rows, const void* dyn,
           long long n_dyn, const void* sparse, long long n_sparse,
           const void* full, long long pw, int n_regs, void* words,
           void* counts, cudaStream_t stream) {
  constexpr long long kBlockW = 32 * kLaneWords;
  const long long n_wblocks = (pw + kBlockW - 1) / kBlockW;
  const long long n_ctas = (n_wblocks * n_seg + kWarps - 1) / kWarps;
  if (n_ctas > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(uint32_t) * kWarps *
      ((size_t)(n_regs + 1) * kBlockW + 2 * (size_t)list_cap + kMaxBatch / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vm_run_kernel<kLaneWords>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  vm_run_kernel<kLaneWords><<<(unsigned)n_ctas, 32 * kWarps, smem, stream>>>(
      block, block + n_instr, block + 2 * n_instr, n_seg, list_cap, n_wblocks,
      (const uint32_t*)bank, n_rows, (const uint32_t*)dyn, n_dyn,
      (const uint32_t*)sparse, n_sparse, (const uint32_t*)full, pw, n_regs,
      (uint32_t*)words, (int32_t*)counts);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py).
// `block` is the program's code block, int32 [2 n_instr + n_seg + 1]: the
// operands, the packed words, then the n_seg + 1 non-decreasing segment
// starts from 0 to n_instr. `list_cap` is at least the number of distinct
// EMIT slots of any segment (its longest segment's length serves). `counts`
// must be zeroed by the caller. Returns cudaGetLastError() after the launch.
extern "C" int lapis_vm_run(const void* block, int n_instr, int n_seg,
                            int list_cap, const void* bank, long long n_rows,
                            const void* dyn, long long n_dyn,
                            const void* sparse, long long n_sparse,
                            const void* full, long long pw, int n_regs,
                            void* words, void* counts, void* stream) {
  if (pw <= 0 || n_seg <= 0) return (int)cudaGetLastError();
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  // the wide form once its grid gives every SM a CTA of 4 warps
  const long long wide_units = (pw + 127) / 128 * n_seg;
  const auto run = wide_units >= (long long)kWarps * n_sm ? launch<4>
                                                          : launch<1>;
  return run((const int32_t*)block, n_instr, n_seg, list_cap, bank, n_rows,
             dyn, n_dyn, sparse, n_sparse, full, pw, n_regs, words, counts,
             (cudaStream_t)stream);
}
