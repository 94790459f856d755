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
// Layout: one CTA per kBlockW words, one word per thread. The register file
// lives in shared memory as [n_regs + 1][kBlockW] u32; each thread touches
// only its own column, so ALU instructions need no barrier. The instruction
// stream is staged into shared memory kBlockW instructions at a time.
//
// What bounds it on an H100: each instruction reads one row word per thread
// from device memory, and the program is a serial chain, so a naive loop
// pays the full load latency on every instruction. The loop loads the
// memory operands of kPrefetch instructions first (they do not depend on the
// registers) and then executes the kPrefetch instructions, so one latency is
// paid per kPrefetch instructions. EMIT_COUNT costs one CTA barrier: each
// warp reduces with __reduce_add_sync, thread 0 sums the warp partials into a
// per-CTA counts table with "set" semantics, and at the end each CTA adds its
// table into the global counts with atomicAdd (the sum over CTAs of the last
// emitted value is the global count, so a repeated EMIT stays exact).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockW = 128;     // words (and threads) per CTA
constexpr int kWarps = kBlockW / 32;
constexpr int kMaxBatch = 4096;  // EMIT_COUNT slots (vm.MAX_BATCH_QUERIES)
constexpr int kPrefetch = 8;     // memory operands loaded ahead per chunk

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

__global__ void __launch_bounds__(kBlockW) vm_run_kernel(
    const int32_t* __restrict__ opers, const int32_t* __restrict__ specs,
    int n_instr, const uint32_t* __restrict__ bank, int64_t n_rows,
    const uint32_t* __restrict__ dyn, int64_t n_dyn,
    const uint32_t* __restrict__ sparse, int64_t n_sparse,
    const uint32_t* __restrict__ full, int64_t pw, int n_regs,
    uint32_t* __restrict__ words, int32_t* __restrict__ counts) {
  extern __shared__ uint32_t smem[];
  uint32_t* regs = smem;                                      // [(n_regs+1) * kBlockW]
  int32_t* counts_s = (int32_t*)(regs + (n_regs + 1) * kBlockW);  // [kMaxBatch]
  int32_t* code_s = counts_s + kMaxBatch;                     // [2 * kBlockW]
  int32_t* warp_sums = code_s + 2 * kBlockW;                  // [2 * kWarps]

  const int tid = threadIdx.x;
  const int64_t w = (int64_t)blockIdx.x * kBlockW + tid;
  const bool live = w < pw;  // threads past the ragged edge load nothing,
                             // so their registers stay 0
  const uint32_t fw = live ? full[w] : 0u;
  for (int r = 0; r <= n_regs; ++r) regs[r * kBlockW + tid] = 0u;
  for (int i = tid; i < kMaxBatch; i += kBlockW) counts_s[i] = 0;
  int emits = 0;

  for (int tile = 0; tile < n_instr; tile += kBlockW) {
    const int n_tile = min(kBlockW, n_instr - tile);
    __syncthreads();  // the previous tile's code is consumed
    if (tid < n_tile) {
      code_s[tid] = opers[tile + tid];
      code_s[kBlockW + tid] = specs[tile + tid];
    }
    __syncthreads();
    for (int base = 0; base < n_tile; base += kPrefetch) {
      uint32_t bv[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int i = base + u;
        bv[u] = 0u;
        if (i < n_tile && live) {
          const int32_t operand = code_s[i];
          const int bsrc = wire_bsrc(code_s[kBlockW + i]);
          if (bsrc == 1) {
            bv[u] = __ldg(bank + clip_row(operand, n_rows) * pw + w);
          } else if (bsrc == 2) {
            bv[u] = __ldg(dyn + clip_row(operand, n_dyn) * pw + w);
          } else if (bsrc == 3) {
            bv[u] = __ldg(sparse + clip_row(operand, n_sparse) * pw + w);
          } else if (bsrc == 4) {
            bv[u] = fw;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int i = base + u;
        if (i >= n_tile) break;  // uniform across the CTA
        const int32_t operand = code_s[i];
        const int32_t spec = code_s[kBlockW + i];
        const int ra = min(wire_ra(spec), n_regs - 1);
        const uint32_t a = regs[ra * kBlockW + tid];
        uint32_t b = bv[u];
        if (wire_bsrc(spec) == 0) {
          b = regs[min(wire_rb(spec), n_regs - 1) * kBlockW + tid];
        }
        uint32_t val;
        switch (wire_mode(spec)) {
          case 0: val = b; break;
          case 1: val = a & b; break;
          case 2: val = a | b; break;
          case 3: val = a ^ b; break;
          default: val = a & (b ^ fw); break;
        }
        regs[min(wire_dst(spec), n_regs) * kBlockW + tid] = val;
        if (wire_opcode(spec) == 1) {  // EMIT_COUNT: uniform, so the barrier is safe
          const int c = __reduce_add_sync(0xffffffffu, __popc(a));
          // two partial buffers alternate, so one barrier per EMIT suffices:
          // a buffer is rewritten two EMITs later, after the next barrier,
          // which thread 0 passes only once it has read it
          int32_t* sums = warp_sums + (emits & 1) * kWarps;
          if ((tid & 31) == 0) sums[tid >> 5] = c;
          __syncthreads();
          if (tid == 0) {
            int32_t total = 0;
            for (int k = 0; k < kWarps; ++k) total += sums[k];
            const int32_t oi = operand < 0 ? operand + kMaxBatch : operand;
            if (oi >= 0 && oi < kMaxBatch) counts_s[oi] = total;
          }
          ++emits;
        }
      }
    }
  }
  __syncthreads();
  if (live) words[w] = regs[tid];
  for (int i = tid; i < kMaxBatch; i += kBlockW) {
    const int32_t v = counts_s[i];
    if (v) atomicAdd(counts + i, v);
  }
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py). `counts`
// must be zeroed by the caller. Returns cudaGetLastError() after the launch.
extern "C" int lapis_vm_run(const void* opers, const void* specs, int n_instr,
                            const void* bank, long long n_rows,
                            const void* dyn, long long n_dyn,
                            const void* sparse, long long n_sparse,
                            const void* full, long long pw, int n_regs,
                            void* words, void* counts, void* stream) {
  if (pw <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(uint32_t) *
      ((size_t)(n_regs + 1) * kBlockW + kMaxBatch + 2 * kBlockW + 2 * kWarps);
  const unsigned grid = (unsigned)((pw + kBlockW - 1) / kBlockW);
  vm_run_kernel<<<grid, kBlockW, smem, (cudaStream_t)stream>>>(
      (const int32_t*)opers, (const int32_t*)specs, n_instr,
      (const uint32_t*)bank, n_rows, (const uint32_t*)dyn, n_dyn,
      (const uint32_t*)sparse, n_sparse, (const uint32_t*)full, pw, n_regs,
      (uint32_t*)words, (int32_t*)counts);
  return (int)cudaGetLastError();
}
