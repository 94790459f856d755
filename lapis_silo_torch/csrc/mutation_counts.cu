// K2: the Mutations reduction over the dense bank,
//   counts[r] = sum_w popcount(bank[start + r, w] & filter[w]),
// over the flat global word axis (partitions folded into words).
//
// Replaces the naive form of mutation_counts_banked
// (lapis_silo_tpu/ops/pallas_kernels.py:150). The TPU kernel streamed
// 256-row x 2048-word tiles through VMEM with a row_block-aligned start; here
// `start` is any row and rows need no bucketing.
//
// What bounds it on an H100: reading the segment's rows, once each (one
// popcount and one AND per 4 bytes; the filter is PW words and stays in
// L1/L2). So the design spends nothing but coalesced loads: one warp per
// row, lanes striding the row with 16-byte loads where the row and the
// filter are 16-byte aligned (PW % 4 == 0), 4-byte loads otherwise, a warp
// shuffle reduction, and one int32 store per row. No atomics, no shared
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;

__device__ __forceinline__ uint32_t popc_and4(uint4 x, uint4 f) {
  return __popc(x.x & f.x) + __popc(x.y & f.y) + __popc(x.z & f.z) +
         __popc(x.w & f.w);
}

__global__ void __launch_bounds__(kThreads) mutation_counts_kernel(
    const uint32_t* __restrict__ bank, const uint32_t* __restrict__ filter,
    int64_t start, int64_t n_rows, int64_t pw, int vectorized,
    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= n_rows) return;  // the whole warp leaves together
  const uint32_t* row = bank + (start + r) * pw;
  uint32_t acc = 0;
  if (vectorized) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    const uint4* filter4 = reinterpret_cast<const uint4*>(filter);
    const int64_t n4 = pw >> 2;
    for (int64_t j = lane; j < n4; j += 32) {
      acc += popc_and4(__ldg(row4 + j), __ldg(filter4 + j));
    }
  } else {
    for (int64_t j = lane; j < pw; j += 32) {
      acc += __popc(__ldg(row + j) & __ldg(filter + j));
    }
  }
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) out[r] = (int32_t)acc;
}

}  // namespace

// C interface, bound with ctypes (lapis_silo_torch/ops/kernels.py).
// Returns cudaGetLastError() after the launch.
extern "C" int lapis_mutation_counts(const void* bank, const void* filter,
                                     long long start, long long n_rows,
                                     long long pw, void* out, void* stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  const int vectorized = (pw % 4 == 0) &&
      ((uintptr_t)bank % 16 == 0) && ((uintptr_t)filter % 16 == 0);
  const unsigned grid =
      (unsigned)((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  mutation_counts_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bank, (const uint32_t*)filter, start, n_rows, pw,
      vectorized, (int32_t*)out);
  return (int)cudaGetLastError();
}
