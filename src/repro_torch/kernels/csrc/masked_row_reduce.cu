// masked_row_reduce: OR (or AND) of the table rows a bitset selects, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitset_ops.py::masked_row_reduce
// (_row_reduce_kernel over a (lanes, row tiles) grid with a log2 tree
// reduction of each tile).
//
// Contract.  table uint32[n, w]; select uint32[L, w]; out uint32[L, w].
// out[l] = OR (AND) of table[v] over the vertices v < n whose bit is set in
// select[l]; bits at or above n select nothing; an empty selection gives
// the identity, 0 for OR and 0xFFFFFFFF for AND.
//
// What bounds it.  One bitwise operation per (selected vertex, word): at
// the solver's shape (n = 300, w = 10, L = 4096, half the bits set) that is
// 6.1 M operations against 0.34 MB of traffic (the table, 12 KB, stays in
// L1/L2), so the bound is the 32-bit logic rate (64 per clock per SM on
// compute capability 9.0, the CUDA C++ Programming Guide's throughput
// table), not memory.  A simple kernel is latency-bound well above that.
//
// Design.  One block per lane; its threads stride over the words of the
// output row, so the rows of neighbouring threads are neighbouring words of
// one table row (coalesced).  Each thread walks the set bits of the lane's
// select words in ascending order with __ffs, so the work is the number of
// selected vertices, not n, and a word's bits at or above n are masked off
// before the walk (a walk over every set bit would read past the table).
// The select words are read by every thread of the block at one address
// (a broadcast).  No shared memory, no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool AND>
__global__ void __launch_bounds__(256)
masked_row_reduce_kernel(const uint32_t* __restrict__ table,
                         const uint32_t* __restrict__ select,
                         uint32_t* __restrict__ out, int n, int w) {
  const uint32_t* sel = select + (size_t)blockIdx.x * w;
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
    uint32_t acc = AND ? 0xFFFFFFFFu : 0u;
    for (int i = 0; i < w && i * 32 < n; ++i) {
      const int base = i * 32;
      uint32_t bits = sel[i];
      if (n - base < 32) bits &= (1u << (n - base)) - 1u;
      while (bits) {
        const int v = base + __ffs(bits) - 1;
        bits &= bits - 1u;
        const uint32_t row = table[(size_t)v * w + k];
        acc = AND ? (acc & row) : (acc | row);
      }
    }
    out[(size_t)blockIdx.x * w + k] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes 1 <= n <= 32 * w, lanes >= 1; op_and = 1 for AND, 0 for OR.
extern "C" int masked_row_reduce_launch(const void* table,
                                        const void* select, void* out, int n,
                                        int w, int lanes, int op_and,
                                        void* stream) {
  if (n < 1 || w < 1 || lanes < 1 || n > 32 * w) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* tb = static_cast<const uint32_t*>(table);
  const auto* sl = static_cast<const uint32_t*>(select);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = w >= 256 ? 256 : (w + 31) / 32 * 32;
  if (op_and) {
    masked_row_reduce_kernel<true><<<lanes, threads, 0, s>>>(tb, sl, o, n, w);
  } else {
    masked_row_reduce_kernel<false><<<lanes, threads, 0, s>>>(tb, sl, o, n,
                                                               w);
  }
  return (int)cudaGetLastError();
}
