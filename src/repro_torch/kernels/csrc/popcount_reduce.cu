// popcount_reduce: the size of each packed set, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitset_ops.py::popcount_reduce
// (_popcount_kernel, one grid step per row).
//
// Contract.  rows uint32[L, w] -> out int32[L], out[l] = sum_k popc(rows[l][k]).
//
// What bounds it.  One popcount per word read: 4 bytes moved for each
// __popc, while the card issues 16 popcounts per clock per SM (the CUDA C++
// Programming Guide's throughput table for compute capability 9.0), about
// 42 G popcounts/s over 132 SMs against 0.84 G words/s of HBM (3.35 TB/s).
// So it is bound by the bytes it reads, and at the shapes of the solver
// (L = 4096, w = 10: 160 KB) by the launch itself.
//
// Design.  One warp per row: the warp's 32 threads stride over the row's
// words (neighbouring threads on neighbouring words, so a row of up to 32
// words is one coalesced load), each sums its __popc, and a warp-shuffle
// sum leaves the total in thread 0.  No shared memory, no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
popcount_reduce_kernel(const uint32_t* __restrict__ rows,
                       int32_t* __restrict__ out, int lanes, int w) {
  const int lane = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (lane >= lanes) return;  // the whole warp leaves together
  const uint32_t* row = rows + (size_t)lane * w;
  int c = 0;
  for (int k = t; k < w; k += 32) c += __popc(row[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_xor_sync(0xFFFFFFFFu, c, off);
  }
  if (t == 0) out[lane] = c;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes lanes >= 1 rows of w >= 0 words.
extern "C" int popcount_reduce_launch(const void* rows, void* out, int lanes,
                                      int w, void* stream) {
  if (lanes < 1 || w < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  popcount_reduce_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<int32_t*>(out), lanes,
      w);
  return (int)cudaGetLastError();
}
