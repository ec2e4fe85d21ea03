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
// (L = 4096, w = 10: 160 KB) by the launch itself: popcount_reduce_floor
// launches an empty kernel of the same grid and block, to time that floor.
//
// Design.  A sub-warp of SW threads per row, SW = w rounded up to a power
// of two (at most 32), so a warp holds 32 / SW rows and every thread has a
// word to read when w is a power of two: the threads stride over the row's
// words (consecutive rows lie together, so a warp's loads are one run of
// words), each sums its __popc, and a shuffle sum within the sub-warp
// leaves the total in its first thread.  No shared memory, no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int SW>
__global__ void __launch_bounds__(kThreads)
popcount_reduce_kernel(const uint32_t* __restrict__ rows,
                       int32_t* __restrict__ out, int lanes, int w) {
  const int lane = blockIdx.x * (kThreads / SW) + threadIdx.x / SW;
  const int t = threadIdx.x % SW;
  int c = 0;
  if (lane < lanes) {    // every thread stays for the shuffles
    const uint32_t* row = rows + (size_t)lane * w;
    for (int k = t; k < w; k += SW) c += __popc(row[k]);
  }
#pragma unroll
  for (int off = SW / 2; off > 0; off >>= 1) {
    c += __shfl_xor_sync(0xFFFFFFFFu, c, off);
  }
  if (t == 0 && lane < lanes) out[lane] = c;
}

__global__ void launch_floor_kernel() {}

// The launch for rows of w words: a sub-warp of sw threads per row (w
// rounded up to a power of two, at most 32) and the blocks that cover the
// lanes.  Both entry points launch on it.
struct Grid {
  int sw, blocks;
};

Grid grid_of(int lanes, int w) {
  int sw = 1;
  while (sw < w && sw < 32) sw <<= 1;
  return {sw, (lanes + kThreads / sw - 1) / (kThreads / sw)};
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes lanes >= 1 rows of w >= 0 words.
extern "C" int popcount_reduce_launch(const void* rows, void* out, int lanes,
                                      int w, void* stream) {
  if (lanes < 1 || w < 0) return (int)cudaErrorInvalidValue;
  const auto* r = static_cast<const uint32_t*>(rows);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const Grid g = grid_of(lanes, w);
  switch (g.sw) {
    case 1: popcount_reduce_kernel<1><<<g.blocks, kThreads, 0, s>>>(r, o, lanes, w); break;
    case 2: popcount_reduce_kernel<2><<<g.blocks, kThreads, 0, s>>>(r, o, lanes, w); break;
    case 4: popcount_reduce_kernel<4><<<g.blocks, kThreads, 0, s>>>(r, o, lanes, w); break;
    case 8: popcount_reduce_kernel<8><<<g.blocks, kThreads, 0, s>>>(r, o, lanes, w); break;
    case 16: popcount_reduce_kernel<16><<<g.blocks, kThreads, 0, s>>>(r, o, lanes, w); break;
    default: popcount_reduce_kernel<32><<<g.blocks, kThreads, 0, s>>>(r, o, lanes, w); break;
  }
  return (int)cudaGetLastError();
}

// An empty kernel launched on popcount_reduce's grid and block for
// (lanes, w), from the same grid_of: the least time any kernel of that
// launch takes.  Not a kernel of the library: chip_smoke.py times it
// beside popcount_reduce.
extern "C" int popcount_reduce_floor_launch(int lanes, int w, void* stream) {
  if (lanes < 1 || w < 0) return (int)cudaErrorInvalidValue;
  const Grid g = grid_of(lanes, w);
  launch_floor_kernel<<<g.blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
