// count_stats: the masked-popcount pass of the solver, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitset_ops.py::count_stats (both of
// its Pallas layouts: _count_stats_split + _combine, and _count_stats_seq).
//
// Contract (DESIGN.md §5.2).  table uint32[n, w]; mask, valid uint32[L, w];
// out int32[L, 4].  For each lane l and each vertex v < n whose valid bit is
// set, count[v] = popcount(table[v] & mask[l]).  The row is
//   (max count, smallest v reaching it, sum of counts, popcount(mask[l]))
// and (-1, -1, 0, popcount(mask[l])) when no vertex is valid.
//
// What bounds it.  The work is L * n_valid * w AND + POPC + ADD word
// operations over a table small enough to stay in L1/L2 (12 KB for the
// 300-vertex 60-cell analogue) and about 8 * L * w bytes of masks: at
// L = 4096, n = 300, w = 10 that is 12.3 M popcounts against 0.4 MB of
// traffic, so it is bound by the popcount issue rate (16 per clock per SM
// on compute capability 9.0, the CUDA C++ Programming Guide's throughput
// table), not by memory.
//
// Design.  One warp per lane, so there is no cross-block combine and no
// atomic: the lane's mask and valid words sit in registers (the loops
// over words are unrolled to MAXW, a compile-time bound on w), and the
// warp's 32 threads stride over the vertices, thread t taking
// v = 32 i + t, whose valid bit is bit t of word i.  Each thread keeps the
// best 64-bit key (count + 1) << 32 | (0xFFFFFFFF - v), so a max over keys
// is a max over counts with the smallest id winning ties; a shuffle
// reduction over the warp makes the result deterministic.  Table rows are
// read through L1/L2.  Making it fast (mask tiles in shared memory,
// several lanes per warp, fusing the caller's epilogue) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int MAXW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
count_stats_kernel(const uint32_t* __restrict__ table,
                   const uint32_t* __restrict__ mask,
                   const uint32_t* __restrict__ valid,
                   int32_t* __restrict__ out, int n, int w, int lanes) {
  const int lane = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (lane >= lanes) return;  // the whole warp leaves together

  uint32_t m[MAXW], vw[MAXW];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    m[k] = k < w ? mask[(size_t)lane * w + k] : 0u;
    vw[k] = k < w ? valid[(size_t)lane * w + k] : 0u;
  }

  unsigned long long key = 0ull;  // decodes to (best = -1, arg = -1)
  int sum = 0;
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    const int v = i * 32 + t;
    if (i < w && v < n && ((vw[i] >> t) & 1u)) {
      const uint32_t* row = table + (size_t)v * w;
      int c = 0;
#pragma unroll
      for (int k = 0; k < MAXW; ++k) {
        if (k < w) c += __popc(row[k] & m[k]);
      }
      sum += c;
      const unsigned long long cand =
          ((unsigned long long)(c + 1) << 32) | (0xFFFFFFFFu - (uint32_t)v);
      key = cand > key ? cand : key;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, key, off);
    key = other > key ? other : key;
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
  }

  if (t == 0) {
    int mcount = 0;
#pragma unroll
    for (int k = 0; k < MAXW; ++k) mcount += __popc(m[k]);
    const int best = (int)(key >> 32) - 1;
    const int arg = best < 0 ? -1 : (int)(0xFFFFFFFFu - (uint32_t)key);
    int32_t* o = out + (size_t)lane * 4;
    o[0] = best;
    o[1] = arg;
    o[2] = sum;
    o[3] = mcount;
  }
}

template <int MAXW>
void launch(const uint32_t* table, const uint32_t* mask,
            const uint32_t* valid, int32_t* out, int n, int w, int lanes,
            cudaStream_t stream) {
  const int blocks = (lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  count_stats_kernel<MAXW><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      table, mask, valid, out, n, w, lanes);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes 1 <= w <= 32 words per row and n <= 32 * w vertices.
extern "C" int count_stats_launch(const void* table, const void* mask,
                                  const void* valid, void* out, int n, int w,
                                  int lanes, void* stream) {
  const auto* tb = static_cast<const uint32_t*>(table);
  const auto* mk = static_cast<const uint32_t*>(mask);
  const auto* vd = static_cast<const uint32_t*>(valid);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n < 1 || w < 1 || lanes < 1 || w > 32 || n > 32 * w) {
    return (int)cudaErrorInvalidValue;
  }
  if (w <= 2) {
    launch<2>(tb, mk, vd, o, n, w, lanes, s);
  } else if (w <= 4) {
    launch<4>(tb, mk, vd, o, n, w, lanes, s);
  } else if (w <= 8) {
    launch<8>(tb, mk, vd, o, n, w, lanes, s);
  } else if (w <= 16) {
    launch<16>(tb, mk, vd, o, n, w, lanes, s);
  } else {
    launch<32>(tb, mk, vd, o, n, w, lanes, s);
  }
  return (int)cudaGetLastError();
}
