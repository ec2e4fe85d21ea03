// stacked_count_stats: the service's masked-popcount pass over K stacked
// instance tables, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitset_ops.py::stacked_count_stats
// (both of its Pallas layouts: _stacked_split + _combine, a grid over
// (instance, tile block) with every lane batched in the body, and
// _stacked_seq, which fetches tables[inst[l]] by scalar prefetch).
//
// Contract (DESIGN.md §5.3).  tables uint32[K, n, w]; inst int32[L];
// mask, valid uint32[L, w]; out int32[L, 4].  Lane l is count_stats of
// mask[l], valid[l] against tables[inst[l]]: for each vertex v < n whose
// valid bit is set, count[v] = popcount(tables[inst[l]][v] & mask[l]), and
// the row is (max count, smallest v reaching it, sum of counts,
// popcount(mask[l])), or (-1, -1, 0, popcount(mask[l])) when no vertex is
// valid.  A lane with inst[l] < 0 (the service's NO_INSTANCE) is parked:
// it reads no table and writes (-1, -1, 0, 0); its mask count is 0
// because the reference zeroes a parked lane's mask.  Ids at or above K
// lie outside the contract (the two Pallas layouts disagree on them); this
// kernel parks such a lane too, so it never reads outside the tables.
//
// What bounds it.  As for count_stats: L * n_valid * w AND + POPC + ADD
// word operations against tables of K * n * w words that stay in L2
// (4 slots of n = 100 are 6.4 KB; 16 of n = 300 are 192 KB) and about
// 8 * L * w bytes of masks, so it is bound by the popcount issue rate
// (16 per clock per SM on compute capability 9.0, the CUDA C++
// Programming Guide's throughput table) unless most lanes are parked.
//
// Design.  count_stats.cu's design with a per-lane table base: one warp
// per lane, so no cross-block combine and no atomics; the lane's mask and
// valid words sit in registers (loops unrolled to MAXW, a compile-time
// bound on w); thread t takes vertices v = 32 i + t and keeps the best
// 64-bit key (count + 1) << 32 | (0xFFFFFFFF - v), so a max over keys is a
// max over counts with the smallest id winning ties; a shuffle reduction
// over the warp makes the result deterministic.  The base pointer
// tables + inst[l] * n * w takes the place of the scalar-prefetch index
// map; a parked lane's warp leaves before it loads anything but its id.
// Rows of more than 32 words (n > 1024) take stacked_count_stats_wide_kernel,
// and any row width may take it where kernels/autotune.py picks the route:
// the same warp per lane, but the lane's mask and valid words (2 * w
// registers, without bound in w) are read where they are needed; every
// thread of the warp reads the same word at once, a broadcast from L1
// (the lane's words are 8 * w bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int MAXW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stacked_count_stats_kernel(const uint32_t* __restrict__ tables,
                           const int32_t* __restrict__ inst,
                           const uint32_t* __restrict__ mask,
                           const uint32_t* __restrict__ valid,
                           int32_t* __restrict__ out, int k, int n, int w,
                           int lanes) {
  const int lane = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (lane >= lanes) return;  // the whole warp leaves together

  const int id = inst[lane];
  if (id < 0 || id >= k) {    // parked: the whole warp takes this branch
    if (t == 0) {
      int32_t* o = out + (size_t)lane * 4;
      o[0] = -1;
      o[1] = -1;
      o[2] = 0;
      o[3] = 0;
    }
    return;
  }
  const uint32_t* table = tables + (size_t)id * n * w;

  uint32_t m[MAXW], vw[MAXW];
#pragma unroll
  for (int j = 0; j < MAXW; ++j) {
    m[j] = j < w ? mask[(size_t)lane * w + j] : 0u;
    vw[j] = j < w ? valid[(size_t)lane * w + j] : 0u;
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
      for (int j = 0; j < MAXW; ++j) {
        if (j < w) c += __popc(row[j] & m[j]);
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
    for (int j = 0; j < MAXW; ++j) mcount += __popc(m[j]);
    const int best = (int)(key >> 32) - 1;
    const int arg = best < 0 ? -1 : (int)(0xFFFFFFFFu - (uint32_t)key);
    int32_t* o = out + (size_t)lane * 4;
    o[0] = best;
    o[1] = arg;
    o[2] = sum;
    o[3] = mcount;
  }
}

// The wide route (any w; the only one for w > 32):
// stacked_count_stats_kernel without the lane's words in registers.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stacked_count_stats_wide_kernel(const uint32_t* __restrict__ tables,
                                const int32_t* __restrict__ inst,
                                const uint32_t* __restrict__ mask,
                                const uint32_t* __restrict__ valid,
                                int32_t* __restrict__ out, int k, int n,
                                int w, int lanes) {
  const int lane = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (lane >= lanes) return;  // the whole warp leaves together

  const int id = inst[lane];
  if (id < 0 || id >= k) {    // parked: the whole warp takes this branch
    if (t == 0) {
      int32_t* o = out + (size_t)lane * 4;
      o[0] = -1;
      o[1] = -1;
      o[2] = 0;
      o[3] = 0;
    }
    return;
  }
  const uint32_t* table = tables + (size_t)id * n * w;
  const uint32_t* m = mask + (size_t)lane * w;
  const uint32_t* vw = valid + (size_t)lane * w;

  unsigned long long key = 0ull;  // decodes to (best = -1, arg = -1)
  int sum = 0;
  for (int i = 0; i * 32 < n; ++i) {  // n <= 32 w, so i < w
    const int v = i * 32 + t;
    if (v < n && ((vw[i] >> t) & 1u)) {
      const uint32_t* row = table + (size_t)v * w;
      int c = 0;
#pragma unroll 4
      for (int j = 0; j < w; ++j) c += __popc(row[j] & m[j]);
      sum += c;
      const unsigned long long cand =
          ((unsigned long long)(c + 1) << 32) | (0xFFFFFFFFu - (uint32_t)v);
      key = cand > key ? cand : key;
    }
  }
  int mcount = 0;
  for (int j = t; j < w; j += 32) mcount += __popc(m[j]);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xFFFFFFFFu, key, off);
    key = other > key ? other : key;
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
    mcount += __shfl_xor_sync(0xFFFFFFFFu, mcount, off);
  }

  if (t == 0) {
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
void launch(const uint32_t* tables, const int32_t* inst,
            const uint32_t* mask, const uint32_t* valid, int32_t* out, int k,
            int n, int w, int lanes, cudaStream_t stream) {
  const int blocks = (lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  stacked_count_stats_kernel<MAXW>
      <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(tables, inst, mask, valid,
                                                   out, k, n, w, lanes);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes K >= 1 tables, w >= 1 words per row and n <= 32 * w vertices.
// `wide` picks the route (kernels/autotune.py): 0 the narrow kernels, which
// take w <= 32 only; 1 stacked_count_stats_wide_kernel, which takes any w.
extern "C" int stacked_count_stats_launch(const void* tables,
                                          const void* inst, const void* mask,
                                          const void* valid, void* out, int k,
                                          int n, int w, int lanes, int wide,
                                          void* stream) {
  const auto* tb = static_cast<const uint32_t*>(tables);
  const auto* in = static_cast<const int32_t*>(inst);
  const auto* mk = static_cast<const uint32_t*>(mask);
  const auto* vd = static_cast<const uint32_t*>(valid);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || n < 1 || w < 1 || lanes < 1 || n > 32LL * w ||
      (!wide && w > 32)) {
    return (int)cudaErrorInvalidValue;
  }
  if (wide) {
    const int blocks = (lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
    stacked_count_stats_wide_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        tb, in, mk, vd, o, k, n, w, lanes);
  } else if (w <= 2) {
    launch<2>(tb, in, mk, vd, o, k, n, w, lanes, s);
  } else if (w <= 4) {
    launch<4>(tb, in, mk, vd, o, k, n, w, lanes, s);
  } else if (w <= 8) {
    launch<8>(tb, in, mk, vd, o, k, n, w, lanes, s);
  } else if (w <= 16) {
    launch<16>(tb, in, mk, vd, o, k, n, w, lanes, s);
  } else {
    launch<32>(tb, in, mk, vd, o, k, n, w, lanes, s);
  }
  return (int)cudaGetLastError();
}
