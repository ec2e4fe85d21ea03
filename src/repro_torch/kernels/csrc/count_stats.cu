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
// What bounds it.  count[l, v] is an AND-popcount matrix product of
// [L x 32w] bits by [32w x n] bits with exact int32 sums: the tensor
// cores' binary product (mma.sync m16n8k256 .and.popc, BMMA in SASS)
// computes it.  On the CUDA cores the same work is L * n_valid * w
// popcounts at 16 per clock per SM (12.3 M, 2.94 us at cell60's root
// shape, n = 300, w = 10, L = 4096); on the tensor cores it is a few
// thousand binary products, so the least time is the bytes: the table
// once, the masks and valid words once, the output once (0.4 MB, about
// 0.12 us at 3.35 TB/s), under a launch.
//
// Design.  A block of 8 warps takes 16 lanes (the product's M).  Each warp
// holds the 16 lanes' mask words as the A fragments of every 256-bit
// k-step in registers, and walks the vertices in 8-vertex tiles (the
// product's N): warp p takes tiles p, p + 8, p + 16, ..., so the warps
// split the vertices and each tile's valid bits are one word per lane
// (tile t lies in word t / 4).  Table words are read as B fragments
// straight from global memory (12 KB at cell60 stays in L1); words past w
// and vertices past n read as 0.  The epilogue keeps, per (lane, vertex)
// of the accumulator fragment, the count of a valid vertex in a running
// sum and a running best (a strict comparison over ascending vertices
// keeps the smallest id), then the 64-bit key
// (count + 1) << 32 | (0xFFFFFFFF - v) is reduced by shuffles over the
// quad that shares a lane and through shared memory over the 8 warps: max
// and integer sum are associative, so the result is the same bits
// whatever the order.  Eight warps: each walks a short chain of tiles,
// and enough warps are resident to hide the latency of the loads and of
// the products (four were slower on the card, sixteen no faster).
//
// Rows of more than 32 words (n > 1024) take count_stats_wide_kernel, and
// any row width may take it where kernels/autotune.py picks the route: the
// same products and tile walk, and the same epilogue (fold_tile) and
// reductions (combine_and_store), but the A fragments are not held for
// every k-step (4 registers a step, without bound in w).  Each tile
// reloads them step by step; the 16 lanes' masks are 64 * w bytes and stay
// in L1.
//
// Fragments of mma.m16n8k256 .b1 (PTX ISA, "Matrix fragments for
// mma.m16n8k256"), with g = thread / 4 and q = thread % 4 in the warp:
//   A (16 x 256, row-major):  a0 = row g,     bits 32q .. 32q + 31
//                             a1 = row g + 8, bits 32q ..
//                             a2 = row g,     bits 128 + 32q ..
//                             a3 = row g + 8, bits 128 + 32q ..
//   B (256 x 8, column-major): b0 = column g, bits 32q ..; b1 = column g,
//                              bits 128 + 32q ..
//   C (16 x 8 s32):            c0, c1 = row g, columns 2q, 2q + 1;
//                              c2, c3 = row g + 8, columns 2q, 2q + 1.
// So k-step s pairs mask word 8s + q (and 8s + 4 + q) of a lane with the
// same word of a vertex's row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // warps per block, splitting the vertices
constexpr int kLanesPerBlock = 16; // the product's M

__device__ __forceinline__ void bmma_and_popc(int (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned long long key_of(int c, int v) {
  return ((unsigned long long)(c + 1) << 32) | (0xFFFFFFFFu - (uint32_t)v);
}

__device__ __forceinline__ unsigned long long max_u64(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

// Folds the accumulator fragment d of the 8-vertex tile at v0 (valid word
// i) into the running best count, its vertex and the sum of counts of the
// thread's two lanes: vertices v0 + 2q and v0 + 2q + 1 whose valid bits are
// set.  A strict comparison over ascending vertices keeps the smallest id.
// (Kept as six ints: a struct of them gave the kernels other SASS.)
__device__ __forceinline__ void fold_tile(
    const int (&d)[4], int v0, int i, int tile, int q, int n, int w,
    const uint32_t* __restrict__ valid, int la, int lb, bool ina, bool inb,
    int& best_a, int& arg_a, int& sum_a, int& best_b, int& arg_b,
    int& sum_b) {
  const int shift = 8 * (tile & 3) + 2 * q;
  const uint32_t va = ina ? valid[(size_t)la * w + i] >> shift : 0u;
  const uint32_t vb = inb ? valid[(size_t)lb * w + i] >> shift : 0u;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int v = v0 + 2 * q + c;
    if (v < n) {
      if ((va >> c) & 1u) {
        sum_a += d[c];
        if (d[c] > best_a) { best_a = d[c]; arg_a = v; }
      }
      if ((vb >> c) & 1u) {
        sum_b += d[2 + c];
        if (d[2 + c] > best_b) { best_b = d[2 + c]; arg_b = v; }
      }
    }
  }
}

// Reduces the thread's partials over the quad that shares its two lanes
// (shuffles) and over the block's warps (shared memory), and writes the
// block's output rows: max and integer sum are associative, so the result
// is the same bits whatever the order.
__device__ __forceinline__ void combine_and_store(
    int best_a, int arg_a, int sum_a, int best_b, int arg_b, int sum_b,
    int mcount_a, int mcount_b, int warp, int g, int q, int lane0,
    int lanes, unsigned long long (&s_key)[kWarps][kLanesPerBlock],
    int (&s_sum)[kWarps][kLanesPerBlock], int32_t* __restrict__ out) {
  unsigned long long key_a = best_a < 0 ? 0ull : key_of(best_a, arg_a);
  unsigned long long key_b = best_b < 0 ? 0ull : key_of(best_b, arg_b);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    key_a = max_u64(key_a, __shfl_xor_sync(0xFFFFFFFFu, key_a, off));
    key_b = max_u64(key_b, __shfl_xor_sync(0xFFFFFFFFu, key_b, off));
    sum_a += __shfl_xor_sync(0xFFFFFFFFu, sum_a, off);
    sum_b += __shfl_xor_sync(0xFFFFFFFFu, sum_b, off);
    mcount_a += __shfl_xor_sync(0xFFFFFFFFu, mcount_a, off);
    mcount_b += __shfl_xor_sync(0xFFFFFFFFu, mcount_b, off);
  }
  if (q == 0) {
    s_key[warp][g] = key_a;
    s_key[warp][g + 8] = key_b;
    s_sum[warp][g] = sum_a;
    s_sum[warp][g + 8] = sum_b;
  }
  __syncthreads();

  // Warp 0 combines the warps' partials; its quad leader q == 0 holds
  // the lane's mask count.
  if (warp == 0 && q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      const int lane = lane0 + r;
      if (lane >= lanes) continue;
      unsigned long long key = 0ull;
      int sum = 0;
#pragma unroll
      for (int p = 0; p < kWarps; ++p) {
        key = max_u64(key, s_key[p][r]);
        sum += s_sum[p][r];
      }
      const int best = (int)(key >> 32) - 1;
      int32_t* o = out + (size_t)lane * 4;
      o[0] = best;
      o[1] = best < 0 ? -1 : (int)(0xFFFFFFFFu - (uint32_t)key);
      o[2] = sum;
      o[3] = h == 0 ? mcount_a : mcount_b;
    }
  }
}

// KS = number of 256-bit k-steps, ceil(w / 8).
template <int KS>
__global__ void __launch_bounds__(kWarps * 32)
count_stats_kernel(const uint32_t* __restrict__ table,
                   const uint32_t* __restrict__ mask,
                   const uint32_t* __restrict__ valid,
                   int32_t* __restrict__ out, int n, int w, int lanes) {
  __shared__ unsigned long long s_key[kWarps][kLanesPerBlock];
  __shared__ int s_sum[kWarps][kLanesPerBlock];

  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int g = t >> 2, q = t & 3;
  const int lane0 = blockIdx.x * kLanesPerBlock;
  const int la = lane0 + g, lb = lane0 + g + 8;  // the thread's two lanes
  const bool ina = la < lanes, inb = lb < lanes;

  // A fragments: the 16 lanes' mask words, 0 past w and past the lanes.
  uint32_t a[KS][4];
  int mcount_a = 0, mcount_b = 0;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int k0 = 8 * s + q, k1 = 8 * s + 4 + q;
    a[s][0] = ina && k0 < w ? mask[(size_t)la * w + k0] : 0u;
    a[s][1] = inb && k0 < w ? mask[(size_t)lb * w + k0] : 0u;
    a[s][2] = ina && k1 < w ? mask[(size_t)la * w + k1] : 0u;
    a[s][3] = inb && k1 < w ? mask[(size_t)lb * w + k1] : 0u;
    mcount_a += __popc(a[s][0]) + __popc(a[s][2]);
    mcount_b += __popc(a[s][1]) + __popc(a[s][3]);
  }

  int best_a = -1, arg_a = -1, sum_a = 0;
  int best_b = -1, arg_b = -1, sum_b = 0;
  const int tiles = (n + 7) >> 3;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int v0 = 8 * tile;           // this warp's 8 vertices
    const int i = tile >> 2;           // their valid word
    const int vrow = v0 + g;           // the vertex whose B fragment t loads
    const uint32_t* row = table + (size_t)vrow * w;
    int d[4] = {0, 0, 0, 0};
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int k0 = 8 * s + q, k1 = 8 * s + 4 + q;
      const uint32_t b0 = vrow < n && k0 < w ? row[k0] : 0u;
      const uint32_t b1 = vrow < n && k1 < w ? row[k1] : 0u;
      bmma_and_popc(d, a[s], b0, b1);
    }
    fold_tile(d, v0, i, tile, q, n, w, valid, la, lb, ina, inb, best_a,
              arg_a, sum_a, best_b, arg_b, sum_b);
  }
  combine_and_store(best_a, arg_a, sum_a, best_b, arg_b, sum_b, mcount_a,
                    mcount_b, warp, g, q, lane0, lanes, s_key, s_sum, out);
}

// The wide route (any w; the only one for w > 32): count_stats_kernel with
// the k-steps a loop and each step's A fragments loaded where the product
// needs them.
__global__ void __launch_bounds__(kWarps * 32)
count_stats_wide_kernel(const uint32_t* __restrict__ table,
                        const uint32_t* __restrict__ mask,
                        const uint32_t* __restrict__ valid,
                        int32_t* __restrict__ out, int n, int w, int lanes) {
  __shared__ unsigned long long s_key[kWarps][kLanesPerBlock];
  __shared__ int s_sum[kWarps][kLanesPerBlock];

  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int g = t >> 2, q = t & 3;
  const int lane0 = blockIdx.x * kLanesPerBlock;
  const int la = lane0 + g, lb = lane0 + g + 8;  // the thread's two lanes
  const bool ina = la < lanes, inb = lb < lanes;
  const uint32_t* ma = mask + (size_t)la * w;
  const uint32_t* mb = mask + (size_t)lb * w;
  const int ks = (w + 7) >> 3;

  int mcount_a = 0, mcount_b = 0;
  for (int k = q; k < w; k += 4) {
    mcount_a += ina ? __popc(ma[k]) : 0;
    mcount_b += inb ? __popc(mb[k]) : 0;
  }

  int best_a = -1, arg_a = -1, sum_a = 0;
  int best_b = -1, arg_b = -1, sum_b = 0;
  const int tiles = (n + 7) >> 3;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int v0 = 8 * tile;           // this warp's 8 vertices
    const int i = tile >> 2;           // their valid word
    const int vrow = v0 + g;           // the vertex whose B fragment t loads
    const uint32_t* row = table + (size_t)vrow * w;
    int d[4] = {0, 0, 0, 0};
#pragma unroll 2
    for (int s = 0; s < ks; ++s) {
      const int k0 = 8 * s + q, k1 = 8 * s + 4 + q;
      const bool in0 = k0 < w, in1 = k1 < w;
      const uint32_t a[4] = {
          ina && in0 ? ma[k0] : 0u, inb && in0 ? mb[k0] : 0u,
          ina && in1 ? ma[k1] : 0u, inb && in1 ? mb[k1] : 0u};
      const uint32_t b0 = vrow < n && in0 ? row[k0] : 0u;
      const uint32_t b1 = vrow < n && in1 ? row[k1] : 0u;
      bmma_and_popc(d, a, b0, b1);
    }
    fold_tile(d, v0, i, tile, q, n, w, valid, la, lb, ina, inb, best_a,
              arg_a, sum_a, best_b, arg_b, sum_b);
  }
  combine_and_store(best_a, arg_a, sum_a, best_b, arg_b, sum_b, mcount_a,
                    mcount_b, warp, g, q, lane0, lanes, s_key, s_sum, out);
}

template <int KS>
void launch(const uint32_t* table, const uint32_t* mask,
            const uint32_t* valid, int32_t* out, int n, int w, int lanes,
            cudaStream_t stream) {
  const int blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  count_stats_kernel<KS><<<blocks, kWarps * 32, 0, stream>>>(
      table, mask, valid, out, n, w, lanes);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes w >= 1 words per row and n <= 32 * w vertices.  `wide` picks the
// route (kernels/autotune.py): 0 the narrow kernel, which takes w <= 32
// only; 1 count_stats_wide_kernel, which takes any w.
extern "C" int count_stats_launch(const void* table, const void* mask,
                                  const void* valid, void* out, int n, int w,
                                  int lanes, int wide, void* stream) {
  const auto* tb = static_cast<const uint32_t*>(table);
  const auto* mk = static_cast<const uint32_t*>(mask);
  const auto* vd = static_cast<const uint32_t*>(valid);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n < 1 || w < 1 || lanes < 1 || n > 32LL * w || (!wide && w > 32)) {
    return (int)cudaErrorInvalidValue;
  }
  if (wide) {
    const int blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
    count_stats_wide_kernel<<<blocks, kWarps * 32, 0, s>>>(tb, mk, vd, o, n,
                                                           w, lanes);
    return (int)cudaGetLastError();
  }
  switch ((w + 7) / 8) {
    case 1: launch<1>(tb, mk, vd, o, n, w, lanes, s); break;
    case 2: launch<2>(tb, mk, vd, o, n, w, lanes, s); break;
    case 3: launch<3>(tb, mk, vd, o, n, w, lanes, s); break;
    default: launch<4>(tb, mk, vd, o, n, w, lanes, s); break;
  }
  return (int)cudaGetLastError();
}
