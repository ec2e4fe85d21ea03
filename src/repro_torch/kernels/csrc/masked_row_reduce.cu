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
// What bounds it.  One bitwise fold per (selected vertex, word), and one
// three-input LOP3 folds two of them (acc | a | b): at the solver's shape
// (n = 300, w = 10, L = 4096, half the bits set) that is 3.1 M LOP3s
// against 0.34 MB of traffic (the table, 12 KB, is read once per block
// from L2), so the bound is the 32-bit logic rate (64 per clock per SM on
// compute capability 9.0, the CUDA C++ Programming Guide's throughput
// table), not memory.
//
// Design: branch-free on the CUDA cores.  Walking each lane's set bits (the
// first design) makes a dependent chain per selected vertex: find the bit,
// load the row, OR it in.  Here the work does not depend on the data:
//   * a block of 16 warps serves 32 lanes, 2 a warp; it stages the table in
//     shared memory, in stages of rows that fit a fixed budget, with each
//     stage's select words of its 32 lanes beside them, by cp.async (every
//     word in flight at once; a loop of loads through registers waited out
//     an L2 round trip per batch and was slower on the card);
//   * thread t of a warp takes the vertices v = 32 i + t, so the 32 threads
//     read 32 rows with 128-bit loads (rows padded to an odd number of
//     16-byte groups: no bank conflicts) and one select word a lane (a
//     broadcast), its bits >= n cleared;
//   * for each of its 2 lanes a thread folds (bit ? row : identity) into
//     WC registers: the bit becomes a mask m by two shifts, then one LOP3 a
//     word (acc | row & m, or acc & (row | ~m)), so each row read feeds 2
//     lanes;
//   * REDUX (__reduce_or_sync / __reduce_and_sync) folds each (lane, word)
//     over the warp's 32 vertex classes.
// It does n * w LOP3s where the bound counts selected * w / 2 (four times
// as many at half density), with no dependent step.  WC, the words a pass
// holds in registers, is a template bound; rows of more than 16 words run
// in passes of at most 16, so no budget of registers or shared memory
// grows with w or n.  Of 1 to 8 lanes a warp and 4 to 32 warps a block,
// this shape was the fastest at cell60's shape without a ptxas spill
// (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;          // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerWarp = 2;    // lanes each thread folds at once
constexpr int kLanesPerBlock = kWarps * kLanesPerWarp;
constexpr int kMaxChunk = 16;       // most words a pass holds in registers
constexpr int kStageBytes = 32 * 1024;  // shared memory of one row stage
constexpr int kSelPitch = kLanesPerBlock + 1;  // words per staged group

// Words per staged row for a pass of wc words: whole 16-byte groups, an
// odd number of them, so the 8 threads of a quarter warp reading 8
// consecutive rows hit disjoint banks.
__host__ __device__ constexpr int row_pitch(int wc) {
  return 4 * (((wc + 3) / 4) | 1);
}

// Rows in a stage: whole groups of 32 rows (the select words of a group
// beside them), as many as fit kStageBytes, at most the table's.
int stage_rows(int n, int wc) {
  const int group_bytes = 4 * (32 * row_pitch(wc) + kSelPitch);
  int groups = kStageBytes / group_bytes;
  const int need = (n + 31) / 32;
  return 32 * (groups < need ? groups : need);
}

// Copies one word from global to shared memory asynchronously (cp.async),
// or writes 0 there when `in` is false; cp.async.wait_all completes it.
__device__ __forceinline__ void copy_word(uint32_t* dst, const uint32_t* src,
                                          bool in) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(src), "r"(in ? 4 : 0) : "memory");
}

template <int WC, bool AND>
__global__ void __launch_bounds__(kThreads)
masked_row_reduce_kernel(const uint32_t* __restrict__ table,
                         const uint32_t* __restrict__ select,
                         uint32_t* __restrict__ out, int n, int w, int lanes,
                         int rows_per_stage) {
  constexpr int kGroups = (WC + 3) / 4;      // 16-byte groups a row uses
  constexpr int kPitch = row_pitch(WC);
  extern __shared__ uint4 smem[];
  uint32_t* s_rows = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_sel = s_rows + rows_per_stage * kPitch;  // [group][lane]

  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int block_lane0 = blockIdx.x * kLanesPerBlock;
  const int lane0 = block_lane0 + warp * kLanesPerWarp;
  const uint32_t ident = AND ? 0xFFFFFFFFu : 0u;

  for (int c0 = 0; c0 < w; c0 += WC) {     // passes over the words
    uint32_t acc[kLanesPerWarp][WC];
#pragma unroll
    for (int l = 0; l < kLanesPerWarp; ++l)
#pragma unroll
      for (int k = 0; k < WC; ++k) acc[l][k] = ident;

    for (int r0 = 0; r0 < n; r0 += rows_per_stage) {
      const int rows = n - r0 < rows_per_stage ? n - r0 : rows_per_stage;
      const int groups = (rows + 31) >> 5;
      const int g0 = r0 >> 5;
      __syncthreads();                     // the last stage is read
      // Stage the rows (words c0 .. c0 + WC, 0 past w) and the groups'
      // select words (0 past the lanes) with cp.async: every word in
      // flight at once, none held in registers.
      for (int e = threadIdx.x; e < rows * WC; e += kThreads) {
        const int r = e / WC, k = e - r * WC;
        const bool in = c0 + k < w;
        copy_word(s_rows + r * kPitch + k,
                  in ? table + (size_t)(r0 + r) * w + c0 + k : table, in);
      }
      for (int e = threadIdx.x; e < groups * kLanesPerBlock; e += kThreads) {
        const int g = e / kLanesPerBlock, lb = e - g * kLanesPerBlock;
        const int lane = block_lane0 + lb;
        const bool in = lane < lanes;
        copy_word(s_sel + g * kSelPitch + lb,
                  in ? select + (size_t)lane * w + g0 + g : select, in);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();

      // Rows past n in the last group hold stale words; their bits are 0.
      for (int g = 0; g < groups; ++g) {
        uint32_t row[4 * kGroups];
        const uint4* src =
            reinterpret_cast<const uint4*>(s_rows + (32 * g + t) * kPitch);
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
          const uint4 x = src[j];
          row[4 * j] = x.x;
          row[4 * j + 1] = x.y;
          row[4 * j + 2] = x.z;
          row[4 * j + 3] = x.w;
        }
        const int left = n - 32 * (g0 + g);  // bits >= n select nothing
        const uint32_t lim = left >= 32 ? 0xFFFFFFFFu : (1u << left) - 1u;
#pragma unroll
        for (int l = 0; l < kLanesPerWarp; ++l) {
          const uint32_t s =
              s_sel[g * kSelPitch + warp * kLanesPerWarp + l] & lim;
          const uint32_t m = (uint32_t)((int32_t)(s << (31 - t)) >> 31);
#pragma unroll
          for (int k = 0; k < WC; ++k) {
            acc[l][k] = AND ? acc[l][k] & (row[k] | ~m)
                            : acc[l][k] | (row[k] & m);
          }
        }
      }
    }

#pragma unroll
    for (int l = 0; l < kLanesPerWarp; ++l) {
#pragma unroll
      for (int k = 0; k < WC; ++k) {
        const uint32_t r = AND ? __reduce_and_sync(0xFFFFFFFFu, acc[l][k])
                               : __reduce_or_sync(0xFFFFFFFFu, acc[l][k]);
        if (t == k && lane0 + l < lanes && c0 + k < w) {
          out[(size_t)(lane0 + l) * w + c0 + k] = r;
        }
      }
    }
  }
}

template <int WC>
int launch(const uint32_t* table, const uint32_t* select, uint32_t* out,
           int n, int w, int lanes, bool op_and, cudaStream_t stream) {
  const int rows = stage_rows(n, WC);
  const size_t smem =
      4 * ((size_t)rows * row_pitch(WC) + rows / 32 * kSelPitch);
  const int blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  if (op_and) {
    masked_row_reduce_kernel<WC, true><<<blocks, kThreads, smem, stream>>>(
        table, select, out, n, w, lanes, rows);
  } else {
    masked_row_reduce_kernel<WC, false>
        <<<blocks, kThreads, smem, stream>>>(table, select, out, n, w,
                                                lanes, rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes 1 <= n <= 32 * w, lanes >= 1; op_and = 1 for AND, 0 for OR.
extern "C" int masked_row_reduce_launch(const void* table,
                                        const void* select, void* out, int n,
                                        int w, int lanes, int op_and,
                                        void* stream) {
  if (n < 1 || w < 1 || lanes < 1 || n > 32LL * w) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* tb = static_cast<const uint32_t*>(table);
  const auto* sl = static_cast<const uint32_t*>(select);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool a = op_and != 0;
  // Passes of equal width, at most kMaxChunk words each.
  const int passes = (w + kMaxChunk - 1) / kMaxChunk;
  switch ((w + passes - 1) / passes) {
    case 1: return launch<1>(tb, sl, o, n, w, lanes, a, s);
    case 2: return launch<2>(tb, sl, o, n, w, lanes, a, s);
    case 3: return launch<3>(tb, sl, o, n, w, lanes, a, s);
    case 4: return launch<4>(tb, sl, o, n, w, lanes, a, s);
    case 5: return launch<5>(tb, sl, o, n, w, lanes, a, s);
    case 6: return launch<6>(tb, sl, o, n, w, lanes, a, s);
    case 7: return launch<7>(tb, sl, o, n, w, lanes, a, s);
    case 8: return launch<8>(tb, sl, o, n, w, lanes, a, s);
    case 9: return launch<9>(tb, sl, o, n, w, lanes, a, s);
    case 10: return launch<10>(tb, sl, o, n, w, lanes, a, s);
    case 11: return launch<11>(tb, sl, o, n, w, lanes, a, s);
    case 12: return launch<12>(tb, sl, o, n, w, lanes, a, s);
    case 13: return launch<13>(tb, sl, o, n, w, lanes, a, s);
    case 14: return launch<14>(tb, sl, o, n, w, lanes, a, s);
    case 15: return launch<15>(tb, sl, o, n, w, lanes, a, s);
    default: return launch<16>(tb, sl, o, n, w, lanes, a, s);
  }
}
