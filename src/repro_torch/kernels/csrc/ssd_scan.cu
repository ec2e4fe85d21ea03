// ssd_scan: the Mamba-2 SSD chunk scan (state-space duality), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (_kernel over
// a (batch * head, chunk) grid whose chunk axis carries the [N, P] state in
// VMEM scratch).
//
// Contract.  x [B, S, H, P] and b, c [B, S, G, N], all float32 or all
// bfloat16; dt [B, S, H], a, d [H] float32.  Head h reads B/C group
// h / (H / G).  For each chunk of Q positions, with cum the inclusive
// cumsum of dt * a over the chunk and S the state carried in:
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . S + d x_i,
//   S  <- exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T.
// y [B, S, H, P] in x's type; the final state [B, H, N, P] in float32.  A
// sequence that is not a multiple of Q is zero-padded, which is exact
// (dt = 0 decays by exp(0) = 1 and adds nothing; C = 0 outputs nothing).
//
// What bounds it.  Per chunk and head, 2 Q^2 N (C B^T) + 2 Q N P (C S)
// + 2 Q N P (state update) + 2 Q^2 P (the masked product with x) flops:
// at mamba2-130m's width (B = 4, S = 4096, H = 24, P = 64, N = 128,
// Q = 128) 22.6 GFLOP of the lower triangles, 23 us at 989 TFLOP/s; the
// bytes of reading each input once and writing y and the state once
// (113.8 MB) take 34 us at 3.35 TB/s.  The carry from chunk to chunk is
// the hard part: a loop over the chunks inside one block (this file's
// first design, one block per (head, batch)) runs 96 blocks on 132 SMs.
//
// Design: three passes, issued one after the other on the caller's stream
// by ssd_scan_launch, with the chunks spread over blocks.
//   1. chunk_state, one block per (chunk, head, batch): dt's cumsum over
//      the chunk and the chunk's own state
//      s_c = sum_j exp(total - cum_j) dt_j B_j x_j^T  [N, P],
//      written to a scratch buffer with the chunk's total (the wrapper
//      allocates it: B * H * chunks * (N * P + 1) floats, 100 MB at
//      mamba2-130m's width).
//   2. state, one thread per (state element, head, batch), a loop over
//      the chunks: S_c = exp(total_{c-1}) S_{c-1} + s_{c-1}, elementwise;
//      each s_c is overwritten by the state carried into chunk c, and the
//      last state is the final state.
//   3. output, one block per (chunk, head, batch):
//      y = (C B^T o L o dt) x + exp(cum) C S_in + d x.
// At mamba2-130m's width that is 3,072 blocks for passes 1 and 3.  The
// scratch traffic (the states written, rewritten and read: about 0.4 GB
// beside the inputs) makes about 0.17 ms the least this design can take;
// fusing pass 2 into the others with a look-back across chunks is the
// lever toward the bound.
//
// The bf16 route runs its products on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate; HMMA in SASS) rather than
// wgmma: the products are at most 128 x 128 x 128 per block, the design
// is bound by its bytes (and the passes' latency) long before the tensor
// cores' rate, and a warp's 16-row tiles let the masked matrix W, made
// from the C B^T accumulator in registers, be split and fed to the
// product with x as A fragments without a trip through shared memory.  Precision: C, B and
// x are bf16 inputs, exact as operands, so C B^T differs from the f32
// plain version only in summation order.  Three operands are f32 values
// that bf16 cannot hold: the scaled B of the state update (B o
// exp(total - cum) dt), W, and the carried state S of C S.  Rounding one
// of them to bf16 costs up to 2^-8 relative per term, a normalised state
// error near 1e-3 over a 128-long contraction, ten times the 1e-4 it is
// held to.  So each is split into bf16 hi + lo (hi = bf16(v),
// lo = bf16(v - hi)) and its product runs twice, hi and lo into one f32
// accumulator: at most 2^-16 relative per term
// (tests/test_torch_ssd_schedule.py models this rounding on the CPU).
// The f32 route keeps its products on the CUDA cores in f32 FMA (pass 3
// is the first design's chunk body, the carried state loaded from the
// scratch buffer), with the same three passes and chunk-parallel grid.
// The dtype picks the route; nothing falls back.
//
// mma.m16n8k16 fragments (PTX ISA), g = lane / 4, q = lane % 4; each .b32
// register holds two bf16, the lower column in the low half:
//   A (16 x 16, row-major): a0 = row g, cols 2q, 2q+1; a1 = row g+8, the
//     same; a2 = row g, cols 2q+8, 2q+9; a3 = row g+8, the same.
//   B (16 x 8, "col"): b0 = rows 2q, 2q+1 of column g; b1 = rows 2q+8, 2q+9.
//   C (16 x 8 f32): c0, c1 = row g, cols 2q, 2q+1; c2, c3 = row g+8.
// Every operand is staged in shared memory row-major as it lies in global
// memory (16-byte loads and stores; rows padded by 8 bf16, so the eight
// rows of a fragment fall in distinct banks): C and B as [Q][N], whose
// pairs along N are the fragments of C and of B^T; B o sdec (hi, lo) as
// [Q][N], x as [Q][P] and S (hi, lo) as [N][P], whose fragments
// ldmatrix.trans reads transposed.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxQ = 128;     // warp 0 scans 4 positions per thread
constexpr int kNT = 32;        // f32 output pass: state columns per sub-tile
constexpr int kPad = 8;        // bf16 of padding per staged row
// The bf16 output pass is compiled for two blocks an SM (128 registers a
// thread; ptxas spills 148 bytes): one block an SM spills nothing and was
// slower on the card (PERF.md).  chip_smoke.py's phase 1 allows this one
// spill (SPILLS_ALLOWED) and fails on any other.
constexpr int kOutputBlocksPerSm = 2;

__host__ __device__ constexpr int round16(int q) { return (q + 15) / 16 * 16; }

// bf16 of the output pass's second region: B [Qa][Na + kPad] during the
// loop over N, then x [Qa][Pa + kPad].
__host__ __device__ constexpr size_t output_b_elems(int qa, int na, int pa) {
  return (size_t)qa * (na > pa ? na + kPad : pa + kPad);
}

// The chunk's dt (0 past the chunk and past the sequence) and the
// inclusive cumsum of dt * a.  Every pass computes it with this code, so
// passes 1 and 3 see the same bits.
__device__ void chunk_cumsum(const float* __restrict__ dt, int b, int S,
                             int H, int h, int t0, int Q, int Qa, float a_h,
                             float* dts, float* cum) {
  for (int j = threadIdx.x; j < Qa; j += blockDim.x) {
    const int pos = t0 + j;
    dts[j] = (j < Q && pos < S) ? dt[((size_t)b * S + pos) * H + h] : 0.0f;
  }
  __syncthreads();
  // Warp 0, four positions per thread, then a shuffle scan of the sums.
  if (threadIdx.x < 32) {
    const int t = threadIdx.x;
    float run[4];
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * t + e;
      acc += j < Qa ? dts[j] * a_h : 0.0f;
      run[e] = acc;
    }
    float incl = acc;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (t >= off) incl += up;
    }
    const float excl = incl - acc;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * t + e;
      if (j < Qa) cum[j] = excl + run[e];
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor-core products (mma.sync m16n8k16).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

__device__ __forceinline__ float value(uint16_t v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// v = hi + lo to 2^-16 relative, both bf16.
__device__ __forceinline__ void split(float v, uint16_t& hi, uint16_t& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi = bits(h);
  lo = bits(__float2bfloat16_rn(v - __bfloat162float(h)));
}

__device__ __forceinline__ uint32_t pack(uint16_t lo_col, uint16_t hi_col) {
  return (uint32_t)lo_col | ((uint32_t)hi_col << 16);
}

// Two bf16 at (row, col) and (row, col + 1) of a staged array.
__device__ __forceinline__ uint32_t pair(const uint16_t* s, int ld, int row,
                                         int col) {
  return *reinterpret_cast<const uint32_t*>(s + row * ld + col);
}

// Four 8 x 8 bf16 matrices of shared memory, transposed: thread T gives
// the address of row T % 8 of matrix T / 8 and receives, from matrix i,
// the elements (rows 2 (T % 4), 2 (T % 4) + 1; column T / 4) in r[i].  A
// row-major [k][m] array thus yields the fragments of its transpose.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint16_t* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The A fragment of rows m0 .. m0 + 15 and k-step k0 .. k0 + 15 of A^T,
// where `s` holds A^T row-major as [k][m] (row stride ld).
__device__ __forceinline__ void a_frag_t(uint32_t (&r)[4], const uint16_t* s,
                                         int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_x4_trans(r, s + (k0 + (lane & 7) + (mi & 2) * 4) * ld + m0 +
                       (mi & 1) * 8);
}

// The B fragments (b0, b1 of columns n0 .. n0 + 7, then of n0 + 8 ..
// n0 + 15) of k-step k0 .. k0 + 15, where `s` holds B row-major as [k][n].
__device__ __forceinline__ void b_frags(uint32_t (&r)[4], const uint16_t* s,
                                        int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_x4_trans(r, s + (k0 + (lane & 7) + (mi & 1) * 8) * ld + n0 +
                       (mi & 2) * 4);
}

// Stage `count` items into shared memory, kBatch per thread at a time:
// every load of a batch is issued before any of its stores, so each
// thread keeps kBatch loads in flight instead of waiting on one.
template <int kBatch, typename Item, typename Load, typename Store>
__device__ __forceinline__ void staged(int count, Load load, Store store) {
  for (int base = threadIdx.x; base < count; base += kBatch * kThreads) {
    Item v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < count) v[u] = load(idx);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < count) store(idx, v[u]);
    }
  }
}

struct F8 {
  float v[8];
};

struct uint4x2 {
  uint4 c, b;
};

// Eight elements c0 .. c0 + 7 of a global row (bf16 bits, or f32), 0 past
// `cols` and for a missing row; `vec` when cols % 8 == 0 and the rows are
// 16-byte aligned, so one or two 16-byte loads fetch them.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int c0,
                                       int cols, bool vec) {
  if (row == nullptr || c0 >= cols) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return *reinterpret_cast<const uint4*>(row + c0);
  uint16_t e[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) e[u] = c0 + u < cols ? bits(row[c0 + u]) : 0;
  return make_uint4(pack(e[0], e[1]), pack(e[2], e[3]), pack(e[4], e[5]),
                    pack(e[6], e[7]));
}

__device__ __forceinline__ F8 load8(const float* row, int c0, int cols,
                                    bool vec) {
  F8 f;
  if (row == nullptr || c0 >= cols) {
#pragma unroll
    for (int u = 0; u < 8; ++u) f.v[u] = 0.0f;
  } else if (vec) {
    const float4 lo = *reinterpret_cast<const float4*>(row + c0);
    const float4 hi = *reinterpret_cast<const float4*>(row + c0 + 4);
    f = F8{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) f.v[u] = c0 + u < cols ? row[c0 + u] : 0.0f;
  }
  return f;
}

// Stage rows 0 .. rows - 1 of a matrix, columns 0 .. cols_a - 1 (a multiple
// of 8), eight columns per item: src(j) is row j in global memory (or
// nullptr for a zero row), put(j, c0, item) stores.
template <typename Item, typename Src, typename Put>
__device__ __forceinline__ void stage_rows(int rows, int cols_a, int cols,
                                           bool vec, Src src, Put put) {
  const int per = cols_a / 8;
  staged<8, Item>(
      rows * per,
      [&](int idx) { return load8(src(idx / per), (idx % per) * 8, cols, vec); },
      [&](int idx, Item v) { put(idx / per, (idx % per) * 8, v); });
}

__device__ __forceinline__ void put8(uint16_t* s, int ld, int row, int c0,
                                     uint4 v) {
  *reinterpret_cast<uint4*>(s + row * ld + c0) = v;
}

// The eight values split into bf16 hi and lo rows.
__device__ __forceinline__ void put8_split(uint16_t* hi, uint16_t* lo, int ld,
                                           int row, int c0, const float* f) {
  uint16_t h[8], l[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) split(f[u], h[u], l[u]);
  put8(hi, ld, row, c0, make_uint4(pack(h[0], h[1]), pack(h[2], h[3]),
                                   pack(h[4], h[5]), pack(h[6], h[7])));
  put8(lo, ld, row, c0, make_uint4(pack(l[0], l[1]), pack(l[2], l[3]),
                                   pack(l[4], l[5]), pack(l[6], l[7])));
}

// Row j of the chunk's x (head h), or nullptr past the chunk or sequence.
__device__ __forceinline__ const __nv_bfloat16* x_row(
    const __nv_bfloat16* x, int b, int S, int H, int h, int P, int t0, int Q,
    int j) {
  const int pos = t0 + j;
  return j < Q && pos < S ? x + (((size_t)b * S + pos) * H + h) * P : nullptr;
}

// Row j of the chunk's B or C (group g), or nullptr.
__device__ __forceinline__ const __nv_bfloat16* bc_row(
    const __nv_bfloat16* m, int b, int S, int G, int g, int N, int t0, int Q,
    int j) {
  const int pos = t0 + j;
  return j < Q && pos < S ? m + (((size_t)b * S + pos) * G + g) * N : nullptr;
}

// Pass 1 (bf16): the chunk's own state s_c [N, P] = (B o sdec)^T x, with
// B o sdec split into hi and lo.  Staged row-major as in global memory
// (B o sdec [Q][N], x [Q][P]); ldmatrix.trans reads the fragments of their
// transposes.  Warp w owns state rows 16 mt + (0..15) for mt = w, w + 8,
// ...; every P column.
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_chunk_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const __nv_bfloat16* __restrict__ bm,
                           float* __restrict__ st, float* __restrict__ tot,
                           int S, int H, int P, int G, int N, int Q,
                           int vec_bc, int vec_x) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int chunks = gridDim.x;
  const int g = h / (H / G);
  const int t0 = c * Q;
  const int Qa = round16(Q), Na = round16(N), Pa = round16(P);
  const int ldn = Na + kPad, ldp = Pa + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* bh = reinterpret_cast<uint16_t*>(smem_raw);  // [Qa][ldn] hi
  uint16_t* bl = bh + (size_t)Qa * ldn;                   // [Qa][ldn] lo
  uint16_t* xs = bl + (size_t)Qa * ldn;                   // [Qa][ldp]
  float* dts = reinterpret_cast<float*>(xs + (size_t)Qa * ldp);
  float* cum = dts + Qa;
  float* sdec = cum + Qa;

  chunk_cumsum(dt, b, S, H, h, t0, Q, Qa, a[h], dts, cum);
  const float total = cum[Qa - 1];
  for (int j = threadIdx.x; j < Qa; j += kThreads) {
    sdec[j] = expf(total - cum[j]) * dts[j];
  }
  __syncthreads();

  stage_rows<uint4>(
      Qa, Na, N, vec_bc,
      [&](int j) { return bc_row(bm, b, S, G, g, N, t0, Q, j); },
      [&](int j, int c0, uint4 v) {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        float f[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          f[u] = value((uint16_t)(w[u / 2] >> (16 * (u % 2)))) * sdec[j];
        }
        put8_split(bh, bl, ldn, j, c0, f);
      });
  stage_rows<uint4>(
      Qa, Pa, P, vec_x,
      [&](int j) { return x_row(x, b, S, H, h, P, t0, Q, j); },
      [&](int j, int c0, uint4 v) { put8(xs, ldp, j, c0, v); });
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int pairs = Pa / 16;  // pairs of 8-column tiles
  float* out = st + ((size_t)(b * H + h) * chunks + c) * N * P;
  for (int mt = warp; mt < Na / 16; mt += kThreads / 32) {
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    }
    for (int k0 = 0; k0 < Qa; k0 += 16) {
      uint32_t ahi[4], alo[4];
      a_frag_t(ahi, bh, ldn, 16 * mt, k0);
      a_frag_t(alo, bl, ldn, 16 * mt, k0);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < pairs) {
          uint32_t bx[4];
          b_frags(bx, xs, ldp, 16 * np, k0);
          mma_bf16(acc[2 * np], ahi, bx[0], bx[1]);
          mma_bf16(acc[2 * np], alo, bx[0], bx[1]);
          mma_bf16(acc[2 * np + 1], ahi, bx[2], bx[3]);
          mma_bf16(acc[2 * np + 1], alo, bx[2], bx[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 16 * mt + gq + 8 * hf, p = 8 * nt + 2 * q;
        if (nt < 2 * pairs && n < N && p < P) {
          if ((P & 1) == 0) {
            *reinterpret_cast<float2*>(out + (size_t)n * P + p) =
                make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
          } else {
            out[(size_t)n * P + p] = acc[nt][2 * hf];
            if (p + 1 < P) out[(size_t)n * P + p + 1] = acc[nt][2 * hf + 1];
          }
        }
      }
    }
  }
  if (threadIdx.x == 0) tot[(size_t)(b * H + h) * chunks + c] = total;
}

// Pass 3 (bf16): y = exp(cum) C S_in + W x + d x with W = C B^T o L o dt.
// Warp m owns output rows 16 m + (0..15): their C B^T scores over the key
// tiles j <= 16 m + 15 and C S_in in one loop over N, then W (hi/lo) from
// the scores in registers times x.  C and B are staged as [Q][N], whose
// pairs along N are the fragments of C and of B^T; S_in (hi/lo) as [N][P]
// and x as [Q][P], read transposed by ldmatrix.trans.  x is staged where B
// was once the loop over N is done, so two blocks fit an SM.
__global__ void __launch_bounds__(kThreads, kOutputBlocksPerSm)
ssd_scan_output_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ a,
                            const __nv_bfloat16* __restrict__ bm,
                            const __nv_bfloat16* __restrict__ cm,
                            const float* __restrict__ dv,
                            const float* __restrict__ st,
                            __nv_bfloat16* __restrict__ y, int S, int H,
                            int P, int G, int N, int Q, int vec_bc,
                            int vec_x) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int chunks = gridDim.x;
  const int g = h / (H / G);
  const int t0 = c * Q;
  const int Qa = round16(Q), Na = round16(N), Pa = round16(P);
  const int ldn = Na + kPad, ldp = Pa + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* cs = reinterpret_cast<uint16_t*>(smem_raw);  // [Qa][ldn] C
  uint16_t* bs = cs + (size_t)Qa * ldn;                   // [Qa][ldn] B
  uint16_t* xs = bs;                     // [Qa][ldp] x, after the N loop
  uint16_t* sh = bs + output_b_elems(Qa, Na, Pa);         // [Na][ldp] S hi
  uint16_t* sl = sh + (size_t)Na * ldp;                   // [Na][ldp] S lo
  float* dts = reinterpret_cast<float*>(sl + (size_t)Na * ldp);
  float* cum = dts + Qa;
  float* ecum = cum + Qa;

  chunk_cumsum(dt, b, S, H, h, t0, Q, Qa, a[h], dts, cum);
  for (int j = threadIdx.x; j < Qa; j += kThreads) ecum[j] = expf(cum[j]);

  // C and B together: both rows' loads of a batch in flight at once.
  const int per = Na / 8;
  staged<8, uint4x2>(
      Qa * per,
      [&](int idx) {
        const int j = idx / per, c0 = (idx % per) * 8;
        return uint4x2{load8(bc_row(cm, b, S, G, g, N, t0, Q, j), c0, N, vec_bc),
                       load8(bc_row(bm, b, S, G, g, N, t0, Q, j), c0, N, vec_bc)};
      },
      [&](int idx, const uint4x2& v) {
        const int j = idx / per, c0 = (idx % per) * 8;
        put8(cs, ldn, j, c0, v.c);
        put8(bs, ldn, j, c0, v.b);
      });
  const float* sin = st + ((size_t)(b * H + h) * chunks + c) * N * P;
  stage_rows<F8>(
      Na, Pa, P, (P & 7) == 0,
      [&](int n) { return n < N ? sin + (size_t)n * P : nullptr; },
      [&](int n, int c0, const F8& f) { put8_split(sh, sl, ldp, n, c0, f.v); });
  __syncthreads();

  const int m = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool rows = m < Qa / 16;  // short chunks leave warps without rows
  const int gq = lane >> 2, q = lane & 3;
  const int r0 = 16 * m + gq;       // rows r0 and r0 + 8
  const int pairs = Pa / 16;
  const int jtiles = 2 * m + 2;     // 8-wide key tiles with j <= 16 m + 15

  float sc[16][4], ya[8][4];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[t][e] = 0.0f;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ya[nt][e] = 0.0f;
  }

  // C B^T and C S_in, sharing C's fragments, over N in steps of 16.
  for (int k0 = 0; rows && k0 < Na; k0 += 16) {
    const int kq = k0 + 2 * q;
    const uint32_t ac[4] = {pair(cs, ldn, r0, kq), pair(cs, ldn, r0 + 8, kq),
                            pair(cs, ldn, r0, kq + 8),
                            pair(cs, ldn, r0 + 8, kq + 8)};
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if (t < jtiles) {
        mma_bf16(sc[t], ac, pair(bs, ldn, 8 * t + gq, kq),
                 pair(bs, ldn, 8 * t + gq, kq + 8));
      }
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np < pairs) {
        uint32_t bhi[4], blo[4];
        b_frags(bhi, sh, ldp, 16 * np, k0);
        b_frags(blo, sl, ldp, 16 * np, k0);
        mma_bf16(ya[2 * np], ac, bhi[0], bhi[1]);
        mma_bf16(ya[2 * np], ac, blo[0], blo[1]);
        mma_bf16(ya[2 * np + 1], ac, bhi[2], bhi[3]);
        mma_bf16(ya[2 * np + 1], ac, blo[2], blo[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with B: x takes its place
  stage_rows<uint4>(
      Qa, Pa, P, vec_x,
      [&](int j) { return x_row(x, b, S, H, h, P, t0, Q, j); },
      [&](int j, int c0, uint4 v) { put8(xs, ldp, j, c0, v); });
  __syncthreads();
  if (!rows) return;

  const float e_a = ecum[r0], e_b = ecum[r0 + 8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    ya[nt][0] *= e_a;
    ya[nt][1] *= e_a;
    ya[nt][2] *= e_b;
    ya[nt][3] *= e_b;
  }

  // W = scores o exp(cum_i - cum_j) o dt_j for j <= i (the mask inside the
  // exponent's argument: for j > i it would overflow), as hi/lo A
  // fragments: key tiles 2 kk and 2 kk + 1 form the k-step kk.  __expf
  // (ex2.approx): its few ulps of error for an argument <= 0 lie far
  // below the 2^-16 of the split.
  const float cum_a = cum[r0], cum_b = cum[r0 + 8];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk <= m) {
      uint16_t whi[2][4], wlo[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 2 * kk + half;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + (e >> 1) * 8, j = 8 * t + 2 * q + (e & 1);
          const float ci = (e >> 1) ? cum_b : cum_a;
          const float w =
              i >= j ? sc[t][e] * __expf(ci - cum[j]) * dts[j] : 0.0f;
          split(w, whi[half][e], wlo[half][e]);
        }
      }
      const uint32_t ahi[4] = {pack(whi[0][0], whi[0][1]),
                               pack(whi[0][2], whi[0][3]),
                               pack(whi[1][0], whi[1][1]),
                               pack(whi[1][2], whi[1][3])};
      const uint32_t alo[4] = {pack(wlo[0][0], wlo[0][1]),
                               pack(wlo[0][2], wlo[0][3]),
                               pack(wlo[1][0], wlo[1][1]),
                               pack(wlo[1][2], wlo[1][3])};
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < pairs) {
          uint32_t bx[4];
          b_frags(bx, xs, ldp, 16 * np, 16 * kk);
          mma_bf16(ya[2 * np], ahi, bx[0], bx[1]);
          mma_bf16(ya[2 * np], alo, bx[0], bx[1]);
          mma_bf16(ya[2 * np + 1], ahi, bx[2], bx[3]);
          mma_bf16(ya[2 * np + 1], alo, bx[2], bx[3]);
        }
      }
    }
  }

  const float d_h = dv[h];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = r0 + 8 * hf, p = 8 * nt + 2 * q;
      const int pos = t0 + i;
      if (nt < 2 * pairs && i < Q && pos < S && p < P) {
        __nv_bfloat16* yp = y + (((size_t)b * S + pos) * H + h) * P + p;
        const float y0 = ya[nt][2 * hf] + value(xs[i * ldp + p]) * d_h;
        const float y1 = ya[nt][2 * hf + 1] + value(xs[i * ldp + p + 1]) * d_h;
        if ((P & 1) == 0) {
          *reinterpret_cast<uint32_t*>(yp) =
              pack(bits(__float2bfloat16(y0)), bits(__float2bfloat16(y1)));
        } else {
          yp[0] = __float2bfloat16(y0);
          if (p + 1 < P) yp[1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: CUDA-core products (f32 FMA).
// ---------------------------------------------------------------------------

// Pass 1 (f32): s_c[n, p] = sum_j B[j, n] sdec_j x[j, p].
__global__ void __launch_bounds__(kThreads)
ssd_scan_chunk_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ bm,
                          float* __restrict__ st, float* __restrict__ tot,
                          int S, int H, int P, int G, int N, int Q) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int chunks = gridDim.x;
  const int g = h / (H / G);
  const int t0 = c * Q;
  const int Qa = round16(Q);

  extern __shared__ float smem[];
  float* xs = smem;                    // [Qa][P]
  float* bsd = xs + (size_t)Qa * P;    // [Qa][N] B o sdec
  float* dts = bsd + (size_t)Qa * N;
  float* cum = dts + Qa;
  float* sdec = cum + Qa;

  chunk_cumsum(dt, b, S, H, h, t0, Q, Qa, a[h], dts, cum);
  const float total = cum[Qa - 1];
  for (int j = threadIdx.x; j < Qa; j += kThreads) {
    sdec[j] = expf(total - cum[j]) * dts[j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < Qa * N; idx += kThreads) {
    const int j = idx / N, n = idx % N;
    const int pos = t0 + j;
    bsd[idx] = (j < Q && pos < S)
                   ? bm[(((size_t)b * S + pos) * G + g) * N + n] * sdec[j]
                   : 0.0f;
  }
  for (int idx = threadIdx.x; idx < Qa * P; idx += kThreads) {
    const int j = idx / P, p = idx % P;
    const int pos = t0 + j;
    xs[idx] = (j < Q && pos < S) ? x[(((size_t)b * S + pos) * H + h) * P + p]
                                 : 0.0f;
  }
  __syncthreads();

  float* out = st + ((size_t)(b * H + h) * chunks + c) * N * P;
  for (int idx = threadIdx.x; idx < N * P; idx += kThreads) {
    const int n = idx / P, p = idx % P;
    float acc = 0.0f;
    for (int j = 0; j < Qa; ++j) acc = fmaf(bsd[j * N + n], xs[j * P + p], acc);
    out[idx] = acc;
  }
  if (threadIdx.x == 0) tot[(size_t)(b * H + h) * chunks + c] = total;
}

// Floats of shared memory of the f32 output pass: state [N][P], x [Qa][P],
// C and B sub-tiles [Qa][kNT + 1], the masked matrix [Qa][Qa + 1], and
// three [Qa] vectors.
__host__ __device__ constexpr size_t output_f32_floats(int q, int n, int p) {
  return (size_t)n * p + (size_t)round16(q) * p +
         2 * (size_t)round16(q) * (kNT + 1) +
         (size_t)round16(q) * (round16(q) + 1) + 3 * (size_t)round16(q);
}

// Pass 3 (f32): the first design's chunk body, the state carried in read
// from the scratch buffer.  Each thread owns rows ti + 16 a and columns
// tj + 16 b of the [Q, Q] and [Q, P] tiles in registers; B and C are
// staged in sub-tiles of kNT state columns.
template <int PC>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_output_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const float* __restrict__ bm,
                           const float* __restrict__ cm,
                           const float* __restrict__ dv,
                           const float* __restrict__ st_in,
                           float* __restrict__ y, int S, int H, int P, int G,
                           int N, int Q) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int chunks = gridDim.x;
  const int g = h / (H / G);
  const int t0 = c * Q;
  const int Qa = round16(Q);
  const int na = Qa / 16;  // rows (and [Q, Q] columns) per thread
  const int ti = threadIdx.x >> 4;
  const int tj = threadIdx.x & 15;
  const float d_h = dv[h];

  extern __shared__ float smem[];
  float* st = smem;                    // [N][P]
  float* xs = st + (size_t)N * P;      // [Qa][P]
  float* cs = xs + (size_t)Qa * P;     // [Qa][kNT + 1]
  float* bs = cs + Qa * (kNT + 1);     // [Qa][kNT + 1]
  float* wsm = bs + Qa * (kNT + 1);    // [Qa][Qa + 1]
  float* dts = wsm + Qa * (Qa + 1);    // [Qa] dt
  float* cum = dts + Qa;               // [Qa] cumsum of dt * a
  float* ecum = cum + Qa;              // [Qa] exp(cum)

  const float* sin = st_in + ((size_t)(b * H + h) * chunks + c) * N * P;
  for (int idx = threadIdx.x; idx < N * P; idx += kThreads) st[idx] = sin[idx];
  for (int idx = threadIdx.x; idx < Qa * P; idx += kThreads) {
    const int j = idx / P, p = idx % P;
    const int pos = t0 + j;
    xs[idx] = (j < Q && pos < S) ? x[(((size_t)b * S + pos) * H + h) * P + p]
                                 : 0.0f;
  }
  chunk_cumsum(dt, b, S, H, h, t0, Q, Qa, a[h], dts, cum);
  for (int j = threadIdx.x; j < Qa; j += kThreads) ecum[j] = expf(cum[j]);

  float w[8][8], ya[8][PC];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int s = 0; s < 8; ++s) w[r][s] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) ya[r][cc] = 0.0f;
  }

  for (int n0 = 0; n0 < N; n0 += kNT) {
    __syncthreads();  // the previous sub-tile has been read
    for (int idx = threadIdx.x; idx < Qa * kNT; idx += kThreads) {
      const int j = idx / kNT, n = idx % kNT;
      const int pos = t0 + j;
      float cv = 0.0f, bv = 0.0f;
      if (j < Q && pos < S && n0 + n < N) {
        const size_t off = (((size_t)b * S + pos) * G + g) * N + n0 + n;
        cv = cm[off];
        bv = bm[off];
      }
      cs[j * (kNT + 1) + n] = cv;
      bs[j * (kNT + 1) + n] = bv;
    }
    __syncthreads();

    // C B^T into w, and C S (the state carried in) into ya.
    const int nt = min(kNT, N - n0);
    for (int n = 0; n < nt; ++n) {
      float cv[8], bv[8], sv[PC];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        cv[r] = r < na ? cs[(ti + 16 * r) * (kNT + 1) + n] : 0.0f;
        bv[r] = r < na ? bs[(tj + 16 * r) * (kNT + 1) + n] : 0.0f;
      }
#pragma unroll
      for (int cc = 0; cc < PC; ++cc) {
        const int p = tj + 16 * cc;
        sv[cc] = p < P ? st[(n0 + n) * P + p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int s = 0; s < 8; ++s) w[r][s] = fmaf(cv[r], bv[s], w[r][s]);
#pragma unroll
        for (int cc = 0; cc < PC; ++cc) {
          ya[r][cc] = fmaf(cv[r], sv[cc], ya[r][cc]);
        }
      }
    }
  }

  // The masked, decayed [Q, Q] matrix; the mask sits inside the exponent.
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r >= na) continue;
    const int i = ti + 16 * r;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (s >= na) continue;
      const int j = tj + 16 * s;
      wsm[i * (Qa + 1) + j] =
          i >= j ? w[r][s] * expf(cum[i] - cum[j]) * dts[j] : 0.0f;
    }
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) ya[r][cc] *= ecum[i];
  }
  __syncthreads();

  // y = exp(cum) C S + sum_{j <= i} W_ij x_j + d x.
  for (int j = 0; j < Qa; ++j) {
    float wv[8], xv[PC];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      wv[r] = r < na ? wsm[(ti + 16 * r) * (Qa + 1) + j] : 0.0f;
    }
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) {
      const int p = tj + 16 * cc;
      xv[cc] = p < P ? xs[j * P + p] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int cc = 0; cc < PC; ++cc) ya[r][cc] = fmaf(wv[r], xv[cc], ya[r][cc]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ti + 16 * r;
    const int pos = t0 + i;
    if (r >= na || i >= Q || pos >= S) continue;
#pragma unroll
    for (int cc = 0; cc < PC; ++cc) {
      const int p = tj + 16 * cc;
      if (p >= P) continue;
      y[(((size_t)b * S + pos) * H + h) * P + p] = ya[r][cc] + xs[i * P + p] * d_h;
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2, both routes: the carry from chunk to chunk.
// ---------------------------------------------------------------------------

// Thread (e, head, batch) walks the chunks for the state elements
// e + kThreads * u, u < kElems: s_c is replaced by the state carried into
// chunk c, and the state after the last chunk is written.  Loads of eight
// chunks are in flight at a time, then their recurrence runs.
constexpr int kElems = 4;
__global__ void __launch_bounds__(kThreads)
ssd_scan_state_kernel(float* __restrict__ st, const float* __restrict__ tot,
                      float* __restrict__ state_out, int H, int NP,
                      int chunks) {
  const int e0 = blockIdx.x * kThreads * kElems + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)(b * H + h) * chunks;
  constexpr int kBatch = 8;
  float s[kElems];
#pragma unroll
  for (int u = 0; u < kElems; ++u) s[u] = 0.0f;
  for (int c0 = 0; c0 < chunks; c0 += kBatch) {
    float own[kBatch][kElems], decay[kBatch];
#pragma unroll
    for (int cc = 0; cc < kBatch; ++cc) {
      if (c0 + cc < chunks) {
        decay[cc] = expf(tot[base + c0 + cc]);
#pragma unroll
        for (int u = 0; u < kElems; ++u) {
          const int e = e0 + kThreads * u;
          own[cc][u] = e < NP ? st[(base + c0 + cc) * NP + e] : 0.0f;
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < kBatch; ++cc) {
      if (c0 + cc < chunks) {
#pragma unroll
        for (int u = 0; u < kElems; ++u) {
          const int e = e0 + kThreads * u;
          if (e < NP) st[(base + c0 + cc) * NP + e] = s[u];
          s[u] = s[u] * decay[cc] + own[cc][u];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kElems; ++u) {
    const int e = e0 + kThreads * u;
    if (e < NP) state_out[(size_t)(b * H + h) * NP + e] = s[u];
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

size_t chunk_bf16_bytes(int q, int n, int p) {
  const size_t qa = round16(q), ldn = round16(n) + kPad;
  const size_t ldp = round16(p) + kPad;
  return 2 * (2 * qa * ldn + qa * ldp) + 4 * 3 * qa;
}

size_t output_bf16_bytes(int q, int n, int p) {
  const size_t qa = round16(q), na = round16(n), ldp = round16(p) + kPad;
  return 2 * (qa * (na + kPad) +
              output_b_elems(round16(q), round16(n), round16(p)) +
              2 * na * ldp) +
         4 * 3 * qa;
}

size_t chunk_f32_bytes(int q, int n, int p) {
  return 4 * ((size_t)round16(q) * (p + n) + 3 * (size_t)round16(q));
}

// Opt `kernel` into `bytes` of dynamic shared memory; over the card's
// limit the error is cleared (so the next launch does not report it) and
// returned.
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

int run_bf16(const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, const void* d, void* y, void* state,
             void* scratch, int B, int S, int H, int P, int G, int N, int Q,
             cudaStream_t stream) {
  const int chunks = (S + Q - 1) / Q;
  const size_t s1 = chunk_bf16_bytes(Q, N, P), s3 = output_bf16_bytes(Q, N, P);
  cudaError_t err = opt_in(ssd_scan_chunk_bf16_kernel, s1);
  if (err == cudaSuccess) err = opt_in(ssd_scan_output_bf16_kernel, s3);
  if (err != cudaSuccess) return (int)err;
  float* st = static_cast<float*>(scratch);
  float* tot = st + (size_t)B * H * chunks * N * P;
  const dim3 grid(chunks, H, B);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(bm);
  // 16-byte loads where rows are whole 16-byte units.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_bc = N % 8 == 0 && aligned(bm) && aligned(cm);
  const int vec_x = P % 8 == 0 && aligned(x);
  ssd_scan_chunk_bf16_kernel<<<grid, kThreads, s1, stream>>>(
      xb, static_cast<const float*>(dt), static_cast<const float*>(a), bb, st,
      tot, S, H, P, G, N, Q, vec_bc, vec_x);
  ssd_scan_state_kernel<<<dim3((N * P + kThreads * kElems - 1) /
                                   (kThreads * kElems), H, B),
                          kThreads, 0, stream>>>(
      st, tot, static_cast<float*>(state), H, N * P, chunks);
  ssd_scan_output_bf16_kernel<<<grid, kThreads, s3, stream>>>(
      xb, static_cast<const float*>(dt), static_cast<const float*>(a), bb,
      static_cast<const __nv_bfloat16*>(cm), static_cast<const float*>(d), st,
      static_cast<__nv_bfloat16*>(y), S, H, P, G, N, Q, vec_bc, vec_x);
  return (int)cudaGetLastError();
}

template <int PC>
int run_f32(const void* x, const void* dt, const void* a, const void* bm,
            const void* cm, const void* d, void* y, void* state,
            void* scratch, int B, int S, int H, int P, int G, int N, int Q,
            cudaStream_t stream) {
  const int chunks = (S + Q - 1) / Q;
  const size_t s1 = chunk_f32_bytes(Q, N, P);
  const size_t s3 = output_f32_floats(Q, N, P) * sizeof(float);
  cudaError_t err = opt_in(ssd_scan_chunk_f32_kernel, s1);
  if (err == cudaSuccess) err = opt_in(ssd_scan_output_f32_kernel<PC>, s3);
  if (err != cudaSuccess) return (int)err;
  float* st = static_cast<float*>(scratch);
  float* tot = st + (size_t)B * H * chunks * N * P;
  const dim3 grid(chunks, H, B);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(bm);
  ssd_scan_chunk_f32_kernel<<<grid, kThreads, s1, stream>>>(
      xf, static_cast<const float*>(dt), static_cast<const float*>(a), bf, st,
      tot, S, H, P, G, N, Q);
  ssd_scan_state_kernel<<<dim3((N * P + kThreads * kElems - 1) /
                                   (kThreads * kElems), H, B),
                          kThreads, 0, stream>>>(
      st, tot, static_cast<float*>(state), H, N * P, chunks);
  ssd_scan_output_f32_kernel<PC><<<grid, kThreads, s3, stream>>>(
      xf, static_cast<const float*>(dt), static_cast<const float*>(a), bf,
      static_cast<const float*>(cm), static_cast<const float*>(d), st,
      static_cast<float*>(y), S, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the three passes on `stream` and returns the CUDA error (0 on
// success; a pass whose shared memory exceeds the card's limit is refused
// before anything runs).  Takes 1 <= chunk <= 128, 1 <= P <= 64, N >= 1,
// H a multiple of G; bf16 = 1 for bfloat16 x, b and c, 0 for float32.
// `scratch` holds B * H * ceil(S / chunk) * (N * P + 1) floats: the
// chunks' states, then their totals.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* d,
                               void* y, void* state, void* scratch, int B,
                               int S, int H, int P, int G, int N, int chunk,
                               int bf16, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H < G || H % G != 0 || P < 1 || P > 64 ||
      N < 1 || chunk < 1 || chunk > kMaxQ || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return run_bf16(x, dt, a, b, c, d, y, state, scratch, B, S, H, P, G, N,
                    chunk, s);
  }
  if (P <= 32) {
    return run_f32<2>(x, dt, a, b, c, d, y, state, scratch, B, S, H, P, G, N,
                      chunk, s);
  }
  return run_f32<4>(x, dt, a, b, c, d, y, state, scratch, B, S, H, P, G, N,
                    chunk, s);
}
