// flash_attention: causal attention with a blocked online softmax, for
// Hopper (sm_90a).  Two kernels, one per input type: bfloat16 runs on the
// tensor cores (wgmma, fed by TMA), float32 on the CUDA cores.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_kernel over a
// (batch * kv head, q block, kv block) grid whose last axis carries (max,
// denominator, accumulator) in VMEM scratch).
//
// Contract.  q [B, S, H, hd]; k, v [B, S, G, hd], all float32 or all
// bfloat16; out [B, S, H, hd] in their type.  Head h reads KV head
// h / (H / G).  Scores are f32: s = (q . k) * scale, then
// softcap * tanh(s / softcap) when softcap > 0, then the causal mask
// (key <= query) and, when window > 0, the window (query - key < window),
// masked scores set to -1e30.  Online softmax with f32 m, l and
// accumulator; p is rounded to the input type before the PV product (the
// reference's p.astype(v.dtype)); out = acc / max(l, 1e-30).
//
// What bounds it.  4 * hd flops per visible (query, key) pair per head:
// at qwen2-7b's prefill (S = 4096, H = 28, hd = 128, causal) 120 GFLOP,
// about 0.12 ms at the 989 TFLOP/s of the bf16 tensor cores; the bytes
// (q, k, v, out: 71 MB) take 0.02 ms.  Operations bound it.  Each pair
// also costs an exp on the SFU (16 per clock per SM: 0.06 ms there) and,
// with a softcap, a tanh: at gemma2-27b's prefill (0.8 G pairs) one SFU
// operation each takes 0.39 ms at the least, just under the products'
// 0.42 ms, so the softmax of one warpgroup has to run under the other's
// products.  This kernel takes the tanh as ex2 and rcp (a few ulps of 1;
// tanh.approx is one operation but errs by 2^-11 relative), three SFU
// operations a pair, about 0.58 ms: on the softcap path the SFU, not the
// tensor cores, bounds it.
//
// bfloat16 design (sm90 below).  One block per (query tile of 128 rows,
// head, batch): two consumer warpgroups of 64 rows and a producer
// warpgroup (setmaxnreg moves its registers to the consumers, 24 / 240,
// though ptxas still allocates the consumer code within the launch
// bound's 168).  One producer thread loads the query tile once and keeps a ring of
// kStages K/V tiles of 128 keys full with TMA (cp.async.bulk.tensor, one
// mbarrier per tile for K and one for V, so S = Q K^T starts before V has
// landed); consumer warps release a stage on an `empty` mbarrier.  Tiles
// are 64-column atoms of 128-byte rows, 128-byte swizzled by TMA, which is
// the layout wgmma's descriptors read: hd = 64 is one atom, hd = 80 and
// 128 are two (TMA fills columns past hd with zeros, so Q K^T is
// unchanged and the extra output columns are never stored).  S = Q K^T is
// wgmma m64n128k16 with both operands in shared memory; the scale, softcap
// (tanh from ex2 and rcp; the softcap is a template parameter) and the
// masks run on the f32 accumulator in registers, the masks as a pass of
// their own only on tiles that hold a key after a row or outside a row's
// window; the softmax runs in base 2 on scores pre-multiplied by log2(e),
// its row maxima and sums over four partials each, so no chain of
// dependent operations runs through a whole row.  P is rounded to bf16 pairs in registers,
// which are the A fragments of O += P V (wgmma with A from registers); V's
// transpose is the descriptor's trans-b bit, not a copy.  Only the key
// tiles the causal mask and the window leave visible are visited (a
// skipped tile adds exactly 0), and query tiles run heaviest first so the
// tail of the grid is light.  The two warpgroups overlap each other's
// softmax with their products.  Overlapping inside a warpgroup as well
// (Q K^T of tile i in flight with P V of tile i - 1, a second set of P
// registers, 3 stages) ran slower on the card: ptxas holds the consumers
// to the 168 registers of the launch bound, spills about 200 bytes and
// serialises the wgmmas.
//
// float32 design (f32 below).  One block per (query tile of 64, head,
// batch), 256 threads; query and K/V tiles staged in shared memory as f32
// (rows padded by one word), each thread 4 rows x 4 keys of the score
// tile and 4 rows x hd / 16 columns of the accumulator, f32 FMA: there is
// no bf16 product to give it tensor cores without changing its numbers.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: f32 FMA on the CUDA cores.
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups

// Rows of 64 positions x hd values from a [B, S, heads, hd] tensor, zero
// past the sequence's end.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int b, int pos0, int head, int S,
                                          int heads) {
  for (int idx = threadIdx.x; idx < kBK * HD; idx += kThreads) {
    const int row = idx / HD, col = idx % HD;
    const int pos = pos0 + row;
    dst[row * (HD + 1) + col] =
        pos < S ? src[(((size_t)b * S + pos) * heads + head) * HD + col] : 0.0f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int H, int G, int window, float softcap,
                       float scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int OC = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                         // [kBQ][HD + 1]
  float* kv = qs + kBQ * (HD + 1);          // [kBK][HD + 1]
  float* ps = kv + kBK * (HD + 1);          // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int rg = threadIdx.x >> 4;  // rows rg + 16 i
  const int cg = threadIdx.x & 15;  // keys cg + 16 j, columns cg + 16 c

  load_tile<HD>(qs, q, b, q0, h, S, H);

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = k_first / kBK; kt <= q_last / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's PV is done with kv and ps
    load_tile<HD>(kv, k, b, k0, g, S, G);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kw[j] = kv[(cg + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kw[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const bool ok = kpos <= qpos && (window <= 0 || qpos - kpos < window);
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(rg + 16 * i) * (kBK + 1) + cg + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with K and has written its p
    load_tile<HD>(kv, v, b, k0, g, S, G);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = kv[kk * (HD + 1) + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rg + 16 * i;
    if (qpos >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float* o = out + (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[cg + 16 * c] = acc[i][c] * inv;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int G, int window, float softcap, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (HD + 1) +
                                           (size_t)kBQ * (kBK + 1));
  auto kernel = flash_attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, G, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA, warp-specialised.
// ---------------------------------------------------------------------------

namespace sm90 {

constexpr int kBQ = 128;             // query rows per block: 2 x 64
constexpr int kBK = 128;             // keys per K/V tile
constexpr int kConsumers = 2;        // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kStages = 2;           // K/V ring depth
constexpr int kAtomCols = 64;        // bf16 columns of one 128-byte row
constexpr int kTileBytes = kBK * 128;  // one 64-column atom of a K/V tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of `bar` with parity `parity` has completed.  A
// wait that never ends (a fault in the pipeline) traps after 2^28 tries,
// so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (tries == (1u << 28)) __trap();
  }
}

// One box {64 columns, 1 head, rows, 1 batch} of a [B, S, heads, hd] bf16
// tensor into shared memory, 128-byte swizzled; completion on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
// lbo / sbo in bytes: for a K-major operand sbo is the stride of 8-row
// groups (1024) and lbo is unused; for an MN-major one lbo is the stride
// between 64-column atoms and sbo that of 8-row groups along K.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = 1 - 2 / (1 + e^(2y)): two SFU operations, an absolute error
// of a few ulps of 1 (tanhf is about twenty instructions).
__device__ __forceinline__ float fast_tanh(float y) {
  return 1.0f - 2.0f * rcp(1.0f + ex2(y * (2.0f * kLog2e)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0 .. 64) (+)= A . B for a 64 x 128 tile, A and B K-major in shared
// memory (128-byte swizzle); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0 .. 64) += A . B for a 64 x 128 tile, A (bf16 pairs) in registers,
// B MN-major in shared memory (128-byte swizzle, transposed by the
// descriptor's trans-b bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[0 .. 32) += A . B for a 64 x 64 tile, A (bf16 pairs) in registers,
// B MN-major in shared memory (128-byte swizzle, transposed by the
// descriptor's trans-b bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int HDP>
__device__ __forceinline__ void wgmma_rs(float (&d)[HDP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (HDP == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    wgmma_rs_n64(d, a, desc_b);
  }
}

// Shared memory, from a 1024-byte aligned base: Q [HDP / 64 atoms][kBQ rows
// x 128 B], then kStages x (K, V) [HDP / 64 atoms][kBK rows x 128 B], then
// the barriers.
template <int HDP>
struct Layout {
  static constexpr int kAtoms = HDP / kAtomCols;
  static constexpr int kQBytes = kAtoms * kBQ * 128;
  static constexpr int kKVBytes = kAtoms * kTileBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages);
  static constexpr size_t kSmem = 1024 + kBytes;  // + the alignment slack
};

// grid (H, number of query tiles, B); block kThreads.  Query tiles run
// heaviest first: blockIdx.y = 0 is the last tile.  scale_l2 = scale *
// log2(e) without a softcap; with one, scores are
// cap_l2 * tanh(qk * pre_cap), cap_l2 = softcap * log2(e): the softmax runs
// in base 2 on scores already multiplied by log2(e).
template <int HDP, bool CAPPED>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out, int S, int H, int G,
                       int hd, int window, float scale_l2,
                       float pre_cap, float cap_l2) {
  using L = Layout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int h = blockIdx.x;
  const int n_qt = gridDim.y;
  const int qt = n_qt - 1 - blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int q0 = qt * kBQ;
  // The key tiles any row of this query tile sees (checked against a
  // brute-force mask in tests/test_torch_sm90_schedule.py).
  const int kt_first = (window > 0 ? max(0, q0 - window + 1) : 0) / kBK;
  const int kt_last = (min(q0 + kBQ, S) - 1) / kBK;
  const int n_tiles = kt_last - kt_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer: one thread keeps the K/V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int a = 0; a < L::kAtoms; ++a) {
        tma_load(smem + L::kQ + a * kBQ * 128, &tm_q, q_full, a * kAtomCols,
                 h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int k0 = (kt_first + it) * kBK;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[st], L::kKVBytes);
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(smem + L::kK + st * L::kKVBytes + a * kTileBytes, &tm_k,
                   &k_full[st], a * kAtomCols, g, k0, b);
        }
        mbar_expect_tx(&v_full[st], L::kKVBytes);
        for (int a = 0; a < L::kAtoms; ++a) {
          tma_load(smem + L::kV + st * L::kKVBytes + a * kTileBytes, &tm_v,
                   &v_full[st], a * kAtomCols, g, k0, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg .. + 63.  Thread t of the
  // warpgroup holds rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8 of the
  // accumulators, columns 8 j + 2 (t % 4) + {0, 1}.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int t = threadIdx.x % 128;
  const int quad = t & 3;
  const int qw0 = q0 + 64 * wg;
  const int row0 = qw0 + 16 * (t / 32) + (t % 32) / 4;
  const int row1 = row0 + 8;
  const uint32_t q_base = smem_u32(smem + L::kQ) + 64 * wg * 128;
  const uint32_t k_base = smem_u32(smem + L::kK);
  const uint32_t v_base = smem_u32(smem + L::kV);

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const int k0 = (kt_first + it) * kBK;

    // S = Q K^T over hd in k-steps of 16 (32 bytes of a 128-byte row).
    float s[kBK / 2];
    mbar_wait(&k_full[st], phase);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HDP / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      const uint64_t da =
          make_desc(q_base + (ks / 4) * kBQ * 128 + off, 16, 1024);
      const uint64_t db = make_desc(
          k_base + st * L::kKVBytes + (ks / 4) * kTileBytes + off, 16, 1024);
      wgmma_ss_n128(s, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scores in base 2; the masks only where a key of the tile lies after
    // a row of the warpgroup, or at or beyond a row's window.
    const bool masked = k0 + kBK - 1 > qw0 ||
                        (window > 0 && k0 <= qw0 + 63 - window);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      s[i] = CAPPED ? cap_l2 * fast_tanh(s[i] * pre_cap) : s[i] * scale_l2;
    }
    if (masked) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        const bool ok = key <= row && (window <= 0 || row - key < window);
        s[i] = ok ? s[i] : kNegInf;
      }
    }
    // Row maxima and sums over four partials each, so no chain of
    // dependent operations runs through all 32 values of a row.
    float mx[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[0][j] = fmaxf(s[4 * j + 0], s[4 * j + 1]);
      mx[1][j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int j = 4; j < kBK / 8; ++j) {
      mx[0][j % 4] = fmaxf(mx[0][j % 4], fmaxf(s[4 * j + 0], s[4 * j + 1]));
      mx[1][j % 4] = fmaxf(mx[1][j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float mx0 = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
    float mx1 = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p = 2^(s - m) in f32 for the row sums, rounded to bf16 pairs as the
    // A operand of P V (k-step kk: keys 16 kk .. 16 kk + 15).
    uint32_t pa[kBK / 16][4];
    float sums[2][4] = {};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p0 = ex2(s[4 * j + 0] - mn0), p1 = ex2(s[4 * j + 1] - mn0);
      const float p2 = ex2(s[4 * j + 2] - mn1), p3 = ex2(s[4 * j + 3] - mn1);
      sums[0][j % 4] += p0 + p1;
      sums[1][j % 4] += p2 + p3;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    float sum0 = (sums[0][0] + sums[0][1]) + (sums[0][2] + sums[0][3]);
    float sum1 = (sums[1][0] + sums[1][1]) + (sums[1][2] + sums[1][3]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xFFFFFFFFu, sum0, off);
      sum1 += __shfl_xor_sync(0xFFFFFFFFu, sum1, off);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      o[4 * j + 0] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // O += P V over the tile's keys in k-steps of 16 (16 rows of 128 B).
    mbar_wait(&v_full[st], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = make_desc(
          v_base + st * L::kKVBytes + kk * 16 * 128, kTileBytes, 1024);
      wgmma_rs<HDP>(o, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    if (t % 32 == 0) mbar_arrive(&empty[st]);
  }

  // out = acc / max(l, 1e-30); rows past S and columns past hd are not
  // stored.
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (col >= hd) continue;
    if (row0 < S) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          out + (((size_t)b * S + row0) * H + h) * hd + col);
      *dst = __floats2bfloat162_rn(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
    }
    if (row1 < S) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          out + (((size_t)b * S + row1) * H + h) * hd + col);
      *dst = __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The map of a [B, S, heads, hd] bf16 tensor read in boxes of {64 columns,
// 1 head, rows, 1 batch}, 128-byte swizzled; reads past hd or S fill zeros.
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int heads,
            int hd, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {kAtomCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int G, int hd, int window, float softcap,
           float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode(&tm_q, q, B, S, H, hd, kBQ) ||
      !encode(&tm_k, k, B, S, G, hd, kBK) ||
      !encode(&tm_v, v, B, S, G, hd, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = Layout<HDP>::kSmem;
  const bool capped = softcap > 0.0f;
  auto kernel = capped ? flash_attention_kernel<HDP, true>
                       : flash_attention_kernel<HDP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_l2 = scale * kLog2e;
  const float pre_cap = capped ? scale / softcap : 0.0f;
  const float cap_l2 = softcap * kLog2e;
  const dim3 grid(H, (S + kBQ - 1) / kBQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), S, H, G, hd,
      window, scale_l2, pre_cap, cap_l2);
  return (int)cudaGetLastError();
}

}  // namespace sm90

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).  Takes
// hd in {64, 80, 128} (the configs' head dims), H a multiple of G, window
// <= 0 for none; bf16 = 1 for bfloat16 tensors (the wgmma kernel: q, k, v
// contiguous and 16-byte aligned), 0 for float32 (the CUDA-core kernel).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int G, int hd, int window,
                                      int bf16, float softcap, float scale,
                                      void* stream) {
  if (B < 1 || S < 1 || G < 1 || H < G || H % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return bf16 ? sm90::launch<64>(q, k, v, out, B, S, H, G, hd, window,
                                     softcap, scale, s)
                  : f32::launch<64>(q, k, v, out, B, S, H, G, window,
                                    softcap, scale, s);
    case 80:
      return bf16 ? sm90::launch<128>(q, k, v, out, B, S, H, G, hd, window,
                                      softcap, scale, s)
                  : f32::launch<80>(q, k, v, out, B, S, H, G, window,
                                    softcap, scale, s);
    case 128:
      return bf16 ? sm90::launch<128>(q, k, v, out, B, S, H, G, hd, window,
                                      softcap, scale, s)
                  : f32::launch<128>(q, k, v, out, B, S, H, G, window,
                                     softcap, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
