// flash_attention: causal attention with a blocked online softmax, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel over a (batch * kv head, q block, kv block) grid whose last axis
// carries (max, denominator, accumulator) in VMEM scratch).
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
// (q, k, v, out: 71 MB) take 0.02 ms.  Operations bound it.
//
// Design.  A simple kernel, right first: one block per (query tile of 64,
// head, batch), 256 threads.  The query tile is staged once in shared
// memory as f32; K and V tiles of 64 keys take turns in one f32 buffer
// (rows padded by one word, so threads reading neighbouring rows hit
// different banks).  Each thread owns 4 query rows (rg + 16 i) and 4 keys
// (cg + 16 j) of the 64x64 score tile, and the same 4 rows times hd / 16
// columns of the accumulator, in registers; a row's max and sum are
// shuffles over the 16 threads of its half-warp.  Only the key tiles that
// the causal mask and the window leave visible are visited, in ascending
// order (a skipped tile would contribute exactly 0).  The products run on
// the CUDA cores in f32 FMA (no tensor cores, no TMA, no pipelining):
// that is what a later PR makes fast, with wgmma on bf16 tiles.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16(x);  // round to nearest even
  }
}

// Rows of 64 positions x hd values from a [B, S, heads, hd] tensor, as f32,
// zero past the sequence's end.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int pos0, int head, int S,
                                          int heads) {
  for (int idx = threadIdx.x; idx < kBK * HD; idx += kThreads) {
    const int row = idx / HD, col = idx % HD;
    const int pos = pos0 + row;
    dst[row * (HD + 1) + col] =
        pos < S ? to_f32(src[(((size_t)b * S + pos) * heads + head) * HD + col])
                : 0.0f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int G, int window, float softcap, float scale) {
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

  load_tile<T, HD>(qs, q, b, q0, h, S, H);

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
    load_tile<T, HD>(kv, k, b, k0, g, S, G);
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
        ps[(rg + 16 * i) * (kBK + 1) + cg + 16 * j] = to_f32(from_f32<T>(p));
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
    load_tile<T, HD>(kv, v, b, k0, g, S, G);
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
    T* o = out + (((size_t)b * S + qpos) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[cg + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

constexpr size_t smem_bytes(int hd) {
  return sizeof(float) *
         ((size_t)(kBQ + kBK) * (hd + 1) + (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int G, int window, float softcap, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(HD);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, G, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int B, int S, int H, int G, int window, float softcap,
             float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, H, G, window, softcap, scale,
                           stream);
    case 80:
      return launch<T, 80>(q, k, v, out, B, S, H, G, window, softcap, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, H, G, window, softcap, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).  Takes
// hd in {64, 80, 128} (the configs' head dims), H a multiple of G, window <= 0 for none;
// bf16 = 1 for bfloat16 tensors, 0 for float32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int G, int hd, int window,
                                      int bf16, float softcap, float scale,
                                      void* stream) {
  if (B < 1 || S < 1 || G < 1 || H < G || H % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(hd, q, k, v, out, B, S, H, G, window,
                                   softcap, scale, s);
  }
  return dispatch<float>(hd, q, k, v, out, B, S, H, G, window, softcap, scale,
                         s);
}
