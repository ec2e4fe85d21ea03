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
// Q = 128) 32 GFLOP, 33 us at 989 TFLOP/s; the bytes (x and y in bf16,
// B, C, dt, the state: 113 MB) take 34 us at 3.35 TB/s.  Both bound it
// about equally.
//
// Design.  A simple kernel, right first: one block of 256 threads per
// (head, batch); the chunks run in a loop inside the block, with the
// [N, P] state in shared memory in f32 for the whole sequence.  Shared
// memory is what limits it: at N = 128, P = 64, Q = 128 the state (32 KB),
// x (32 KB) and the masked [Q, Q] matrix (66 KB) stay resident, and B and
// C are staged in sub-tiles of 32 state columns (17 KB each), which feed
// C B^T, C S and the state update in turn.  167 KB in all, above the
// default 48 KB, so the launcher opts in; a chunk that does not fit is
// refused.  Each thread owns rows ti + 16 a and columns tj + 16 b of the
// [Q, Q] and [Q, P] tiles in registers.  The intra-chunk decay is masked
// inside the exponent (for i < j, cum_i - cum_j > 0 and exp overflows).
// Only B * H blocks run (96 at mamba2-130m's width on 132 SMs), and the
// products run on the CUDA cores in f32 FMA: splitting the chunks over
// blocks and wgmma are later work.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kMaxQ = 128;     // a thread owns 8 rows of a chunk
constexpr int kNT = 32;        // state columns (N) per B/C sub-tile

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

__host__ __device__ constexpr int round16(int q) { return (q + 15) / 16 * 16; }

// Floats of shared memory: state [N][P], x [Qa][P], C and B sub-tiles
// [Qa][kNT + 1], the masked matrix [Qa][Qa + 1], and four [Qa] vectors.
__host__ __device__ constexpr size_t smem_floats(int q, int n, int p) {
  return (size_t)n * p + (size_t)round16(q) * p +
         2 * (size_t)round16(q) * (kNT + 1) +
         (size_t)round16(q) * (round16(q) + 1) + 4 * (size_t)round16(q);
}

template <typename T, int PC>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dv,
                T* __restrict__ y, float* __restrict__ state_out, int S, int H,
                int P, int G, int N, int Q) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int Qa = round16(Q);
  const int na = Qa / 16;  // rows (and [Q, Q] columns) per thread
  const int ti = threadIdx.x >> 4;
  const int tj = threadIdx.x & 15;
  const float a_h = a[h];
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
  float* sdec = ecum + Qa;             // [Qa] exp(cum_last - cum) * dt

  for (int idx = threadIdx.x; idx < N * P; idx += kThreads) st[idx] = 0.0f;

  const int chunks = (S + Q - 1) / Q;
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * Q;
    __syncthreads();  // the previous chunk is done with xs, wsm, the vectors

    // dt and x of the chunk, zero past the chunk and past the sequence.
    for (int j = threadIdx.x; j < Qa; j += kThreads) {
      const int pos = t0 + j;
      dts[j] = (j < Q && pos < S) ? dt[((size_t)b * S + pos) * H + h] : 0.0f;
    }
    for (int idx = threadIdx.x; idx < Qa * P; idx += kThreads) {
      const int j = idx / P, p = idx % P;
      const int pos = t0 + j;
      xs[idx] = (j < Q && pos < S)
                    ? to_f32(x[(((size_t)b * S + pos) * H + h) * P + p])
                    : 0.0f;
    }
    __syncthreads();

    // Inclusive cumsum of dt * a: warp 0, four positions per thread, then a
    // shuffle scan of the threads' sums.
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
    const float total = cum[Qa - 1];
    for (int j = threadIdx.x; j < Qa; j += kThreads) {
      ecum[j] = expf(cum[j]);
      sdec[j] = expf(total - cum[j]) * dts[j];
    }
    const float etotal = expf(total);

    float w[8][8], ya[8][PC];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int s = 0; s < 8; ++s) w[r][s] = 0.0f;
#pragma unroll
      for (int c = 0; c < PC; ++c) ya[r][c] = 0.0f;
    }

    for (int n0 = 0; n0 < N; n0 += kNT) {
      __syncthreads();  // the previous sub-tile's state update is done
      for (int idx = threadIdx.x; idx < Qa * kNT; idx += kThreads) {
        const int j = idx / kNT, n = idx % kNT;
        const int pos = t0 + j;
        float cv = 0.0f, bv = 0.0f;
        if (j < Q && pos < S && n0 + n < N) {
          const size_t off = (((size_t)b * S + pos) * G + g) * N + n0 + n;
          cv = to_f32(cm[off]);
          bv = to_f32(bm[off]);
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
        for (int c = 0; c < PC; ++c) {
          const int p = tj + 16 * c;
          sv[c] = p < P ? st[(n0 + n) * P + p] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int s = 0; s < 8; ++s) w[r][s] = fmaf(cv[r], bv[s], w[r][s]);
#pragma unroll
          for (int c = 0; c < PC; ++c) ya[r][c] = fmaf(cv[r], sv[c], ya[r][c]);
        }
      }
      __syncthreads();  // every thread has read these state rows

      // State rows n0 .. n0 + nt: decay and add sum_j B_j sdec_j x_j^T.
#pragma unroll
      for (int e = 0; e < kNT / 16; ++e) {
        const int n = ti + 16 * e;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int p = tj + 16 * c;
          if (n >= nt || p >= P) continue;
          float upd = 0.0f;
          for (int j = 0; j < Qa; ++j) {
            upd = fmaf(bs[j * (kNT + 1) + n] * sdec[j], xs[j * P + p], upd);
          }
          float* sp = st + (n0 + n) * P + p;
          *sp = *sp * etotal + upd;
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
      for (int c = 0; c < PC; ++c) ya[r][c] *= ecum[i];
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
      for (int c = 0; c < PC; ++c) {
        const int p = tj + 16 * c;
        xv[c] = p < P ? xs[j * P + p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < PC; ++c) ya[r][c] = fmaf(wv[r], xv[c], ya[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ti + 16 * r;
      const int pos = t0 + i;
      if (r >= na || i >= Q || pos >= S) continue;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int p = tj + 16 * c;
        if (p >= P) continue;
        y[(((size_t)b * S + pos) * H + h) * P + p] =
            from_f32<T>(ya[r][c] + xs[i * P + p] * d_h);
      }
    }
  }

  __syncthreads();
  float* so = state_out + ((size_t)b * H + h) * N * P;
  for (int idx = threadIdx.x; idx < N * P; idx += kThreads) so[idx] = st[idx];
}

template <typename T, int PC>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* d, void* y, void* state, int B, int S,
           int H, int P, int G, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(Q, N, P) * sizeof(float);
  auto kernel = ssd_scan_kernel<T, PC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    // Over the card's opt-in limit: clear the error so that the next
    // launch does not report it, and refuse.
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(d),
      static_cast<T*>(y), static_cast<float*>(state), S, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

// The head widths of the configs: P = 32 (smoke) and P = 64.
template <typename T>
int dispatch(const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, const void* d, void* y, void* state, int B,
             int S, int H, int P, int G, int N, int Q, cudaStream_t stream) {
  if (P <= 32) {
    return launch<T, 2>(x, dt, a, bm, cm, d, y, state, B, S, H, P, G, N, Q,
                        stream);
  }
  return launch<T, 4>(x, dt, a, bm, cm, d, y, state, B, S, H, P, G, N, Q,
                      stream);
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).  Takes
// 1 <= chunk <= 128, 1 <= P <= 64, N >= 1, H a multiple of G; bf16 = 1 for
// bfloat16 x, b and c, 0 for float32.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* d,
                               void* y, void* state, int B, int S, int H,
                               int P, int G, int N, int chunk, int bf16,
                               void* stream) {
  if (B < 1 || S < 1 || G < 1 || H < G || H % G != 0 || P < 1 || P > 64 ||
      N < 1 || chunk < 1 || chunk > kMaxQ) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(x, dt, a, b, c, d, y, state, B, S, H, P, G,
                                   N, chunk, s);
  }
  return dispatch<float>(x, dt, a, b, c, d, y, state, B, S, H, P, G, N, chunk,
                         s);
}
