// Weight-only int8 matmul for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_ops/quantized_matmul.py
// quantized_matmul_kernel (body _qmm_kernel).  What it computes:
//
//   out[m, n] = ( sum_k x[m, k] * float(w_q[k, n]) ) * w_scale[n]
//
// x [M, K] f32 or bf16, w_q [K, N] int8, w_scale [N] f32, out [M, N] in
// x's dtype; the sum is f32 and the per-channel scale is applied once,
// after the K-sum, as in the TPU kernel's epilogue.  The products run as
// f32 FMAs on the CUDA cores: TF32 or bf16 tensor cores would change the
// numbers the reference pins.
//
// What bounds it on an H100: at decode (M = a few lane rows) the int8
// weight bytes (K * N, once); at a prefill chunk (M up to 512) the
// 2 * M * K * N f32 operations.  The design is a plain shared-memory
// tiled product: a BM x BN output tile per block walks K in BK chunks,
// the x chunk staged as f32 and the weight chunk widened from int8 on
// load (4 bytes per thread when rows allow), each thread keeping a
// TM x TN register tile.  Every output is summed by one thread in
// sequential K order, so a row's result does not depend on M or on the
// other rows of the launch (the serving engine and the dense decode
// oracle get bitwise equal projections).  Two tilings: 16 x 32 for
// M <= 16 (decode; 24 blocks at N = 768) and 64 x 64 otherwise.  Edges
// in M, K and N are masked, so any shape works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, T* __restrict__ out, int M,
           int K, int N, int vec4) {
  constexpr int TX = BN / TN;            // threads along N
  constexpr int TY = BM / TM;            // threads along M
  constexpr int NT = TX * TY;
  __shared__ float xs[BK][BM + 1];       // x chunk, k-major (padded)
  __shared__ float ws[BK][BN];           // weight chunk, widened to f32
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // k fastest: each row of x is read contiguously
    for (int i = tid; i < BM * BK; i += NT) {
      const int m = i / BK;
      const int k = i - m * BK;
      const int gm = m0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    if (vec4) {
      // N % 4 == 0 and a 4-byte aligned pool: 4 int8 per load
      constexpr int BN4 = BN / 4;
      for (int i = tid; i < BK * BN4; i += NT) {
        const int k = i / BN4;
        const int n = (i - k * BN4) * 4;
        const int gk = k0 + k, gn = n0 + n;
        char4 c = make_char4(0, 0, 0, 0);
        if (gk < K && gn < N)
          c = *reinterpret_cast<const char4*>(w + (size_t)gk * N + gn);
        ws[k][n] = (float)c.x;
        ws[k][n + 1] = (float)c.y;
        ws[k][n + 2] = (float)c.z;
        ws[k][n + 3] = (float)c.w;
      }
    } else {
      for (int i = tid; i < BK * BN; i += NT) {
        const int k = i / BN;
        const int n = i - k * BN;
        const int gk = k0 + k, gn = n0 + n;
        ws[k][n] = (gk < K && gn < N) ? (float)w[(size_t)gk * N + gn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the per-channel scale, once
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) store(out + (size_t)gm * N + gn, acc[i][j] * scale[gn]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch_tiled(const void* x, const void* w, const void* s, void* out,
                 int M, int K, int N, cudaStream_t stream) {
  const int vec4 =
      (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  qmm_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<T*>(out), M, K, N, vec4);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* s, void* out, int M,
           int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch_tiled<T, 16, 32, 64, 1, 2>(x, w, s, out, M, K, N, st);
  return launch_tiled<T, 64, 64, 32, 4, 4>(x, w, s, out, M, K, N, st);
}

}  // namespace

// x [M, K] (f32 or bf16), w_q [K, N] int8, w_scale [N] f32, out [M, N]
// (x's dtype); all contiguous on one device.  Launches on ``stream`` and
// returns cudaGetLastError() (0 = launched).
extern "C" int ptt_quantized_matmul_f32(const void* x, const void* w,
                                        const void* s, void* out, int M,
                                        int K, int N, void* stream) {
  return launch<float>(x, w, s, out, M, K, N, stream);
}

extern "C" int ptt_quantized_matmul_bf16(const void* x, const void* w,
                                         const void* s, void* out, int M,
                                         int K, int N, void* stream) {
  return launch<__nv_bfloat16>(x, w, s, out, M, K, N, stream);
}
