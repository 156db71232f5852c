// Elementwise out = x * scale[0] + shift[0] for paddle_tpu_torch.
//
// Replaces the worked Pallas example of the custom-op API,
// tests/test_custom_op.py:_pallas_scale_shift (its inline `kernel`,
// launched by pl.pallas_call at :102, and again by its VJP for dx).
//
// Bound: bytes.  Each element is read once and written once and takes
// two flops, far below the card's ~20 flops per byte of f32 balance, so
// the kernel can only approach 2 * numel * itemsize / 3.35 TB/s.  The
// design does the one thing that matters for that: a grid-stride loop
// of 16-byte vector loads and stores (4 f32 or 8 bf16/f16 per thread
// per trip) when both pointers are 16-byte aligned, a scalar loop for
// the tail or for an unaligned view, and a grid of a few blocks per SM
// so enough loads are in flight.
//
// Scale and shift are read from device memory by every thread (one
// cached load each): the host never reads them, so a call needs no
// host sync.  Arithmetic is f32 as __fadd_rn(__fmul_rn(x, s), b) — no
// FMA contraction — so the product and the sum are each rounded, as in
// the plain PyTorch version (x.float() * s + b, then one cast), and the
// result is rounded once to x's dtype.  Kernel and plain version agree
// bit for bit.
//
// Plain C interface (ctypes); returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct F32 {
  using Bits = uint32_t;
  static __device__ __forceinline__ float load(Bits b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ Bits store(float f) {
    return __float_as_uint(f);
  }
};

struct BF16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float load(Bits b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ Bits store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float load(Bits b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ Bits store(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
};

template <typename T>
__device__ __forceinline__ typename T::Bits apply(typename T::Bits v,
                                                  float s, float b) {
  return T::store(__fadd_rn(__fmul_rn(T::load(v), s), b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_shift_kernel(const typename T::Bits* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   typename T::Bits* __restrict__ out, int64_t n,
                   int vec_ok) {
  using Bits = typename T::Bits;
  constexpr int V = 16 / sizeof(Bits);
  union Vec {
    uint4 u;
    Bits e[V];
  };
  const float s = __ldg(scale);
  const float b = __ldg(shift);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = vec_ok ? n / V : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (int64_t i = tid; i < nvec; i += stride) {
    Vec v;
    v.u = xv[i];
#pragma unroll
    for (int k = 0; k < V; ++k) v.e[k] = apply<T>(v.e[k], s, b);
    ov[i] = v.u;
  }
  for (int64_t i = nvec * V + tid; i < n; i += stride) {
    out[i] = apply<T>(x[i], s, b);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* shift, void* out,
           long long n, int vec_ok, void* stream) {
  using Bits = typename T::Bits;
  constexpr int V = 16 / sizeof(Bits);
  const long long work = vec_ok ? (n / V > 0 ? n / V : 1) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  scale_shift_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Bits*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<Bits*>(out),
      (int64_t)n, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ptt_scale_shift_f32(const void* x, const void* scale, const void* shift,
                        void* out, long long n, int vec_ok, void* stream) {
  return launch<F32>(x, scale, shift, out, n, vec_ok, stream);
}

int ptt_scale_shift_bf16(const void* x, const void* scale, const void* shift,
                         void* out, long long n, int vec_ok, void* stream) {
  return launch<BF16>(x, scale, shift, out, n, vec_ok, stream);
}

int ptt_scale_shift_f16(const void* x, const void* scale, const void* shift,
                        void* out, long long n, int vec_ok, void* stream) {
  return launch<F16>(x, scale, shift, out, n, vec_ok, stream);
}

}  // extern "C"
