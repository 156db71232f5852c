// Paged decode attention for NVIDIA Hopper (sm_90a), plain C interface:
// one query row per sequence, each row with its own page-table row and
// length.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_ops/paged_attention.py
// paged_attention_kernel, both of its bodies: _decode_kernel (f32 or bf16
// pools) and _decode_kernel_quant (int8 pools).  What it computes, per
// row b and head h:
//
//   out[b, h, :] = softmax_{s < seq_lens[b]}( q[b,h,:] . k[s,h,:] / sqrt(D) ) @ v[s,h,:]
//
// where position s of row b lives in page page_tables[b, s / P], slot
// s % P, of the pools k_pages / v_pages [N, P, H, D].  Rows with seq_len
// 0 write exact zeros.  q is f32 or bf16; all arithmetic is f32 and the
// scale comes from the real D.
//
// Int8 pools carry one f32 scale per (page, head), k_scales / v_scales
// [N, H].  fused_dequant = 1 (the default) scales a position's score by
// its page's K scale after the q.k dot and its p.v contribution by its
// page's V scale (the softmax denominator l stays unscaled);
// fused_dequant = 0 dequantizes each K and V element before the dots.  A
// NaN scale reaches every row that reads its page, and no other: the
// score or contribution turns NaN, and so do l and the accumulator
// (fmaxf drops a NaN from the running max, but p = exp(NaN - m) carries
// it on).
//
// Masked slots: positions at or past seq_len are never read, not even
// from a page the row's table holds.  The TPU kernel reads such a page
// whole and masks the scores; both give the same result for finite
// pools.
//
// What bounds it on an H100: bytes.  A row does 4*D flops per K/V
// position it reads (2*D*4 bytes in f32, 2*D bytes in int8), far below
// the card's flop-per-byte balance, so the floor is the K/V page stream.
// The design walks only the pages below seq_len, so a row's cost follows
// its real tokens, not the padded table width.  Rows that share a table
// row (a prefill chunk: C rows of one sequence) each read its pages
// again; those repeated reads are served from L2.
//
// Layout of the work (the TPU kernel's sequential page axis becomes a
// loop inside the block):
//   grid  = (B rows, H heads)
//   block = 4 warps.  Warp w walks the 32-position tiles w, w+4, ... of
//           the row's horizon.  Lane j owns position j of the tile for
//           the q.k score (reading its K row with 16-byte loads when the
//           row is 16-byte aligned) and output columns j, j+32, ... for
//           p.v (consecutive lanes on consecutive columns: coalesced).
//   Each warp keeps an online softmax (running max m, denominator l, f32
//   accumulator); the four warps' states merge through shared memory.
// Head dims: D <= 256, in instances of DC = 1, 2, 4 or 8 output columns a
// lane (D <= 32 DC); the query and merge arrays hold 128 columns up to
// DC 4 and 256 at DC 8 (4 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;             // positions per warp tile
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of K row (4 f32, 8 bf16 or 16 int8 values) widened to f32
__device__ __forceinline__ void widen(const int4 v, float* dst, float) {
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = f[i];
}
__device__ __forceinline__ void widen(const int4 v, float* dst,
                                      __nv_bfloat16) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen(const int4 v, float* dst, int8_t) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dst[4 * i + b] = (float)((int)((unsigned)w[i] << (24 - 8 * b)) >> 24);
}

// q_s . (k * kf) over D values: q_s is the pre-scaled query in shared
// memory, k one K row in device memory; each element is widened to f32
// and multiplied by kf (the K scale before the dot, or 1) first.  With
// ``vec`` the row is read as 16-byte vectors.
template <typename KV>
__device__ __forceinline__ float dot_row(const float* q_s,
                                         const KV* __restrict__ k, int D,
                                         float kf, int vec) {
  float s = 0.f;
  if (vec) {
    constexpr int kPer = 16 / sizeof(KV);
    const int4* k4 = reinterpret_cast<const int4*>(k);
    for (int c = 0; c < D / kPer; ++c) {
      float x[kPer];
      widen(__ldg(k4 + c), x, KV());
#pragma unroll
      for (int i = 0; i < kPer; ++i) s += q_s[c * kPer + i] * (x[i] * kf);
    }
  } else {
    for (int d = 0; d < D; ++d) s += q_s[d] * (to_f32(k[d]) * kf);
  }
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// KV is T (f32 / bf16 pools) or int8_t (pools with [N, H] scales)
template <typename T, typename KV, int DC>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ page_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int D, int P, int M, float scale, int fused,
                    int vec) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kD = DC < 8 ? 128 : kMaxD;    // the instance's widest D
  __shared__ float q_s[kD];
  __shared__ float part[kWarps][kD + 2];      // acc[0..D), m, l per warp
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)b * H + h;

  // positions past the page table (M * P) do not exist
  const int len = min(max(seq_lens[b], 0), M * P);
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    q_s[d] = to_f32(q[row * D + d]) * scale;
  __syncthreads();

  float m = kNegInf, l = 0.f, acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  const int* pt = page_tables + (size_t)b * M;
  const long long slot_stride = (long long)H * D;
  const int n_tiles = (len + kTile - 1) / kTile;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int base = t * kTile;
    const int pos = base + lane;
    const bool valid = pos < len;
    long long src = 0;
    float ksl = 1.f, vsl = 1.f;     // int8: this position's page scales
    float s = -INFINITY;
    if (valid) {
      const int page = pt[pos / P];
      src = ((long long)page * P + pos % P) * slot_stride + (long long)h * D;
      if constexpr (kQuant) {
        ksl = k_scales[(size_t)page * H + h];
        vsl = v_scales[(size_t)page * H + h];
      }
      s = dot_row(q_s, k_pages + src, D, (kQuant && !fused) ? ksl : 1.f,
                  vec);
      if (kQuant && fused) s *= ksl;   // dequant K after the dot
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    // int8: V's scale on the contribution (fused) or on each element
    const float pv = (kQuant && fused) ? p * vsl : p;
    const float vf = (kQuant && !fused) ? vsl : 1.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= alpha;
    const int jn = min(kTile, len - base);   // visible positions only
    for (int j = 0; j < jn; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pv, j);
      const float vfj = __shfl_sync(0xffffffffu, vf, j);
      const long long sj = __shfl_sync(0xffffffffu, src, j);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] += pj * (to_f32(v_pages[sj + d]) * vfj);
      }
    }
    m = m_new;
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = lane + 32 * c;
    if (d < D) part[warp][d] = acc[c];
  }
  if (lane == 0) {
    part[warp][D] = m;
    part[warp][D + 1] = l;
  }
  __syncthreads();
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, part[w][D]);
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    lsum += part[w][D + 1] * expf(part[w][D] - mx);
  // an empty row has l == 0 and acc == 0: exact zeros, as on the TPU
  const float denom = fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += part[w][d] * expf(part[w][D] - mx);
    store(out + row * D + d, o / denom);
  }
}

template <typename T, typename KV, int DC>
int launch_dc(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* pt, const void* sl, void* out,
              int B, int H, int D, int P, int M, int fused,
              cudaStream_t stream) {
  // 16-byte K row loads need every row start aligned: the row is D
  // elements and the pools' base is aligned
  const int vec = (D * (int)sizeof(KV)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const dim3 grid((unsigned)B, (unsigned)H);
  paged_decode_kernel<T, KV, DC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(sl), static_cast<T*>(out), H, D, P, M,
      1.0f / sqrtf((float)D), fused, vec);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* sl, void* out, int B,
           int H, int D, int P, int M, int fused, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || M <= 0 || D <= 0 || D > kMaxD ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dc<T, KV, 1>(q, k, v, ks, vs, pt, sl, out, B, H, D, P, M,
                               fused, s);
  if (D <= 64)
    return launch_dc<T, KV, 2>(q, k, v, ks, vs, pt, sl, out, B, H, D, P, M,
                               fused, s);
  if (D <= 128)
    return launch_dc<T, KV, 4>(q, k, v, ks, vs, pt, sl, out, B, H, D, P, M,
                               fused, s);
  return launch_dc<T, KV, 8>(q, k, v, ks, vs, pt, sl, out, B, H, D, P, M,
                             fused, s);
}

}  // namespace

// q [B, H, D], k/v pools [N, P, H, D] (same dtype as q), page_tables
// [B, M] int32, seq_lens [B] int32, out [B, H, D] (q's dtype); all
// contiguous on one device, page ids in [0, N).  Launches on ``stream``
// and returns cudaGetLastError() (0 = launched).
extern "C" int ptt_paged_attention_f32(const void* q, const void* k,
                                       const void* v, const void* pt,
                                       const void* sl, void* out, int B,
                                       int H, int D, int P, int M,
                                       void* stream) {
  return launch<float, float>(q, k, v, nullptr, nullptr, pt, sl, out, B, H,
                              D, P, M, 0, stream);
}

extern "C" int ptt_paged_attention_bf16(const void* q, const void* k,
                                        const void* v, const void* pt,
                                        const void* sl, void* out, int B,
                                        int H, int D, int P, int M,
                                        void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, pt,
                                              sl, out, B, H, D, P, M, 0,
                                              stream);
}

// The int8 body: k/v pools [N, P, H, D] int8 with k_scales / v_scales
// [N, H] f32; q and out f32 or bf16; fused_dequant 1 scales after the
// dots, 0 before.  Otherwise as above.
extern "C" int ptt_paged_attention_int8_f32(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* sl, void* out, int B, int H,
    int D, int P, int M, int fused_dequant, void* stream) {
  return launch<float, int8_t>(q, k, v, ks, vs, pt, sl, out, B, H, D, P, M,
                               fused_dequant, stream);
}

extern "C" int ptt_paged_attention_int8_bf16(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* sl, void* out, int B, int H,
    int D, int P, int M, int fused_dequant, void* stream) {
  return launch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, pt, sl, out, B, H, D,
                                       P, M, fused_dequant, stream);
}
