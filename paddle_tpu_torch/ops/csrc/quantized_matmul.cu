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
// The contract: one canonical summation order, a function of K alone.
// K is cut into chunks of KC = 64; a chunk's partial is summed in
// sequential k order from 0 (p = fma(x[k], w[k], p)); the partials are
// added in chunk order from 0, ((0 + p0) + p1) + ...; the total is
// multiplied by the scale.  A row's result therefore depends neither on
// M nor on the other rows of the launch, nor on the form below that
// computed it: the serving engine (whose decode rows share a launch with
// a prefill chunk, M up to 72) and the dense decode oracle (its own M)
// get bitwise equal projections.  int8 is widened to f32 exactly, by
// placing the biased byte in the mantissa of 2^23 (no conversion unit).
//
// Two forms, by M, each made for what bounds it on an H100 at GPT-2-small
// widths (K and N 768 or 3072):
//   decode (M <= 16), bound by the int8 weight bytes (K N, read once:
//       0.00019-0.00075 ms), so in practice by launch cost (an empty
//       kernel's event-timed floor is about 5 us).  Split-K over blocks:
//       one block of one warp per (chunk, 64 columns), so K 768 x N 768
//       already gives 144 blocks and the other shapes 576.  The warp
//       copies its 64 x 64 weight tile and its x rows with 16-byte
//       cp.async (every weight byte once per launch), a lane sums 2
//       columns for all M rows (a template bucket of 1-16), and the block
//       writes its f32 chunk partials to a scratch [chunks, M, N] the
//       wrapper allocates.  A second small kernel adds them in chunk
//       order and applies the scale; no atomics.  It is launched as a
//       programmatic dependent of the first, so its launch overlaps the
//       first grid and it waits for the partials on the card.
//   prefill (M > 16), bound by the 2 M K N f32 operations (0.0361 ms at
//       M 512 for fc1/fc2), but at these M the outputs are too few to give
//       every scheduler of the card a warp at 32 outputs a thread.  So K
//       is split again, over the four warps of a block: a block owns a
//       32 x 32 output tile, warp w computes chunk 4 r + w of round r with 8 x 4
//       outputs a lane, streaming its x rows and weight rows through its
//       own four-stage cp.async ring of 16 k (the weight widened to f32
//       once a stage), and at the end of each round the four chunk
//       partials meet in shared memory and join each output's total in
//       chunk order.
// Edges in M, K and N are masked (zeros in the tiles), so any shape
// works; where a row is not a whole number of 16-byte chunks (K or N) or
// a pointer is not 16-byte aligned, the tiles are loaded element by
// element instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int KC = 64;          // the canonical chunk of K
constexpr int kDecodeMaxM = 16;  // the decode form's rows

__host__ __device__ __forceinline__ int chunks_of(int K) {
  return (K + KC - 1) / KC;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// byte i of a word of int8 whose sign bits were flipped (b + 128), as the
// exact f32 value b: 2^23 + (b + 128) - (2^23 + 128)
__device__ __forceinline__ float widen(uint32_t biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | i)) -
         8388736.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// src_size 0 writes zeros (rows and columns past the weight)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// x values [k, k + 4) of one staged row as f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// rows [0, R) x columns [c0, c0 + C) of a row-major [n, ld] matrix into a
// [R][S] shared tile (row stride S elements), zeros past n_rows and
// n_cols: 16-byte cp.async where vec, element by element otherwise
template <int R, int C, int S, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           int r0, int c0, int n_rows,
                                           int n_cols, int ld, bool vec,
                                           int tid, int nt) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    for (int i = tid; i < R * (C / E); i += nt) {
      const int r = i / (C / E), c = (i % (C / E)) * E;
      const bool ok = r0 + r < n_rows && c0 + c < n_cols;
      cp_async16(dst + r * S + c,
                 ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int i = tid; i < R * C; i += nt) {
      const int r = i / C, c = i % C;
      dst[r * S + c] = (r0 + r < n_rows && c0 + c < n_cols)
                           ? src[(size_t)(r0 + r) * ld + c0 + c]
                           : T();
    }
  }
}

// ---------------------------------------------------------------------------
// decode form: grid (ceil(N / 64), chunks), one warp a block, writing its
// chunk's partials; then qmm_sum_kernel adds them in chunk order
// ---------------------------------------------------------------------------
constexpr int kWarpCols = 64;

template <typename T, int MB>
__global__ void __launch_bounds__(32)
    qmm_chunk_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     float* __restrict__ part, int M, int K, int N, int xvec,
                     int wvec) {
  constexpr int XS = KC + 16 / sizeof(T);  // padded x row
  __shared__ __align__(16) int8_t wt[KC][kWarpCols];
  __shared__ __align__(16) T xs[MB][XS];
  // the sum pass may start launching: it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int lane = threadIdx.x;
  const int c = blockIdx.y, k0 = c * KC;
  const int n0 = blockIdx.x * kWarpCols;
  stage_tile<KC, kWarpCols, kWarpCols>(&wt[0][0], w, k0, n0, K, N, N, wvec,
                                       lane, 32);
  stage_tile<MB, KC, XS>(&xs[0][0], x, 0, k0, M, K, K, xvec, lane, 32);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // the chunk's partial of columns n0 + 2 lane (+ 1), sequential in k
  float acc[MB][2];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m][0] = acc[m][1] = 0.f;
#pragma unroll 2
  for (int k4 = 0; k4 < KC; k4 += 4) {
    float4 a[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) a[m] = ld4(&xs[m][k4]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t wb =
          *reinterpret_cast<const uint16_t*>(&wt[k4 + u][2 * lane]) ^ 0x8080u;
      const float b0 = widen(wb, 0), b1 = widen(wb, 1);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        acc[m][0] = fmaf(lane4(a[m], u), b0, acc[m][0]);
        acc[m][1] = fmaf(lane4(a[m], u), b1, acc[m][1]);
      }
    }
  }
  const int n = n0 + 2 * lane;
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (m >= M) break;
    float* dst = part + ((size_t)c * M + m) * N + n;
    if (n + 1 < N && N % 2 == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(acc[m][0], acc[m][1]);
    } else {
      if (n < N) dst[0] = acc[m][0];
      if (n + 1 < N) dst[1] = acc[m][1];
    }
  }
}

// the chunk partials [chunks, M, N] added in chunk order, then the scale;
// launched as a programmatic dependent of qmm_chunk_kernel, so its launch
// overlaps that grid and it waits here until the partials are written
template <typename T>
__global__ void __launch_bounds__(256)
    qmm_sum_kernel(const float* __restrict__ part,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int M, int N, int chunks) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const size_t stride = (size_t)M * N;
  float tot = 0.f;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c) tot += part[c * stride + i];
  store(out + i, tot * scale[i % N]);
}

// ---------------------------------------------------------------------------
// prefill form: grid (ceil(N / 32), ceil(M / 32)), 4 warps a block over
// one 32 x 32 output tile.  Warp w computes chunk 4 r + w of round r (a
// lane owns rows ty + 4 i, i < 8, and columns 4 tx + j, j < 4),
// streaming it through its own ring of kSub-k stages; at the end of a
// round the four chunk partials meet in shared memory and each thread
// adds those of the outputs it owns to their totals in chunk order
// ---------------------------------------------------------------------------
constexpr int kTileWarps = 4;  // chunks a round
constexpr int kTileM = 32;     // output rows a block
constexpr int BN = 32;         // output columns a block
constexpr int kSub = 16;       // k rows a stage
constexpr int kRing = 4;       // stages a warp's ring holds

template <typename T>
struct TileCfg {
  // padded x row: 16-byte aligned, and the rows of one warp's load land
  // in distinct banks
  static constexpr int XS = kSub + 16 / sizeof(T);
  static constexpr size_t xbytes = kRing * kTileM * XS * sizeof(T);
  static constexpr size_t wbytes = kRing * kSub * BN;
  static constexpr size_t fbytes = kSub * BN * sizeof(float);
  static constexpr size_t warp_bytes = xbytes + wbytes + fbytes;
  static constexpr size_t smem =
      kTileWarps * (warp_bytes + kTileM * BN * sizeof(float));
};

template <typename T>
__global__ void __launch_bounds__(32 * kTileWarps)
    qmm_tile_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int M, int K, int N, int xvec, int wvec) {
  using C = TileCfg<T>;
  constexpr int TM = 8, XS = C::XS, NR = kRing;
  constexpr int SUBS = KC / kSub;  // stages a chunk
  constexpr int NT = 32 * kTileWarps, OWN = kTileM * BN / NT;
  static_assert(KC % kSub == 0, "tile split");
  extern __shared__ __align__(16) unsigned char qsmem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = lane % 8, ty = lane / 8;
  unsigned char* mine = qsmem + warp * C::warp_bytes;
  T* xr = reinterpret_cast<T*>(mine);                        // [NR][32][XS]
  int8_t* wr = reinterpret_cast<int8_t*>(mine + C::xbytes);  // [NR][kSub][BN]
  float* wf = reinterpret_cast<float*>(mine + C::xbytes + C::wbytes);
  float* P = reinterpret_cast<float*>(qsmem + kTileWarps * C::warp_bytes);
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * BN;
  const int rounds = (chunks_of(K) + kTileWarps - 1) / kTileWarps;
  const int stages = rounds * SUBS;  // this warp's, round after round

  // stage g of this warp: chunk kTileWarps (g / SUBS) + warp, its
  // (g % SUBS)-th kSub k rows, into ring slot g % NR; zeros past M, K, N
  auto load = [&](int g) {
    const int k = ((g / SUBS) * kTileWarps + warp) * KC + (g % SUBS) * kSub;
    stage_tile<kTileM, kSub, XS>(xr + (g % NR) * kTileM * XS, x, m0, k, M,
                                 K, K, xvec, lane, 32);
    stage_tile<kSub, BN, BN>(wr + (g % NR) * kSub * BN, w, k, n0, K, N, N,
                             wvec, lane, 32);
  };
#pragma unroll
  for (int g = 0; g < NR - 1; ++g) {  // one commit group a stage
    if (g < stages) load(g);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  float part[TM][4], tot[OWN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
  for (int q = 0; q < OWN; ++q) tot[q] = 0.f;

  for (int g = 0; g < stages; ++g) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NR - 2) : "memory");
    __syncwarp();  // stage g landed; stage g - 1 and wf are read
    if (g + NR - 1 < stages) load(g + NR - 1);  // into stage g - 1's slot
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // the stage's weight widened to f32 once, for all the warp's reads
    const int8_t* ws = wr + (g % NR) * kSub * BN;
#pragma unroll
    for (int c = lane; c < kSub * BN / 4; c += 32) {
      const uint32_t b =
          reinterpret_cast<const uint32_t*>(ws)[c] ^ 0x80808080u;
      reinterpret_cast<float4*>(wf)[c] =
          make_float4(widen(b, 0), widen(b, 1), widen(b, 2), widen(b, 3));
    }
    __syncwarp();
    const T* xs = xr + (g % NR) * kTileM * XS;
#pragma unroll
    for (int k4 = 0; k4 < kSub; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ld4(xs + (ty + 4 * i) * XS + k4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 b =
            *reinterpret_cast<const float4*>(wf + (k4 + u) * BN + 4 * tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = lane4(a[i], u);
          part[i][0] = fmaf(av, b.x, part[i][0]);
          part[i][1] = fmaf(av, b.y, part[i][1]);
          part[i][2] = fmaf(av, b.z, part[i][2]);
          part[i][3] = fmaf(av, b.w, part[i][3]);
        }
      }
    }
    if (g % SUBS == SUBS - 1) {
      // the round's chunks are done: the four partials join the totals
      // in chunk order
      float* mp = P + warp * kTileM * BN;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        *reinterpret_cast<float4*>(mp + (ty + 4 * i) * BN + 4 * tx) =
            make_float4(part[i][0], part[i][1], part[i][2], part[i][3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < OWN; ++q)
#pragma unroll
        for (int v = 0; v < kTileWarps; ++v)
          tot[q] += P[v * kTileM * BN + tid + q * NT];
      __syncthreads();
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // epilogue: the per-channel scale, once
#pragma unroll
  for (int q = 0; q < OWN; ++q) {
    const int o = tid + q * NT;
    const int m = m0 + o / BN, n = n0 + o % BN;
    if (m < M && n < N) store(out + (size_t)m * N + n, tot[q] * scale[n]);
  }
}

template <typename T, int MB>
int launch_decode(const T* x, const int8_t* w, const float* s, float* part,
                  T* out, int M, int K, int N, cudaStream_t st) {
  const int xvec = K % (16 / (int)sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int wvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((unsigned)((N + kWarpCols - 1) / kWarpCols),
                  (unsigned)chunks_of(K));
  qmm_chunk_kernel<T, MB><<<grid, 32, 0, st>>>(x, w, part, M, K, N, xvec,
                                               wvec);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  // the sum pass, allowed to launch while the partials are still computed
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((long long)M * N + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cpart = part;
  const int chunks = chunks_of(K);
  rc = (int)cudaLaunchKernelEx(&cfg, qmm_sum_kernel<T>, cpart, s, out, M, N,
                               chunks);
  return rc ? rc : (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const T* x, const int8_t* w, const float* s, T* out, int M,
                int K, int N, cudaStream_t st) {
  using C = TileCfg<T>;
  const int xvec = K % (16 / (int)sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int wvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kern = qmm_tile_kernel<T>;
  const int rc = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (rc) return rc;
  const dim3 grid((unsigned)((N + BN - 1) / BN),
                  (unsigned)((M + kTileM - 1) / kTileM));
  kern<<<grid, 32 * kTileWarps, C::smem, st>>>(x, w, s, out, M, K, N, xvec,
                                               wvec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, const void* wv, const void* sv, void* partv,
           void* outv, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + kTileM - 1) / kTileM > 65535 ||
      chunks_of(K) > 65535 || (long long)M * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  const int8_t* w = static_cast<const int8_t*>(wv);
  const float* s = static_cast<const float*>(sv);
  float* part = static_cast<float*>(partv);
  T* out = static_cast<T*>(outv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= kDecodeMaxM) {
    if (part == nullptr) return (int)cudaErrorInvalidValue;
#define PTT_QMM_DECODE(MB) \
  launch_decode<T, MB>(x, w, s, part, out, M, K, N, st)
    if (M == 1) return PTT_QMM_DECODE(1);
    if (M == 2) return PTT_QMM_DECODE(2);
    if (M <= 4) return PTT_QMM_DECODE(4);
    if (M <= 8) return PTT_QMM_DECODE(8);
    return PTT_QMM_DECODE(16);
#undef PTT_QMM_DECODE
  }
  return launch_tile<T>(x, w, s, out, M, K, N, st);
}

}  // namespace

// x [M, K] (f32 or bf16), w_q [K, N] int8, w_scale [N] f32, out [M, N]
// (x's dtype), all contiguous on one device; part: an f32 scratch of
// [ceil(K / KC), M, N] for M <= 16 (the decode form), unused (may be
// null) otherwise.  Launches on ``stream`` and returns the first launch
// error (0 = launched).
extern "C" int ptt_quantized_matmul_f32(const void* x, const void* w,
                                        const void* s, void* part,
                                        void* out, int M, int K, int N,
                                        void* stream) {
  return launch<float>(x, w, s, part, out, M, K, N, stream);
}

extern "C" int ptt_quantized_matmul_bf16(const void* x, const void* w,
                                         const void* s, void* part,
                                         void* out, int M, int K, int N,
                                         void* stream) {
  return launch<__nv_bfloat16>(x, w, s, part, out, M, K, N, stream);
}

// the contract's constants, checked by the wrapper when it binds
extern "C" int ptt_quantized_matmul_chunk() { return KC; }
extern "C" int ptt_quantized_matmul_decode_max_m() { return kDecodeMaxM; }
