// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a), plain
// C interface.
//
// Replaces the three Pallas kernels of
// paddle_tpu/ops/pallas_ops/flash_attention.py:
//   ptt_flash_fwd_*  <- _flash_fwd_bhsd (body _fwd_kernel)
//   ptt_flash_dkv_*  <- _flash_dkv_bhsd (body _bwd_dkv_kernel)
//   ptt_flash_dq_*   <- _flash_dq_bhsd  (body _bwd_dq_kernel)
//
// What they compute, on q [BH, Sq, D], k and v [BH, Sk, D] (f32, bf16 or
// fp16,
// row-major), a kv validity mask [B, Sk] f32 (b = bh / H) and a seed
// (a launch argument, or a uint32 the kernels read from device memory
// when seed_ptr is not null, so a captured graph's replays each take the
// value written there before them):
//   s = (scale * q) k^T, masked to the finite sentinel -1e30 where the
//       key is invalid or (causal) row < col on global positions;
//   forward: online softmax over key tiles, o = (sum p' v) / max(l, 1e-30)
//       and lse = m + log(max(l, 1e-30)), where p' is p times keep / (1-p)
//       under dropout and l keeps the full mass;
//   dK/dV and dQ: p = exp(s - lse) from the saved lse, dp = dO v^T,
//       dV = p'^T dO, dS = p * (dp' - delta) with dp' dropped by the same
//       bits, dK = dS^T (scale * q), dQ = scale * dS k.
// The dropout bits are the uint32 hash of (seed, bh, global row, global
// col) of the JAX package's _keep_mask, so every kernel regenerates the
// forward's bits whatever its tiling.  o, dq, dk and dv are written in the
// input dtype, lse in f32.  A key past Sk scores -inf, exactly 0 after
// exp, so it never enters any sum.  Blocks are independent and run in no
// order; the backward keeps the JAX package's split into two kernels, so
// it needs no atomics and its gradients are the same from run to run.
//
// What bounds them on an H100: at the training shape (B 8, H 12, S 1024,
// D 64, causal) the score tiles never leave the chip, so each kernel moves
// only its inputs and outputs once and does 4 S^2 D (causal: half) per
// product pair.  That is bound by operations in f32: f32-accurate
// products run at 165 TFLOP/s as 3xTF32 on the tensor cores (495 TFLOP/s
// of TF32, three products for one), 67 on the CUDA cores (0.0781 ms
// forward, 0.117 ms dK/dV, 0.0781 ms dQ at 165).  In bf16 the 989 TFLOP/s
// of the tensor cores make the bytes the bound (0.0152 ms forward,
// 0.0228 ms dK/dV, 0.0190 ms dQ).
//
// Two designs.
//
// f32 (all three bodies, namespace f32tc): the bf16 bodies' design below
// on the tensor cores in 3xTF32, the arithmetic of CUTLASS's FastF32 that
// PyTorch's memory-efficient attention uses for f32.  mma.sync m16n8k8
// takes TF32 (10 mantissa bits); each f32 operand is split where its
// fragment is formed into big = x rounded to TF32 and the residual
// small = x - big, and small * big, big * small and big * big go into one
// f32 accumulator: about 2^-21 of a product, where one TF32 product keeps
// 2^-11 (tests/test_torch_flash_f32tc_numerics.py).  Tiles are not split
// in shared memory, which would double the bytes staged.  What the design
// does about f32's costs:
//   - operands straight from the accumulators: the C fragment gives a
//     thread columns (2 t, 2 t + 1), the A fragment wants k (t, t + 4), so
//     the k of every product is read through that permutation, and P'
//     (forward), P'^T, dS^T (dK/dV) and dS (dQ) become A fragments in
//     registers, unrounded, without shuffles; their B operands (V, dO and
//     Q, K) read rows 2 t, 2 t + 1;
//   - the tensor cores round each mma's f32 sum toward zero, a drift of
//     half an ulp of the running sum a step that a sum over 1024 keys or
//     queries (3 mma a chunk of 8) would pile up: each tile's chunks go
//     into a partial sum from zero, added to the running sum by f32
//     operations (S and dP: every 64 columns of d; the forward's O as
//     O alpha + partial, the online softmax's rescale folded in);
//   - f32 tiles are twice the bf16 bytes and there is no 32-bit
//     transposed ldmatrix: tiles of 32 keys (forward, dQ) or query rows
//     (dK/dV), 16 at D 256, a 2-stage cp.async ring, 64 output columns a
//     dK/dV block (grid.y = DT / 64: dK, dV and their partial sums in
//     registers) and 128 a forward or dQ block from D 128 on (each such
//     forward block computes S again; the first writes lse); at D 64 two
//     blocks fit an SM;
//   - rows of DT + 8 floats, rows 4-7 of every 8 swapped in pairs, so both
//     ways a tile is read (64-bit along a row, 32-bit down a column) are
//     free of bank conflicts at a per-thread offset plus a constant;
//   - the longest causal tiles first, branch-free hot loops (an interior
//     tile is not masked element by element), scale on the S accumulators
//     or in the epilogue, and the outputs stored straight from the
//     accumulators.
// The forward is dQ's body with V in K's place as the B operand of the
// second product and no dP: a warp owns 16 query rows; K, V and the mask
// tile come through the ring; S = Q K^T (Q's split fragments held in
// registers at D 64, read from its tile otherwise) is scaled on the
// accumulators, as the bf16 forward does, so that Q is split once where
// it stays in registers and a tile of it is staged unchanged otherwise
// (an f32 rounding of the score from the plain version's (scale q) k^T,
// far below 3xTF32's 2^-21); the online softmax runs on the accumulators,
// a row on the four lanes of a quad, with __expf.
//
// bf16 (all three bodies, namespace tc): FA2's design on the tensor
// cores, mma.sync m16n8k16 (bf16 in, f32 accumulators), chosen over
// wgmma + TMA because it needs no tensor maps, no warp specialisation and
// no shared-memory matrix descriptors, and its register-resident A
// operand is what keeps P and dS out of shared memory.  One block of 4
// warps.
//   forward: one block per (bh, tile of BQ query rows), looping over the
//       key tiles it can see; the last query tiles, which see the most
//       keys under causal masking, are scheduled first.  A warp owns 16
//       rows, or 32 at D 64 without dropout, where the registers hold two
//       16-row slices that share every K and V fragment (254 registers, no
//       spill).  K, V and the mask tile arrive through a ring of three
//       stages of cp.async copies: the tile two ahead is in flight while
//       this one computes, and one barrier a tile both publishes a landed
//       tile and frees the stage the next copy overwrites.  S = Q K^T on
//       the tensor cores from unscaled bf16 q (Q's fragments held in
//       registers up to D 128), times scale in f32 (exact for D 64; an
//       f32 ulp from (scale q) k^T otherwise).  Only a tile that reaches
//       past Sk or the diagonal, or whose kv mask has a zero, is masked
//       element by element.  The online softmax runs on the accumulators,
//       a row spread over the four lanes of a quad; P', rounded to bf16,
//       goes from the S accumulators straight into the A fragments of
//       P'V, never to shared memory; V's B fragments come by
//       ldmatrix.trans.
//   dK/dV: one block per (bh, 64 keys), looping over the query tiles that
//       see them (the first key tiles first); Q, dO, lse and delta arrive
//       through the same three-stage ring.  Each warp computes the
//       transposed products S^T = K Q^T and dP^T = V dO^T for its 16 keys,
//       so P'^T and dS^T, formed in f32 and rounded to bf16, are already
//       the A operands of dV += P'^T dO and dK += dS^T Q; dO and Q serve
//       as B by ldmatrix.trans.  dK takes scale in the epilogue.  From
//       D 128 on, a block owns 128 output columns (grid.y = DT / 128) to
//       bound the accumulators' registers.
//   dQ: the forward's schedule and ring with dK/dV's products turned to
//       own query rows: one block per (bh, 64 query rows), the last query
//       tiles first, a warp owning 16 rows; K, V and the mask tile through
//       the three-stage ring.  Q's and dO's fragments stay in registers
//       (up to D 128) as the A operands of S = Q K^T and dP = dO V^T;
//       dS = P (dP' - delta) is formed in f32 on the two accumulators and
//       rounded to bf16 in registers as the A fragment of dQ += dS K, K
//       serving as B by ldmatrix.trans, so dS never goes to shared
//       memory.  64-key tiles at D 64, 32 from D 128 on (the S and dP
//       accumulators' registers); from D 128 on, 128 output columns a
//       block as in dK/dV.  Scale in the epilogue.
// The hot loops have no branch: columns past D are zeros in the tiles and
// add nothing, dropout is a template parameter.  Tiles sit in shared
// memory with their 16-byte chunks XOR-swizzled by the row, so ldmatrix
// reads them without bank conflicts; each thread copies fixed chunks of
// fixed rows, its offsets computed once.  Where a bf16 row is not a
// multiple of 16 bytes (D not a multiple of 8) or a pointer is not
// 16-byte aligned, the tiles are loaded element by element and
// zero-padded instead of by cp.async.  Outputs leave through the warp's
// own rows of a shared tile in 16-byte stores.  P and dS are rounded to
// bf16 because the tensor cores take bf16 operands; the rounding (8
// mantissa bits, as the outputs already have) stays inside the card
// tests' bf16 tolerance, tests/test_torch_flash_tc_numerics.py shows it
// on the CPU.
//
// fp16 (the same three bodies): the tc kernels are templates on their
// 16-bit element type T, so fp16 runs the bf16 design line for line with
// mma.sync m16n8k16 ...f32.f16.f16.f32 (f32 accumulators), P' and dS
// packed by __floats2half2_rn, the same tiles, ring and ldmatrix.  fp16
// keeps 11 significant bits to bf16's 8 but only 5 exponent bits: a P'
// (at most 1 / (1 - p)) always fits, a dS or an output past 65504 rounds
// to inf.  Under loss scaling that inf is the overflow a GradScaler
// detects: it skips the step and lowers the scale.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX package's finite NEG_INF

struct Params {
  int H, Sq, Sk, D;
  float scale;
  int causal, dropout;
  float keep_scale;  // 1 / (1 - dropout_p)
  uint32_t thresh;   // keep where hash >= thresh
  uint32_t seed;
  const uint32_t* seed_ptr;  // when not null, the seed is *seed_ptr
};

// paddle_tpu/ops/pallas_ops/flash_attention.py:_keep_mask, bit for bit
__device__ __forceinline__ bool keep_bit(const Params& p, uint32_t bh,
                                         uint32_t row, uint32_t col) {
  const uint32_t seed = p.seed_ptr ? __ldg(p.seed_ptr) : p.seed;
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x = x + seed * 0xC2B2AE3Du;
  x = x ^ (bh * 0x27D4EB2Fu);
  x = x ^ (x >> 15);
  x = x * 0x2C1B3C6Du;
  x = x ^ (x >> 12);
  x = x * 0x297A2D39u;
  x = x ^ (x >> 15);
  return x >= p.thresh;
}

// ---------------------------------------------------------------------------
// bf16 and fp16 forward, dK/dV and dQ on the tensor cores (mma.sync
// m16n8k16), templates on the element type T
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
using bf16 = __nv_bfloat16;
using f16 = __half;
// every tile element is 16 bits, bf16 or fp16
constexpr size_t kElt = 2;
static_assert(sizeof(bf16) == kElt && sizeof(f16) == kElt, "16-bit");

// element offset of (row r, column c) in a [rows][DT] 16-bit tile whose
// 16-byte chunks are XOR-swizzled by the row's low three bits: the eight
// rows one ldmatrix phase reads land in eight different bank groups
template <int DT>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DT + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// async copies; src_size 0 writes zeros (rows and columns past the data)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}

// c (16x8 f32) += a (16x16 T, row) * b (16x8 T, col), T bf16 or fp16
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, f16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same<T, bf16>::value, "bf16 or fp16");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two f32 rounded to T (to nearest even) in one register, the lower
// column in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<T, f16>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// a 16-bit zero of type T
template <typename T>
__device__ __forceinline__ T zero() {
  if constexpr (std::is_same<T, f16>::value) {
    return __float2half(0.f);
  } else {
    return __float2bfloat16(0.f);
  }
}

// rows [r0, r0 + R) of a row-major [n, D] T matrix into a swizzled
// [R][DT] tile, rows past n and columns past D zero.  vec (D a multiple of
// 8, every pointer 16-byte aligned): one 16-byte cp.async per chunk;
// otherwise element by element, synchronously
template <int R, int DT, typename T>
__device__ __forceinline__ void load_tile(T* dst,
                                          const T* __restrict__ src,
                                          int r0, int n, int D, bool vec) {
  if (vec) {
    // thread i copies chunk i % CH of rows i / CH + RP u
    constexpr int CH = DT / 8, RP = kThreads / CH;
    static_assert(kThreads % CH == 0 && R % RP == 0, "tile split");
    const int c = (threadIdx.x % CH) * 8, rr = threadIdx.x / CH;
    const T* g = src + (size_t)(r0 + rr) * D + c;
#pragma unroll
    for (int u = 0; u < R / RP; ++u) {
      const int r = rr + u * RP;
      const bool ok = r0 + r < n && c < D;
      cp_async16(dst + swz<DT>(r, c), ok ? g + (size_t)u * RP * D : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * DT; i += kThreads) {
      const int r = i / DT, c = i % DT;
      dst[swz<DT>(r, c)] = (r0 + r < n && c < D)
                               ? src[(size_t)(r0 + r) * D + c]
                               : zero<T>();
    }
  }
}

// entries [i0, i0 + N) of an f32 vector of length n (zeros past it)
template <int N>
__device__ __forceinline__ void load_vec(float* dst,
                                         const float* __restrict__ src,
                                         int i0, int n) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool ok = i0 + i < n;
    cp_async4(dst + i, ok ? src + i0 + i : src, ok);
  }
}

// a warp's 16 staged rows [tr0, tr0 + 16), columns [c0, c0 + W), to rows
// [gr0, gr0 + 16) of a row-major [n, D] matrix (rows past n and columns
// past D are not written)
template <int DT, int W, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const T* tile, int tr0,
                                           int gr0, int n, int D, int c0,
                                           bool vec) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    constexpr int CH = W / 8;
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = c0 + (i % CH) * 8;
      if (gr0 + r < n && c < D)
        *reinterpret_cast<uint4*>(dst + (size_t)(gr0 + r) * D + c) =
            *reinterpret_cast<const uint4*>(tile + swz<DT>(tr0 + r, c));
    }
  } else {
    for (int i = lane; i < 16 * W; i += 32) {
      const int r = i / W, c = c0 + i % W;
      if (gr0 + r < n && c < D)
        dst[(size_t)(gr0 + r) * D + c] = tile[swz<DT>(tr0 + r, c)];
    }
  }
}

// row g of a fragment pair in the low two values, row g + 8 in the high
template <typename T>
__device__ __forceinline__ void stage2(T* tile, int off0, int off1,
                                       const float (&c)[4], float mul0,
                                       float mul1) {
  *reinterpret_cast<uint32_t*>(tile + off0) =
      pack<T>(c[0] * mul0, c[1] * mul0);
  *reinterpret_cast<uint32_t*>(tile + off1) =
      pack<T>(c[2] * mul1, c[3] * mul1);
}

// ---------------------------------------------------------------------------
// forward: grid BH * ceil(Sq / BQ); warp w owns query rows 16 MT w ..
// 16 MT (w + 1) - 1, MT slices of 16 rows that share each K and V fragment
// ---------------------------------------------------------------------------
template <int DT, bool kDrop>
struct FwdCfg {
  // 16-row slices a warp: two where the registers hold them without a
  // spill (D 64 without dropout: 254 of 255)
  static constexpr int MT = DT == 64 && !kDrop ? 2 : 1;
  static constexpr int BQ = 16 * MT * kWarps;
  static constexpr int BK = DT == 256 ? 32 : 64;
  static constexpr int kStages = 3;         // the K/V ring
  static constexpr bool kQReg = DT <= 128;  // Q's fragments in registers
  static constexpr size_t smem =
      kElt * (BQ * DT + 2 * kStages * BK * DT) +
      sizeof(float) * kStages * BK;
};

template <typename T, int DT, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ mask,
                  T* __restrict__ o, float* __restrict__ lse, Params p,
                  int vec) {
  using C = FwdCfg<DT, kDrop>;
  constexpr int MT = C::MT, BQ = C::BQ, BK = C::BK, NS = C::kStages;
  constexpr int NT = BK / 8, KD = DT / 16, ND = DT / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  T* Qs = reinterpret_cast<T*>(tc_smem);  // [BQ][DT]
  T* Ks = Qs + BQ * DT;                        // [NS][BK][DT]
  T* Vs = Ks + NS * BK * DT;                   // [NS][BK][DT]
  float* Ms = reinterpret_cast<float*>(Vs + NS * BK * DT);  // [NS][BK]
  // the last query tiles (under causal masking the longest) first
  const int nqt = (p.Sq + BQ - 1) / BQ, BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH;
  const int q0 = (nqt - 1 - (int)blockIdx.x / BH) * BQ;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16 * MT;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = q + (size_t)bh * p.Sq * p.D;
  const T* kb = k + (size_t)bh * p.Sk * p.D;
  const T* vb = v + (size_t)bh * p.Sk * p.D;
  const float* mb = mask + (size_t)(bh / p.H) * p.Sk;
  int nkt = (p.Sk + BK - 1) / BK;
  if (p.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);  // k0 <= last row

  // key tile i goes to stage i % NS: K, V and its mask slice
  auto load_kv = [&](int i) {
    const int st = i % NS;
    load_tile<BK, DT>(Ks + st * BK * DT, kb, i * BK, p.Sk, p.D, vec);
    load_tile<BK, DT>(Vs + st * BK * DT, vb, i * BK, p.Sk, p.D, vec);
    load_vec<BK>(Ms + st * BK, mb, i * BK, p.Sk);
  };
  load_tile<BQ, DT>(Qs, qb, q0, p.Sq, p.D, vec);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // one commit group per tile
    if (i < nkt) load_kv(i);
    cp_commit();
  }

  // per slice mt: running max m and partial sum l of rows (g, g + 8)
  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  uint32_t qf[MT][C::kQReg ? KD : 1][4];

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % NS;
    cp_wait<NS - 2>();  // this tile (and Q) have landed ...
    __syncthreads();    // ... for every thread, and tile kt - 1 is done
    // tile kt + NS - 1 streams into the stage tile kt - 1 used while the
    // tiles before it compute
    if (kt + NS - 1 < nkt) load_kv(kt + NS - 1);
    cp_commit();
    const T* Kt = Ks + st * BK * DT;
    const T* Vt = Vs + st * BK * DT;
    const float* Mt = Ms + st * BK;
    const int k0 = kt * BK;
    if constexpr (C::kQReg) {
      if (kt == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            ldsm(qf[mt][kk], Qs + swz<DT>(wr + mt * 16 + (lane & 15),
                                          kk * 16 + (lane >> 4) * 8));
      }
    }

    // S = Q K^T, f32 accumulators: s[mt][j] holds rows (g, g + 8) of
    // slice mt and key columns (8 j + 2 t, + 1).  The hot loops have no
    // branch (columns past D are zeros), so loads and products overlap
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (C::kQReg) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kk][e];
        } else {
          ldsm(a[mt], Qs + swz<DT>(wr + mt * 16 + (lane & 15),
                                   kk * 16 + (lane >> 4) * 8));
        }
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm(b, Kt + swz<DT>(j * 8 + (lane & 7) + (lane >> 4) * 8,
                             kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma<T>(s[mt][j], a[mt], b[0], b[1]);
          mma<T>(s[mt][j + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // scale in f32, then the reference's masks on global positions: only
    // a tile that reaches past Sk or the diagonal, or whose kv mask has a
    // zero, is masked element by element
    bool valid = true;
#pragma unroll
    for (int c = lane; c < BK; c += 32) valid = valid && Mt[c] > 0.f;
    const bool edge = !__all_sync(0xffffffffu, valid) || k0 + BK > p.Sk ||
                      (p.causal && k0 + BK - 1 > q0 + wr);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] *= p.scale;
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 mk =
            *reinterpret_cast<const float2*>(Mt + j * 8 + 2 * t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            const int row = q0 + wr + mt * 16 + g + (e >> 1) * 8;
            if (col >= p.Sk)
              s[mt][j][e] = -INFINITY;  // past the keys: 0 after exp
            else if (!(((e & 1) ? mk.y : mk.x) > 0.f) ||
                     (p.causal && row < col))
              s[mt][j][e] = kNegInf;
          }
      }
    }

    // online softmax; a row's values live in the four lanes of a quad.
    // P' (dropped, rounded to T) goes from the S accumulators straight
    // into the A fragments of P'V: keys 16 kk .. 16 kk + 15 are s[2 kk],
    // s[2 kk + 1]
    uint32_t pf[MT][NT / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r]);
        alpha[r] = __expf(m[mt][r] - m_new);
        m[mt][r] = m_new;
        l[mt][r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[mt][n][0] *= alpha[0];
        acc[mt][n][1] *= alpha[0];
        acc[mt][n][2] *= alpha[1];
        acc[mt][n][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = __expf(s[mt][j][e] - m[mt][e >> 1]);
          l[mt][e >> 1] += pr;  // the denominator keeps the full mass
          pe[e] = pr;
          if constexpr (kDrop) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            const int row = q0 + wr + mt * 16 + g + (e >> 1) * 8;
            pe[e] = keep_bit(p, bh, row, col) ? pr * p.keep_scale : 0.f;
          }
        }
        pf[mt][j >> 1][(j & 1) * 2] = pack<T>(pe[0], pe[1]);
        pf[mt][j >> 1][(j & 1) * 2 + 1] = pack<T>(pe[2], pe[3]);
      }
    }
    // O += P' V; V's fragments by ldmatrix.trans from its [key][d] tile
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b[4];
        ldsm_t(b, Vt + swz<DT>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                               n * 8 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma<T>(acc[mt][n], pf[mt][kk], b[0], b[1]);
          mma<T>(acc[mt][n + 1], pf[mt][kk], b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // o through the warp's own rows of the Q tile, out in 16-byte rows
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float l_safe = fmaxf(lr, 1e-30f);
      inv[r] = 1.f / l_safe;
      const int row = q0 + wr + mt * 16 + g + r * 8;
      if (t == 0 && row < p.Sq)
        lse[(size_t)bh * p.Sq + row] = m[mt][r] + logf(l_safe);
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t, r = wr + mt * 16 + g;
      stage2(Qs, swz<DT>(r, c), swz<DT>(r + 8, c), acc[mt][n], inv[0],
             inv[1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<DT, DT>(o + (size_t)bh * p.Sq * p.D, Qs, wr + mt * 16,
                       q0 + wr + mt * 16, p.Sq, p.D, 0, vec);
}

// ---------------------------------------------------------------------------
// dK/dV: grid (BH * ceil(Sk / 64), DT / DO); warp w owns keys 16 w ..
// 16 w + 15 and computes the transposed scores S^T = K Q^T, so that P'^T
// and dS^T are already the A operands of dV += P'^T dO and dK += dS^T Q
// ---------------------------------------------------------------------------
template <int DT>
struct DkvCfg {
  static constexpr int BK = 16 * kWarps;
  static constexpr int BQ = DT == 64 ? 64 : 32;
  static constexpr int DO = DT < 128 ? DT : 128;  // output columns a block
  static constexpr int kStages = 3;  // the Q, dO, lse, delta ring
  static constexpr size_t smem =
      kElt * (2 * BK * DT + 2 * kStages * BQ * DT) +
      sizeof(float) * (BK + 2 * kStages * BQ);
};

template <typename T, int DT, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ mask, T* __restrict__ dk,
                  T* __restrict__ dv, Params p, int vec) {
  using C = DkvCfg<DT>;
  constexpr int BK = C::BK, BQ = C::BQ, DO = C::DO, NS = C::kStages;
  constexpr int NQ = BQ / 8, KD = DT / 16, NO = DO / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  T* Ks = reinterpret_cast<T*>(tc_smem);  // [BK][DT]
  T* Vs = Ks + BK * DT;                        // [BK][DT]
  T* Qs = Vs + BK * DT;                        // [NS][BQ][DT]
  T* Os = Qs + NS * BQ * DT;                   // [NS][BQ][DT], dO
  float* Ms = reinterpret_cast<float*>(Os + NS * BQ * DT);  // [BK]
  float* Ls = Ms + BK;                                      // [NS][BQ]
  float* Dl = Ls + NS * BQ;                                 // [NS][BQ]
  // the first key tiles (under causal masking the longest) first
  const int nkt = (p.Sk + BK - 1) / BK, BH = gridDim.x / nkt;
  const int bh = blockIdx.x % BH;
  const int k0 = ((int)blockIdx.x / BH) * BK;
  const int d0 = blockIdx.y * DO;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = q + (size_t)bh * p.Sq * p.D;
  const T* ob = dout + (size_t)bh * p.Sq * p.D;
  const float* lb = lse + (size_t)bh * p.Sq;
  const float* db = delta + (size_t)bh * p.Sq;
  const size_t koff = (size_t)bh * p.Sk * p.D;
  const float* mb = mask + (size_t)(bh / p.H) * p.Sk;
  const int nqt = (p.Sq + BQ - 1) / BQ;
  // causal: a query tile whose last row is above this block's first key
  // sees none of it
  const int qt0 = p.causal ? k0 / BQ : 0;

  // the i-th query tile this block visits goes to stage i % NS
  auto load_q = [&](int i) {
    const int st = i % NS, r0 = (qt0 + i) * BQ;
    load_tile<BQ, DT>(Qs + st * BQ * DT, qb, r0, p.Sq, p.D, vec);
    load_tile<BQ, DT>(Os + st * BQ * DT, ob, r0, p.Sq, p.D, vec);
    load_vec<BQ>(Ls + st * BQ, lb, r0, p.Sq);
    load_vec<BQ>(Dl + st * BQ, db, r0, p.Sq);
  };
  const int nvis = nqt - qt0;  // query tiles that see these keys
  load_tile<BK, DT>(Ks, k + koff, k0, p.Sk, p.D, vec);
  load_tile<BK, DT>(Vs, v + koff, k0, p.Sk, p.D, vec);
  load_vec<BK>(Ms, mb, k0, p.Sk);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // one commit group per tile
    if (i < nvis) load_q(i);
    cp_commit();
  }

  float adk[NO][4], adv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int i = 0; i < nvis; ++i) {
    const int st = i % NS;
    cp_wait<NS - 2>();  // this tile (and K, V) have landed ...
    __syncthreads();    // ... for every thread, and tile i - 1 is done
    if (i + NS - 1 < nvis) load_q(i + NS - 1);  // into tile i - 1's stage
    cp_commit();
    const T* Qt = Qs + st * BQ * DT;
    const T* Ot = Os + st * BQ * DT;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Dl + st * BQ;
    const int q0 = (qt0 + i) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: s[j] holds keys (g, g + 8) and query
    // columns (8 j + 2 t, + 1)
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int aoff = swz<DT>(wr + (lane & 15), kk * 16 + (lane >> 4) * 8);
      uint32_t ak[4], av[4];
      ldsm(ak, Ks + aoff);
      ldsm(av, Vs + aoff);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        const int boff = swz<DT>(j * 8 + (lane & 7) + (lane >> 4) * 8,
                                 kk * 16 + ((lane >> 3) & 1) * 8);
        uint32_t bq[4], bo[4];
        ldsm(bq, Qt + boff);
        ldsm(bo, Ot + boff);
        mma<T>(s[j], ak, bq[0], bq[1]);
        mma<T>(s[j + 1], ak, bq[2], bq[3]);
        mma<T>(dp[j], av, bo[0], bo[1]);
        mma<T>(dp[j + 1], av, bo[2], bo[3]);
      }
    }

    // P = exp(S scale - lse) and dS = P (dP' - delta) in f32; P' and dS
    // rounded to T straight into the A fragments of the next products
    const float mk[2] = {Ms[wr + g], Ms[wr + g + 8]};
    uint32_t pa[NQ / 2][4], da[NQ / 2][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(Lt + j * 8 + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(Dt + j * 8 + 2 * t);
      float pv[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + wr + g + (e >> 1) * 8;
        const int row = q0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * p.scale;
        if ((p.causal && row < key) || !(mk[e >> 1] > 0.f)) x = kNegInf;
        // rows past Sq and keys past Sk (zero tiles) enter no sum
        const float pr = (row < p.Sq && key < p.Sk)
                             ? __expf(x - ((e & 1) ? lv.y : lv.x))
                             : 0.f;
        float dpn = dp[j][e];
        pv[e] = pr;
        if constexpr (kDrop) {
          const bool keep = keep_bit(p, bh, row, key);
          pv[e] = keep ? pr * p.keep_scale : 0.f;
          dpn = keep ? dpn * p.keep_scale : 0.f;
        }
        ds[e] = pr * (dpn - ((e & 1) ? dl.y : dl.x));
      }
      pa[j >> 1][(j & 1) * 2] = pack<T>(pv[0], pv[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack<T>(pv[2], pv[3]);
      da[j >> 1][(j & 1) * 2] = pack<T>(ds[0], ds[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack<T>(ds[2], ds[3]);
    }

    // dV += P'^T dO and dK += dS^T Q over this block's columns; dO's and
    // Q's fragments by ldmatrix.trans from their [query][d] tiles
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        const int boff = swz<DT>(kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 d0 + n * 8 + (lane >> 4) * 8);
        uint32_t bo[4], bq[4];
        ldsm_t(bo, Ot + boff);
        ldsm_t(bq, Qt + boff);
        mma<T>(adv[n], pa[kq], bo[0], bo[1]);
        mma<T>(adv[n + 1], pa[kq], bo[2], bo[3]);
        mma<T>(adk[n], da[kq], bq[0], bq[1]);
        mma<T>(adk[n + 1], da[kq], bq[2], bq[3]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // K and V have landed even where no query tile ran

  // dK = scale dS^T q and dV through the warp's own rows of the K and V
  // tiles, out in 16-byte rows
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = d0 + n * 8 + 2 * t;
    const int off0 = swz<DT>(wr + g, c), off1 = swz<DT>(wr + g + 8, c);
    stage2(Ks, off0, off1, adk[n], p.scale, p.scale);
    stage2(Vs, off0, off1, adv[n], 1.f, 1.f);
  }
  __syncwarp();
  store_rows<DT, DO>(dk + koff, Ks, wr, k0 + wr, p.Sk, p.D, d0, vec);
  store_rows<DT, DO>(dv + koff, Vs, wr, k0 + wr, p.Sk, p.D, d0, vec);
}

// ---------------------------------------------------------------------------
// dQ: grid (BH * ceil(Sq / 64), DT / DO); warp w owns query rows 16 w ..
// 16 w + 15.  S = Q K^T and dP = dO V^T take Q's and dO's fragments as A,
// so dS, formed on their accumulators, is already the A operand of
// dQ += dS K
// ---------------------------------------------------------------------------
template <int DT>
struct DqCfg {
  static constexpr int BQ = 16 * kWarps;
  static constexpr int BK = DT == 64 ? 64 : 32;  // s and dp's registers
  static constexpr int DO = DT < 128 ? DT : 128;  // output columns a block
  static constexpr int kStages = 3;               // the K, V, mask ring
  static constexpr bool kQReg = DT <= 128;  // Q, dO fragments in registers
  static constexpr size_t smem =
      kElt * (2 * BQ * DT + 2 * kStages * BK * DT) +
      sizeof(float) * kStages * BK;
};

template <typename T, int DT, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ mask, T* __restrict__ dq,
                 Params p, int vec) {
  using C = DqCfg<DT>;
  constexpr int BQ = C::BQ, BK = C::BK, DO = C::DO, NS = C::kStages;
  constexpr int NT = BK / 8, KD = DT / 16, NO = DO / 8;
  constexpr int KR = C::kQReg ? KD : 1;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  T* Qs = reinterpret_cast<T*>(tc_smem);  // [BQ][DT]
  T* Os = Qs + BQ * DT;                        // [BQ][DT], dO
  T* Ks = Os + BQ * DT;                        // [NS][BK][DT]
  T* Vs = Ks + NS * BK * DT;                   // [NS][BK][DT]
  float* Ms = reinterpret_cast<float*>(Vs + NS * BK * DT);  // [NS][BK]
  // the last query tiles (under causal masking the longest) first
  const int nqt = (p.Sq + BQ - 1) / BQ, BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH;
  const int q0 = (nqt - 1 - (int)blockIdx.x / BH) * BQ;
  const int d0 = blockIdx.y * DO;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * p.Sq * p.D;
  const T* kb = k + (size_t)bh * p.Sk * p.D;
  const T* vb = v + (size_t)bh * p.Sk * p.D;
  const float* mb = mask + (size_t)(bh / p.H) * p.Sk;
  int nkt = (p.Sk + BK - 1) / BK;
  if (p.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);  // k0 <= last row

  // key tile i goes to stage i % NS: K, V and its mask slice
  auto load_kv = [&](int i) {
    const int st = i % NS;
    load_tile<BK, DT>(Ks + st * BK * DT, kb, i * BK, p.Sk, p.D, vec);
    load_tile<BK, DT>(Vs + st * BK * DT, vb, i * BK, p.Sk, p.D, vec);
    load_vec<BK>(Ms + st * BK, mb, i * BK, p.Sk);
  };
  load_tile<BQ, DT>(Qs, q + qoff, q0, p.Sq, p.D, vec);
  load_tile<BQ, DT>(Os, dout + qoff, q0, p.Sq, p.D, vec);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // one commit group per tile
    if (i < nkt) load_kv(i);
    cp_commit();
  }

  // lse and delta of rows (g, g + 8); rows past Sq are never stored
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    lr[r] = row < p.Sq ? lse[(size_t)bh * p.Sq + row] : 0.f;
    dl[r] = row < p.Sq ? delta[(size_t)bh * p.Sq + row] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KR][4], of[KR][4];

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % NS;
    cp_wait<NS - 2>();  // this tile (and Q, dO) have landed ...
    __syncthreads();    // ... for every thread, and tile kt - 1 is done
    if (kt + NS - 1 < nkt) load_kv(kt + NS - 1);  // into tile kt - 1's stage
    cp_commit();
    const T* Kt = Ks + st * BK * DT;
    const T* Vt = Vs + st * BK * DT;
    const float* Mt = Ms + st * BK;
    const int k0 = kt * BK;
    if constexpr (C::kQReg) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int aoff =
              swz<DT>(wr + (lane & 15), kk * 16 + (lane >> 4) * 8);
          ldsm(qf[kk], Qs + aoff);
          ldsm(of[kk], Os + aoff);
        }
      }
    }

    // S = Q K^T and dP = dO V^T: s[j], dp[j] hold rows (g, g + 8) and key
    // columns (8 j + 2 t, + 1)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ao[4];
      if constexpr (C::kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[e] = qf[kk][e];
          ao[e] = of[kk][e];
        }
      } else {
        const int aoff = swz<DT>(wr + (lane & 15), kk * 16 + (lane >> 4) * 8);
        ldsm(aq, Qs + aoff);
        ldsm(ao, Os + aoff);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int boff = swz<DT>(j * 8 + (lane & 7) + (lane >> 4) * 8,
                                 kk * 16 + ((lane >> 3) & 1) * 8);
        uint32_t bk[4], bv[4];
        ldsm(bk, Kt + boff);
        ldsm(bv, Vt + boff);
        mma<T>(s[j], aq, bk[0], bk[1]);
        mma<T>(s[j + 1], aq, bk[2], bk[3]);
        mma<T>(dp[j], ao, bv[0], bv[1]);
        mma<T>(dp[j + 1], ao, bv[2], bv[3]);
      }
    }

    // scale in f32, then the reference's masks on global positions: only
    // a tile that reaches past Sk or the diagonal, or whose kv mask has a
    // zero, is masked element by element
    bool valid = true;
#pragma unroll
    for (int c = lane; c < BK; c += 32) valid = valid && Mt[c] > 0.f;
    const bool edge = !__all_sync(0xffffffffu, valid) || k0 + BK > p.Sk ||
                      (p.causal && k0 + BK - 1 > q0 + wr);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 mk =
            *reinterpret_cast<const float2*>(Mt + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = q0 + wr + g + (e >> 1) * 8;
          if (col >= p.Sk)
            s[j][e] = -INFINITY;  // past the keys: P exactly 0
          else if (!(((e & 1) ? mk.y : mk.x) > 0.f) ||
                   (p.causal && row < col))
            s[j][e] = kNegInf;
        }
      }
    }

    // P = exp(S scale - lse) and dS = P (dP' - delta) in f32, rounded to
    // T straight into the A fragments of dS K: keys 16 kk .. 16 kk + 15
    // are s[2 kk], s[2 kk + 1]
    uint32_t da[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = __expf(s[j][e] - lr[e >> 1]);
        float dpn = dp[j][e];
        if constexpr (kDrop) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = q0 + wr + g + (e >> 1) * 8;
          dpn = keep_bit(p, bh, row, col) ? dpn * p.keep_scale : 0.f;
        }
        ds[e] = pr * (dpn - dl[e >> 1]);
      }
      da[j >> 1][(j & 1) * 2] = pack<T>(ds[0], ds[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack<T>(ds[2], ds[3]);
    }

    // dQ += dS K over this block's columns; K's fragments by
    // ldmatrix.trans from its [key][d] tile
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldsm_t(b, Kt + swz<DT>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                               d0 + n * 8 + (lane >> 4) * 8));
        mma<T>(acc[n], da[kk], b[0], b[1]);
        mma<T>(acc[n + 1], da[kk], b[2], b[3]);
      }
    }
  }
  cp_wait<0>();

  // dQ = scale dS K through the warp's own rows of the Q tile, out in
  // 16-byte rows
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = d0 + n * 8 + 2 * t;
    stage2(Qs, swz<DT>(wr + g, c), swz<DT>(wr + g + 8, c), acc[n], p.scale,
           p.scale);
  }
  __syncwarp();
  store_rows<DT, DO>(dq + qoff, Qs, wr, q0 + wr, p.Sq, p.D, d0, vec);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 forward, dK/dV and dQ on the tensor cores in 3xTF32 (mma.sync
// m16n8k8 tf32)
// ---------------------------------------------------------------------------
namespace f32tc {

using tc::cp_async16;
using tc::cp_commit;
using tc::cp_wait;
using tc::kThreads;
using tc::kWarps;
using tc::load_vec;

// An f32 tile of DT columns keeps rows of DT + 8 floats, and row r at row
// srow(r): rows 4 and 5, and 6 and 7, of every 8 trade places.  The
// fragment reads of a warp are then free of bank conflicts both ways a
// tile is read: 64-bit reads of rows 8 j + g at columns 8 kk + 2 t (an
// operand whose k runs along the row; the half-warp's rows g = 0-3 or 4-7
// start 8 banks apart) and 32-bit reads of rows 8 kk + 2 t (+ 1) at
// columns 8 n + g (k down the column; rows 0, 2, 4, 6 and 1, 3, 5, 7 start
// 8 banks apart).  Both read at a per-thread offset plus a constant, so
// the unrolled loops spend no instruction on addresses.
template <int DT>
constexpr int kStride = DT + 8;
__device__ __forceinline__ int srow(int r) { return r ^ ((r >> 2) & 1); }

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x = big + small: big is x rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds, on the bit pattern);
// small = x - big is exact in f32, and the tensor core reads its top 11
// significant bits, so big + small carries about 22 of x's 24
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
template <int N>
__device__ __forceinline__ void split(const float (&x)[N],
                                      uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
}

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: small * big, big * small, then big * big into the
// same f32 accumulator (the small terms first, as CUTLASS's FastF32 does);
// the small * small term, 2^-22 relative, is dropped
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(c, as, bb[0], bb[1]);
  mma(c, ab, bs[0], bs[1]);
  mma(c, ab, bb[0], bb[1]);
}

// The k index of every product is read through one permutation inside
// each chunk of 8: logical k = t <-> actual 2 t, t + 4 <-> 2 t + 1.  The
// A fragment wants (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
// and the B fragment (k t, col g), (t + 4, g), so
// - an operand whose k runs along a tile's row comes in 64-bit reads of
//   columns (2 t, 2 t + 1);
// - an A operand formed on an accumulator (C holds (g, 2 t), (g, 2 t + 1),
//   (g + 8, 2 t), (g + 8, 2 t + 1)) is {c0, c2, c1, c3}, no shuffle;
// - its B operand reads rows 2 t and 2 t + 1 of the chunk.
// Each thread's offsets: fr = srow(g) * SD + 2 t for the first kind (row
// 8 j + g, column 8 kk + 2 t at fr + 8 j SD + 8 kk), fc[h] = srow(2 t + h)
// * SD + g for the B operands of the second (row 8 j + 2 t + h, column
// c0 + 8 n + g at fc[h] + 8 j SD + c0 + 8 n)

// the A fragment of rows (8 i + g, + 8) of a tile, k along the row, split
template <int DT>
__device__ __forceinline__ void load_a(const float* p, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float2 lo = lds2(p), hi = lds2(p + 8 * kStride<DT>);
  const float a[4] = {lo.x, hi.x, lo.y, hi.y};
  split(a, big, small);
}

// the B fragment of tile row 8 j + g (n), k along the row, split
__device__ __forceinline__ void load_b_row(const float* p, uint32_t (&big)[2],
                                           uint32_t (&small)[2]) {
  const float2 b = lds2(p);
  const float x[2] = {b.x, b.y};
  split(x, big, small);
}

// the B fragment of tile rows 8 j + 2 t, + 1 (k) at one column (n), split
__device__ __forceinline__ void load_b_col(const float* p, const int (&fc)[2],
                                           uint32_t (&big)[2],
                                           uint32_t (&small)[2]) {
  const float x[2] = {p[fc[0]], p[fc[1]]};
  split(x, big, small);
}

// an accumulator as the A fragment of the next product (k = its columns)
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split(a, big, small);
}

// rows [r0, r0 + R) of a row-major [n, D] f32 matrix into a [R][DT] tile
// (rows at srow, stride DT + 8), rows past n and columns past D zero.  vec
// (D a multiple of 4, every pointer 16-byte aligned): one 16-byte cp.async
// per chunk of 4; otherwise element by element, synchronously
template <int R, int DT>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int n, int D, bool vec) {
  constexpr int SD = kStride<DT>;
  if (vec) {
    // thread i copies chunk i % CH of rows i / CH + RP u
    constexpr int CH = DT / 4, RP = kThreads / CH;
    static_assert(kThreads % CH == 0 && R % RP == 0, "tile split");
    const int c = (threadIdx.x % CH) * 4, rr = threadIdx.x / CH;
    const float* g = src + (size_t)(r0 + rr) * D + c;
#pragma unroll
    for (int u = 0; u < R / RP; ++u) {
      const int r = rr + u * RP;
      const bool ok = r0 + r < n && c < D;
      cp_async16(dst + srow(r) * SD + c, ok ? g + (size_t)u * RP * D : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * DT; i += kThreads) {
      const int r = i / DT, c = i % DT;
      dst[srow(r) * SD + c] =
          (r0 + r < n && c < D) ? src[(size_t)(r0 + r) * D + c] : 0.f;
    }
  }
}

// a warp's accumulators for rows (row0 + g, + 8) and columns c0 + 8 n +
// 2 t (+ 1), times mul, to a row-major [n, D] f32 matrix (rows past n and
// columns past D are not written)
template <int NO>
__device__ __forceinline__ void store_acc(float* __restrict__ dst,
                                          const float (&acc)[NO][4],
                                          int row0, int n, int D, int c0,
                                          float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    float* out = dst + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      if (c < D) out[c] = acc[j][2 * r] * mul;
      if (c + 1 < D) out[c + 1] = acc[j][2 * r + 1] * mul;
    }
  }
}

// The tensor cores round each mma's f32 sum toward zero, so a long chain
// of mma into one accumulator drifts toward zero by about half an f32 ulp
// of the running sum per step.  The bodies therefore sum each tile's
// chunks (at most 8 chunks of k) into a partial accumulator that starts
// at zero and add it to the running sum in an f32 add, which rounds to
// nearest: the truncations then act on partial sums, not on the total.

// total += part (the first part is the total), part for the next chunks
template <int NJ>
__device__ __forceinline__ void fold(float (&total)[NJ][4],
                                     const float (&part)[NJ][4], bool first) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      total[j][e] = first ? part[j][e] : total[j][e] + part[j][e];
}
template <int NJ>
__device__ __forceinline__ void zero(float (&a)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// ---------------------------------------------------------------------------
// forward: grid (BH * ceil(Sq / 64), DT / DO); warp w owns query rows 16 w ..
// 16 w + 15.  S = Q K^T takes Q's fragments as A, so P', formed on its
// accumulators by the online softmax, is already the A operand of
// O += P' V
// ---------------------------------------------------------------------------
template <int DT>
struct FwdCfg {
  static constexpr int BQ = 16 * kWarps;
  // key tile: the K/V ring and the S accumulators' registers
  static constexpr int BK = DT < 256 ? 32 : 16;
  static constexpr int DO = DT < 128 ? DT : 128;  // output columns a block
  static constexpr int kStages = 2;               // the K, V, mask ring
  // Q's split fragments in registers (64 of them at D 64), formed once
  static constexpr bool kQReg = DT == 64;
  static constexpr int kMinBlocks = DT == 64 ? 2 : 1;  // an SM at D 64
  static constexpr size_t smem =
      sizeof(float) *
      ((BQ + 2 * kStages * BK) * kStride<DT> + kStages * BK);
};

template <int DT, bool kDrop>
__global__ void __launch_bounds__(kThreads, FwdCfg<DT>::kMinBlocks)
    fwd_f32tc_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ o,
                     float* __restrict__ lse, Params p, int vec) {
  using C = FwdCfg<DT>;
  constexpr int BQ = C::BQ, BK = C::BK, DO = C::DO, NS = C::kStages;
  constexpr int NT = BK / 8, KD = DT / 8, NO = DO / 8, SD = kStride<DT>;
  constexpr int KR = C::kQReg ? KD : 1;
  extern __shared__ __align__(128) unsigned char f32_smem[];
  float* Qs = reinterpret_cast<float*>(f32_smem);  // [BQ][SD]
  float* Ks = Qs + BQ * SD;                          // [NS][BK][SD]
  float* Vs = Ks + NS * BK * SD;                     // [NS][BK][SD]
  float* Ms = Vs + NS * BK * SD;                     // [NS][BK]
  // the last query tiles (under causal masking the longest) first
  const int nqt = (p.Sq + BQ - 1) / BQ, BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH;
  const int q0 = (nqt - 1 - (int)blockIdx.x / BH) * BQ;
  const int d0 = blockIdx.y * DO;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int fr = srow(g) * SD + 2 * t;
  const int fc[2] = {srow(2 * t) * SD + g + d0,
                     srow(2 * t + 1) * SD + g + d0};
  const size_t qoff = (size_t)bh * p.Sq * p.D;
  const float* kb = k + (size_t)bh * p.Sk * p.D;
  const float* vb = v + (size_t)bh * p.Sk * p.D;
  const float* mb = mask + (size_t)(bh / p.H) * p.Sk;
  int nkt = (p.Sk + BK - 1) / BK;
  if (p.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);  // k0 <= last row

  // key tile i goes to stage i % NS: K, V and its mask slice
  auto load_kv = [&](int i) {
    const int st = i % NS;
    load_tile<BK, DT>(Ks + st * BK * SD, kb, i * BK, p.Sk, p.D, vec);
    load_tile<BK, DT>(Vs + st * BK * SD, vb, i * BK, p.Sk, p.D, vec);
    load_vec<BK>(Ms + st * BK, mb, i * BK, p.Sk);
  };
  load_tile<BQ, DT>(Qs, q + qoff, q0, p.Sq, p.D, vec);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // one commit group per tile
    if (i < nkt) load_kv(i);
    cp_commit();
  }

  // rows (g, g + 8): the running max m and this thread's part of the
  // denominator l (the full mass: dropout leaves it alone)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NO][4];
  zero(acc);
  uint32_t qbg[KR][4], qsm[KR][4];

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % NS;
    cp_wait<NS - 2>();  // this tile (and Q) have landed ...
    __syncthreads();    // ... for every thread, and tile kt - 1 is done
    if (kt + NS - 1 < nkt) load_kv(kt + NS - 1);  // into tile kt - 1's stage
    cp_commit();
    const float* Kt = Ks + st * BK * SD;
    const float* Vt = Vs + st * BK * SD;
    const float* Mt = Ms + st * BK;
    const int k0 = kt * BK;
    if constexpr (C::kQReg) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          load_a<DT>(Qs + fr + wr * SD + 8 * kk, qbg[kk], qsm[kk]);
      }
    }

    // S = Q K^T: s[j] holds rows (g, g + 8) and key columns (8 j + 2 t,
    // + 1); 64 columns of d a partial sum
    float s[NT][4];
#pragma unroll
    for (int kg = 0; kg < KD; kg += 8) {
      float ps[NT][4];
      zero(ps);
#pragma unroll
      for (int kk = kg; kk < kg + 8; ++kk) {
        uint32_t aqb[4], aqs[4];
        if constexpr (C::kQReg) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            aqb[e] = qbg[kk][e];
            aqs[e] = qsm[kk][e];
          }
        } else {
          load_a<DT>(Qs + fr + wr * SD + 8 * kk, aqb, aqs);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t kbg[2], ksm[2];
          load_b_row(Kt + fr + 8 * j * SD + 8 * kk, kbg, ksm);
          mma3(ps[j], aqb, aqs, kbg, ksm);
        }
      }
      fold(s, ps, kg == 0);
    }

    // scale in f32, then the reference's masks on global positions: only
    // a tile that reaches past Sk or the diagonal, or whose kv mask has a
    // zero, is masked element by element
    bool valid = true;
#pragma unroll
    for (int c = lane; c < BK; c += 32) valid = valid && Mt[c] > 0.f;
    const bool edge = !__all_sync(0xffffffffu, valid) || k0 + BK > p.Sk ||
                      (p.causal && k0 + BK - 1 > q0 + wr);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 mk = lds2(Mt + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = q0 + wr + g + (e >> 1) * 8;
          if (col >= p.Sk)
            s[j][e] = -INFINITY;  // past the keys: exactly 0 after exp
          else if (!(((e & 1) ? mk.y : mk.x) > 0.f) ||
                   (p.causal && row < col))
            s[j][e] = kNegInf;
        }
      }
    }

    // online softmax on the accumulators, a row on the four lanes of a
    // quad; s becomes P' in place (dropped where a bit says so, the
    // denominator keeping the full mass)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = __expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += pr;
        float pv = pr;
        if constexpr (kDrop) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = q0 + wr + g + (e >> 1) * 8;
          pv = keep_bit(p, bh, row, col) ? pr * p.keep_scale : 0.f;
        }
        s[j][e] = pv;
      }

    // O = O alpha + P' V over this block's columns, the tile's partial sum
    // from zero first: the 8 keys of s[j] are one k chunk; V's B fragments
    // are rows 8 j + 2 t, + 1 of its tile
    float pacc[NO][4];
    zero(pacc);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t pbg[4], psm[4];
      acc_as_a(s[j], pbg, psm);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t vbg[2], vsm[2];
        load_b_col(Vt + 8 * j * SD + 8 * n, fc, vbg, vsm);
        mma3(pacc[n], pbg, psm, vbg, vsm);
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = acc[n][e] * alpha[e >> 1] + pacc[n][e];
  }
  cp_wait<0>();

  // o = O / max(l, 1e-30) straight from the accumulators; lse = m +
  // log(max(l, 1e-30)) over the quad's sum, from the first column block
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float l_safe = fmaxf(lr, 1e-30f);
    inv[r] = 1.f / l_safe;
    const int row = q0 + wr + g + r * 8;
    if (blockIdx.y == 0 && t == 0 && row < p.Sq)
      lse[(size_t)bh * p.Sq + row] = m[r] + logf(l_safe);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv[e >> 1];
  store_acc<NO>(o + qoff, acc, q0 + wr, p.Sq, p.D, d0, 1.f);
}

// ---------------------------------------------------------------------------
// dK/dV: grid (BH * ceil(Sk / 64), DT / 64); warp w owns keys 16 w ..
// 16 w + 15 and computes S^T = K Q^T and dP^T = V dO^T, so that P'^T and
// dS^T are already the A operands of dV += P'^T dO and dK += dS^T Q
// ---------------------------------------------------------------------------
template <int DT>
struct DkvCfg {
  static constexpr int BK = 16 * kWarps;
  // query tile: the Q/dO ring and the S^T, dP^T accumulators' registers
  static constexpr int BQ = DT < 256 ? 32 : 16;
  // output columns a block: dK and dV, each with its partial sum, hold
  // 4 DO / 8 registers a thread
  static constexpr int DO = 64;
  static constexpr int kStages = 2;  // the Q, dO, lse, delta ring
  static constexpr int kMinBlocks = DT == 64 ? 2 : 1;  // an SM at D 64
  static constexpr size_t smem =
      sizeof(float) * ((2 * BK + 2 * kStages * BQ) * kStride<DT> + BK +
                       2 * kStages * BQ);
};

template <int DT, bool kDrop>
__global__ void __launch_bounds__(kThreads, DkvCfg<DT>::kMinBlocks)
    dkv_f32tc_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask, float* __restrict__ dk,
                     float* __restrict__ dv, Params p, int vec) {
  using C = DkvCfg<DT>;
  constexpr int BK = C::BK, BQ = C::BQ, DO = C::DO, NS = C::kStages;
  constexpr int NQ = BQ / 8, KD = DT / 8, NO = DO / 8, SD = kStride<DT>;
  extern __shared__ __align__(128) unsigned char f32_smem[];
  float* Ks = reinterpret_cast<float*>(f32_smem);  // [BK][SD]
  float* Vs = Ks + BK * SD;                          // [BK][SD]
  float* Qs = Vs + BK * SD;                          // [NS][BQ][SD]
  float* Os = Qs + NS * BQ * SD;                     // [NS][BQ][SD], dO
  float* Ms = Os + NS * BQ * SD;                     // [BK]
  float* Ls = Ms + BK;                               // [NS][BQ]
  float* Dl = Ls + NS * BQ;                          // [NS][BQ]
  // the first key tiles (under causal masking the longest) first
  const int nkt = (p.Sk + BK - 1) / BK, BH = gridDim.x / nkt;
  const int bh = blockIdx.x % BH;
  const int k0 = ((int)blockIdx.x / BH) * BK;
  const int d0 = blockIdx.y * DO;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int fr = srow(g) * SD + 2 * t;
  const int fc[2] = {srow(2 * t) * SD + g + d0,
                     srow(2 * t + 1) * SD + g + d0};
  const float* qb = q + (size_t)bh * p.Sq * p.D;
  const float* ob = dout + (size_t)bh * p.Sq * p.D;
  const float* lb = lse + (size_t)bh * p.Sq;
  const float* db = delta + (size_t)bh * p.Sq;
  const size_t koff = (size_t)bh * p.Sk * p.D;
  const float* mb = mask + (size_t)(bh / p.H) * p.Sk;
  const int nqt = (p.Sq + BQ - 1) / BQ;
  // causal: a query tile whose last row is above this block's first key
  // sees none of it
  const int qt0 = p.causal ? k0 / BQ : 0;

  // the i-th query tile this block visits goes to stage i % NS
  auto load_q = [&](int i) {
    const int st = i % NS, r0 = (qt0 + i) * BQ;
    load_tile<BQ, DT>(Qs + st * BQ * SD, qb, r0, p.Sq, p.D, vec);
    load_tile<BQ, DT>(Os + st * BQ * SD, ob, r0, p.Sq, p.D, vec);
    load_vec<BQ>(Ls + st * BQ, lb, r0, p.Sq);
    load_vec<BQ>(Dl + st * BQ, db, r0, p.Sq);
  };
  const int nvis = nqt - qt0;  // query tiles that see these keys
  load_tile<BK, DT>(Ks, k + koff, k0, p.Sk, p.D, vec);
  load_tile<BK, DT>(Vs, v + koff, k0, p.Sk, p.D, vec);
  load_vec<BK>(Ms, mb, k0, p.Sk);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // one commit group per tile
    if (i < nvis) load_q(i);
    cp_commit();
  }

  float adk[NO][4], adv[NO][4];
  zero(adk);
  zero(adv);

  for (int i = 0; i < nvis; ++i) {
    const int st = i % NS;
    cp_wait<NS - 2>();  // this tile (and K, V) have landed ...
    __syncthreads();    // ... for every thread, and tile i - 1 is done
    if (i + NS - 1 < nvis) load_q(i + NS - 1);  // into tile i - 1's stage
    cp_commit();
    const float* Qt = Qs + st * BQ * SD;
    const float* Ot = Os + st * BQ * SD;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Dl + st * BQ;
    const int q0 = (qt0 + i) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: s[j] holds keys (g, g + 8) and query
    // columns (8 j + 2 t, + 1); 64 columns of d a partial sum
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int kg = 0; kg < KD; kg += 8) {
      float ps[NQ][4], pdp[NQ][4];
      zero(ps);
      zero(pdp);
#pragma unroll
      for (int kk = kg; kk < kg + 8; ++kk) {
        uint32_t akb[4], aks[4], avb[4], avs[4];
        load_a<DT>(Ks + fr + wr * SD + 8 * kk, akb, aks);
        load_a<DT>(Vs + fr + wr * SD + 8 * kk, avb, avs);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          uint32_t qbg[2], qsm[2], obg[2], osm[2];
          load_b_row(Qt + fr + 8 * j * SD + 8 * kk, qbg, qsm);
          load_b_row(Ot + fr + 8 * j * SD + 8 * kk, obg, osm);
          mma3(ps[j], akb, aks, qbg, qsm);
          mma3(pdp[j], avb, avs, obg, osm);
        }
      }
      fold(s, ps, kg == 0);
      fold(dp, pdp, kg == 0);
    }

    // scale in f32, then the reference's masks on global positions: only
    // a tile that reaches past Sq, Sk or the diagonal, or whose kv mask
    // has a zero among the warp's keys, is masked element by element
    const float mk[2] = {Ms[wr + g], Ms[wr + g + 8]};
    const bool edge =
        !__all_sync(0xffffffffu, mk[0] > 0.f && mk[1] > 0.f) ||
        q0 + BQ > p.Sq || k0 + wr + 16 > p.Sk ||
        (p.causal && q0 < k0 + wr + 15);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    if (edge) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + wr + g + (e >> 1) * 8;
          const int row = q0 + j * 8 + 2 * t + (e & 1);
          if (row >= p.Sq || key >= p.Sk)
            s[j][e] = -INFINITY;  // past the data: P exactly 0
          else if ((p.causal && row < key) || !(mk[e >> 1] > 0.f))
            s[j][e] = kNegInf;
        }
    }

    // P = exp(S scale - lse) and dS = P (dP' - delta) in f32, in place:
    // s becomes P' and dp becomes dS
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 lv = lds2(Lt + j * 8 + 2 * t);
      const float2 dl = lds2(Dt + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = __expf(s[j][e] - ((e & 1) ? lv.y : lv.x));
        float dpn = dp[j][e];
        float pv = pr;
        if constexpr (kDrop) {
          const int key = k0 + wr + g + (e >> 1) * 8;
          const int row = q0 + j * 8 + 2 * t + (e & 1);
          const bool keep = keep_bit(p, bh, row, key);
          pv = keep ? pr * p.keep_scale : 0.f;
          dpn = keep ? dpn * p.keep_scale : 0.f;
        }
        s[j][e] = pv;
        dp[j][e] = pr * (dpn - ((e & 1) ? dl.y : dl.x));
      }
    }

    // dV += P'^T dO and dK += dS^T Q over this block's columns, the tile's
    // partial sums first: the 8 queries of s[j] are one k chunk; dO's and
    // Q's B fragments are rows 8 j + 2 t, + 1 of their tiles
    float pdv[NO][4], pdk[NO][4];
    zero(pdv);
    zero(pdk);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      uint32_t pbg[4], psm[4], dbg[4], dsm[4];
      acc_as_a(s[j], pbg, psm);
      acc_as_a(dp[j], dbg, dsm);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t obg[2], osm[2], qbg[2], qsm[2];
        load_b_col(Ot + 8 * j * SD + 8 * n, fc, obg, osm);
        load_b_col(Qt + 8 * j * SD + 8 * n, fc, qbg, qsm);
        mma3(pdv[n], pbg, psm, obg, osm);
        mma3(pdk[n], dbg, dsm, qbg, qsm);
      }
    }
    fold(adv, pdv, false);
    fold(adk, pdk, false);
  }
  cp_wait<0>();  // K and V have landed even where no query tile ran

  // dK = scale dS^T q and dV, straight from the accumulators
  store_acc<NO>(dk + koff, adk, k0 + wr, p.Sk, p.D, d0, p.scale);
  store_acc<NO>(dv + koff, adv, k0 + wr, p.Sk, p.D, d0, 1.f);
}

// ---------------------------------------------------------------------------
// dQ: grid (BH * ceil(Sq / 64), DT / DO); warp w owns query rows 16 w ..
// 16 w + 15.  S = Q K^T and dP = dO V^T take Q's and dO's fragments as A,
// so dS, formed on their accumulators, is already the A operand of
// dQ += dS K
// ---------------------------------------------------------------------------
template <int DT>
struct DqCfg {
  static constexpr int BQ = 16 * kWarps;
  // key tile: the K/V ring and the S, dP accumulators' registers
  static constexpr int BK = DT < 256 ? 32 : 16;
  static constexpr int DO = DT < 128 ? DT : 128;  // output columns a block
  static constexpr int kStages = 2;               // the K, V, mask ring
  static constexpr int kMinBlocks = DT == 64 ? 2 : 1;  // an SM at D 64
  static constexpr size_t smem =
      sizeof(float) *
      ((2 * BQ + 2 * kStages * BK) * kStride<DT> + kStages * BK);
};

template <int DT, bool kDrop>
__global__ void __launch_bounds__(kThreads, DqCfg<DT>::kMinBlocks)
    dq_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, float* __restrict__ dq,
                    Params p, int vec) {
  using C = DqCfg<DT>;
  constexpr int BQ = C::BQ, BK = C::BK, DO = C::DO, NS = C::kStages;
  constexpr int NT = BK / 8, KD = DT / 8, NO = DO / 8, SD = kStride<DT>;
  extern __shared__ __align__(128) unsigned char f32_smem[];
  float* Qs = reinterpret_cast<float*>(f32_smem);  // [BQ][SD]
  float* Os = Qs + BQ * SD;                          // [BQ][SD], dO
  float* Ks = Os + BQ * SD;                          // [NS][BK][SD]
  float* Vs = Ks + NS * BK * SD;                     // [NS][BK][SD]
  float* Ms = Vs + NS * BK * SD;                     // [NS][BK]
  // the last query tiles (under causal masking the longest) first
  const int nqt = (p.Sq + BQ - 1) / BQ, BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH;
  const int q0 = (nqt - 1 - (int)blockIdx.x / BH) * BQ;
  const int d0 = blockIdx.y * DO;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int fr = srow(g) * SD + 2 * t;
  const int fc[2] = {srow(2 * t) * SD + g + d0,
                     srow(2 * t + 1) * SD + g + d0};
  const size_t qoff = (size_t)bh * p.Sq * p.D;
  const float* kb = k + (size_t)bh * p.Sk * p.D;
  const float* vb = v + (size_t)bh * p.Sk * p.D;
  const float* mb = mask + (size_t)(bh / p.H) * p.Sk;
  int nkt = (p.Sk + BK - 1) / BK;
  if (p.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);  // k0 <= last row

  // key tile i goes to stage i % NS: K, V and its mask slice
  auto load_kv = [&](int i) {
    const int st = i % NS;
    load_tile<BK, DT>(Ks + st * BK * SD, kb, i * BK, p.Sk, p.D, vec);
    load_tile<BK, DT>(Vs + st * BK * SD, vb, i * BK, p.Sk, p.D, vec);
    load_vec<BK>(Ms + st * BK, mb, i * BK, p.Sk);
  };
  load_tile<BQ, DT>(Qs, q + qoff, q0, p.Sq, p.D, vec);
  load_tile<BQ, DT>(Os, dout + qoff, q0, p.Sq, p.D, vec);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {  // one commit group per tile
    if (i < nkt) load_kv(i);
    cp_commit();
  }

  // lse and delta of rows (g, g + 8); rows past Sq are never stored
  float lr[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    lr[r] = row < p.Sq ? lse[(size_t)bh * p.Sq + row] : 0.f;
    dl[r] = row < p.Sq ? delta[(size_t)bh * p.Sq + row] : 0.f;
  }
  float acc[NO][4];
  zero(acc);

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % NS;
    cp_wait<NS - 2>();  // this tile (and Q, dO) have landed ...
    __syncthreads();    // ... for every thread, and tile kt - 1 is done
    if (kt + NS - 1 < nkt) load_kv(kt + NS - 1);  // into tile kt - 1's stage
    cp_commit();
    const float* Kt = Ks + st * BK * SD;
    const float* Vt = Vs + st * BK * SD;
    const float* Mt = Ms + st * BK;
    const int k0 = kt * BK;

    // S = Q K^T and dP = dO V^T: s[j], dp[j] hold rows (g, g + 8) and key
    // columns (8 j + 2 t, + 1); 64 columns of d a partial sum
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int kg = 0; kg < KD; kg += 8) {
      float ps[NT][4], pdp[NT][4];
      zero(ps);
      zero(pdp);
#pragma unroll
      for (int kk = kg; kk < kg + 8; ++kk) {
        uint32_t aqb[4], aqs[4], aob[4], aos[4];
        load_a<DT>(Qs + fr + wr * SD + 8 * kk, aqb, aqs);
        load_a<DT>(Os + fr + wr * SD + 8 * kk, aob, aos);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t kbg[2], ksm[2], vbg[2], vsm[2];
          load_b_row(Kt + fr + 8 * j * SD + 8 * kk, kbg, ksm);
          load_b_row(Vt + fr + 8 * j * SD + 8 * kk, vbg, vsm);
          mma3(ps[j], aqb, aqs, kbg, ksm);
          mma3(pdp[j], aob, aos, vbg, vsm);
        }
      }
      fold(s, ps, kg == 0);
      fold(dp, pdp, kg == 0);
    }

    // scale in f32, then the reference's masks on global positions: only
    // a tile that reaches past Sk or the diagonal, or whose kv mask has a
    // zero, is masked element by element
    bool valid = true;
#pragma unroll
    for (int c = lane; c < BK; c += 32) valid = valid && Mt[c] > 0.f;
    const bool edge = !__all_sync(0xffffffffu, valid) || k0 + BK > p.Sk ||
                      (p.causal && k0 + BK - 1 > q0 + wr);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 mk = lds2(Mt + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = q0 + wr + g + (e >> 1) * 8;
          if (col >= p.Sk)
            s[j][e] = -INFINITY;  // past the keys: P exactly 0
          else if (!(((e & 1) ? mk.y : mk.x) > 0.f) ||
                   (p.causal && row < col))
            s[j][e] = kNegInf;
        }
      }
    }

    // dS = P (dP' - delta), P = exp(S scale - lse), in f32 on dp
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = __expf(s[j][e] - lr[e >> 1]);
        float dpn = dp[j][e];
        if constexpr (kDrop) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = q0 + wr + g + (e >> 1) * 8;
          dpn = keep_bit(p, bh, row, col) ? dpn * p.keep_scale : 0.f;
        }
        dp[j][e] = pr * (dpn - dl[e >> 1]);
      }
    }

    // dQ += dS K over this block's columns, the tile's partial sum first:
    // the 8 keys of dp[j] are one k chunk; K's B fragments are rows 8 j +
    // 2 t, + 1 of its tile
    float pacc[NO][4];
    zero(pacc);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t dbg[4], dsm[4];
      acc_as_a(dp[j], dbg, dsm);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t kbg[2], ksm[2];
        load_b_col(Kt + 8 * j * SD + 8 * n, fc, kbg, ksm);
        mma3(pacc[n], dbg, dsm, kbg, ksm);
      }
    }
    fold(acc, pacc, false);
  }
  cp_wait<0>();

  // dQ = scale dS K, straight from the accumulators
  store_acc<NO>(dq + qoff, acc, q0 + wr, p.Sq, p.D, d0, p.scale);
}

}  // namespace f32tc

// ---------------------------------------------------------------------------
// launchers: tiles by head width (DT = 64, 128, 256)
// ---------------------------------------------------------------------------
template <typename K>
int prepare(K kern, size_t smem, long long blocks) {
  if (blocks <= 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int check_dims(int BH, int H, int Sq, int Sk, int D) {
  if (BH <= 0 || H <= 0 || BH % H || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > 256)
    return (int)cudaErrorInvalidValue;
  return 0;
}

Params make_params(int H, int Sq, int Sk, int D, float scale, int causal,
                   int dropout, float keep_scale, unsigned thresh,
                   unsigned seed, const void* seed_ptr) {
  Params p;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.keep_scale = keep_scale;
  p.thresh = thresh;
  p.seed = seed;
  p.seed_ptr = static_cast<const uint32_t*>(seed_ptr);
  return p;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename T, int DT, bool kDrop>
int launch_fwd_tc(const void* q, const void* k, const void* v,
                  const void* mask, void* o, void* lse, int BH,
                  const Params& p, int vec, cudaStream_t st) {
  using C = tc::FwdCfg<DT, kDrop>;
  const long long blocks = (long long)BH * ((p.Sq + C::BQ - 1) / C::BQ);
  auto kern = tc::fwd_tc_kernel<T, DT, kDrop>;
  const int rc = prepare(kern, C::smem, blocks);
  if (rc) return rc;
  kern<<<(unsigned)blocks, tc::kThreads, C::smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(o), static_cast<float*>(lse), p, vec);
  return (int)cudaGetLastError();
}

template <typename T, int DT>
int launch_fwd_tc(const void* q, const void* k, const void* v,
                  const void* mask, void* o, void* lse, int BH,
                  const Params& p, int vec, cudaStream_t st) {
  return p.dropout
             ? launch_fwd_tc<T, DT, true>(q, k, v, mask, o, lse, BH, p, vec,
                                          st)
             : launch_fwd_tc<T, DT, false>(q, k, v, mask, o, lse, BH, p,
                                           vec, st);
}

template <typename T, int DT>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* mask, void* dk, void* dv, int BH,
                  const Params& p, int vec, cudaStream_t st) {
  using C = tc::DkvCfg<DT>;
  const long long blocks = (long long)BH * ((p.Sk + C::BK - 1) / C::BK);
  auto kern = p.dropout ? tc::dkv_tc_kernel<T, DT, true>
                        : tc::dkv_tc_kernel<T, DT, false>;
  const int rc = prepare(kern, C::smem, blocks);
  if (rc) return rc;
  kern<<<dim3((unsigned)blocks, DT / C::DO), tc::kThreads, C::smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dk),
      static_cast<T*>(dv), p, vec);
  return (int)cudaGetLastError();
}

template <typename T, int DT>
int launch_dq_tc(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* mask, void* dqo, int BH, const Params& p,
                 int vec, cudaStream_t st) {
  using C = tc::DqCfg<DT>;
  const long long blocks = (long long)BH * ((p.Sq + C::BQ - 1) / C::BQ);
  auto kern = p.dropout ? tc::dq_tc_kernel<T, DT, true>
                        : tc::dq_tc_kernel<T, DT, false>;
  const int rc = prepare(kern, C::smem, blocks);
  if (rc) return rc;
  kern<<<dim3((unsigned)blocks, DT / C::DO), tc::kThreads, C::smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dqo), p, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_tc(const void* q, const void* k, const void* v, const void* mask,
           void* o, void* lse, int BH, int H, int Sq, int Sk, int D,
           float scale, int causal, int dropout, float keep_scale,
           unsigned thresh, unsigned seed, const void* seed_ptr, void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed, seed_ptr);
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_fwd_tc<T, 64>(q, k, v, mask, o, lse, BH, p, vec, st);
  if (D <= 128)
    return launch_fwd_tc<T, 128>(q, k, v, mask, o, lse, BH, p, vec, st);
  return launch_fwd_tc<T, 256>(q, k, v, mask, o, lse, BH, p, vec, st);
}

template <typename T>
int dkv_tc(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* mask, void* dk,
           void* dv, int BH, int H, int Sq, int Sk, int D, float scale,
           int causal, int dropout, float keep_scale, unsigned thresh,
           unsigned seed, const void* seed_ptr, void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed, seed_ptr);
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dk) &&
                  aligned16(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkv_tc<T, 64>(q, k, v, dout, lse, delta, mask, dk, dv, BH, p,
                             vec, st);
  if (D <= 128)
    return launch_dkv_tc<T, 128>(q, k, v, dout, lse, delta, mask, dk, dv, BH,
                              p, vec, st);
  return launch_dkv_tc<T, 256>(q, k, v, dout, lse, delta, mask, dk, dv, BH, p,
                            vec, st);
}

template <typename T>
int dq_tc(const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, const void* mask, void* dqo,
          int BH, int H, int Sq, int Sk, int D, float scale, int causal,
          int dropout, float keep_scale, unsigned thresh, unsigned seed,
          const void* seed_ptr,
          void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed, seed_ptr);
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dqo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dq_tc<T, 64>(q, k, v, dout, lse, delta, mask, dqo, BH, p, vec,
                            st);
  if (D <= 128)
    return launch_dq_tc<T, 128>(q, k, v, dout, lse, delta, mask, dqo, BH, p,
                             vec, st);
  return launch_dq_tc<T, 256>(q, k, v, dout, lse, delta, mask, dqo, BH, p, vec,
                           st);
}


template <int DT>
int launch_fwd_f32tc(const void* q, const void* k, const void* v,
                     const void* mask, void* o, void* lse, int BH,
                     const Params& p, int vec, cudaStream_t st) {
  using C = f32tc::FwdCfg<DT>;
  const long long blocks = (long long)BH * ((p.Sq + C::BQ - 1) / C::BQ);
  auto kern = p.dropout ? f32tc::fwd_f32tc_kernel<DT, true>
                        : f32tc::fwd_f32tc_kernel<DT, false>;
  const int rc = prepare(kern, C::smem, blocks);
  if (rc) return rc;
  kern<<<dim3((unsigned)blocks, DT / C::DO), tc::kThreads, C::smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<float*>(o), static_cast<float*>(lse), p, vec);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dkv_f32tc(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* mask, void* dk, void* dv, int BH,
                     const Params& p, int vec, cudaStream_t st) {
  using C = f32tc::DkvCfg<DT>;
  const long long blocks = (long long)BH * ((p.Sk + C::BK - 1) / C::BK);
  auto kern = p.dropout ? f32tc::dkv_f32tc_kernel<DT, true>
                        : f32tc::dkv_f32tc_kernel<DT, false>;
  const int rc = prepare(kern, C::smem, blocks);
  if (rc) return rc;
  kern<<<dim3((unsigned)blocks, DT / C::DO), tc::kThreads, C::smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<float*>(dk),
      static_cast<float*>(dv), p, vec);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dq_f32tc(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* mask, void* dqo, int BH, const Params& p,
                    int vec, cudaStream_t st) {
  using C = f32tc::DqCfg<DT>;
  const long long blocks = (long long)BH * ((p.Sq + C::BQ - 1) / C::BQ);
  auto kern = p.dropout ? f32tc::dq_f32tc_kernel<DT, true>
                        : f32tc::dq_f32tc_kernel<DT, false>;
  const int rc = prepare(kern, C::smem, blocks);
  if (rc) return rc;
  kern<<<dim3((unsigned)blocks, DT / C::DO), tc::kThreads, C::smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<float*>(dqo), p, vec);
  return (int)cudaGetLastError();
}

int fwd_f32tc(const void* q, const void* k, const void* v, const void* mask,
              void* o, void* lse, int BH, int H, int Sq, int Sk, int D,
              float scale, int causal, int dropout, float keep_scale,
              unsigned thresh, unsigned seed, const void* seed_ptr,
              void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed, seed_ptr);
  const int vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_fwd_f32tc<64>(q, k, v, mask, o, lse, BH, p, vec, st);
  if (D <= 128)
    return launch_fwd_f32tc<128>(q, k, v, mask, o, lse, BH, p, vec, st);
  return launch_fwd_f32tc<256>(q, k, v, mask, o, lse, BH, p, vec, st);
}

int dkv_f32tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* mask, void* dk,
              void* dv, int BH, int H, int Sq, int Sk, int D, float scale,
              int causal, int dropout, float keep_scale, unsigned thresh,
              unsigned seed, const void* seed_ptr, void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed, seed_ptr);
  const int vec = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkv_f32tc<64>(q, k, v, dout, lse, delta, mask, dk, dv, BH,
                                p, vec, st);
  if (D <= 128)
    return launch_dkv_f32tc<128>(q, k, v, dout, lse, delta, mask, dk, dv,
                                 BH, p, vec, st);
  return launch_dkv_f32tc<256>(q, k, v, dout, lse, delta, mask, dk, dv, BH,
                               p, vec, st);
}

int dq_f32tc(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* mask, void* dqo,
             int BH, int H, int Sq, int Sk, int D, float scale, int causal,
             int dropout, float keep_scale, unsigned thresh, unsigned seed,
             const void* seed_ptr,
             void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed, seed_ptr);
  const int vec = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dq_f32tc<64>(q, k, v, dout, lse, delta, mask, dqo, BH, p,
                               vec, st);
  if (D <= 128)
    return launch_dq_f32tc<128>(q, k, v, dout, lse, delta, mask, dqo, BH, p,
                                vec, st);
  return launch_dq_f32tc<256>(q, k, v, dout, lse, delta, mask, dqo, BH, p,
                              vec, st);
}

}  // namespace

// All pointers are contiguous device memory on one card: q [BH, Sq, D],
// k and v [BH, Sk, D] and dout [BH, Sq, D] in the entry point's dtype;
// mask [BH / H, Sk], lse and delta [BH, Sq] in f32; seed_ptr is null or
// one uint32 on the card, read in place of seed.  Each launches on
// ``stream`` and returns cudaGetLastError() (0 = launched).
// f32: all three bodies on the tensor cores in 3xTF32
extern "C" int ptt_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 const void* mask, void* o, void* lse, int BH,
                                 int H, int Sq, int Sk, int D, float scale,
                                 int causal, int dropout, float keep_scale,
                                 unsigned thresh, unsigned seed,
                                 const void* seed_ptr,
                                 void* stream) {
  return fwd_f32tc(q, k, v, mask, o, lse, BH, H, Sq, Sk, D, scale, causal,
                   dropout, keep_scale, thresh, seed, seed_ptr, stream);
}
extern "C" int ptt_flash_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* mask,
                                 void* dk, void* dv, int BH, int H, int Sq,
                                 int Sk, int D, float scale, int causal,
                                 int dropout, float keep_scale,
                                 unsigned thresh, unsigned seed,
                                 const void* seed_ptr,
                                 void* stream) {
  return dkv_f32tc(q, k, v, dout, lse, delta, mask, dk, dv, BH, H, Sq, Sk, D,
                   scale, causal, dropout, keep_scale, thresh, seed, seed_ptr,
                   stream);
}
extern "C" int ptt_flash_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* mask,
                                void* dqo, int BH, int H, int Sq, int Sk,
                                int D, float scale, int causal, int dropout,
                                float keep_scale, unsigned thresh,
                                unsigned seed, const void* seed_ptr,
                                void* stream) {
  return dq_f32tc(q, k, v, dout, lse, delta, mask, dqo, BH, H, Sq, Sk, D,
                  scale, causal, dropout, keep_scale, thresh, seed, seed_ptr,
                  stream);
}

// bf16 and fp16: all three bodies on the tensor cores, one template
extern "C" int ptt_flash_fwd_bf16(const void* q, const void* k,
                                  const void* v, const void* mask, void* o,
                                  void* lse, int BH, int H, int Sq, int Sk,
                                  int D, float scale, int causal,
                                  int dropout, float keep_scale,
                                  unsigned thresh, unsigned seed,
                                  const void* seed_ptr, void* stream) {
  return fwd_tc<tc::bf16>(q, k, v, mask, o, lse, BH, H, Sq, Sk, D, scale,
                      causal, dropout, keep_scale, thresh, seed, seed_ptr,
                      stream);
}
extern "C" int ptt_flash_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* mask, void* dk, void* dv,
                                  int BH, int H, int Sq, int Sk, int D,
                                  float scale, int causal, int dropout,
                                  float keep_scale, unsigned thresh,
                                  unsigned seed, const void* seed_ptr,
                                  void* stream) {
  return dkv_tc<tc::bf16>(q, k, v, dout, lse, delta, mask, dk, dv, BH, H, Sq,
                      Sk, D, scale, causal, dropout, keep_scale, thresh,
                      seed, seed_ptr, stream);
}
extern "C" int ptt_flash_dq_bf16(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* mask, void* dqo, int BH, int H,
                                 int Sq, int Sk, int D, float scale,
                                 int causal, int dropout, float keep_scale,
                                 unsigned thresh, unsigned seed,
                                 const void* seed_ptr, void* stream) {
  return dq_tc<tc::bf16>(q, k, v, dout, lse, delta, mask, dqo, BH, H, Sq, Sk,
                     D, scale, causal, dropout, keep_scale, thresh, seed,
                     seed_ptr, stream);
}
extern "C" int ptt_flash_fwd_f16(const void* q, const void* k,
                                  const void* v, const void* mask, void* o,
                                  void* lse, int BH, int H, int Sq, int Sk,
                                  int D, float scale, int causal,
                                  int dropout, float keep_scale,
                                  unsigned thresh, unsigned seed,
                                  const void* seed_ptr, void* stream) {
  return fwd_tc<tc::f16>(q, k, v, mask, o, lse, BH, H, Sq, Sk, D, scale,
                      causal, dropout, keep_scale, thresh, seed, seed_ptr,
                      stream);
}
extern "C" int ptt_flash_dkv_f16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* mask, void* dk, void* dv,
                                  int BH, int H, int Sq, int Sk, int D,
                                  float scale, int causal, int dropout,
                                  float keep_scale, unsigned thresh,
                                  unsigned seed, const void* seed_ptr,
                                  void* stream) {
  return dkv_tc<tc::f16>(q, k, v, dout, lse, delta, mask, dk, dv, BH, H, Sq,
                      Sk, D, scale, causal, dropout, keep_scale, thresh,
                      seed, seed_ptr, stream);
}
extern "C" int ptt_flash_dq_f16(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* mask, void* dqo, int BH, int H,
                                 int Sq, int Sk, int D, float scale,
                                 int causal, int dropout, float keep_scale,
                                 unsigned thresh, unsigned seed,
                                 const void* seed_ptr, void* stream) {
  return dq_tc<tc::f16>(q, k, v, dout, lse, delta, mask, dqo, BH, H, Sq, Sk,
                     D, scale, causal, dropout, keep_scale, thresh, seed,
                     seed_ptr, stream);
}
