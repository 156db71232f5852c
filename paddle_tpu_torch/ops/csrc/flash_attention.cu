// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a), plain
// C interface.
//
// Replaces the three Pallas kernels of
// paddle_tpu/ops/pallas_ops/flash_attention.py:
//   ptt_flash_fwd_*  <- _flash_fwd_bhsd (body _fwd_kernel)
//   ptt_flash_dkv_*  <- _flash_dkv_bhsd (body _bwd_dkv_kernel)
//   ptt_flash_dq_*   <- _flash_dq_bhsd  (body _bwd_dq_kernel)
//
// What they compute, on q [BH, Sq, D], k and v [BH, Sk, D] (f32 or bf16,
// row-major), a kv validity mask [B, Sk] f32 (b = bh / H) and a seed:
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
// product pair.  In f32 that is the 67 TFLOP/s of the CUDA cores (bound
// by operations); in bf16 the 989 TFLOP/s of the tensor cores make the
// bytes the bound (0.0152 ms forward, 0.0228 ms dK/dV).
//
// Two designs.
//
// f32 (all three bodies) and bf16 dQ: all arithmetic in f32 FMAs on the
// CUDA cores, so the f32 results stay those the tests pin.  A plain
// shared-memory tiling, one block of 256 threads (16 x 16) per output
// tile: forward and dQ one block per (bh, tile of BQ query rows) looping
// over the key tiles it can see (causal: up to the diagonal), dK/dV one
// block per (bh, tile of BK keys) looping over the query tiles that see
// it.  Each thread owns a register micro-tile of rows ty + 16 i and
// columns tx + 16 j; a score row lives in 16 adjacent lanes of one warp,
// so the row max and sum are warp shuffles.  Tiles are loaded
// synchronously and sized by the head width (DT = 64, 128 or 256 columns,
// zero-padded past D), so that shared memory stays under the 227 KB a
// block may use at D 256.
//
// bf16 forward and dK/dV (namespace tc): FA2's design on the tensor
// cores, mma.sync m16n8k16 (bf16 in, f32 accumulators), chosen over
// wgmma + TMA because it needs no tensor maps, no warp specialisation and
// no shared-memory matrix descriptors, and its register-resident A
// operand is what keeps P and dS out of shared memory.  One block of 4 warps.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX package's finite NEG_INF
constexpr int kThreads = 256;      // 16 x 16: ty = tid / 16, tx = tid % 16

struct Params {
  int H, Sq, Sk, D;
  float scale;
  int causal, dropout;
  float keep_scale;  // 1 / (1 - dropout_p)
  uint32_t thresh;   // keep where hash >= thresh
  uint32_t seed;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// paddle_tpu/ops/pallas_ops/flash_attention.py:_keep_mask, bit for bit
__device__ __forceinline__ bool keep_bit(const Params& p, uint32_t bh,
                                         uint32_t row, uint32_t col) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x = x + p.seed * 0xC2B2AE3Du;
  x = x ^ (bh * 0x27D4EB2Fu);
  x = x ^ (x >> 15);
  x = x * 0x2C1B3C6Du;
  x = x ^ (x >> 12);
  x = x * 0x297A2D39u;
  x = x ^ (x >> 15);
  return x >= p.thresh;
}

// rows [r0, r0 + R) of a row-major [n, D] matrix into a shared tile of
// row stride DT + 1, as f32 times mul; rows past n and columns past D are 0
template <typename T, int R, int DT>
__device__ __forceinline__ void load_rows(float* dst,
                                          const T* __restrict__ src, int r0,
                                          int n, int D, float mul) {
  constexpr int SD = DT + 1;
  for (int i = threadIdx.x; i < R * DT; i += kThreads) {
    const int r = i / DT, d = i % DT;
    const int gr = r0 + r;
    dst[r * SD + d] =
        (gr < n && d < D) ? to_f32(src[(size_t)gr * D + d]) * mul : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d]  (row stride DT + 1)
template <int DT, int TM, int TN>
__device__ __forceinline__ void mm_nt(const float* A, const float* B,
                                      float (&acc)[TM][TN], int D) {
  constexpr int SD = DT + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * SD + d];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = B[(tx + 16 * j) * SD + d];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{c < NC} P[ty + 16 i][c] * V[c][tx + 16 j]  (P row
// stride NC + 1, V row stride DT + 1); column groups past D are skipped
template <int NC, int DT, int TM, int TD>
__device__ __forceinline__ void mm_nn(const float* P, const float* V,
                                      float (&acc)[TM][TD], int D) {
  constexpr int SP = NC + 1, SD = DT + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int c = 0; c < NC; ++c) {
    float pr[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) pr[i] = P[(ty + 16 * i) * SP + c];
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      if (16 * j < D) {  // the same for every thread of the block
        const float vv = V[c * SD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }
}

// reduce over the 16 lanes that hold one score row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// forward: grid BH * ceil(Sq / BQ)
// ---------------------------------------------------------------------------
template <int BQ, int BK, int DT>
constexpr size_t fwd_smem() {
  return sizeof(float) *
         (BQ * (DT + 1) + 2 * BK * (DT + 1) + BQ * (BK + 1) + BK);
}

template <typename T, int BQ, int BK, int DT>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ mask,
               T* __restrict__ o, float* __restrict__ lse, Params p) {
  constexpr int SD = DT + 1, SP = BK + 1;
  constexpr int TM = BQ / 16, TN = BK / 16, TD = DT / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][SD], pre-scaled
  float* Ks = Qs + BQ * SD;      // [BK][SD]
  float* Vs = Ks + BK * SD;      // [BK][SD]
  float* Ps = Vs + BK * SD;      // [BQ][SP], dropped probabilities
  float* Ms = Ps + BQ * SP;      // [BK], kv mask of the tile
  const int nqt = (p.Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt;
  const int q0 = (blockIdx.x % nqt) * BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + (size_t)bh * p.Sq * p.D;
  const T* kb = k + (size_t)bh * p.Sk * p.D;
  const T* vb = v + (size_t)bh * p.Sk * p.D;
  const float* mb = mask + (size_t)(bh / p.H) * p.Sk;

  load_rows<T, BQ, DT>(Qs, qb, q0, p.Sq, p.D, p.scale);
  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }
  int nkt = (p.Sk + BK - 1) / BK;
  if (p.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);  // k0 <= last row

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, BK, DT>(Ks, kb, k0, p.Sk, p.D, 1.f);
    load_rows<T, BK, DT>(Vs, vb, k0, p.Sk, p.D, 1.f);
    for (int c = threadIdx.x; c < BK; c += kThreads)
      Ms[c] = (k0 + c < p.Sk) ? mb[k0 + c] : 0.f;
    __syncthreads();
    float s[TM][TN];
    mm_nt<DT, TM, TN>(Qs, Ks, s, p.D);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j];
        if (col >= p.Sk)
          x = -INFINITY;  // past the keys: exactly 0 after exp
        else if ((p.causal && row < col) || !(Ms[tx + 16 * j] > 0.f))
          x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        float pa = e;
        if (p.dropout) {
          const int col = k0 + tx + 16 * j;
          pa = keep_bit(p, bh, row, col) ? e * p.keep_scale : 0.f;
        }
        Ps[(ty + 16 * i) * SP + tx + 16 * j] = pa;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mm_nn<BK, DT, TM, TD>(Ps, Vs, acc, p.D);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * p.Sq + row) * p.D;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) store(orow + d, acc[i][j] / l_safe);
    }
    if (tx == 0) lse[(size_t)bh * p.Sq + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid BH * ceil(Sq / BQ)
// ---------------------------------------------------------------------------
template <int BQ, int BK, int DT>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (2 * BQ * (DT + 1) + 2 * BK * (DT + 1) + BQ * (BK + 1) + BK);
}

template <typename T, int BQ, int BK, int DT>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ mask, T* __restrict__ dq, Params p) {
  constexpr int SD = DT + 1, SP = BK + 1;
  constexpr int TM = BQ / 16, TN = BK / 16, TD = DT / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][SD], pre-scaled
  float* dOs = Qs + BQ * SD;     // [BQ][SD]
  float* Ks = dOs + BQ * SD;     // [BK][SD]
  float* Vs = Ks + BK * SD;      // [BK][SD]
  float* dSs = Vs + BK * SD;     // [BQ][SP]
  float* Ms = dSs + BQ * SP;     // [BK]
  const int nqt = (p.Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nqt;
  const int q0 = (blockIdx.x % nqt) * BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = (size_t)bh * p.Sq * p.D;
  const T* kb = k + (size_t)bh * p.Sk * p.D;
  const T* vb = v + (size_t)bh * p.Sk * p.D;
  const float* mb = mask + (size_t)(bh / p.H) * p.Sk;

  load_rows<T, BQ, DT>(Qs, q + qoff, q0, p.Sq, p.D, p.scale);
  load_rows<T, BQ, DT>(dOs, dout + qoff, q0, p.Sq, p.D, 1.f);
  float lr[TM], dl[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < p.Sq ? lse[(size_t)bh * p.Sq + row] : 0.f;
    dl[i] = row < p.Sq ? delta[(size_t)bh * p.Sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }
  int nkt = (p.Sk + BK - 1) / BK;
  if (p.causal) nkt = min(nkt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows<T, BK, DT>(Ks, kb, k0, p.Sk, p.D, 1.f);
    load_rows<T, BK, DT>(Vs, vb, k0, p.Sk, p.D, 1.f);
    for (int c = threadIdx.x; c < BK; c += kThreads)
      Ms[c] = (k0 + c < p.Sk) ? mb[k0 + c] : 0.f;
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
    mm_nt<DT, TM, TN>(Qs, Ks, s, p.D);
    mm_nt<DT, TM, TN>(dOs, Vs, dp, p.D);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (row < p.Sq && col < p.Sk) {
          float x = s[i][j];
          if ((p.causal && row < col) || !(Ms[tx + 16 * j] > 0.f))
            x = kNegInf;
          const float pr = expf(x - lr[i]);
          float dpn = dp[i][j];
          if (p.dropout)
            dpn = keep_bit(p, bh, row, col) ? dpn * p.keep_scale : 0.f;
          ds = pr * (dpn - dl[i]);
        }
        dSs[(ty + 16 * i) * SP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    mm_nn<BK, DT, TM, TD>(dSs, Ks, acc, p.D);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    T* out = dq + qoff + (size_t)row * p.D;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) store(out + d, acc[i][j] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid BH * ceil(Sk / BK)
// ---------------------------------------------------------------------------
template <int BQ, int BK, int DT>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * BK * (DT + 1) + 2 * BQ * (DT + 1) +
                          2 * BK * (BQ + 1) + 2 * BQ + BK);
}

template <typename T, int BQ, int BK, int DT>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               const float* __restrict__ mask, T* __restrict__ dk,
               T* __restrict__ dv, Params p) {
  constexpr int SD = DT + 1, SP = BQ + 1;
  constexpr int TM = BK / 16, TN = BQ / 16, TD = DT / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BK][SD]
  float* Vs = Ks + BK * SD;      // [BK][SD]
  float* Qs = Vs + BK * SD;      // [BQ][SD], pre-scaled
  float* dOs = Qs + BQ * SD;     // [BQ][SD]
  float* PT = dOs + BQ * SD;     // [BK][SP], dropped probabilities^T
  float* dST = PT + BK * SP;     // [BK][SP], dS^T
  float* Ls = dST + BK * SP;     // [BQ] lse of the query tile
  float* Dl = Ls + BQ;           // [BQ] delta of the query tile
  float* Ms = Dl + BQ;           // [BK] kv mask of this block's keys
  const int nkt = (p.Sk + BK - 1) / BK;
  const int bh = blockIdx.x / nkt;
  const int k0 = (blockIdx.x % nkt) * BK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + (size_t)bh * p.Sq * p.D;
  const T* ob = dout + (size_t)bh * p.Sq * p.D;
  const size_t koff = (size_t)bh * p.Sk * p.D;
  const float* mb = mask + (size_t)(bh / p.H) * p.Sk;

  load_rows<T, BK, DT>(Ks, k + koff, k0, p.Sk, p.D, 1.f);
  load_rows<T, BK, DT>(Vs, v + koff, k0, p.Sk, p.D, 1.f);
  for (int c = threadIdx.x; c < BK; c += kThreads)
    Ms[c] = (k0 + c < p.Sk) ? mb[k0 + c] : 0.f;
  float adk[TM][TD], adv[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) adk[i][j] = adv[i][j] = 0.f;
  const int nqt = (p.Sq + BQ - 1) / BQ;
  // causal: a query tile whose last row is above this block's first key
  // sees none of it
  const int qt0 = p.causal ? k0 / BQ : 0;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_rows<T, BQ, DT>(Qs, qb, q0, p.Sq, p.D, p.scale);
    load_rows<T, BQ, DT>(dOs, ob, q0, p.Sq, p.D, 1.f);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = q0 + r < p.Sq;
      Ls[r] = in ? lse[(size_t)bh * p.Sq + q0 + r] : 0.f;
      Dl[r] = in ? delta[(size_t)bh * p.Sq + q0 + r] : 0.f;
    }
    __syncthreads();
    // transposed scores: element [i][j] is (row q0 + tx + 16 j, col
    // k0 + ty + 16 i)
    float sT[TM][TN], dpT[TM][TN];
    mm_nt<DT, TM, TN>(Ks, Qs, sT, p.D);
    mm_nt<DT, TM, TN>(Vs, dOs, dpT, p.D);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int row = q0 + tx + 16 * j;
        float pv = 0.f, ds = 0.f;
        if (row < p.Sq && col < p.Sk) {
          float x = sT[i][j];
          if ((p.causal && row < col) || !(Ms[ty + 16 * i] > 0.f))
            x = kNegInf;
          const float pr = expf(x - Ls[tx + 16 * j]);
          float dpn = dpT[i][j];
          pv = pr;
          if (p.dropout) {
            const bool keep = keep_bit(p, bh, row, col);
            pv = keep ? pr * p.keep_scale : 0.f;
            dpn = keep ? dpn * p.keep_scale : 0.f;
          }
          ds = pr * (dpn - Dl[tx + 16 * j]);
        }
        PT[(ty + 16 * i) * SP + tx + 16 * j] = pv;
        dST[(ty + 16 * i) * SP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    mm_nn<BQ, DT, TM, TD>(PT, dOs, adv, p.D);
    mm_nn<BQ, DT, TM, TD>(dST, Qs, adk, p.D);  // q pre-scaled: scale dS^T q
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col >= p.Sk) continue;
    const size_t off = koff + (size_t)col * p.D;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) {
        store(dk + off + d, adk[i][j]);
        store(dv + off + d, adv[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward and dK/dV on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
using bf16 = __nv_bfloat16;

// element offset of (row r, column c) in a [rows][DT] bf16 tile whose
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
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 in one register, the lower column in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + R) of a row-major [n, D] bf16 matrix into a swizzled
// [R][DT] tile, rows past n and columns past D zero.  vec (D a multiple of
// 8, every pointer 16-byte aligned): one 16-byte cp.async per chunk;
// otherwise element by element, synchronously
template <int R, int DT>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int r0, int n, int D, bool vec) {
  if (vec) {
    // thread i copies chunk i % CH of rows i / CH + RP u
    constexpr int CH = DT / 8, RP = kThreads / CH;
    static_assert(kThreads % CH == 0 && R % RP == 0, "tile split");
    const int c = (threadIdx.x % CH) * 8, rr = threadIdx.x / CH;
    const bf16* g = src + (size_t)(r0 + rr) * D + c;
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
                               : __float2bfloat16(0.f);
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
template <int DT, int W>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const bf16* tile, int tr0,
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
__device__ __forceinline__ void stage2(bf16* tile, int off0, int off1,
                                       const float (&c)[4], float mul0,
                                       float mul1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + off0) =
      __floats2bfloat162_rn(c[0] * mul0, c[1] * mul0);
  *reinterpret_cast<__nv_bfloat162*>(tile + off1) =
      __floats2bfloat162_rn(c[2] * mul1, c[3] * mul1);
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
      sizeof(bf16) * (BQ * DT + 2 * kStages * BK * DT) +
      sizeof(float) * kStages * BK;
};

template <int DT, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ mask,
                  bf16* __restrict__ o, float* __restrict__ lse, Params p,
                  int vec) {
  using C = FwdCfg<DT, kDrop>;
  constexpr int MT = C::MT, BQ = C::BQ, BK = C::BK, NS = C::kStages;
  constexpr int NT = BK / 8, KD = DT / 16, ND = DT / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][DT]
  bf16* Ks = Qs + BQ * DT;                        // [NS][BK][DT]
  bf16* Vs = Ks + NS * BK * DT;                   // [NS][BK][DT]
  float* Ms = reinterpret_cast<float*>(Vs + NS * BK * DT);  // [NS][BK]
  // the last query tiles (under causal masking the longest) first
  const int nqt = (p.Sq + BQ - 1) / BQ, BH = gridDim.x / nqt;
  const int bh = blockIdx.x % BH;
  const int q0 = (nqt - 1 - (int)blockIdx.x / BH) * BQ;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16 * MT;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + (size_t)bh * p.Sq * p.D;
  const bf16* kb = k + (size_t)bh * p.Sk * p.D;
  const bf16* vb = v + (size_t)bh * p.Sk * p.D;
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
    const bf16* Kt = Ks + st * BK * DT;
    const bf16* Vt = Vs + st * BK * DT;
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
          mma(s[mt][j], a[mt], b[0], b[1]);
          mma(s[mt][j + 1], a[mt], b[2], b[3]);
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
    // P' (dropped, rounded to bf16) goes from the S accumulators straight
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
        pf[mt][j >> 1][(j & 1) * 2] = pack(pe[0], pe[1]);
        pf[mt][j >> 1][(j & 1) * 2 + 1] = pack(pe[2], pe[3]);
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
          mma(acc[mt][n], pf[mt][kk], b[0], b[1]);
          mma(acc[mt][n + 1], pf[mt][kk], b[2], b[3]);
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
      sizeof(bf16) * (2 * BK * DT + 2 * kStages * BQ * DT) +
      sizeof(float) * (BK + 2 * kStages * BQ);
};

template <int DT, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ mask, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, Params p, int vec) {
  using C = DkvCfg<DT>;
  constexpr int BK = C::BK, BQ = C::BQ, DO = C::DO, NS = C::kStages;
  constexpr int NQ = BQ / 8, KD = DT / 16, NO = DO / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);  // [BK][DT]
  bf16* Vs = Ks + BK * DT;                        // [BK][DT]
  bf16* Qs = Vs + BK * DT;                        // [NS][BQ][DT]
  bf16* Os = Qs + NS * BQ * DT;                   // [NS][BQ][DT], dO
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
  const bf16* qb = q + (size_t)bh * p.Sq * p.D;
  const bf16* ob = dout + (size_t)bh * p.Sq * p.D;
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
    const bf16* Qt = Qs + st * BQ * DT;
    const bf16* Ot = Os + st * BQ * DT;
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
        mma(s[j], ak, bq[0], bq[1]);
        mma(s[j + 1], ak, bq[2], bq[3]);
        mma(dp[j], av, bo[0], bo[1]);
        mma(dp[j + 1], av, bo[2], bo[3]);
      }
    }

    // P = exp(S scale - lse) and dS = P (dP' - delta) in f32; P' and dS
    // rounded to bf16 straight into the A fragments of the next products
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
      pa[j >> 1][(j & 1) * 2] = pack(pv[0], pv[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack(pv[2], pv[3]);
      da[j >> 1][(j & 1) * 2] = pack(ds[0], ds[1]);
      da[j >> 1][(j & 1) * 2 + 1] = pack(ds[2], ds[3]);
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
        mma(adv[n], pa[kq], bo[0], bo[1]);
        mma(adv[n + 1], pa[kq], bo[2], bo[3]);
        mma(adk[n], da[kq], bq[0], bq[1]);
        mma(adk[n + 1], da[kq], bq[2], bq[3]);
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

}  // namespace tc

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

template <typename T, int BQ, int BK, int DT>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask,
               void* o, void* lse, int BH, const Params& p,
               cudaStream_t st) {
  constexpr size_t smem = fwd_smem<BQ, BK, DT>();
  const long long blocks = (long long)BH * ((p.Sq + BQ - 1) / BQ);
  auto kern = fwd_kernel<T, BQ, BK, DT>;
  const int rc = prepare(kern, smem, blocks);
  if (rc) return rc;
  kern<<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(o), static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int BK, int DT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* mask, void* dq,
              int BH, const Params& p, cudaStream_t st) {
  constexpr size_t smem = dq_smem<BQ, BK, DT>();
  const long long blocks = (long long)BH * ((p.Sq + BQ - 1) / BQ);
  auto kern = dq_kernel<T, BQ, BK, DT>;
  const int rc = prepare(kern, smem, blocks);
  if (rc) return rc;
  kern<<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dq), p);
  return (int)cudaGetLastError();
}

template <typename T, int BQ, int BK, int DT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* mask,
               void* dk, void* dv, int BH, const Params& p,
               cudaStream_t st) {
  constexpr size_t smem = dkv_smem<BQ, BK, DT>();
  const long long blocks = (long long)BH * ((p.Sk + BK - 1) / BK);
  auto kern = dkv_kernel<T, BQ, BK, DT>;
  const int rc = prepare(kern, smem, blocks);
  if (rc) return rc;
  kern<<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<T*>(dk),
      static_cast<T*>(dv), p);
  return (int)cudaGetLastError();
}

Params make_params(int H, int Sq, int Sk, int D, float scale, int causal,
                   int dropout, float keep_scale, unsigned thresh,
                   unsigned seed) {
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
  return p;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* mask,
        void* o, void* lse, int BH, int H, int Sq, int Sk, int D,
        float scale, int causal, int dropout, float keep_scale,
        unsigned thresh, unsigned seed, void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_fwd<T, 64, 64, 64>(q, k, v, mask, o, lse, BH, p, st);
  if (D <= 128)
    return launch_fwd<T, 64, 32, 128>(q, k, v, mask, o, lse, BH, p, st);
  return launch_fwd<T, 64, 32, 256>(q, k, v, mask, o, lse, BH, p, st);
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, const void* mask, void* dqo,
       int BH, int H, int Sq, int Sk, int D, float scale, int causal,
       int dropout, float keep_scale, unsigned thresh, unsigned seed,
       void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dq<T, 64, 64, 64>(q, k, v, dout, lse, delta, mask, dqo,
                                    BH, p, st);
  if (D <= 128)
    return launch_dq<T, 64, 32, 128>(q, k, v, dout, lse, delta, mask, dqo,
                                     BH, p, st);
  return launch_dq<T, 64, 32, 256>(q, k, v, dout, lse, delta, mask, dqo, BH,
                                   p, st);
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* mask, void* dk,
        void* dv, int BH, int H, int Sq, int Sk, int D, float scale,
        int causal, int dropout, float keep_scale, unsigned thresh,
        unsigned seed, void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkv<T, 64, 64, 64>(q, k, v, dout, lse, delta, mask, dk,
                                     dv, BH, p, st);
  if (D <= 128)
    return launch_dkv<T, 32, 32, 128>(q, k, v, dout, lse, delta, mask, dk,
                                      dv, BH, p, st);
  return launch_dkv<T, 32, 32, 256>(q, k, v, dout, lse, delta, mask, dk, dv,
                                    BH, p, st);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <int DT, bool kDrop>
int launch_fwd_tc(const void* q, const void* k, const void* v,
                  const void* mask, void* o, void* lse, int BH,
                  const Params& p, int vec, cudaStream_t st) {
  using C = tc::FwdCfg<DT, kDrop>;
  const long long blocks = (long long)BH * ((p.Sq + C::BQ - 1) / C::BQ);
  auto kern = tc::fwd_tc_kernel<DT, kDrop>;
  const int rc = prepare(kern, C::smem, blocks);
  if (rc) return rc;
  kern<<<(unsigned)blocks, tc::kThreads, C::smem, st>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const float*>(mask),
      static_cast<tc::bf16*>(o), static_cast<float*>(lse), p, vec);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_fwd_tc(const void* q, const void* k, const void* v,
                  const void* mask, void* o, void* lse, int BH,
                  const Params& p, int vec, cudaStream_t st) {
  return p.dropout
             ? launch_fwd_tc<DT, true>(q, k, v, mask, o, lse, BH, p, vec, st)
             : launch_fwd_tc<DT, false>(q, k, v, mask, o, lse, BH, p, vec,
                                        st);
}

template <int DT>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* mask, void* dk, void* dv, int BH,
                  const Params& p, int vec, cudaStream_t st) {
  using C = tc::DkvCfg<DT>;
  const long long blocks = (long long)BH * ((p.Sk + C::BK - 1) / C::BK);
  auto kern = p.dropout ? tc::dkv_tc_kernel<DT, true>
                        : tc::dkv_tc_kernel<DT, false>;
  const int rc = prepare(kern, C::smem, blocks);
  if (rc) return rc;
  kern<<<dim3((unsigned)blocks, DT / C::DO), tc::kThreads, C::smem, st>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(mask), static_cast<tc::bf16*>(dk),
      static_cast<tc::bf16*>(dv), p, vec);
  return (int)cudaGetLastError();
}

int fwd_tc(const void* q, const void* k, const void* v, const void* mask,
           void* o, void* lse, int BH, int H, int Sq, int Sk, int D,
           float scale, int causal, int dropout, float keep_scale,
           unsigned thresh, unsigned seed, void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed);
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_fwd_tc<64>(q, k, v, mask, o, lse, BH, p, vec, st);
  if (D <= 128)
    return launch_fwd_tc<128>(q, k, v, mask, o, lse, BH, p, vec, st);
  return launch_fwd_tc<256>(q, k, v, mask, o, lse, BH, p, vec, st);
}

int dkv_tc(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* mask, void* dk,
           void* dv, int BH, int H, int Sq, int Sk, int D, float scale,
           int causal, int dropout, float keep_scale, unsigned thresh,
           unsigned seed, void* stream) {
  const int bad = check_dims(BH, H, Sq, Sk, D);
  if (bad) return bad;
  const Params p = make_params(H, Sq, Sk, D, scale, causal, dropout,
                               keep_scale, thresh, seed);
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dk) &&
                  aligned16(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_dkv_tc<64>(q, k, v, dout, lse, delta, mask, dk, dv, BH, p,
                             vec, st);
  if (D <= 128)
    return launch_dkv_tc<128>(q, k, v, dout, lse, delta, mask, dk, dv, BH,
                              p, vec, st);
  return launch_dkv_tc<256>(q, k, v, dout, lse, delta, mask, dk, dv, BH, p,
                            vec, st);
}

}  // namespace

// All pointers are contiguous device memory on one card: q [BH, Sq, D],
// k and v [BH, Sk, D] and dout [BH, Sq, D] in the entry point's dtype;
// mask [BH / H, Sk], lse and delta [BH, Sq] in f32.  Each launches on
// ``stream`` and returns cudaGetLastError() (0 = launched).
#define PTT_FLASH_ENTRIES(SUFFIX, T)                                          \
  extern "C" int ptt_flash_fwd_##SUFFIX(                                      \
      const void* q, const void* k, const void* v, const void* mask,          \
      void* o, void* lse, int BH, int H, int Sq, int Sk, int D, float scale,  \
      int causal, int dropout, float keep_scale, unsigned thresh,             \
      unsigned seed, void* stream) {                                          \
    return fwd<T>(q, k, v, mask, o, lse, BH, H, Sq, Sk, D, scale, causal,     \
                  dropout, keep_scale, thresh, seed, stream);                 \
  }                                                                           \
  extern "C" int ptt_flash_dkv_##SUFFIX(                                      \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, const void* mask, void* dk,         \
      void* dv, int BH, int H, int Sq, int Sk, int D, float scale,            \
      int causal, int dropout, float keep_scale, unsigned thresh,             \
      unsigned seed, void* stream) {                                          \
    return dkv<T>(q, k, v, dout, lse, delta, mask, dk, dv, BH, H, Sq, Sk, D,  \
                  scale, causal, dropout, keep_scale, thresh, seed, stream);  \
  }                                                                           \
  extern "C" int ptt_flash_dq_##SUFFIX(                                       \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, const void* mask, void* dqo,        \
      int BH, int H, int Sq, int Sk, int D, float scale, int causal,          \
      int dropout, float keep_scale, unsigned thresh, unsigned seed,          \
      void* stream) {                                                         \
    return dq<T>(q, k, v, dout, lse, delta, mask, dqo, BH, H, Sq, Sk, D,      \
                 scale, causal, dropout, keep_scale, thresh, seed, stream);   \
  }

PTT_FLASH_ENTRIES(f32, float)

// bf16: the forward and dK/dV on the tensor cores, dQ on the CUDA cores
extern "C" int ptt_flash_fwd_bf16(const void* q, const void* k,
                                  const void* v, const void* mask, void* o,
                                  void* lse, int BH, int H, int Sq, int Sk,
                                  int D, float scale, int causal,
                                  int dropout, float keep_scale,
                                  unsigned thresh, unsigned seed,
                                  void* stream) {
  return fwd_tc(q, k, v, mask, o, lse, BH, H, Sq, Sk, D, scale, causal,
                dropout, keep_scale, thresh, seed, stream);
}
extern "C" int ptt_flash_dkv_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* mask, void* dk, void* dv,
                                  int BH, int H, int Sq, int Sk, int D,
                                  float scale, int causal, int dropout,
                                  float keep_scale, unsigned thresh,
                                  unsigned seed, void* stream) {
  return dkv_tc(q, k, v, dout, lse, delta, mask, dk, dv, BH, H, Sq, Sk, D,
                scale, causal, dropout, keep_scale, thresh, seed, stream);
}
extern "C" int ptt_flash_dq_bf16(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* mask, void* dqo, int BH, int H,
                                 int Sq, int Sk, int D, float scale,
                                 int causal, int dropout, float keep_scale,
                                 unsigned thresh, unsigned seed,
                                 void* stream) {
  return dq<__nv_bfloat16>(q, k, v, dout, lse, delta, mask, dqo, BH, H, Sq,
                           Sk, D, scale, causal, dropout, keep_scale, thresh,
                           seed, stream);
}
