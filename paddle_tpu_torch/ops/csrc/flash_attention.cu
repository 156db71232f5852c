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
// forward's bits whatever its tiling.  All arithmetic is f32 FMAs on the
// CUDA cores: TF32 or bf16 tensor cores would move the numbers the tests
// pin.  o, dq, dk and dv are written in the input dtype, lse in f32.
//
// What bounds them on an H100: at the training shape (S 1024, D 64) the
// score tiles never leave the chip, so each kernel moves only its inputs
// and outputs once and is bound by its 4 * S^2 * D (causal: half) f32
// operations.  The design is a plain shared-memory tiling, one block of
// 256 threads (16 x 16) per output tile, blocks independent and in no
// order:
//   forward and dQ: one block per (bh, tile of BQ query rows), looping
//       over the key tiles it can see (causal: up to the diagonal), the
//       running max, denominator and accumulator in registers;
//   dK/dV: one block per (bh, tile of BK key rows), looping over the
//       query tiles that can see it.
// Each thread owns a register micro-tile of rows ty + 16 i and columns
// tx + 16 j; a score row lives in 16 adjacent lanes of one warp, so the
// row max and sum are warp shuffles.  Keeping the JAX package's split of
// the backward into two kernels needs no atomics: gradients are the same
// from run to run.  Tiles are sized by the head width (DT = 64, 128 or
// 256 columns, zero-padded past D) so that shared memory stays under the
// 227 KB a block may use at D 256.  Ragged edges (S not a multiple of a
// tile, D not a multiple of 16) are masked in the kernels: a key past Sk
// scores -inf, exactly 0 after exp, so it never enters any sum.
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
PTT_FLASH_ENTRIES(bf16, __nv_bfloat16)
