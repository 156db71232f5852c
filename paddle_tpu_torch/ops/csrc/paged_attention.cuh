// The paged-attention kernels for NVIDIA Hopper (sm_90a), shared by their
// plain C interfaces: paged_attention.cu (#1 / #1q, the normalized context
// of the ragged layout, bodies _ragged_kernel / _ragged_kernel_quant),
// paged_decode.cu (#2 / #2q, one query row per table row, bodies
// _decode_kernel / _decode_kernel_quant) and paged_attention_stats.cu (#3 /
// #3q, the stats form of a sequence shard, bodies _ragged_stats_kernel /
// _ragged_stats_kernel_quant).  What they compute, per lane g, query row r
// and head h:
//
//   out[g, r, h, :] = softmax_{s visible}( q[g,r,h,:] . k[s,h,:] / sqrt(D) ) @ v[s,h,:]
//
// where position s of lane g lives in page page_tables[g, s / P], slot
// s % P, of the pools k_pages / v_pages [N, P, H, D], and s is visible when
// s < row_lens[g, r] — and, in the stats form, when its page is owned:
// page_ok[g, s / P] != 0.  The stats form also writes
//
//   lse[g, r, h] = m + log(l)   (the log-sum-exp of the visible scores)
//
// in f32, or -1e30 (the finite NEG_INF) where l is not positive: a row with
// no visible position.  Rows with nothing visible write exact zeros.  q is
// f32 or bf16; all arithmetic is f32.  #2 is #1 at one row a lane (G = B,
// Qb = 1, row_lens = seq_lens).
//
// Int8 pools carry one f32 scale per (page, head), k_scales / v_scales
// [N, H].  fused_dequant = 1 (the default) scales a position's score by
// its page's K scale after the q.k dot — before the running max, so lse is
// the log-sum-exp of the dequantized logits — and its p.v contribution by
// its page's V scale (the softmax denominator l stays unscaled);
// fused_dequant = 0 dequantizes K and V before the dots.  A tile of 32
// positions can span pages, so each lane holds the scales of its own
// position.  A NaN scale reaches every row that reads its page: the score
// turns NaN, and so do p, l and the accumulator (fmaxf drops a NaN from
// the running max, but p = exp(NaN - m) carries it on).
//
// Three forms, by kernel and by the rows a lane carries:
//   - the decode form (below; #1 / #1q at Qb < 16, #2 / #2q): a lane's
//     walk split over a thread-block cluster;
//   - the prefill form (paged_attention_stats.cuh; #1 / #1q and #3 / #3q
//     at Qb >= 16): 16 rows a block, block-shared register-tiled tiles;
//   - the warp form (this header, first; #3 / #3q at Qb < 16), which walks
//     a shard's owned pages: the block first compacts the lane's owned
//     table entries below its horizon into a list in shared memory
//     (own_list), and its 32-position tiles are tiles of that compacted
//     walk, so a shard reads and scores only what it owns, whatever the
//     ownership pattern.
// Each reads a page once per (lane, head, row tile) and stops at the
// longest row of the tile, so a lane's cost follows its real tokens, not
// the padded page-table width.
//
// The warp form.  What bounds it on an H100: bytes (4*D flops per K/V
// position read).  Row tiles of up to 8 rows; int8 rows load as 16-byte
// vectors (D / 16 lanes per row) when D is a multiple of 16, else byte by
// byte, widened to f32 as a tile is staged.  Head dims: D <= 256, in
// instances of DC = 1, 2, 4 or 8 output columns a lane (D <= 32 DC).  Up
// to DC 4 a warp stages its K and V tiles side by side; at DC 8 (D
// 129-256) K and V share one tile: K is staged and scored, then V
// overwrites it.  Layout:
//   grid  = (G lanes, H heads, ceil(Qb / RB) row tiles)
//   block = 4 warps.  Warp w walks the 32-position tiles w, w+4, ... of
//           the block's compacted owned positions; lane j of the warp owns
//           position j of the tile for the q.k scores and D/32 output
//           columns for p.v.
//   Each warp keeps an online softmax (running max m, denominator l, f32
//   accumulator) per row, skips tiles a row cannot see, and the four
//   warps' partial states merge through shared memory at the end, after
//   which lse is written.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kTile = 32;             // KV positions per warp tile
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

// 16 int8 values (one 16-byte load) widened to f32, times f
__device__ __forceinline__ void unpack16(const int4 v, float* dst, float f) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dst[4 * i + b] = (float)((int)((unsigned)w[i] << (24 - 8 * b)) >> 24) * f;
}

// Stage one 32-position int8 tile of K and V into shared memory as f32.
// Lane j holds position j's byte offset ``src`` (-1 for a position that is
// not read: zeros) and its dequant factors kf / vf (1 when the scales are
// applied after the dots).  With ``vec`` (D % 16 == 0, 16-byte aligned
// pools) a row is D / 16 chunks of 16 bytes and each pass loads
// 32 / (D / 16) rows at once (2 at D 256), all passes in flight before any
// store.  ``kSides`` picks the tiles: bit 0 K, bit 1 V (DC 8 stages them
// one at a time into one tile).
template <int DC, int kSides = 3>
__device__ __forceinline__ void stage_int8(const int8_t* __restrict__ k_pages,
                                           const int8_t* __restrict__ v_pages,
                                           long long src, float kf, float vf,
                                           float* k_s, float* v_s, int ldk,
                                           int ldv, int D, int lane,
                                           int vec) {
  if (vec) {
    const int n_ch = D >> 4;
    const int rp = 32 / n_ch;               // rows per pass
    const int rsub = lane / n_ch;
    const int ch = lane - rsub * n_ch;
    constexpr int kPass = 2 * DC;            // >= ceil(32 / rp) for D <= 32 * DC
    int4 kr[kPass], vr[kPass];
    float kfs[kPass], vfs[kPass];
#pragma unroll
    for (int ps = 0; ps < kPass; ++ps) {
      const int j = ps * rp + rsub;
      const int jc = min(j, kTile - 1);
      const long long off = __shfl_sync(0xffffffffu, src, jc);
      if constexpr ((kSides & 1) != 0)
        kfs[ps] = __shfl_sync(0xffffffffu, kf, jc);
      if constexpr ((kSides & 2) != 0)
        vfs[ps] = __shfl_sync(0xffffffffu, vf, jc);
      kr[ps] = vr[ps] = make_int4(0, 0, 0, 0);
      if (rsub < rp && j < kTile && off >= 0) {
        if constexpr ((kSides & 1) != 0)
          kr[ps] = __ldg(reinterpret_cast<const int4*>(k_pages + off) + ch);
        if constexpr ((kSides & 2) != 0)
          vr[ps] = __ldg(reinterpret_cast<const int4*>(v_pages + off) + ch);
      }
    }
#pragma unroll
    for (int ps = 0; ps < kPass; ++ps) {
      const int j = ps * rp + rsub;
      if (rsub < rp && j < kTile) {
        if constexpr ((kSides & 1) != 0)
          unpack16(kr[ps], k_s + j * ldk + ch * 16, kfs[ps]);
        if constexpr ((kSides & 2) != 0)
          unpack16(vr[ps], v_s + j * ldv + ch * 16, vfs[ps]);
      }
    }
  } else {
    // any D: row by row, one byte per lane and column
    for (int j = 0; j < kTile; ++j) {
      const long long off = __shfl_sync(0xffffffffu, src, j);
      const float kfj = __shfl_sync(0xffffffffu, kf, j);
      const float vfj = __shfl_sync(0xffffffffu, vf, j);
      for (int d = lane; d < D; d += 32) {
        if constexpr ((kSides & 1) != 0)
          k_s[j * ldk + d] = off < 0 ? 0.f : (float)k_pages[off + d] * kfj;
        if constexpr ((kSides & 2) != 0)
          v_s[j * ldv + d] = off < 0 ? 0.f : (float)v_pages[off + d] * vfj;
      }
    }
  }
}

// Stage one 32-position tile of an f32 or bf16 pool (K or V) into shared
// memory as f32: DC 8's staging, one tile at a time, kBatch rows' loads in
// flight together (each row's offset broadcast by shuffle, consecutive
// lanes on consecutive d)
template <int DC, typename KV>
__device__ __forceinline__ void stage_rows(const KV* __restrict__ pages,
                                           long long src, float* dst, int ld,
                                           int D, int lane) {
  constexpr int kBatch = 32 / DC;     // kBatch * DC = 32 registers
#pragma unroll 1
  for (int j0 = 0; j0 < kTile; j0 += kBatch) {
    float r[kBatch][DC];
#pragma unroll
    for (int jj = 0; jj < kBatch; ++jj) {
      const long long off = __shfl_sync(0xffffffffu, src, j0 + jj);
      const long long at = off < 0 ? 0 : off;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = min(lane + 32 * c, D - 1);
        r[jj][c] = to_f32(pages[at + d]);
        if (off < 0) r[jj][c] = 0.f;
      }
    }
#pragma unroll
    for (int jj = 0; jj < kBatch; ++jj)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) dst[(j0 + jj) * ld + d] = r[jj][c];
      }
  }
}

// async copies; src_size 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
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

// The stats form's walk: the owned entries of one lane's table below
// ``horizon`` (ok_g[m] != 0 for m < ceil(horizon / P)), compacted in table
// order by a block prefix scan — own_m[e] the e-th owned entry's index,
// own_page[e] its page id — and the number of owned positions below the
// horizon, the length of the compacted walk.  Compacted position i lies
// in entry own_m[i / P], slot i % P, at original position
// own_m[i / P] * P + i % P; original positions grow with i, so the
// positions a row sees are a prefix of the walk.  Every thread of the
// block calls it (wsum holds one int per warp); the list is visible to
// all of them on return.
template <int kThreads>
__device__ __forceinline__ int own_list(const int* __restrict__ pt_g,
                                        const int* __restrict__ ok_g,
                                        int horizon, int P, int* own_m,
                                        int* own_page, int* wsum) {
  constexpr int kW = kThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_ent = (horizon + P - 1) / P;
  int n_own = 0;
  for (int b = 0; b < n_ent; b += kThreads) {   // block-uniform trip count
    const int m = b + threadIdx.x;
    const bool f = m < n_ent && ok_g[m] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) wsum[warp] = __popc(bal);
    __syncthreads();
    int before = n_own, total = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const int c = wsum[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (f) {
      const int e = before + __popc(bal & ((1u << lane) - 1u));
      own_m[e] = m;
      own_page[e] = pt_g[m];
    }
    n_own += total;
    __syncthreads();
  }
  if (n_own == 0) return 0;
  return (n_own - 1) * P + min(P, horizon - own_m[n_own - 1] * P);
}

// The stats kernel's warp form.  KV is T (f32 / bf16 pools) or int8_t
// (pools with [N, H] scales); it reads the page_ok mask [G, M] and writes
// the lse output [G, Qb, H].
template <typename T, typename KV, int RB, int DC>
__global__ void __launch_bounds__(kWarps * 32)
stats_warp_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                  const KV* __restrict__ v_pages,
                  const float* __restrict__ k_scales,
                  const float* __restrict__ v_scales,
                  const int* __restrict__ page_tables,
                  const int* __restrict__ row_lens,
                  const int* __restrict__ page_ok, T* __restrict__ out,
                  float* __restrict__ lse, int Qb, int H, int D, int P, int M,
                  float scale, int fused, int vec) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  // DC 8: K and V take turns in one tile a warp (the header note)
  constexpr bool kShareKV = DC == 8;
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * RB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ldk = D + 1;  // padded K rows: lane-strided reads hit distinct banks
  // int8 tiles are stored 16 columns per lane-row: pad V rows too
  const int ldv = kQuant ? D + 1 : D;

  float* q_s = smem;                                   // [RB][D], pre-scaled
  float* kv_s = q_s + RB * D;                          // per-warp tiles
  float* k_s;                                          // [kTile][ldk]
  float* v_s;                                          // [kTile][ldv]
  // stats form: the compacted owned list ([M] entries, [M] pages) and the
  // scan's warp sums
  int* own_m;
  if constexpr (kShareKV) {
    k_s = kv_s + warp * kTile * ldk;
    v_s = k_s;
    own_m = reinterpret_cast<int*>(kv_s + kWarps * kTile * ldk);
  } else {
    k_s = kv_s + warp * kTile * (ldk + ldv);
    v_s = k_s + kTile * ldk;
    own_m = reinterpret_cast<int*>(kv_s + kWarps * kTile * (ldk + ldv));
  }
  int* own_page = own_m + M;

  // per-row horizons; rows past Qb are empty.  Positions past the page
  // table (M * P) do not exist.
  const int cap = M * P;
  int rl[RB];
  int horizon = 0;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int row = r0 + r;
    int len = row < Qb ? row_lens[(size_t)g * Qb + row] : 0;
    len = min(max(len, 0), cap);
    rl[r] = len;
    horizon = max(horizon, len);
  }
  for (int i = threadIdx.x; i < RB * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = r0 + r;
    q_s[i] = row < Qb
                 ? to_f32(q[(((size_t)g * Qb + row) * H + h) * D + d]) * scale
                 : 0.f;
  }
  __syncthreads();

  float m[RB], l[RB], acc[RB][DC];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  const int* pt = page_tables + (size_t)g * M;
  const size_t slot_stride = (size_t)H * D;
  // positions walked: the owned positions below the horizon, compacted
  const int n_walk = own_list<kWarps * 32>(pt, page_ok + (size_t)g * M,
                                           horizon, P, own_m, own_page,
                                           own_page + M);
  const int n_tiles = (n_walk + kTile - 1) / kTile;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int base = t * kTile;
    // each lane looks up the slot of ITS position once; the warp then
    // stages the tile kBatch rows at a time, each row's offset broadcast
    // by shuffle, consecutive lanes on consecutive d (coalesced).  The
    // loads are unconditional (a position that is not read loads slot 0
    // of the pool and is zeroed after), so all kBatch rows' loads are in
    // flight together instead of one dependent round trip per row.
    long long src = -1;
    float ksl = 1.f, vsl = 1.f;     // int8: the page scales of this lane's position
    int pos = base + lane;
    // ``own``: this lane's compacted position exists — only then is it
    // read.  base and pos count compacted owned positions: pos becomes the
    // lane's original position, which every visibility test reads.
    // ``first``: the tile's first position (warp-uniform)
    const bool own = pos < n_walk;
    if (own) {
      const int e = pos / P;
      const int slot = pos - e * P;
      const int page = own_page[e];
      pos = own_m[e] * P + slot;
      src = ((long long)page * P + slot) * slot_stride + (long long)h * D;
      if constexpr (kQuant) {
        ksl = k_scales[(size_t)page * H + h];
        vsl = v_scales[(size_t)page * H + h];
      }
    }
    const int first = __shfl_sync(0xffffffffu, pos, 0);
    if constexpr (kQuant) {
      stage_int8<DC, kShareKV ? 1 : 3>(k_pages, v_pages, src,
                                       fused ? 1.f : ksl, fused ? 1.f : vsl,
                                       k_s, v_s, ldk, ldv, D, lane, vec);
    } else if constexpr (kShareKV) {
      stage_rows<DC>(k_pages, src, k_s, ldk, D, lane);
    } else {
    constexpr int kBatch = 32 / DC;     // kBatch * DC * 2 = 64 registers
#pragma unroll 1
    for (int j0 = 0; j0 < kTile; j0 += kBatch) {
      float kr[kBatch][DC], vr[kBatch][DC];
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const long long off = __shfl_sync(0xffffffffu, src, j0 + jj);
        const long long at = off < 0 ? 0 : off;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = min(lane + 32 * c, D - 1);
          kr[jj][c] = to_f32(k_pages[at + d]);
          vr[jj][c] = to_f32(v_pages[at + d]);
          if (off < 0) kr[jj][c] = vr[jj][c] = 0.f;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) {
            k_s[(j0 + jj) * ldk + d] = kr[jj][c];
            v_s[(j0 + jj) * ldv + d] = vr[jj][c];
          }
        }
      }
    }
    }
    __syncwarp();

    float s[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) s[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane * ldk + d];
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r] += q_s[r * D + d] * kd;
    }
    if (kQuant && fused) {
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r] *= ksl;   // dequant K after the dot
    }
    if constexpr (kShareKV) {
      __syncwarp();   // every lane has read its K row: V takes the tile
      if constexpr (kQuant)
        stage_int8<DC, 2>(k_pages, v_pages, src, 1.f, fused ? 1.f : vsl,
                          k_s, v_s, ldk, ldv, D, lane, vec);
      else
        stage_rows<DC>(v_pages, src, v_s, ldv, D, lane);
      __syncwarp();
    }

#pragma unroll
    for (int r = 0; r < RB; ++r) {
      // a row that sees no position of this tile skips it outright
      // (warp-uniform: rl and first are the same on every lane)
      if (first >= rl[r]) continue;
      const bool valid = own && pos < rl[r];
      const float m_new = fmaxf(m[r], warp_max(valid ? s[r] : -INFINITY));
      const float alpha = expf(m[r] - m_new);
      const float p = valid ? expf(s[r] - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      // dequant V on position j's contribution, not on the denominator
      const float pv = (kQuant && fused) ? p * vsl : p;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
      // visible positions only (a position that is not read holds zeros
      // and p = 0); they are a prefix of the tile
      const int jn = __popc(__ballot_sync(0xffffffffu, valid));
      for (int j = 0; j < jn; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[r][c] += pj * v_s[j * ldv + d];
        }
      }
      m[r] = m_new;
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states through shared memory (the
  // K/V tiles are dead now)
  __syncthreads();
  const int ld = D + 2;  // acc[0..D), m, l
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float* e = kv_s + (size_t)(warp * RB + r) * ld;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) e[d] = acc[r][c];
    }
    if (lane == 0) {
      e[D] = m[r];
      e[D + 1] = l[r];
    }
  }
  __syncthreads();
  for (int r = warp; r < RB; r += kWarps) {
    const int row = r0 + r;
    if (row >= Qb) continue;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, kv_s[(size_t)(w * RB + r) * ld + D]);
    float lsum = 0.f;
    float o[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* e = kv_s + (size_t)(w * RB + r) * ld;
      const float sc = expf(e[D] - mx);
      lsum += e[D + 1] * sc;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) o[c] += e[d] * sc;
      }
    }
    // an empty row has l == 0 and acc == 0: exact zeros, as on the TPU
    const float denom = fmaxf(lsum, 1e-30f);
    const size_t at = ((size_t)g * Qb + row) * H + h;
    T* dst = out + at * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(dst + d, o[c] / denom);
    }
    // the merged stats: a row with nothing visible (or a NaN sum, as the
    // TPU kernel's ``l > 0`` test reads it) gets the finite NEG_INF, so a
    // shard merge weighs it exp(-1e30 - M) = 0, never NaN
    if (lane == 0) lse[at] = lsum > 0.f ? mx + logf(lsum) : kNegInf;
  }
}

template <typename T, typename KV, int RB, int DC>
int launch_rb(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* pt, const void* rl, const void* ok,
              void* out, void* lse, int G, int Qb, int H, int D, int P,
              int M, int fused, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const int ldv = kQuant ? D + 1 : D;
  // a warp's tiles a row: K's and V's, or (DC 8) the one they share
  const int ld_kv = DC == 8 ? D + 1 : D + 1 + ldv;
  const size_t smem = ((size_t)RB * D +
                       (size_t)kWarps * kTile * ld_kv) * sizeof(float) +
                      (size_t)(2 * M + kWarps) * sizeof(int);
  const int vec = kQuant && D % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto kern = stats_warp_kernel<T, KV, RB, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)G, (unsigned)H, (unsigned)((Qb + RB - 1) / RB));
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(rl), static_cast<const int*>(ok),
      static_cast<T*>(out), static_cast<float*>(lse), Qb, H, D, P, M,
      1.0f / sqrtf((float)D), fused, vec);
  return (int)cudaGetLastError();
}

// rows per block: 1 for decode lanes, 4 or 8 for more (registers hold
// RB * DC accumulators per lane)
template <typename T, typename KV, int DC>
int launch_dc(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* pt, const void* rl, const void* ok,
              void* out, void* lse, int G, int Qb, int H, int D, int P,
              int M, int fused, cudaStream_t s) {
  if (Qb <= 1)
    return launch_rb<T, KV, 1, DC>(q, k, v, ks, vs, pt, rl, ok, out, lse, G,
                                   Qb, H, D, P, M, fused, s);
  if (Qb <= 4)
    return launch_rb<T, KV, 4, DC>(q, k, v, ks, vs, pt, rl, ok, out, lse, G,
                                   Qb, H, D, P, M, fused, s);
  return launch_rb<T, KV, 8, DC>(q, k, v, ks, vs, pt, rl, ok, out, lse, G, Qb,
                                 H, D, P, M, fused, s);
}

// the stats kernel's warp form (Qb < 16)
template <typename T, typename KV>
int launch_warp(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* pt, const void* rl,
                const void* ok, void* out, void* lse, int G, int Qb, int H,
                int D, int P, int M, int fused, void* stream) {
  if (G <= 0 || Qb <= 0 || H <= 0 || P <= 0 || M <= 0 || D <= 0 ||
      D > kMaxD || H > 65535 || Qb > 8 * 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dc<T, KV, 1>(q, k, v, ks, vs, pt, rl, ok, out, lse, G, Qb,
                               H, D, P, M, fused, s);
  if (D <= 64)
    return launch_dc<T, KV, 2>(q, k, v, ks, vs, pt, rl, ok, out, lse, G, Qb,
                               H, D, P, M, fused, s);
  if (D <= 128)
    return launch_dc<T, KV, 4>(q, k, v, ks, vs, pt, rl, ok, out, lse, G, Qb,
                               H, D, P, M, fused, s);
  return launch_dc<T, KV, 8>(q, k, v, ks, vs, pt, rl, ok, out, lse, G, Qb, H,
                             D, P, M, fused, s);
}

// --------------------------------------------------------------------------
// The decode form: #1 / #1q lanes of fewer than 16 rows, and #2 / #2q (one
// row a table row: G = B, Qb = 1, row_lens = seq_lens).
//
// What bounds it on an H100: bytes (4*D flops per K/V position read), and
// at serving widths the latency of a long lane's walk: (lane, head) pairs
// alone give 64-96 blocks on 132 SMs, each walking up to 32 tiles.  So
//   - each (lane, head, row tile)'s walk is split over the CS CTAs of a
//     thread-block cluster (CS <= 8, from the table's capacity M * P, the
//     pools' type and D only, never from G, H or other lanes' lengths):
//     tile t of the lane's walk goes to worker t mod (CS * W), worker
//     w = rank * W + warp.  Which tiles a warp takes is a function of the
//     lane's own horizon, so a lane's bits do not depend on its batch.
//     CS is sized for a few tiles a warp of a full table
//     (decode_tiles_per_worker), not one.  Rank r walks tiles from r * W
//     on, so a lane of n tiles keeps the first ceil(n / W) CTAs busy; the
//     others leave at once (with the cluster's two barriers when a peer
//     merges, else before any), and a lane of at most W tiles never
//     touches the cluster: rank 0 writes its CTA's state;
//   - a warp stages its tile's K and V rows by 16-byte cp.async as raw
//     bytes (f32, bf16 or int8) and pipelines its tiles: the next tile's
//     page lookups go out while this one is scored, its K copy once this
//     K is scored, its V copy once this V is used.  bf16 and int8 pools
//     keep a K and a V tile a warp, V's copy in flight while K is scored;
//     f32 pools share one tile (decode_share_kv);
//   - lane j scores position j from its raw K row (16-byte reads, rows
//     padded to an odd number of 16-byte chunks, so the lanes' reads fall
//     in distinct banks; the pre-scaled q broadcast from shared memory);
//     lane L owns output columns [L * DC, L * DC + DC) for p.v;
//   - each warp keeps an online softmax a row; the CTA merges its warps'
//     states in shared memory, then rank 0 merges the CTAs' states through
//     distributed shared memory (cluster.map_shared_rank) between two
//     cluster barriers and writes the output: no scratch in device memory,
//     no second launch.  Ranks without a tile hold m = -1e30, l = 0 and
//     acc = 0, which add exact zeros, so leaving them out of the merge
//     changes no bit.
// Int8 pools: each lane holds its position's page scales; fused_dequant
// 1 scales the score by K's and p by V's (not the denominator), 0 scales
// each element of K and V as it is read.  A position a row does not see
// is removed by select (score -inf, p 0, no p.v term), so a NaN stored
// there never reaches the row.  Rows with nothing visible write exact
// zeros.  D <= 256 (DC = 1, 2, 4, 8).
constexpr int kDecodeMaxCluster = 8;
constexpr int kDecodeMaxRows = 15;   // more rows a lane: the prefill form

// warps a CTA: f32 rows at DC 8 take 33 KB a warp, and two warps a CTA
// keep three CTAs an SM
__host__ __device__ constexpr int decode_warps(bool f32, int DC) {
  return f32 && DC == 8 ? 2 : 4;
}

// f32 pools: K and V of a warp's tile share one raw tile, V staged once K
// is scored.  f32 rows take 2-4x the bytes of bf16 and int8 ones, and half
// the shared memory doubles the CTAs an SM holds, which the card's L2
// throughput needs at many lanes.  bf16 and int8 pools keep two tiles, V's
// copy in flight while K is scored.
__host__ __device__ constexpr bool decode_share_kv(bool f32) { return f32; }

// 32-position tiles of a full table a warp is sized to take (so a lane's
// walk is split over fewer CTAs when each does more): f32 4, else 2
// (tools/paged_decode_probe.py times other counts by setting these).  A
// launch of many long lanes pays for every busy CTA, a launch of a few
// long lanes for the tiles a warp walks in turn.
#ifndef PTT_DECODE_TILES_F32
#define PTT_DECODE_TILES_F32 4
#endif
#ifndef PTT_DECODE_TILES
#define PTT_DECODE_TILES 2
#endif
__host__ __device__ constexpr int decode_tiles_per_worker(bool f32) {
  return f32 ? PTT_DECODE_TILES_F32 : PTT_DECODE_TILES;
}

template <typename KV, int DC>
struct DecodeCfg {
  static constexpr int W = decode_warps(std::is_same<KV, float>::value, DC);
  static constexpr int DP = 32 * DC;             // columns a row computes
  static constexpr int LDP = DP + 4;             // a merge row: acc, m, l
  static constexpr int kPer = 16 / (int)sizeof(KV);   // values a chunk
  static constexpr bool kF32 = std::is_same<KV, float>::value;
  static constexpr bool kShare = decode_share_kv(kF32);
};

// bytes of a raw tile row: D values rounded up to 16-byte chunks, and one
// more chunk when their number is even
__host__ __device__ __forceinline__ int decode_row_stride(int D, int item) {
  const int b = (D * item + 15) / 16 * 16;
  return (b / 16) % 2 ? b : b + 16;
}

// CTAs a lane's walk is split over: enough that W warps each take about
// decode_tiles_per_worker tiles of a full table, at most kDecodeMaxCluster
__host__ __device__ __forceinline__ int decode_cluster(bool f32, int W, int M,
                                                       int P) {
  const long long tiles = ((long long)M * P + kTile - 1) / kTile;
  const long long per = (long long)W * decode_tiles_per_worker(f32);
  const long long cs = (tiles + per - 1) / per;
  return (int)(cs < 1 ? 1 : cs > kDecodeMaxCluster ? kDecodeMaxCluster : cs);
}

// rows a CTA: 1 for a decode lane, 4 up to 4 rows, else 8 (spec verify)
__host__ __device__ __forceinline__ int decode_rows(int Qb) {
  return Qb <= 1 ? 1 : Qb <= 4 ? 4 : 8;
}

template <typename KV, int DC>
__host__ __device__ __forceinline__ size_t decode_smem(int RB, int D) {
  using C = DecodeCfg<KV, DC>;
  const size_t tiles = (size_t)C::W * (C::kShare ? 1 : 2) * kTile *
                       decode_row_stride(D, (int)sizeof(KV));
  const size_t merge = (size_t)C::W * RB * C::LDP * sizeof(float);
  return (size_t)RB * (C::DP + C::LDP) * sizeof(float) +
         (tiles > merge ? tiles : merge);
}

// One 32-position tile of a pool (K or V) into a warp's raw tile by
// 16-byte cp.async: nch chunks a row, consecutive lanes on consecutive
// chunks (coalesced); lane j holds position j's element offset src (-1:
// not read, zeros)
template <typename KV>
__device__ __forceinline__ void stage_async(const KV* __restrict__ pages,
                                            long long src,
                                            unsigned char* dst, int RS,
                                            int nch, int lane) {
  const int dj = 32 / nch, dc = 32 % nch;
  int j = lane / nch, c = lane - j * nch;
  for (int k = 0; k < nch; ++k) {    // warp-uniform: 32 * nch chunks
    const long long off = __shfl_sync(0xffffffffu, src, j);
    const unsigned char* from =
        reinterpret_cast<const unsigned char*>(pages + (off < 0 ? 0 : off));
    cp_async16(dst + j * RS + c * 16, from + c * 16, off >= 0);
    c += dc;
    j += dj;
    if (c >= nch) {
      c -= nch;
      ++j;
    }
  }
}

// the same for any D (rows not a multiple of 16 bytes, or pools not
// 16-byte aligned): byte by byte, zeros past the row to its last chunk
template <typename KV>
__device__ __forceinline__ void stage_bytes(const KV* __restrict__ pages,
                                            long long src,
                                            unsigned char* dst, int RS,
                                            int D, int lane) {
  const int rb = D * (int)sizeof(KV);
  const int rb16 = (rb + 15) / 16 * 16;
  for (int j = 0; j < kTile; ++j) {
    const long long off = __shfl_sync(0xffffffffu, src, j);
    const unsigned char* from =
        reinterpret_cast<const unsigned char*>(pages + (off < 0 ? 0 : off));
    for (int b = lane; b < rb16; b += 32)
      dst[j * RS + b] = off >= 0 && b < rb ? from[b] : 0;
  }
}

// N raw values at p (N * sizeof(KV) bytes, aligned to that size up to
// 16) widened to f32
template <typename KV, int N>
__device__ __forceinline__ void widen_n(const unsigned char* p, float* x) {
  constexpr int B = N * (int)sizeof(KV);
  if constexpr (B >= 16) {
#pragma unroll
    for (int u = 0; u < B / 16; ++u) {
      const int4 v = reinterpret_cast<const int4*>(p)[u];
      const KV* e = reinterpret_cast<const KV*>(&v);
#pragma unroll
      for (int i = 0; i < 16 / (int)sizeof(KV); ++i)
        x[u * (16 / (int)sizeof(KV)) + i] = to_f32(e[i]);
    }
  } else {
    using V = typename std::conditional<
        B == 8, int2, typename std::conditional<
                          B == 4, int, typename std::conditional<
                                           B == 2, short, char>::type>::type>::
        type;
    const V v = *reinterpret_cast<const V*>(p);
    const KV* e = reinterpret_cast<const KV*>(&v);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(e[i]);
  }
}

template <typename T, typename KV, int RB, int DC>
__global__ void __launch_bounds__(DecodeCfg<KV, DC>::W * 32)
ragged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                     const KV* __restrict__ v_pages,
                     const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     const int* __restrict__ page_tables,
                     const int* __restrict__ row_lens, T* __restrict__ out,
                     int Qb, int H, int D, int P, int M, float scale,
                     int fused, int vec) {
  using C = DecodeCfg<KV, DC>;
  constexpr int W = C::W, DP = C::DP, LDP = C::LDP, kPer = C::kPer;
  // partial sums a score keeps: a single row's dot runs as four chains
  constexpr int NA = RB == 1 ? 4 : 1;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  extern __shared__ __align__(16) unsigned char dc_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / CS;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * RB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int RS = decode_row_stride(D, (int)sizeof(KV));
  const int nch = (D * (int)sizeof(KV) + 15) / 16;

  float* q_s = reinterpret_cast<float*>(dc_smem);     // [RB][DP], pre-scaled
  float* cta = q_s + RB * DP;                          // [RB][LDP] merged
  unsigned char* tiles = reinterpret_cast<unsigned char*>(cta + RB * LDP);
  constexpr bool kShare = C::kShare;
  unsigned char* k_t = tiles + (size_t)warp * (kShare ? 1 : 2) * kTile * RS;
  unsigned char* v_t = kShare ? k_t : k_t + kTile * RS;     // [32][RS]

  // Positions past the page table (M * P) do not exist.  Lane j's slot in
  // tile t: its page's pool offset (-1: not read) and, for int8 pools, the
  // page's scales.  Looked up below M * P before the rows' lengths are
  // known (every table entry is a valid page id), and cut at the horizon
  // after.
  const int cap = M * P;
  const int* pt = page_tables + (size_t)g * M;
  const long long slot_stride = (long long)H * D;
  auto lookup = [&](int t, long long& src, float& ksl, float& vsl) {
    const int pos = t * kTile + lane;
    src = -1;
    ksl = vsl = 1.f;
    if (pos < cap) {
      const int page = pt[pos / P];
      src = ((long long)page * P + pos % P) * slot_stride + (long long)h * D;
      if constexpr (kQuant) {
        ksl = k_scales[(size_t)page * H + h];
        vsl = v_scales[(size_t)page * H + h];
      }
    }
  };
  const int stride = CS * W;            // workers a lane's walk is dealt to
  int t = rank * W + warp;              // this warp's first tile
  long long src;
  float ksl, vsl;
  lookup(t, src, ksl, vsl);

  // per-row horizons (in flight with the lookups); rows past Qb are empty
  int rl[RB];
  int horizon = 0;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int row = r0 + r;
    int len = row < Qb ? row_lens[(size_t)g * Qb + row] : 0;
    len = min(max(len, 0), cap);
    rl[r] = len;
    horizon = max(horizon, len);
  }
  // the CTAs with a tile to walk (rank 0 always: it writes the output)
  const int n_tiles = (horizon + kTile - 1) / kTile;
  const int busy = max(1, min(CS, (n_tiles + W - 1) / W));
  if (rank >= busy) {
    if (busy > 1) {                     // the busy ranks' two barriers
      cluster.sync();
      cluster.sync();
    }
    return;
  }
  for (int i = threadIdx.x; i < RB * DP; i += W * 32) {
    const int r = i / DP;
    const int d = i - r * DP;
    const int row = r0 + r;
    q_s[i] = row < Qb && d < D
                 ? to_f32(q[(((size_t)g * Qb + row) * H + h) * D + d]) * scale
                 : 0.f;
  }
  // a row's output from its merged state; an empty row has l == 0 and
  // acc == 0: exact zeros, as on the TPU
  auto write_row = [&](int row, const float* o, float lsum) {
    const float denom = fmaxf(lsum, 1e-30f);
    T* dst = out + (((size_t)g * Qb + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane * DC + c;
      if (d < D) store(dst + d, o[c] / denom);
    }
  };

  float m[RB], l[RB], acc[RB][DC];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // K and V of a tile into the warp's raw tiles, each its own cp.async group
  auto stage = [&](const KV* pages, long long from, unsigned char* dst) {
    if (vec) {
      stage_async(pages, from, dst, RS, nch, lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      stage_bytes(pages, from, dst, RS, D, lane);
    }
  };
  if (t < n_tiles) {                    // warp-uniform
    if (t * kTile + lane >= horizon) src = -1;
    stage(k_pages, src, k_t);
    if constexpr (!kShare) stage(v_pages, src, v_t);
  }
  __syncthreads();                      // q_s

  // The walk, pipelined: K(t + stride)'s copy goes out once K(t) is scored
  // and V(t + stride)'s once V(t) is used, so a tile's copy is in flight
  // while the one before it is computed.  cp.async groups complete in
  // order: K(t), V(t), K(t + stride), V(t + stride), ...
  for (; t < n_tiles; t += stride) {
    const int base = t * kTile;
    const int pos = base + lane;
    const bool more = t + stride < n_tiles;       // warp-uniform
    long long src_n = -1;
    float ksl_n = 1.f, vsl_n = 1.f;
    if (more) {
      lookup(t + stride, src_n, ksl_n, vsl_n);
      if ((t + stride) * kTile + lane >= horizon) src_n = -1;
    }
    if constexpr (kShare)                                     // K(t) landed
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();

    // lane j's scores: q . k_j over its raw row (K scaled per element when
    // fused_dequant is 0, the score after the dot when 1)
    float s[RB];
    {
      float sp[RB][NA];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int a = 0; a < NA; ++a) sp[r][a] = 0.f;
      const unsigned char* krow = k_t + lane * RS;
#pragma unroll 2
      for (int c = 0; c < nch; ++c) {
        float x[kPer];
        widen_n<KV, kPer>(krow + c * 16, x);
        if (kQuant && !fused) {
#pragma unroll
          for (int i = 0; i < kPer; ++i) x[i] *= ksl;
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4* qa =
              reinterpret_cast<const float4*>(q_s + r * DP + c * kPer);
#pragma unroll
          for (int u = 0; u < kPer / 4; ++u) {
            const float4 a = qa[u];
            const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& part_s = sp[r][(4 * u + e) % NA];
              part_s = fmaf(av[e], x[4 * u + e], part_s);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        s[r] = sp[r][0];
        if constexpr (NA == 4)
          s[r] = (sp[r][0] + sp[r][1]) + (sp[r][2] + sp[r][3]);
        if (kQuant && fused) s[r] *= ksl;   // dequant K after the dot
      }
    }
    // the K tile is free: V(t) takes it (one tile a warp), or K(t + stride)
    __syncwarp();                       // every lane has read its K row
    if constexpr (kShare)
      stage(v_pages, src, v_t);
    else if (more)
      stage(k_pages, src_n, k_t);

    // the online softmax a row; rows that see nothing of the tile skip it
    // (warp-uniform)
    float pv[RB];
    int jn[RB];
    int jmax = 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      jn[r] = max(0, min(kTile, rl[r] - base));
      jmax = max(jmax, jn[r]);
      pv[r] = 0.f;
      if (jn[r] == 0) continue;
      const bool valid = pos < rl[r];
      const float m_new = fmaxf(m[r], warp_max(valid ? s[r] : -INFINITY));
      const float alpha = expf(m[r] - m_new);
      const float p = valid ? expf(s[r] - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      // dequant V on the contribution, not on the denominator
      pv[r] = (kQuant && fused) ? p * vsl : p;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }
    const float vf = (kQuant && !fused) ? vsl : 1.f;

    if (!kShare && more)                // V(t) landed (K(t + stride) may not)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    // p.v over each row's visible prefix of the tile.  A lane whose
    // columns lie past D reads the row's last DC values instead (its sums
    // are never stored), so no read leaves the row.
    const unsigned char* vcol =
        v_t + min(lane * DC, RS / (int)sizeof(KV) - DC) * (int)sizeof(KV);
#pragma unroll 2
    for (int j = 0; j < jmax; ++j) {
      float v[DC];
      widen_n<KV, DC>(vcol + j * RS, v);
      if (kQuant && !fused) {
        const float vfj = __shfl_sync(0xffffffffu, vf, j);
#pragma unroll
        for (int c = 0; c < DC; ++c) v[c] *= vfj;
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (j < jn[r]) {
          const float pj = __shfl_sync(0xffffffffu, pv[r], j);
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pj, v[c], acc[r][c]);
        }
      }
    }
    // the V tile is free: K(t + stride) takes it (one tile a warp), or
    // V(t + stride)
    __syncwarp();                       // every lane is done with V(t)
    if (more) stage(kShare ? k_pages : v_pages, src_n, v_t);
    src = src_n;
    ksl = ksl_n;
    vsl = vsl_n;
  }

  // the CTA's state: its warps' states merged in warp order through shared
  // memory (the tiles are dead now)
  __syncthreads();
  float* part = reinterpret_cast<float*>(tiles);       // [W][RB][LDP]
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float* e = part + (size_t)(warp * RB + r) * LDP;
#pragma unroll
    for (int c = 0; c < DC; ++c) e[lane * DC + c] = acc[r][c];
    if (lane == 0) {
      e[DP] = m[r];
      e[DP + 1] = l[r];
    }
  }
  __syncthreads();
  for (int r = warp; r < RB; r += W) {
    float mx = kNegInf;
    for (int w = 0; w < W; ++w)
      mx = fmaxf(mx, part[(size_t)(w * RB + r) * LDP + DP]);
    float lsum = 0.f, o[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = 0.f;
    for (int w = 0; w < W; ++w) {
      const float* e = part + (size_t)(w * RB + r) * LDP;
      const float sc = expf(e[DP] - mx);
      lsum += e[DP + 1] * sc;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[c] += e[lane * DC + c] * sc;
    }
    if (busy == 1) {                    // the lane's state: write it
      const int row = r0 + r;
      if (row < Qb) write_row(row, o, lsum);
      continue;
    }
    float* dst = cta + r * LDP;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[lane * DC + c] = o[c];
    if (lane == 0) {
      dst[DP] = mx;
      dst[DP + 1] = lsum;
    }
  }
  if (busy == 1) return;

  // rank 0 merges the busy CTAs' states, in rank order, through
  // distributed shared memory; the second barrier keeps every CTA's
  // shared memory alive until it has read them
  cluster.sync();
  if (rank == 0) {
    for (int r = warp; r < RB; r += W) {
      const int row = r0 + r;
      if (row >= Qb) continue;
      float mx = kNegInf;
      for (int b = 0; b < busy; ++b)
        mx = fmaxf(mx, cluster.map_shared_rank(cta, b)[r * LDP + DP]);
      float lsum = 0.f, o[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) o[c] = 0.f;
      for (int b = 0; b < busy; ++b) {
        const float* e = cluster.map_shared_rank(cta, b) + r * LDP;
        const float sc = expf(e[DP] - mx);
        lsum += e[DP + 1] * sc;
#pragma unroll
        for (int c = 0; c < DC; ++c) o[c] += e[lane * DC + c] * sc;
      }
      write_row(row, o, lsum);
    }
  }
  cluster.sync();
}

// One launch of the decode form: grid (G * CS, H, ceil(Qb / RB)), a
// cluster of CS CTAs along x
template <typename T, typename KV, int RB, int DC>
int launch_decode_rb(const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* pt,
                     const void* rl, void* out, int G, int Qb, int H, int D,
                     int P, int M, int fused, cudaStream_t stream) {
  using C = DecodeCfg<KV, DC>;
  const int CS = decode_cluster(C::kF32, C::W, M, P);
  const size_t smem = decode_smem<KV, DC>(RB, D);
  const int vec = (D * (int)sizeof(KV)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto kern = ragged_decode_kernel<T, KV, RB, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G * CS, (unsigned)H,
                     (unsigned)((Qb + RB - 1) / RB));
  cfg.blockDim = dim3(C::W * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1;                // one CTA: no cluster launch
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(rl), static_cast<T*>(out), Qb, H, D, P, M,
      1.0f / sqrtf((float)D), fused, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int DC, int kMaxRB>
int launch_decode_dc(const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* pt,
                     const void* rl, void* out, int G, int Qb, int H, int D,
                     int P, int M, int fused, cudaStream_t s) {
  if (kMaxRB == 1 || decode_rows(Qb) == 1)
    return launch_decode_rb<T, KV, 1, DC>(q, k, v, ks, vs, pt, rl, out, G, Qb,
                                          H, D, P, M, fused, s);
  if constexpr (kMaxRB > 1) {
    if (decode_rows(Qb) == 4)
      return launch_decode_rb<T, KV, 4, DC>(q, k, v, ks, vs, pt, rl, out, G,
                                            Qb, H, D, P, M, fused, s);
    return launch_decode_rb<T, KV, 8, DC>(q, k, v, ks, vs, pt, rl, out, G,
                                          Qb, H, D, P, M, fused, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the decode form's launcher: q [G, Qb, H, D], row_lens [G, Qb], Qb < 16;
// kMaxRB 1 builds the one-row instances only (the per-row kernel)
template <typename T, typename KV, int kMaxRB = 8>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* pt,
                  const void* rl, void* out, int G, int Qb, int H, int D,
                  int P, int M, int fused, void* stream) {
  if (G <= 0 || Qb <= 0 || Qb > (kMaxRB == 1 ? 1 : kDecodeMaxRows) ||
      H <= 0 || P <= 0 || M <= 0 || D <= 0 || D > kMaxD || H > 65535 ||
      (long long)G * kDecodeMaxCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_decode_dc<T, KV, 1, kMaxRB>(q, k, v, ks, vs, pt, rl, out, G,
                                              Qb, H, D, P, M, fused, s);
  if (D <= 64)
    return launch_decode_dc<T, KV, 2, kMaxRB>(q, k, v, ks, vs, pt, rl, out, G,
                                              Qb, H, D, P, M, fused, s);
  if (D <= 128)
    return launch_decode_dc<T, KV, 4, kMaxRB>(q, k, v, ks, vs, pt, rl, out, G,
                                              Qb, H, D, P, M, fused, s);
  return launch_decode_dc<T, KV, 8, kMaxRB>(q, k, v, ks, vs, pt, rl, out, G,
                                            Qb, H, D, P, M, fused, s);
}

// the decode form's layout for (D, pool element size, Qb, M, P): the
// cluster's CTAs, a CTA's warps and its rows
__host__ __forceinline__ void decode_layout(int D, int item, int Qb, int M,
                                            int P, int* cs, int* warps,
                                            int* rows) {
  const int W = decode_warps(item == 4, D <= 32    ? 1
                                        : D <= 64  ? 2
                                        : D <= 128 ? 4
                                                   : 8);
  *cs = decode_cluster(item == 4, W, M, P);
  *warps = W;
  *rows = decode_rows(Qb);
}

}  // namespace
