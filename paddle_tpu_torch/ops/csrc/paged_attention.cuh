// The ragged paged-attention kernel for NVIDIA Hopper (sm_90a), shared by
// its two plain C interfaces: paged_attention.cu (the normalized context,
// bodies _ragged_kernel / _ragged_kernel_quant) and paged_attention_stats.cu
// (the stats form of a sequence shard, bodies _ragged_stats_kernel /
// _ragged_stats_kernel_quant).  What it computes, per lane g, query row r
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
// f32 or bf16; all arithmetic is f32.  This header holds the warp form of
// both; the stats form's prefill form (Qb >= 16) is in
// paged_attention_stats.cuh.
//
// Int8 pools carry one f32 scale per (page, head), k_scales / v_scales
// [N, H], and are widened to f32 as a tile is staged.  fused_dequant = 1
// (the default) scales a position's score by its page's K scale after
// the q.k dot — before the running max, so lse is the log-sum-exp of the
// dequantized logits — and its p.v contribution by its page's V scale
// (the softmax denominator l stays unscaled); fused_dequant = 0
// dequantizes K and V as they are staged, before the dots.  A tile of 32
// positions can span pages, so each lane holds the scales of its own
// position.  A NaN scale reaches every row that reads its page: the score
// turns NaN, and so do p, l and the accumulator (fmaxf drops a NaN from
// the running max, but p = exp(NaN - m) carries it on).
//
// What bounds it on an H100: bytes.  A decode row does 4*D flops per K/V
// position it reads (2*D*4 bytes in f32, 2*D bytes in int8), far below
// the card's flop-per-byte balance, so the time floor is the K/V page
// stream.  The design reads each page once per (lane, head, row tile) —
// every query row of the tile is scored against the staged tile — and
// stops at the longest row of the tile, so a lane's cost follows its real
// tokens, not the padded page-table width.  The stats form walks owned
// pages, not table positions: the block first compacts the lane's owned
// table entries below its horizon into a list in shared memory
// (own_list), and its 32-position tiles are tiles of that compacted walk,
// so a shard reads and scores only what it owns, whatever the ownership
// pattern (every second page costs what a run of half the pages costs).
// Prefill chunks (many rows per lane) are split into
// row tiles of up to 8 rows; their repeated page reads hit L2.  Int8 rows
// load as 16-byte vectors (D / 16 lanes per row) when D is a multiple of
// 16, else byte by byte.
//
// Head dims: D <= 256, in instances of DC = 1, 2, 4 or 8 output columns a
// lane (D <= 32 DC).  Up to DC 4 a warp stages its K and V tiles side by
// side.  At DC 8 (D 129-256) two tiles of 32 x 257 floats a warp would
// take 263 KB a block, more than the 227 KB an SM gives one, so K and V
// share one tile: K is staged and scored, then V overwrites it.
//
// Layout of the work (the TPU kernel's sequential page axis becomes a
// loop inside the block):
//   grid  = (G lanes, H heads, ceil(Qb / RB) row tiles)
//   block = 4 warps.  Warp w walks the 32-position KV tiles w, w+4, ...
//           of the block's horizon (stats form: of its compacted owned
//           positions); lane j of the warp owns position j of the tile
//           for the q.k scores and D/32 output columns for p.v.
//   Each warp keeps an online softmax (running max m, denominator l, f32
//   accumulator) per row, skips tiles a row cannot see, and the four
//   warps' partial states merge through shared memory at the end; the
//   stats form writes lse after that merge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;             // KV positions per warp tile
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

// KV is T (f32 / bf16 pools) or int8_t (pools with [N, H] scales); kStats
// adds the page_ok mask [G, M] and the lse output [G, Qb, H]
template <typename T, typename KV, int RB, int DC, bool kStats>
__global__ void __launch_bounds__(kWarps * 32)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const KV* __restrict__ k_pages,
                              const KV* __restrict__ v_pages,
                              const float* __restrict__ k_scales,
                              const float* __restrict__ v_scales,
                              const int* __restrict__ page_tables,
                              const int* __restrict__ row_lens,
                              const int* __restrict__ page_ok,
                              T* __restrict__ out, float* __restrict__ lse,
                              int Qb, int H, int D, int P, int M, float scale,
                              int fused, int vec) {
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
  // positions walked: the horizon, or (stats form) the owned positions
  // below it, compacted
  int n_walk = horizon;
  if constexpr (kStats)
    n_walk = own_list<kWarps * 32>(pt, page_ok + (size_t)g * M, horizon, P,
                                   own_m, own_page, own_page + M);
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
    // ``own``: this lane's position exists below the horizon — only then
    // is it read.  ``first``: the tile's first position (warp-uniform)
    bool own = pos < horizon;
    int first = base;
    if constexpr (kStats) {
      // base and pos count compacted owned positions: pos becomes the
      // lane's original position, which every visibility test reads
      own = pos < n_walk;
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
      first = __shfl_sync(0xffffffffu, pos, 0);
    } else if (own) {
      const int page = pt[pos / P];
      src = ((long long)page * P + (pos % P)) * slot_stride +
            (long long)h * D;
      if constexpr (kQuant) {
        ksl = k_scales[(size_t)page * H + h];
        vsl = v_scales[(size_t)page * H + h];
      }
    }
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
      int jn;
      if constexpr (kStats)
        jn = __popc(__ballot_sync(0xffffffffu, valid));
      else
        jn = min(kTile, rl[r] - base);
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
    if constexpr (kStats) {
      // the merged stats: a row with nothing visible (or a NaN sum, as
      // the TPU kernel's ``l > 0`` test reads it) gets the finite NEG_INF,
      // so a shard merge weighs it exp(-1e30 - M) = 0, never NaN
      if (lane == 0) lse[at] = lsum > 0.f ? mx + logf(lsum) : kNegInf;
    }
  }
}

template <typename T, typename KV, int RB, int DC, bool kStats>
int launch_rb(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* pt, const void* rl, const void* ok,
              void* out, void* lse, int G, int Qb, int H, int D, int P,
              int M, int fused, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const int ldv = kQuant ? D + 1 : D;
  // a warp's tiles a row: K's and V's, or (DC 8) the one they share
  const int ld_kv = DC == 8 ? D + 1 : D + 1 + ldv;
  size_t smem = ((size_t)RB * D +
                 (size_t)kWarps * kTile * ld_kv) * sizeof(float);
  if constexpr (kStats) smem += (size_t)(2 * M + kWarps) * sizeof(int);
  const int vec = kQuant && D % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto kern = ragged_paged_attention_kernel<T, KV, RB, DC, kStats>;
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

// rows per block: 1 for decode lanes, 8 for prefill chunks (registers
// hold RB * DC accumulators per lane)
template <typename T, typename KV, int DC, bool kStats>
int launch_dc(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* pt, const void* rl, const void* ok,
              void* out, void* lse, int G, int Qb, int H, int D, int P,
              int M, int fused, cudaStream_t s) {
  if (Qb <= 1)
    return launch_rb<T, KV, 1, DC, kStats>(q, k, v, ks, vs, pt, rl, ok, out,
                                           lse, G, Qb, H, D, P, M, fused, s);
  if (Qb <= 4)
    return launch_rb<T, KV, 4, DC, kStats>(q, k, v, ks, vs, pt, rl, ok, out,
                                           lse, G, Qb, H, D, P, M, fused, s);
  return launch_rb<T, KV, 8, DC, kStats>(q, k, v, ks, vs, pt, rl, ok, out,
                                         lse, G, Qb, H, D, P, M, fused, s);
}

template <typename T, typename KV, bool kStats>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* rl, const void* ok,
           void* out, void* lse, int G, int Qb, int H, int D, int P, int M,
           int fused, void* stream) {
  if (G <= 0 || Qb <= 0 || H <= 0 || P <= 0 || M <= 0 || D <= 0 ||
      D > kMaxD || H > 65535 || Qb > 8 * 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dc<T, KV, 1, kStats>(q, k, v, ks, vs, pt, rl, ok, out, lse,
                                       G, Qb, H, D, P, M, fused, s);
  if (D <= 64)
    return launch_dc<T, KV, 2, kStats>(q, k, v, ks, vs, pt, rl, ok, out, lse,
                                       G, Qb, H, D, P, M, fused, s);
  if (D <= 128)
    return launch_dc<T, KV, 4, kStats>(q, k, v, ks, vs, pt, rl, ok, out, lse,
                                       G, Qb, H, D, P, M, fused, s);
  return launch_dc<T, KV, 8, kStats>(q, k, v, ks, vs, pt, rl, ok, out, lse, G,
                                     Qb, H, D, P, M, fused, s);
}

}  // namespace
