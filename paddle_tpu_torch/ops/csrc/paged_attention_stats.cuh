// The prefill form of the paged kernels (Qb >= 16 rows a lane: the stats
// kernel's bodies #3 / #3q and the ragged kernel's #1 / #1q), for NVIDIA
// Hopper (sm_90a), and the launchers that pick a form by Qb: the stats
// form's (this form or the warp form of paged_attention.cuh) and the
// ragged kernel's (this form or the decode form).  It computes what
// paged_attention.cuh describes: for the stats kernel (kOwned) the context
// over the visible owned positions, lse = m + log(l), -1e30 and exact
// zeros for a row with nothing visible; for #1 the context over every
// position below a row's length, exact zeros for a row with nothing
// visible; fused_dequant as described there.
//
// What bounds it on an H100.  A prefill row tile does 4*D flops per
// position and row, and its K/V bytes are shared by every row of the
// tile, so at 16 rows a tile it is bound by operations on the CUDA cores
// (f32 pools pin the result to 1e-6, so TF32 and bf16 tensor cores are
// out).  The warp form reaches a fraction of that: every warp stages its
// own 32-position tile with scalar loads, each 8-row block stages the
// lane's K/V again, and its inner loops issue about one shared load per
// FMA.  And a shard's prefill grid is small (G x H x Qb/16 blocks, the
// longest lanes' blocks walking many tiles), so a block runs with few
// warps beside it on its SM: each warp's latency is exposed.  This form:
//   - walks only the owned positions below the block's horizon, compacted
//     by own_list (paged_attention.cuh), so a shard reads and scores only
//     what it owns;
//   - stages each tile of TK compacted positions once per block, by
//     16-byte cp.async into a two-stage ring (the next tile's copy is in
//     flight while this one is scored); bf16 and int8 tiles land as raw
//     bytes and are widened to f32 in shared memory, int8 with each
//     position's page scales copied beside it (fused_dequant 0 multiplies
//     them in there);
//   - runs 8 warps in 4 groups of 64 threads, and register-tiles both
//     products with 4 x 4 micro-tiles: each group computes S = Q K^T over
//     a quarter of D (float4 loads of a pre-scaled, padded Q tile and of
//     K: 8 FMAs a shared load), and O += P V over a quarter of the tile's
//     positions (a float4 of P^T and of V: 8 FMAs a load at D 64); the
//     groups' partial scores add up in the softmax, their accumulators
//     once at the end (they share each row's max and alpha).  Row strides
//     of LD = 32*DC + 4 floats keep the float4 loads free of bank
//     conflicts;
//   - runs the online softmax with one running max and denominator a row,
//     a row on 16 lanes of one warp (reductions by 4 shuffles).
// Without kOwned (#1) the walk is the lane's table below the block's
// horizon, one position per table position, and M is not bounded.
// Head dims: D <= 256 in instances of DC = 1, 2, 4 or 8 (D <= 32 DC).
// Tiles hold TK = 64 compacted positions up to DC 2, 32 at DC 4 and
// kPfTk8 at DC 8, where a 32-position f32 ring takes 165 KB: one block an
// SM, so that instance's launch bounds ask for one block, not two.
// What a row does not see is removed by select, never multiplied by
// zero: score -inf, p = 0, and no p.v term (the visible positions of a
// tile are a prefix, and the P.V loop stops at each row's count), so a
// NaN stored at a position a row does not see never reaches it.
//
// Layout:
//   grid  = (G lanes, H heads, ceil(Qb / 16) row tiles)
//   block = 8 warps, 16 query rows.  A tile: metadata (original
//           position, page, pool offset) of each compacted position,
//           written two tiles ahead; the copy one tile ahead; then the
//           partial scores (registers -> shared), the softmax (shared
//           P^T, per-row alpha and visible count), P.V into registers.
#pragma once

#include "paged_attention.cuh"

namespace {

constexpr int kStatsMaxPages = 4096;  // pages_per_seq: the compacted list
constexpr int kPrefillRows = 16;      // rows a block; Qb >= this takes it
constexpr int kPfGroups = 4;          // 64-thread groups a block
constexpr int kPfThreads = 64 * kPfGroups;
constexpr int kPfTk8 = 32;            // compacted positions a tile at DC 8

template <int DC>
struct PfCfg {
  // compacted positions a tile
  static constexpr int TK = DC <= 2 ? 64 : DC == 4 ? 32 : kPfTk8;
  static constexpr int DP = 32 * DC;            // columns computed
  static constexpr int LD = DP + 4;             // f32 row stride, LD/4 odd
  static constexpr int SP = TK / 16;            // S: 4 rows x SP positions
  static constexpr int LPR = 4 * kPfGroups;     // softmax: lanes a row
  static constexpr int LDS = TK + LPR;          // S row stride
  static constexpr int LDP = kPrefillRows + 4;  // P^T row stride
  // P.V: float4 columns a thread
  static constexpr int PC = DC == 8 ? 4 : DC == 4 ? 2 : 1;
  static constexpr int NCG = 8 * DC / PC;       // P.V: column groups
  static constexpr int PR = kPrefillRows * NCG / 64;  // P.V: rows a thread
  static constexpr int JG = TK / kPfGroups;     // P.V: positions a group
  // resident blocks an SM the launch bounds ask for
  static constexpr int kMinBlocks = DC == 8 && TK == 32 ? 1 : 2;
};

// the block's shared memory: raw K/V rings (bf16, int8), then f32, then
// the 8-byte pool offsets, then ints (the compacted list last, [M] x 2)
template <typename KV, int DC>
struct PfSmem {
  using C = PfCfg<DC>;
  static constexpr bool kF32 = std::is_same<KV, float>::value;
  static constexpr int NF = kF32 ? 2 : 1;  // f32 tiles: the ring, or one
  // the K/V tiles' area, which also holds the groups' accumulators for
  // the merge at the end
  static constexpr int kTiles = 2 * NF * C::TK * C::LD;
  static constexpr int kMerge = kPfGroups * kPrefillRows * C::DP;
  static constexpr int kKV = kTiles > kMerge ? kTiles : kMerge;
  static constexpr int kFloats =
      kPrefillRows * C::LD + kKV + kPfGroups * kPrefillRows * C::LDS +
      C::TK * C::LDP + 4 * C::TK + 3 * kPrefillRows;
  static constexpr int kFloatsPad = (kFloats + 1) & ~1;

  static __host__ __device__ size_t raw_bytes(int D) {   // one of K, V
    return kF32 ? 0 : (size_t)2 * C::TK * D * sizeof(KV);
  }
  static __host__ __device__ size_t bytes(int D, int M) {
    return 2 * raw_bytes(D) + (size_t)kFloatsPad * sizeof(float) +
           (size_t)2 * C::TK * sizeof(long long) +
           (size_t)(4 * C::TK + 2 * kPrefillRows + 8 + 2 * M) * sizeof(int);
  }

  unsigned char *raw_k, *raw_v;
  float *q, *kf, *vf, *S, *P, *ksc, *vsc, *alpha, *m_fin, *l_fin;
  long long* off;
  int *pos, *pg, *rl, *nv, *wsum, *own_m, *own_page;

  __device__ PfSmem(unsigned char* base, int D, int M) {
    raw_k = base;
    raw_v = base + raw_bytes(D);
    float* f0 = reinterpret_cast<float*>(base + 2 * raw_bytes(D));
    float* f = f0;
    q = f;      f += kPrefillRows * C::LD;   // [16][LD], pre-scaled
    kf = f;                                  // [NF][TK][LD]
    vf = f + NF * C::TK * C::LD;
    f += kKV;
    S = f;      f += kPfGroups * kPrefillRows * C::LDS;  // [groups][16][LDS]
    P = f;      f += C::TK * C::LDP;         // [TK][LDP] p^T (times V scale)
    ksc = f;    f += 2 * C::TK;              // [2][TK] page scales
    vsc = f;    f += 2 * C::TK;
    alpha = f;  f += kPrefillRows;
    m_fin = f;  f += kPrefillRows;
    l_fin = f;
    off = reinterpret_cast<long long*>(f0 + kFloatsPad);  // [2][TK]
    int* i = reinterpret_cast<int*>(off + 2 * C::TK);
    pos = i;      i += 2 * C::TK;            // [2][TK] original positions
    pg = i;       i += 2 * C::TK;            // [2][TK] pages (-1: none)
    rl = i;       i += kPrefillRows;
    nv = i;       i += kPrefillRows;         // visible positions of a tile
    wsum = i;     i += 8;
    own_m = i;    i += M;
    own_page = i;
  }
};

// The form's body.  kOwned (the stats kernel, #3 / #3q) walks the owned
// positions and writes lse; without it (#1 / #1q, Qb >= 16) the walk is
// the lane's table below the block's horizon, no page_ok is read, no
// owned list is built or allocated and no lse is written.
template <typename T, typename KV, int DC, bool kOwned>
__device__ __forceinline__ void prefill_body(
    const T* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ page_tables,
    const int* __restrict__ row_lens, const int* __restrict__ page_ok,
    T* __restrict__ out, float* __restrict__ lse, int Qb, int H, int D,
    int P, int M, float scale, int fused, int vec) {
  using C = PfCfg<DC>;
  using SM = PfSmem<KV, DC>;
  constexpr int TK = C::TK, LD = C::LD, RT = kPrefillRows;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr bool kF32 = SM::kF32;
  constexpr int kNoPos = 0x7fffffff;
  extern __shared__ __align__(16) unsigned char pf_smem[];
  SM sm(pf_smem, D, kOwned ? M : 0);

  const int g = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * RT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = tid >> 6;        // the thread's group
  const int tg = tid & 63;         // its thread in the group
  const int cap = M * P;
  const int* pt_g = page_tables + (size_t)g * M;
  const int* ok_g = kOwned ? page_ok + (size_t)g * M : nullptr;

  // the lane's first table entries into L1 while the rows load: the
  // ownership scan below then finds them there
  if (tid < M) {
    if constexpr (kOwned)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(ok_g + tid));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(pt_g + tid));
  }
  if (tid < RT) {
    const int row = r0 + tid;
    const int len = row < Qb ? row_lens[(size_t)g * Qb + row] : 0;
    sm.rl[tid] = min(max(len, 0), cap);
  }
  {
    // every load in flight before the first store
    constexpr int kQPer = (RT * LD + kPfThreads - 1) / kPfThreads;
    float qv[kQPer];
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      const int i = tid + u * kPfThreads;
      const int r = i / LD;
      const int d = i - r * LD;
      const int row = r0 + r;
      qv[u] = r < RT && row < Qb && d < D
                  ? to_f32(q[(((size_t)g * Qb + row) * H + h) * D + d]) * scale
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      const int i = tid + u * kPfThreads;
      if (i < RT * LD) sm.q[i] = qv[u];
    }
  }
  __syncthreads();
  int horizon = 0;
#pragma unroll
  for (int r = 0; r < RT; ++r) horizon = max(horizon, sm.rl[r]);
  int n_walk = horizon;
  if constexpr (kOwned)
    n_walk = own_list<kPfThreads>(pt_g, ok_g, horizon, P, sm.own_m,
                                  sm.own_page, sm.wsum);
  const int n_tiles = (n_walk + TK - 1) / TK;

  // tile t's metadata into slot t & 1: a thread a compacted position
  auto meta = [&](int t) {
    if (tid < TK) {
      const int c = t * TK + tid;
      const int at = (t & 1) * TK + tid;
      int p = kNoPos, page = -1;
      long long o = -1;
      if (c < n_walk) {
        const int e = c / P;
        const int slot = c - e * P;
        if constexpr (kOwned) {
          page = sm.own_page[e];
          p = sm.own_m[e] * P + slot;
        } else {
          page = pt_g[e];
          p = c;
        }
        o = ((long long)page * P + slot) * H * D + (long long)h * D;
      }
      sm.pos[at] = p;
      sm.pg[at] = page;
      sm.off[at] = o;
    }
  };

  // 16-byte chunks: thread tid copies chunk st_ch of rows st_row0 + u
  // RPP (CPR chunks a row of DP columns; those past D are not copied)
  constexpr int CPR = C::DP * (int)sizeof(KV) / 16;
  constexpr int RPP = kPfThreads / CPR;
  constexpr int kStRows = (TK + RPP - 1) / RPP;
  const int rowbytes = D * (int)sizeof(KV);
  const int st_row0 = tid / CPR;
  const int st_ch = tid % CPR;
  const bool st_on = vec && st_ch < (rowbytes >> 4);
  constexpr int kPerChunk = 16 / (int)sizeof(KV);

  auto issue = [&](int t) {
    const int sl = t & 1;
    if (st_on) {
#pragma unroll
      for (int u = 0; u < kStRows; ++u) {
        const int j = st_row0 + u * RPP;
        if (j >= TK) break;
        const long long o = sm.off[sl * TK + j];
        const bool ok = o >= 0;
        const size_t src = (size_t)(ok ? o : 0) + (size_t)st_ch * kPerChunk;
        void *dk, *dv;
        if constexpr (kF32) {
          dk = sm.kf + ((size_t)sl * TK + j) * LD + st_ch * 4;
          dv = sm.vf + ((size_t)sl * TK + j) * LD + st_ch * 4;
        } else {
          dk = sm.raw_k + ((size_t)sl * TK + j) * rowbytes + st_ch * 16;
          dv = sm.raw_v + ((size_t)sl * TK + j) * rowbytes + st_ch * 16;
        }
        cp_async16(dk, k_pages + src, ok);
        cp_async16(dv, v_pages + src, ok);
      }
    }
    if constexpr (kQuant) {   // the page scales beside their positions
      if (tid < TK) {
        const int page = sm.pg[sl * TK + tid];
        const size_t at = page >= 0 ? (size_t)page * H + h : 0;
        cp_async4(sm.ksc + sl * TK + tid, k_scales + at, page >= 0);
        cp_async4(sm.vsc + sl * TK + tid, v_scales + at, page >= 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // tile t into the f32 tiles kt / vt: widen the raw ring (vec), or load
  // element by element (any D; zeros past D and for absent positions)
  auto stage = [&](int t, float* kt, float* vt) {
    const int sl = t & 1;
    if (vec) {
      if constexpr (!kF32) {
        if (st_on) {
#pragma unroll
          for (int u = 0; u < kStRows; ++u) {
            const int j = st_row0 + u * RPP;
            if (j >= TK) break;
            const float kfac = kQuant && !fused ? sm.ksc[sl * TK + j] : 1.f;
            const float vfac = kQuant && !fused ? sm.vsc[sl * TK + j] : 1.f;
            const size_t at = ((size_t)sl * TK + j) * rowbytes + st_ch * 16;
            const int4 kr = *reinterpret_cast<const int4*>(sm.raw_k + at);
            const int4 vr = *reinterpret_cast<const int4*>(sm.raw_v + at);
            float* kd = kt + j * LD + st_ch * kPerChunk;
            float* vd = vt + j * LD + st_ch * kPerChunk;
            if constexpr (kQuant) {
              float kw[16], vw[16];
              unpack16(kr, kw, kfac);
              unpack16(vr, vw, vfac);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                reinterpret_cast<float4*>(kd)[u] = make_float4(
                    kw[4 * u], kw[4 * u + 1], kw[4 * u + 2], kw[4 * u + 3]);
                reinterpret_cast<float4*>(vd)[u] = make_float4(
                    vw[4 * u], vw[4 * u + 1], vw[4 * u + 2], vw[4 * u + 3]);
              }
            } else {
              const __nv_bfloat16* kb =
                  reinterpret_cast<const __nv_bfloat16*>(&kr);
              const __nv_bfloat16* vb =
                  reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                reinterpret_cast<float4*>(kd)[u] = make_float4(
                    to_f32(kb[4 * u]), to_f32(kb[4 * u + 1]),
                    to_f32(kb[4 * u + 2]), to_f32(kb[4 * u + 3]));
                reinterpret_cast<float4*>(vd)[u] = make_float4(
                    to_f32(vb[4 * u]), to_f32(vb[4 * u + 1]),
                    to_f32(vb[4 * u + 2]), to_f32(vb[4 * u + 3]));
              }
            }
          }
        }
      }
    } else {
      if constexpr (kQuant) {
        if (tid < TK) {
          const int page = sm.pg[sl * TK + tid];
          sm.ksc[sl * TK + tid] = page >= 0 ? k_scales[(size_t)page * H + h]
                                            : 0.f;
          sm.vsc[sl * TK + tid] = page >= 0 ? v_scales[(size_t)page * H + h]
                                            : 0.f;
        }
        __syncthreads();
      }
      for (int j = warp; j < TK; j += kPfThreads / 32) {
        const long long o = sm.off[sl * TK + j];
        const float kfac = kQuant && !fused ? sm.ksc[sl * TK + j] : 1.f;
        const float vfac = kQuant && !fused ? sm.vsc[sl * TK + j] : 1.f;
        for (int d = lane; d < C::DP; d += 32) {
          const bool ok = o >= 0 && d < D;
          kt[j * LD + d] = ok ? to_f32(k_pages[o + d]) * kfac : 0.f;
          vt[j * LD + d] = ok ? to_f32(v_pages[o + d]) * vfac : 0.f;
        }
      }
    }
  };

  // S layout: group grp, rows srg + 4 i, positions spg + 16 k, its
  // quarter of D
  const int srg = tg & 3;
  const int spg = tg >> 2;
  const int d4n = (D + 3) >> 2;
  const int d4a = grp * d4n / kPfGroups;
  const int d4b = (grp + 1) * d4n / kPfGroups;
  // softmax layout: row srow on LPR lanes of its warp, positions
  // lj + LPR k
  constexpr int LPR = C::LPR;
  const int srow = warp * (32 / LPR) + lane / LPR;
  const int lj = lane % LPR;
  // P.V layout: group grp, rows rg * PR + i, float4 columns
  // cg + NCG p, positions [grp JG, grp JG + JG)
  const int cg = tg % C::NCG;
  const int rg = tg / C::NCG;
  const int j0 = grp * C::JG;

  float m_run = kNegInf, l_run = 0.f;
  float acc[C::PR][4 * C::PC];
#pragma unroll
  for (int i = 0; i < C::PR; ++i)
#pragma unroll
    for (int c = 0; c < 4 * C::PC; ++c) acc[i][c] = 0.f;

  if (n_tiles > 0) meta(0);
  if (n_tiles > 1) meta(1);
  __syncthreads();
  if (vec && n_tiles > 0) issue(0);

  for (int t = 0; t < n_tiles; ++t) {
    const int sl = t & 1;
    if (vec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                 // tile t landed; tile t - 1 is done
    if (vec && t + 1 < n_tiles) issue(t + 1);
    float* kt = sm.kf + (kF32 ? sl : 0) * TK * LD;
    float* vt = sm.vf + (kF32 ? sl : 0) * TK * LD;
    if (!kF32 || !vec) {
      stage(t, kt, vt);
      __syncthreads();
    }

    // the group's partial scores (Q scale) K^T over its quarter of D
    {
      float s[4][C::SP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < C::SP; ++k) s[i][k] = 0.f;
      const float* qa = sm.q + srg * LD;
      const float* kb = kt + spg * LD;
#pragma unroll 2
      for (int d4 = d4a; d4 < d4b; ++d4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = reinterpret_cast<const float4*>(qa + 4 * i * LD)[d4];
#pragma unroll
        for (int k = 0; k < C::SP; ++k) {
          const float4 x =
              reinterpret_cast<const float4*>(kb + 16 * k * LD)[d4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][k] = fmaf(a[i].x, x.x, s[i][k]);
            s[i][k] = fmaf(a[i].y, x.y, s[i][k]);
            s[i][k] = fmaf(a[i].z, x.z, s[i][k]);
            s[i][k] = fmaf(a[i].w, x.w, s[i][k]);
          }
        }
      }
      float* sg = sm.S + grp * RT * C::LDS;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < C::SP; ++k)
          sg[(srg + 4 * i) * C::LDS + spg + 16 * k] = s[i][k];
    }
    __syncthreads();

    // the online softmax: the groups' partial scores summed in group
    // order, then the K scale (fused) and the mask, by select
    {
      const int rlr = sm.rl[srow];
      constexpr int kPer = TK / LPR;
      float sv[kPer];
      bool vis[kPer];
      float mx = -INFINITY;
      int nvis = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = lj + LPR * k;
        float x = sm.S[srow * C::LDS + j];
#pragma unroll
        for (int gg = 1; gg < kPfGroups; ++gg)
          x += sm.S[(gg * RT + srow) * C::LDS + j];
        if (kQuant && fused) x *= sm.ksc[sl * TK + j];
        vis[k] = sm.pos[sl * TK + j] < rlr;
        sv[k] = x;
        mx = fmaxf(mx, vis[k] ? x : -INFINITY);
        nvis += vis[k];
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        nvis += __shfl_xor_sync(0xffffffffu, nvis, o);
      }
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = lj + LPR * k;
        const float p = vis[k] ? expf(sv[k] - m_new) : 0.f;
        psum += p;
        // the V scale on the p.v term, not on the denominator
        const float pv = kQuant && fused ? p * sm.vsc[sl * TK + j] : p;
        sm.P[j * C::LDP + srow] = vis[k] ? pv : 0.f;
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      if (lj == 0) {
        sm.alpha[srow] = alpha;
        sm.nv[srow] = nvis;
      }
    }
    __syncthreads();
    // slot sl is free for tile t + 2's metadata (read after the next
    // iteration's first barrier)
    if (t + 2 < n_tiles) meta(t + 2);

    // O = O alpha + P V over the group's positions of each row's
    // visible prefix
    {
      int nvr[C::PR];
      int lo = TK, hi = 0;
#pragma unroll
      for (int i = 0; i < C::PR; ++i) {
        const int rr = rg * C::PR + i;
        const float a = sm.alpha[rr];
        nvr[i] = sm.nv[rr];
        lo = min(lo, nvr[i]);
        hi = max(hi, nvr[i]);
#pragma unroll
        for (int c = 0; c < 4 * C::PC; ++c) acc[i][c] *= a;
      }
      const int ja = min(lo, j0 + C::JG);
      const int jb = min(hi, j0 + C::JG);
      const float* vc = vt + 4 * cg;
      const float* pc = sm.P + rg * C::PR;
#pragma unroll 4
      for (int j = j0; j < ja; ++j) {
        float p[C::PR];
        if constexpr (C::PR == 4) {
          const float4 x = *reinterpret_cast<const float4*>(pc + j * C::LDP);
          p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(pc + j * C::LDP);
          p[0] = x.x; p[1] = x.y;
        }
#pragma unroll
        for (int pp = 0; pp < C::PC; ++pp) {
          const float4 v =
              *reinterpret_cast<const float4*>(vc + j * LD + 4 * C::NCG * pp);
#pragma unroll
          for (int i = 0; i < C::PR; ++i) {
            acc[i][4 * pp + 0] = fmaf(p[i], v.x, acc[i][4 * pp + 0]);
            acc[i][4 * pp + 1] = fmaf(p[i], v.y, acc[i][4 * pp + 1]);
            acc[i][4 * pp + 2] = fmaf(p[i], v.z, acc[i][4 * pp + 2]);
            acc[i][4 * pp + 3] = fmaf(p[i], v.w, acc[i][4 * pp + 3]);
          }
        }
      }
      for (int j = max(ja, j0); j < jb; ++j) {   // the diagonal: rows end apart
#pragma unroll
        for (int pp = 0; pp < C::PC; ++pp) {
          const float4 v =
              *reinterpret_cast<const float4*>(vc + j * LD + 4 * C::NCG * pp);
#pragma unroll
          for (int i = 0; i < C::PR; ++i) {
            if (j < nvr[i]) {
              const float p = pc[j * C::LDP + i];
              acc[i][4 * pp + 0] = fmaf(p, v.x, acc[i][4 * pp + 0]);
              acc[i][4 * pp + 1] = fmaf(p, v.y, acc[i][4 * pp + 1]);
              acc[i][4 * pp + 2] = fmaf(p, v.z, acc[i][4 * pp + 2]);
              acc[i][4 * pp + 3] = fmaf(p, v.w, acc[i][4 * pp + 3]);
            }
          }
        }
      }
    }
  }

  // epilogue: the groups' accumulators summed in group order (in the K/V
  // tiles, dead now); o = acc / max(l, 1e-30); lse = m + log(l), -1e30
  // unless l > 0 (a NaN l too, as the TPU kernel's ``l > 0`` reads it)
  __syncthreads();
  float* merge = sm.kf;                        // [groups][16][DP]
#pragma unroll
  for (int i = 0; i < C::PR; ++i)
#pragma unroll
    for (int pp = 0; pp < C::PC; ++pp)
      *reinterpret_cast<float4*>(
          merge + (grp * RT + rg * C::PR + i) * C::DP + 4 * (cg + C::NCG * pp)) =
          make_float4(acc[i][4 * pp], acc[i][4 * pp + 1], acc[i][4 * pp + 2],
                      acc[i][4 * pp + 3]);
  if (lj == 0) {
    sm.m_fin[srow] = m_run;
    sm.l_fin[srow] = l_run;
    const int row = r0 + srow;
    if (kOwned && row < Qb)
      lse[((size_t)g * Qb + row) * H + h] =
          l_run > 0.f ? m_run + logf(l_run) : kNegInf;
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < C::PR; ++i) {
      const int rr = rg * C::PR + i;
      const int row = r0 + rr;
      if (row >= Qb) continue;
      const float den = fmaxf(sm.l_fin[rr], 1e-30f);
      T* dst = out + (((size_t)g * Qb + row) * H + h) * D;
#pragma unroll
      for (int pp = 0; pp < C::PC; ++pp) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 4 * (cg + C::NCG * pp) + c;
          float o = merge[rr * C::DP + col];
#pragma unroll
          for (int gg = 1; gg < kPfGroups; ++gg)
            o += merge[(gg * RT + rr) * C::DP + col];
          if (col < D) store(dst + col, o / den);
        }
      }
    }
  }
}

template <typename T, typename KV, int DC>
__global__ void __launch_bounds__(kPfThreads, PfCfg<DC>::kMinBlocks)
stats_prefill_kernel(const T* __restrict__ q,
                     const KV* __restrict__ k_pages,
                     const KV* __restrict__ v_pages,
                     const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     const int* __restrict__ page_tables,
                     const int* __restrict__ row_lens,
                     const int* __restrict__ page_ok, T* __restrict__ out,
                     float* __restrict__ lse, int Qb, int H, int D, int P,
                     int M, float scale, int fused, int vec) {
  prefill_body<T, KV, DC, true>(q, k_pages, v_pages, k_scales, v_scales,
                                page_tables, row_lens, page_ok, out, lse, Qb,
                                H, D, P, M, scale, fused, vec);
}

// #1 / #1q at Qb >= 16: the same form over the lane's whole table
// (page_ok and lse are not read: null)
template <typename T, typename KV, int DC>
__global__ void __launch_bounds__(kPfThreads, PfCfg<DC>::kMinBlocks)
ragged_prefill_kernel(const T* __restrict__ q,
                      const KV* __restrict__ k_pages,
                      const KV* __restrict__ v_pages,
                      const float* __restrict__ k_scales,
                      const float* __restrict__ v_scales,
                      const int* __restrict__ page_tables,
                      const int* __restrict__ row_lens,
                      const int* __restrict__ page_ok, T* __restrict__ out,
                      float* __restrict__ lse, int Qb, int H, int D, int P,
                      int M, float scale, int fused, int vec) {
  prefill_body<T, KV, DC, false>(q, k_pages, v_pages, k_scales, v_scales,
                                 page_tables, row_lens, nullptr, out,
                                 nullptr, Qb, H, D, P, M, scale, fused, vec);
}

template <typename T, typename KV, int DC, bool kOwned>
int launch_prefill(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* pt,
                   const void* rl, const void* ok, void* out, void* lse,
                   int G, int Qb, int H, int D, int P, int M, int fused,
                   cudaStream_t stream) {
  const size_t smem = PfSmem<KV, DC>::bytes(D, kOwned ? M : 0);
  const int vec = (D * (int)sizeof(KV)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((unsigned)G, (unsigned)H,
                  (unsigned)((Qb + kPrefillRows - 1) / kPrefillRows));
  // the stats kernel's wrapper or #1's; only the one picked is built
  auto kern = [] {
    if constexpr (kOwned)
      return stats_prefill_kernel<T, KV, DC>;
    else
      return ragged_prefill_kernel<T, KV, DC>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kPfThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(rl), static_cast<const int*>(ok),
      static_cast<T*>(out), static_cast<float*>(lse), Qb, H, D, P, M,
      1.0f / sqrtf((float)D), fused, vec);
  return (int)cudaGetLastError();
}

// the prefill form's launcher by head dim
template <typename T, typename KV, bool kOwned>
int launch_prefill_d(const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* pt,
                     const void* rl, const void* ok, void* out, void* lse,
                     int G, int Qb, int H, int D, int P, int M, int fused,
                     void* stream) {
  if (G <= 0 || H <= 0 || P <= 0 || M <= 0 || D <= 0 || D > kMaxD ||
      H > 65535 || Qb > kPrefillRows * 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_prefill<T, KV, 1, kOwned>(q, k, v, ks, vs, pt, rl, ok, out,
                                            lse, G, Qb, H, D, P, M, fused, s);
  if (D <= 64)
    return launch_prefill<T, KV, 2, kOwned>(q, k, v, ks, vs, pt, rl, ok, out,
                                            lse, G, Qb, H, D, P, M, fused, s);
  if (D <= 128)
    return launch_prefill<T, KV, 4, kOwned>(q, k, v, ks, vs, pt, rl, ok, out,
                                            lse, G, Qb, H, D, P, M, fused, s);
  return launch_prefill<T, KV, 8, kOwned>(q, k, v, ks, vs, pt, rl, ok, out,
                                          lse, G, Qb, H, D, P, M, fused, s);
}

// the stats form's launcher: Qb >= kPrefillRows rows a lane take the
// prefill form, fewer (decode lanes, spec-verify rows) the warp form of
// paged_attention.cuh; both walk the compacted owned list, so M is
// bounded by kStatsMaxPages
template <typename T, typename KV>
int launch_stats(const void* q, const void* k, const void* v,
                 const void* ks, const void* vs, const void* pt,
                 const void* rl, const void* ok, void* out, void* lse, int G,
                 int Qb, int H, int D, int P, int M, int fused,
                 void* stream) {
  if (M > kStatsMaxPages) return (int)cudaErrorInvalidValue;
  if (Qb < kPrefillRows)
    return launch_warp<T, KV>(q, k, v, ks, vs, pt, rl, ok, out, lse, G, Qb, H,
                              D, P, M, fused, stream);
  return launch_prefill_d<T, KV, true>(q, k, v, ks, vs, pt, rl, ok, out, lse,
                                       G, Qb, H, D, P, M, fused, stream);
}

// #1 / #1q: lanes of Qb >= kPrefillRows rows take the prefill form over
// the lane's whole table (no page limit), fewer the decode form of
// paged_attention.cuh
template <typename T, typename KV>
int launch_ragged(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* pt,
                  const void* rl, void* out, int G, int Qb, int H, int D,
                  int P, int M, int fused, void* stream) {
  if (Qb < kPrefillRows)
    return launch_decode<T, KV>(q, k, v, ks, vs, pt, rl, out, G, Qb, H, D, P,
                                M, fused, stream);
  return launch_prefill_d<T, KV, false>(q, k, v, ks, vs, pt, rl, nullptr,
                                        out, nullptr, G, Qb, H, D, P, M,
                                        fused, stream);
}

}  // namespace
