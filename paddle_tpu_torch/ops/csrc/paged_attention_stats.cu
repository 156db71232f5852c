// The stats form of ragged paged attention for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_ops/paged_attention.py
// ragged_paged_attention_stats_kernel, both of its bodies:
// _ragged_stats_kernel (f32 or bf16 pools) and _ragged_stats_kernel_quant
// (int8 pools).  A sequence shard of the serving mesh holds some of each
// lane's pages; it attends over the positions on the pages it owns
// (page_ok [G, M] != 0) below each row's length and returns the locally
// normalized context with its log-sum-exp, which the caller merges across
// shards in lse space (-1e30 for a row with nothing visible, whose
// context is exact zeros).
//
// Both of its forms walk owned pages: the block compacts the lane's owned
// table entries below its horizon into a list in shared memory and walks
// that list, so a shard reads and scores only what it owns.  Lanes of
// fewer than 16 rows (decode, spec verify) take the warp form of
// paged_attention.cuh; prefill chunks the block-shared, register-tiled
// form of paged_attention_stats.cuh.  pages_per_seq M is at most 4096.
#include "paged_attention_stats.cuh"

// q [G, Qb, H, D], k/v pools [N, P, H, D] (same dtype as q), page_tables
// [G, M] int32, row_lens [G, Qb] int32, page_ok [G, M] int32, out
// [G, Qb, H, D] (q's dtype), lse [G, Qb, H] f32; all contiguous on one
// device, page ids in [0, N), M <= 4096.  Launches on ``stream`` and
// returns cudaGetLastError() (0 = launched).
extern "C" int ptt_ragged_paged_attention_stats_f32(
    const void* q, const void* k, const void* v, const void* pt,
    const void* rl, const void* ok, void* out, void* lse, int G, int Qb,
    int H, int D, int P, int M, void* stream) {
  return launch_stats<float, float>(q, k, v, nullptr, nullptr, pt, rl, ok,
                                    out, lse, G, Qb, H, D, P, M, 0, stream);
}

extern "C" int ptt_ragged_paged_attention_stats_bf16(
    const void* q, const void* k, const void* v, const void* pt,
    const void* rl, const void* ok, void* out, void* lse, int G, int Qb,
    int H, int D, int P, int M, void* stream) {
  return launch_stats<__nv_bfloat16, __nv_bfloat16>(
      q, k, v, nullptr, nullptr, pt, rl, ok, out, lse, G, Qb, H, D, P, M, 0,
      stream);
}

// The int8 body: k/v pools [N, P, H, D] int8 with k_scales / v_scales
// [N, H] f32; q and out f32 or bf16; fused_dequant 1 scales after the
// dots (the K scale before the running max), 0 before.  Otherwise as
// above.
extern "C" int ptt_ragged_paged_attention_stats_int8_f32(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* rl, const void* ok,
    void* out, void* lse, int G, int Qb, int H, int D, int P, int M,
    int fused_dequant, void* stream) {
  return launch_stats<float, int8_t>(q, k, v, ks, vs, pt, rl, ok, out, lse,
                                     G, Qb, H, D, P, M, fused_dequant,
                                     stream);
}

extern "C" int ptt_ragged_paged_attention_stats_int8_bf16(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* rl, const void* ok,
    void* out, void* lse, int G, int Qb, int H, int D, int P, int M,
    int fused_dequant, void* stream) {
  return launch_stats<__nv_bfloat16, int8_t>(q, k, v, ks, vs, pt, rl, ok,
                                             out, lse, G, Qb, H, D, P, M,
                                             fused_dequant, stream);
}
