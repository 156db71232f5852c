// Ragged paged attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_ops/paged_attention.py
// ragged_paged_attention_kernel, both of its bodies: _ragged_kernel (f32 or
// bf16 pools) and _ragged_kernel_quant (int8 pools).  What it computes is
// described in paged_attention.cuh; every position below a row's length is
// visible (no ownership mask, no lse output).  Two forms, by the rows a
// lane carries:
//   - Qb < 16 (decode lanes, spec verify): the decode form of
//     paged_attention.cuh, each lane's walk split over a thread-block
//     cluster;
//   - Qb >= 16 (prefill chunks): the block-shared, register-tiled prefill
//     form of paged_attention_stats.cuh over the lane's whole table, 16
//     rows a block.
// The page table's width M is not bounded here.
#include "paged_attention_stats.cuh"

// q [G, Qb, H, D], k/v pools [N, P, H, D] (same dtype as q), page_tables
// [G, M] int32, row_lens [G, Qb] int32, out [G, Qb, H, D] (q's dtype); all
// contiguous on one device, page ids in [0, N).  Launches on ``stream``
// and returns the launch's CUDA error (0 = launched).
extern "C" int ptt_ragged_paged_attention_f32(const void* q, const void* k,
                                              const void* v, const void* pt,
                                              const void* rl, void* out, int G,
                                              int Qb, int H, int D, int P,
                                              int M, void* stream) {
  return launch_ragged<float, float>(q, k, v, nullptr, nullptr, pt, rl, out,
                                     G, Qb, H, D, P, M, 0, stream);
}

extern "C" int ptt_ragged_paged_attention_bf16(const void* q, const void* k,
                                               const void* v, const void* pt,
                                               const void* rl, void* out,
                                               int G, int Qb, int H, int D,
                                               int P, int M, void* stream) {
  return launch_ragged<__nv_bfloat16, __nv_bfloat16>(
      q, k, v, nullptr, nullptr, pt, rl, out, G, Qb, H, D, P, M, 0, stream);
}

// The int8 body: k/v pools [N, P, H, D] int8 with k_scales / v_scales
// [N, H] f32; q and out f32 or bf16; fused_dequant 1 scales after the
// dots, 0 before.  Otherwise as above.
extern "C" int ptt_ragged_paged_attention_int8_f32(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* rl, void* out, int G, int Qb,
    int H, int D, int P, int M, int fused_dequant, void* stream) {
  return launch_ragged<float, int8_t>(q, k, v, ks, vs, pt, rl, out, G, Qb, H,
                                      D, P, M, fused_dequant, stream);
}

extern "C" int ptt_ragged_paged_attention_int8_bf16(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* rl, void* out, int G, int Qb,
    int H, int D, int P, int M, int fused_dequant, void* stream) {
  return launch_ragged<__nv_bfloat16, int8_t>(q, k, v, ks, vs, pt, rl, out, G,
                                              Qb, H, D, P, M, fused_dequant,
                                              stream);
}

// The decode form's layout for a call (D, the pools' element size in
// bytes, Qb, M, P): the CTAs of a lane's cluster, a CTA's warps, its rows.
// Returns 0.
extern "C" int ptt_paged_decode_layout(int D, int item, int Qb, int M, int P,
                                       int* cluster, int* warps, int* rows) {
  decode_layout(D, item, Qb, M, P, cluster, warps, rows);
  return 0;
}
