// Ragged paged attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_ops/paged_attention.py
// ragged_paged_attention_kernel, both of its bodies: _ragged_kernel (f32 or
// bf16 pools) and _ragged_kernel_quant (int8 pools).  The kernel itself,
// what it computes and how the work is laid out, is in
// paged_attention.cuh; these entry points launch it without the
// ownership mask and the lse output (every position below a row's length
// is visible).
#include "paged_attention.cuh"

// q [G, Qb, H, D], k/v pools [N, P, H, D] (same dtype as q), page_tables
// [G, M] int32, row_lens [G, Qb] int32, out [G, Qb, H, D] (q's dtype); all
// contiguous on one device, page ids in [0, N).  Launches on ``stream``
// and returns cudaGetLastError() (0 = launched).
extern "C" int ptt_ragged_paged_attention_f32(const void* q, const void* k,
                                              const void* v, const void* pt,
                                              const void* rl, void* out, int G,
                                              int Qb, int H, int D, int P,
                                              int M, void* stream) {
  return launch<float, float, false>(q, k, v, nullptr, nullptr, pt, rl,
                                     nullptr, out, nullptr, G, Qb, H, D, P,
                                     M, 0, stream);
}

extern "C" int ptt_ragged_paged_attention_bf16(const void* q, const void* k,
                                               const void* v, const void* pt,
                                               const void* rl, void* out,
                                               int G, int Qb, int H, int D,
                                               int P, int M, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, false>(
      q, k, v, nullptr, nullptr, pt, rl, nullptr, out, nullptr, G, Qb, H, D,
      P, M, 0, stream);
}

// The int8 body: k/v pools [N, P, H, D] int8 with k_scales / v_scales
// [N, H] f32; q and out f32 or bf16; fused_dequant 1 scales after the
// dots, 0 before.  Otherwise as above.
extern "C" int ptt_ragged_paged_attention_int8_f32(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* rl, void* out, int G, int Qb,
    int H, int D, int P, int M, int fused_dequant, void* stream) {
  return launch<float, int8_t, false>(q, k, v, ks, vs, pt, rl, nullptr, out,
                                      nullptr, G, Qb, H, D, P, M,
                                      fused_dequant, stream);
}

extern "C" int ptt_ragged_paged_attention_int8_bf16(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* rl, void* out, int G, int Qb,
    int H, int D, int P, int M, int fused_dequant, void* stream) {
  return launch<__nv_bfloat16, int8_t, false>(q, k, v, ks, vs, pt, rl,
                                              nullptr, out, nullptr, G, Qb, H,
                                              D, P, M, fused_dequant, stream);
}
