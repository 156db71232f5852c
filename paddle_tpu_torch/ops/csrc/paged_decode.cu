// Paged decode attention for NVIDIA Hopper (sm_90a), plain C interface:
// one query row per sequence, each row with its own page-table row and
// length.
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_ops/paged_attention.py
// paged_attention_kernel, both of its bodies: _decode_kernel (f32 or bf16
// pools) and _decode_kernel_quant (int8 pools).  What it computes, per
// row b and head h:
//
//   out[b, h, :] = softmax_{s < seq_lens[b]}( q[b,h,:] . k[s,h,:] / sqrt(D) ) @ v[s,h,:]
//
// where position s of row b lives in page page_tables[b, s / P], slot
// s % P, of the pools k_pages / v_pages [N, P, H, D].  Rows with seq_len
// 0 write exact zeros.  q is f32 or bf16; all arithmetic is f32 and the
// scale comes from the real D.  Int8 pools carry one f32 scale per (page,
// head), k_scales / v_scales [N, H]; fused_dequant as in the ragged kernel.
//
// This is the ragged kernel's decode form (paged_attention.cuh) at one row
// a lane: G = B lanes of Qb = 1, row_lens = seq_lens viewed as [B, 1].  A
// row's walk is split over a thread-block cluster, so the per-row layout
// costs what the ragged layout costs on the same inputs.  Rows that share
// a table row (a prefill chunk: C rows of one sequence) each read its
// pages again; those repeated reads are served from L2.  Positions at or
// past seq_len are never read, not even from a page the row's table
// holds; the TPU kernel reads such a page whole and masks the scores;
// both give the same result for finite pools.  A NaN scale reaches every
// row that reads its page, and no other.
#include "paged_attention.cuh"

// q [B, H, D], k/v pools [N, P, H, D] (same dtype as q), page_tables
// [B, M] int32, seq_lens [B] int32, out [B, H, D] (q's dtype); all
// contiguous on one device, page ids in [0, N).  Launches on ``stream``
// and returns the launch's CUDA error (0 = launched).
extern "C" int ptt_paged_attention_f32(const void* q, const void* k,
                                       const void* v, const void* pt,
                                       const void* sl, void* out, int B,
                                       int H, int D, int P, int M,
                                       void* stream) {
  return launch_decode<float, float, 1>(q, k, v, nullptr, nullptr, pt, sl,
                                        out, B, 1, H, D, P, M, 0, stream);
}

extern "C" int ptt_paged_attention_bf16(const void* q, const void* k,
                                        const void* v, const void* pt,
                                        const void* sl, void* out, int B,
                                        int H, int D, int P, int M,
                                        void* stream) {
  return launch_decode<__nv_bfloat16, __nv_bfloat16, 1>(
      q, k, v, nullptr, nullptr, pt, sl, out, B, 1, H, D, P, M, 0, stream);
}

// The int8 body: k/v pools [N, P, H, D] int8 with k_scales / v_scales
// [N, H] f32; q and out f32 or bf16; fused_dequant 1 scales after the
// dots, 0 before.  Otherwise as above.
extern "C" int ptt_paged_attention_int8_f32(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* sl, void* out, int B, int H,
    int D, int P, int M, int fused_dequant, void* stream) {
  return launch_decode<float, int8_t, 1>(q, k, v, ks, vs, pt, sl, out, B, 1,
                                         H, D, P, M, fused_dequant, stream);
}

extern "C" int ptt_paged_attention_int8_bf16(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pt, const void* sl, void* out, int B, int H,
    int D, int P, int M, int fused_dequant, void* stream) {
  return launch_decode<__nv_bfloat16, int8_t, 1>(
      q, k, v, ks, vs, pt, sl, out, B, 1, H, D, P, M, fused_dequant, stream);
}
