"""Paged attention over a block-paged KV cache — the counterpart of
``paddle_tpu/ops/pallas_ops/paged_attention.py``: the per-row decode
kernel, the ragged kernel and its stats form.

Page id 0 is the trash page: padding entries point at it, so every
table entry is a valid index.  Two layouts read the same pools
``[N, P, H, D]``:

- per row (the split decode, prefill-chunk, fused and spec-verify
  programs): ``B`` query rows, each with its OWN page-table row and
  length; row ``b`` attends to positions ``s < seq_lens[b]``.
- ragged (the unified serving step): each serving lane owns one
  page-table row and carries ``Qb`` query rows (a decode lane one, a
  chunked-prefill lane a chunk); row ``r`` attends to positions
  ``s < row_lens[g, r]`` of its lane.

Int8 pools (the quantized serving arm) come with per-page-per-head f32
scales ``k_scales, v_scales [N, H]``; the plain versions dequantize after
the gather, the kernels in registers (``fused_dequant`` 1, the contract
default: scale after the q·k dot and on the p·v contribution; 0: before
the dots).

The stats form (a sequence shard of the serving mesh) takes a
``page_ok [G, M]`` ownership mask: a position is visible when it is
below its row's length AND its page is owned.  It returns ``(o, lse)``:
``o`` the softmax over the visible positions applied to v (exact zeros
for a row with nothing visible) and ``lse [G, Qb, H]`` f32 its
log-sum-exp ``m + log(l)``, or the finite ``NEG_INF`` for such a row, so
the shards merge in lse space without NaN.

- :func:`paged_attention` / :func:`ragged_paged_attention` /
  :func:`ragged_paged_attention_stats` — the routing entries: a CUDA
  tensor launches the hand-written kernel (``csrc/paged_decode.cu`` /
  ``csrc/paged_attention.cu`` / ``csrc/paged_attention_stats.cu``), a
  CPU tensor runs the plain version.  There is no other branch and no
  fallback on the card.  The per-row kernel and the ragged kernel's
  lanes of fewer than 16 rows share one decode form (each lane's walk
  split over a thread-block cluster, whose size the kernel library
  reports through ``ptt_paged_decode_layout``); the
  ragged kernel's prefill chunks (16 rows or more) and the stats kernel's
  share one prefill form.
- :func:`paged_attention_ref` / :func:`ragged_paged_attention_ref` /
  :func:`ragged_paged_attention_stats_ref` — the plain PyTorch twins of
  ``paged_attention_xla``, ``ragged_paged_attention_xla`` and
  ``ragged_paged_attention_stats_xla``: gather the pages into a dense
  view and run a masked f32 softmax.
- :func:`paged_attention_cuda` / :func:`ragged_paged_attention_cuda` /
  :func:`ragged_paged_attention_stats_cuda` — the kernel wrappers.

``PAGED_ROUTE_STATS`` counts routing decisions per call, the twin of the
reference's trace-time counter: ``"cuda_decode"`` / ``"cuda_decode_int8"``
(the per-row kernel, f32/bf16 or int8 pools), ``"cuda"`` /
``"cuda_int8"`` (the ragged kernel) and ``"cuda_stats"`` /
``"cuda_stats_int8"`` (its stats form) are incremented by their kernel
wrapper once per launch and nowhere else; ``"ref"`` and ``"ref_stats"``
by a routing entry once per plain-version call.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..profiler.jit_cost import count_launch

__all__ = ["NEG_INF", "PAGED_ROUTE_STATS", "FUSED_DEQUANT", "MAX_HEAD_DIM",
           "STATS_MAX_PAGES", "STATS_PREFILL_ROWS",
           "paged_attention_ref", "paged_attention_cuda", "paged_attention",
           "ragged_paged_attention_ref", "ragged_paged_attention_cuda",
           "ragged_paged_attention", "ragged_paged_attention_stats_ref",
           "ragged_paged_attention_stats_cuda", "ragged_paged_attention_stats"]

NEG_INF = -1e30

# counted through ``count_launch``: the CUDA-graph runner adds a captured
# program's launches on every replay
PAGED_ROUTE_STATS = {
    "cuda": 0, "cuda_int8": 0, "cuda_decode": 0, "cuda_decode_int8": 0,
    "cuda_stats": 0, "cuda_stats_int8": 0, "ref": 0, "ref_stats": 0}

# the contract default of the int8 body (paddle_tpu's PAGED_RAGGED_INT8
# ``fused_dequant``): scales applied after the dots
FUSED_DEQUANT = 1

# the kernels' widest head: instances of 32, 64, 128 and 256 columns (the
# flash kernels' bound too); the serving engine checks it when it is
# built on the card
MAX_HEAD_DIM = 256
# the stats kernel compacts a lane's owned table entries into shared
# memory: pages_per_seq (page_tables.shape[1]) is bounded
STATS_MAX_PAGES = 4096
# lanes of at least this many rows take the prefill form (the stats
# kernel's and the ragged kernel's), fewer the decode form
STATS_PREFILL_ROWS = 16
# (library, q dtype, int8 pools) -> C entry point
_KERNEL_FNS = {
    ("paged_attention", torch.float32, False):
        "ptt_ragged_paged_attention_f32",
    ("paged_attention", torch.bfloat16, False):
        "ptt_ragged_paged_attention_bf16",
    ("paged_attention", torch.float32, True):
        "ptt_ragged_paged_attention_int8_f32",
    ("paged_attention", torch.bfloat16, True):
        "ptt_ragged_paged_attention_int8_bf16",
    ("paged_decode", torch.float32, False): "ptt_paged_attention_f32",
    ("paged_decode", torch.bfloat16, False): "ptt_paged_attention_bf16",
    ("paged_decode", torch.float32, True): "ptt_paged_attention_int8_f32",
    ("paged_decode", torch.bfloat16, True): "ptt_paged_attention_int8_bf16",
    ("paged_attention_stats", torch.float32, False):
        "ptt_ragged_paged_attention_stats_f32",
    ("paged_attention_stats", torch.bfloat16, False):
        "ptt_ragged_paged_attention_stats_bf16",
    ("paged_attention_stats", torch.float32, True):
        "ptt_ragged_paged_attention_stats_int8_f32",
    ("paged_attention_stats", torch.bfloat16, True):
        "ptt_ragged_paged_attention_stats_int8_bf16"}


def _require_scales(k_pages, k_scales, v_scales):
    if k_pages.dtype == torch.int8 and (k_scales is None
                                        or v_scales is None):
        raise ValueError("int8 KV pages require k_scales/v_scales")


def paged_attention_ref(q, k_pages, v_pages, page_tables, seq_lens,
                        k_scales=None, v_scales=None):
    """Plain twin of ``paged_attention_xla``: gather each sequence's pages
    into a dense ``[B, M*P, H, D]`` view, masked f32 softmax with the
    finite ``NEG_INF`` sentinel, rows with ``seq_len 0`` pinned to 0.
    Int8 pages are dequantized after the gather with their per-page-per-
    head scales.

    q [B, H, D], pools [N, P, H, D], page_tables [B, M], seq_lens [B]
    (k_scales, v_scales [N, H] f32 iff the pools are int8) -> [B, H, D]
    in q's dtype."""
    _require_scales(k_pages, k_scales, v_scales)
    B, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    S = M * P
    idx = page_tables.long()
    k = k_pages[idx].reshape(B, S, H, D)
    v = v_pages[idx].reshape(B, S, H, D)
    if k_pages.dtype == torch.int8:
        ks = torch.repeat_interleave(k_scales[idx], P, dim=1)   # [B, S, H]
        vs = torch.repeat_interleave(v_scales[idx], P, dim=1)
        k = k.float() * ks[..., None]
        v = v.float() * vs[..., None]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, None, :]
             < seq_lens.to(q.device)[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bshd->bhd", p, v.float())
    # empty rows: the all-masked softmax is uniform garbage -> pin to 0,
    # matching the kernel's zero-initialised accumulator
    ctx = torch.where(seq_lens.to(q.device)[:, None, None] > 0, ctx,
                      torch.zeros_like(ctx))
    return ctx.to(q.dtype)


def ragged_paged_attention_ref(q, k_pages, v_pages, page_tables, row_lens,
                               k_scales=None, v_scales=None):
    """Plain twin of ``ragged_paged_attention_xla``: flatten the G x Qb
    rows, repeat each lane's page-table row across its queries and
    delegate to :func:`paged_attention_ref`."""
    G, Qb, H, D = q.shape
    rows_q = q.reshape(G * Qb, H, D)
    rows_pt = torch.repeat_interleave(page_tables, Qb, dim=0)
    rows_len = row_lens.reshape(G * Qb)
    out = paged_attention_ref(rows_q, k_pages, v_pages, rows_pt, rows_len,
                              k_scales, v_scales)
    return out.reshape(G, Qb, H, D)


def ragged_paged_attention_stats_ref(q, k_pages, v_pages, page_tables,
                                     row_lens, page_ok, k_scales=None,
                                     v_scales=None):
    """Plain twin of ``ragged_paged_attention_stats_xla``: gather each
    lane's pages, mask by position AND page ownership, and return the
    locally normalized context with its log-sum-exp.

    q [G, Qb, H, D], pools [N, P, H, D], page_tables / page_ok [G, M],
    row_lens [G, Qb] (k_scales, v_scales [N, H] f32 iff the pools are
    int8) -> (o [G, Qb, H, D] in q's dtype, lse [G, Qb, H] f32).  A row
    with no visible position gets o = 0 and lse = ``NEG_INF``.  Like the
    reference, a position on a page that is not owned is multiplied by a
    zero probability, not skipped: a NaN stored there reaches the row."""
    _require_scales(k_pages, k_scales, v_scales)
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    S = M * P
    idx = page_tables.long()
    k = k_pages[idx].reshape(G, S, H, D)
    v = v_pages[idx].reshape(G, S, H, D)
    if k_pages.dtype == torch.int8:
        ks = torch.repeat_interleave(k_scales[idx], P, dim=1)   # [G, S, H]
        vs = torch.repeat_interleave(v_scales[idx], P, dim=1)
        k = k.float() * ks[..., None]
        v = v.float() * vs[..., None]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("gqhd,gshd->gqhs", q.float(), k.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, None, :]
             < row_lens.to(q.device)[:, :, None])             # [G, Qb, S]
    ok = torch.repeat_interleave(page_ok.to(q.device) != 0, P, dim=1)
    vmask = (valid & ok[:, None, :])[:, :, None, :]           # [G, Qb, 1, S]
    s = torch.where(vmask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                        # [G, Qb, H]
    p = torch.where(vmask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    l_safe = torch.clamp(l, min=1e-30)
    o = torch.einsum("gqhs,gshd->gqhd", p, v.float()) / l_safe[..., None]
    lse = torch.where(l > 0, m + torch.log(l_safe),
                      torch.full_like(l, NEG_INF))
    return o.to(q.dtype), lse.float()


def _check(q, k_pages, v_pages, page_tables, row_lens, k_scales, v_scales):
    """The ragged kernel's terms: q [G, Qb, H, D], row_lens [G, Qb]."""
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q must be [G, Qb, H, D] and the pools "
                         f"[N, P, H, D]; got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    G, Qb = q.shape[:2]
    if page_tables.dim() != 2 or page_tables.shape[0] != G:
        raise ValueError(f"page_tables must be [G={G}, M], got "
                         f"{tuple(page_tables.shape)}")
    if tuple(row_lens.shape) != (G, Qb):
        raise ValueError(f"row_lens must be [{G}, {Qb}], got "
                         f"{tuple(row_lens.shape)}")
    _check_pools(q, k_pages, v_pages, k_scales, v_scales,
                 (("page_tables", page_tables), ("row_lens", row_lens)))


def _check_decode(q, k_pages, v_pages, page_tables, seq_lens, k_scales,
                  v_scales):
    """The per-row kernel's terms: q [B, H, D], seq_lens [B]."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be [B, H, D] and the pools "
                         f"[N, P, H, D]; got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    B = q.shape[0]
    if page_tables.dim() != 2 or page_tables.shape[0] != B:
        raise ValueError(f"page_tables must be [B={B}, M], got "
                         f"{tuple(page_tables.shape)}")
    if tuple(seq_lens.shape) != (B,):
        raise ValueError(f"seq_lens must be [{B}], got "
                         f"{tuple(seq_lens.shape)}")
    _check_pools(q, k_pages, v_pages, k_scales, v_scales,
                 (("page_tables", page_tables), ("seq_lens", seq_lens)))


def _check_pools(q, k_pages, v_pages, k_scales, v_scales, index_tensors):
    """What both kernels take: pools [N, P, H, D] matching q's trailing
    (H, D), f32 or bf16 q with pools of its dtype or int8 with f32
    [N, H] scales, D <= 256, one device, contiguous q, pools and
    scales."""
    H, D = q.shape[-2:]
    if k_pages.shape != v_pages.shape or tuple(k_pages.shape[2:]) != (H, D):
        raise ValueError(f"k/v pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q heads/dim "
                         f"({H}, {D})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged attention kernels take float32 or "
                        f"bfloat16 queries, got {q.dtype}")
    quant = k_pages.dtype == torch.int8
    pool_dtype = torch.int8 if quant else q.dtype
    if k_pages.dtype != pool_dtype or v_pages.dtype != pool_dtype:
        raise TypeError(f"pools ({k_pages.dtype}, {v_pages.dtype}) must "
                        f"both be int8 or share q's dtype {q.dtype}")
    scales = ()
    if quant:
        _require_scales(k_pages, k_scales, v_scales)
        N = k_pages.shape[0]
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(t.shape) != (N, H) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 [N={N}, H={H}], "
                                 f"got {t.dtype} {tuple(t.shape)}")
        scales = (("k_scales", k_scales), ("v_scales", v_scales))
    elif k_scales is not None or v_scales is not None:
        raise ValueError("k_scales/v_scales belong to int8 pools only")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM} is not supported "
                         "by the kernel")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    *index_tensors, *scales):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    *scales):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_BOUND = {}


def _kernel(library: str, dtype, quant: bool):
    """The C entry point of ``csrc/<library>.cu`` for (q dtype, int8
    pools), built and bound at first use."""
    key = (library, dtype, quant)
    fn = _BOUND.get(key)
    if fn is None:
        from ._build import load_library

        fn = getattr(load_library(library), _KERNEL_FNS[key])
        # pointers and the stream as c_void_p: a plain int argument would
        # be passed as a 32-bit C int and cut the address
        n_ptr, n_int = {"paged_attention": (6, 6),
                        "paged_attention_stats": (8, 6),
                        "paged_decode": (6, 5)}[library]
        if quant:
            n_ptr, n_int = n_ptr + 2, n_int + 1     # scales, fused_dequant
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return fn


def paged_attention_cuda(q, k_pages, v_pages, page_tables, seq_lens,
                         k_scales=None, v_scales=None,
                         fused_dequant: int = FUSED_DEQUANT):
    """Launch the per-row CUDA kernel (``csrc/paged_decode.cu``), which
    replaces ``paddle_tpu/ops/pallas_ops/paged_attention.py:_decode_kernel``
    and, for int8 pools, ``_decode_kernel_quant``.

    It is the ragged kernel's decode form at one row a lane (G = B,
    Qb = 1, ``seq_lens`` as the row lengths).  The kernel is bound by
    bytes: a row does 4·D flops per K/V position it reads, far under the
    H100's flop-per-byte balance.  Each (row, head)'s walk of its pages
    below its length is split over a thread-block cluster; rows that
    share a table row (a prefill chunk) each read the pages again, out of
    L2.

    Inputs must be contiguous CUDA tensors on one device (q [B, H, D] f32
    or bf16; pools of q's dtype, or int8 with f32 ``[N, H]`` scales;
    D <= 256); page tables and lengths are cast to contiguous int32 here.
    Raises when the launch is refused."""
    _check_decode(q, k_pages, v_pages, page_tables, seq_lens, k_scales,
                  v_scales)
    if not q.is_cuda:
        raise ValueError("paged_attention_cuda needs CUDA tensors")
    quant = k_pages.dtype == torch.int8
    fn = _kernel("paged_decode", q.dtype, quant)
    B, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    pt = page_tables.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0 or M == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quant:
            rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    k_scales.data_ptr(), v_scales.data_ptr(), pt.data_ptr(),
                    sl.data_ptr(), out.data_ptr(), B, H, D, P, M,
                    int(bool(fused_dequant)), stream)
        else:
            rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    pt.data_ptr(), sl.data_ptr(), out.data_ptr(),
                    B, H, D, P, M, stream)
    if rc != 0:
        raise RuntimeError(
            f"paged attention kernel launch failed: CUDA error {rc} "
            f"(B={B}, H={H}, D={D}, P={P}, M={M}, {q.dtype}, pools "
            f"{k_pages.dtype})")
    count_launch(PAGED_ROUTE_STATS,
                 "cuda_decode_int8" if quant else "cuda_decode")
    return out


@torch.library.custom_op("paddle_tpu_torch::paged_attention", mutates_args=())
def _paged_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              page_tables: torch.Tensor, seq_lens: torch.Tensor,
              k_scales: Optional[torch.Tensor],
              v_scales: Optional[torch.Tensor],
              fused_dequant: int) -> torch.Tensor:
    if q.is_cuda:
        return paged_attention_cuda(q, k_pages, v_pages, page_tables,
                                    seq_lens, k_scales, v_scales,
                                    fused_dequant)
    count_launch(PAGED_ROUTE_STATS, "ref")
    return paged_attention_ref(q, k_pages, v_pages, page_tables, seq_lens,
                               k_scales, v_scales)


@_paged_op.register_fake
def _paged_fake(q, k_pages, v_pages, page_tables, seq_lens, k_scales,
                v_scales, fused_dequant):
    return q.new_empty(q.shape)


def paged_attention(q, k_pages, v_pages, page_tables, seq_lens,
                    k_scales=None, v_scales=None,
                    fused_dequant: int = FUSED_DEQUANT):
    """Routing entry for the per-row layout (the split serving programs).

    q [B, H, D]; pools [N, P, H, D]; page_tables [B, M] (one row per
    query row, padded with the trash page 0); seq_lens [B] (0 = inactive
    row); k_scales, v_scales [N, H] f32 iff the pools are int8.  Returns
    [B, H, D] in q's dtype; softmax scale 1/sqrt(D) applied inside.

    The operator ``paddle_tpu_torch::paged_attention``: a CUDA tensor
    launches the kernel (``fused_dequant`` picks the int8 body's dequant
    placement); a CPU tensor runs the plain version; a tensor with no
    data gets the shape from the op's fake function."""
    return _paged_op(q, k_pages, v_pages, page_tables, seq_lens, k_scales,
                     v_scales, int(fused_dequant))


def ragged_paged_attention_cuda(q, k_pages, v_pages, page_tables, row_lens,
                                k_scales=None, v_scales=None,
                                fused_dequant: int = FUSED_DEQUANT):
    """Launch the CUDA kernel (``csrc/paged_attention.cu``), which replaces
    ``paddle_tpu/ops/pallas_ops/paged_attention.py:_ragged_kernel`` and,
    for int8 pools, ``_ragged_kernel_quant``.

    Two forms, by the rows a lane carries.  Fewer than
    ``STATS_PREFILL_ROWS`` (decode lanes, spec verify): the decode form,
    bound by bytes (a decode row does 4·D flops per K/V position it
    streams), which reads each visible page once per (lane, head, tile of
    up to 8 rows), split over a thread-block cluster of up to 8 CTAs,
    whose rank 0 merges the CTAs' softmax states through distributed
    shared memory.  Prefill chunks: the stats
    kernel's prefill form over the lane's whole table, bound by f32
    operations: 16 rows a block, each tile of 64 positions (32 at D > 64)
    staged once by ``cp.async`` into a two-stage ring, S = QKᵀ and
    O += PV register-tiled.  Both stop at the longest row of a block —
    cost follows real tokens, not the page-table width — and remove what
    a row does not see by select, never by a multiply by zero.

    Int8 pools stream a quarter of the f32 bytes as raw 16-byte copies;
    each position carries its page's scales, so a tile may span pages.

    Inputs must be contiguous CUDA tensors on one device (q f32 or bf16;
    pools of q's dtype, or int8 with f32 ``[N, H]`` scales; D <= 256);
    page tables and lengths are cast to contiguous int32 here.  Raises
    when the launch is refused."""
    _check(q, k_pages, v_pages, page_tables, row_lens, k_scales, v_scales)
    if not q.is_cuda:
        raise ValueError("ragged_paged_attention_cuda needs CUDA tensors")
    quant = k_pages.dtype == torch.int8
    fn = _kernel("paged_attention", q.dtype, quant)
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    pt = page_tables.to(torch.int32).contiguous()
    rl = row_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0 or M == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quant:
            rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    k_scales.data_ptr(), v_scales.data_ptr(), pt.data_ptr(),
                    rl.data_ptr(), out.data_ptr(), G, Qb, H, D, P, M,
                    int(bool(fused_dequant)), stream)
        else:
            rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    pt.data_ptr(), rl.data_ptr(), out.data_ptr(),
                    G, Qb, H, D, P, M, stream)
    if rc != 0:
        raise RuntimeError(
            f"ragged paged attention kernel launch failed: CUDA error {rc} "
            f"(G={G}, Qb={Qb}, H={H}, D={D}, P={P}, M={M}, {q.dtype}, "
            f"pools {k_pages.dtype})")
    count_launch(PAGED_ROUTE_STATS, "cuda_int8" if quant else "cuda")
    return out


@torch.library.custom_op("paddle_tpu_torch::ragged_paged_attention",
                         mutates_args=())
def _ragged_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               page_tables: torch.Tensor, row_lens: torch.Tensor,
               k_scales: Optional[torch.Tensor],
               v_scales: Optional[torch.Tensor],
               fused_dequant: int) -> torch.Tensor:
    if q.is_cuda:
        return ragged_paged_attention_cuda(q, k_pages, v_pages,
                                           page_tables, row_lens, k_scales,
                                           v_scales, fused_dequant)
    count_launch(PAGED_ROUTE_STATS, "ref")
    return ragged_paged_attention_ref(q, k_pages, v_pages, page_tables,
                                      row_lens, k_scales, v_scales)


@_ragged_op.register_fake
def _ragged_fake(q, k_pages, v_pages, page_tables, row_lens, k_scales,
                 v_scales, fused_dequant):
    return q.new_empty(q.shape)


def ragged_paged_attention(q, k_pages, v_pages, page_tables, row_lens,
                           k_scales=None, v_scales=None,
                           fused_dequant: int = FUSED_DEQUANT):
    """Routing entry for the unified serving step.

    q [G, Qb, H, D]; pools [N, P, H, D]; page_tables [G, M] (one row per
    lane, padded with the trash page 0); row_lens [G, Qb] (each row's
    causal KV horizon, 0 = padded row); k_scales, v_scales [N, H] f32
    iff the pools are int8.  Returns [G, Qb, H, D].

    A CUDA tensor launches the kernel (``fused_dequant`` picks the int8
    body's dequant placement); a CPU tensor runs the plain version.
    Softmax scale 1/sqrt(D) is applied inside.  The operator
    ``paddle_tpu_torch::ragged_paged_attention``: a tensor with no data
    gets the shape from its fake function."""
    return _ragged_op(q, k_pages, v_pages, page_tables, row_lens, k_scales,
                      v_scales, int(fused_dequant))


def ragged_paged_attention_stats_cuda(q, k_pages, v_pages, page_tables,
                                      row_lens, page_ok, k_scales=None,
                                      v_scales=None,
                                      fused_dequant: int = FUSED_DEQUANT):
    """Launch the stats form of the ragged kernel
    (``csrc/paged_attention_stats.cu``), which replaces
    ``paddle_tpu/ops/pallas_ops/paged_attention.py:_ragged_stats_kernel``
    and, for int8 pools, ``_ragged_stats_kernel_quant``.

    Both of its forms walk owned pages: a block first compacts its lane's
    owned table entries below its longest row into a list in shared
    memory, then walks tiles of that list, so a shard reads and scores
    only the positions it owns, whatever the ownership pattern.  Lanes of
    fewer than ``STATS_PREFILL_ROWS`` (16) rows — decode lanes, spec
    verify — take a warp form (bound by bytes: 4·D flops per position
    read), with lse written after the block's four warps merge.  Prefill
    chunks take the prefill form (which :func:`ragged_paged_attention_cuda`
    shares, without the ownership list),
    bound by f32 operations on the CUDA cores: one block per (lane, head,
    16 rows) stages each tile of 64 owned positions (32 at D > 64) once,
    by 16-byte ``cp.async`` into a two-stage ring, and register-tiles
    S = QKᵀ and O += PV.  A position a row does not see is removed by
    select, never multiplied by zero, so a NaN stored there does not
    reach the row.

    Inputs as for :func:`ragged_paged_attention_cuda` plus ``page_ok
    [G, M]`` (cast to contiguous int32 here); M is at most
    ``STATS_MAX_PAGES`` (4096).  Returns ``(o, lse)``.  Raises when the
    launch is refused."""
    _check(q, k_pages, v_pages, page_tables, row_lens, k_scales, v_scales)
    if tuple(page_ok.shape) != tuple(page_tables.shape):
        raise ValueError(f"page_ok must be {tuple(page_tables.shape)} like "
                         f"page_tables, got {tuple(page_ok.shape)}")
    if page_ok.device != q.device:
        raise ValueError(f"page_ok is on {page_ok.device}, q on {q.device}")
    if not q.is_cuda:
        raise ValueError("ragged_paged_attention_stats_cuda needs CUDA "
                         "tensors")
    if page_tables.shape[1] > STATS_MAX_PAGES:
        raise ValueError(f"pages_per_seq {page_tables.shape[1]} > "
                         f"{STATS_MAX_PAGES} is not supported by the stats "
                         "kernel")
    quant = k_pages.dtype == torch.int8
    fn = _kernel("paged_attention_stats", q.dtype, quant)
    G, Qb, H, D = q.shape
    P = k_pages.shape[1]
    M = page_tables.shape[1]
    pt = page_tables.to(torch.int32).contiguous()
    rl = row_lens.to(torch.int32).contiguous()
    ok = page_ok.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((G, Qb, H), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or M == 0:
        return out.zero_(), lse.fill_(NEG_INF)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if quant:
            rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    k_scales.data_ptr(), v_scales.data_ptr(), pt.data_ptr(),
                    rl.data_ptr(), ok.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), G, Qb, H, D, P, M,
                    int(bool(fused_dequant)), stream)
        else:
            rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    pt.data_ptr(), rl.data_ptr(), ok.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), G, Qb, H, D, P, M,
                    stream)
    if rc != 0:
        raise RuntimeError(
            f"ragged paged attention stats kernel launch failed: CUDA error "
            f"{rc} (G={G}, Qb={Qb}, H={H}, D={D}, P={P}, M={M}, {q.dtype}, "
            f"pools {k_pages.dtype})")
    count_launch(PAGED_ROUTE_STATS,
                 "cuda_stats_int8" if quant else "cuda_stats")
    return out, lse


@torch.library.custom_op("paddle_tpu_torch::ragged_paged_attention_stats",
                         mutates_args=())
def _ragged_stats_op(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_tables: torch.Tensor,
                     row_lens: torch.Tensor, page_ok: torch.Tensor,
                     k_scales: Optional[torch.Tensor],
                     v_scales: Optional[torch.Tensor],
                     fused_dequant: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.is_cuda:
        return ragged_paged_attention_stats_cuda(
            q, k_pages, v_pages, page_tables, row_lens, page_ok, k_scales,
            v_scales, fused_dequant)
    count_launch(PAGED_ROUTE_STATS, "ref_stats")
    return ragged_paged_attention_stats_ref(q, k_pages, v_pages, page_tables,
                                            row_lens, page_ok, k_scales,
                                            v_scales)


@_ragged_stats_op.register_fake
def _ragged_stats_fake(q, k_pages, v_pages, page_tables, row_lens, page_ok,
                       k_scales, v_scales, fused_dequant):
    return q.new_empty(q.shape), q.new_empty(q.shape[:-1],
                                             dtype=torch.float32)


def ragged_paged_attention_stats(q, k_pages, v_pages, page_tables, row_lens,
                                 page_ok, k_scales=None, v_scales=None,
                                 fused_dequant: int = FUSED_DEQUANT):
    """Routing entry for a sequence shard of the mesh-sharded serving
    core: :func:`ragged_paged_attention`'s inputs plus ``page_ok [G, M]``
    (nonzero = this shard owns the table entry's page); returns
    ``(o [G, Qb, H, D], lse [G, Qb, H] f32)``, the shard's partial stats
    for the cross-shard lse merge.

    The operator ``paddle_tpu_torch::ragged_paged_attention_stats``: a
    CUDA tensor launches the kernel; a CPU tensor runs the plain
    version; a tensor with no data gets the shapes from its fake
    function."""
    return _ragged_stats_op(q, k_pages, v_pages, page_tables, row_lens,
                            page_ok, k_scales, v_scales, int(fused_dequant))
