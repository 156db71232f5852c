"""Attention ops — twin of ``paddle_tpu/ops/attention.py``.

- :func:`scaled_dot_product_attention` — ``[B, S, H, D]`` in and out.
  When the mask is padding-style (or absent) and :func:`_pallas_ok`
  allows, it routes to :func:`flash_attention`; otherwise to
  :func:`_sdpa_core`, plain matmuls and a softmax (which the JAX package
  leaves to XLA).
- :func:`flash_attention` — the flash kernels (forward and backward,
  ``ops/flash_attention.py``) on the route's terms, else the
  :func:`scaled_dot_product_attention` fallback with a boolean mask.
- :func:`paged_attention` — decode-time attention over a block-paged KV
  cache, one query row per sequence: ``ops/paged_attention.py``'s
  routing entry (the per-row CUDA kernel on a CUDA tensor, its plain
  version on a CPU tensor).

Under ``amp.auto_cast`` both routes cast their floating inputs as the
JAX package's ``apply`` does: the flash route as "flash_attention", the
plain route as "scaled_dot_product_attention" (both on the white list),
so bf16 q, k and v reach the bf16 flash bodies.

Routing (:func:`_pallas_ok`): the flash route needs a CUDA tensor (the
JAX package says "on TPU"), self-attention shapes, S >= 128 and
D <= 256.  ``PADDLE_TPU_FORCE_FLASH=1`` (the JAX package's switch) takes
the flash route off the card too and drops the S gate, so the CPU tests
run the flash bodies' plain versions; a CUDA tensor never takes them.

``ROUTE_STATS`` keeps the JAX key names so counts compare one to one:
``"pallas"`` counts calls routed to the flash kernels (their plain
versions on the CPU), ``"xla"`` calls routed to :func:`_sdpa_core`;
both count through ``count_launch``, so a graph's replays add theirs.
"""
from __future__ import annotations

import os

import torch

from ..amp.auto_cast import cast_inputs
from ..framework.random import generator
from ..profiler.jit_cost import count_launch
from .flash_attention import NEG_INF, flash_attention_bshd

__all__ = ["ROUTE_STATS", "scaled_dot_product_attention", "flash_attention",
           "paged_attention"]

ROUTE_STATS = {"pallas": 0, "xla": 0}


def _sdpa_core(q, k, v, mask, dropout_p, is_causal, scale=None):
    """Plain attention on ``[B, H, S, D]``: f32 logits, the finite
    ``NEG_INF`` sentinel for causal and boolean masks, a float mask added
    to the logits, the softmax cast back to q's dtype.  Dropout draws
    from the port's generator of q's device (``framework.random``), so
    its bits differ from the JAX package's; only the flash route's bits
    are shared."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((ql, kl), dtype=torch.bool,
                            device=q.device).tril(diagonal=kl - ql)
        logits = torch.where(causal, logits, torch.full_like(logits,
                                                             NEG_INF))
    if mask is not None:
        if mask.dim() == 2:
            # [B, S] validity mask -> broadcast over heads and queries
            mask = (mask > 0.5)[:, None, None, :]
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, torch.full_like(logits,
                                                               NEG_INF))
        else:
            logits = logits + mask.float()
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(p.shape, generator=generator(p.device),
                          device=p.device) >= dropout_p
        p = torch.where(keep, p / (1.0 - dropout_p),
                        torch.zeros_like(p)).to(q.dtype)
    return torch.matmul(p, v)


def _as_kv_mask(mask, B, S):
    """Reduce a padding-style attention mask to a ``[B, S]`` f32 kv
    validity mask, or None if it is not losslessly reducible.

    Recognized: a bool or 0/1 float ``[B, S]`` validity mask (1/True =
    attend) and a bool ``[B, 1, 1, S]`` mask (True = attend).  An
    additive FLOAT mask is never binarized: a soft penalty like -3.0
    would become hard masking on the flash route while the plain route
    adds it to the logits, so it stays on the plain route."""
    if mask.dim() == 2 and tuple(mask.shape) == (B, S):
        if mask.dtype == torch.bool:
            return mask.float()
        return (mask > 0.5).float()
    if (mask.dim() == 4 and mask.shape[0] == B and mask.shape[1] == 1
            and mask.shape[2] == 1 and mask.shape[3] == S
            and mask.dtype == torch.bool):
        return mask[:, 0, 0, :].float()
    return None


def _pallas_ok(q, k=None) -> bool:
    """Take the flash route: on a CUDA tensor (or when forced), with
    self-attention shapes and D <= 256; S >= 128 unless forced."""
    forced = os.environ.get("PADDLE_TPU_FORCE_FLASH") == "1"
    if not forced and not q.is_cuda:
        return False
    B, S, H, D = q.shape
    if k is not None and tuple(k.shape) != (B, S, H, D):
        return False     # cross-attention with another kv length
    if not forced and S < 128:
        return False     # short sequences: the plain route is fine
    return D <= 256


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Inputs ``[B, S, H, D]``; returns ``[B, S, H, D]`` in the query's
    dtype.  Routes to the flash kernels when the mask is padding-style
    (or absent) and :func:`_pallas_ok` allows; otherwise plain
    attention."""
    drop = dropout_p if training else 0.0
    if _pallas_ok(query, key):
        kv_mask = None
        routable = attn_mask is None
        if attn_mask is not None:
            kv_mask = _as_kv_mask(attn_mask, key.shape[0], key.shape[1])
            routable = kv_mask is not None
        if routable:
            count_launch(ROUTE_STATS, "pallas")
            return flash_attention(query, key, value, dropout=drop,
                                   causal=is_causal, kv_mask=kv_mask)
    count_launch(ROUTE_STATS, "xla")
    query, key, value, attn_mask = cast_inputs(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    out = _sdpa_core(query.transpose(1, 2), key.transpose(1, 2),
                     value.transpose(1, 2), attn_mask, drop, is_causal)
    return out.transpose(1, 2).to(query.dtype)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, kv_mask=None, name=None):
    """Flash attention entry, ``[B, S, H, D]``; ``kv_mask``: optional
    ``[B, S]`` validity mask (1/True = attend).  On the route's terms the
    flash kernels run (their plain versions for a CPU tensor); otherwise
    :func:`scaled_dot_product_attention` with the mask as a boolean
    ``[B, 1, 1, S]``.  With dropout the kernel seed is an int32 tensor
    drawn on the query's device from the port's generator there
    (``framework.random``), which the kernels read on the card: a CUDA
    graph draws a new one at each replay.  The JAX package draws it from
    its own key chain, so the two packages' draws differ; pass an
    explicit ``seed`` to ``flash_attention_bshd`` to share bits."""
    if _pallas_ok(query, key):
        query, key, value = cast_inputs("flash_attention", query, key, value)
        seed = None
        if dropout > 0.0:
            seed = torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=generator(query.device),
                                 device=query.device, dtype=torch.int32)
        out = flash_attention_bshd(query, key, value, causal=causal,
                                   kv_mask=kv_mask, dropout_p=dropout,
                                   seed=seed)
    else:
        mask4 = None
        if kv_mask is not None:
            mask4 = (kv_mask > 0)[:, None, None, :]
        out = scaled_dot_product_attention(query, key, value,
                                           attn_mask=mask4,
                                           dropout_p=dropout,
                                           is_causal=causal)
    if return_softmax:
        return out, None
    return out


def paged_attention(query, key_pages, value_pages, page_tables, seq_lens,
                    key_scales=None, value_scales=None, name=None):
    """Decode-time paged attention over a block-paged KV cache (the split
    serving programs' attention primitive).

    query        [B, H, D]    one query per row
    key_pages    [N, P, H, D] global K page pool (P = page size)
    value_pages  [N, P, H, D] global V page pool
    page_tables  [B, M] int32 per-row page ids (pad with 0, the trash
                              page)
    seq_lens     [B] int32    valid KV length per row (0 = inactive)
    key_scales   [N, H] f32   per-page-per-head dequant scales, required
                              (with value_scales) when the pools are int8
    value_scales [N, H] f32

    Returns [B, H, D]; scale 1/sqrt(D) applied inside.  Routes through
    ``ops.paged_attention.paged_attention``: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    from .paged_attention import paged_attention as _core

    if (key_scales is None) != (value_scales is None):
        raise ValueError("key_scales and value_scales must be passed "
                         "together (per-page-per-head [N, H] fp32)")
    return _core(query, key_pages, value_pages, page_tables, seq_lens,
                 key_scales, value_scales)
