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

Programs: the routing above is decided on the tensors a call gets, so a
program must not decide it where it is traced.  On a tensor with no data
(a fake tensor of a static Program being built or of a ``torch.export``
trace — ``jit.save``, ``Program.save`` and ``save_train``) the attention
is the operator ``paddle_tpu_torch::attention``, registered when this
module is imported, with a fake function for its shape and a backward:
its one implementation is the routing above, run where the program
runs, so an artifact saved on the CPU launches the flash kernels on the
card and one saved on the card runs the plain route on the CPU.  It
returns the dropout seed it drew beside the output; its backward,
``paddle_tpu_torch::attention_bwd``, routes the same way on the same
seed and recomputes the forward (the flash forward kernel again, then
the dK/dV and dQ kernels; or the plain route's gradients), as the
operator keeps no softmax statistics.  The plain route inside the
operator draws its dropout bits from the flash hash of that seed.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from ..amp.auto_cast import cast_inputs
from ..framework.export_compat import is_placeholder
from ..framework.random import generator
from ..profiler.jit_cost import count_launch
from .flash_attention import (NEG_INF, _flash_bwd_bhsd, _flash_fwd_bhsd,
                              _keep, _mask2d, flash_attention_bshd)

__all__ = ["ROUTE_STATS", "scaled_dot_product_attention", "flash_attention",
           "paged_attention"]

ROUTE_STATS = {"pallas": 0, "xla": 0}


def _logits(q, k, mask, is_causal, scale):
    """f32 logits of plain attention on ``[B, H, S, D]``, masked: the
    finite ``NEG_INF`` sentinel for causal and boolean masks, a float
    mask added."""
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
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
    return logits


def _hash_keep(seed, p, dropout_p):
    """Keep bits of ``p`` [B, H, Sq, Sk] from the flash hash of ``seed``."""
    B, H, Sq, Sk = p.shape
    rows = torch.arange(Sq, device=p.device)[:, None]
    cols = torch.arange(Sk, device=p.device)[None, :]
    return _keep(seed, B, H, rows, cols, dropout_p, p.device)


def _sdpa_core(q, k, v, mask, dropout_p, is_causal, scale=None, seed=None):
    """Plain attention on ``[B, H, S, D]``: f32 logits (:func:`_logits`),
    the softmax cast back to q's dtype.  Dropout draws from the port's
    generator of q's device (``framework.random``), so its bits differ
    from the JAX package's; only the flash route's bits are shared.
    Given a ``seed`` (the attention operator's), the bits are the flash
    hash's of it instead."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    p = torch.softmax(_logits(q, k, mask, is_causal, s), dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        if seed is None:
            keep = torch.rand(p.shape, generator=generator(p.device),
                              device=p.device) >= dropout_p
        else:
            keep = _hash_keep(seed, p, dropout_p)
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
    attention.  On a tensor with no data it is the
    ``paddle_tpu_torch::attention`` operator, which routes when the
    program runs (module docstring)."""
    drop = dropout_p if training else 0.0
    if is_placeholder(query):
        return _attention_op(query, key, value, attn_mask, float(drop),
                             bool(is_causal))[0]
    return _route(query, key, value, attn_mask, drop, is_causal)


def _plain(query, key, value, attn_mask, drop, is_causal, seed=None):
    """The plain route, ``[B, S, H, D]`` in and out."""
    query, key, value, attn_mask = cast_inputs(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    out = _sdpa_core(query.transpose(1, 2), key.transpose(1, 2),
                     value.transpose(1, 2), attn_mask, drop, is_causal,
                     seed=seed)
    return out.transpose(1, 2).to(query.dtype)


def _flash_terms(query, key, attn_mask):
    """(whether the call takes the flash route, its ``[B, S]`` kv mask
    or None)."""
    if not _pallas_ok(query, key):
        return False, None
    if attn_mask is None:
        return True, None
    kv_mask = _as_kv_mask(attn_mask, key.shape[0], key.shape[1])
    return kv_mask is not None, kv_mask


def _route(query, key, value, attn_mask, drop, is_causal):
    """The run-time routing of :func:`scaled_dot_product_attention`."""
    flash, kv_mask = _flash_terms(query, key, attn_mask)
    if flash:
        count_launch(ROUTE_STATS, "pallas")
        return flash_attention(query, key, value, dropout=drop,
                               causal=is_causal, kv_mask=kv_mask)
    count_launch(ROUTE_STATS, "xla")
    return _plain(query, key, value, attn_mask, drop, is_causal)


@torch.library.custom_op("paddle_tpu_torch::attention", mutates_args=())
def _attention_op(query: torch.Tensor, key: torch.Tensor,
                  value: torch.Tensor, attn_mask: Optional[torch.Tensor],
                  dropout_p: float,
                  is_causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, seed): :func:`_route`'s choice, made where the program runs
    (the flash kernels on their terms — a CUDA tensor, D <= 256,
    S >= 128, a padding-style mask — else the plain route), on an int32
    seed drawn from the port's generator (zero without dropout)."""
    if dropout_p > 0.0:
        seed = torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=generator(query.device),
                             device=query.device, dtype=torch.int32)
    else:
        seed = torch.zeros((1,), dtype=torch.int32, device=query.device)
    flash, kv_mask = _flash_terms(query, key, attn_mask)
    if flash:
        count_launch(ROUTE_STATS, "pallas")
        q, k, v = cast_inputs("flash_attention", query, key, value)
        out = flash_attention_bshd(q, k, v, causal=is_causal,
                                   kv_mask=kv_mask, dropout_p=dropout_p,
                                   seed=seed)
    else:
        count_launch(ROUTE_STATS, "xla")
        out = _plain(query, key, value, attn_mask, dropout_p, is_causal,
                     seed=seed)
    return out.contiguous(), seed


@_attention_op.register_fake
def _attention_op_fake(query, key, value, attn_mask, dropout_p, is_causal):
    return (query.new_empty(tuple(query.shape[:-1]) + (value.shape[-1],)),
            query.new_empty((1,), dtype=torch.int32))


@torch.library.custom_op("paddle_tpu_torch::attention_bwd", mutates_args=())
def _attention_bwd_op(query: torch.Tensor, key: torch.Tensor,
                      value: torch.Tensor, attn_mask: Optional[torch.Tensor],
                      dropout_p: float, is_causal: bool, seed: torch.Tensor,
                      grad: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`_attention_op` on the same route and seed,
    the forward recomputed."""
    flash, kv_mask = _flash_terms(query, key, attn_mask)
    if flash:
        q, k, v = cast_inputs("flash_attention", query, key, value)
        B, S, _, D = q.shape
        scale = 1.0 / math.sqrt(D)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = _mask2d(kv_mask, B, S, q.device).contiguous()
        o, lse = _flash_fwd_bhsd(qt, kt, vt, mask, seed, scale, is_causal,
                                 dropout_p)
        g = grad.to(o.dtype).transpose(1, 2).contiguous()
        grads = [t.transpose(1, 2) for t in _flash_bwd_bhsd(
            qt, kt, vt, o, lse, g, mask, seed, scale, is_causal, dropout_p)]
    else:
        grads = _plain_grads(query, key, value, attn_mask, dropout_p,
                             is_causal, seed, grad)
    return tuple(gr.to(x.dtype).contiguous()
                 for gr, x in zip(grads, (query, key, value)))


@_attention_bwd_op.register_fake
def _attention_bwd_fake(query, key, value, attn_mask, dropout_p, is_causal,
                        seed, grad):
    return (query.new_empty(query.shape), key.new_empty(key.shape),
            value.new_empty(value.shape))


def _plain_grads(query, key, value, attn_mask, drop, is_causal, seed, grad):
    """Gradients of the plain route (``[B, S, H, D]``), in f32: P =
    softmax(logits), P' = P ⊙ keep / (1 − p), out = P'·V; dV = P'ᵀ·dO,
    dP = keep ⊙ (dO·Vᵀ) / (1 − p), dS = P ⊙ (dP − rowsum(dP ⊙ P)),
    dQ = scale · dS·K, dK = scale · dSᵀ·Q."""
    query, key, value, attn_mask = cast_inputs(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    q, k, v, g = (t.transpose(1, 2).float() for t in (query, key, value,
                                                       grad))
    scale = 1.0 / (q.shape[-1] ** 0.5)
    p = torch.softmax(_logits(q, k, attn_mask, is_causal, scale), dim=-1)
    dp = torch.matmul(g, v.transpose(-1, -2))
    p_v = p
    if drop > 0.0:
        keep = _hash_keep(seed, p, drop)
        p_v = torch.where(keep, p / (1.0 - drop), torch.zeros_like(p))
        dp = torch.where(keep, dp / (1.0 - drop), torch.zeros_like(dp))
    dv = torch.matmul(p_v.transpose(-1, -2), g)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _attention_setup(ctx, inputs, output):
    query, key, value, attn_mask, dropout_p, is_causal = inputs
    ctx.save_for_backward(query, key, value, attn_mask, output[1])
    ctx.dropout_p, ctx.is_causal = dropout_p, is_causal


def _attention_backward(ctx, grad, _grad_seed):
    query, key, value, attn_mask, seed = ctx.saved_tensors
    dq, dk, dv = _attention_bwd_op(query, key, value, attn_mask,
                                   ctx.dropout_p, ctx.is_causal, seed,
                                   grad.contiguous())
    return dq, dk, dv, None, None, None


_attention_op.register_autograd(_attention_backward,
                                setup_context=_attention_setup)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, kv_mask=None, name=None):
    """Flash attention entry, ``[B, S, H, D]``; ``kv_mask``: optional
    ``[B, S]`` validity mask (1/True = attend).  On the route's terms the
    flash kernels run (their plain versions for a CPU tensor); otherwise
    :func:`scaled_dot_product_attention` with the mask as a boolean
    ``[B, 1, 1, S]`` — also on a tensor with no data, so a program
    carries the ``paddle_tpu_torch::attention`` operator, which takes the
    flash route on the same terms where the program runs.  With dropout the kernel seed is an int32 tensor
    drawn on the query's device from the port's generator there
    (``framework.random``), which the kernels read on the card: a CUDA
    graph draws a new one at each replay.  The JAX package draws it from
    its own key chain, so the two packages' draws differ; pass an
    explicit ``seed`` to ``flash_attention_bshd`` to share bits."""
    if _pallas_ok(query, key) and not is_placeholder(query):
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
