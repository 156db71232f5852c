"""paddle_tpu_torch.nn.functional — the functionals the GPT serving and
training slices, the dygraph core, the sequence layers and the losses of
``nn/loss_layers.py`` run, twins of
``paddle_tpu/nn/functional``.

``gelu`` (exact erf) and ``layer_norm`` (f32 statistics, population
variance) are the serving path's ``_gelu`` and ``_ln``; they dispatch as
"gelu" and "layer_norm" on a port ``Tensor``, and on a plain torch
tensor (the torch-module ``GPTModel``) return one.  The attention
entries are ``ops/attention.py``'s (flash and paged), re-exported as the
JAX package re-exports them.
"""
from __future__ import annotations

import torch

from ...text.generation import _ln
from .activation import gelu, log_softmax, relu, sigmoid, softmax, tanh
from .common import dropout, embedding, linear
from .conv import conv2d
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, ctc_loss, dice_loss, hinge_embedding_loss,
                   kl_div, l1_loss, log_loss, margin_ranking_loss, mse_loss,
                   nll_loss, npair_loss, sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .pooling import max_pool2d

__all__ = ["gelu", "layer_norm", "cross_entropy", "softmax_with_cross_entropy",
           "nll_loss", "mse_loss", "l1_loss", "smooth_l1_loss",
           "square_error_cost", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "npair_loss",
           "log_loss", "ctc_loss", "dice_loss", "sigmoid_focal_loss",
           "linear", "dropout",
           "embedding", "conv2d", "max_pool2d", "relu", "sigmoid", "tanh",
           "softmax", "log_softmax", "scaled_dot_product_attention",
           "flash_attention", "paged_attention"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing axes ``normalized_shape`` names, with
    f32 statistics and population variance, cast back to x's dtype."""
    from ...ops._helpers import to_tensor_like
    from ...ops.dispatch import apply

    shape = ((normalized_shape,) if isinstance(normalized_shape, int)
             else tuple(normalized_shape))
    if tuple(x.shape[len(x.shape) - len(shape):]) != shape:
        from ...framework.errors import InvalidArgumentError

        raise InvalidArgumentError(
            f"layer_norm over {shape} of a {tuple(x.shape)} input: the "
            "normalized shape must be the input's trailing axes")
    dims = tuple(range(-len(shape), 0))
    has_w, has_b = weight is not None, bias is not None

    def f(v, *wb):
        return _ln(v, wb[0] if has_w else 1.0, wb[-1] if has_b else 0.0,
                   epsilon, dims)

    wb = [t for t in (weight, bias) if t is not None]
    if isinstance(x, torch.Tensor):
        return f(x, *wb)
    return apply("layer_norm", f, to_tensor_like(x),
                 *map(to_tensor_like, wb))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    from ...ops.attention import scaled_dot_product_attention as _sdpa

    return _sdpa(query, key, value, attn_mask=attn_mask,
                 dropout_p=dropout_p, is_causal=is_causal,
                 training=training)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, name=None):
    from ...ops.attention import flash_attention as _fa

    return _fa(query, key, value, dropout=dropout, causal=causal,
               return_softmax=return_softmax)


def paged_attention(query, key_pages, value_pages, page_tables, seq_lens,
                    key_scales=None, value_scales=None, name=None):
    """Decode-time paged attention over a block-paged KV cache; see
    ``ops/attention.py`` for the contract.  Pass per-page-per-head
    ``key_scales``/``value_scales`` when the page pools are int8."""
    from ...ops.attention import paged_attention as _pa

    return _pa(query, key_pages, value_pages, page_tables, seq_lens,
               key_scales, value_scales)
