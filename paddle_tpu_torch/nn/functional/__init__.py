"""paddle_tpu_torch.nn.functional — the functionals the GPT serving and
training slices and the dygraph core run, twins of
``paddle_tpu/nn/functional``.

``gelu`` (exact erf) and ``layer_norm`` (f32 statistics, population
variance) are the serving path's ``_gelu`` and ``_ln`` from
``text/generation.py``; the attention entries are
``ops/attention.py``'s (flash and paged), re-exported as the JAX package
re-exports them.
"""
from __future__ import annotations

from ...text.generation import _gelu, _ln
from .activation import relu
from .common import linear
from .conv import conv2d
from .loss import cross_entropy
from .pooling import max_pool2d

__all__ = ["gelu", "layer_norm", "cross_entropy", "linear", "conv2d",
           "max_pool2d", "relu", "scaled_dot_product_attention",
           "flash_attention", "paged_attention"]


def gelu(x, approximate=False, name=None):
    """Exact GELU (erf form); the tanh approximation is not ported."""
    if approximate:
        from ...framework.errors import InvalidArgumentError

        raise InvalidArgumentError(
            "gelu(approximate=True) is not ported yet (ROADMAP queue 1 "
            "item 8)")
    return _gelu(x)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the last axis with f32 statistics and population
    variance, cast back to x's dtype."""
    shape = ((normalized_shape,) if isinstance(normalized_shape, int)
             else tuple(normalized_shape))
    if len(shape) != 1 or shape[0] != x.shape[-1]:
        from ...framework.errors import InvalidArgumentError

        raise InvalidArgumentError(
            f"layer_norm over {shape} of a {tuple(x.shape)} input: only the "
            "last axis is ported (ROADMAP queue 1 item 8)")
    w = weight if weight is not None else 1.0
    b = bias if bias is not None else 0.0
    return _ln(x, w, b, epsilon)


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
