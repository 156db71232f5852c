"""paddle_tpu_torch.nn.functional — the functionals the GPT training
slice runs, twins of ``paddle_tpu/nn/functional``.

``gelu`` (exact erf) and ``layer_norm`` (f32 statistics, population
variance) are the serving path's ``_gelu`` and ``_ln`` from
``text/generation.py``; the attention entries are
``ops/attention.py``'s, re-exported as the JAX package re-exports them.
"""
from __future__ import annotations

from ...text.generation import _gelu, _ln
from .loss import cross_entropy

__all__ = ["gelu", "layer_norm", "cross_entropy",
           "scaled_dot_product_attention", "flash_attention"]


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
