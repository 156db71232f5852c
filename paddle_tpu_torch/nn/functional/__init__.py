"""paddle_tpu_torch.nn.functional — twins of ``paddle_tpu/nn/functional``:
the activations, the common functionals (``linear``, the dropouts,
``embedding``, ``pad``, ``interpolate``, the shuffles, ``unfold`` /
``fold``, the sampling grids, ...), the convolutions, the losses, the
norms and the pools, under the JAX package's names; of the fluid surface
(``extension.py``) only ``hsigmoid_loss`` and ``nce``, with ``erf`` and
``gather_tree``.

``gelu`` (exact erf) and ``layer_norm`` (f32 statistics, population
variance) are the serving path's ``_gelu`` and ``_ln``; they dispatch as
"gelu" and "layer_norm" on a port ``Tensor``, and on a plain torch
tensor (the torch-module ``GPTModel``) return one.  The attention
entries are ``ops/attention.py``'s (flash and paged), re-exported as the
JAX package re-exports them, and ``distributed/ring_attention.py``'s
``ring_attention``.
"""
from __future__ import annotations

from . import activation as _activation
from . import common as _common
from . import conv as _conv
from . import loss as _loss
from . import norm as _norm
from . import pooling as _pooling
from ...ops.math import erf  # noqa: F401
from ..decode import gather_tree  # noqa: F401
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extension import hsigmoid_loss, nce  # noqa: F401
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403

__all__ = (list(_activation.__all__) + list(_common.__all__)
           + list(_conv.__all__) + list(_loss.__all__) + list(_norm.__all__)
           + list(_pooling.__all__)
           + ["hsigmoid_loss", "nce", "erf", "gather_tree",
              "scaled_dot_product_attention", "flash_attention",
              "paged_attention", "ring_attention"])


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """``ops/attention.py``'s entry; port Tensors dispatch as
    "scaled_dot_product_attention", plain torch tensors (the
    torch-module models) call it directly."""
    from ...ops.attention import scaled_dot_product_attention as _sdpa

    def f(q, k, v, *mask):
        return _sdpa(q, k, v, attn_mask=mask[0] if mask else None,
                     dropout_p=dropout_p, is_causal=is_causal,
                     training=training)

    return _attention_entry("scaled_dot_product_attention", f, query, key,
                            value, attn_mask)


def ring_attention(query, key, value, axis_name="sp", causal=False,
                   name=None):
    """Context-parallel attention over a mesh axis (the sequence sharded
    over ``axis_name`` of the installed mesh; ``distributed/
    ring_attention.py``): global ``[B, S, H, D]`` in and out."""
    from ...distributed.ring_attention import sequence_parallel_attention
    from ...ops._helpers import to_tensor_like
    from ...tensor import Tensor

    q = to_tensor_like(query)
    out = sequence_parallel_attention(q._value, to_tensor_like(key)._value,
                                      to_tensor_like(value)._value,
                                      axis_name=axis_name, causal=causal)
    return Tensor(out)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, name=None):
    """``ops/attention.py``'s flash entry, dispatched as
    "flash_attention" on port Tensors."""
    from ...ops.attention import flash_attention as _fa

    def f(q, k, v):
        return _fa(q, k, v, dropout=dropout, causal=causal)

    out = _attention_entry("flash_attention", f, query, key, value, None)
    return (out, None) if return_softmax else out


def _attention_entry(name, f, query, key, value, mask):
    import torch

    from ...ops.dispatch import apply

    masks = [] if mask is None else [mask]
    if isinstance(query, torch.Tensor):
        return f(query, key, value, *masks)
    return apply(name, f, query, key, value, *masks)


def paged_attention(query, key_pages, value_pages, page_tables, seq_lens,
                    key_scales=None, value_scales=None, name=None):
    """Decode-time paged attention over a block-paged KV cache; see
    ``ops/attention.py`` for the contract.  Pass per-page-per-head
    ``key_scales``/``value_scales`` when the page pools are int8."""
    from ...ops.attention import paged_attention as _pa

    return _pa(query, key_pages, value_pages, page_tables, seq_lens,
               key_scales, value_scales)
