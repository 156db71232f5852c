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
JAX package re-exports them.
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
              "paged_attention"])


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
