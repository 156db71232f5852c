"""The transformer stack — twin of ``paddle_tpu/nn/transformer.py``:
``MultiHeadAttention`` with its ``Cache`` / ``StaticCache`` for
incremental decoding, ``TransformerEncoderLayer`` / ``Encoder``,
``TransformerDecoderLayer`` / ``Decoder`` and ``Transformer``.

Attention goes through ``ops/attention.py``'s
``scaled_dot_product_attention``, dispatched as that op: on the card,
self-attention at S >= 128 with no mask or a padding mask takes the
flash kernels (forward, and both backward kernels under autograd); a
dense causal mask, cross-attention and a cached step of one row take
the plain route, as in the JAX package.  ``need_weights`` runs the
explicit softmax (op "mha_weights"), with the JAX package's -1e30
sentinel for masked logits."""
from __future__ import annotations

import collections
import copy

import torch

from ..ops._helpers import to_tensor_like
from ..ops.dispatch import apply
from ..tensor import Tensor
from . import functional as F
from .common_layers import Dropout, Linear
from .container import LayerList
from .layer import Layer
from .norm_layers import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]

# the finite sentinel of a masked logit on the need_weights path
_MASKED = -1e30


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        from ..ops.manipulation import reshape

        b, s, _ = x.shape
        return reshape(x, [b, s, self.num_heads, self.head_dim])

    def gen_cache(self, key, value=None, type=Cache):
        """A ``StaticCache`` of ``key``'s (and ``value``'s) projected
        heads, or an incremental ``Cache``: empty ``[B, 0, H, D]`` K and V
        that each cached call extends, or ``Cache(key, value)`` when both
        are given."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(
                self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        if value is not None:
            return self.Cache(key, value)
        ref = to_tensor_like(key)

        def empty():
            return Tensor(torch.zeros(
                (ref.shape[0], 0, self.num_heads, self.head_dim),
                dtype=ref.dtype, device=ref.place))

        return self.Cache(empty(), empty())

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, is_causal=False):
        """``is_causal=True`` with no mask is causal masking without an
        S × S mask (the flash route's condition); it combines with a
        padding mask.  Returns the output, then the weights
        (``need_weights``), then the extended ``Cache`` (if one was
        given)."""
        from ..ops.manipulation import concat, reshape

        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = concat([cache.k, k], axis=1)
                v = concat([cache.v, v], axis=1)
                cache = self.Cache(k, v)
        mask = None if attn_mask is None else to_tensor_like(attn_mask)
        if self.need_weights:
            out, weights = self._attention_with_weights(q, k, v, mask,
                                                        is_causal)
        else:
            out = self._attention(q, k, v, mask, is_causal)
            weights = None
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(reshape(out, [b, s, self.embed_dim]))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None and not isinstance(cache, self.StaticCache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    def _attention(self, q, k, v, mask, is_causal):
        from ..ops.attention import scaled_dot_product_attention as sdpa

        drop, training = self.dropout, self.training

        def f(qq, kk, vv, *mm):
            return sdpa(qq, kk, vv, attn_mask=mm[0] if mm else None,
                        dropout_p=drop, is_causal=is_causal,
                        training=training)

        masks = [] if mask is None else [mask]
        return apply("scaled_dot_product_attention", f, q, k, v, *masks)

    def _attention_with_weights(self, q, k, v, mask, is_causal=False):
        from ..framework.random import generator

        scale = self.head_dim ** -0.5
        dropout = self.dropout if self.training else 0.0
        gen = generator(q.place) if dropout > 0 else None

        def f(qq, kk, vv, *mm):
            qt, kt, vt = (t.transpose(1, 2) for t in (qq, kk, vv))
            logits = torch.matmul(qt, kt.transpose(-1, -2)).float() * scale
            if is_causal:
                sq, sk = logits.shape[-2], logits.shape[-1]
                tri = torch.ones((sq, sk), dtype=torch.bool,
                                 device=qq.device).tril(diagonal=sk - sq)
                logits = torch.where(tri, logits,
                                     torch.full_like(logits, _MASKED))
            if mm:
                m = mm[0]
                if m.dim() == 2:                       # [B, S] validity
                    m = (m > 0.5)[:, None, None, :]
                if m.dtype == torch.bool:
                    logits = torch.where(m, logits,
                                         torch.full_like(logits, _MASKED))
                else:
                    logits = logits + m.float()
            p = torch.softmax(logits, dim=-1).to(qq.dtype)
            if gen is not None:
                keep = torch.rand(p.shape, generator=gen,
                                  device=p.device) < 1.0 - dropout
                p = torch.where(keep, p / (1.0 - dropout),
                                torch.zeros_like(p)).to(qq.dtype)
            return torch.matmul(p, vt).transpose(1, 2), p

        masks = [] if mask is None else [mask]
        return apply("mha_weights", f, q, k, v, *masks)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self.activation)
        src = self.linear2(self.dropout(act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             dropout=attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        act = getattr(F, self.activation)
        tgt = self.linear2(self.dropout(act(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache, cache[1]))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """A float32 ``[length, length]`` mask on the default place: 0 on
        and below the diagonal, -inf above."""
        from ..framework.place import default_device

        keep = torch.ones((length, length), dtype=torch.bool,
                          device=default_device()).tril()
        return Tensor(torch.zeros((length, length), device=keep.device)
                      .masked_fill(~keep, float("-inf")))
