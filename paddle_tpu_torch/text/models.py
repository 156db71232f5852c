"""GPT as a ``torch.nn.Module`` — twin of
``paddle_tpu/text/models.py:125-180`` (``GPTDecoderLayer``,
``GPTModel``) and of the self-attention path of
``paddle_tpu/nn/transformer.py`` ``MultiHeadAttention``.

Parameter names match the JAX package's ``get_state`` names exactly
(``wte.weight``, ``wpe.weight``,
``layers.{i}.{ln1,attn.{q,k,v,out}_proj,ln2,fc1,fc2}.{weight,bias}``,
``ln_f.{weight,bias}``; the LM head is tied to ``wte``).  Linear layers
are ``torch.nn.Linear`` and so store ``[out, in]``; the JAX package
stores ``[in, out]`` and computes ``x @ W`` — :func:`load_numpy_state`
transposes on the way in.

``GPTModel.forward(input_ids)`` is the full-sequence causal forward of
the training slice: every layer's attention goes through
``ops.attention.scaled_dot_product_attention`` (the flash kernels on the
card), LayerNorm and GELU are the serving path's ``_ln`` and ``_gelu``.
The parameters are trainable, as a paddle ``Layer``'s are; the serving
steps (``text/generation.py``) run under ``torch.no_grad()`` on detached
weights and build no graph.

Under ``amp.auto_cast`` the forward casts where the JAX package's
``apply`` casts (``bench.py`` trains under
``auto_cast(dtype="bfloat16")``): the linear layers and the tied head
are on the white list, so their input and their f32 master weight (and
bias) are cast and the product runs in bf16; attention gets bf16 q, k,
v, so the bf16 flash bodies run; GELU runs in its input's dtype,
LayerNorm returns its input's, residual adds promote bf16 + f32 to f32
and the loss (``cross_entropy``, black list) reads the logits in f32.
The parameters, their gradients and the optimizer state stay f32.
With ``auto_cast`` off every layer runs as before, in the parameters'
dtype.  Level O1 only: under O2 the JAX package's ``apply`` casts every
op off the black list (GELU, LayerNorm, the adds too), which this
forward does not do, so it raises there.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..amp.auto_cast import amp_state, cast_inputs, should_cast
from ..nn import functional as F

__all__ = ["GPTModel", "load_numpy_state", "numpy_state"]

_LINEARS = ("attn.q_proj", "attn.k_proj", "attn.v_proj", "attn.out_proj",
            "fc1", "fc2")


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        if hidden % heads:
            raise ValueError(f"hidden {hidden} not divisible by heads {heads}")
        self.num_heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, attn_mask=None, is_causal=False):
        """``MultiHeadAttention.forward`` as self-attention without a
        cache: project, split heads to ``[B, S, H, D]``, attend
        (``is_causal`` combines with a padding mask), merge heads,
        ``out_proj``.  No attention dropout (the slice trains with
        ``dropout=0.0``)."""
        B, S, E = x.shape
        H = self.num_heads

        def heads(proj):
            return _linear(proj, x).reshape(B, S, H, E // H)

        out = F.scaled_dot_product_attention(
            heads(self.q_proj), heads(self.k_proj), heads(self.v_proj),
            attn_mask=attn_mask, is_causal=is_causal, training=self.training)
        return _linear(self.out_proj, out.reshape(B, S, E))


class GPTDecoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, ffn: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(hidden)
        self.attn = _Attention(hidden, heads)
        self.ln2 = nn.LayerNorm(hidden)
        self.fc1 = nn.Linear(hidden, ffn)
        self.fc2 = nn.Linear(ffn, hidden)

    def forward(self, x, mask=None, causal=False):
        """Pre-LN block: ``x + attn(ln1(x))``, then
        ``x + fc2(gelu(fc1(ln2(x))))``."""
        h = _layer_norm(self.ln1, x)
        x = x + self.attn(h, attn_mask=mask,
                          is_causal=causal and mask is None)
        h = _layer_norm(self.ln2, x)
        return x + _linear(self.fc2, F.gelu(_linear(self.fc1, h)))


def _layer_norm(ln: nn.LayerNorm, x):
    return F.layer_norm(x, x.shape[-1], ln.weight, ln.bias, ln.eps)


def _linear(lin: nn.Linear, x):
    """``lin(x)``; under ``auto_cast`` the "linear" op of the JAX package:
    x, the weight and the bias cast to the AMP dtype, then
    ``x @ Wᵀ + b`` (the product and the add each rounded to it)."""
    if should_cast("linear") is None:
        return lin(x)
    x, w, b = cast_inputs("linear", x, lin.weight, lin.bias)
    return torch.matmul(x, w.t()) + b


class GPTModel(nn.Module):
    """Decoder-only causal LM (pre-LN, exact-erf GELU, tied head).

    ``device=None`` means the CUDA card (raises without one).  Weights
    are initialised from ``seed`` with an explicit generator on the
    target device: N(0, 0.02) for embeddings and linear weights, zero
    biases, unit LayerNorm scales.  Tests instead load the JAX model's
    weights with :func:`load_numpy_state`."""

    def __init__(self, vocab_size: int = 50304, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 ffn_size: int = 3072, max_seq_len: int = 1024, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        dev = resolve_device(device)
        # build on the meta device (no ambient-RNG initialisation), then
        # materialise on the target device and fill from the seed
        with torch.device("meta"):
            self.wte = nn.Embedding(vocab_size, hidden_size)
            self.wpe = nn.Embedding(max_seq_len, hidden_size)
            self.layers = nn.ModuleList([
                GPTDecoderLayer(hidden_size, num_heads, ffn_size)
                for _ in range(num_layers)])
            self.ln_f = nn.LayerNorm(hidden_size)
        self.to_empty(device=dev)
        self.to(dtype)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: Optional[int] = 0):
        gen = torch.Generator(device=self.wte.weight.device)
        gen.manual_seed(0 if seed is None else int(seed))
        for name, p in self.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            elif ".ln" in name or name.startswith("ln_f"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, input_ids):
        """Full-sequence causal logits ``[B, S, vocab]`` for ``input_ids``
        ``[B, S]``: ``wte + wpe``, the causal layers, ``ln_f`` and the
        head tied to ``wte``."""
        state = amp_state()
        if state.enabled and state.level == "O2":
            raise NotImplementedError(
                "GPTModel casts as auto_cast level O1 does; level O2 (every "
                "op off the black list in low precision) is not ported")
        ids = torch.as_tensor(input_ids, device=self.device).long()
        S = ids.shape[1]
        pos = torch.arange(S, device=self.device)
        x = self.wte(ids) + self.wpe(pos)
        # causal masking rides the attention op (is_causal: the flash
        # route), never a materialized S x S mask
        for layer in self.layers:
            x = layer(x, causal=True)
        x = _layer_norm(self.ln_f, x)
        # the head is F.linear in the JAX GPT
        x, w = cast_inputs("linear", x, self.wte.weight)
        return torch.matmul(x, w.t())


def _is_linear_weight(name: str) -> bool:
    return name.endswith(".weight") and any(
        f".{lin}.weight" in name for lin in _LINEARS)


@torch.no_grad()
def load_numpy_state(model: GPTModel, state: Dict[str, np.ndarray]):
    """The weight bridge: load ``{name: np.ndarray}`` as the JAX package
    produces it (``{k: np.asarray(v) for k, v in
    paddle_tpu.jit.functional.get_state(jax_model)[0].items()}``).

    Linear weights arrive ``[in, out]`` and are transposed into
    ``nn.Linear``'s ``[out, in]``; every other tensor copies as is.  The
    key sets must match exactly, as must every shape."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    for name, p in params.items():
        arr = np.asarray(state[name])
        if _is_linear_weight(name):
            arr = arr.T
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: state shape {arr.shape} vs model "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(arr, dtype=p.dtype))
    return model


def numpy_state(model: GPTModel) -> Dict[str, np.ndarray]:
    """Inverse of :func:`load_numpy_state`: the weights under the JAX
    names and layout (linear weights ``[in, out]``)."""
    out = {}
    for name, p in model.named_parameters():
        arr = p.detach().cpu().float().numpy()
        out[name] = np.ascontiguousarray(arr.T if _is_linear_weight(name)
                                         else arr)
    return out
