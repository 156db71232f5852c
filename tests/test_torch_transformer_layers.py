"""paddle_tpu_torch's ``nn/transformer.py`` against the JAX package on the
same weights: ``MultiHeadAttention`` (masks of every form, ``is_causal``,
cross-attention, ``need_weights``, its ``Cache`` and ``StaticCache``),
the encoder and decoder layers and stacks with ``gen_cache``, and
``Transformer``.

Each case builds the layer in both packages from one constructor call and
copies paddle_tpu's weights into the port; the ``state_dict`` names must
be equal, in order (``tests/torch_layer_parity.py``).  Tolerances:
forward 1e-5 absolute and relative, input and parameter gradients 1e-4.
Cached decoding must equal the full forward within 1e-5 in both
packages.  ``PADDLE_TPU_FORCE_FLASH=1`` runs the flash route's bodies on
the CPU in both (the port's plain version, paddle_tpu's Pallas kernel in
interpret mode).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.ops import attention as jattn
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import attention as tattn
from torch_layer_parity import FWD
from torch_layer_parity import build as _build
from torch_layer_parity import compare as _compare
from torch_layer_parity import one_torch_thread_on_the_cpu
from torch_layer_parity import rand as _x


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


# --- nn/transformer.py -----------------------------------------------------
B, S, E, NH = 2, 6, 16, 4


def _causal4():
    return np.triu(np.full((S, S), -np.inf, np.float32), 1)[None, None]


MHA_CASES = {
    "self": (lambda m: m.MultiHeadAttention(E, NH), [_x(B, S, E)],
             lambda layer, x: layer(x)),
    "bool_mask": (lambda m: m.MultiHeadAttention(E, NH),
                  [_x(B, S, E), np.tril(np.ones((B, 1, S, S), bool))],
                  lambda layer, x, mask: layer(x, attn_mask=mask)),
    "float_mask": (lambda m: m.MultiHeadAttention(E, NH),
                   [_x(B, S, E), _causal4() + _x(1, 1, S, S, seed=4)],
                   lambda layer, x, mask: layer(x, attn_mask=mask)),
    "padding_mask": (lambda m: m.MultiHeadAttention(E, NH),
                     [_x(B, S, E), np.asarray([[1] * S, [1] * 4 + [0] * 2],
                                              np.float32)],
                     lambda layer, x, mask: layer(x, attn_mask=mask)),
    "causal": (lambda m: m.MultiHeadAttention(E, NH), [_x(B, S, E)],
               lambda layer, x: layer(x, is_causal=True)),
    "cross_kdim": (lambda m: m.MultiHeadAttention(E, NH, kdim=8, vdim=12),
                   [_x(B, S, E), _x(B, 3, 8), _x(B, 3, 12)],
                   lambda layer, q, k, v: layer(q, k, v)),
    "need_weights": (lambda m: m.MultiHeadAttention(E, NH,
                                                    need_weights=True),
                     [_x(B, S, E), np.tril(np.ones((B, 1, S, S), bool))],
                     lambda layer, x, mask: layer(x, attn_mask=mask)),
    "need_weights_causal_float": (
        lambda m: m.MultiHeadAttention(E, NH, need_weights=True),
        [_x(B, S, E), _x(1, 1, S, S, seed=4)],
        lambda layer, x, mask: layer(x, attn_mask=mask, is_causal=True)),
}


@pytest.mark.parametrize("name", sorted(MHA_CASES))
def test_multi_head_attention(name):
    factory, inputs, call = MHA_CASES[name]
    jl, tl = _build(factory)
    _compare(jl, tl, inputs, call=call)


def _enc(m, **kw):
    return m.TransformerEncoderLayer(E, NH, 32, dropout=0.0, **kw)


def _dec(m, **kw):
    return m.TransformerDecoderLayer(E, NH, 32, dropout=0.0, **kw)


STACK_CASES = {
    "encoder_layer": (lambda m: _enc(m), [_x(B, S, E)],
                      lambda layer, x: layer(x)),
    "encoder_layer_pre_gelu": (
        lambda m: _enc(m, normalize_before=True, activation="gelu"),
        [_x(B, S, E), np.asarray([[1] * S, [1] * 3 + [0] * 3], np.float32)],
        lambda layer, x, mask: layer(x, src_mask=mask)),
    "encoder": (lambda m: m.TransformerEncoder(_enc(m), 2, m.LayerNorm(E)),
                [_x(B, S, E)], lambda layer, x: layer(x)),
    "decoder_layer": (lambda m: _dec(m),
                      [_x(B, S, E), _x(B, S, E, seed=1), _causal4()],
                      lambda layer, t, mem, mask: layer(t, mem, mask)),
    "decoder": (lambda m: m.TransformerDecoder(
        _dec(m, normalize_before=True), 1, m.LayerNorm(E)),
        [_x(B, S, E), _x(B, S, E, seed=1)],
        lambda layer, t, mem: layer(t, mem)),
    "transformer": (lambda m: m.Transformer(
        E, NH, 2, 2, 32, dropout=0.0),
        [_x(B, S, E), _x(B, S, E, seed=1),
         np.asarray([[1] * S, [1] * 5 + [0]], np.float32), _causal4()],
        lambda layer, src, tgt, sm, tm: layer(src, tgt, src_mask=sm,
                                              tgt_mask=tm)),
}


@pytest.mark.parametrize("name", sorted(STACK_CASES))
def test_transformer_stack(name):
    factory, inputs, call = STACK_CASES[name]
    jl, tl = _build(factory)
    _compare(jl, tl, inputs, call=call)


def test_square_subsequent_mask():
    want = jnn.Transformer.generate_square_subsequent_mask(5).numpy()
    got = tnn.Transformer.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("name", ["self", "padding_mask", "causal"])
def test_mha_on_the_flash_route(monkeypatch, name):
    """Self-attention under PADDLE_TPU_FORCE_FLASH=1: the flash bodies in
    both packages (the port's plain version, paddle_tpu's kernel in
    interpret mode), each counted on its route."""
    monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", "1")
    factory, inputs, call = MHA_CASES[name]
    jl, tl = _build(factory)
    j0, t0 = jattn.ROUTE_STATS["pallas"], tattn.ROUTE_STATS["pallas"]
    _compare(jl, tl, inputs, call=call)
    assert jattn.ROUTE_STATS["pallas"] == j0 + 1
    assert tattn.ROUTE_STATS["pallas"] == t0 + 1


def test_encoder_layer_on_the_flash_route(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", "1")
    factory, inputs, call = STACK_CASES["encoder_layer_pre_gelu"]
    jl, tl = _build(factory)
    t0 = tattn.ROUTE_STATS["pallas"]
    _compare(jl, tl, inputs, call=call)
    assert tattn.ROUTE_STATS["pallas"] == t0 + 1


def _incremental(layer, x, cache, step):
    outs = []
    for t in range(x.shape[1]):
        o, cache = step(layer, x[:, t:t + 1], cache)
        outs.append(o)
    return outs, cache


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_mha_caches_equal_the_full_forward(pkg):
    m, mod = (jnn, paddle) if pkg == "jax" else (tnn, pt)
    jl, tl = _build(lambda n: n.MultiHeadAttention(E, NH))
    layer = jl if pkg == "jax" else tl
    layer.eval()
    x, mem = mod.to_tensor(_x(B, 3, E)), mod.to_tensor(_x(B, 5, E, seed=1))
    full = layer(x, is_causal=True).numpy()
    outs, cache = _incremental(
        layer, x, layer.gen_cache(x),
        lambda lyr, xt, c: lyr(xt, xt, xt, None, c))
    assert isinstance(cache, m.MultiHeadAttention.Cache)
    assert cache.k.shape == [B, 3, NH, E // NH]
    np.testing.assert_allclose(np.concatenate([o.numpy() for o in outs], 1),
                               full, **FWD)
    static = layer.gen_cache(mem, mem, type=m.MultiHeadAttention.StaticCache)
    np.testing.assert_allclose(layer(x, None, None, None, static).numpy(),
                               layer(x, mem, mem).numpy(), **FWD)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_decoder_gen_cache_equals_the_causal_forward(pkg):
    mod = paddle if pkg == "jax" else pt
    jl, tl = _build(lambda n: n.TransformerDecoder(_dec(n), 2))
    layer = jl if pkg == "jax" else tl
    tgt, mem = mod.to_tensor(_x(B, 3, E)), mod.to_tensor(_x(B, 5, E, seed=1))
    full = layer(tgt, mem, tgt_mask=mod.to_tensor(
        _causal4()[..., :3, :3])).numpy()
    outs, _ = _incremental(
        layer, tgt, layer.gen_cache(mem),
        lambda lyr, xt, c: lyr(xt, mem, None, None, c))
    np.testing.assert_allclose(np.concatenate([o.numpy() for o in outs], 1),
                               full, **FWD)


def test_decoder_gen_cache_matches_across_packages():
    jl, tl = _build(lambda n: n.TransformerDecoder(_dec(n), 2))
    got = []
    for layer, mod in ((jl, paddle), (tl, pt)):
        tgt = mod.to_tensor(_x(B, 3, E))
        mem = mod.to_tensor(_x(B, 5, E, seed=1))
        outs, cache = _incremental(
            layer, tgt, layer.gen_cache(mem),
            lambda lyr, xt, c: lyr(xt, mem, None, None, c))
        got.append([o.numpy() for o in outs] + [cache[1][0].k.numpy()])
    for t, j in zip(got[1], got[0]):
        np.testing.assert_allclose(t, j, **FWD)
    zipped = tl.gen_cache(pt.to_tensor(_x(B, 5, E)), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
