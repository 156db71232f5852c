"""paddle_tpu_torch's BERT and functional execution against the JAX
package on shared weights.

- A 2-layer, hidden-64 ``BertForSequenceClassification`` and
  ``BertForQuestionAnswering`` (the JAX package's weights carried across
  by ``state_dict`` name) on token ids with a padding mask: the forward
  in eval and training mode (dropout 0), and one AdamW step of the
  port's twin of ``bench.py``'s ``build_step`` (``chip_smoke.py``,
  eager, f32) against the JAX package's form of it (``functional_call``
  under ``jax.value_and_grad``, then ``fused_step``): the loss and
  every parameter after the step.  Then the twin under bf16 autocast
  against ``bench.py``'s own ``build_step`` (which takes the ids alone).
- ``jit.functional_call`` / ``get_state``: bound tensors in, the layer's
  own tensors and modes back after, batch-norm buffers updated in place
  and returned.

Tolerances: f32 forward 1e-5 absolute and relative; the f32 loss 1e-5;
after one AdamW step every parameter within ``2 · lr`` of the JAX
package's and at most 1 % of the entries beyond ``5e-3 · lr``, as
``tests/test_torch_hapi.py`` holds its GPT: Adam's first step moves an
entry by ``lr · sign(g)`` whatever its gradient's size, so an entry
whose gradient is at the rounding floor steps ±lr in either package
(the key projection's bias always: its exact gradient is 0, a softmax
row being invariant to a constant added to its scores; it is left out
of the 1 %).  bf16: the loss within 2e-2 relative (logits rounded to 8
mantissa bits), every parameter within ``2 · lr``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit.functional import functional_call as jax_call
from paddle_tpu.jit.functional import get_state as jax_state
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.text import models as jmodels
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import functional_call, get_state
from paddle_tpu_torch.nn import state_from_numpy
from paddle_tpu_torch.text import models as tmodels
from torch_layer_parity import FWD, one_torch_thread_on_the_cpu

import bench
import chip_smoke

CFG = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
           max_position_embeddings=32)
B, S, LR = 4, 16, 5e-5
NOISE = "self_attn.k_proj.bias"


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1::2, S - S // 4:] = 0
    y = rng.randint(0, 2, (B,)).astype(np.int64)
    return ids, mask, y


def _pair(cls, **kw):
    paddle.seed(0)
    jm = getattr(jmodels, cls)(**CFG, **kw)
    tm = getattr(tmodels, cls)(**CFG, **kw)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    assert list(state) == list(tm.state_dict())
    assert tm.set_state_dict(state_from_numpy(state, "cpu")) == ([], [])
    return jm, tm


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("cls", ["BertForSequenceClassification",
                                 "BertForQuestionAnswering"])
def test_bert_forward_matches_jax(cls, mode):
    kw = {"dropout": 0.0} if cls == "BertForSequenceClassification" else {}
    jm, tm = _pair(cls, **kw)
    getattr(jm, mode)()
    getattr(tm, mode)()
    ids, mask, _ = _inputs()
    jo = jm(paddle.to_tensor(ids), None, paddle.to_tensor(mask))
    to = tm(pt.to_tensor(ids), None, pt.to_tensor(mask))
    jo = jo if isinstance(jo, tuple) else (jo,)
    to = to if isinstance(to, tuple) else (to,)
    for j, t in zip(jo, to):
        assert j.shape == t.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j._value), **FWD)


def test_bert_model_masked_keys_change_nothing():
    """A padded position's token does not reach the other rows' outputs:
    the mask is the attention's kv mask."""
    _, tm = _pair("BertForSequenceClassification", dropout=0.0)
    tm.eval()
    ids, mask, _ = _inputs()
    other = ids.copy()
    other[1, S - 1] = (other[1, S - 1] + 1) % CFG["vocab_size"]
    a = tm.bert(pt.to_tensor(ids), None, pt.to_tensor(mask))[0].numpy()
    b = tm.bert(pt.to_tensor(other), None, pt.to_tensor(mask))[0].numpy()
    np.testing.assert_allclose(a[1, :S - S // 4], b[1, :S - S // 4],
                               rtol=1e-6, atol=1e-6)


def _jax_step(jm, ids, mask, y):
    params, buffers = jax_state(jm)
    opt = jopt.AdamW(LR, parameters=jm.parameters())
    loss_fn = jnn.CrossEntropyLoss()

    def loss_of(p):
        out, _ = jax_call(jm, p, buffers, (jnp.asarray(ids), None,
                                            jnp.asarray(mask)),
                          training=True)
        return loss_fn(JTensor(out), JTensor(jnp.asarray(y)))._value.astype(
            jnp.float32)

    loss, grads = jax.value_and_grad(loss_of)(params)
    new_params, _ = opt.fused_step(params, grads, opt.init_opt_state(params),
                                   jnp.asarray(1, jnp.int32))
    return float(loss), new_params


def _adam_step_close(got, want, one_percent=True):
    """``got`` / ``want``: ``{name: array}`` after one AdamW step."""
    off, total = 0, 0
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR * (1 + 1e-3),
                                   err_msg=name)
        if NOISE not in name:
            off += int((np.abs(g - w) > 5e-3 * LR).sum())
            total += w.size
    if one_percent:
        assert off <= 0.01 * total, (off, total)


def test_bench_step_twin_matches_the_jax_form():
    jm, tm = _pair("BertForSequenceClassification", dropout=0.0)
    ids, mask, y = _inputs()
    jloss, jparams = _jax_step(jm, ids, mask, y)
    step, state = chip_smoke.build_step(
        tm, tnn.CrossEntropyLoss(), topt.AdamW(LR, parameters=tm.parameters()),
        amp_dtype=None, graphed=False)
    loss = float(step(state, torch.from_numpy(ids), None,
                      torch.from_numpy(mask), torch.from_numpy(y)))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert float(state["step"]) == 1.0
    tstate = tm.state_dict()
    # the step updated the model's own tensors in place
    assert all(state["params"][n] is tstate[n]._value for n in jparams)
    _adam_step_close({n: tstate[n].numpy() for n in jparams}, jparams)


def test_bench_step_twin_under_autocast_tracks_bench_build_step():
    """bf16: ``bench.py``'s ``build_step`` (the ids alone, no mask)
    against the twin on the same weights."""
    jm, tm = _pair("BertForSequenceClassification", dropout=0.0)
    ids, _, y = _inputs(seed=1)
    jopt_ = jopt.AdamW(LR, parameters=jm.parameters())
    jstep, jstate = bench.build_step(jm, jnn.CrossEntropyLoss(), jopt_)
    jstate, jloss = jstep(jstate, jax.random.key(0), jnp.asarray(ids),
                          jnp.asarray(y))
    step, state = chip_smoke.build_step(
        tm, tnn.CrossEntropyLoss(), topt.AdamW(LR, parameters=tm.parameters()),
        graphed=False)
    loss = float(step(state, torch.from_numpy(ids), torch.from_numpy(y)))
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-2)
    _adam_step_close({n: p.detach().numpy()
                      for n, p in state["params"].items()},
                     jstate["params"], one_percent=False)


def test_functional_call_binds_restores_and_updates_buffers_in_place():
    pt.seed(0)
    net = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4))
    params, buffers = get_state(net)
    assert list(params) == ["0.weight", "0.bias", "1.weight", "1.bias"]
    assert list(buffers) == ["1._mean", "1._variance"]
    own_w = net[0].weight._value
    w2 = torch.zeros_like(own_w)
    mean2 = torch.zeros(4)
    net.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 5, 5).astype(
        np.float32))
    out, new_bufs = functional_call(net, {"0.weight": w2},
                                    {"1._mean": mean2}, (x,), training=True)
    assert net[0].weight._value is own_w and not net.training
    assert new_bufs["1._mean"] is mean2 and float(mean2.abs().max()) > 0
    assert new_bufs["1._variance"] is buffers["1._variance"]
    # a zero weight: each channel is its bias, the batch mean is the bias
    np.testing.assert_allclose(mean2.numpy(),
                               0.1 * net[0].bias._value.detach().numpy(),
                               rtol=1e-6)
    assert out.shape == (2, 4, 3, 3) and isinstance(out, torch.Tensor)
