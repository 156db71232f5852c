"""paddle_tpu_torch's ``amp.decorate`` and level O2 against the JAX
package's.

- ``decorate(level="O2")`` casts a port ``Layer``'s parameters and
  buffers (each gets a new torch tensor) and re-points the optimizer
  built before it at them, accumulators made already moving with their
  parameter; a ``torch.nn.Module`` (the GPT) keeps its Parameter
  objects.  One AdamW step on the MLP after decorating matches the JAX
  package's decorated step within a bf16 rounding of the weights (both
  compute the update in f32 and round it to bf16: an entry near a
  rounding boundary may land one bf16 ulp apart, 2^-8 relative).
- A 2-layer, 64-wide GPT (the JAX package's ``paddle.seed(3)`` weights
  carried across) under ``auto_cast(level="O2")``, with f32 weights and
  decorated to bf16: logits within 2e-2 of the largest |logit| and on
  average within 3e-3 of it.  Both packages round to bf16 after every op
  off the black list (the embeddings' add, the layer norms, GELU, the
  residual adds, the linear layers, attention, the head) but sum inside
  an op in another order, so an element differs by a bf16 ulp here and
  there and the differences grow through the layers; with bf16 weights
  the products' inputs are the same values in both, so the logits' gap
  is of the same size as O1's (``tests/test_torch_amp_gpt.py``).
- Training under O2, the decorated GPT and AdamW (no master weights:
  accumulators bf16, the update computed in f32 and cast back), three
  steps against the JAX package's ``functional_call`` +
  ``value_and_grad`` + ``fused_step`` (its eager tape cannot take this
  backward): losses within 1e-2 relative; the first step's gradients
  within 5e-2 of JAX's in relative L2 (bf16 gradients: each rounded to 8
  bits, twice O1's 3e-2, where they are f32); the key projections' biases
  as in ``tests/test_torch_amp_gpt.py``.  The port's ``Model.fit`` on the
  same weights (its train step as written on the CPU) gives the dygraph
  loop's losses bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit.functional import functional_call, get_state
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.text.models import GPTModel as JaxGPT

import paddle_tpu_torch as pt
from paddle_tpu_torch import amp
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import place
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import state_from_numpy
from paddle_tpu_torch.text.models import (GPTModel, _is_linear_weight,
                                          load_numpy_state)

CFG = dict(vocab_size=50, hidden_size=64, num_layers=2, num_heads=2,
           ffn_size=128, max_seq_len=64)
B, S = 2, 40
LR, WD, STEPS = 1e-2, 0.1, 3
V = CFG["vocab_size"]
NOISE = ("layers.0.attn.k_proj.bias", "layers.1.attn.k_proj.bias")
LOGIT_MAX, LOGIT_MEAN = 2e-2, 3e-3
LOSS_RTOL, GRAD_REL = 1e-2, 5e-2


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _jax_gpt():
    paddle.seed(3)
    return JaxGPT(**CFG, dropout=0.0)


@pytest.fixture(scope="module")
def weights():
    return {k: np.asarray(v) for k, v in get_state(_jax_gpt())[0].items()}


@pytest.fixture(scope="module")
def batch():
    ids = np.random.RandomState(0).randint(0, V, (B, S + 1)).astype(
        np.int64)
    return ids[:, :-1], ids[:, 1:]


def o2():
    return amp.auto_cast(level="O2", dtype="bfloat16")


def jax_o2():
    return paddle.amp.auto_cast(level="O2", dtype="bfloat16")


# --- decorate -----------------------------------------------------------------
def _mlps():
    paddle.seed(7)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    w = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    tnet = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(), tnn.Linear(16, 4))
    tnet.set_state_dict(state_from_numpy(w, "cpu"))
    return jnet, tnet


@pytest.mark.parametrize("stepped_before", [False, True])
def test_decorate_repoints_the_optimizer(stepped_before):
    jnet, tnet = _mlps()
    jo = jopt.AdamW(LR, parameters=jnet.parameters(), weight_decay=WD)
    to = topt.AdamW(LR, parameters=tnet.parameters(), weight_decay=WD)
    x = np.random.RandomState(1).randn(4, 8).astype(np.float32)

    def step(net, opt, pkg):
        xin = pkg.to_tensor(x, dtype=str(net[0].weight.dtype).split(".")[-1])
        loss = (net(xin) * net(xin)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()

    if stepped_before:
        step(jnet, jo, paddle)
        step(tnet, to, pt)
    old = [p._value for p in tnet.parameters()]
    out = amp.decorate(models=tnet, optimizers=to, level="O2",
                       dtype="bfloat16")
    assert out == (tnet, to)
    paddle.amp.decorate(models=jnet, optimizers=jo, level="O2",
                        dtype="bfloat16")
    new = [p._value for p in tnet.parameters()]
    assert all(n is not o for n, o in zip(new, old))
    assert all(a is b for a, b in zip(to._param_list(), new))
    assert all(t.dtype == torch.bfloat16 for t in new)
    # the bare bf16 step (the JAX eager tape cannot take an O2 backward
    # whose loss is black-listed to f32)
    step(tnet, to, pt)
    step(jnet, jo, paddle)
    for kind, store in to._accumulators.items():
        assert set(store) == {id(t) for t in new}
        want = torch.float32 if stepped_before else torch.bfloat16
        assert all(a.dtype == want for a in store.values()), kind
    for (k, jp), tp in zip(jnet.state_dict().items(), tnet.parameters()):
        got = tp._value.detach().float().numpy()
        want = np.asarray(jp._value.astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0,
                                   err_msg=k)


def test_decorate_o1_and_module_keep_their_objects():
    m = GPTModel(**CFG, device="cpu", seed=0)
    params = list(m.parameters())
    opt = topt.AdamW(LR, parameters=params, weight_decay=WD)
    assert amp.decorate(models=m, level="O1") is m
    assert all(p.dtype == torch.float32 for p in m.parameters())
    amp.decorate(models=m, optimizers=opt, level="O2", dtype="bfloat16")
    assert [id(p) for p in m.parameters()] == [id(p) for p in params]
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    assert all(a is b for a, b in zip(opt._param_list(), params))


# --- GPT under O2 -------------------------------------------------------------
def _port_gpt(weights, decorated):
    m = load_numpy_state(GPTModel(**CFG, device="cpu"), weights)
    if decorated:
        amp.decorate(models=m, level="O2", dtype="bfloat16")
    return m


def _check_logits(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, V)
    got = got.detach().float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    diff = np.abs(got - want)
    assert diff.max() <= LOGIT_MAX * scale, diff.max()
    assert diff.mean() <= LOGIT_MEAN * scale, diff.mean()


@pytest.mark.parametrize("decorated", [False, True],
                         ids=["f32_weights", "bf16_weights"])
def test_gpt_o2_forward_matches_jax(weights, batch, decorated):
    jm = _jax_gpt()
    if decorated:
        paddle.amp.decorate(models=jm, level="O2", dtype="bfloat16")
    with jax_o2():
        want = jm(paddle.to_tensor(batch[0]))
    assert want._value.dtype == jnp.bfloat16
    m = _port_gpt(weights, decorated)
    with o2():
        got = m(torch.from_numpy(batch[0]))
    _check_logits(got, np.asarray(want._value.astype(jnp.float32)))


def _jax_train_o2(batch):
    m = _jax_gpt()
    paddle.amp.decorate(models=m, level="O2", dtype="bfloat16")
    opt = jopt.AdamW(LR, parameters=m.parameters(), weight_decay=WD)
    params, bufs = get_state(m)
    state = opt.init_opt_state(params)
    x, y = (jnp.asarray(a) for a in batch)

    def loss_of(p):
        with jax_o2():
            out, _ = functional_call(m, p, bufs, (x,), training=True)
            loss = JF.cross_entropy(JTensor(out).reshape([-1, V]),
                                    JTensor(y).reshape([-1]))
        return loss._value.astype(jnp.float32)

    losses, first = [], None
    for i in range(STEPS):
        loss, grads = jax.value_and_grad(loss_of)(params)
        if first is None:
            first = {k: np.asarray(v.astype(jnp.float32))
                     for k, v in grads.items()}
        params, state = opt.fused_step(params, grads, state,
                                       jnp.asarray(i + 1, jnp.int32))
        losses.append(float(loss))
    return losses, first, params, state


def _port_loop(weights, batch):
    m = _port_gpt(weights, True)
    opt = topt.AdamW(LR, parameters=list(m.parameters()), weight_decay=WD)
    x, y = (torch.from_numpy(a) for a in batch)
    losses, first = [], None
    for _ in range(STEPS):
        with o2():
            logits = m(x)
            loss = F.cross_entropy(logits.reshape(-1, V), y.reshape(-1))
        assert loss.dtype == torch.float32
        loss.backward()
        if first is None:
            first = {k: (p.grad.T if _is_linear_weight(k) else p.grad)
                     .float().numpy().copy() for k, p in m.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses, first, m, opt


def test_gpt_o2_training_matches_jax(weights, batch):
    j_losses, j_grads, j_params, j_state = _jax_train_o2(batch)
    t_losses, t_grads, m, opt = _port_loop(weights, batch)
    assert all(v.dtype == jnp.bfloat16 for v in j_params.values())
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    accs = [v for v in opt.state_dict().values()
            if torch.is_tensor(v) and v.is_floating_point()]
    assert len(accs) == 2 * len(list(m.parameters()))
    assert all(a.dtype == torch.bfloat16 for a in accs)
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]
    largest = max(np.linalg.norm(g) for g in j_grads.values())
    for name, want in j_grads.items():
        got = t_grads[name]
        if name in NOISE:
            assert np.linalg.norm(got) <= 2e-3 * largest, name
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= GRAD_REL, f"{name}: gradient differs by {rel}"


def test_gpt_o2_fit_equals_the_dygraph_loop(weights, batch):
    t_losses, _, m_loop, _ = _port_loop(weights, batch)
    m = _port_gpt(weights, False)
    opt = topt.AdamW(LR, parameters=list(m.parameters()), weight_decay=WD)
    amp.decorate(models=m, optimizers=opt, level="O2", dtype="bfloat16")

    def loss_fn(logits, y):
        return F.cross_entropy(logits.reshape([-1, V]), y.reshape([-1]))

    model = pt.Model(m)
    model.prepare(opt, loss_fn, amp_configs={"level": "O2"})
    x, y = batch
    losses = []

    class Rec(pt.hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    data = tio.TensorDataset([np.concatenate([x] * STEPS),
                              np.concatenate([y] * STEPS)])
    with o2():
        model.fit(data, batch_size=B, shuffle=False, verbose=0,
                  callbacks=[Rec()])
    assert losses == t_losses
    for a, b in zip(m.parameters(), m_loop.parameters()):
        assert torch.equal(a, b)
