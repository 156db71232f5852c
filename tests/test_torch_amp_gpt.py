"""paddle_tpu_torch's GPT under ``amp.auto_cast(dtype="bfloat16")`` vs the
JAX package's, the way ``bench.py`` trains (``build_step``: the forward
under ``auto_cast``, the loss in f32, ``value_and_grad`` over the
parameters, ``AdamW.fused_step``).

The same seeded weights (a JAX ``GPTModel`` from ``paddle.seed``, carried
over by ``load_numpy_state``) and the same seeded token batch go through
both packages on both of the JAX package's attention routes: the bf16
logits of the first forward, the gradients of the first step, the loss
of each of three AdamW steps and the weights after them.  The JAX side uses the functional form because
its eager tape cannot take this backward (a residual add's VJP receives
a bf16 cotangent for its f32 output and raises); ``bench.py`` uses the
functional form too.

Tolerances and why: both packages round to bf16 after every white-list
op (linear, attention, the tied head) and after GELU, but their CPU
kernels take the sums inside those ops in another order and round them
at other places (XLA and oneDNN), so an element differs by a bf16 ulp
(2^-8 relative) here and there and the differences grow through the
layers:
- logits within 1e-2 of the largest |logit| (one or two bf16 ulps;
  the largest difference seen is 0.0156 at |logit| up to 3.2, i.e. one
  ulp), and on average within 2e-3 of it;
- losses within 5e-3 relative (seen: 7e-4);
- the first step's gradient of every parameter within 3e-2 of JAX's
  ``value_and_grad`` gradient in relative L2 norm (seen: at most 1.7e-2,
  median 7e-3, on either route), so a missed cast or a wrong bf16
  backward in one layer, which Adam's normalized step would hide in the
  weights, fails here;
- weights after three steps: the update ``w - w0`` of every parameter
  within 0.4 of the JAX update in relative L2 norm (seen: at most 0.21,
  median 0.03), and 99 % of all entries within 0.5 · lr (seen: 0.23 ·
  lr).  Adam's step is normalized, so a gradient that differs by 1 %
  still moves a weight by about lr, and an entry whose gradient changes
  sign moves the other way.  The key projections' biases are excluded
  from the gradient and update checks (their exact gradient is 0 — a
  softmax row is invariant to a constant added to all its scores — so
  their computed gradient is rounding noise in both packages); their
  gradient norm must stay within 2e-3 of the largest parameter's (seen:
  3.4e-4) and their weights within the ``2 · lr · steps`` that Adam can
  move them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit.functional import functional_call, get_state
from paddle_tpu.ops import attention as jatt
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.text.models import GPTModel as JaxGPT
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text.models import (GPTModel, _is_linear_weight,
                                          load_numpy_state, numpy_state)

CFG = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=2,
           ffn_size=64, max_seq_len=64)
B, S = 2, 40
LR, WD, STEPS = 1e-2, 0.1, 3
V, L = CFG["vocab_size"], CFG["num_layers"]
ROUTES = ["xla", "flash"]          # the JAX package's two attention routes
NOISE = ("layers.0.attn.k_proj.bias", "layers.1.attn.k_proj.bias")
GRAD_REL, UPDATE_REL = 3e-2, 0.4


def _jax_model():
    paddle.seed(3)
    return JaxGPT(**CFG, dropout=0.0)


@pytest.fixture(scope="module")
def weights():
    return {k: np.asarray(v) for k, v in get_state(_jax_model())[0].items()}


def _port_model(weights):
    return load_numpy_state(GPTModel(**CFG, device="cpu"), weights)


@pytest.fixture(scope="module")
def batch():
    ids = np.random.RandomState(0).randint(0, V, (B, S + 1)).astype(
        np.int64)
    return ids[:, :-1], ids[:, 1:]


@pytest.fixture
def route(request, monkeypatch):
    if request.param == "flash":
        monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_FORCE_FLASH", raising=False)
    for stats in (jatt.ROUTE_STATS, tatt.ROUTE_STATS):
        stats.update(pallas=0, xla=0)
    tfa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
    return request.param


_JAX_RUNS = {}


def _jax_train(route, batch):
    """bench.py's step, unjitted: (first logits as f32, losses, final
    weights, the route counts of the run, the first step's gradients).
    Computed once per route."""
    if route in _JAX_RUNS:
        return _JAX_RUNS[route]
    jatt.ROUTE_STATS.update(pallas=0, xla=0)
    m = _jax_model()
    opt = jopt.AdamW(LR, parameters=m.parameters(), weight_decay=WD)
    params, bufs = get_state(m)
    state = opt.init_opt_state(params)
    x, y = (jnp.asarray(a) for a in batch)

    def forward(p):
        with paddle.amp.auto_cast(dtype="bfloat16"):
            out, _ = functional_call(m, p, bufs, (x,), training=True)
        return out

    def loss_of(p):
        loss = JF.cross_entropy(JTensor(forward(p)).reshape([-1, V]),
                                JTensor(y).reshape([-1]))
        return loss._value.astype(jnp.float32)

    logits = forward(params)
    assert logits.dtype == jnp.bfloat16
    losses, first_grads = [], None
    for i in range(STEPS):
        loss, grads = jax.value_and_grad(loss_of)(params)
        if first_grads is None:
            first_grads = {k: np.asarray(v) for k, v in grads.items()}
        params, state = opt.fused_step(params, grads, state,
                                       jnp.asarray(i + 1, jnp.int32))
        losses.append(float(loss))
    run = (np.asarray(logits.astype(jnp.float32)), losses,
           {k: np.asarray(v) for k, v in params.items()},
           dict(jatt.ROUTE_STATS), first_grads)
    _JAX_RUNS[route] = run
    return run


def _port_train(weights, batch):
    """The paddle dygraph loop with the forward under the port's
    ``auto_cast``: (first logits, losses, model, optimizer, the first
    step's gradients under the JAX layout)."""
    m = _port_model(weights)
    opt = topt.AdamW(LR, parameters=list(m.parameters()), weight_decay=WD)
    x, y = (torch.from_numpy(a) for a in batch)
    first, losses, grads = None, [], None
    for _ in range(STEPS):
        with amp.auto_cast(dtype="bfloat16"):
            logits = m(x)
        if first is None:
            first = logits
        loss = F.cross_entropy(logits.reshape(-1, V), y.reshape(-1))
        assert loss.dtype == torch.float32
        loss.backward()
        if grads is None:
            # under the JAX names and layout, as numpy_state gives them
            grads = {k: (p.grad.T if _is_linear_weight(k) else p.grad)
                     .numpy().copy() for k, p in m.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return first, losses, m, opt, grads


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_autocast_training_matches_jax(route, weights, batch):
    """Three bf16-autocast AdamW steps of the whole slice on each JAX
    attention route: the first logits, the first gradients, each loss
    and the final weights."""
    j_logits, j_losses, j_w, j_routes, j_grads = _jax_train(route, batch)
    tatt.ROUTE_STATS.update(pallas=0, xla=0)
    tfa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
    logits, t_losses, m, _, t_grads = _port_train(weights, batch)

    key = "pallas" if route == "flash" else "xla"
    assert j_routes == {"pallas": 0, "xla": 0, key: (1 + STEPS) * L}
    assert tatt.ROUTE_STATS == {"pallas": 0, "xla": 0, key: STEPS * L}
    # forward and the two backward bodies per layer per step, plain
    # versions on the CPU
    assert tfa.FLASH_ROUTE_STATS["ref"] == (
        3 * L * STEPS if route == "flash" else 0)

    assert logits.dtype == torch.bfloat16 and logits.shape == (B, S, V)
    got = logits.detach().float().numpy()
    scale = max(1.0, float(np.abs(j_logits).max()))
    diff = np.abs(got - j_logits)
    assert diff.max() <= 1e-2 * scale, diff.max()
    assert diff.mean() <= 2e-3 * scale, diff.mean()

    np.testing.assert_allclose(t_losses, j_losses, rtol=5e-3)
    assert j_losses[-1] < j_losses[0] and t_losses[-1] < t_losses[0]

    assert set(t_grads) == set(j_grads) == set(weights)
    largest = max(np.linalg.norm(g) for g in j_grads.values())
    for name, want in j_grads.items():
        got = t_grads[name]
        assert got.shape == want.shape, name
        if name in NOISE:
            assert np.linalg.norm(got) <= 2e-3 * largest, name
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= GRAD_REL, f"{name}: gradient differs by {rel}"

    t_w = numpy_state(m)
    assert set(t_w) == set(j_w) == set(weights)
    entries = []
    for name, want in j_w.items():
        got = t_w[name]
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR * STEPS * (1 + WD), name
        entries.append(diff.ravel())
        if name in NOISE:
            continue
        upd_t, upd_j = got - weights[name], want - weights[name]
        rel = np.linalg.norm(upd_t - upd_j) / np.linalg.norm(upd_j)
        assert rel <= UPDATE_REL, (f"{name}: update differs by {rel} "
                                   f"(relative L2)")
    q99 = float(np.quantile(np.concatenate(entries), 0.99))
    assert q99 <= 0.5 * LR, q99


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_autocast_attention_runs_in_bf16(route, weights, batch,
                                         monkeypatch):
    """Under auto_cast the attention op's q, k and v are bf16 on either
    route (so on the card the bf16 flash bodies run), its output is bf16,
    and every parameter, gradient and AdamW moment stays f32."""
    seen = []
    if route == "flash":
        real = tfa._flash_fwd_bhsd

        def spy(q, k, v, *args, **kw):
            seen.append((q.dtype, k.dtype, v.dtype))
            return real(q, k, v, *args, **kw)

        monkeypatch.setattr(tfa, "_flash_fwd_bhsd", spy)
    else:
        real = tatt._sdpa_core

        def spy(q, k, v, *args, **kw):
            seen.append((q.dtype, k.dtype, v.dtype))
            out = real(q, k, v, *args, **kw)
            assert out.dtype == torch.bfloat16
            return out

        monkeypatch.setattr(tatt, "_sdpa_core", spy)
    _, _, m, opt, _ = _port_train(weights, batch)
    assert seen == [(torch.bfloat16,) * 3] * (L * STEPS)
    key = "pallas" if route == "flash" else "xla"
    assert tatt.ROUTE_STATS[key] == L * STEPS
    assert all(p.dtype == torch.float32 for p in m.parameters())
    x = torch.from_numpy(batch[0])
    with amp.auto_cast(dtype="bfloat16"):
        loss = m(x).float().mean()
    loss.backward()
    assert all(p.grad.dtype == torch.float32 for p in m.parameters())
    moments = [v for v in opt.state_dict().values()
               if torch.is_tensor(v) and v.is_floating_point()]
    assert moments and all(v.dtype == torch.float32 for v in moments)


def _forward_before_autocast(m, ids):
    """``GPTModel.forward`` as it was before it learned auto_cast: every
    projection through its ``nn.Linear``, the head a plain matmul."""
    x = m.wte(ids) + m.wpe(torch.arange(ids.shape[1]))
    for layer in m.layers:
        h = F.layer_norm(x, x.shape[-1], layer.ln1.weight, layer.ln1.bias,
                         layer.ln1.eps)
        a = layer.attn
        B_, S_, E = h.shape

        def heads(proj):
            return proj(h).reshape(B_, S_, a.num_heads, E // a.num_heads)

        o = F.scaled_dot_product_attention(
            heads(a.q_proj), heads(a.k_proj), heads(a.v_proj),
            is_causal=True, training=a.training)
        x = x + a.out_proj(o.reshape(B_, S_, E))
        h = F.layer_norm(x, x.shape[-1], layer.ln2.weight, layer.ln2.bias,
                         layer.ln2.eps)
        x = x + layer.fc2(F.gelu(layer.fc1(h)))
    x = F.layer_norm(x, x.shape[-1], m.ln_f.weight, m.ln_f.bias,
                     m.ln_f.eps)
    return torch.matmul(x, m.wte.weight.t())


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_forward_without_autocast_is_unchanged(route, weights, batch):
    """With auto_cast off (absent, or ``enable=False``) the forward is the
    f32 forward of before, bit for bit."""
    m = _port_model(weights)
    x = torch.from_numpy(batch[0])
    with torch.no_grad():
        want = _forward_before_autocast(m, x)
        plain = m(x)
        with amp.auto_cast(enable=False, dtype="bfloat16"):
            off = m(x)
    assert plain.dtype == off.dtype == torch.float32
    assert torch.equal(plain, want) and torch.equal(off, want)


def test_autocast_level_o2_is_refused(weights, batch):
    """Under O2 GPTModel refuses O1's mix: it casts every op off the black
    list to bf16, as the JAX package's ``apply`` does (the layer norms,
    GELU and the residual adds too), so its logits are bf16 and differ
    from O1's, whose adds and norms stay f32.  Parity with the JAX
    package's O2 forward is ``tests/test_torch_amp_o2.py``'s."""
    m = _port_model(weights)
    x = torch.from_numpy(batch[0])
    with amp.auto_cast(dtype="bfloat16", level="O2"):
        o2 = m(x)
    with amp.auto_cast(dtype="bfloat16"):
        o1 = m(x)
    assert o2.dtype == o1.dtype == torch.bfloat16
    assert torch.isfinite(o2.float()).all()
    assert not torch.equal(o2, o1)
