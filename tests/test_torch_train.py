"""paddle_tpu_torch's GPT training slice vs the JAX package's eager trainer.

The same seeded weights (a JAX ``GPTModel`` built from ``paddle.seed``,
carried over by ``load_numpy_state``) and the same seeded token batches
go through both packages: ``GPTModel.forward`` logits on both attention
routes, ``cross_entropy``, the SGD / Adam / AdamW update rules and three
training steps of the whole slice
(``loss.backward(); opt.step(); opt.clear_grad()``).

Tolerances and why:
- logits and losses 1e-4 absolute and relative: the same f32 ops in the
  same association order on the CPU, summed in another order inside the
  backends' matmuls, softmax and logsumexp;
- gradients of ``cross_entropy`` 1e-6: one softmax over 50 classes;
- optimizer rules on given gradients 1e-6 relative (SGD: 1e-7): the
  same f32 expressions in the same order;
- weights after three SGD steps of the slice 1e-5 absolute and
  relative: the gradients differ by f32 rounding only, scaled by lr;
- weights after three AdamW steps: every entry within ``2e-3 · lr``
  (the largest difference seen is 2e-4 · lr), except entries whose
  gradient is pure rounding noise.  Adam divides by ``sqrt(v̂) + 1e-8``,
  so where ``|g|`` is at the noise floor the normalized step
  ``m̂ / sqrt(v̂)`` is about ±1 in either package whatever the noise, and
  such an entry may move by up to ``lr`` per step.  An entry counts as
  noise when its gradient (JAX package, any step) is below 1e-6 of the
  model's largest ``|g|`` at that step; those may differ by up to
  ``2 · lr · steps``, and they must be under 1 % of the weights.  The
  case that occurs is structural: the key projection's bias has an
  exact gradient of 0 (a softmax row is invariant to a constant added to
  all its scores), so its computed gradient (|g| < 1e-8) is rounding
  noise in both packages — 64 of 20,800 weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit.functional import get_state
from paddle_tpu.ops import attention as jatt
from paddle_tpu.text.models import GPTModel as JaxGPT
from paddle_tpu.tensor import Parameter
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text.models import (GPTModel, load_numpy_state,
                                          numpy_state)

CFG = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=2,
           ffn_size=64, max_seq_len=64)
B, S = 2, 40
LR, WD, STEPS = 1e-2, 0.1, 3
ROUTES = ["xla", "flash"]          # the JAX package's two attention routes


def _jax_model():
    """A fresh JAX GPT with the seeded weights (this module trains its
    own models: the suite's ``shared_gpt_small`` is eval-only)."""
    paddle.seed(3)
    return JaxGPT(**CFG, dropout=0.0)


@pytest.fixture(scope="module")
def weights():
    return {k: np.asarray(v) for k, v in get_state(_jax_model())[0].items()}


def _port_model(weights):
    return load_numpy_state(GPTModel(**CFG, device="cpu"), weights)


@pytest.fixture(scope="module")
def batch():
    ids = np.random.RandomState(0).randint(0, CFG["vocab_size"],
                                           (B, S + 1)).astype(np.int64)
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


def _expect_routes(route, n_calls):
    key = "pallas" if route == "flash" else "xla"
    want = {"pallas": 0, "xla": 0, key: n_calls}
    assert jatt.ROUTE_STATS == want
    assert tatt.ROUTE_STATS == want
    assert tfa.FLASH_ROUTE_STATS["fwd"] == tfa.FLASH_ROUTE_STATS["dq"] == 0


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_forward_logits_match_jax(route, weights, batch):
    """The full-sequence causal forward (the parity test ROADMAP item 1
    deferred to this slice)."""
    x, _ = batch
    want = _jax_model()(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = _port_model(weights)(torch.from_numpy(x))
    assert got.shape == (B, S, CFG["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    _expect_routes(route, CFG["num_layers"])
    assert tfa.FLASH_ROUTE_STATS["ref"] == (2 if route == "flash" else 0)


_CE_CASES = [("mean", -100, 0.0), ("sum", -100, 0.0), ("none", -100, 0.0),
             ("mean", 3, 0.0), ("mean", -100, 0.1), ("none", 3, 0.2),
             ("sum", 3, 0.1)]


@pytest.mark.parametrize("reduction,ignore_index,smoothing", _CE_CASES)
@pytest.mark.parametrize("label_rank", [2, 3], ids=["labels", "labels1"])
def test_cross_entropy_matches_jax(reduction, ignore_index, smoothing,
                                   label_rank):
    rng = np.random.RandomState(7)
    logits = (rng.randn(3, 5, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, (3, 5)).astype(np.int64)
    labels[0, :2] = 3                          # some ignored positions
    if label_rank == 3:
        labels = labels[..., None]
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(jx, paddle.to_tensor(labels),
                          ignore_index=ignore_index, reduction=reduction,
                          label_smoothing=smoothing)
    jl.sum().backward()
    tx = torch.tensor(logits, requires_grad=True)
    tl = F.cross_entropy(tx, torch.from_numpy(labels),
                         ignore_index=ignore_index, reduction=reduction,
                         label_smoothing=smoothing)
    tl.sum().backward()
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_cross_entropy_rejects_what_is_not_ported():
    """``weight``, ``soft_label`` and ``use_softmax=False`` are ported
    now: each matches the JAX package (1e-6, one softmax over 4
    classes); an unknown reduction is still refused."""
    rng = np.random.RandomState(8)
    x = rng.rand(5, 4).astype(np.float32) + 0.1
    y = rng.randint(0, 4, (5,)).astype(np.int64)
    soft = rng.dirichlet(np.ones(4), 5).astype(np.float32)
    w = np.asarray([0.5, 1.0, 2.0, 1.5], np.float32)
    for label, kw in ((y, {"weight": w}), (soft, {"soft_label": True}),
                      (y, {"use_softmax": False}),
                      (soft, {"soft_label": True, "weight": w})):
        jkw = {k: paddle.to_tensor(v) if k == "weight" else v
               for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) if k == "weight" else v
               for k, v in kw.items()}
        want = JF.cross_entropy(paddle.to_tensor(x), paddle.to_tensor(label),
                                **jkw)
        got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(label),
                              **tkw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="reduction"):
        F.cross_entropy(torch.zeros(2, 4), torch.zeros(2, dtype=torch.long),
                        reduction="batchmean")


_OPTIMIZERS = {
    "sgd": (lambda ps: jopt.SGD(0.1, parameters=ps, weight_decay=0.01),
            lambda ps: topt.SGD(0.1, parameters=ps, weight_decay=0.01),
            1e-7),
    "adam": (lambda ps: jopt.Adam(0.05, parameters=ps),
             lambda ps: topt.Adam(0.05, parameters=ps), 1e-6),
    "adam_l2": (lambda ps: jopt.Adam(0.05, parameters=ps, weight_decay=0.1),
                lambda ps: topt.Adam(0.05, parameters=ps, weight_decay=0.1),
                1e-6),
    "adamw": (lambda ps: jopt.AdamW(0.05, parameters=ps, weight_decay=0.1),
              lambda ps: topt.AdamW(0.05, parameters=ps, weight_decay=0.1),
              1e-6),
}


def _opt_pair(name, rng):
    make_j, make_t, tol = _OPTIMIZERS[name]
    shapes = [(4, 3), (5,), (2, 2, 3)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    jp = [Parameter(paddle.to_tensor(a)._value) for a in init]
    tp = [torch.nn.Parameter(torch.tensor(a)) for a in init]
    return make_j(jp), make_t(tp), jp, tp, tol


def _apply_grads(rng, jp, tp):
    for a, b in zip(jp, tp):
        g = rng.randn(*b.shape).astype(np.float32)
        g[..., 0] *= 1e-3                      # a spread of magnitudes
        a._grad = paddle.to_tensor(g)
        b.grad = torch.tensor(g)


@pytest.mark.parametrize("name", list(_OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    """Four steps of each rule on the same gradients; ``clear_grad``
    drops the gradients in both."""
    rng = np.random.RandomState(11)
    jo, to, jp, tp, tol = _opt_pair(name, rng)
    for _ in range(4):
        _apply_grads(rng, jp, tp)
        jo.step()
        to.step()
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.detach().numpy(), a.numpy(),
                                       rtol=tol, atol=tol)
        jo.clear_grad()
        to.clear_grad()
        assert all(b.grad is None for b in tp)
    assert to.get_lr() == jo.get_lr()
    to.set_lr(0.5)
    assert to.get_lr() == 0.5


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_state_dict_keys_and_round_trip(name):
    rng = np.random.RandomState(12)
    jo, to, jp, tp, _ = _opt_pair(name, rng)
    for _ in range(2):
        _apply_grads(rng, jp, tp)
        jo.step()
        to.step()
    sd = to.state_dict()
    assert set(sd) == set(jo.state_dict())
    assert sd["step_count"] == 2
    for key, val in jo.state_dict().items():
        if key.startswith("param_"):
            np.testing.assert_allclose(sd[key].numpy(), val.numpy(),
                                       rtol=1e-6, atol=1e-7)
    # a fresh optimizer over copies of the weights resumes exactly
    tp2 = [torch.nn.Parameter(p.detach().clone()) for p in tp]
    to2 = _OPTIMIZERS[name][1](tp2)
    to2.set_state_dict({k: (v.numpy() if torch.is_tensor(v) else v)
                        for k, v in sd.items()})
    g = [rng.randn(*p.shape).astype(np.float32) for p in tp]
    for p, q, gi in zip(tp, tp2, g):
        p.grad, q.grad = torch.tensor(gi), torch.tensor(gi)
    to.step()
    to2.step()
    for p, q in zip(tp, tp2):
        assert torch.equal(p, q)


def test_optimizer_rejects_what_is_not_ported():
    """``AdamW(lr_ratio=)``, which the JAX package accepts and never
    reads, raises (``lazy_mode`` and ``apply_decay_param_fun`` are ported:
    ``tests/test_torch_sparse_grad.py``); ``grad_clip`` and an LR
    scheduler match the JAX package's eager step (1e-7, as SGD above)."""
    from paddle_tpu.nn import ClipGradByNorm as JClip
    from paddle_tpu.optimizer.lr import StepDecay as JStep
    from paddle_tpu_torch.nn import ClipGradByNorm as TClip
    from paddle_tpu_torch.optimizer.lr import StepDecay as TStep

    ps = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="lr_ratio"):
        topt.AdamW(parameters=ps, lr_ratio=lambda p: 1.0)
    for make_j, make_t in (
            (lambda p: jopt.SGD(0.1, parameters=p, grad_clip=JClip(0.5)),
             lambda p: topt.SGD(0.1, parameters=p, grad_clip=TClip(0.5))),
            (lambda p: jopt.SGD(JStep(0.1, 1, 0.5), parameters=p),
             lambda p: topt.SGD(TStep(0.1, 1, 0.5), parameters=p))):
        rng = np.random.RandomState(13)
        init = rng.randn(3, 2).astype(np.float32)
        jp = [Parameter(paddle.to_tensor(init)._value)]
        tp = [torch.nn.Parameter(torch.tensor(init))]
        jo, to = make_j(jp), make_t(tp)
        for _ in range(3):
            g = rng.randn(3, 2).astype(np.float32)
            jp[0]._grad = paddle.to_tensor(g)
            tp[0].grad = torch.tensor(g)
            jo.step()
            to.step()
            if not isinstance(jo._lr, float):
                jo._lr.step()
                to._lr.step()
        np.testing.assert_allclose(tp[0].detach().numpy(), jp[0].numpy(),
                                   rtol=1e-7, atol=1e-7)


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------
def _train_jax(kind, batch):
    m = _jax_model()
    params = m.parameters()
    opt = (jopt.AdamW(LR, parameters=params, weight_decay=WD)
           if kind == "adamw" else jopt.SGD(LR, parameters=params))
    x, y = (paddle.to_tensor(a) for a in batch)
    losses, grads = [], []
    for _ in range(STEPS):
        loss = JF.cross_entropy(m(x).reshape([-1, CFG["vocab_size"]]),
                                y.reshape([-1]))
        loss.backward()
        grads.append({n: np.asarray(p._grad._value)
                      for n, p in m.named_parameters()})
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, {k: np.asarray(v) for k, v in get_state(m)[0].items()}, \
        grads


def _train_port(kind, weights, batch):
    m = _port_model(weights)
    params = list(m.parameters())
    opt = (topt.AdamW(LR, parameters=params, weight_decay=WD)
           if kind == "adamw" else topt.SGD(LR, parameters=params))
    x, y = (torch.from_numpy(a) for a in batch)
    losses = []
    for _ in range(STEPS):
        loss = F.cross_entropy(m(x).reshape(-1, CFG["vocab_size"]),
                               y.reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert all(p.grad is None for p in params)
    return losses, numpy_state(m)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_training_steps_match_jax(kind, route, weights, batch):
    """Three steps of the whole slice on each JAX attention route: the
    loss per step and the final weights."""
    j_losses, j_w, j_grads = _train_jax(kind, batch)
    t_losses, t_w = _train_port(kind, weights, batch)
    # fwd + bwd per layer per step on the flash route
    _expect_routes(route, CFG["num_layers"] * STEPS)
    if route == "flash":
        assert tfa.FLASH_ROUTE_STATS["ref"] == 3 * CFG["num_layers"] * STEPS
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=1e-4)
    assert j_losses[-1] < j_losses[0]
    assert set(t_w) == set(j_w)
    loose = total = 0
    for name, want in j_w.items():
        got = t_w[name]
        if kind == "sgd":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            continue
        g = np.abs(np.stack([step[name] for step in j_grads]))
        floor = 1e-6 * np.array([max(np.abs(v).max() for v in step.values())
                                 for step in j_grads])
        noise = (g < floor.reshape((-1,) + (1,) * (g.ndim - 1))).any(axis=0)
        diff = np.abs(got - want)
        off = diff > 2e-3 * LR
        assert not (off & ~noise).any(), \
            f"{name}: {diff[~noise].max()} > {2e-3 * LR} off the noise floor"
        assert (diff <= 2 * LR * STEPS).all(), name
        loose += int(off.sum())
        total += diff.size
    assert loose <= 0.01 * total, f"{loose} of {total} entries off"


def test_serving_on_the_trainable_model_builds_no_graph(weights,
                                                        monkeypatch):
    """The parameters are trainable now; every serving entry still runs
    under ``torch.no_grad()``: no ``.grad`` appears and no attention call
    sees a tensor that requires grad."""
    from paddle_tpu_torch.serving import create_serving_engine
    from paddle_tpu_torch.slim import export_serving_quant
    from paddle_tpu_torch.text import generation as tgen

    m = _port_model(weights)
    assert all(p.requires_grad for p in m.parameters())
    seen = []
    real = tgen.ragged_paged_attention

    def spy(q, *args, **kw):
        seen.append((torch.is_grad_enabled(), q.requires_grad))
        return real(q, *args, **kw)

    monkeypatch.setattr(tgen, "ragged_paged_attention", spy)
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (3, 9)]
    quant = export_serving_quant(m, calib_prompts=np.stack(
        [np.arange(1, 9), np.arange(2, 10)]))
    outs = []
    for kw in ({}, {"kv_cache_dtype": "int8", "weight_dtype": "int8",
                    "quant_scales": quant},
               {"kv_cache_dtype": "int8", "weight_dtype": "int8"}):
        eng = create_serving_engine(m, page_size=4, max_batch_size=2,
                                    prefill_chunk=4, eos_id=-1,
                                    device="cpu", **kw)
        ids = [eng.add_request(p, max_new_tokens=4) for p in prompts]
        outs.append(eng.drain()[ids[0]])
    ids, _ = tgen.generate(m, prompts[1][None], max_new_tokens=4, end_id=-1)
    assert not ids.requires_grad
    assert seen and not any(g or r for g, r in seen)
    assert all(p.grad is None for p in m.parameters())
