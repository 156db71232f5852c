"""``ParamAttr`` in the port against paddle_tpu's eager step on the CPU.

A two-layer MLP is built in both packages with the same ``ParamAttr``
settings and the JAX package's initial weights, then trained 3 steps
(``loss.backward(); opt.step(); opt.clear_grad()``) on the same seeded
batches under SGD, Momentum and Adam with a global-norm clip and an
optimizer-level ``L1Decay``; the parameters after every step within
1e-6 (the optimizer rules' tolerance in ``tests/test_torch_optimizers``:
the same f32 expressions in the same order).  Settings, one case each:
the learning-rate scale, a parameter's own regularizer (which takes the
place of the optimizer's), ``need_clip=False``, ``trainable=False`` and
all of them at once; and the name and the initializer.

The port keeps the eager semantics on every path: ``fused_step`` over
the live tensors and ``hapi.Model``'s accelerated step give the eager
``step()``'s parameters bit for bit (the reference's own fused step
ignores these settings; ROADMAP "Known facts about the reference")."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import place

TOL = 1e-6
STEPS = 3


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _attrs(P, setting):
    """(weight_attr of layer 1, bias_attr of layer 1, weight_attr of
    layer 2) for a setting."""
    R = P.regularizer
    lr = P.ParamAttr(learning_rate=0.5)
    reg = P.ParamAttr(regularizer=R.L2Decay(0.05))
    noclip = P.ParamAttr(need_clip=False)
    frozen = P.ParamAttr(trainable=False)
    return {
        "lr_scale": (lr, None, P.ParamAttr(learning_rate=2.0)),
        "regularizer": (reg, P.ParamAttr(regularizer=R.L1Decay(0.02)), None),
        "need_clip": (noclip, noclip, None),
        "trainable": (None, frozen, frozen),
        "all": (P.ParamAttr(learning_rate=0.5, regularizer=R.L2Decay(0.05),
                            need_clip=False), frozen,
                P.ParamAttr(learning_rate=3.0)),
    }[setting]


def _net(P, setting):
    w1, b1, w2 = _attrs(P, setting)
    return P.nn.Sequential(P.nn.Linear(4, 5, weight_attr=w1, bias_attr=b1),
                           P.nn.Tanh(), P.nn.Linear(5, 2, weight_attr=w2))


def _opt(P, kind, params):
    clip = P.nn.ClipGradByGlobalNorm(0.3)
    wd = P.regularizer.L1Decay(0.01)
    if kind == "SGD":
        return P.optimizer.SGD(0.1, parameters=params, weight_decay=wd,
                               grad_clip=clip)
    if kind == "Momentum":
        return P.optimizer.Momentum(0.1, 0.9, parameters=params,
                                    weight_decay=wd, grad_clip=clip)
    return P.optimizer.Adam(0.05, parameters=params, weight_decay=wd,
                            grad_clip=clip)


def _batches():
    r = np.random.RandomState(3)
    return [(r.uniform(-1, 1, (6, 4)).astype(np.float32),
             r.uniform(-1, 1, (6, 2)).astype(np.float32))
            for _ in range(STEPS)]


def _pair(setting):
    jp.seed(11)
    jnet = _net(jp, setting)
    tnet = _net(pt, setting)
    state = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()}
    for k, v in tnet.state_dict().items():
        v.set_value(state[k])
    return jnet, tnet


def _train(P, net, kind, batches):
    opt = _opt(P, kind, net.parameters())
    out = []
    for x, y in batches:
        d = net(P.to_tensor(x)) - P.to_tensor(y)
        (d * d).mean().backward()
        opt.step()
        opt.clear_grad()
        out.append({k: np.array(v.numpy()) for k, v in
                    net.state_dict().items()})
    return out


@pytest.mark.parametrize("kind", ["SGD", "Momentum", "Adam"])
@pytest.mark.parametrize("setting", ["lr_scale", "regularizer", "need_clip",
                                     "trainable", "all"])
def test_param_attr_step_matches_reference(setting, kind):
    jnet, tnet = _pair(setting)
    init = {k: v.numpy().copy() for k, v in tnet.state_dict().items()}
    batches = _batches()
    want = _train(jp, jnet, kind, batches)
    got = _train(pt, tnet, kind, batches)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step} {k}")
    if setting in ("trainable", "all"):
        np.testing.assert_array_equal(got[-1]["0.bias"], init["0.bias"])
        assert tnet[0].bias.stop_gradient and not tnet[0].bias.trainable


def test_name_and_initializer_match_reference():
    for P in (jp, pt):
        lin = P.nn.Linear(3, 2, weight_attr=P.ParamAttr(
            name="fc_w", initializer=P.nn.initializer.Constant(0.3)),
            bias_attr="fc_b")
        assert lin.weight.name == "fc_w" and lin.bias.name == "fc_b"
        np.testing.assert_array_equal(lin.weight.numpy(), np.float32(0.3))
    # a bare initializer is a ParamAttr's initializer
    lin = pt.nn.Linear(3, 2, weight_attr=pt.nn.initializer.Constant(2.0))
    np.testing.assert_array_equal(lin.weight.numpy(), 2.0)
    p = pt.create_parameter([2, 2], "float32", attr=pt.ParamAttr(
        learning_rate=0.25, need_clip=False))
    assert p.optimize_attr["learning_rate"] == 0.25 and not p.need_clip
    assert pt.nn.Linear(3, 2, bias_attr=False).bias is None


@pytest.mark.parametrize("kind", ["SGD", "Adam"])
def test_fused_step_over_live_tensors_equals_step(kind):
    _, a = _pair("all")
    _, b = _pair("all")
    batches = _batches()
    want = _train(pt, a, kind, batches)
    opt = _opt(pt, kind, b.parameters())
    names = [n for n, p in b.named_parameters() if not p.stop_gradient]
    live = {n: p._value for n, p in b.named_parameters()
            if not p.stop_gradient}
    state = opt.init_opt_state(live)
    for step, (x, y) in enumerate(batches):
        d = b(pt.to_tensor(x)) - pt.to_tensor(y)
        loss = (d * d).mean()._value
        grads = torch.autograd.grad(loss, [live[n] for n in names])
        new_p, state = opt.fused_step(live, dict(zip(names, grads)), state,
                                      step + 1)
        with torch.no_grad():
            for n in names:
                live[n].copy_(new_p[n])
    for k, v in b.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[-1][k], err_msg=k)


def test_accelerated_model_step_equals_eager():
    losses = {}
    finals = {}
    for accelerate in (False, True):
        _, net = _pair("all")
        model = pt.Model(net)
        model.prepare(_opt(pt, "Adam", net.parameters()),
                      pt.nn.MSELoss(), accelerate=accelerate)
        losses[accelerate] = [model.train_batch([x], [y])
                              for x, y in _batches()]
        finals[accelerate] = {k: v.numpy() for k, v in
                              model.state_dict().items()}
    assert str(losses[True]) == str(losses[False])
    for k in finals[False]:
        np.testing.assert_array_equal(finals[True][k], finals[False][k],
                                      err_msg=k)


def test_param_attr_holds_after_decorate_o2():
    """``amp.decorate(level="O2")`` after the optimizer is built gives
    each parameter a new bf16 tensor; its settings still hold: a bf16
    SGD step against the JAX package's decorated one, within a bf16
    rounding of the tensor's largest entry (2^-7 of it: the gradients are
    bf16 and summed in another order, so an entry near zero, a bias, may
    land a bf16 ulp of its update apart; with the settings ignored the
    second layer is 4e-2 of its largest entry off)."""
    jnet, tnet = _pair("all")
    got = {}
    for P, net in ((jp, jnet), (pt, tnet)):
        opt = _opt(P, "SGD", net.parameters())
        P.amp.decorate(models=net, optimizers=opt, level="O2",
                       dtype="bfloat16")
        for x, y in _batches()[:1]:
            d = (net(P.to_tensor(x, dtype="bfloat16"))
                 - P.to_tensor(y, dtype="bfloat16"))
            (d * d).mean().backward()
            opt.step()
            opt.clear_grad()
        got[P] = {k: np.asarray(v.astype("float32").numpy())
                  for k, v in net.state_dict().items()}
    for k, want in got[jp].items():
        np.testing.assert_allclose(got[pt][k], want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("accelerate", [False, True])
def test_param_attr_holds_through_prepare_without_parameters(accelerate):
    """An optimizer built without ``parameters=`` takes the network's
    from ``Model.prepare``; its steps equal the JAX package's eager loop
    over an optimizer given the parameters (the reference's ``Model``
    cannot step such an optimizer eagerly, and its fused step ignores the
    settings), within ``TOL``."""
    jnet, tnet = _pair("all")
    batches = _batches()
    jopt = _opt(jp, "Adam", jnet.parameters())
    for x, y in batches:
        jp.nn.MSELoss()(jnet(jp.to_tensor(x)), jp.to_tensor(y)).backward()
        jopt.step()
        jopt.clear_grad()
    model = pt.Model(tnet)
    model.prepare(_opt(pt, "Adam", None), pt.nn.MSELoss(),
                  accelerate=accelerate)
    for x, y in batches:
        model.train_batch([x], [y])
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(tnet.state_dict()[k].numpy(),
                                   np.asarray(v._value), rtol=TOL, atol=TOL,
                                   err_msg=k)
