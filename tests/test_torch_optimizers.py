"""paddle_tpu_torch's optimizers against the JAX package's eager ``step()``.

Every optimizer of ``optimizer/optimizer.py`` runs 5 steps in both
packages on the same seeded weights and gradients (three tensors of
mixed shapes, gradients spread over three orders of magnitude), under
each weight decay it takes ({none, float, ``L1Decay``, ``L2Decay``}; the
optimizers with a decay of their own vary that), a constant LR and a
scheduler stepped after each update, and no clip or each of the three
clips.  Also: the functional ``fused_step`` against ``step()``, loading
the JAX package's ``state_dict()`` read out as numpy arrays, ``Dpsgd``'s
noise statistically and ``ModelAverage``'s apply / restore.

Tolerance: 1e-6 absolute and relative, that of the optimizer rules in
``tests/test_torch_train.py::test_training_steps_match_jax`` — the same
f32 expressions in the same order, the bias corrections and scalar
products rounded to f32 as the JAX package's Python scalars are.
``fused_step`` against ``step()`` within the port is bit-equal: one rule
on the same operands.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn import clip_grad as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.tensor import Parameter
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.nn import clip_grad as tclip
from paddle_tpu_torch.optimizer import lr as tlr

TOL = 1e-6
STEPS = 5
SHAPES = [(4, 3), (5,), (2, 2, 3)]
PKGS = {"jax": (jopt, jlr, jreg, jclip), "torch": (topt, tlr, treg, tclip)}


def _decay(kind, R):
    return {"none": None, "float": 0.01, "l1": R.L1Decay(0.01),
            "l2": R.L2Decay(0.02)}[kind]


def _clip(kind, C):
    return {"none": None, "value": C.ClipGradByValue(0.5),
            "norm": C.ClipGradByNorm(0.7),
            "global": C.ClipGradByGlobalNorm(1.0)}[kind]


# name -> (make(O, lr, decay, clip, params), decays it is run under)
_GENERIC = ("none", "float", "l1", "l2")
OPTIMIZERS = {
    "SGD": (lambda O, lr, d, c, ps: O.SGD(lr, parameters=ps, weight_decay=d,
                                          grad_clip=c), _GENERIC),
    "Momentum": (lambda O, lr, d, c, ps: O.Momentum(
        lr, 0.9, parameters=ps, weight_decay=d, grad_clip=c), _GENERIC),
    "Momentum_nesterov": (lambda O, lr, d, c, ps: O.Momentum(
        lr, 0.8, parameters=ps, use_nesterov=True, weight_decay=d,
        grad_clip=c), ("none", "l2")),
    "Adagrad": (lambda O, lr, d, c, ps: O.Adagrad(
        lr, parameters=ps, weight_decay=d, grad_clip=c), _GENERIC),
    "Adam": (lambda O, lr, d, c, ps: O.Adam(
        lr, parameters=ps, weight_decay=d, grad_clip=c), _GENERIC),
    "AdamW": (lambda O, lr, d, c, ps: O.AdamW(
        lr, parameters=ps, weight_decay=0.0 if d is None else 0.05,
        grad_clip=c), ("none", "float")),
    "Adamax": (lambda O, lr, d, c, ps: O.Adamax(
        lr, parameters=ps, weight_decay=d, grad_clip=c), _GENERIC),
    "Adadelta": (lambda O, lr, d, c, ps: O.Adadelta(
        lr, parameters=ps, weight_decay=d, grad_clip=c), _GENERIC),
    "RMSProp": (lambda O, lr, d, c, ps: O.RMSProp(
        lr, momentum=0.5, parameters=ps, weight_decay=d, grad_clip=c),
        _GENERIC),
    "RMSProp_centered": (lambda O, lr, d, c, ps: O.RMSProp(
        lr, centered=True, parameters=ps, weight_decay=d, grad_clip=c),
        ("none", "l1")),
    "Lamb": (lambda O, lr, d, c, ps: O.Lamb(
        lr, lamb_weight_decay=0.0 if d is None else 0.01, parameters=ps,
        grad_clip=c), ("none", "float")),
    "Lars": (lambda O, lr, d, c, ps: O.Lars(
        lr, parameters=ps, lars_weight_decay=0.0 if d is None else 0.0005,
        grad_clip=c), ("none", "float")),
    "Ftrl": (lambda O, lr, d, c, ps: O.Ftrl(
        lr, l1=0.01, l2=0.01, parameters=ps, regularization=d, grad_clip=c),
        _GENERIC),
    "Dpsgd": (lambda O, lr, d, c, ps: O.Dpsgd(
        lr, clip=1.0, batch_size=4.0, sigma=0.0, parameters=ps), ("none",)),
    "Lookahead": (lambda O, lr, d, c, ps: O.Lookahead(
        O.Adam(lr, parameters=ps, weight_decay=d, grad_clip=c), 0.5, 2),
        _GENERIC),
}
NO_CLIP = ("Dpsgd",)


def _cases():
    out = []
    for name, (_, decays) in OPTIMIZERS.items():
        for decay in decays:
            for sched in (False, True):
                for clip in (("none",) if name in NO_CLIP else
                             ("none", "value", "norm", "global")):
                    out.append((name, decay, sched, clip))
    return out


def _init(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def _params(pkg, init):
    if pkg == "jax":
        return [Parameter(paddle.to_tensor(a)._value) for a in init]
    return [torch.nn.Parameter(torch.tensor(a)) for a in init]


def _grads(rng):
    out = []
    for s in SHAPES:
        g = rng.randn(*s).astype(np.float32)
        g[..., 0] *= 1e-3                         # a spread of magnitudes
        out.append(g)
    return out


def _set_grads(pkg, params, grads):
    for p, g in zip(params, grads):
        if pkg == "jax":
            p._grad = paddle.to_tensor(g)
        else:
            p.grad = torch.tensor(g)


def _read(pkg, params):
    return [np.asarray(p.numpy()) if pkg == "jax"
            else p.detach().numpy().copy() for p in params]


def _make(pkg, name, decay, sched, clip, params):
    O, L, R, C = PKGS[pkg]
    lr = L.StepDecay(0.1, 2, 0.5) if sched else 0.1
    return OPTIMIZERS[name][0](O, lr, _decay(decay, R), _clip(clip, C),
                               params)


def _scheduler(opt):
    inner = getattr(opt, "inner_optimizer", opt)
    return inner._lr if not isinstance(inner._lr, float) else None


def _run(pkg, name, decay, sched, clip, steps=STEPS):
    params = _params(pkg, _init())
    opt = _make(pkg, name, decay, sched, clip, params)
    rng = np.random.RandomState(1)
    for _ in range(steps):
        _set_grads(pkg, params, _grads(rng))
        opt.step()
        opt.clear_grad()
        s = _scheduler(opt)
        if s is not None:
            s.step()
    return _read(pkg, params), opt, params


@pytest.mark.parametrize("name,decay,sched,clip", _cases(),
                         ids=lambda v: str(v))
def test_optimizer_matches_jax(name, decay, sched, clip):
    want, jo, _ = _run("jax", name, decay, sched, clip)
    got, to, _ = _run("torch", name, decay, sched, clip)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    counts = [getattr(o, "inner_optimizer", o)._step_count for o in (to, jo)]
    assert counts == [STEPS, STEPS]
    assert to.get_lr() == jo.get_lr()


FUSED = [n for n in OPTIMIZERS if n != "Dpsgd"]


@pytest.mark.parametrize("name", FUSED)
def test_fused_step_equals_step(name):
    """The functional path (``init_opt_state`` / ``fused_step``) and the
    in-place ``step()`` run one rule: bit-equal weights and state, with
    a scheduler and the global-norm clip."""
    init = _init()
    params = _params("torch", init)
    opt = _make("torch", name, "l2" if "l2" in OPTIMIZERS[name][1]
                else "none", True, "global", params)
    names = [f"w{i}" for i in range(len(init))]
    fparams = {n: torch.tensor(a) for n, a in zip(names, init)}
    state = opt.init_opt_state(fparams)
    rng = np.random.RandomState(1)
    for step in range(1, STEPS + 1):
        grads = _grads(rng)
        _set_grads("torch", params, grads)
        fparams, state = opt.fused_step(
            fparams, {n: torch.tensor(g) for n, g in zip(names, grads)},
            state, step)
        opt.step()
        opt.clear_grad()
        _scheduler(opt).step()
    for n, p in zip(names, params):
        assert torch.equal(fparams[n], p.detach()), n
    for kind in opt._acc_kinds():
        for n, p in zip(names, params):
            assert torch.equal(state[kind][n],
                               opt._accumulators[kind][id(p)]), (kind, n)


STATEFUL = [n for n in FUSED if n not in ("SGD", "Dpsgd")]


@pytest.mark.parametrize("name", STATEFUL)
def test_loads_the_jax_state_dict_as_numpy(name):
    """Three reference steps, its ``state_dict()`` read out as numpy
    arrays loaded into a port optimizer over the reference's weights;
    then two more steps in both."""
    _, jo, jp = _run("jax", name, "none", True, "none", steps=3)
    sd = {}
    for k, v in jo.state_dict().items():
        if k == "inner":
            v = {ik: (np.asarray(iv._value) if hasattr(iv, "_value")
                      else iv) for ik, iv in v.items()}
        elif hasattr(v, "_value"):
            v = np.asarray(v._value)
        sd[k] = v
    tp = _params("torch", _read("jax", jp))
    to = _make("torch", name, "none", True, "none", tp)
    to.set_state_dict(sd)
    counts = [getattr(o, "inner_optimizer", o)._step_count for o in (to, jo)]
    assert counts == [3, 3]
    assert to.get_lr() == jo.get_lr()
    rng = np.random.RandomState(9)
    for _ in range(2):
        grads = _grads(rng)
        for pkg, ps, o in (("jax", jp, jo), ("torch", tp, to)):
            _set_grads(pkg, ps, grads)
            o.step()
            o.clear_grad()
            _scheduler(o).step()
    for a, b in zip(_read("torch", tp), _read("jax", jp)):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    got = to.state_dict()
    want = jo.state_dict()
    if name == "Lookahead":
        got, want = got["inner"], want["inner"]
    assert set(got) == set(want)


def test_dpsgd_noise_is_statistical():
    """The clip exactly (sigma 0 is covered above); with sigma 0.5 and
    batch 2 the noise added to each tensor in a step is one gaussian
    scalar of std 0.25 scaled by lr: mean and spread over 400 steps
    within 5 standard errors."""
    p = torch.nn.Parameter(torch.zeros(4))
    opt = topt.Dpsgd(1.0, clip=1e9, batch_size=2.0, sigma=0.5,
                     parameters=[p])
    draws = []
    for _ in range(400):
        before = p.detach().clone()
        p.grad = torch.zeros(4)
        opt.step()
        d = -(p.detach() - before)
        assert torch.allclose(d, d[0].expand(4))   # one scalar a tensor
        draws.append(float(d[0]))
    draws = np.asarray(draws)
    n = len(draws)
    assert abs(draws.mean()) < 5 * 0.25 / np.sqrt(n)
    assert abs(draws.std() - 0.25) < 5 * 0.25 / np.sqrt(2 * n)


@pytest.mark.parametrize("windows", [(2, 3), (3, 10)])
def test_model_average_matches_jax(windows):
    """Accumulate after each of 7 SGD steps, then apply (averaged
    weights) and restore (the trained ones), in both packages."""
    lo, hi = windows
    out = {}
    for pkg in ("jax", "torch"):
        O = PKGS[pkg][0]
        params = _params(pkg, _init())
        sgd = O.SGD(0.1, parameters=params)
        ma = O.ModelAverage(0.5, parameters=params, min_average_window=lo,
                            max_average_window=hi)
        rng = np.random.RandomState(1)
        for _ in range(7):
            _set_grads(pkg, params, _grads(rng))
            sgd.step()
            sgd.clear_grad()
            ma.step()
        trained = _read(pkg, params)
        with ma.apply():
            averaged = _read(pkg, params)
        out[pkg] = (trained, averaged, _read(pkg, params))
    for got, want in zip(out["torch"], out["jax"]):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for a, b in zip(out["torch"][0], out["torch"][2]):
        assert np.array_equal(a, b)
    with pytest.raises(TypeError, match="not a training optimizer"):
        topt.ModelAverage(0.5, parameters=[torch.zeros(1)]).fused_step(
            {}, {}, {}, 1)


@pytest.mark.parametrize("make,refused", [
    (lambda ps: topt.Adam(parameters=ps, lazy_mode=True), False),
    (lambda ps: topt.AdamW(parameters=ps, apply_decay_param_fun=lambda n: 1),
     False),
    (lambda ps: topt.AdamW(parameters=ps, lr_ratio=lambda p: 1.0), True),
], ids=["lazy_mode", "apply_decay_param_fun", "lr_ratio"])
def test_unported_knobs_raise_naming_item_8(make, refused):
    """Item 8 is done: ``lazy_mode`` and ``apply_decay_param_fun`` are
    taken (``tests/test_torch_sparse_grad.py`` holds them against the JAX
    package); ``lr_ratio``, which the JAX package never reads, raises."""
    ps = [torch.nn.Parameter(torch.zeros(2))]
    if refused:
        with pytest.raises(InvalidArgumentError, match="never reads"):
            make(ps)
    else:
        make(ps)
