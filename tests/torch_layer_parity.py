"""Layer parity between paddle_tpu and paddle_tpu_torch for the CPU tests
of the port's paddle-API layers (``tests/test_torch_seq_layers.py``,
``tests/test_torch_transformer_layers.py``).

``build(factory)`` makes ``factory(nn)`` in both packages and copies
paddle_tpu's weights into the port's (``set_state_dict`` over
``state_from_numpy``; the ``state_dict`` names must be equal, in order).
``compare`` runs the same inputs through both and backpropagates the same
weighted sum of the outputs: forward within ``FWD``, input and parameter
gradients within ``GRAD`` (the same f32 products on two backends, summed
in another order, at sizes of at most 32)."""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import state_from_numpy

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def build(factory, seed=0):
    """The layer ``factory(nn)`` in both packages, paddle_tpu's weights
    copied into the port's."""
    paddle.seed(seed)
    jl = factory(jnn)
    tl = factory(tnn)
    state = {k: np.asarray(v._value) for k, v in jl.state_dict().items()}
    assert list(state) == list(tl.state_dict())
    missing, unexpected = tl.set_state_dict(state_from_numpy(state, "cpu"))
    assert missing == [] and unexpected == []
    return jl, tl


def flat(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in flat(o)]
    return [] if out is None else [out]


def as_np(t):
    return np.asarray(t.numpy())


def compare(jl, tl, inputs, call=lambda layer, *xs: layer(*xs),
            grad=True):
    """Forward both on ``inputs`` (numpy; float ones get gradients), then
    backward the same weighted sum; returns the port's outputs."""
    def wrap(mod, a):
        fl = np.issubdtype(np.asarray(a).dtype, np.floating)
        return mod.to_tensor(a, stop_gradient=not (grad and fl))

    jx = [wrap(paddle, a) for a in inputs]
    tx = [wrap(pt, a) for a in inputs]
    jo, to = flat(call(jl, *jx)), flat(call(tl, *tx))
    assert len(jo) == len(to)
    for j, t in zip(jo, to):
        assert j.shape == t.shape
        np.testing.assert_allclose(as_np(t), as_np(j), **FWD)
    if not grad:
        return to
    rng = np.random.RandomState(7)
    jloss = tloss = None
    for j, t in zip(jo, to):
        w = rng.randn(*j.shape).astype(np.float32)
        jterm = (j * paddle.to_tensor(w)).sum()
        tterm = (t * pt.to_tensor(w)).sum()
        jloss = jterm if jloss is None else jloss + jterm
        tloss = tterm if tloss is None else tloss + tterm
    jloss.backward()
    tloss.backward()
    for j, t in zip(jx, tx):
        if t.stop_gradient:
            continue
        if t.grad is None:          # no path from the input (a mask)
            assert j.grad is None or not as_np(j.grad).any()
            continue
        np.testing.assert_allclose(as_np(t.grad), as_np(j.grad), **GRAD)
    if not hasattr(jl, "state_dict"):
        return to
    jp, tp = jl.state_dict(), tl.state_dict()
    for name in jp:
        if jp[name].grad is None:
            assert tp[name].grad is None, name
            continue
        np.testing.assert_allclose(as_np(tp[name].grad),
                                   as_np(jp[name].grad), err_msg=name,
                                   **GRAD)
    return to


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def rand_ids(high, *shape, seed=0):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


def one_torch_thread_on_the_cpu():
    """Body of the test modules' fixture: torch on one thread (the cases
    are runs of small ops; the suite's workers share the CPU) and the
    CPU as the port's default place."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    torch.set_num_threads(prev)
