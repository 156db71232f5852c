"""The port's random ops (``paddle_tpu_torch/ops/random_ops.py``)
against ``paddle_tpu/ops/random_ops.py`` on the CPU.

The bits differ by design (the port draws from torch's generators,
Philox on the card and the Mersenne Twister on the CPU; the reference
from threefry keys), so each op is compared by statistics from a fixed
seed in each package: 20,000 draws whose mean and standard deviation
agree within five standard errors of the reference's, the support and
dtype held exactly.  Reproducibility is checked within the port:
``paddle.seed(s)`` replays the same draws."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import place
from torch_op_parity import to_numpy

N = 20000


@pytest.fixture(autouse=True)
def _cpu():
    prev = place._DEFAULT["device"]
    pt.set_device("cpu")
    yield
    place._DEFAULT["device"] = prev


def _draw(pkg, name):
    P = np.full((N,), 0.3, np.float32)
    LAM = np.full((N,), 2.5, np.float32)
    calls = {
        "rand": lambda: pkg.rand([N]),
        "randn": lambda: pkg.randn([N]),
        "standard_normal": lambda: pkg.standard_normal([N]),
        "uniform": lambda: pkg.uniform([N], min=-2.0, max=5.0),
        "uniform_seeded": lambda: pkg.uniform([N], min=0.0, max=1.0, seed=7),
        "normal": lambda: pkg.normal(1.5, 0.5, [N]),
        "normal_tensor": lambda: pkg.normal(pkg.to_tensor(np.full(
            (N,), -1.0, np.float32)), pkg.to_tensor(np.full((N,), 2.0,
                                                          np.float32))),
        "randint": lambda: pkg.randint(-3, 9, [N]),
        "randint_like": lambda: pkg.randint_like(pkg.to_tensor(
            np.zeros((N,), np.float32)), 0, 10),
        "randperm": lambda: pkg.randperm(N),
        "multinomial": lambda: pkg.multinomial(pkg.to_tensor(np.array(
            [0.1, 0.2, 0.7], np.float32)), N, replacement=True),
        "bernoulli": lambda: pkg.bernoulli(pkg.to_tensor(P)),
        "poisson": lambda: pkg.poisson(pkg.to_tensor(LAM)),
        "uniform_": lambda: pkg.to_tensor(np.zeros((N,), np.float32))
        .uniform_(-1.0, 3.0),
        "normal_": lambda: pkg.to_tensor(np.zeros((N,), np.float32))
        .normal_(2.0, 3.0),
        "exponential_": lambda: pkg.to_tensor(np.zeros((N,), np.float32))
        .exponential_(2.0),
    }
    return to_numpy(calls[name]())


OPS = ["rand", "randn", "standard_normal", "uniform", "uniform_seeded",
       "normal", "normal_tensor", "randint", "randint_like", "randperm",
       "multinomial", "bernoulli", "poisson", "uniform_", "normal_",
       "exponential_"]


@pytest.mark.parametrize("name", OPS)
def test_random_op_matches_reference_statistics(name):
    jp.seed(2024)
    pt.seed(2024)
    want, got = _draw(jp, name), _draw(pt, name)
    assert got.shape == want.shape
    assert got.dtype.kind == want.dtype.kind
    se = want.std() / np.sqrt(N)
    assert abs(got.mean() - want.mean()) < 5 * np.sqrt(2) * se + 1e-6, \
        (got.mean(), want.mean())
    assert abs(got.std() - want.std()) < 0.03 * want.std() + 1e-6
    assert got.min() >= want.min() - 5 * want.std() or name in (
        "randn", "standard_normal", "normal", "normal_tensor", "normal_")
    if want.dtype.kind in "iu":
        assert set(np.unique(got)) <= set(np.unique(want)) | set(
            range(int(want.min()), int(want.max()) + 1))
    if name == "randperm":
        np.testing.assert_array_equal(np.sort(got), np.arange(N))


@pytest.mark.parametrize("name", OPS)
def test_seed_replays_the_port_draws(name):
    pt.seed(99)
    a = _draw(pt, name)
    pt.seed(99)
    b = _draw(pt, name)
    np.testing.assert_array_equal(a, b)
    if name != "uniform_seeded":
        assert not np.array_equal(a, _draw(pt, name))


def test_multinomial_without_replacement_is_a_permutation():
    pt.seed(5)
    p = pt.to_tensor(np.array([[0.2, 0.3, 0.5, 0.0, 0.1]] * 4, np.float32))
    out = pt.multinomial(p, 4).numpy()
    assert out.shape == (4, 4)
    for row in out:
        assert len(set(row)) == 4 and 3 not in row
