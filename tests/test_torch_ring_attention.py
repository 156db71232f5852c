"""paddle_tpu_torch's ring attention and Ulysses against the JAX package's
on the same inputs — the twins of ``tests/test_attention.py``'s
``TestRingAttention`` (:81-130) and ``TestRingFlash`` (:327-370).

The port's mesh runs on ``force_device_count(8)`` CPU slots, the JAX
package's on the 8 forced host devices.  At ``S_local >= 128`` (a
multiple of 128) the port takes its flash ring, whose kernels run their
plain versions on the CPU (``ops/flash_attention.py``); it is held
against the JAX package's einsum ring (``use_flash=False``) on the same
inputs, which computes the same function without Pallas' interpret
mode.  Below that both take the einsum ring.

Tolerances: f32 outputs and gradients within 2e-5 absolute and 1e-4
relative of the JAX package's (chunk partials merged in another order),
and within 2e-3 of the plain whole-sequence attention (the JAX tests'
bound).
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.mesh import shard_map as jshard_map

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.ops.flash_attention import FLASH_ROUTE_STATS
from torch_layer_parity import one_torch_thread_on_the_cpu

ATOL, RTOL = 2e-5, 1e-4
# the packages re-export the function under the module's name
jra = importlib.import_module("paddle_tpu.distributed.ring_attention")
tra = importlib.import_module("paddle_tpu_torch.distributed.ring_attention")


@pytest.fixture(scope="module", autouse=True)
def _cpu_slots():
    prev = tmesh.force_device_count(8)
    for _ in one_torch_thread_on_the_cpu():
        yield
    tmesh.force_device_count(prev)


def make_qkv(B=1, S=256, H=2, D=32, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def reference_attention(q, k, v, causal=False):
    qt, kt, vt = (np.swapaxes(x, 1, 2).astype(np.float64) for x in (q, k, v))
    s = qt @ np.swapaxes(kt, -1, -2) / np.sqrt(q.shape[-1])
    if causal:
        S = s.shape[-1]
        s = np.where(np.tril(np.ones((S, S), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.swapaxes(p @ vt, 1, 2)


def _jax_ring(sp, causal, use_flash=None, ulysses=False):
    mesh = jdist.init_mesh({"sp": sp})
    spec = JP(None, "sp", None, None)
    if ulysses:
        body = lambda a, b, c: jra.ulysses_attention(a, b, c, "sp",  # noqa
                                                     causal=causal)
    else:
        body = functools.partial(jra.ring_attention, axis_name="sp",
                                 causal=causal, use_flash=use_flash)
    return jshard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                      out_specs=spec)


def _port_ring(sp, causal, use_flash=None, ulysses=False):
    mesh = tmesh.init_mesh({"sp": sp}, device_type="cpu")
    spec = tmesh.P(None, "sp", None, None)
    if ulysses:
        body = lambda a, b, c: tra.ulysses_attention(a, b, c, "sp",  # noqa
                                                     causal=causal)
    else:
        body = functools.partial(tra.ring_attention, axis_name="sp",
                                 causal=causal, use_flash=use_flash)
    return tmesh.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                           out_specs=spec)


def _fwd_and_grads(jfn, tfn, q, k, v, seed=1):
    """Both packages' outputs and (dq, dk, dv) of sum(out * w)."""
    w = np.random.RandomState(seed).randn(*q.shape).astype(np.float32)

    def jloss(a, b, c):
        return jnp.sum(jfn(a, b, c) * jnp.asarray(w))

    args = [jnp.asarray(x) for x in (q, k, v)]
    jout, jg = jax.jit(lambda a, b, c: (
        jfn(a, b, c), jax.grad(jloss, argnums=(0, 1, 2))(a, b, c)))(*args)
    jout, jg = np.asarray(jout), [np.asarray(g) for g in jg]
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tout = tfn(*leaves)
    tg = torch.autograd.grad(tout, leaves, grad_outputs=torch.tensor(w))
    return jout, jg, tout.detach().numpy(), [g.numpy() for g in tg]


def _check(jout, jg, tout, tg):
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=RTOL)
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_full_attention(self, causal):
        """sp 8, S 256 (S_local 32: the einsum ring in both)."""
        q, k, v = make_qkv(B=1, S=256, H=2, D=32, seed=3 if causal else 0)
        FLASH_ROUTE_STATS["ref"] = 0
        jout, jg, tout, tg = _fwd_and_grads(_jax_ring(8, causal),
                                            _port_ring(8, causal), q, k, v)
        assert FLASH_ROUTE_STATS["ref"] == 0
        _check(jout, jg, tout, tg)
        np.testing.assert_allclose(tout, reference_attention(q, k, v, causal),
                                   rtol=2e-3, atol=2e-3)

    def test_grad_flows(self):
        q, k, v = make_qkv(B=1, S=128, H=2, D=32)
        leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        pt.distributed.init_mesh({"sp": 8}, device_type="cpu")
        out = pt.distributed.sequence_parallel_attention(*leaves)
        (out ** 2).sum().backward()
        assert all(torch.isfinite(t.grad).all() for t in leaves)

    @pytest.mark.parametrize("causal", [False, True])
    def test_ulysses_matches(self, causal):
        """Ulysses over sp 4 (heads scattered by all_to_all), forward and
        gradients."""
        q, k, v = make_qkv(B=1, S=128, H=4, D=32, seed=5)
        jout, jg, tout, tg = _fwd_and_grads(
            _jax_ring(4, causal, ulysses=True),
            _port_ring(4, causal, ulysses=True), q, k, v)
        _check(jout, jg, tout, tg)
        np.testing.assert_allclose(tout, reference_attention(q, k, v, causal),
                                   rtol=2e-3, atol=2e-3)

    def test_functional_entry(self):
        """``nn.functional.ring_attention`` on the installed mesh."""
        from paddle_tpu import nn as jnn
        from paddle_tpu.tensor import Tensor as JTensor

        q, k, v = make_qkv(B=2, S=64, H=2, D=16, seed=9)
        jdist.init_mesh({"sp": 4})
        pt.distributed.init_mesh({"sp": 4}, device_type="cpu")
        j = jax.jit(lambda a, b, c: jnn.functional.ring_attention(
            JTensor(a), JTensor(b), JTensor(c), causal=True)._value)(
                *map(jnp.asarray, (q, k, v)))
        t = pt.nn.functional.ring_attention(pt.to_tensor(q), pt.to_tensor(k),
                                            pt.to_tensor(v), causal=True)
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   atol=ATOL, rtol=RTOL)


class TestRingFlash:
    """S_local = 128: the port's flash ring (#5-#7 per chunk pair, merged
    in lse space; one autograd node for the counter-rotating backward)."""

    @pytest.mark.parametrize("causal", [False, True])
    def test_flash_ring_matches_jax(self, causal):
        sp = 4
        q, k, v = make_qkv(B=1, S=512, H=2, D=32, seed=7)
        FLASH_ROUTE_STATS["ref"] = 0
        jout, jg, tout, tg = _fwd_and_grads(
            _jax_ring(sp, causal, use_flash=False), _port_ring(sp, causal),
            q, k, v)
        # the plain versions of fwd, dkv and dq, once per visible
        # (query shard, kv chunk) pair: n(n+1)/2 causal, n^2 otherwise
        pairs = sp * (sp + 1) // 2 if causal else sp * sp
        assert FLASH_ROUTE_STATS["ref"] == 3 * pairs
        _check(jout, jg, tout, tg)
        np.testing.assert_allclose(tout, reference_attention(q, k, v, causal),
                                   rtol=2e-3, atol=2e-3)

    def test_flash_ring_equals_plain_ring(self):
        """The port's two routes on the same shards (causal, dp 2 x sp 4:
        two rings in one node)."""
        q, k, v = make_qkv(B=2, S=512, H=2, D=16, seed=11)
        mesh = tmesh.init_mesh({"dp": 2, "sp": 4}, device_type="cpu")
        spec = tmesh.P(None, "sp", None, None)
        outs = {}
        for flash in (True, False):
            fn = tmesh.shard_map(
                functools.partial(tra.ring_attention, axis_name="sp",
                                  causal=True, use_flash=flash),
                mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
            leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
            out = fn(*leaves)
            grads = torch.autograd.grad((out ** 2).sum(), leaves)
            outs[flash] = [out.detach()] + list(grads)
        for a, b in zip(outs[True], outs[False]):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)

    def test_short_shards_keep_the_einsum_ring(self):
        q, k, v = make_qkv(B=1, S=128, H=2, D=32, seed=2)
        FLASH_ROUTE_STATS["ref"] = 0
        out = _port_ring(4, False)(*map(torch.tensor, (q, k, v)))
        assert FLASH_ROUTE_STATS["ref"] == 0
        np.testing.assert_allclose(out.numpy(), reference_attention(q, k, v),
                                   rtol=2e-3, atol=2e-3)
