"""paddle_tpu_torch flash attention vs the JAX package's Pallas kernels.

The port's plain versions of the three bodies (the CPU route of
``_flash_fwd_bhsd``, ``_flash_dkv_bhsd``, ``_flash_dq_bhsd``) are held
against the Pallas kernels in interpret mode, called directly as
``tests/test_attention.py`` calls them, on seeded numpy inputs; the
``autograd.Function`` against ``jax.grad`` of ``flash_attention_bshd``;
the attention routing against the JAX package's ``ROUTE_STATS``.

Tolerances: the dropout keep bits are compared bit for bit.  Outputs,
lse and gradients 2e-5 absolute: the same f32 products on the CPU, the
kernel's online softmax over key blocks against the plain version's
single pass (values of magnitude ~1, sums over at most 100 positions;
the largest difference seen is ~1e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.ops import attention as jatt
from paddle_tpu.ops.pallas_ops import flash_attention as jfa
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=0, atol=2e-5)
B, H = 2, 2


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# dropout keep bits
# --------------------------------------------------------------------------
@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.999])
@pytest.mark.parametrize("seed", [0, 1, 987654321, -1, -2 ** 31, 2 ** 31 - 1])
def test_keep_mask_bit_for_bit(seed, p):
    rng = np.random.RandomState(abs(seed) % 1000)
    rows = rng.randint(0, 1 << 20, (48, 1)).astype(np.int32)
    cols = rng.randint(0, 1 << 20, (1, 40)).astype(np.int32)
    for bh in (0, 5, 191):
        want = np.asarray(jfa._keep_mask(
            jnp.int32(seed), jnp.int32(bh), jnp.asarray(rows),
            jnp.asarray(cols), p))
        got = tfa._keep_mask(seed, bh, _t(rows), _t(cols), p).numpy()
        np.testing.assert_array_equal(got, want)
    # a tensor bh broadcasts like the kernels' (b·h, row, col) grid
    bhs = np.arange(3, dtype=np.int32)[:, None, None]
    want = np.asarray(jfa._keep_mask(jnp.int32(seed), jnp.asarray(bhs),
                                     jnp.asarray(rows), jnp.asarray(cols),
                                     p))
    got = tfa._keep_mask(seed, _t(bhs), _t(rows), _t(cols), p).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the three bodies, plain versions vs Pallas interpret mode
# --------------------------------------------------------------------------
# (name, S, D, causal, masked, dropout_p, block_q, block_k)
_CASES = [("full", 64, 16, False, False, 0.0, 32, 16),
          ("causal", 64, 16, True, False, 0.0, 32, 16),
          ("mask_dropout", 64, 16, False, True, 0.3, 16, 32),
          ("causal_mask_dropout", 64, 16, True, True, 0.3, 32, 16),
          ("unaligned", 100, 20, True, True, 0.1, 50, 25)]
_SEED = -12345


def _inputs(S, D, masked, seed=0, Sk=None):
    rng = np.random.RandomState(seed + S + D)
    Sk = S if Sk is None else Sk
    q, g = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, Sk, D).astype(np.float32) for _ in range(2))
    mask = np.ones((B, 1, Sk), np.float32)
    if masked:
        mask[1, 0, Sk - Sk // 3:] = 0.0
    return q, k, v, g, mask


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's Pallas forward, dK/dV and dQ, computed once."""
    out = {}
    for name, S, D, causal, masked, p, bq, bk in _CASES:
        q, k, v, g, mask = _inputs(S, D, masked)
        scale = 1.0 / np.sqrt(D)
        seed = jnp.asarray([_SEED], jnp.int32)
        o, lse = jfa._flash_fwd_bhsd(*map(jnp.asarray, (q, k, v, mask)),
                                     seed, scale, causal, p, bq, bk)
        delta = (g * np.asarray(o)).sum(-1).reshape(B * H, S, 1)
        bwd = tuple(map(jnp.asarray, (q, k, v, g))) + (
            lse, jnp.asarray(delta), jnp.asarray(mask), seed, scale, causal,
            p, bq, bk)
        dk, dv = jfa._flash_dkv_bhsd(*bwd)
        dq = jfa._flash_dq_bhsd(*bwd)
        out[name] = dict(inputs=(q, k, v, g, mask), o=np.asarray(o),
                         lse=np.asarray(lse), delta=delta,
                         dk=np.asarray(dk), dv=np.asarray(dv),
                         dq=np.asarray(dq), scale=scale, causal=causal, p=p)
    return out


def _port_args(run):
    q, k, v, g, mask = (_t(a) for a in run["inputs"])
    return q, k, v, g, mask


@pytest.mark.parametrize("case", [c[0] for c in _CASES])
def test_fwd_matches_pallas(jax_runs, case):
    run = jax_runs[case]
    q, k, v, _, mask = _port_args(run)
    tfa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
    o, lse = tfa._flash_fwd_bhsd(q, k, v, mask, _SEED, run["scale"],
                                 run["causal"], run["p"])
    assert tfa.FLASH_ROUTE_STATS == {"fwd": 0, "dkv": 0, "dq": 0, "ref": 1}
    assert o.dtype == torch.float32 and lse.shape == run["lse"].shape
    np.testing.assert_allclose(o.numpy(), run["o"], **TOL)
    np.testing.assert_allclose(lse.numpy(), run["lse"], **TOL)


@pytest.mark.parametrize("case", [c[0] for c in _CASES])
def test_dkv_and_dq_match_pallas(jax_runs, case):
    """Both backward bodies for the given (JAX) lse and delta."""
    run = jax_runs[case]
    q, k, v, g, mask = _port_args(run)
    args = (q, k, v, g, _t(run["lse"]), _t(run["delta"]), mask, _SEED,
            run["scale"], run["causal"], run["p"])
    dk, dv = tfa._flash_dkv_bhsd(*args)
    dq = tfa._flash_dq_bhsd(*args)
    np.testing.assert_allclose(dk.numpy(), run["dk"], **TOL)
    np.testing.assert_allclose(dv.numpy(), run["dv"], **TOL)
    np.testing.assert_allclose(dq.numpy(), run["dq"], **TOL)


def test_backward_bodies_on_a_ring_chunk_match_pallas():
    """Sq != Sk with causal=False, as ring attention calls the backward
    bodies on an off-diagonal chunk with the GLOBAL lse and delta."""
    Sq, Sk, D = 32, 64, 16
    q, k, v, g, mask = _inputs(Sq, D, True, seed=3, Sk=Sk)
    rng = np.random.RandomState(4)
    lse = (rng.rand(B * H, Sq, 1) * 2 + 3).astype(np.float32)
    delta = rng.randn(B * H, Sq, 1).astype(np.float32) * 0.1
    seed = jnp.asarray([77], jnp.int32)
    jargs = tuple(map(jnp.asarray, (q, k, v, g, lse, delta, mask))) + (
        seed, 0.25, False, 0.2, 16, 32)
    jdk, jdv = jfa._flash_dkv_bhsd(*jargs)
    jdq = jfa._flash_dq_bhsd(*jargs)
    targs = tuple(_t(a) for a in (q, k, v, g, lse, delta, mask)) + (
        77, 0.25, False, 0.2)
    dk, dv = tfa._flash_dkv_bhsd(*targs)
    dq = tfa._flash_dq_bhsd(*targs)
    assert dk.shape == (B, H, Sk, D) and dq.shape == (B, H, Sq, D)
    for got, want in ((dk, jdk), (dv, jdv), (dq, jdq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,D,causal,p", [(64, 16, True, 0.2),
                                          (100, 20, False, 0.1)],
                         ids=["causal_dropout", "unaligned_dropout"])
def test_autograd_function_matches_jax_grad(S, D, causal, p):
    """``flash_attention_bshd`` through ``FlashAttentionCore``: output and
    dq, dk, dv against ``jax.grad`` of the JAX package's wrapper (which
    pads S to 128 and D to 64; the port pads nothing)."""
    rng = np.random.RandomState(S)
    q, k, v, w = (rng.randn(B, S, H, D).astype(np.float32)
                  for _ in range(4))
    kv_mask = np.ones((B, S), np.float32)
    kv_mask[0, S - 10:] = 0.0

    def loss(q, k, v):
        out = jfa.flash_attention_bshd(q, k, v, causal=causal,
                                       kv_mask=jnp.asarray(kv_mask),
                                       dropout_p=p, seed=31)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tfa.flash_attention_bshd(tq, tk, tv, causal=causal,
                                   kv_mask=_t(kv_mask), dropout_p=p, seed=31)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
def _mask_forms(rng, S):
    keep = np.ones((B, S), bool)
    keep[1, S - 5:] = False
    additive = np.where(keep, 0.0, -3.0).astype(np.float32)
    return {
        "none": None,
        "valid_bool_2d": keep,
        "valid_float_2d": keep.astype(np.float32),
        "bool_4d": keep[:, None, None, :],
        "additive_float_4d": additive[:, None, None, :],
        "dense_bool_4d": rng.rand(B, H, S, S) > 0.2,
    }


# mask form -> route with PADDLE_TPU_FORCE_FLASH=1 (an additive float
# mask is never binarized: it stays on the plain route)
_ROUTES = {"none": "pallas", "valid_bool_2d": "pallas",
           "valid_float_2d": "pallas", "bool_4d": "pallas",
           "additive_float_4d": "xla", "dense_bool_4d": "xla"}


@pytest.mark.parametrize("form", list(_ROUTES))
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_sdpa_routes_and_values_match_jax(monkeypatch, form, causal):
    monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", "1")
    rng = np.random.RandomState(9)
    S, D = 24, 16
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    mask = _mask_forms(rng, S)[form]
    for stats in (jatt.ROUTE_STATS, tatt.ROUTE_STATS):
        stats.update(pallas=0, xla=0)
    jm = None if mask is None else paddle.to_tensor(mask)
    want = jatt.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), attn_mask=jm,
        is_causal=causal).numpy()
    got = tatt.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=None if mask is None else _t(mask),
        is_causal=causal)
    expect = {"pallas": 0, "xla": 0, _ROUTES[form]: 1}
    assert jatt.ROUTE_STATS == expect and tatt.ROUTE_STATS == expect
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sdpa_route_gates_off_the_card(monkeypatch):
    """Unforced on CPU tensors every call takes the plain route, as the
    JAX package off-TPU; forced, cross-attention shapes still do."""
    rng = np.random.RandomState(2)
    q = _t(rng.randn(B, 128, H, 16).astype(np.float32))
    kx = _t(rng.randn(B, 130, H, 16).astype(np.float32))
    monkeypatch.delenv("PADDLE_TPU_FORCE_FLASH", raising=False)
    assert not tatt._pallas_ok(q, q)
    monkeypatch.setenv("PADDLE_TPU_FORCE_FLASH", "1")
    assert tatt._pallas_ok(q, q) and not tatt._pallas_ok(q, kx)
    assert not tatt._pallas_ok(_t(np.zeros((1, 4, 1, 260), np.float32)))
    tatt.ROUTE_STATS.update(pallas=0, xla=0)
    out = tatt.scaled_dot_product_attention(q, kx, kx)
    assert tatt.ROUTE_STATS == {"pallas": 0, "xla": 1}
    assert out.shape == q.shape


@pytest.mark.parametrize("form", [f for f in _ROUTES if f != "none"])
def test_as_kv_mask_matches_jax(form):
    S = 24
    mask = _mask_forms(np.random.RandomState(1), S)[form]
    want = jatt._as_kv_mask(jnp.asarray(mask), B, S)
    got = tatt._as_kv_mask(_t(mask), B, S)
    if want is None:
        assert got is None
    else:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
