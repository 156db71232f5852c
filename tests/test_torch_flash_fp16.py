"""fp16 flash attention in paddle_tpu_torch against the JAX package's
Pallas kernels in fp16 (interpret mode, called directly as
``tests/test_torch_flash_attention.py`` calls them).

- The port's plain route (``_flash_fwd_bhsd``, ``_flash_dkv_bhsd``,
  ``_flash_dq_bhsd`` on CPU fp16 tensors, what a CPU tensor runs) against
  the Pallas kernels on the same fp16 inputs: both keep P and dS in f32
  and round only their outputs to fp16 (2^-12 relative), so they agree
  within PLAIN_TOL = 2e-3 of max(1, the largest reference value) and
  PLAIN_REL_L2 = 2e-4 in relative L2 (seen: at most 3.7e-4 and 3.2e-5);
  lse within 1e-4 (seen: 4.8e-7).
- The rounding model of the fp16 bodies that run on the tensor cores
  (the bf16 design instanced on fp16 in ``csrc/flash_attention.cu``):
  ``tests/test_torch_flash_tc_numerics.py``'s emulation with P' and dS
  rounded to fp16 instead of bf16, against the Pallas kernels: within
  ``chip_smoke.FLASH_TOL[float16]`` and ``FLASH_REL_L2[float16]``, the
  card's limits for these bodies, with room to spare.
- The kernels' dtype gate: fp16 passes it (a CPU tensor then fails on
  its device, as every dtype does), float64 raises ``TypeError``; fp16
  launches count in ``FLASH_FP16_STATS``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from paddle_tpu.ops.pallas_ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

B, H, S = 2, 2, 128
BK = 64                             # the kernels' key tile at D <= 128
SEED = 4242
PLAIN_TOL, PLAIN_REL_L2, LSE_TOL = 2e-3, 2e-4, 1e-4
TC_TOL = chip_smoke.FLASH_TOL[torch.float16]
TC_REL_L2 = chip_smoke.FLASH_REL_L2[torch.float16]

CASES = [(64, False, 0.0), (64, True, 0.1), (80, False, 0.1),
         (80, True, 0.0)]


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def _f16(x):
    return x.to(torch.float16).float()


@pytest.fixture(scope="module")
def pallas():
    """Each case's fp16 inputs and Pallas outputs, computed once."""
    out = {}
    for D, causal, p in CASES:
        rng = np.random.RandomState(D + 7 * causal)
        q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32)
                      for _ in range(4))
        mask = np.ones((B, 1, S), np.float32)
        if p:
            mask[1, 0, S - S // 3:] = 0.0
        scale = 1.0 / np.sqrt(D)
        jq, jk, jv, jg = (jnp.asarray(a, jnp.float16) for a in (q, k, v, g))
        seed = jnp.asarray([SEED], jnp.int32)
        o, lse = jfa._flash_fwd_bhsd(jq, jk, jv, jnp.asarray(mask), seed,
                                     scale, causal, p, 64, 64)
        delta = jnp.sum(jg.astype(jnp.float32) * o.astype(jnp.float32),
                        axis=-1).reshape(B * H, S, 1)
        bwd = (jq, jk, jv, jg, lse, delta, jnp.asarray(mask), seed, scale,
               causal, p, 64, 64)
        dk, dv = jfa._flash_dkv_bhsd(*bwd)
        dq = jfa._flash_dq_bhsd(*bwd)
        assert o.dtype == dk.dtype == dv.dtype == dq.dtype == jnp.float16
        out[(D, causal, p)] = dict(
            inputs=tuple(torch.from_numpy(np.array(a)) for a in
                         (jq, jk, jv, jg)),
            mask=torch.from_numpy(mask), scale=scale, lse=_t(lse),
            delta=_t(delta), o=_t(o), dk=_t(dk), dv=_t(dv), dq=_t(dq))
    return out


def _close(got, want, tol, rel_l2, what):
    err = float((got.float() - want).abs().max())
    limit = tol * max(1.0, float(want.abs().max()))
    assert err <= limit, f"{what}: max_abs_err {err} > {limit}"
    if rel_l2 is not None:
        rel = chip_smoke.flash_rel_l2(got, want)
        assert rel <= rel_l2, f"{what}: relative L2 {rel} > {rel_l2}"
    return err


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"D{c[0]}-c{int(c[1])}"
                         f"-p{c[2]}")
def test_plain_route_in_fp16_matches_pallas(pallas, case):
    run = pallas[case]
    _, causal, p = case
    q, k, v, g = run["inputs"]
    common = (run["mask"], SEED, run["scale"], causal, p)
    tfa.FLASH_ROUTE_STATS.update(fwd=0, dkv=0, dq=0, ref=0)
    o, lse = tfa._flash_fwd_bhsd(q, k, v, *common)
    bwd = (run["lse"], run["delta"]) + common
    dk, dv = tfa._flash_dkv_bhsd(q, k, v, g, *bwd)
    dq = tfa._flash_dq_bhsd(q, k, v, g, *bwd)
    assert tfa.FLASH_ROUTE_STATS == {"fwd": 0, "dkv": 0, "dq": 0, "ref": 3}
    assert o.dtype == dk.dtype == dv.dtype == dq.dtype == torch.float16
    for name, got in (("o", o), ("dk", dk), ("dv", dv), ("dq", dq)):
        _close(got, run[name], PLAIN_TOL, PLAIN_REL_L2, name)
    _close(lse, run["lse"], LSE_TOL, None, "lse")


# --- the tensor-core bodies' rounding, in fp16 -------------------------------
def _scores(q, k, mask, scale, causal):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    rows = torch.arange(q.shape[2])[:, None]
    cols = torch.arange(k.shape[2])[None, :]
    if causal:
        s = torch.where(rows >= cols, s, torch.full_like(s, tfa.NEG_INF))
    valid = mask.reshape(q.shape[0], 1, 1, -1) > 0
    s = torch.where(valid, s, torch.full_like(s, tfa.NEG_INF))
    return s, rows, cols


def _keep(q, rows, cols, p):
    bh = torch.arange(q.shape[0] * q.shape[1]).reshape(q.shape[0],
                                                       q.shape[1], 1, 1)
    return tfa._keep_mask(SEED, bh, rows, cols, p)


def tc_forward(q, k, v, mask, scale, causal, p):
    """The forward body: online softmax over key tiles, P' rounded to
    fp16 before P'V, o rounded to fp16."""
    s, rows, cols = _scores(q, k, mask, scale, causal)
    keep = _keep(q, rows, cols, p) if p > 0 else None
    m = torch.full(s.shape[:-1] + (1,), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for k0 in range(0, s.shape[-1], BK):
        st = s[..., k0:k0 + BK]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(st - m_new)
        l = l * alpha + pr.sum(-1, keepdim=True)
        if keep is not None:
            pr = torch.where(keep[..., k0:k0 + BK], pr / (1.0 - p),
                             torch.zeros_like(pr))
        acc = acc * alpha + torch.matmul(_f16(pr), v[..., k0:k0 + BK, :])
        m = m_new
    return _f16(acc / torch.clamp(l, min=1e-30))


def tc_backward(q, k, v, g, lse, delta, mask, scale, causal, p):
    """dK/dV and dQ: P' and dS rounded to fp16 before their products,
    the outputs rounded to fp16."""
    s, rows, cols = _scores(q, k, mask, scale, causal)
    pr = torch.exp(s - lse.reshape(s.shape[:3] + (1,)))
    dp = torch.matmul(g, v.transpose(-1, -2))
    p_v = pr
    if p > 0:
        keep = _keep(q, rows, cols, p)
        p_v = torch.where(keep, pr / (1.0 - p), torch.zeros_like(pr))
        dp = torch.where(keep, dp / (1.0 - p), torch.zeros_like(dp))
    ds = _f16(pr * (dp - delta.reshape(s.shape[:3] + (1,))))
    dv = torch.matmul(_f16(p_v).transpose(-1, -2), g)
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dq = torch.matmul(ds, k) * scale
    return _f16(dk), _f16(dv), _f16(dq)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"D{c[0]}-c{int(c[1])}"
                         f"-p{c[2]}")
def test_tc_fp16_rounding_fits_the_card_tolerance(pallas, case):
    run = pallas[case]
    _, causal, p = case
    q, k, v, g = (x.float() for x in run["inputs"])
    o = tc_forward(q, k, v, run["mask"], run["scale"], causal, p)
    dk, dv, dq = tc_backward(q, k, v, g, run["lse"], run["delta"],
                             run["mask"], run["scale"], causal, p)
    errs = {name: _close(got, run[name], TC_TOL, TC_REL_L2, name)
            for name, got in (("o", o), ("dk", dk), ("dv", dv), ("dq", dq))}
    # rounding P and dS to fp16 is real, and far inside the card's limit
    assert all(0 < e <= TC_TOL / 4 * max(1.0, float(run[n].abs().max()))
               for n, e in errs.items()), errs


def test_dtype_gate_admits_fp16():
    q = torch.zeros(1, 1, 8, 16, dtype=torch.float16)
    mask = torch.ones(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, q, q, mask, 0, 0.25, False, 0.0)
    with pytest.raises(TypeError, match="float16"):
        tfa.flash_fwd_cuda(q.double(), q.double(), q.double(), mask, 0,
                           0.25, False, 0.0)
    assert tfa._DTYPES[torch.float16] == "f16"
    assert tfa._DTYPE_STATS[torch.float16] is tfa.FLASH_FP16_STATS
    assert set(tfa.FLASH_FP16_STATS) == {"fwd", "dkv", "dq"}
