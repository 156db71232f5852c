"""The rounding model of the bf16 flash bodies that run on the tensor cores
(forward and dK/dV in ``paddle_tpu_torch/ops/csrc/flash_attention.cu``),
emulated on the CPU and held against the JAX package's Pallas kernels.

The card cannot run here, so this file shows on the CPU that the design
fits the card tests' bf16 tolerance.  The emulation does what the kernels
do, in torch on the CPU:
- S from the bf16 q and k with f32 sums, then times scale in f32;
- forward: the online softmax over key tiles of 64, P' (dropped) rounded
  to bf16 before P'V, the denominator from the unrounded P, o rounded to
  bf16, lse = m + log(max(l, 1e-30));
- dK/dV: P = exp(S - lse), dP = dO V^T with f32 sums, P' and
  dS = P (dP' - delta) rounded to bf16 before dV = P'^T dO and
  dK = dS^T q, dK times scale, both rounded to bf16.
The Pallas kernels (``_flash_fwd_bhsd``, ``_flash_dkv_bhsd``, interpret
mode, called directly as ``tests/test_torch_flash_attention.py`` calls
them) read the same bf16 inputs and keep P and dS in f32.  The limit is
``tests/test_torch_cuda.py``'s for bf16: 2e-2 times max(1, the largest
reference value), and each whole output within ``chip_smoke``'s
``FLASH_REL_L2`` (1e-2) in relative L2 norm.  Rounding P and dS costs
2^-9 relative per term, and the sums over 128 positions average it out,
so the emulation lands well inside both (at most 7.3e-3 of the largest
reference value, and at most 2.8e-3 in relative L2, in these cases); lse is
computed before any rounding and is held to the card tests' 1e-4.  A
body that drops a key tile from the long causal rows fails the relative
L2 limit by far (the last test).  The emulation lives here only: no
path of the package runs it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from paddle_tpu.ops.pallas_ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

B, H, S = 2, 2, 128
BK = 64                            # the kernels' key tile at D <= 128
SEED = 4242
BF16_TOL, LSE_TOL = 2e-2, 1e-4
REL_L2 = chip_smoke.FLASH_REL_L2[torch.bfloat16]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _scores(q, k, mask, scale, causal):
    """f32 sums of the bf16 products, times scale, masked to -1e30."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    rows = torch.arange(q.shape[2])[:, None]
    cols = torch.arange(k.shape[2])[None, :]
    if causal:
        s = torch.where(rows >= cols, s, torch.full_like(s, tfa.NEG_INF))
    valid = mask.reshape(q.shape[0], 1, 1, -1) > 0
    s = torch.where(valid, s, torch.full_like(s, tfa.NEG_INF))
    return s, rows, cols


def _keep(q, rows, cols, p):
    b, h = q.shape[:2]
    bh = torch.arange(b * h).reshape(b, h, 1, 1)
    return tfa._keep_mask(SEED, bh, rows, cols, p)


def tc_forward(q, k, v, mask, scale, causal, p):
    """The tensor-core forward's arithmetic: (o in bf16, lse f32)."""
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
        acc = acc * alpha + torch.matmul(_bf16(pr), v[..., k0:k0 + BK, :])
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    return _bf16(acc / l_safe), (m + torch.log(l_safe)).reshape(-1, s.shape[2], 1)


def tc_dkv(q, k, v, g, lse, delta, mask, scale, causal, p):
    """The tensor-core dK/dV's arithmetic: (dk, dv) in bf16."""
    s, rows, cols = _scores(q, k, mask, scale, causal)
    pr = torch.exp(s - lse.reshape(s.shape[:3] + (1,)))
    dp = torch.matmul(g, v.transpose(-1, -2))
    p_v = pr
    if p > 0:
        keep = _keep(q, rows, cols, p)
        p_v = torch.where(keep, pr / (1.0 - p), torch.zeros_like(pr))
        dp = torch.where(keep, dp / (1.0 - p), torch.zeros_like(dp))
    ds = pr * (dp - delta.reshape(s.shape[:3] + (1,)))
    dv = torch.matmul(_bf16(p_v).transpose(-1, -2), g)
    dk = torch.matmul(_bf16(ds).transpose(-1, -2), q) * scale
    return _bf16(dk), _bf16(dv)


def _close(got, want, tol, what):
    want = want.float()
    err = float((got.float() - want).abs().max())
    limit = tol * max(1.0, float(want.abs().max()))
    assert err <= limit, f"{what}: max_abs_err {err} > {limit}"
    return err


@pytest.mark.parametrize("variant", ["plain", "mask_dropout"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [64, 80])
def test_tc_rounding_fits_the_bf16_tolerance(D, causal, variant):
    rng = np.random.RandomState(D + 7 * causal)
    q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = np.ones((B, 1, S), np.float32)
    p = 0.0
    if variant == "mask_dropout":
        mask[1, 0, S - S // 3:] = 0.0
        p = 0.1
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    seed = jnp.asarray([SEED], jnp.int32)
    o, lse = jfa._flash_fwd_bhsd(jq, jk, jv, jnp.asarray(mask), seed, scale,
                                 causal, p, 64, 64)
    delta = jnp.sum(jg.astype(jnp.float32) * o.astype(jnp.float32),
                    axis=-1).reshape(B * H, S, 1)
    dk, dv = jfa._flash_dkv_bhsd(jq, jk, jv, jg, lse, delta,
                                 jnp.asarray(mask), seed, scale, causal, p,
                                 64, 64)
    assert o.dtype == dk.dtype == dv.dtype == jnp.bfloat16

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))

    tq, tk, tv, tg = (t(a) for a in (jq, jk, jv, jg))
    tmask = torch.from_numpy(mask)
    e_o, e_lse = tc_forward(tq, tk, tv, tmask, scale, causal, p)
    e_dk, e_dv = tc_dkv(tq, tk, tv, tg, t(lse), t(delta), tmask, scale,
                        causal, p)
    errs = {name: _close(got, t(want), BF16_TOL, name) for name, got, want in
            (("o", e_o, o), ("dk", e_dk, dk), ("dv", e_dv, dv))}
    for name, got, want in (("o", e_o, o), ("dk", e_dk, dk), ("dv", e_dv, dv)):
        rel = chip_smoke.flash_rel_l2(got, t(want))
        assert 0 < rel <= REL_L2 / 2, f"{name}: relative L2 {rel}"
    _close(e_lse, t(lse), LSE_TOL, "lse")
    # the rounding of P and dS is real, and well inside the limit
    assert all(0 < e <= BF16_TOL / 2 * max(1.0, float(t(w).abs().max()))
               for e, w in ((errs["o"], o), (errs["dk"], dk),
                            (errs["dv"], dv)))


def test_tc_emulation_rounds_where_the_plain_version_does_not():
    """P and dS rounded to bf16 move the outputs off the plain version's
    f32 result (before the outputs' own rounding): the emulation is not
    the plain version in disguise."""
    rng = np.random.RandomState(1)
    q, k, v = (_bf16(torch.from_numpy(rng.randn(B, H, S, 64).astype(
        np.float32))) for _ in range(3))
    mask = torch.ones(B, S)
    scale = 0.125
    ref_o, ref_lse = tfa.flash_fwd_ref(q, k, v, mask, SEED, scale, True, 0.0)
    e_o, e_lse = tc_forward(q, k, v, mask, scale, True, 0.0)
    torch.testing.assert_close(e_lse, ref_lse, rtol=0, atol=1e-5)
    assert not torch.equal(e_o, _bf16(ref_o))
    _close(e_o, ref_o, BF16_TOL, "o")


def test_rel_l2_limit_fails_a_dropped_key_tile():
    """The emulated forward with the key tile [64, 128) dropped from the
    rows past 300 (what a wrong tile loop on long rows would do) at S
    1024: the relative L2 check fails it by more than ten times its
    limit (0.18 here), where the correct emulation stays under half."""
    rng = np.random.RandomState(2)
    n, long_rows = 1024, 300
    q, k, v = (_bf16(torch.from_numpy(rng.randn(1, 1, n, 64).astype(
        np.float32))) for _ in range(3))
    mask = torch.ones(1, n)
    ref_o, _ = tfa.flash_fwd_ref(q, k, v, mask, SEED, 0.125, True, 0.0)
    good, _ = tc_forward(q, k, v, mask, 0.125, True, 0.0)
    holed = mask.clone()
    holed[:, BK:2 * BK] = 0.0
    bad, _ = tc_forward(q, k, v, holed, 0.125, True, 0.0)
    bad[..., :long_rows, :] = good[..., :long_rows, :]
    assert chip_smoke.flash_rel_l2(good, ref_o) <= REL_L2 / 2
    assert chip_smoke.flash_rel_l2(bad, ref_o) > 10 * REL_L2
