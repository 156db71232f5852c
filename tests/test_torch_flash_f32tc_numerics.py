"""The arithmetic of the f32 flash bodies that run on the tensor cores in
3xTF32 (the forward, dK/dV and dQ in ``paddle_tpu_torch/ops/csrc/
flash_attention.cu``, namespace ``f32tc``), emulated on the CPU and held
against the JAX package's Pallas kernels.

The card cannot run here, so this file shows on the CPU that the design
fits the f32 limits of the card tests.  The emulation does what the
kernels do, in torch on the CPU:
- every operand of a product is split where its fragment is formed:
  big = x rounded to TF32 (10 mantissa bits, to nearest with ties away
  from zero, by an int32 view, as the kernels round with integer
  arithmetic on the bit pattern, which is what ``cvt.rna.tf32.f32``
  does) and small = x - big, which is exact in f32 and of which the
  tensor core reads the top 11 significant bits (truncated here);
- each product runs over k in chunks of 8 in the kernels' order (the
  chunks of one tile in order, the tiles in order; tiles a causal block
  skips would add exact zeros), three TF32 products a chunk: small * big,
  big * small, big * big.  One such step is modelled as the exact sum of
  the accumulator and the chunk's products, rounded toward zero to f32:
  the tensor cores' f32 accumulation is not rounded to nearest, and
  truncation is the pessimistic model.  As in the kernels, the steps of a
  tile go into a partial sum from zero that an f32 add folds into the
  total (S and dP every 64 columns of d; dV, dK and dQ every tile of 32
  queries or keys);
- dK/dV: S = (K Q^T) scale, P = exp(S - lse), dP = V dO^T, P' and
  dS = P (dP' - delta) in f32, dV = P'^T dO, dK = (dS^T Q) scale;
- dQ: S and dP the same way, dQ = (dS K) scale;
- forward: S = (Q K^T) scale the same way, then per tile of 32 keys the
  online softmax (running max m, alpha = exp(m_old - m_new), the
  denominator l = l alpha + the tile's row sums of P, the full mass),
  P' = P dropped, P' split unrounded into big and small, the tile's P'V
  chunks into a partial sum from zero and O = O alpha + partial in f32;
  o = O / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
The Pallas kernels (``_flash_fwd_bhsd``, ``_flash_dkv_bhsd``,
``_flash_dq_bhsd``, interpret mode, called directly as
``tests/test_torch_flash_attention.py`` calls them) compute in f32
throughout.

Tolerances.  The card tests' f32 limit: 1e-4 times max(1, the largest
reference value) (``chip_smoke.FLASH_TOL``), and each whole output within
``chip_smoke.FLASH_REL_L2[float32]`` (2e-4) of its reference in relative
L2 norm.  3xTF32 drops the small * small term and the residuals' bits
past 11, about 2^-21 of a product (the unit test below), and the
truncating accumulation adds about an f32 ulp of a partial sum a step;
here that lands at most at 1.9e-6 in relative L2 (a fiftieth of the
limit is asserted; the forward's o lands at most at 8.9e-7 and its lse
within 1.7e-6 absolute, where 1e-4 is asserted).  A one-pass TF32
product (big * big only) keeps 11 bits and lands at 4.1e-4 to 5.9e-4
(the forward's o at 3.7e-4), beyond the limit: the limit tells 3xTF32
from TF32.  The limit leaves room for the card tests' single-key
cases, whose exact dK and dQ are 0, so that their rounding noise is
measured against the rms floor ``chip_smoke.FLASH_REL_L2_FLOOR`` (the
emulation puts them at up to 4.8e-5 at D 256, the card at up to 8.2e-5;
PERF.md).  The emulation lives here only: no path of the package
runs it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from paddle_tpu.ops.pallas_ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

B, H, S = 2, 2, 128
SEED = 4242
# chunks of 8 a partial sum: S and dP every 64 columns of d; dV, dK and dQ
# every tile of 32 queries (dK/dV) or keys (dQ), the kernels' tiles below
# D 256
FOLD_D, FOLD_TILE = 8, 4
# keys a tile of the forward (32 below D 256): one online-softmax step
# and one P'V partial sum each
FWD_TILE = 32
F32_TOL = chip_smoke.FLASH_TOL[torch.float32]
REL_L2 = chip_smoke.FLASH_REL_L2[torch.float32]
# lse against the Pallas forward's, absolute (the card tests' limit)
LSE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch work on one thread.  Its emulations are
    long runs of small tensor ops; with the suite's workers sharing the
    CPU, an OpenMP team per worker oversubscribes it and each op pays
    for the team's rendezvous (two orders of magnitude here).  The
    cases, their inputs and their limits are unchanged."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tf32_rna(x):
    """x rounded to TF32: to nearest, ties away from zero (the bit
    pattern plus half a TF32 ulp, the low 13 bits cleared)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """The top 11 significant bits of x, as the tensor core reads an f32
    register that holds more."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_trunc(x - big)


def _step(acc, a, b):
    """One mma into an f32 accumulator: the exact sum, rounded toward
    zero."""
    exact = acc.double() + a.double() @ b.double()
    r = exact.float()
    return torch.where(r.double().abs() > exact.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def mm(a, b, fold, passes=3):
    """a @ b over k in chunks of 8: three TF32 products a chunk (small *
    big, big * small, big * big), or one (big * big) for passes=1, into a
    partial sum that starts at zero every ``fold`` chunks and is added to
    the total in f32, as the kernels fold a tile's chunks."""
    total = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    for c0 in range(0, a.shape[-1], 8 * fold):
        acc = torch.zeros_like(total)
        for k0 in range(c0, min(c0 + 8 * fold, a.shape[-1]), 8):
            ab, as_ = split(a[..., k0:k0 + 8].contiguous())
            bb, bs = split(b[..., k0:k0 + 8, :].contiguous())
            terms = ((as_, bb), (ab, bs), (ab, bb)) if passes == 3 else (
                (ab, bb),)
            for x, y in terms:
                acc = _step(acc, x, y)
        total = acc if c0 == 0 else total + acc
    return total


def _masked_scores(q, k, mask, scale, causal, passes):
    """S = (Q K^T) scale as the bodies form it, masked to NEG_INF; and the
    global (row, col) index grids."""
    s = mm(q, k.transpose(-1, -2), FOLD_D, passes) * scale
    rows = torch.arange(q.shape[2])[:, None]
    cols = torch.arange(k.shape[2])[None, :]
    if causal:
        s = torch.where(rows >= cols, s, torch.full_like(s, tfa.NEG_INF))
    valid = mask.reshape(q.shape[0], 1, 1, -1) > 0
    s = torch.where(valid, s, torch.full_like(s, tfa.NEG_INF))
    return s, rows, cols


def _keep(q, rows, cols, p):
    bh = torch.arange(q.shape[0] * q.shape[1]).reshape(
        q.shape[0], q.shape[1], 1, 1)
    return tfa._keep_mask(SEED, bh, rows, cols, p)


def f32tc_fwd(q, k, v, mask, scale, causal, p, passes=3):
    """The 3xTF32 forward's arithmetic: (o, lse [B·H, Sq, 1]) in f32.
    Tiles a causal block skips would leave m, l and O as they are (their
    scores are NEG_INF, their P exactly 0), so every tile runs here."""
    s, rows, cols = _masked_scores(q, k, mask, scale, causal, passes)
    keep = _keep(q, rows, cols, p) if p > 0 else None
    inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
    m = torch.full(s.shape[:3] + (1,), tfa.NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[:3] + (v.shape[-1],))
    for k0 in range(0, k.shape[2], FWD_TILE):
        st = s[..., k0:k0 + FWD_TILE]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(st - m_new)
        l = l * alpha + pr.sum(dim=-1, keepdim=True)
        if keep is not None:
            pr = torch.where(keep[..., k0:k0 + FWD_TILE], pr * inv,
                             torch.zeros_like(pr))
        part = mm(pr, v[..., k0:k0 + FWD_TILE, :].contiguous(),
                  FWD_TILE // 8, passes)
        o = o * alpha + part
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    lse = (m + torch.log(l_safe)).reshape(q.shape[0] * q.shape[1], -1, 1)
    return o / l_safe, lse


def _probs_and_ds(q, k, v, g, lse, delta, mask, scale, causal, p, passes):
    """P', dS = P (dP' - delta), from S and dP as the bodies form them."""
    s, rows, cols = _masked_scores(q, k, mask, scale, causal, passes)
    pr = torch.exp(s - lse.reshape(s.shape[:3] + (1,)))
    dp = mm(g, v.transpose(-1, -2), FOLD_D, passes)
    p_v = pr
    if p > 0:
        keep = _keep(q, rows, cols, p)
        inv = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32)
        p_v = torch.where(keep, pr * inv, torch.zeros_like(pr))
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
    ds = pr * (dp - delta.reshape(s.shape[:3] + (1,)))
    return p_v, ds


def f32tc_dkv(q, k, v, g, lse, delta, mask, scale, causal, p, passes=3):
    """The 3xTF32 dK/dV's arithmetic: (dk, dv) in f32."""
    p_v, ds = _probs_and_ds(q, k, v, g, lse, delta, mask, scale, causal, p,
                            passes)
    dv = mm(p_v.transpose(-1, -2).contiguous(), g, FOLD_TILE, passes)
    dk = mm(ds.transpose(-1, -2).contiguous(), q, FOLD_TILE, passes) * scale
    return dk, dv


def f32tc_dq(q, k, v, g, lse, delta, mask, scale, causal, p, passes=3):
    """The 3xTF32 dQ's arithmetic: dq in f32."""
    _, ds = _probs_and_ds(q, k, v, g, lse, delta, mask, scale, causal, p,
                          passes)
    return mm(ds, k, FOLD_TILE, passes) * scale


def _pallas_case(D, causal, variant, seed):
    """Seeded f32 inputs and the Pallas kernels' o and lse, and dk, dv and
    dq (with the Pallas forward's lse and delta), all as CPU tensors."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = np.ones((B, 1, S), np.float32)
    p = 0.0
    if variant == "mask_dropout":
        mask[1, 0, S - S // 3:] = 0.0
        p = 0.1
    scale = 1.0 / np.sqrt(D)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jseed = jnp.asarray([SEED], jnp.int32)
    jmask = jnp.asarray(mask)
    o, lse = jfa._flash_fwd_bhsd(jq, jk, jv, jmask, jseed, scale, causal, p,
                                 64, 64)
    delta = jnp.sum(jg * o, axis=-1).reshape(B * H, S, 1)
    dk, dv = jfa._flash_dkv_bhsd(jq, jk, jv, jg, lse, delta, jmask, jseed,
                                 scale, causal, p, 64, 64)
    dq = jfa._flash_dq_bhsd(jq, jk, jv, jg, lse, delta, jmask, jseed, scale,
                            causal, p, 64, 64)
    assert dk.dtype == dv.dtype == dq.dtype == jnp.float32

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    inputs = (t(q), t(k), t(v), t(g), t(lse), t(delta), t(mask), scale,
              causal, p)
    return inputs, {"dk": t(dk), "dv": t(dv), "dq": t(dq), "o": t(o),
                    "lse": t(lse)}


def _emulate(inputs, passes=3):
    dk, dv = f32tc_dkv(*inputs, passes=passes)
    return {"dk": dk, "dv": dv, "dq": f32tc_dq(*inputs, passes=passes)}


def _max_err(got, want):
    """max |got - want| over the card tests' limit scale max(1, max
    |want|)."""
    return float((got - want).abs().max()) / max(1.0,
                                                float(want.abs().max()))


@pytest.mark.parametrize("variant", ["plain", "mask_dropout"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [64, 100])
def test_3xtf32_fits_the_f32_limits(D, causal, variant):
    """dK, dV and dQ in 3xTF32 within the card tests' f32 max-abs limit
    and a fiftieth of the f32 relative L2 limit of the Pallas kernels,
    and off them (the rounding is real)."""
    inputs, want = _pallas_case(D, causal, variant, 5 * D + causal)
    got = _emulate(inputs)
    for name in ("dk", "dv", "dq"):
        err = _max_err(got[name], want[name])
        rel = chip_smoke.flash_rel_l2(got[name], want[name])
        assert err <= F32_TOL, f"{name}: max_abs_err {err} of the scale"
        assert 0 < rel <= REL_L2 / 50, f"{name}: relative L2 {rel}"


def _fwd_inputs(inputs):
    """The forward's arguments out of a backward case's."""
    q, k, v, _, _, _, mask, scale, causal, p = inputs
    return q, k, v, mask, scale, causal, p


@pytest.mark.parametrize("variant", ["plain", "mask_dropout"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [64, 100])
def test_3xtf32_forward_fits_the_f32_limits(D, causal, variant):
    """o in 3xTF32 within the card tests' f32 max-abs limit and a fiftieth
    of the f32 relative L2 limit of the Pallas forward, and off it (the
    rounding is real); lse within LSE_TOL."""
    inputs, want = _pallas_case(D, causal, variant, 5 * D + causal)
    o, lse = f32tc_fwd(*_fwd_inputs(inputs))
    err = _max_err(o, want["o"])
    rel = chip_smoke.flash_rel_l2(o, want["o"])
    assert err <= F32_TOL, f"o: max_abs_err {err} of the scale"
    assert 0 < rel <= REL_L2 / 50, f"o: relative L2 {rel}"
    lse_err = float((lse - want["lse"]).abs().max())
    assert lse_err <= LSE_TOL, f"lse: max_abs_err {lse_err}"


def test_one_pass_tf32_forward_fails_the_f32_l2_limit():
    """The forward with one TF32 product a chunk (big * big) misses the
    f32 relative L2 limit on o: the limit has teeth for it too."""
    inputs, want = _pallas_case(64, True, "mask_dropout", 11)
    three, _ = f32tc_fwd(*_fwd_inputs(inputs))
    one, _ = f32tc_fwd(*_fwd_inputs(inputs), passes=1)
    assert chip_smoke.flash_rel_l2(three, want["o"]) <= REL_L2
    rel = chip_smoke.flash_rel_l2(one, want["o"])
    assert rel > REL_L2, f"o: one-pass TF32 at relative L2 {rel}"


def test_one_pass_tf32_fails_the_f32_l2_limit():
    """The same bodies with one TF32 product a chunk (big * big) miss the
    f32 relative L2 limit on every output: the limit has teeth."""
    inputs, want = _pallas_case(64, True, "mask_dropout", 11)
    three = _emulate(inputs)
    one = _emulate(inputs, passes=1)
    for name in ("dk", "dv", "dq"):
        assert chip_smoke.flash_rel_l2(three[name], want[name]) <= REL_L2
        rel = chip_smoke.flash_rel_l2(one[name], want[name])
        assert rel > REL_L2, f"{name}: one-pass TF32 at relative L2 {rel}"


def test_split_reproduces_f32_products():
    """big * big + big * small + small * big against the exact product of
    two f32 values over 24 binades: within 2.5 * 2^-21 relative at worst
    (2^-22 for small * small, 2^-21 for each residual's truncation) and
    2^-22 in rms, where one TF32 product is 2^-11 off at worst; big +
    small is x exactly before the truncation."""
    rng = np.random.RandomState(0)
    n = 200_000
    a, b = (torch.from_numpy((rng.randn(n) * 2.0 ** rng.randint(
        -12, 12, n)).astype(np.float32)) for _ in range(2))
    ab, as_ = split(a)
    bb, bs = split(b)
    assert torch.equal(ab + (a - ab), a)
    exact = a.double() * b.double()
    three = (ab.double() * bb.double() + ab.double() * bs.double()
             + as_.double() * bb.double())
    one = ab.double() * bb.double()
    rel3 = ((three - exact) / exact).abs()
    rel1 = ((one - exact) / exact).abs()
    assert float(rel3.max()) <= 2.5 * 2.0 ** -21
    assert float(rel3.pow(2).mean().sqrt()) <= 2.0 ** -22
    assert 2.0 ** -13 <= float(rel1.max()) <= 2.0 ** -10
