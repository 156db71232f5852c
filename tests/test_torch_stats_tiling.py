"""The walk and tile order of the stats kernel (bodies #3, #3q in
``paddle_tpu_torch/ops/csrc/paged_attention_stats.cu``), emulated on the
CPU and held against the JAX package.

The card cannot run here, so this file shows on the CPU that the kernel's
algorithm computes what ``ragged_paged_attention_stats_xla`` and the
Pallas stats kernel (interpret mode) compute.  The emulation does what
the kernel does, in torch on the CPU:
- a block of rows (the warp form: 1, 4 or 8 rows, Qb < 16; the prefill
  form: 16 rows) compacts its lane's owned table entries below its
  longest row into a list, and walks the compacted positions: position
  i lies in entry list[i / P], slot i % P, at original position
  list[i / P] * P + i % P, against which every visibility test is made;
- it walks them in tiles: the warp form's 32-position tiles dealt round
  robin to four warps, each with its own running state, merged at the
  end; the prefill form's tiles of 64 (32 at D > 64) in order, with one
  running state a row;
- each tile updates the online softmax (running max without NaN, as
  ``fmaxf`` keeps it; alpha; denominator; accumulator);
- a position a row does not see is removed by select: score -inf, p 0,
  and no p.v term;
- int8 pools: ``fused_dequant`` 1 multiplies the K scale into the score
  before the running max and the V scale into p for the p.v term only;
  0 dequantizes K and V as the tile is staged.
Inputs are built with numpy from a seed, as in
``tests/test_torch_stats_attention.py`` (whose two cases are run here
too), and held to that file's 2e-5 (the same exact softmax summed in
another order over at most 96 positions).  The same emulation with
masks by multiplication by zero lets a NaN K scale through to rows that
never see its page (the last test): the kernel's selects are what keep
it out.  The emulation lives here only: no path of the package runs it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_ops.paged_attention import (
    ragged_paged_attention_stats_kernel, ragged_paged_attention_stats_xla)
from paddle_tpu_torch.ops import paged_attention as pa
from test_torch_stats_attention import (TOL, _jnp, _parity_case, _torch,
                                        _wide_case)

NEG_INF = pa.NEG_INF
WARPS, WARP_TILE = 4, 32
OWNERSHIP = ("every-second", "runs", "run-mid-tile", "one-page", "none")


def prefill_tile(D):
    """Compacted positions a tile in the prefill form."""
    return 64 if D <= 64 else 32


def rows_per_block(Qb):
    if Qb >= pa.STATS_PREFILL_ROWS:
        return pa.STATS_PREFILL_ROWS
    return 1 if Qb <= 1 else 4 if Qb <= 4 else 8


def own_walk(pt_g, ok_g, horizon, P):
    """The compacted walk of one block: (original positions, pages,
    slots) of the owned positions below ``horizon``, in table order."""
    n_ent = -(-horizon // P)
    owned = [m for m in range(n_ent) if ok_g[m] != 0]
    if not owned:
        return (np.zeros(0, np.int64),) * 3
    n = (len(owned) - 1) * P + min(P, horizon - owned[-1] * P)
    c = np.arange(n)
    ent = np.asarray(owned)[c // P]
    slot = c % P
    return ent * P + slot, pt_g[ent].astype(np.int64), slot


class State:
    """One running softmax state for R rows and H heads."""

    def __init__(self, R, H, D):
        self.m = torch.full((R, H), NEG_INF)
        self.l = torch.zeros(R, H)
        self.acc = torch.zeros(R, H, D)

    def step(self, qs, kt, vt, pos, rl, ksc, vsc, mask):
        """One tile: qs [R, H, D] pre-scaled, kt / vt [T, H, D] f32,
        pos [T] original positions, rl [R], ksc / vsc [T, H] or None."""
        s = torch.einsum("rhd,thd->rht", qs, kt)
        if ksc is not None:
            s = s * ksc.T[None]
        vis = (pos[None, :] < rl[:, None])[:, None, :]            # [R, 1, T]
        mx = torch.where(vis & ~torch.isnan(s), s,
                         torch.tensor(-np.inf)).amax(-1)
        m_new = torch.fmax(self.m, mx)
        alpha = torch.exp(self.m - m_new)
        if mask == "select":
            p = torch.where(vis, torch.exp(s - m_new[..., None]),
                            torch.zeros(()))
        else:   # arithmetic masks: a bias on the score, p times 0 or 1
            sm = s + torch.where(vis, 0.0, NEG_INF)
            p = torch.exp(sm - m_new[..., None]) * vis
        pv = p * vsc.T[None] if vsc is not None else p
        if mask == "select":
            term = torch.where(vis[..., None],
                               pv[..., None] * vt.permute(1, 0, 2)[None],
                               torch.zeros(())).sum(2)
        else:
            term = torch.einsum("rht,thd->rhd", pv, vt)
        self.l = self.l * alpha + p.sum(-1)
        self.acc = self.acc * alpha[..., None] + term
        self.m = m_new


def emulate(q, kp, vp, pt, rl, ok, ks=None, vs=None, fused=True,
            mask="select"):
    """The stats kernel's arithmetic on numpy inputs -> (o, lse)."""
    G, Qb, H, D = q.shape
    P, M = kp.shape[1], pt.shape[1]
    quant = kp.dtype == np.int8
    scale = 1.0 / np.sqrt(D)
    RB = rows_per_block(Qb)
    prefill = Qb >= pa.STATS_PREFILL_ROWS
    T = prefill_tile(D) if prefill else WARP_TILE
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)) for a in (q, kp,
                                                                  vp))
    o = torch.zeros(G, Qb, H, D)
    lse = torch.full((G, Qb, H), NEG_INF)
    for g in range(G):
        for r0 in range(0, Qb, RB):
            rows = slice(r0, min(r0 + RB, Qb))
            rlb = torch.from_numpy(np.clip(rl[g, rows], 0, M * P).astype(
                np.int64))
            R = rlb.shape[0]
            qs = tq[g, rows] * scale
            pos, page, slot = own_walk(pt[g], ok[g], int(rlb.max()), P)
            states = [State(R, H, D) for _ in range(1 if prefill
                                                      else WARPS)]
            pg, st = torch.from_numpy(page), torch.from_numpy(slot)
            for t, c0 in enumerate(range(0, len(pos), T)):
                sl = slice(c0, c0 + T)
                kt, vt = tk[pg[sl], st[sl]], tv[pg[sl], st[sl]]
                ksc = vsc = None
                if quant:
                    kss = torch.from_numpy(ks[page[sl]])          # [T, H]
                    vss = torch.from_numpy(vs[page[sl]])
                    if fused:
                        ksc, vsc = kss, vss
                    else:
                        kt, vt = kt * kss[..., None], vt * vss[..., None]
                states[t % len(states)].step(
                    qs, kt, vt, torch.from_numpy(pos[sl]), rlb, ksc, vsc,
                    mask)
            # the warp form's merge (one state: the identity)
            mx = states[0].m
            for st in states[1:]:
                mx = torch.fmax(mx, st.m)
            lsum = sum(st.l * torch.exp(st.m - mx) for st in states)
            acc = sum(st.acc * torch.exp(st.m - mx)[..., None]
                      for st in states)
            o[g, rows] = acc / torch.clamp(lsum, min=1e-30)[..., None]
            lse[g, rows] = torch.where(lsum > 0, mx + torch.log(
                torch.clamp(lsum, min=1e-30)), torch.tensor(NEG_INF))
    return o, lse


def ownership(pattern, G, M, none_lane=None):
    m = np.arange(M)
    own = {"every-second": m % 2 == 0,
           "runs": m < (M + 1) // 2,
           "run-mid-tile": (m >= 3) & (m < M - 2),
           "one-page": m == M // 2,
           "none": m < 0}[pattern]
    ok = np.tile(own.astype(np.int32), (G, 1))
    if none_lane is not None:
        ok[none_lane] = 0
    return ok


def tiled_case(rng, quantized, Qb, pattern, D=20):
    """G 4 lanes, H 3, page 4, M 24 (96 positions: several tiles of the
    walk): lane 0 fills its table, lane 1 stops mid-page and owns
    nothing, lane 2 is empty, lane 3 stops one page short; a prefill
    staircase of Qb rows with one padded row in lane 0."""
    G, H, N, P, M = 4, 3, 110, 4, 24
    q = rng.randn(G, Qb, H, D).astype(np.float32)
    if quantized:
        kp = rng.randint(-127, 128, (N, P, H, D)).astype(np.int8)
        vp = rng.randint(-127, 128, (N, P, H, D)).astype(np.int8)
        ks = (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32)
        vs = (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32)
    else:
        kp = rng.randn(N, P, H, D).astype(np.float32)
        vp = rng.randn(N, P, H, D).astype(np.float32)
        ks = vs = None
    pt = rng.permutation(np.arange(1, N))[:G * M].reshape(G, M).astype(
        np.int32)
    lane_lens = [M * P, 61, 0, M * P - 5]
    rl = np.array([[max(n - (Qb - 1 - r), 0) for r in range(Qb)]
                   for n in lane_lens], np.int32)
    rl[0, Qb // 2] = 0
    ok = ownership(pattern, G, M, none_lane=1)
    return q, kp, vp, pt, rl, ok, ks, vs


# (pools, fused_dequant): f32 and the int8 body in both settings
BODIES = [(False, True), (True, True), (True, False)]
BODY_IDS = ["f32", "int8-fused", "int8-unfused"]


def _close(got, want):
    o, lse = got
    np.testing.assert_allclose(o.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("quantized,fused", BODIES, ids=BODY_IDS)
@pytest.mark.parametrize("Qb", [1, 15, 16, 17, 64])
@pytest.mark.parametrize("pattern", OWNERSHIP)
def test_emulation_matches_jax_xla_reference(pattern, Qb, quantized,
                                             fused):
    args = tiled_case(np.random.RandomState(30), quantized, Qb, pattern)
    got = emulate(*args, fused=fused)
    _close(got, ragged_paged_attention_stats_xla(*_jnp(args)))
    # and the port's plain version, which the card tests hold the kernel
    # against
    _close(got, pa.ragged_paged_attention_stats(*_torch(args)))


@pytest.mark.parametrize("quantized,fused", BODIES, ids=BODY_IDS)
@pytest.mark.parametrize("Qb,pattern", [(1, "every-second"), (15, "runs"),
                                        (16, "run-mid-tile"),
                                        (17, "every-second"),
                                        (64, "runs"), (64, "one-page")])
def test_emulation_matches_pallas_kernel_interpret(pattern, Qb, quantized,
                                                   fused):
    args = tiled_case(np.random.RandomState(31), quantized, Qb, pattern)
    want = ragged_paged_attention_stats_kernel(
        *_jnp(args), interpret=True,
        fused_dequant=fused if quantized else None)
    _close(emulate(*args, fused=fused), want)


@pytest.mark.parametrize("quantized,fused", BODIES, ids=BODY_IDS)
@pytest.mark.parametrize("Qb", [17, 64])
def test_emulation_at_wide_heads_takes_32_position_tiles(Qb, quantized,
                                                         fused):
    """D 80: the prefill form's tiles of 32 compacted positions."""
    args = tiled_case(np.random.RandomState(32), quantized, Qb, "runs",
                      D=80)
    _close(emulate(*args, fused=fused),
           ragged_paged_attention_stats_xla(*_jnp(args)))


@pytest.mark.parametrize("quantized,fused", BODIES, ids=BODY_IDS)
@pytest.mark.parametrize("name,make", [("parity", _parity_case),
                                       ("wide", _wide_case)])
def test_emulation_on_the_stats_attention_cases(name, make, quantized,
                                                fused):
    args = make(np.random.RandomState(13), quantized)
    want = ragged_paged_attention_stats_kernel(
        *_jnp(args), interpret=True,
        fused_dequant=fused if quantized else None)
    _close(emulate(*args, fused=fused), want)


@pytest.mark.parametrize("Qb", [1, 64])
def test_walk_follows_owned_positions_not_the_pattern(Qb):
    """Every second page and a run of half the pages walk the same number
    of positions and tiles; a lane owning nothing walks none."""
    P, M = 4, 24
    pt = np.arange(1, M + 1, dtype=np.int32)
    T = prefill_tile(20) if Qb >= pa.STATS_PREFILL_ROWS else WARP_TILE
    walks = {p: own_walk(pt, ownership(p, 1, M)[0], M * P, P)[0]
             for p in OWNERSHIP}
    assert len(walks["every-second"]) == len(walks["runs"]) == M * P // 2
    assert -(-len(walks["every-second"]) // T) == -(-len(walks["runs"])
                                                      // T)
    assert len(walks["one-page"]) == P and len(walks["none"]) == 0
    for pos in walks.values():          # original positions, ascending
        assert (np.diff(pos) > 0).all()
    # a horizon mid-page: the last owned entry is cut at the horizon
    pos = own_walk(pt, ownership("runs", 1, M)[0], 2 * P + 1, P)[0]
    assert pos.tolist() == list(range(2 * P + 1))


def _nan_case(fused):
    """tiled_case at Qb 64 with NaN K scales: in head 1 on lane 0's entry
    18 (positions 72..75, owned), which its rows of at most 72 positions
    never see — rows 33..39 (66..72 positions) walk it all the same, in
    the block of rows 32..47 — and in head 2 on its entry 19 (not
    owned)."""
    args = list(tiled_case(np.random.RandomState(33), True, 64,
                           "every-second"))
    pt, rl, ks = args[3], args[4], args[6].copy()
    ks[pt[0, 18], 1] = np.nan
    ks[pt[0, 19], 2] = np.nan
    args[6] = ks
    readers = np.zeros(rl.shape + (3,), bool)
    readers[0, :, 1] = rl[0] > 72
    return args, readers


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_nan_k_scale_reaches_exactly_its_readers(fused):
    args, readers = _nan_case(fused)
    rl = args[4]
    assert readers.any() and ((rl[0] > 0) & (rl[0] <= 72)).any()
    o, lse = emulate(*args, fused=fused)
    bad = ~torch.isfinite(o).all(-1).numpy()
    np.testing.assert_array_equal(bad, readers)
    want_o, want_lse = ragged_paged_attention_stats_kernel(
        *_jnp(args), interpret=True, fused_dequant=fused)
    want_o = np.asarray(want_o)
    np.testing.assert_array_equal(~np.isfinite(want_o).all(-1), readers)
    fin = ~readers
    np.testing.assert_allclose(o.numpy()[fin], want_o[fin], **TOL)
    np.testing.assert_allclose(lse.numpy()[fin], np.asarray(want_lse)[fin],
                               **TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_masks_by_multiplication_let_the_unseen_nan_through(fused):
    """The same walk with arithmetic masks: the NaN score of a position a
    row does not see turns its p into NaN * 0, so the rows of the NaN
    page's block that stop before it go NaN too."""
    args, readers = _nan_case(fused)
    o, _ = emulate(*args, fused=fused, mask="multiply")
    bad = ~torch.isfinite(o).all(-1).numpy()
    assert bad[readers].all()
    assert not readers[0, 33:40, 1].any() and bad[0, 33:40, 1].all()
