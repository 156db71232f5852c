"""The two forms of the paged-attention kernels (bodies #1, #1q of
``paddle_tpu_torch/ops/csrc/paged_attention.cu`` and #2, #2q of
``paged_decode.cu``), emulated on the CPU and held against the JAX
package.

The card cannot run here, so this file shows on the CPU that the kernels'
algorithms compute what ``ragged_paged_attention_xla`` /
``paged_attention_xla`` and the Pallas kernels (interpret mode) compute.
The emulation does what the kernels do, in torch on the CPU:
- the decode form (a lane of fewer than 16 rows; #2 is it at one row a
  lane): a CTA takes 1, 4 or 8 rows of a lane and walks the lane's
  positions below its longest row in 32-position tiles; tile t goes to
  worker t mod (CS * W), rank worker // W of the lane's cluster of CS
  CTAs and warp worker % W of that CTA, each worker with its own running
  state; each CTA merges its warps' states in warp order, then rank 0
  merges the states of the CTAs that had a tile (the first
  ceil(tiles / W)) in rank order.  The emulation takes any (CS, W); the
  kernel library picks them (``ptt_paged_decode_layout``, which a card
  test pins), and a row's arithmetic does not depend on the rows a CTA
  takes (1, 4 or 8);
- the prefill form without the ownership list (16 rows or more): blocks
  of 16 rows walk the lane's table below their longest row in tiles of
  64 positions (32 at D > 64), in order, one running state a row;
- each tile updates the online softmax (running max without NaN, as
  ``fmaxf`` keeps it; alpha; denominator; accumulator); a position a row
  does not see is removed by select: score -inf, p 0, no p.v term;
- int8 pools: ``fused_dequant`` 1 multiplies the K scale into the score
  before the running max and the V scale into p for the p.v term only;
  0 dequantizes K and V before the dots.
Inputs are built with numpy from a seed and held to 2e-5, as in
``tests/test_torch_stats_tiling.py`` (the same exact softmax summed in
another order over at most 1024 positions).  The emulation lives here
only: no path of the package runs it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_ops.paged_attention import (
    paged_attention_kernel, paged_attention_xla, ragged_paged_attention_kernel,
    ragged_paged_attention_xla)
from paddle_tpu_torch.ops import paged_attention as pa
from test_torch_stats_tiling import State

TOL = dict(rtol=2e-5, atol=2e-5)
NEG_INF = pa.NEG_INF
PREFILL_ROWS = pa.STATS_PREFILL_ROWS
DECODE_TILE = 32
# (CTAs a lane's cluster, warps a CTA): what the card runs for bf16 and
# int8 pools at a 1024-position table
DECODE_LAYOUT = (4, 4)
DECODE_ROWS = 8             # rows a CTA of a spec-verify lane


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


def deal(n_tiles, CS, W):
    """The decode form's split of a lane's tiles: tile t's worker
    (rank * W + warp), and the ranks that have a tile (rank 0 always)."""
    workers = [t % (CS * W) for t in range(n_tiles)]
    return workers, max(1, min(CS, -(-n_tiles // W)))


def prefill_tile(D):
    return 64 if D <= 64 else 32


def _merge(states):
    """States merged as the kernel merges them: the running max over the
    states (NaN-free), then the denominators and accumulators rescaled
    and summed in order -> (m, l, acc)."""
    mx = torch.full_like(states[0].m, NEG_INF)
    for st in states:
        mx = torch.fmax(mx, st.m)
    l = sum(st.l * torch.exp(st.m - mx) for st in states)
    acc = sum(st.acc * torch.exp(st.m - mx)[..., None] for st in states)
    merged = State(*states[0].acc.shape)
    merged.m, merged.l, merged.acc = mx, l, acc
    return merged


def _tile(tk, tv, pt_g, pos, P, quant, ks, vs, fused):
    """K / V of the positions ``pos`` of one lane (f32), and the scales
    the score and p take (None unless int8 with fused_dequant 1)."""
    page = torch.from_numpy(pt_g[pos // P].astype(np.int64))
    slot = torch.from_numpy(pos % P)
    kt, vt = tk[page, slot], tv[page, slot]
    if not quant:
        return kt, vt, None, None
    kss = torch.from_numpy(ks)[page]                          # [T, H]
    vss = torch.from_numpy(vs)[page]
    if fused:
        return kt, vt, kss, vss
    return kt * kss[..., None], vt * vss[..., None], None, None


def emulate(q, kp, vp, pt, rl, ks=None, vs=None, fused=True,
            layout=DECODE_LAYOUT):
    """#1 / #1q's arithmetic on numpy inputs: the decode form below 16
    rows a lane (a cluster of ``layout`` = (CS, W)), the prefill form from
    16 -> o [G, Qb, H, D]."""
    G, Qb, H, D = q.shape
    P, M = kp.shape[1], pt.shape[1]
    quant = kp.dtype == np.int8
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)) for a in (q, kp,
                                                                  vp))
    prefill = Qb >= PREFILL_ROWS
    if prefill:
        RB, T = PREFILL_ROWS, prefill_tile(D)
    else:
        (CS, W), RB, T = layout, DECODE_ROWS, DECODE_TILE
    o = torch.zeros(G, Qb, H, D)
    for g in range(G):
        for r0 in range(0, Qb, RB):
            rows = slice(r0, min(r0 + RB, Qb))
            rlb = torch.from_numpy(np.clip(rl[g, rows], 0, M * P).astype(
                np.int64))
            R = rlb.shape[0]
            qs = tq[g, rows] * (1.0 / np.sqrt(D))
            horizon = int(rlb.max())
            n_tiles = -(-horizon // T)
            if prefill:
                dealt, busy, n_workers = [0] * n_tiles, 1, 1
            else:
                (dealt, busy), n_workers = deal(n_tiles, CS, W), CS * W
            workers = [State(R, H, D) for _ in range(n_workers)]
            for t, c0 in enumerate(range(0, horizon, T)):
                pos = np.arange(c0, min(c0 + T, horizon))
                kt, vt, ksc, vsc = _tile(tk, tv, pt[g], pos, P, quant, ks,
                                         vs, fused)
                workers[dealt[t]].step(
                    qs, kt, vt, torch.from_numpy(pos), rlb, ksc, vsc,
                    "select")
            if prefill:
                st = workers[0]
            else:   # each CTA's warps, then the busy CTAs of the cluster
                st = _merge([_merge(workers[r * W:(r + 1) * W])
                             for r in range(busy)])
            o[g, rows] = st.acc / torch.clamp(st.l, min=1e-30)[..., None]
    return o


def emulate_rows(q, kp, vp, pt, sl, ks=None, vs=None, fused=True,
                 layout=DECODE_LAYOUT):
    """#2 / #2q: the decode form at one row a lane (G = B, Qb = 1)."""
    return emulate(q[:, None], kp, vp, pt, sl[:, None], ks, vs, fused,
                   layout)[:, 0]


def pools(rng, quantized, N, P, H, D):
    if quantized:
        return (rng.randint(-127, 128, (N, P, H, D)).astype(np.int8),
                rng.randint(-127, 128, (N, P, H, D)).astype(np.int8),
                (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32),
                (rng.rand(N, H) * 0.05 + 1e-3).astype(np.float32))
    return (rng.randn(N, P, H, D).astype(np.float32),
            rng.randn(N, P, H, D).astype(np.float32), None, None)


def lanes_case(rng, quantized, Qb, D, P, M, lane_lens=None, H=3):
    """G 4 lanes over their own pages: a full table, a lane stopping
    mid-page, an empty lane, one a page short of full; a prefill
    staircase of Qb rows with one padded row in lane 0."""
    lane_lens = lane_lens or [M * P, 61, 0, M * P - P - 3]
    G = len(lane_lens)
    N = 1 + G * M + 2
    q = rng.randn(G, Qb, H, D).astype(np.float32)
    kp, vp, ks, vs = pools(rng, quantized, N, P, H, D)
    pt = rng.permutation(np.arange(1, N))[:G * M].reshape(G, M).astype(
        np.int32)
    rl = np.array([[max(n - (Qb - 1 - r), 0) for r in range(Qb)]
                   for n in lane_lens], np.int32)
    rl[0, Qb // 2] = 0
    return q, kp, vp, pt, rl, ks, vs


def _jnp(args):
    return tuple(None if a is None else jnp.asarray(a) for a in args)


def _torch(args):
    return tuple(None if a is None else torch.from_numpy(a) for a in args)


# (pools, fused_dequant): f32 and the int8 body in both settings
BODIES = [(False, True), (True, True), (True, False)]
BODY_IDS = ["f32", "int8-fused", "int8-unfused"]
FORM_QB = [1, 15, 16, 17, 64]
FORM_D = [16, 64, 256]


@pytest.mark.parametrize("quantized,fused", BODIES, ids=BODY_IDS)
@pytest.mark.parametrize("D", FORM_D)
@pytest.mark.parametrize("Qb", FORM_QB)
def test_emulation_matches_jax_xla_reference(Qb, D, quantized, fused):
    """A 1024-position table: the decode form splits each lane over a
    cluster of 4 CTAs of 4 warps."""
    args = lanes_case(np.random.RandomState(40 + Qb), quantized, Qb, D,
                      P=4, M=256)
    got = emulate(*args, fused=fused).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ragged_paged_attention_xla(*_jnp(args))), **TOL)
    # and the port's plain version, which the card tests hold the kernel
    # against
    np.testing.assert_allclose(
        got, pa.ragged_paged_attention(*_torch(args)).numpy(), **TOL)


@pytest.mark.parametrize("quantized,fused", BODIES, ids=BODY_IDS)
@pytest.mark.parametrize("D", FORM_D)
@pytest.mark.parametrize("Qb", FORM_QB)
def test_emulation_matches_pallas_kernel_interpret(Qb, D, quantized,
                                                   fused):
    """A 192-position table: 6 tiles, on the first two CTAs of the
    cluster."""
    args = lanes_case(np.random.RandomState(50 + Qb), quantized, Qb, D,
                      P=16, M=12)
    want = ragged_paged_attention_kernel(
        *_jnp(args), interpret=True,
        fused_dequant=fused if quantized else None)
    np.testing.assert_allclose(emulate(*args, fused=fused).numpy(),
                               np.asarray(want), **TOL)


def rows_case(rng, quantized, D, P, M, lens):
    """#2's layout: one table row and one length per query row."""
    B, H = len(lens), 3
    N = 1 + B * M + 2
    q = rng.randn(B, H, D).astype(np.float32)
    kp, vp, ks, vs = pools(rng, quantized, N, P, H, D)
    pt = rng.permutation(np.arange(1, N))[:B * M].reshape(B, M).astype(
        np.int32)
    return q, kp, vp, pt, np.asarray(lens, np.int32), ks, vs


ROW_LENS = [0, 1, 33, 100, 191, 192]


@pytest.mark.parametrize("quantized,fused", BODIES, ids=BODY_IDS)
@pytest.mark.parametrize("D", FORM_D)
def test_per_row_emulation_matches_jax(D, quantized, fused):
    args = rows_case(np.random.RandomState(60 + D), quantized, D, 16, 12,
                     ROW_LENS)
    got = emulate_rows(*args, fused=fused).numpy()
    np.testing.assert_allclose(
        got, np.asarray(paged_attention_xla(*_jnp(args))), **TOL)
    want = paged_attention_kernel(*_jnp(args), interpret=True,
                                  fused_dequant=fused if quantized else None)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert (got[0] == 0).all()            # an empty row: exact zeros


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("Qb", [1, 8, 64])
def test_nan_k_scale_reaches_exactly_its_readers(Qb, fused):
    """A NaN K scale on lane 3's page 5 (positions 80..95), head 1: only
    the rows that see past position 80 go non-finite, in the decode
    form's cluster and in the prefill form alike."""
    args = list(lanes_case(np.random.RandomState(70), True, Qb, 64, P=16,
                           M=64, lane_lens=[0, 17, 1024, 84]))
    pt, rl, ks = args[3], args[4], args[5].copy()
    ks[pt[3, 5], 1] = np.nan
    args[5] = ks
    readers = np.zeros(rl.shape + (3,), bool)
    readers[3, :, 1] = rl[3] > 80
    assert readers.any()
    if Qb > 1:      # rows of the NaN page's block that stop before it
        assert ((rl[3] > 0) & (rl[3] <= 80)).any()
    o = emulate(*args, fused=fused)
    bad = ~torch.isfinite(o).all(-1).numpy()
    np.testing.assert_array_equal(bad, readers)
    want = np.asarray(ragged_paged_attention_xla(*_jnp(args)))
    np.testing.assert_array_equal(~np.isfinite(want).all(-1), readers)
    fin = ~readers
    np.testing.assert_allclose(o.numpy()[fin], want[fin], **TOL)


@pytest.mark.parametrize("Qb", [1, 8, 16, 64])
def test_a_lane_does_not_depend_on_its_batch(Qb):
    """The forms' layouts depend on D, the pools, the Qb bucket and the
    table's capacity only, and a lane's tiles on its own rows: each lane
    emulated alone gives the bits it gives inside a batch of other
    lengths."""
    args = lanes_case(np.random.RandomState(80), False, Qb, 64, P=16, M=64,
                      lane_lens=[1024, 0, 1, 500, 777, 33])
    full = emulate(*args)
    q, kp, vp, pt, rl, ks, vs = args
    for g in range(q.shape[0]):
        one = emulate(q[g:g + 1], kp, vp, pt[g:g + 1], rl[g:g + 1], ks, vs)
        assert torch.equal(one[0], full[g]), g


@pytest.mark.parametrize("layout,tiles_a_warp", [
    ((2, 4), 4), ((4, 4), 2), ((4, 4), 2), ((4, 2), 4), ((4, 4), 2)],
    ids=["f32", "int8", "bf16", "f32-d256", "int8-d256"])
def test_tiles_are_dealt_to_every_worker(layout, tiles_a_warp):
    """At a 1024-position table every worker (cluster CTAs x warps) of
    the layouts the card runs (a card test pins them) takes the same
    number of a full lane's 32 tiles, and every CTA is busy; a lane of 33
    positions occupies rank 0's first two warps only, and an empty lane
    rank 0 alone."""
    CS, W = layout
    workers, busy = deal(-(-1024 // DECODE_TILE), CS, W)
    assert sorted(set(workers)) == list(range(CS * W)) and busy == CS
    assert all(workers.count(w) == tiles_a_warp for w in range(CS * W))
    workers, busy = deal(-(-33 // DECODE_TILE), CS, W)
    assert {(w // W, w % W) for w in workers} == {(0, 0), (0, 1)}
    assert busy == 1
    assert deal(0, CS, W) == ([], 1)


@pytest.mark.parametrize("layout", [(1, 4), (2, 4), (4, 2), (8, 4), (8, 2)])
@pytest.mark.parametrize("Qb", [1, 8])
def test_every_cluster_layout_matches_jax(Qb, layout):
    """The split is exact for any cluster: one CTA, clusters whose last
    ranks are idle on the shorter lanes, and 8 CTAs of 2 warps."""
    args = lanes_case(np.random.RandomState(90 + Qb), False, Qb, 64, P=16,
                      M=64, lane_lens=[1024, 0, 1, 300, 777, 33])
    np.testing.assert_allclose(
        emulate(*args, layout=layout).numpy(),
        np.asarray(ragged_paged_attention_xla(*_jnp(args))), **TOL)
