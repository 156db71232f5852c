"""The mesh-sharded serving replica of paddle_tpu_torch vs the JAX package.

The JAX mesh engine does not run under the installed JAX (its
``shard_map`` cannot infer the replication of the sharded core's output),
so the port's mesh is held against what the JAX suite pins it equal to:
the single-device step and engine, and ``generate`` (greedy).

- one sharded ragged step at tp 2, sp 2 and tp 2 x sp 2 — native,
  int8_static and int8_dynamic KV (int8 weights with int8 KV) — against
  paddle_tpu's single-device ``make_gpt_paged_ragged_step`` and its core
  on the same inputs: logits within 1e-4 (the same f32 products; at
  sp > 1 the softmax merges in lse space) and tokens exact on the live
  rows, the shards' pools assembled into the global pool within 1e-5
  (one quantum for int8; a K/V value a few ulps apart may round to the
  neighbouring int8) outside the reserved pages, scales exact (static)
  or rtol 1e-6 (dynamic).  Rows that write and read the trash page (an
  idle lane, chunk padding) carry junk the engine drops; on a mesh the
  rows of pages another shard owns land in the same trash row, so under
  dynamic int8 that junk differs from one device's;
- twins of ``tests/test_serving_mesh.py``'s byte identity (streams equal
  paddle_tpu's ``generate`` and the port's single-device engine, token
  for token), knob validation, shard-sync chaos and reserved pages;
- the quarantine scrub and the page gather/scatter on a sharded pool,
  and the ``serving.shard.*`` metrics.

The mesh runs on 8 CPU slots (``force_device_count(8)``, the twin of the
suite's ``--xla_force_host_platform_device_count=8``), set for this
module and put back after it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.jit.functional import get_state
from paddle_tpu.slim import export_serving_quant as jax_export
from paddle_tpu.text.generation import _make_gpt_paged_core as jax_core
from paddle_tpu.text.generation import (
    make_gpt_paged_ragged_step as jax_ragged_step)
from paddle_tpu_torch.distributed import devices, force_device_count
from paddle_tpu_torch.framework.errors import (InternalError,
                                               InvalidArgumentError)
from paddle_tpu_torch.framework.monitor import stat_registry
from paddle_tpu_torch.serving import PagedKVCache, ServingEngine
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.testing.chaos import ChaosPlan, Fault
from paddle_tpu_torch.text.generation import (RAGGED_NO_LIMIT,
                                              ServingMeshLayout,
                                              _make_gpt_paged_core,
                                              make_gpt_paged_ragged_step)
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB, LAYERS, HEADS, D = 50, 2, 2, 16
ENGINE = dict(page_size=4, max_batch_size=4, prefill_chunk=4, eos_id=0,
              device="cpu")
BUDGET = 10
QUANT_KEY = "torch_mesh_serving-calib3"
LAYOUTS = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module", autouse=True)
def _eight_slots():
    prev = force_device_count(8)
    yield
    force_device_count(prev)


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=LAYERS,
                 num_heads=HEADS, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


@pytest.fixture(scope="module")
def quant(shared_gpt_small):
    rng = np.random.RandomState(3)
    return jax_export(shared_gpt_small,
                      calib_prompts=rng.randint(1, VOCAB, (4, 12)).astype(
                          np.int32))


def _truncate(want, end_id=0):
    if (want == end_id).any():
        want = want[: int(np.argmax(want == end_id)) + 1]
    return want


def _mixed_prompts(rng, lens=(3, 9, 5, 2)):
    return [rng.randint(1, VOCAB, (n,)).astype(np.int32) for n in lens]


def _drive(eng, prompts, budget=BUDGET, spans=None):
    """Serve ``prompts``; with ``spans`` (a set) record every sp shard
    count a running sequence's pages covered after each step."""
    ids = [eng.add_request(p, max_new_tokens=budget) for p in prompts]
    lay = eng._mesh_layout
    while eng.scheduler.has_work() or eng._pending:
        eng.step()
        if spans is not None and lay is not None:
            per = eng.cache.num_pages // lay.sp
            for seq in eng.scheduler.running:
                spans.add(len({p // per for p in
                               eng.cache.seq_page_ids(seq.seq_id)}))
    outs = eng.drain()
    return [outs[r] for r in ids]


def _refs(shared_gpt_small, greedy_ref_memo, prompts, budget=BUDGET,
          **quant):
    return [_truncate(greedy_ref_memo(shared_gpt_small, p, budget, end_id=0,
                                      **quant)) for p in prompts]


def _assert_streams(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# =============================================================================
# one sharded ragged step vs paddle_tpu's single-device step
# =============================================================================
PAGE, PPS, NPAGES = 4, 16, 24


def _step_inputs(mode, kv_scales):
    """A decode lane, a padded prefill chunk, a second decode lane and an
    idle lane; lanes 0-2 hold pages on both halves of the pool, none on
    the pages a 2-way page split reserves (0 and 12)."""
    rng = np.random.RandomState(7)
    B, Q = 4, 8
    if mode == "native":
        pools = {s: [rng.randn(NPAGES, PAGE, HEADS, D).astype(np.float32)
                     for _ in range(LAYERS)] for s in ("k", "v")}
    else:
        pools = {s: [rng.randint(-127, 128, (NPAGES, PAGE, HEADS, D)).astype(
            np.int8) for _ in range(LAYERS)] for s in ("k", "v")}
        for s in ("k", "v"):
            pools[f"{s}_scale"] = [
                (np.broadcast_to(np.asarray(kv_scales[s][i], np.float32),
                                 (NPAGES, HEADS)).copy()
                 if mode == "int8_static" else
                 (rng.rand(NPAGES, HEADS) * 0.05 + 1e-3).astype(np.float32))
                for i in range(LAYERS)]
    tables = np.zeros((B, PPS), np.int32)
    tables[0, :3] = [3, 17, 11]         # decode lane, pos 9 -> page 11
    tables[1, :2] = [5, 14]             # prefill lane, prompt of 7
    tables[2, :2] = [20, 9]             # decode lane, pos 5 -> page 9
    state_tok = np.array([17, 0, 23, 0], np.int32)
    state_pos = np.array([9, 0, 5, 0], np.int32)
    rows_tok = np.zeros((B, Q), np.int32)
    rows_pos = np.zeros((B, Q), np.int32)
    row_valid = np.zeros((B, Q), np.int32)
    row_valid[:, 0] = RAGGED_NO_LIMIT
    rows_tok[1] = rng.randint(1, VOCAB, Q)
    rows_pos[1] = 4 + np.arange(Q)
    row_valid[1] = 7
    advance = np.array([1, 0, 1, 1], np.int32)
    return (state_tok, state_pos, tables, rows_tok, rows_pos, row_valid,
            advance), pools


def _core_inputs(rows):
    """The core's row inputs as the ragged step builds them, and the live
    rows: those whose position lies below their valid length on a real
    (not trash) page."""
    st, sp, tables, rt, rp, rv, adv = rows
    tok, pos = rt.copy(), rp.copy()
    decode = adv > 0
    tok[:, 0] = np.where(decode, st, rt[:, 0])
    pos[:, 0] = np.where(decode, sp, rp[:, 0])
    page = np.take_along_axis(tables, pos // PAGE, axis=1)
    live = (pos < rv) & (page != 0)
    return tok.reshape(-1), pos.reshape(-1), tables, rv.reshape(-1), live


def _shard_pools(lay, init_pages, pools):
    kvs = init_pages(NPAGES)
    for j, kv in enumerate(kvs):
        t, s = divmod(j, lay.sp)
        for side, arrs in pools.items():
            for dst, a in zip(kv[side], arrs):
                dst.copy_(lay.shard_pool(torch.from_numpy(a), t, s))
    return kvs


@pytest.fixture(scope="module")
def step_results(shared_gpt_small, port, quant):
    """{(mode, tp, sp): (jax ragged out, port ragged out, jax logits, port
    logits, layout)}."""
    res = {}
    for mode in ("native", "int8_static", "int8_dynamic"):
        qkw = {}
        if mode != "native":
            qkw = dict(kv_cache_dtype="int8", weight_quant=quant["weights"],
                       kv_scales=(quant["kv_scales"] if mode == "int8_static"
                                  else None))
        rows, pools = _step_inputs(mode, quant["kv_scales"])
        jfn, _ = jax_ragged_step(shared_gpt_small, PAGE, PPS, **qkw)
        jkv = {k: [jnp.asarray(a) for a in v] for k, v in pools.items()}
        jout = jfn(*(jnp.asarray(a) for a in rows), jkv)
        jcore, _ = jax_core(shared_gpt_small, PAGE, PPS, **qkw)
        tok, pos, tables, vl, live = _core_inputs(rows)
        jlogits, _ = jcore(jnp.asarray(tok), jnp.asarray(pos),
                           jnp.asarray(tables),
                           {k: [jnp.asarray(a) for a in v]
                            for k, v in pools.items()},
                           valid_len=jnp.asarray(vl), qgroup=rows[3].shape[1])
        for tp, sp in LAYOUTS:
            lay = ServingMeshLayout(tp=tp, sp=sp)
            tfn, init = make_gpt_paged_ragged_step(port, PAGE, PPS,
                                                   mesh_layout=lay, **qkw)
            tout = tfn(*(torch.from_numpy(a) for a in rows),
                       _shard_pools(lay, init, pools))
            tcore, init = _make_gpt_paged_core(port, PAGE, PPS,
                                               mesh_layout=lay, **qkw)
            tlogits, _ = tcore(*(torch.from_numpy(a) for a in
                                 (tok, pos, tables)),
                               _shard_pools(lay, init, pools),
                               valid_len=torch.from_numpy(vl),
                               qgroup=rows[3].shape[1])
            res[mode, tp, sp] = (jout, tout, np.asarray(jlogits), tlogits,
                                 lay, live)
    return res


STEP_CASES = [(m, tp, sp) for m in ("native", "int8_static", "int8_dynamic")
              for tp, sp in LAYOUTS]


@pytest.mark.parametrize("mode,tp,sp", STEP_CASES,
                         ids=[f"{m}-tp{t}sp{s}" for m, t, s in STEP_CASES])
def test_sharded_step_matches_jax_single_device(step_results, mode, tp, sp):
    jout, tout, jlogits, tlogits, lay, live = step_results[mode, tp, sp]
    assert live.sum() == 5              # 2 decode rows, 3 chunk rows
    np.testing.assert_allclose(tlogits.numpy()[live.reshape(-1)],
                               jlogits[live.reshape(-1)], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tout[0].numpy()[live],
                                  np.asarray(jout[0])[live])
    lanes = live[:, 0]                  # the decode lanes' device state
    for t, j in zip(tout[1:4], jout[1:4]):
        np.testing.assert_array_equal(t.numpy()[lanes], np.asarray(j)[lanes])
    keep = np.ones(NPAGES, bool)
    keep[list(lay.reserved_pages(NPAGES))] = False
    jkv, tkv = jout[4], tout[4]
    for side in jkv:
        for i in range(LAYERS):
            got = lay.assemble_pool([kv[side][i] for kv in tkv]).numpy()
            want = np.asarray(jkv[side][i])
            assert got.shape == want.shape
            got, want = got[keep], want[keep]
            if side.endswith("_scale"):
                if mode == "int8_static":
                    assert got.tobytes() == want.tobytes()
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            elif mode == "native":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            else:
                diff = got.astype(np.int16) - want.astype(np.int16)
                assert np.abs(diff).max() <= 1


def test_layout_cuts_and_reassembles(port):
    lay = ServingMeshLayout(tp=2, sp=3)
    assert lay.size == 6 and lay.axes() == {"tp": 2, "sp": 3, "data": 1}
    assert lay.reserved_pages(12) == (0, 4, 8)
    assert ServingMeshLayout().reserved_pages(12) == (0,)
    w = dict(port.named_parameters())
    q = w["layers.0.attn.q_proj.weight"].detach()           # [out, in]
    assert torch.equal(lay.shard_param("layers.0.attn.q_proj.weight", q, 1),
                       q[16:])
    b = w["layers.1.fc1.bias"].detach()
    assert torch.equal(lay.shard_param("layers.1.fc1.bias", b, 0), b[:32])
    o = w["layers.0.attn.out_proj.weight"].detach()
    assert lay.shard_param("layers.0.attn.out_proj.weight", o, 1) is o
    wq = torch.arange(32 * 64, dtype=torch.int8).reshape(32, 64)
    qs, ss = lay.shard_weight_quant("layers.0.fc1.weight", wq,
                                    np.arange(64, dtype=np.float32), 1)
    assert torch.equal(qs, wq[:, 32:]) and ss.tolist() == list(range(32, 64))
    pool = torch.arange(12 * 2 * 4 * 3, dtype=torch.float32).reshape(
        12, 2, 4, 3)
    parts = [lay.shard_pool(pool, t, s) for t in range(2) for s in range(3)]
    assert parts[4].shape == (4, 2, 2, 3)
    assert torch.equal(parts[4], pool[4:8, :, 2:])
    assert torch.equal(lay.assemble_pool(parts), pool)
    sc = pool[:, 0, :, 0]                                   # [12, 4]
    assert torch.equal(lay.shard_pool(sc, 1, 2), sc[8:, 2:])
    with pytest.raises(ValueError, match=">= 1"):
        ServingMeshLayout(tp=0)
    with pytest.raises(ValueError, match="divisible by tp"):
        _make_gpt_paged_core(port, PAGE, PPS,
                             mesh_layout=ServingMeshLayout(tp=3))
    core, init = _make_gpt_paged_core(port, PAGE, PPS,
                                      mesh_layout=ServingMeshLayout(sp=2))
    with pytest.raises(ValueError, match="divisible by sp"):
        init(25)
    with pytest.raises(NotImplementedError, match="ragged"):
        core(torch.zeros(2, dtype=torch.int32),
             torch.zeros(2, dtype=torch.int32),
             torch.zeros((2, PPS), dtype=torch.int32), init(24))


# =============================================================================
# byte identity vs generate and the single-device engine
# =============================================================================
@pytest.fixture(scope="module")
def native_ref(shared_gpt_small, greedy_ref_memo, port):
    prompts = _mixed_prompts(np.random.RandomState(0))
    return (prompts, _refs(shared_gpt_small, greedy_ref_memo, prompts),
            _drive(ServingEngine(port, **ENGINE), prompts))


def _shard_count(name):
    return stat_registry.get(f"serving.shard.{name}").get()


class TestByteIdentity:
    def test_tp2_matches_single_device(self, port, native_ref):
        prompts, ref, single = native_ref
        mesh = ServingEngine(port, mesh_axes={"tp": 2}, **ENGINE)
        got = _drive(mesh, prompts)
        _assert_streams(got, ref, single)
        assert _shard_count("steps") == \
            mesh.stats()["metrics"]["ragged"]["steps"] > 0
        assert _shard_count("tp") == 2 and _shard_count("devices") == 2
        assert mesh.cache.pages_in_use == 0

    def test_sp2_long_prompt_matches_single_device(self, shared_gpt_small,
                                                   greedy_ref_memo, port):
        """A long-document drive: 24- and 33-token prompts over a 24-page
        pool split into two 12-page shards, so sequences hold pages on
        both shards and every layer merges the shards' stats."""
        rng = np.random.RandomState(1)
        prompts = [rng.randint(1, VOCAB, (n,)).astype(np.int32)
                   for n in (24, 33, 5)]
        ref = _refs(shared_gpt_small, greedy_ref_memo, prompts, budget=12)
        single = _drive(ServingEngine(port, num_pages=24, **ENGINE), prompts,
                        budget=12)
        mesh = ServingEngine(port, num_pages=24, mesh_axes={"sp": 2},
                             **ENGINE)
        spans = set()
        got = _drive(mesh, prompts, budget=12, spans=spans)
        _assert_streams(got, ref, single)
        assert 2 in spans
        assert mesh.stats()["pipeline"]["mesh"] == {"tp": 1, "sp": 2,
                                                    "devices": 2}
        assert mesh.cache.reserved_pages == (0, 12)
        assert mesh.cache.pages_in_use == 0

    def test_tp2_sp2_matches_single_device(self, port, native_ref):
        prompts, ref, single = native_ref
        mesh = ServingEngine(port, num_pages=16, mesh_axes={"tp": 2, "sp": 2},
                             **ENGINE)
        spans = set()
        got = _drive(mesh, prompts, spans=spans)
        _assert_streams(got, ref, single)
        assert 2 in spans
        assert mesh.stats()["pipeline"]["mesh"]["devices"] == 4
        assert mesh.cache.pages_in_use == 0

    def test_int8_static_matches_single_device(self, shared_gpt_small,
                                               greedy_ref_memo, port, quant):
        prompts = _mixed_prompts(np.random.RandomState(3))
        kw = dict(kv_cache_dtype="int8", weight_dtype="int8",
                  quant_scales=quant, **ENGINE)
        ref = _refs(shared_gpt_small, greedy_ref_memo, prompts, quant=quant,
                    quant_key=QUANT_KEY)
        single = _drive(ServingEngine(port, **kw), prompts)
        mesh = ServingEngine(port, num_pages=16,
                             mesh_axes={"tp": 2, "sp": 2}, **kw)
        spans = set()
        got = _drive(mesh, prompts, spans=spans)
        _assert_streams(got, ref, single)
        assert 2 in spans and mesh.kv_mode() == "int8_static"

    @pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 2, "sp": 2}],
                             ids=["tp2", "tp2sp2"])
    def test_int8_dynamic_matches_single_device(self, port, axes):
        prompts = _mixed_prompts(np.random.RandomState(4))
        kw = dict(kv_cache_dtype="int8", weight_dtype="int8", **ENGINE)
        single = _drive(ServingEngine(port, num_pages=16, **kw), prompts)
        mesh = ServingEngine(port, num_pages=16, mesh_axes=axes, **kw)
        _assert_streams(_drive(mesh, prompts), single)
        assert mesh.kv_mode() == "int8_dynamic"
        assert mesh.cache.pages_in_use == 0

    def test_spec_decode_under_tp_matches_single_device(
            self, shared_gpt_small, greedy_ref_memo, port):
        """Spec-verify rows fold into the mesh ragged dispatch as on one
        device (native KV; int8_dynamic is refused at construction)."""
        rng = np.random.RandomState(5)
        prompts = [np.tile(rng.randint(1, VOCAB, (p,)).astype(np.int32), 4)
                   for p in (2, 3)]
        ref = _refs(shared_gpt_small, greedy_ref_memo, prompts, budget=16)
        single = _drive(ServingEngine(port, spec_decode=4, **ENGINE),
                        prompts, budget=16)
        mesh = ServingEngine(port, mesh_axes={"tp": 2}, spec_decode=4,
                             **ENGINE)
        got = _drive(mesh, prompts, budget=16)
        _assert_streams(got, ref, single)
        assert mesh.stats()["spec"]["drafted"] > 0
        assert mesh._spec_fn is None
        assert _shard_count("steps") == \
            mesh.stats()["programs"]["ragged_step"]

    def test_double_drive_deterministic(self, port):
        eng = ServingEngine(port, mesh_axes={"tp": 2, "sp": 2}, **ENGINE)
        prompts = _mixed_prompts(np.random.RandomState(6))
        first = _drive(eng, prompts, budget=8)
        second = _drive(eng, prompts, budget=8)
        _assert_streams(first, second)


# =============================================================================
# sharded page maintenance, metrics
# =============================================================================
def test_quarantine_scrubs_a_sharded_pool(port, native_ref):
    """The numeric guard on a head-sharded pool: the scrub zeroes the
    victim's pages in every tensor shard.  (The quarantine contract at
    sp > 1 is ``test_quarantine_at_sp_fails_only_the_victim``.)"""
    prompts, ref, _ = native_ref
    eng = ServingEngine(port, mesh_axes={"tp": 2}, sync_mode=True, **ENGINE)
    ids = [eng.add_request(p, max_new_tokens=BUDGET) for p in prompts[:2]]
    for _ in range(4):                  # past both prefill plans
        eng.step()
    victim = next(s for s in eng.scheduler.running if s.seq_id == ids[1])
    scatters = _shard_count("page_scatters")
    eng._poison_lane(victim)            # NaN over its last written page
    assert any(not torch.isfinite(p).all() for kv in eng._kv
               for side in kv.values() for p in side)
    outs = eng.drain()
    assert eng.take_faulted() == [ids[1]] and ids[1] not in outs
    np.testing.assert_array_equal(outs[ids[0]], ref[0])
    assert _shard_count("page_scatters") == scatters + 1
    assert eng.cache.pages_in_use == 0
    assert all(torch.isfinite(p).all() for kv in eng._kv
               for side in kv.values() for p in side)


# The quarantine contract of tests/test_numeric_guards.py:79 at sp > 1.
# Fault F1: the rows a lane writes into pages another shard owns land in
# that shard's local row 0, and the plain stats version multiplies every
# non-owned table entry (row 0) by a zero probability, so one victim's
# NaN K/V turned every co-batched lane NaN.  The mesh core now clears
# row 0 after each layer's scatters on the plain route.  Two pools: 24
# pages, where both sequences sit on shard 0 when the poison lands (the
# drive that first showed F1: the survivor failed at its third token),
# and 12 pages poisoned after 7 steps, where both span both shards and
# the victim's poisoned page lies on shard 1 beside the survivor's.
# int8_static pages cannot carry the NaN into row 0 (a NaN quantizes to
# a finite int8 and static scales are never written), so that arm held
# before the fix too; native and int8_dynamic failed.
F1_PROMPTS = (9, 6)
F1_POOLS = {"one_shard": (24, 4), "both_shards": (12, 7)}


@pytest.fixture(scope="module")
def f1_model():
    return GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=LAYERS,
                    num_heads=HEADS, ffn_size=64, max_seq_len=64,
                    device="cpu", seed=0)


def _f1_drive(model, kv_mode, mesh_axes, num_pages, poison_after):
    from paddle_tpu_torch.slim import export_serving_quant

    kw = dict(page_size=4, max_batch_size=4, prefill_chunk=4, eos_id=-1,
              device="cpu", sync_mode=True, num_pages=num_pages)
    if kv_mode != "native":
        kw["kv_cache_dtype"] = "int8"
    if kv_mode == "int8_static":
        kw["quant_scales"] = export_serving_quant(
            model, weight_dtype=None,
            calib_prompts=np.random.RandomState(3).randint(
                1, VOCAB, (4, 12)).astype(np.int32))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, VOCAB, (n,)).astype(np.int32)
               for n in F1_PROMPTS]
    eng = ServingEngine(model, mesh_axes=mesh_axes, **kw)
    ids = [eng.add_request(p, max_new_tokens=BUDGET) for p in prompts]
    for _ in range(poison_after):
        eng.step()
    spans = {}
    if eng._mesh_layout is not None:
        per = num_pages // eng._mesh_layout.sp
        spans = {s.seq_id: {p // per for p in eng.cache.seq_page_ids(
            s.seq_id)} for s in eng.scheduler.running}
    victim = next(s for s in eng.scheduler.running if s.seq_id == ids[1])
    eng._poison_lane(victim)
    outs = eng.drain()
    return eng, ids, outs, spans


@pytest.mark.parametrize("pool", sorted(F1_POOLS))
@pytest.mark.parametrize("kv_mode", ["native", "int8_static",
                                     "int8_dynamic"])
@pytest.mark.parametrize("mesh_axes", [{"sp": 2}, {"tp": 2, "sp": 2}],
                         ids=["sp2", "tp2sp2"])
def test_quarantine_at_sp_fails_only_the_victim(f1_model, mesh_axes,
                                                kv_mode, pool):
    num_pages, poison_after = F1_POOLS[pool]
    _, sids, souts, _ = _f1_drive(f1_model, kv_mode, None, num_pages,
                                  poison_after)
    eng, ids, outs, spans = _f1_drive(f1_model, kv_mode, mesh_axes,
                                      num_pages, poison_after)
    want = {"one_shard": {0}, "both_shards": {0, 1}}[pool]
    assert all(s == want for s in spans.values()) and len(spans) == 2
    assert eng.take_faulted() == [ids[1]] and ids[1] not in outs
    assert len(outs[ids[0]]) == BUDGET
    np.testing.assert_array_equal(outs[ids[0]], souts[sids[0]])
    assert eng.cache.pages_in_use == 0
    assert all(torch.isfinite(p).all() for kv in eng._kv
               for side in kv.values() for p in side)


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"],
                         ids=["native", "int8"])
def test_page_gather_and_put_cross_every_shard(port, kv_cache_dtype):
    eng = ServingEngine(port, num_pages=16, mesh_axes={"tp": 2, "sp": 2},
                        kv_cache_dtype=kv_cache_dtype, **ENGINE)
    lay = eng._mesh_layout
    rng = np.random.RandomState(9)
    for kv in eng._kv:
        for side in kv.values():
            for t in side:
                t.copy_(torch.from_numpy(
                    rng.randint(-50, 50, tuple(t.shape)).astype(
                        np.float32)).to(t.dtype))
    pages = [3, 13, 9, 1]               # both sequence shards, any order
    g0, s0 = _shard_count("page_gathers"), _shard_count("page_scatters")
    saved = eng._page_gather(pages)
    assert _shard_count("page_gathers") == g0 + 1
    for side, pools in saved.items():
        for i, got in enumerate(pools):
            full = lay.assemble_pool([kv[side][i] for kv in eng._kv])
            assert torch.equal(got, full[pages])
    zeros = {side: [torch.zeros_like(t) for t in pools]
             for side, pools in saved.items()}
    eng._page_put(pages, zeros)
    assert _shard_count("page_scatters") == s0 + 1
    for side, pools in saved.items():
        for i in range(len(pools)):
            full = lay.assemble_pool([kv[side][i] for kv in eng._kv])
            assert not full[pages].any()
    eng._page_put(pages, saved)
    for side, pools in saved.items():
        for i, want in enumerate(pools):
            full = lay.assemble_pool([kv[side][i] for kv in eng._kv])
            assert torch.equal(full[pages], want)


def test_dynamic_scale_reset_reaches_the_owning_shard(port):
    eng = ServingEngine(port, num_pages=16, mesh_axes={"tp": 2, "sp": 2},
                        kv_cache_dtype="int8", **ENGINE)
    lay = eng._mesh_layout
    for kv in eng._kv:
        for sc in kv["k_scale"] + kv["v_scale"]:
            sc.fill_(0.5)
    eng._reset_page_scales([2, 11])
    from paddle_tpu_torch.serving.kv_cache import KV_SCALE_EPS

    for side in ("k_scale", "v_scale"):
        for i in range(LAYERS):
            full = lay.assemble_pool([kv[side][i] for kv in eng._kv])
            reset = torch.zeros(16, dtype=torch.bool)
            reset[[2, 11]] = True
            assert (full[reset] == KV_SCALE_EPS).all()
            assert (full[~reset] == 0.5).all()


def test_shard_metrics_and_stats_surface(port):
    eng = ServingEngine(port, mesh_axes={"tp": 2, "sp": 2}, **ENGINE)
    snap = eng.stats()["metrics"]["shard"]
    assert snap == {"tp": 2, "sp": 2, "devices": 4, "steps": 0,
                    "page_gathers": 0, "page_scatters": 0}
    assert eng.stats()["pipeline"]["mesh"] == {"tp": 2, "sp": 2,
                                               "devices": 4}
    _drive(eng, _mixed_prompts(np.random.RandomState(12)), budget=4)
    snap = eng.stats()["metrics"]["shard"]
    assert snap["steps"] == eng.stats()["programs"]["ragged_step"] > 0
    # one pool per shard: [N/sp, P, H/tp, D] each, the same bytes in all
    assert len(eng._kv) == 4
    assert tuple(eng._kv[3]["k"][0].shape) == (eng.cache.num_pages // 2,
                                               4, 1, D)
    plain = ServingEngine(port, **ENGINE)
    assert eng.kv_cache_bytes() == plain.kv_cache_bytes() \
        * eng.cache.num_pages // plain.cache.num_pages


# =============================================================================
# knob validation
# =============================================================================
class TestKnobValidation:
    BASE = dict(page_size=4, eos_id=0, device="cpu")

    @pytest.mark.parametrize("axes,kw,match", [
        (2, {}, "mesh_axes"),
        ({"dp": 2}, {}, "mesh_axes"),
        ({"tp": 0}, {}, "mesh_axes"),
        ({"tp": "x"}, {}, "mesh_axes"),
        ({"tp": 3}, {}, "head"),
        ({"tp": 2}, {"ragged": False}, "ragged"),
        ({"tp": 2}, {"fused_steps": 4}, "ragged"),
        ({"tp": 2}, {"spec_decode": 4, "kv_cache_dtype": "int8"},
         "spec_decode"),
        ({"sp": 2}, {"num_pages": 31}, "num_pages")],
        ids=["not-dict", "unknown-axis", "degree-0", "degree-str",
             "tp-divides-heads", "ragged-false", "fused-steps",
             "spec-int8-dynamic", "num-pages"])
    def test_invalid_mesh_axes_raise(self, port, axes, kw, match):
        with pytest.raises(InvalidArgumentError, match=match):
            ServingEngine(port, mesh_axes=axes, **kw, **self.BASE)

    def test_mesh_must_fit_devices(self, port):
        too_many = len(devices("cpu")) * 2
        with pytest.raises(InvalidArgumentError, match="device"):
            ServingEngine(port, mesh_axes={"sp": too_many}, **self.BASE)

    def test_without_forced_slots_the_cpu_is_one_device(self, port):
        prev = force_device_count(None)
        try:
            assert devices("cpu") == [torch.device("cpu")]
            with pytest.raises(InvalidArgumentError, match="device"):
                ServingEngine(port, mesh_axes={"tp": 2}, **self.BASE)
        finally:
            force_device_count(prev)

    def test_num_pages_rounds_up_to_sp(self, port):
        eng = ServingEngine(port, mesh_axes={"sp": 3}, max_batch_size=4,
                            **self.BASE)
        # 4 lanes x 16 pages + 1 = 65, rounded up to 66
        assert eng.cache.num_pages == 66
        assert eng.cache.reserved_pages == (0, 22, 44)

    def test_plain_engine_reports_no_mesh(self, port):
        eng = ServingEngine(port, **self.BASE)
        assert eng.stats()["pipeline"]["mesh"] is None

    def test_trivial_mesh_is_single_device(self, port):
        eng = ServingEngine(port, mesh_axes={"tp": 1, "sp": 1},
                            **self.BASE)
        assert eng.stats()["pipeline"]["mesh"] is None
        assert isinstance(eng._kv, dict)


# =============================================================================
# chaos: the mesh failure domain
# =============================================================================
class TestShardSyncChaos:
    def test_straggler_shard_delays_but_stream_unchanged(self, port,
                                                         native_ref):
        prompts, ref, single = native_ref
        mesh = ServingEngine(port, mesh_axes={"tp": 2}, **ENGINE)
        plan = ChaosPlan([Fault("serving.shard_sync", at=2,
                                action="delay", delay_s=0.02)])
        with chaos.running(plan):
            got = _drive(mesh, prompts)
        assert plan.fired and plan.fired[0]["site"] == "serving.shard_sync"
        _assert_streams(got, ref, single)

    def test_failed_exchange_is_a_replica_crash(self, port):
        eng = ServingEngine(port, mesh_axes={"tp": 2}, **ENGINE)
        rng = np.random.RandomState(10)
        eng.add_request(rng.randint(1, VOCAB, (5,)).astype(np.int32),
                        max_new_tokens=8)
        plan = ChaosPlan([Fault("serving.shard_sync", at=1,
                                action="raise")])
        with chaos.running(plan):
            with pytest.raises(InternalError, match="chaos"):
                for _ in range(16):
                    eng.step()

    def test_site_never_fires_on_single_device(self, port):
        eng = ServingEngine(port, **ENGINE)
        rng = np.random.RandomState(11)
        eng.add_request(rng.randint(1, VOCAB, (3,)).astype(np.int32),
                        max_new_tokens=4)
        plan = ChaosPlan([Fault("serving.shard_sync", at=1,
                                action="raise")])
        with chaos.running(plan):
            eng.drain()
        assert not plan.fired


# =============================================================================
# kv cache: per-shard reserved trash pages
# =============================================================================
class TestReservedPages:
    def test_reserved_pages_excluded_from_allocation(self):
        cache = PagedKVCache(num_pages=16, page_size=4, pages_per_seq=4,
                             reserved_pages=(0, 8))
        assert cache.reserved_pages == (0, 8)
        assert cache.allocatable_pages == 14
        seen = set()
        i = 0
        while cache.free_pages:
            assert cache.allocate(f"s{i}", 4)          # one page each
            seen.update(cache.seq_page_ids(f"s{i}"))
            i += 1
        assert 0 not in seen and 8 not in seen
        assert len(seen) == 14
        assert not cache.allocate("overflow", 4)       # all-or-nothing

    def test_leak_invariant_over_allocatable(self):
        cache = PagedKVCache(num_pages=8, page_size=4, pages_per_seq=4,
                             reserved_pages=(0, 4))
        assert cache.allocate("s", 10)                 # 3 pages
        assert (cache.pages_in_use + cache.free_pages
                == cache.allocatable_pages)
        cache.free("s")
        assert cache.free_pages == cache.allocatable_pages == 6
        assert cache.stats()["num_pages"] == 6

    def test_share_rejects_reserved_ids(self):
        cache = PagedKVCache(num_pages=8, page_size=4, pages_per_seq=4,
                             reserved_pages=(0, 4))
        with pytest.raises(InvalidArgumentError, match="reserved"):
            cache.share("s", [4])

    def test_all_pages_reserved_rejected(self):
        with pytest.raises(InvalidArgumentError):
            PagedKVCache(num_pages=2, page_size=4, pages_per_seq=1,
                         reserved_pages=(0, 1))
