"""Snapshots and the resilience policy objects of paddle_tpu_torch
(``serving/resilience.py`` and the engine's ``snapshot`` / ``restore``)
vs paddle_tpu.

- a request snapshotted mid-stream in one package, carried through
  ``to_state()`` / ``from_state()`` and restored in the other package's
  engine finishes with the uninterrupted stream, in both directions,
  native and int8_static (and with the donor's pages shared through its
  prefix cache: they restore private);
- int8_dynamic: the snapshot carries dequantized f32 pages and no scale
  rows, restore requantizes them with fresh abs-max scales (the donor's
  int8 pages come back within one quantum, the stream equals the
  uninterrupted one), in the port and into the JAX engine;
- a tp 2 x sp 2 mesh snapshot restores in a single-slot engine and the
  reverse, and the speculative drafter's lane state travels along;
- refusals: a page-size or KV-mode mismatch and a live duplicate id
  raise, a snapshot of an unknown, queued or mid-plan request is None;
  the snapshot and restore metrics count;
- ``Watchdog`` and ``BrownoutController`` fed the same timed event
  sequences with an injected clock reach the same verdicts, thresholds,
  backoffs, trips and stages as paddle_tpu's; the metric hooks of
  snapshots, the watchdog, the prefix cache and the brownout count what
  paddle_tpu's count.
"""
import numpy as np
import pytest

from paddle_tpu.framework.monitor import stat_registry as jax_registry
from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import resilience as jax_res
from paddle_tpu.slim import export_serving_quant as jax_export
from paddle_tpu_torch.distributed import force_device_count
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.framework.monitor import stat_registry
from paddle_tpu_torch.serving import Sequence, ServingEngine
from paddle_tpu_torch.serving import resilience as port_res
from paddle_tpu_torch.serving.kv_cache import (dequantize_kv_page,
                                               quantize_kv_page)
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 50
ENGINE = dict(page_size=4, max_batch_size=4, prefill_chunk=4, eos_id=-1)
BUDGET = 12


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


@pytest.fixture(scope="module")
def quant(shared_gpt_small):
    calib = np.random.RandomState(11).randint(1, VOCAB, (4, 12))
    return jax_export(shared_gpt_small, calib_prompts=calib.astype(np.int32))


@pytest.fixture(scope="module")
def prompt():
    return np.random.RandomState(5).randint(1, VOCAB, (7,)).astype(np.int32)


def _engine(pkg, models, quant, mode, **kw):
    kw = dict(ENGINE, **kw)
    if mode != "native":
        kw["kv_cache_dtype"] = "int8"
    if mode == "int8_static":
        kw["quant_scales"] = quant
    if pkg == "jax":
        return JaxEngine(models[0], **kw)
    return ServingEngine(models[1], device="cpu", **kw)


def _run_until(eng, rid, ntokens):
    """Step until ``rid`` has consumed ``ntokens`` tokens."""
    for _ in range(200):
        seq = next((s for s in eng.scheduler.running if s.seq_id == rid),
                   None)
        if seq is not None and len(seq.generated) >= ntokens:
            return
        eng.step()
    raise AssertionError(f"{rid} never reached {ntokens} tokens")


def _uninterrupted(eng, prompt, budget=BUDGET, **kw):
    rid = eng.add_request(prompt, max_new_tokens=budget, **kw)
    return eng.drain()[rid]


# =============================================================================
# snapshots across packages
# =============================================================================
@pytest.mark.parametrize("mode", ["native", "int8_static"])
@pytest.mark.parametrize("donor,survivor", [("jax", "port"),
                                            ("port", "jax")])
def test_snapshot_restores_across_packages(shared_gpt_small, port, quant,
                                           prompt, mode, donor, survivor):
    models = (shared_gpt_small, port)
    want = _uninterrupted(_engine(survivor, models, quant, mode), prompt)
    src = _engine(donor, models, quant, mode)
    assert src.kv_mode() == mode
    rid = src.add_request(prompt, max_new_tokens=BUDGET, request_id="x")
    _run_until(src, rid, 5)
    snap = src.snapshot(rid)
    assert snap.kv_mode == mode and snap.num_generated >= 5
    state = snap.to_state()
    res = jax_res if survivor == "jax" else port_res
    carried = res.EngineSnapshot.from_state(state)
    assert carried.pos == snap.pos and carried.nbytes == snap.nbytes
    dst = _engine(survivor, models, quant, mode)
    assert dst.restore(carried) == rid
    got = dst.drain()[rid]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:snap.num_generated], snap.generated)
    assert dst.cache.pages_in_use == 0
    # both packages gather the same pages
    other = _engine(survivor, models, quant, mode)
    orid = other.add_request(prompt, max_new_tokens=BUDGET,
                             request_id="x")
    _run_until(other, orid, snap.num_generated)
    twin = other.snapshot(orid)
    if twin.num_generated == snap.num_generated:
        for side in ("k", "v"):
            for a, b in zip(snap.pages[side], twin.pages[side]):
                np.testing.assert_allclose(np.asarray(a, np.float32),
                                           np.asarray(b, np.float32),
                                           atol=1e-5 if mode == "native"
                                           else 1)


def test_snapshot_of_shared_pages_restores_private(shared_gpt_small, port):
    """The donor's sequence reads pages of its prefix cache; the
    snapshot gathers them like owned ones and the survivor (the other
    package, cache on) admits them private."""
    rng = np.random.RandomState(16)
    prefix = rng.randint(1, VOCAB, (8,)).astype(np.int32)
    pb = np.concatenate([prefix, [9, 21, 33]]).astype(np.int32)
    want = _uninterrupted(ServingEngine(port, device="cpu", **ENGINE), pb)
    donor = ServingEngine(port, prefix_cache=True, device="cpu", **ENGINE)
    _uninterrupted(donor, prefix, budget=4)
    rid = donor.add_request(pb, max_new_tokens=BUDGET, request_id="b")
    _run_until(donor, rid, 4)
    assert donor.stats()["prefix_cache"]["hits"] == 1
    snap = donor.snapshot(rid)
    surv = JaxEngine(shared_gpt_small, prefix_cache=True, **ENGINE)
    surv.restore(jax_res.EngineSnapshot.from_state(snap.to_state()))
    np.testing.assert_array_equal(surv.drain()[rid], want)
    # resume admissions neither look up nor seal
    assert surv.stats()["prefix_cache"]["hits"] == 0
    assert surv.stats()["prefix_cache"]["pages"] == 0


# =============================================================================
# int8_dynamic: dequantize on snapshot, requantize on restore
# =============================================================================
@pytest.mark.parametrize("survivor", ["port", "jax"])
def test_int8_dynamic_dequantize_requantize(shared_gpt_small, port, prompt,
                                            survivor):
    models = (shared_gpt_small, port)
    donor = _engine("port", models, None, "int8_dynamic")
    assert donor.kv_mode() == "int8_dynamic"
    rid = donor.add_request(prompt, max_new_tokens=BUDGET)
    _run_until(donor, rid, 4)
    snap = donor.snapshot(rid)
    assert snap.kv_mode == "int8_dynamic"
    assert set(snap.pages) == {"k", "v"}
    assert snap.pages["k"][0].dtype == np.float32
    # the donor's pages: requantizing the dequantized payload gives back
    # the int8 page within one quantum and the scale within f32 rounding
    rows = donor.cache.seq_page_ids(rid)[:snap.num_pages]
    raw = donor._page_gather(rows)
    for side in ("k", "v"):
        for layer, fp in enumerate(snap.pages[side]):
            q0 = raw[side][layer].numpy()
            s0 = raw[f"{side}_scale"][layer].numpy()
            for i in range(len(rows)):
                np.testing.assert_array_equal(
                    fp[i], dequantize_kv_page(q0[i], s0[i]))
                q1, s1 = quantize_kv_page(fp[i])
                np.testing.assert_allclose(s1, s0[i], rtol=1e-6)
                assert np.abs(q1.astype(int) - q0[i]).max() <= 1
    want = _uninterrupted(_engine(survivor, models, None, "int8_dynamic"),
                          prompt)
    res = jax_res if survivor == "jax" else port_res
    surv = _engine(survivor, models, None, "int8_dynamic")
    surv.restore(res.EngineSnapshot.from_state(snap.to_state()))
    np.testing.assert_array_equal(surv.drain()[rid], want)


# =============================================================================
# mesh shapes and the drafter's lane state
# =============================================================================
@pytest.fixture
def eight_slots():
    prev = force_device_count(8)
    yield
    force_device_count(prev)


@pytest.mark.parametrize("donor_axes,survivor_axes",
                         [({"tp": 2, "sp": 2}, None),
                          (None, {"tp": 2, "sp": 2})],
                         ids=["mesh_to_single", "single_to_mesh"])
def test_snapshot_portable_across_mesh_shapes(port, prompt, eight_slots,
                                              donor_axes, survivor_axes):
    kw = dict(ENGINE, device="cpu", num_pages=32)
    want = _uninterrupted(ServingEngine(port, **kw), prompt)
    donor = ServingEngine(port, mesh_axes=donor_axes, **kw)
    rid = donor.add_request(prompt, max_new_tokens=BUDGET)
    _run_until(donor, rid, 5)
    snap = donor.snapshot(rid)
    surv = ServingEngine(port, mesh_axes=survivor_axes, **kw)
    ptrs = [t.data_ptr() for pools in surv._pool_dicts()
            for side in pools.values() for t in side]
    surv.restore(snap)
    np.testing.assert_array_equal(surv.drain()[rid], want)
    # the upload wrote the pools in place
    assert ptrs == [t.data_ptr() for pools in surv._pool_dicts()
                    for side in pools.values() for t in side]
    assert surv.cache.pages_in_use == 0


def test_spec_lane_state_travels(port):
    prompt = np.tile(np.arange(3, 9, dtype=np.int32), 4)
    kw = dict(ENGINE, device="cpu", spec_decode=4)
    want = _uninterrupted(ServingEngine(port, **kw), prompt, budget=16)
    donor = ServingEngine(port, **kw)
    rid = donor.add_request(prompt, max_new_tokens=16)
    _run_until(donor, rid, 6)
    snap = donor.snapshot(rid)
    assert snap.spec and snap.spec == donor.spec.drafter.export_lane(rid)
    surv = ServingEngine(port, **kw)
    surv.restore(port_res.EngineSnapshot.from_state(snap.to_state()))
    # the resumed admission seeds the drafter with the donor's lane state
    seq = Sequence(surv.scheduler.waiting[0])
    surv.spec.on_admit(seq)
    assert surv.spec.drafter.export_lane(rid) == snap.spec
    surv.spec.on_drop(rid)
    np.testing.assert_array_equal(surv.drain()[rid], want)


# =============================================================================
# refusals and metrics
# =============================================================================
def test_refusals(port, prompt):
    eng = ServingEngine(port, device="cpu", **ENGINE)
    assert eng.snapshot("nope") is None
    rid = eng.add_request(prompt, max_new_tokens=BUDGET)
    assert eng.snapshot(rid) is None                   # queued
    eng.step()
    assert rid in eng._prefill_plans
    assert eng.snapshot(rid) is None                   # mid prefill plan
    _run_until(eng, rid, 2)
    snap = eng.snapshot(rid)
    assert snap is not None
    other_ps = ServingEngine(port, device="cpu", page_size=8,
                             max_batch_size=4, eos_id=-1)
    with pytest.raises(InvalidArgumentError, match="page_size"):
        other_ps.restore(snap)
    other_mode = ServingEngine(port, device="cpu", kv_cache_dtype="int8",
                               **ENGINE)
    with pytest.raises(InvalidArgumentError, match="kv_mode"):
        other_mode.restore(snap)
    with pytest.raises(ValueError, match="in flight"):
        eng.restore(snap)


def test_snapshot_and_restore_metrics(port, prompt):
    eng = ServingEngine(port, device="cpu", **ENGINE)
    rid = eng.add_request(prompt, max_new_tokens=BUDGET)
    _run_until(eng, rid, 3)
    snap = eng.snapshot(rid)
    m = eng.metrics.snapshot()
    assert m["snapshots"] == 1 and m["snapshot_bytes"] == snap.nbytes > 0
    assert stat_registry.get("serving.snapshots").get() == 1
    eng.abort(rid)
    eng.restore(snap)
    eng.drain()
    assert eng.metrics.snapshot()["restores"] == 1
    assert eng.cache.pages_in_use == 0


# =============================================================================
# policy objects on the same timed event sequences
# =============================================================================
def _watchdog_trace(res):
    out = []
    cfgs = [dict(min_threshold_s=0.2, hang_timeout_s=5.0, cold_grace_s=60.0,
                 backoff_initial_s=1.0, backoff_max_s=16.0),
            dict(min_threshold_s=0.2, p99_multiplier=0.0,
                 backoff_initial_s=1.0),
            dict(numeric_fault_suspect=2, numeric_fault_dead=3,
                 numeric_fault_window_s=10.0, backoff_initial_s=0.5)]
    rng = np.random.RandomState(3)
    for cfg in cfgs:
        wd = res.Watchdog(res.WatchdogConfig(**cfg))
        t = 0.0
        out.append(wd.check("r0", busy_for=30.0, now=t))       # cold
        for i in range(40):
            t += float(rng.uniform(0.05, 1.5))
            ev = rng.randint(5)
            if ev == 0:
                wd.observe_step("r0", float(rng.uniform(0.001, 0.6)),
                                now=t)
            elif ev == 1:
                wd.note_numeric_fault("r0", now=t)
            busy = None if ev == 2 else float(rng.uniform(0.0, 7.0))
            out.append((wd.check("r0", busy_for=busy, now=t),
                        wd.threshold_s("r0"), wd.backoff_s("r0"),
                        wd.trips("r0"), wd.numeric_faults("r0", now=t)))
    return out


def test_watchdog_matches_jax():
    got, want = _watchdog_trace(port_res), _watchdog_trace(jax_res)
    assert got == want
    verdicts = {v[0] if isinstance(v, tuple) else v for v in got}
    assert {"ok", "suspect", "dead", "readmit"} <= verdicts


def _brownout_trace(res, registry):
    out = []
    pols = [dict(sustain_evals=3), dict(sustain_evals=2),
            dict(sustain_evals=2, sustain_s=0.5),
            dict(shed_at=0.6, release_margin=0.1, sustain_evals=1)]
    rng = np.random.RandomState(4)
    for pol in pols:
        bc = res.BrownoutController(res.BrownoutPolicy(**pol))
        t = 10.0
        for _ in range(60):
            t += float(rng.uniform(0.0001, 0.3))
            p = float(np.clip(rng.normal(0.7, 0.25), 0.0, 1.3))
            out.append((bc.evaluate(p, now=t), bc.stage_name,
                        registry.get("serving.brownout_stage").get()))
    return out


def test_brownout_matches_jax():
    from paddle_tpu_torch.profiler.flight_recorder import recorder

    recorder.reset()
    got = _brownout_trace(port_res, stat_registry)
    want = _brownout_trace(jax_res, jax_registry)
    assert got == want
    # every stage change lands in the recorder's transitions ring (each
    # policy's controller starts at stage 0, 60 samples apiece)
    stages = [s for s, _, _ in got]
    changes = [s for i, s in enumerate(stages)
               if s != (0 if i % 60 == 0 else stages[i - 1])]
    assert [t["target"] for t in recorder.transitions()
            if t["kind"] == "brownout.stage"] == \
        [port_res.BROWNOUT_STAGES[s] for s in changes]
    assert {s for s, _, _ in got} == set(port_res.BROWNOUT_STAGES)
    assert [(s, g) for s, _, g in got] == [(s, s) for s, _, _ in got]


def test_metric_hooks_match_jax():
    """The resilience, prefix and brownout hooks fed the same events
    count what paddle_tpu's ``ServingMetrics`` and, for the brownout
    counters, its ``FrontendMetrics`` count."""
    from paddle_tpu.serving.metrics import FrontendMetrics
    from paddle_tpu.serving.metrics import ServingMetrics as JaxMetrics
    from paddle_tpu_torch.serving import ServingMetrics
    from paddle_tpu_torch.serving.metrics import (
        FrontendMetrics as PortFrontendMetrics)

    def feed(m, fm):
        m.on_snapshot(1234)
        m.on_snapshot(77)
        m.on_restore()
        m.on_watchdog_trip(2)
        m.on_retry_backoff()
        m.on_failover_recovery(0.25)
        m.on_prefix_hit(32)
        m.on_prefix_hit(16)
        m.on_prefix_miss()
        m.on_prefix_evict(3)
        m.on_prefix_cow()
        m.set_prefix_cached_tokens(96)
        fm.on_brownout_shed()
        fm.on_brownout_clamp()
        fm.on_brownout_clamp()
        fm.on_brownout_reject()

    jm = JaxMetrics()
    jfm = FrontendMetrics()
    feed(jm, jfm)
    pm = ServingMetrics()
    pfm = PortFrontendMetrics()
    feed(pm, pfm)
    want, got = jm.snapshot(), pm.snapshot()
    for key in ("snapshots", "restores", "watchdog_trips",
                "retries_backoff", "brownout_stage", "snapshot_bytes"):
        assert got[key] == want[key], key
    assert got["prefix"] == {k: want["prefix"][k] for k in got["prefix"]}
    assert got["failover_recovery_ms"]["count"] == \
        want["failover_recovery_ms"]["count"] == 1
    fsnap, psnap = jfm.snapshot(), pfm.snapshot()
    assert {k: psnap[f"brownout_{k}"]
            for k in ("shed", "clamped", "rejected")} == \
        {k: fsnap[f"brownout_{k}"] for k in ("shed", "clamped", "rejected")}
