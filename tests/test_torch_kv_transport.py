"""The tiered KV transport of paddle_tpu_torch (``serving/kv_transport.py``,
the prefix cache's demotion hook and ``promote_for``, the engine's tier
closures and admission window) vs paddle_tpu.

- the host units — ``HostTier``, ``DiskTier`` (over each package's own
  ``CheckpointStore``) and ``PageTransport``'s policy — run the same
  numpy fakes through both packages and give equal results: spill order,
  hits and misses, the corrupt-slot miss, the collision guard, the
  chaos denials and the ``stats()`` dicts;
- both packages' engines on one schedule (demote then promote, ragged
  and split, native and int8_static, the disk tier, torn disk slots,
  churn, seeded chaos) stream equal tokens, report equal
  ``stats()["prefix_cache"]`` (its ``tiers`` section included), and the
  port's tier-on stream equals its own tier-off stream;
- steady decode after a promotion makes no tier call and captures no
  program (the sync check is the card test's);
- a tp 2 x sp 2 mesh engine with tiers streams what the single-slot
  engine streams, and the pools keep their storage;
- a bfloat16 pool's pages round-trip bit for bit as their 16-bit
  pattern.

Streams are compared token for token (greedy, f32 on the CPU).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.framework.errors import (
    InvalidArgumentError as JaxInvalidArgument,
    PageTransportError as JaxPageTransportError)
from paddle_tpu.io.checkpoint import CheckpointStore as JaxStore
from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import kv_transport as jax_kvt
from paddle_tpu.slim import export_serving_quant as jax_export
from paddle_tpu.testing import chaos as jax_chaos
from paddle_tpu_torch.distributed import force_device_count
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               PageTransportError)
from paddle_tpu_torch.io.checkpoint import CheckpointStore
from paddle_tpu_torch.profiler.jit_cost import compile_budget
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import kv_transport as port_kvt
from paddle_tpu_torch.testing import chaos as port_chaos
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 50
ENGINE = dict(page_size=4, max_batch_size=4, prefill_chunk=4, eos_id=-1)

# (kv_transport module, CheckpointStore, chaos module, InvalidArgument,
# PageTransportError) of each package
PACKAGES = {
    "jax": (jax_kvt, JaxStore, jax_chaos, JaxInvalidArgument,
            JaxPageTransportError),
    "port": (port_kvt, CheckpointStore, port_chaos, InvalidArgumentError,
             PageTransportError),
}


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


@pytest.fixture(scope="module")
def quant(shared_gpt_small):
    """paddle_tpu's export, loaded unchanged by the port."""
    calib = np.random.RandomState(10).randint(1, VOCAB, (4, 12))
    return jax_export(shared_gpt_small, calib_prompts=calib.astype(np.int32))


def _invariant(cache):
    assert (cache.pages_in_use + cache.pages_cached + cache.free_pages
            == cache.allocatable_pages)


def _payload(seed):
    rng = np.random.RandomState(seed)
    return {"k": [rng.rand(2, 2, 2).astype(np.float32)],
            "v": [rng.rand(2, 2, 2).astype(np.float32)]}


def _plain(x):
    """Payloads, keys and lists as nested python values (comparable
    across packages)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    return x


# =============================================================================
# host units: the same numpy fakes through both packages
# =============================================================================
def _host_tier(pkg, tmp):
    kvt, _, _, Invalid, _ = pkg
    t = kvt.HostTier(2)
    log = [t.put((1,), _payload(1)), t.put((2,), _payload(2))]
    t.get((1,))                          # refresh: (2,) is now LRU
    log += [t.put((3,), _payload(3)), (1,) in t, (3,) in t, (2,) in t,
            t.nbytes(), len(t)]
    z = kvt.HostTier(0)
    log += [z.put((9,), _payload(4)), len(z)]
    try:
        kvt.HostTier(-1)
        log.append("no raise")
    except Invalid:
        log.append("raised")
    return log


def _disk_tier(pkg, tmp):
    kvt, Store, _, _, _ = pkg
    t = kvt.DiskTier(Store(str(tmp), keep_last=64), capacity_pages=2)
    t.put((1, 2), _payload(5))
    t.put((3, 4), _payload(6))
    log = [t.get((1, 2))]
    t.put((5, 6), _payload(7))           # capacity 2: the oldest retired
    log += [t.get((1, 2)), len(t), sorted(t._names)]
    # a slot whose stored chain is another key's (the collision shape)
    t._names[(9, 9)] = t._names[(3, 4)]
    log.append(t.get((9, 9)))
    return log


def _corrupt_slot(pkg, tmp):
    kvt, Store, _, _, _ = pkg
    store = Store(str(tmp), keep_last=64)
    t = kvt.DiskTier(store, capacity_pages=4)
    t.put((1, 2, 3), _payload(8))
    name = t._names[(1, 2, 3)]
    with open(store._slot_path(name), "wb") as f:
        f.write(b"torn")
    return [name, t.get((1, 2, 3)), (1, 2, 3) in t._names,
            name in store.named()]


def _window_spill_fetch(pkg, tmp):
    kvt, Store, _, _, _ = pkg
    payloads = {1: _payload(11), 2: _payload(12), 3: _payload(13)}
    tr = kvt.PageTransport(lambda ids: [payloads[i] for i in ids],
                           lambda ids, ps: None, host_pages=1,
                           disk_store=Store(str(tmp), keep_last=64),
                           disk_pages=8)
    log = [tr.demote((1,), 1), tr.stats()]         # window closed
    tr.demote_window = True
    log += [tr.demote((1,), 1), tr.demote((2,), 2), tr.host_pages,
            tr.disk_pages, tr.fetch((1,)), tr.disk_hits, tr.fetch((7,)),
            tr.fetch((2,)), tr.demote((3,), 3), tr.stats()]
    return log


def _gather_restore_failures(pkg, tmp):
    kvt, _, _, Invalid, TransportError = pkg

    def boom(_ids):
        raise RuntimeError("gather broke")

    tr = kvt.PageTransport(boom, lambda ids, ps: boom(ids), host_pages=4)
    tr.demote_window = True
    log = [tr.demote((1,), 1), tr.demote_denied]
    for call in (lambda: tr.restore_page(3, _payload(14)),
                 lambda: kvt.PageTransport(boom, boom, disk_pages=4)):
        try:
            call()
            log.append("no raise")
        except TransportError:
            log.append("PageTransportError")
        except Invalid:
            log.append("InvalidArgumentError")
    return log + [tr.stats()]


def _chaos_deny(pkg, tmp):
    kvt, _, chaos, _, _ = pkg
    payloads = {1: _payload(15)}
    tr = kvt.PageTransport(lambda ids: [payloads[i] for i in ids],
                           lambda ids, ps: None, host_pages=4)
    tr.demote_window = True
    plan = chaos.ChaosPlan([chaos.Fault("kv.demote", at=1, action="deny"),
                            chaos.Fault("kv.promote", at=1, action="deny")],
                           name="tier-deny")
    with chaos.running(plan):
        log = [tr.demote((1,), 1), tr.demote((1,), 1), tr.fetch((1,)),
               tr.fetch((1,))]
    return log + [sorted(e["site"] for e in plan.fired_log()), tr.stats()]


def _chain_keys(pkg, tmp):
    kvt = pkg[0]
    keys = [kvt.chain_key(np.asarray([3, 4], np.int32)),
            kvt.chain_key([3, 4]), kvt.chain_key(np.arange(6).reshape(2, 3))]
    return keys + [kvt._key_name(k) for k in keys] + [
        kvt.payload_nbytes(_payload(1))]


UNITS = {f.__name__.lstrip("_"): f for f in (
    _host_tier, _disk_tier, _corrupt_slot, _window_spill_fetch,
    _gather_restore_failures, _chaos_deny, _chain_keys)}


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_host_units_match_jax(unit, tmp_path):
    logs = {}
    for name, pkg in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        logs[name] = _plain(UNITS[unit](pkg, d))
    assert logs["port"] == logs["jax"]


# =============================================================================
# both packages' engines on one schedule
# =============================================================================
def _evict_all(eng):
    """Demote every cached page through the admission window (the window
    the engine opens around ``Scheduler.admit``)."""
    eng.kv_transport.demote_window = True
    try:
        return eng.prefix_cache.evict(eng.cache.pages_cached)
    finally:
        eng.kv_transport.demote_window = False


def _prompts(seed, prefix_len, suffixes):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, VOCAB, (prefix_len,)).astype(np.int32)
    return prefix, [np.concatenate([prefix, rng.randint(
        1, VOCAB, (k,)).astype(np.int32)]) for k in suffixes]


def _sc_demote_promote(eng, ctx):
    """Serve A, demote its sealed pages, serve B over A's prefix: B's
    prefix pages promote back."""
    p8, (pb,) = _prompts(31, 8, (5,))
    outs = {}
    eng.add_request(p8, max_new_tokens=6, request_id="a")
    outs.update(eng.drain())
    if eng.kv_transport is not None:
        assert _evict_all(eng) >= 2
        assert eng.cache.pages_cached == 0
        _invariant(eng.cache)
    eng.add_request(pb, max_new_tokens=6, request_id="b")
    outs.update(eng.drain())
    return outs


def _sc_disk_spill(eng, ctx):
    """host_pages=1: the demotions spill to disk, B's promotion hits it."""
    return _sc_demote_promote(eng, ctx)


def _sc_torn_disk(eng, ctx):
    """Every disk slot torn and the host tier emptied: each fetch misses,
    B re-prefills."""
    p8, (pb,) = _prompts(33, 8, (5,))
    outs = {}
    eng.add_request(p8, max_new_tokens=6, request_id="a")
    outs.update(eng.drain())
    if eng.kv_transport is not None:
        assert _evict_all(eng) >= 2
        store = eng.kv_transport.disk.store
        for name in store.named():
            with open(store._slot_path(name), "wb") as f:
                f.write(b"torn")
        eng.kv_transport.host._entries.clear()
    eng.add_request(pb, max_new_tokens=6, request_id="b")
    outs.update(eng.drain())
    return outs


def _sc_churn(eng, ctx):
    """Demote / promote / re-demote rounds; the leak invariant at every
    boundary."""
    rng = np.random.RandomState(34)
    prompts = [rng.randint(1, VOCAB, (8,)).astype(np.int32)
               for _ in range(3)]
    outs = {}
    for round_ in range(2):
        for i, p in enumerate(prompts):
            eng.add_request(p, max_new_tokens=4,
                            request_id=f"r{round_}-{i}")
            outs.update(eng.drain())
            _invariant(eng.cache)
        if eng.kv_transport is not None:
            assert _evict_all(eng) > 0 and eng.cache.pages_cached == 0
            _invariant(eng.cache)
    return outs


def _sc_chaos(eng, ctx):
    """Seeded ``kv.demote`` / ``kv.promote`` denials under each package's
    own chaos module."""
    p8, prompts = _prompts(35, 8, (2, 5, 3))
    chaos = ctx["chaos"]
    plan = chaos.ChaosPlan([chaos.Fault("kv.demote", at=3, action="deny"),
                            chaos.Fault("kv.promote", at=2, action="deny")],
                           name="tier-chaos")
    outs = {}
    with chaos.running(plan):
        eng.add_request(p8, max_new_tokens=6, request_id="seed")
        outs.update(eng.drain())
        if eng.kv_transport is not None:
            _evict_all(eng)
        for i, p in enumerate(prompts):
            eng.add_request(p, max_new_tokens=6, request_id=f"r{i}")
            outs.update(eng.drain())
            if eng.kv_transport is not None:
                _evict_all(eng)
    ctx["fired"] = sorted(e["site"] for e in plan.fired_log())
    return outs


def _sc_admission_pressure(eng, ctx):
    """A 13-page pool (12 allocatable): two prompts over one 12-token
    prefix, then one 45-token prompt whose admission needs every page —
    it evicts the first wave's cached pages INSIDE the engine's own
    admission window (no manual demotion) — then the first wave again,
    whose admission promotes its prefix back."""
    _, wave1 = _prompts(36, 12, (1, 2))
    wave2 = [np.random.RandomState(37).randint(1, VOCAB, (45,)).astype(
        np.int32)]
    outs = {}
    for w, wave in enumerate((wave1, wave2, wave1)):
        for i, p in enumerate(wave):
            eng.add_request(p, max_new_tokens=3, request_id=f"w{w}-{i}")
        outs.update(eng.drain())
        _invariant(eng.cache)
    return outs


DISK = object()        # stands for dict(host_pages=1, disk_dir=<tmp>, ...)
# name -> (scenario, tier option, engine knobs)
SCHEDULES = {
    "demote_promote": (_sc_demote_promote, True, {}),
    "demote_promote_split": (_sc_demote_promote, True, {"ragged": False}),
    "int8_static_scale_rows": (_sc_demote_promote, True, {"int8": True}),
    "disk_spill_hit": (_sc_disk_spill, DISK, {}),
    "torn_disk_is_miss": (_sc_torn_disk, DISK, {}),
    "churn_zero_leak": (_sc_churn, True, {}),
    "seeded_chaos": (_sc_chaos, True, {}),
    "admission_pressure": (_sc_admission_pressure, {"host_pages": 8},
                           dict(num_pages=13)),
}


def _knobs(knobs, quant):
    kw = dict(ENGINE, **{k: v for k, v in knobs.items() if k != "int8"})
    if knobs.get("int8"):
        kw.update(kv_cache_dtype="int8", quant_scales=quant)
    return kw


def _tiering(option, tmp):
    if option is DISK:
        return dict(host_pages=1, disk_dir=str(tmp), disk_pages=16)
    return option


def _drive(make, scenario, chaos, tmp):
    ctx = {"chaos": chaos}
    eng = make(tmp)
    outs = scenario(eng, ctx)
    # the registry is process-wide: read it before the next engine
    prefix = eng.metrics.snapshot()["prefix"]
    return eng, outs, prefix, ctx


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_engine_schedule_matches_jax(shared_gpt_small, port, quant, name,
                                     tmp_path):
    scenario, option, knobs = SCHEDULES[name]
    kw = _knobs(knobs, quant)
    jax_eng, want, jm, jctx = _drive(
        lambda d: JaxEngine(shared_gpt_small, prefix_cache=True,
                            kv_tiering=_tiering(option, d), **kw),
        scenario, jax_chaos, tmp_path / "jax")
    eng, got, m, ctx = _drive(
        lambda d: ServingEngine(port, prefix_cache=True, device="cpu",
                                kv_tiering=_tiering(option, d), **kw),
        scenario, port_chaos, tmp_path / "port")
    off = _drive(
        lambda d: ServingEngine(port, prefix_cache=True, device="cpu",
                                **kw), scenario, port_chaos, None)[1]
    assert sorted(got) == sorted(want) == sorted(off)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
        np.testing.assert_array_equal(got[rid], off[rid], err_msg=rid)
    st, jst = eng.stats()["prefix_cache"], jax_eng.stats()["prefix_cache"]
    assert st == jst
    assert m == {k: jm[k] for k in m}
    assert ctx.get("fired") == jctx.get("fired")
    _invariant(eng.cache)
    assert eng.cache.pages_in_use == 0 and not eng.prefix_cache.unwritten
    tiers = st["tiers"]
    if name == "torn_disk_is_miss":
        assert tiers["promotions"] == 0 and st["hits"] == 0
    elif name == "seeded_chaos":
        assert ctx["fired"] == ["kv.demote", "kv.promote"]
        assert tiers["demote_denied"] > 0 and tiers["promotions"] > 0
    else:
        assert tiers["demotions"] > 0 and tiers["promotions"] > 0
    if name == "disk_spill_hit":
        assert tiers["disk_hits"] > 0 and tiers["host_pages"] == 1
    if name == "admission_pressure":
        # demotions came from the engine's own admission window
        assert st["evictions"] > 0
        assert tiers["demotions"] + tiers["demote_denied"] == \
            st["evictions"]


def test_seeded_chaos_double_drive_deterministic(port):
    """An identical plan replays to identical streams and tier stats."""
    runs = []
    for _ in range(2):
        eng = ServingEngine(port, prefix_cache=True, kv_tiering=True,
                            device="cpu", **ENGINE)
        ctx = {"chaos": port_chaos}
        runs.append((_sc_chaos(eng, ctx), eng.kv_transport.stats(),
                     ctx["fired"]))
        _invariant(eng.cache)
    (a, sa, fa), (b, sb, fb) = runs
    assert sa == sb and fa == fb
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid], err_msg=rid)


def test_tiers_cut_prefill_rows(port):
    """The promoted prefix is not prefilled again: wave 3 of the
    admission-pressure drive carries fewer prefill rows with tiers."""
    rows = {}
    for tiering in (False, {"host_pages": 8}):
        eng = ServingEngine(port, prefix_cache=True, kv_tiering=tiering,
                            device="cpu", **dict(ENGINE, num_pages=13))
        _sc_admission_pressure(eng, {})
        rows[bool(tiering)] = eng.stats()["metrics"]["ragged"][
            "prefill_rows"]
    assert rows[True] < rows[False]


def test_steady_decode_makes_no_tier_call_and_no_capture(port):
    """After promotion-fed admissions, steady decode calls neither tier
    closure and captures no program: demotion and promotion live at
    admission only."""
    rng = np.random.RandomState(36)
    prefix = rng.randint(1, VOCAB, (9,)).astype(np.int32)
    eng = ServingEngine(port, page_size=4, max_batch_size=4, eos_id=-1,
                        prefix_cache=True, kv_tiering=True, device="cpu")
    eng.add_request(np.concatenate([prefix, [7]]).astype(np.int32),
                    max_new_tokens=4, request_id="warm")
    eng.drain()
    assert _evict_all(eng) > 0
    calls = []
    tr = eng.kv_transport
    gather, restore = tr._gather, tr._restore
    tr._gather = lambda *a: calls.append("gather") or gather(*a)
    tr._restore = lambda *a: calls.append("restore") or restore(*a)
    for i in range(4):
        sfx = rng.randint(1, VOCAB, (2 + i,)).astype(np.int32)
        eng.add_request(np.concatenate([prefix, sfx]), max_new_tokens=24,
                        request_id=f"s{i}")
    while eng.scheduler.waiting or eng._prefill_plans:
        eng.step()
    for _ in range(2):          # the steady signature's first call, then
        eng.step()              # its first replay
    assert tr.promotions > 0 and "restore" in calls
    seen = len(calls)
    with compile_budget(0, prefix="serving."):
        for _ in range(8):
            assert eng.step()["bucket"] == 4
    assert len(calls) == seen
    eng.drain()
    assert eng.cache.pages_in_use == 0
    _invariant(eng.cache)


def test_bf16_pool_round_trips_as_its_bit_pattern():
    """A bfloat16 pool's page travels as int16 (numpy has no bfloat16)
    and comes back bit for bit; a payload of another dtype is refused."""
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu",
                 dtype=torch.bfloat16, seed=3)
    eng = ServingEngine(m, prefix_cache=True, kv_tiering=True,
                        device="cpu", **ENGINE)
    pools = eng._kv
    assert pools["k"][0].dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    for side in ("k", "v"):
        for pool in pools[side]:
            pool.copy_(torch.randn(pool.shape, generator=gen))
    (payload,) = eng._tier_gather([3])
    assert {a.dtype for arrs in payload.values() for a in arrs} == {
        np.dtype(np.int16)}
    before = {side: [p[3].clone() for p in pools[side]] for side in pools}
    eng._tier_restore([5], [payload])
    for side in ("k", "v"):
        for pool, was in zip(pools[side], before[side]):
            assert torch.equal(pool[5].view(torch.int16),
                               was.view(torch.int16))
    wrong = {k: [a.astype(np.float32) for a in v]
             for k, v in payload.items()}
    with pytest.raises(InvalidArgumentError, match="does not fit"):
        eng._tier_restore([6], [wrong])


# =============================================================================
# the mesh replica
# =============================================================================
@pytest.fixture
def eight_slots():
    prev = force_device_count(8)
    yield
    force_device_count(prev)


def _pool_ptrs(eng):
    return [t.data_ptr() for pools in eng._pool_dicts()
            for side in pools.values() for t in side]


def test_mesh_with_tiers_equals_single_slot(port, eight_slots):
    single = ServingEngine(port, prefix_cache=True, kv_tiering=True,
                           device="cpu", **ENGINE)
    want = _sc_demote_promote(single, {})
    mesh = ServingEngine(port, prefix_cache=True, kv_tiering=True,
                         device="cpu", mesh_axes={"tp": 2, "sp": 2},
                         num_pages=16, **ENGINE)
    ptrs = _pool_ptrs(mesh)
    got = _sc_demote_promote(mesh, {})
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    assert _pool_ptrs(mesh) == ptrs
    tiers = mesh.stats()["prefix_cache"]["tiers"]
    assert tiers == single.stats()["prefix_cache"]["tiers"]
    assert tiers["promotions"] == 2
    _invariant(mesh.cache)
    assert mesh.cache.pages_in_use == 0


# =============================================================================
# the knob
# =============================================================================
def test_tiering_knob_validation(port, tmp_path):
    for kw in (dict(kv_tiering=True),                        # no index
               dict(prefix_cache=True, kv_tiering="on"),
               dict(prefix_cache=True, kv_tiering=dict(host_mb=1)),
               dict(prefix_cache=True, kv_tiering=dict(disk_pages=4))):
        with pytest.raises(InvalidArgumentError):
            ServingEngine(port, device="cpu", **kw, **ENGINE)
    eng = ServingEngine(port, device="cpu", prefix_cache=True,
                        kv_tiering=dict(host_pages=3, disk_dir=str(tmp_path),
                                        disk_pages=5), **ENGINE)
    tiers = eng.stats()["prefix_cache"]["tiers"]
    assert (tiers["host_capacity"], tiers["disk_capacity"]) == (3, 5)


def test_int8_dynamic_bypass_and_off_default(port):
    dyn = ServingEngine(port, kv_cache_dtype="int8", prefix_cache=True,
                        kv_tiering=True, device="cpu", **ENGINE)
    assert dyn.prefix_cache is None and dyn.kv_transport is None
    off = ServingEngine(port, prefix_cache=True, device="cpu", **ENGINE)
    assert off.kv_transport is None
    assert "tiers" not in off.prefix_cache.stats()
