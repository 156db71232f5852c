"""The prefix cache of paddle_tpu_torch (``serving/prefix_cache.py``, the
refcounted ``PagedKVCache``, prefix admission in the scheduler and the
engine's copy-on-write, sealing and write barrier) vs paddle_tpu.

- the same operation sequences through both packages' ``PagedKVCache``
  and ``PrefixCache`` (share, copy-on-write, a chaos-denied copy,
  exhaustion, reclaim before failing, longest match, first publisher
  wins, leaf-first LRU eviction, referenced pages never evicted) give
  equal results, refcounts and accounting, and the leak invariant
  ``pages_in_use + pages_cached + free_pages == allocatable_pages``
  holds after every operation;
- both packages' engines driven on one schedule (shared-prefix skip in
  native and int8_static, full-prompt copy-on-write, sharing within one
  batch, retirement sealing generated tokens, the per-request opt-out,
  the int8_dynamic bypass, abort and deadline expiry of a shared reader,
  preemption under a tight pool, the split and fused programs, and
  speculative decoding) stream the same
  tokens, report the same ``stats()["prefix_cache"]`` and the same page
  accounting, and the port's stream equals its own cache-off engine's;
- a tp 2 x sp 2 mesh engine with the cache on streams what the port's
  single-slot engine streams, and the pools keep their storage across
  the copy-on-write (``data_ptr`` unchanged).

Streams are compared token for token (greedy, f32 on the CPU).
"""
import time

import numpy as np
import pytest

from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxCache
from paddle_tpu.serving.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.slim import export_serving_quant as jax_export
from paddle_tpu.testing import chaos as jax_chaos
from paddle_tpu_torch.distributed import force_device_count
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.serving import (PagedKVCache, PrefixCache,
                                      ServingEngine)
from paddle_tpu_torch.testing import chaos as port_chaos
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 50
ENGINE = dict(page_size=4, max_batch_size=4, prefill_chunk=4, eos_id=-1)


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


# =============================================================================
# host units: the same operation sequences through both packages
# =============================================================================
def _share(C, PC, chaos):
    c = C(num_pages=17, page_size=4, pages_per_seq=8)
    log = [c.allocate("a", 12)]
    pages = c.seq_page_ids("a")
    for p in pages:
        c.pin_cached(p)
    log += [c.share("b", pages[:2]), c.allocate("b", 12),
            c.seq_page_ids("b"), c.pages_in_use, c.ref_count(pages[0])]
    c.free("a")
    log += [c.ref_count(pages[0]), c.pages_in_use, c.pages_cached]
    c.free("b")
    log += [c.pages_in_use, c.pages_cached]
    for p in pages:
        c.release_cached(p)
    log += [c.free_pages, not c.share("b2", [1] * 9)]
    return c, log


def _cow(C, PC, chaos):
    c = C(num_pages=9, page_size=4, pages_per_seq=4)
    log = [c.allocate("a", 8)]
    pages = c.seq_page_ids("a")
    for p in pages:
        c.pin_cached(p)
    log += [c.share("b", pages), c.cow_page("b", 1), c.seq_page_ids("b"),
            [c.ref_count(p) for p in range(9)], c.stats()["total_cow"]]
    return c, log


def _cow_chaos_denial(C, PC, chaos):
    c = C(num_pages=9, page_size=4, pages_per_seq=4)
    log = [c.allocate("a", 8)]
    pages = c.seq_page_ids("a")
    log.append(c.share("b", pages))
    plan = chaos.ChaosPlan([chaos.Fault("kv.allocate", at=1,
                                        action="deny", match="b")])
    with chaos.running(plan):
        log.append(c.cow_page("b", 1))
    log += [c.seq_page_ids("b"), c.ref_count(pages[1]),
            len(plan.fired_log())]
    return c, log


def _cow_exhaustion(C, PC, chaos):
    c = C(num_pages=3, page_size=4, pages_per_seq=2)
    log = [c.allocate("a", 8)]
    pages = c.seq_page_ids("a")
    log += [c.share("b", pages), c.cow_page("b", 0), c.seq_page_ids("b")]
    return c, log


def _reclaim_before_fail(C, PC, chaos):
    c = C(num_pages=5, page_size=4, pages_per_seq=4)
    pc = PC(c)
    toks = np.arange(1, 9, dtype=np.int32)
    log = [c.allocate("a", 8)]
    log.append(pc.insert(toks, c.seq_page_ids("a"), 2))
    c.free("a")
    log += [c.pages_cached, c.free_pages, c.allocate("big", 16),
            c.free_pages, c.pages_cached, pc.evictions, pc.match(toks)]
    c.free("big")
    log += [c.free_pages, c.pages_cached]
    return c, log


def _longest_match(C, PC, chaos):
    c = C(num_pages=17, page_size=4, pages_per_seq=8)
    pc = PC(c)
    toks = np.arange(1, 13, dtype=np.int32)
    log = [c.allocate("a", 12)]
    pages = c.seq_page_ids("a")
    log.append(pc.insert(toks, pages, 3))
    div = toks.copy()
    div[5] = 49
    log += [pc.match(toks), pc.match(toks[:8]), pc.match(toks[:7]),
            pc.match(toks[:3]), pc.match(div), pc.cached_tokens]
    return c, log


def _first_publisher_wins(C, PC, chaos):
    c = C(num_pages=17, page_size=4, pages_per_seq=8)
    pc = PC(c)
    toks = np.arange(1, 9, dtype=np.int32)
    log = [c.allocate("a", 8), pc.insert(toks, c.seq_page_ids("a"), 2),
           c.allocate("b", 8), pc.insert(toks, c.seq_page_ids("b"), 2),
           pc.match(toks)]
    c.free("b")
    log.append(c.free_pages)
    return c, log


def _lru_leaf_first(C, PC, chaos):
    c = C(num_pages=17, page_size=4, pages_per_seq=8)
    pc = PC(c)
    chain = np.arange(1, 13, dtype=np.int32)
    other = np.arange(20, 28, dtype=np.int32)
    log = [c.allocate("a", 12)]
    pa = c.seq_page_ids("a")
    log += [pc.insert(chain, pa, 3), c.allocate("b", 8)]
    log.append(pc.insert(other, c.seq_page_ids("b"), 2))
    c.free("a")
    c.free("b")
    pc.match(chain)                       # the chain is the most recent
    log += [pc.evict(1), pc.match(chain), pc.match(other), pc.evict(10),
            pc.match(chain), pc.match(other), c.free_pages,
            pc.stats()]
    return c, log


def _referenced_never_evicted(C, PC, chaos):
    c = C(num_pages=9, page_size=4, pages_per_seq=4)
    pc = PC(c)
    toks = np.arange(1, 9, dtype=np.int32)
    log = [c.allocate("a", 8)]
    log += [pc.insert(toks, c.seq_page_ids("a"), 2), pc.evict(8),
            pc.match(toks), c.is_free(1), [c.is_free(p) for p in range(9)]]
    c.free("a")
    log += [[c.is_free(p) for p in range(9)], pc.invalidate_pages([1, 2]),
            c.free_pages]
    return c, log


UNITS = [_share, _cow, _cow_chaos_denial, _cow_exhaustion,
         _reclaim_before_fail, _longest_match, _first_publisher_wins,
         _lru_leaf_first, _referenced_never_evicted]


@pytest.mark.parametrize("unit", UNITS, ids=lambda f: f.__name__[1:])
def test_cache_and_index_units_match_jax(unit):
    jc, want = unit(JaxCache, JaxPrefixCache, jax_chaos)
    pc, got = unit(PagedKVCache, PrefixCache, port_chaos)
    assert got == want
    _invariant(pc)
    stats_keys = ("num_pages", "pages_in_use", "pages_cached", "pages_free",
                  "num_seqs", "total_allocs", "total_frees",
                  "total_shared_maps", "total_cow", "peak_pages_in_use")
    assert {k: pc.stats()[k] for k in stats_keys} == \
        {k: jc.stats()[k] for k in stats_keys}


def test_share_checks_residency_and_range():
    c = PagedKVCache(num_pages=9, page_size=4, pages_per_seq=4)
    with pytest.raises(InvalidArgumentError, match="resident"):
        c.share("s", [3])
    with pytest.raises(InvalidArgumentError, match="reserved"):
        c.share("s", [0])
    c.pin_cached(3)                     # index custody makes it shareable
    assert c.share("s", [3]) and c.ref_count(3) == 1


# =============================================================================
# engines on one schedule
# =============================================================================
def _rng_prompts(seed, prefix_len, suffixes):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, VOCAB, (prefix_len,)).astype(np.int32)
    return [np.concatenate([prefix, rng.randint(1, VOCAB, (k,)).astype(
        np.int32)]) for k in suffixes]


def _drain(eng, outs):
    outs.update(eng.drain())


def _sc_shared_skip(eng):
    pa, pb = _rng_prompts(5, 9, (3, 5))
    outs = {}
    eng.add_request(pa, max_new_tokens=10, request_id="a")
    _drain(eng, outs)
    eng.add_request(pb, max_new_tokens=10, request_id="b")
    _drain(eng, outs)
    return outs


def _sc_full_prompt_cow(eng):
    p8 = np.random.RandomState(6).randint(1, VOCAB, (8,)).astype(np.int32)
    outs = {}
    for rid in ("a", "b", "c"):
        eng.add_request(p8.copy(), max_new_tokens=8, request_id=rid)
        _drain(eng, outs)
    return outs


def _sc_intra_batch(eng):
    outs = {}
    for i, p in enumerate(_rng_prompts(7, 9, (2, 3, 4, 0))):
        eng.add_request(p, max_new_tokens=8, request_id=f"r{i}")
    _drain(eng, outs)
    return outs


def _sc_retirement_seals(eng):
    rng = np.random.RandomState(8)
    p5 = rng.randint(1, VOCAB, (5,)).astype(np.int32)
    outs = {}
    eng.add_request(p5, max_new_tokens=12, request_id="a")
    _drain(eng, outs)
    # prompt (5) + the first 7 generated tokens = 3 full pages
    turn2 = np.concatenate([p5, outs["a"][:7],
                            rng.randint(1, VOCAB, (2,)).astype(np.int32)])
    eng.add_request(turn2, max_new_tokens=8, request_id="b")
    _drain(eng, outs)
    return outs


def _sc_opt_out(eng):
    p8 = np.random.RandomState(9).randint(1, VOCAB, (8,)).astype(np.int32)
    outs = {}
    eng.add_request(p8, max_new_tokens=6, request_id="a",
                    prefix_cache=False)
    _drain(eng, outs)
    eng.add_request(p8.copy(), max_new_tokens=6, request_id="b")
    _drain(eng, outs)
    return outs


def _sc_abort_reader(eng):
    pa, pb = _rng_prompts(13, 9, (2, 3))
    outs = {}
    eng.add_request(pa, max_new_tokens=20, request_id="a")
    eng.add_request(pb, max_new_tokens=20, request_id="b")
    for _ in range(5):
        eng.step()
    shared = [p for p in eng.cache.seq_page_ids("a")
              if eng.cache.ref_count(p) == 2]
    assert bool(shared) == (eng.prefix_cache is not None)
    assert eng.abort("b")
    assert [eng.cache.ref_count(p) for p in shared] == [1] * len(shared)
    _drain(eng, outs)
    return outs


def _sc_deadline_reader(eng):
    pa, pb = _rng_prompts(14, 9, (1, 2))
    outs = {}
    eng.add_request(pa, max_new_tokens=16, request_id="a")
    eng.add_request(pb, max_new_tokens=16, request_id="b",
                    deadline=time.monotonic() + 1e9)
    for _ in range(4):
        eng.step()
    next(s for s in eng.scheduler.running
         if s.seq_id == "b").request.deadline = time.monotonic() - 1.0
    eng.step()
    outs["expired"] = np.asarray([eng.take_expired() == ["b"]])
    _drain(eng, outs)
    return outs


def _sc_preemption(eng):
    outs = {}
    for i, p in enumerate(_rng_prompts(15, 9, (2, 3, 4, 5))):
        eng.add_request(p, max_new_tokens=10, request_id=f"r{i}")
    _drain(eng, outs)
    return outs


def _sc_mid_plan_abort(eng):
    """A writer aborted mid-plan: its never-written sealed pages are
    un-published and the barrier-held sharer is recomputed."""
    outs = {}
    prompts = _rng_prompts(16, 17, (3, 2))
    eng.add_request(prompts[0], max_new_tokens=6, request_id="w")
    eng.add_request(prompts[1], max_new_tokens=6, request_id="r")
    eng.step()
    assert eng.abort("w")
    _drain(eng, outs)
    return outs


# name -> (scenario, engine knobs)
SCHEDULES = {
    "shared_skip_native": (_sc_shared_skip, {}),
    "shared_skip_int8_static": (_sc_shared_skip, {"int8": True}),
    "full_prompt_cow": (_sc_full_prompt_cow, {}),
    "intra_batch_same_step": (_sc_intra_batch, {}),
    "retirement_seals_generated": (_sc_retirement_seals, {}),
    "per_request_opt_out": (_sc_opt_out, {}),
    "int8_dynamic_bypass": (_sc_shared_skip, {"kv_cache_dtype": "int8"}),
    "abort_shared_reader": (_sc_abort_reader, {}),
    "deadline_shared_reader": (_sc_deadline_reader, {}),
    "preemption_tight_pool": (_sc_preemption,
                              dict(max_batch_size=3, num_pages=13)),
    "mid_plan_abort": (_sc_mid_plan_abort, dict(prefill_chunk=8)),
    "split_full_prompt_cow": (_sc_full_prompt_cow, {"ragged": False}),
    "fused4_shared_skip": (_sc_shared_skip, {"fused_steps": 4}),
    "spec_intra_batch": (_sc_intra_batch, {"spec_decode": 4}),
    "split_shared_skip_int8_static": (_sc_shared_skip,
                                      {"ragged": False, "int8": True}),
}


def _knobs(knobs, quant):
    kw = dict(ENGINE, **{k: v for k, v in knobs.items() if k != "int8"})
    if knobs.get("int8"):
        kw.update(kv_cache_dtype="int8", quant_scales=quant)
    return kw


def _accounting(eng):
    c = eng.cache
    return {"pages_in_use": c.pages_in_use, "pages_cached": c.pages_cached,
            "free_pages": c.free_pages,
            **{k: c.stats()[k] for k in ("total_allocs", "total_frees",
                                         "total_shared_maps", "total_cow")}}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_engine_schedule_matches_jax(shared_gpt_small, port, quant, name):
    scenario, knobs = SCHEDULES[name]
    kw = _knobs(knobs, quant)
    jax_eng = JaxEngine(shared_gpt_small, prefix_cache=True, **kw)
    want = scenario(jax_eng)
    jm = jax_eng.metrics.snapshot()["prefix"]
    eng = ServingEngine(port, prefix_cache=True, device="cpu", **kw)
    got = scenario(eng)
    # the registry is process-wide: read it before the next engine
    m = eng.metrics.snapshot()["prefix"]
    off = scenario(ServingEngine(port, prefix_cache=False, device="cpu",
                                 **kw))
    assert sorted(got) == sorted(want) == sorted(off)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
        np.testing.assert_array_equal(got[rid], off[rid], err_msg=rid)
    st, jst = eng.stats()["prefix_cache"], jax_eng.stats()["prefix_cache"]
    assert st == {k: jst[k] for k in st}
    assert m == {k: jm[k] for k in m}
    assert _accounting(eng) == _accounting(jax_eng)
    _invariant(eng.cache)
    assert eng.cache.pages_in_use == 0
    assert not eng.prefix_cache or not eng.prefix_cache.unwritten
    if name == "int8_dynamic_bypass":
        assert eng.prefix_cache is None and not st["enabled"]
        assert "int8_dynamic" in st["bypass_reason"]
    elif name == "preemption_tight_pool":
        assert eng.scheduler.num_preemptions > 0
        assert st["evictions"] > 0
    elif "cow" in name:
        assert st["cow_copies"] == 2
    elif name == "mid_plan_abort":
        assert eng.scheduler.num_preemptions == \
            jax_eng.scheduler.num_preemptions == 1


def test_prefix_skip_cuts_prefill_rows(port):
    """The shared-prefix request prefills only its uncached suffix: the
    ragged dispatches carry fewer prefill rows than the cache-off drive."""
    rows = {}
    for pc in (True, False):
        eng = ServingEngine(port, prefix_cache=pc, device="cpu", **ENGINE)
        _sc_shared_skip(eng)
        rows[pc] = eng.stats()["metrics"]["ragged"]["prefill_rows"]
    assert rows[True] < rows[False]


def test_knob_validation(port):
    eng = ServingEngine(port, prefix_cache=True, device="cpu", **ENGINE)
    with pytest.raises(InvalidArgumentError, match="prefix_cache"):
        eng.add_request(np.ones(4, np.int32), prefix_cache="yes")
    with pytest.raises(InvalidArgumentError, match="prefix_cache is off"):
        ServingEngine(port, prefix_cache=False, kv_tiering=True,
                      device="cpu", **ENGINE)
    assert ServingEngine(port, prefix_cache=True, kv_tiering=True,
                         device="cpu", **ENGINE).kv_transport is not None
    with pytest.raises(InvalidArgumentError, match="kv_tiering"):
        ServingEngine(port, prefix_cache=True, kv_tiering="yes",
                      device="cpu", **ENGINE)
    # tiers off: promotion finds nothing to promote
    assert eng.prefix_cache.transport is None
    assert eng.prefix_cache.promote_for(np.ones(8, np.int32)) == 0


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


@pytest.mark.parametrize("scenario", [_sc_full_prompt_cow, _sc_intra_batch],
                         ids=["full_prompt_cow", "intra_batch"])
def test_mesh_with_cache_equals_single_slot(port, eight_slots, scenario):
    single = scenario(ServingEngine(port, prefix_cache=True, device="cpu",
                                    **ENGINE))
    mesh = ServingEngine(port, prefix_cache=True, device="cpu",
                         mesh_axes={"tp": 2, "sp": 2}, num_pages=16,
                         **ENGINE)
    ptrs = _pool_ptrs(mesh)
    got = scenario(mesh)
    assert sorted(got) == sorted(single)
    for rid in single:
        np.testing.assert_array_equal(got[rid], single[rid], err_msg=rid)
    assert _pool_ptrs(mesh) == ptrs
    st = mesh.stats()["prefix_cache"]
    assert st["hits"] > 0
    if scenario is _sc_full_prompt_cow:
        assert st["cow_copies"] == 2
    _invariant(mesh.cache)
    assert mesh.cache.pages_in_use == 0
