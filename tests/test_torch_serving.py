"""paddle_tpu_torch serving stack (scheduler, KV cache, ragged engine) vs
paddle_tpu and vs the port's own dense ``generate``.

- the scheduler and page allocator take identical admission, growth,
  preemption, retirement and expiry decisions on a scripted trace;
- a mixed-length batch through the port's engine (sync and pipelined)
  streams exactly what the port's ``generate`` and paddle_tpu's
  ``ServingEngine`` stream, with no page leaked;
- recompute preemption, abort, deadlines and the numeric-guard
  quarantine keep every surviving stream equal to ``generate``;
- knobs the port does not carry yet (the KV tiers), and knob values no
  slice takes (an unknown KV or weight dtype, ``quant_scales`` without
  an int8 knob, ``ragged=True`` with ``fused_steps``, a ``spec_decode``
  horizon below 2, an unknown mesh axis), raise
  ``InvalidArgumentError``, and the
  default device (the CUDA card) raises where there is none.

Streams are compared token for token (greedy, f32 on the CPU).
"""
import time

import numpy as np
import pytest
import torch

from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxCache
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.serving import (PagedKVCache, Request, Scheduler,
                                      ServingEngine, create_serving_engine)
from paddle_tpu_torch.text.generation import generate
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 50
ENGINE = dict(page_size=4, max_batch_size=4, prefill_chunk=4, eos_id=0)
LENS = (3, 9, 5, 2, 1, 12)
BUDGET = 10


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, VOCAB, (n,)).astype(np.int32) for n in LENS]


def _ref(model, prompt, T, end_id=0):
    """The port's generate(), truncated after the first EOS."""
    want = generate(model, prompt[None], max_new_tokens=T,
                    end_id=end_id)[0][0].numpy()
    if (want == end_id).any():
        want = want[: int(np.argmax(want == end_id)) + 1]
    return want


@pytest.fixture(scope="module")
def refs(port, prompts):
    return [_ref(port, p, BUDGET) for p in prompts]


def _drive(eng, prompts, budget=BUDGET):
    ids = [eng.add_request(p, max_new_tokens=budget) for p in prompts]
    outs = eng.drain()
    return [outs[r] for r in ids]


# =============================================================================
# scheduler + allocator decisions vs paddle_tpu
# =============================================================================
def _trace(cache_cls, sched_cls, req_cls):
    cache = cache_cls(num_pages=8, page_size=4, pages_per_seq=4)
    s = sched_cls(cache, max_batch_size=3)
    log = []

    def snap(tag):
        log.append((tag, [q.seq_id for q in s.running],
                    [r.request_id for r in s.waiting],
                    {q.seq_id: cache.seq_page_ids(q.seq_id)
                     for q in s.running},
                    cache.pages_in_use, cache.free_pages, s.bucket(),
                    sorted(s.seq_lens().items())))

    for i, n in enumerate((8, 5, 3, 9, 2)):
        s.add(req_cls(prompt=np.arange(1, n + 1), request_id=f"r{i}",
                      deadline=50.0 if i == 4 else None))
    log.append(("admit", [q.seq_id for q in s.admit()]))
    snap("admitted")
    for q in s.running:                 # decode growth to the next page
        q.pos = 4 * cache.seq_pages(q.seq_id)
    log.append(("preempt", [q.seq_id for q in s.ensure_decode_pages()]))
    snap("grown")
    s.finish(s.running[0])
    log.append(("expired", [r.request_id for r in s.expire_queued(60.0)]))
    log.append(("admit", [q.seq_id for q in s.admit()]))
    snap("readmitted")
    for q in list(s.running):
        s.finish(q)
    log.append(("admit", [q.seq_id for q in s.admit()]))
    snap("final")
    # the allocator counters both packages keep (the JAX one adds its
    # prefix-cache residency and copy-on-write counters)
    keys = ("num_pages", "page_size", "pages_in_use", "pages_free",
            "num_seqs", "total_allocs", "total_frees", "peak_pages_in_use",
            "utilization")
    log.append(("stats", {k: cache.stats()[k] for k in keys}))
    return log


def test_scheduler_trace_matches_jax():
    want = _trace(JaxCache, JaxScheduler, JaxRequest)
    got = _trace(PagedKVCache, Scheduler, Request)
    assert got == want
    assert any(tag == "preempt" and ids for tag, ids in
               (e[:2] for e in got if len(e) == 2))


def test_kv_cache_refcounts_and_leak_invariant():
    c = PagedKVCache(num_pages=9, page_size=4, pages_per_seq=4)
    assert c.allocate("a", 8) and c.seq_page_ids("a") == [1, 2]
    assert c.share("b", c.seq_page_ids("a")) and c.allocate("b", 12)
    assert c.ref_count(1) == 2 and c.pages_in_use == 3
    assert c.pages_in_use + c.free_pages == c.allocatable_pages
    c.free("a")
    assert c.ref_count(1) == 1 and not c.is_free(1)
    c.free("b")
    assert c.pages_in_use == 0 and c.free_pages == c.allocatable_pages == 8
    assert c.page_table_row("b").tolist() == [0, 0, 0, 0]
    assert not c.allocate("c", 17)      # beyond pages_per_seq
    assert c.num_seqs() == 0            # no phantom registration


# =============================================================================
# engine streams
# =============================================================================
@pytest.fixture(scope="module")
def jax_streams(shared_gpt_small, prompts):
    return _drive(JaxEngine(shared_gpt_small, **ENGINE), prompts)


@pytest.mark.parametrize("sync_mode", [True, False])
def test_mixed_batch_matches_generate_and_jax_engine(port, prompts, refs,
                                                     jax_streams,
                                                     sync_mode):
    eng = create_serving_engine(port, sync_mode=sync_mode, device="cpu",
                                **ENGINE)
    got = _drive(eng, prompts)
    for g, want, j in zip(got, refs, jax_streams):
        np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(g, j)
    assert eng.cache.pages_in_use == 0
    assert eng.cache.total_allocs == eng.cache.total_frees
    st = eng.stats()
    assert st["metrics"]["ragged"]["prefill_rows"] > 0
    assert st["pipeline"]["state_bucket"] == 0 and not eng._pending


def test_preemption_keeps_streams(port, prompts, refs):
    # 8 allocatable pages for 4 lanes of up to 21 positions: recompute
    # preemption must strike and replay deterministically
    eng = ServingEngine(port, num_pages=9, device="cpu", **ENGINE)
    got = _drive(eng, prompts)
    assert eng.scheduler.num_preemptions > 0
    for g, want in zip(got, refs):
        np.testing.assert_array_equal(g, want)
    assert eng.cache.pages_in_use == 0


def test_abort_and_deadline_leave_survivors_unchanged(port, prompts, refs):
    eng = ServingEngine(port, device="cpu", **ENGINE)
    ids = [eng.add_request(p, max_new_tokens=BUDGET) for p in prompts[:3]]
    late = eng.add_request(prompts[3], max_new_tokens=BUDGET,
                           deadline=time.monotonic() - 1.0)
    eng.step()
    eng.step()
    assert eng.abort(ids[1]) and not eng.abort("no-such-request")
    outs = eng.drain()
    assert eng.take_expired() == [late] and late not in outs
    assert ids[1] not in outs
    for rid, want in ((ids[0], refs[0]), (ids[2], refs[2])):
        np.testing.assert_array_equal(outs[rid], want)
    assert eng.cache.pages_in_use == 0


def test_numeric_guard_quarantines_only_the_damaged_request(port, prompts,
                                                            refs):
    eng = ServingEngine(port, device="cpu", sync_mode=True, **ENGINE)
    ids = [eng.add_request(p, max_new_tokens=BUDGET) for p in prompts[:2]]
    for _ in range(4):                  # past both prefill plans
        eng.step()
    victim = next(s for s in eng.scheduler.running if s.seq_id == ids[1])
    eng._poison_lane(victim)            # NaN over its last written page
    outs = eng.drain()
    assert eng.take_faulted() == [ids[1]] and ids[1] not in outs
    np.testing.assert_array_equal(outs[ids[0]], refs[0])
    assert eng.stats()["metrics"]["guard"]["quarantines"] == 1
    assert eng.cache.pages_in_use == 0
    # the scrub zeroed the freed pages: no NaN survives in any pool
    assert all(torch.isfinite(p).all() for side in eng._kv.values()
               for p in side)


def test_request_validation(port):
    eng = ServingEngine(port, device="cpu", **ENGINE)
    with pytest.raises(InvalidArgumentError, match="max_seq_len"):
        eng.add_request(np.ones(60, np.int32), max_new_tokens=10)
    with pytest.raises(InvalidArgumentError, match="empty"):
        eng.add_request(np.zeros(0, np.int32))
    eng.add_request(np.ones(3, np.int32), request_id="dup")
    with pytest.raises(ValueError, match="dup"):
        eng.add_request(np.ones(3, np.int32), request_id="dup")


# =============================================================================
# knobs the port does not carry yet, invalid knob values, and the device
# default
# =============================================================================
@pytest.mark.parametrize("knob", [
    {"prefix_cache": True, "kv_tiering": {"host_mb": 1}},
    {"kv_tiering": True},
    {"spec_decode": 1},
    {"spec_drafter": object()}, {"mesh_axes": {"dp": 2}},
    {"kv_cache_dtype": "int4"}, {"weight_dtype": "fp8"},
    {"quant_scales": {}}, {"fused_steps": 2, "ragged": True},
    {"ragged": True, "fused_steps": 4},
    {"ragged": "yes"}, {"prefix_cache": "yes"}, {"numeric_guards": 1},
    pytest.param({"spec_decode": "yes"}, id="spec_decode_str")],
    ids=lambda k: next(iter(k)))
def test_unsupported_knobs_raise(port, knob):
    with pytest.raises(InvalidArgumentError):
        ServingEngine(port, device="cpu", **knob)


def test_unported_entry_points_name_the_roadmap(port):
    """The entry points that once named the ROADMAP are ported: a tiered
    engine builds, and a config without ``enable_serving`` is refused as
    in the JAX package."""
    eng = ServingEngine(port, device="cpu", prefix_cache=True,
                        kv_tiering={"host_pages": 4}, **ENGINE)
    assert eng.stats()["prefix_cache"]["tiers"]["host_capacity"] == 4
    with pytest.raises(InvalidArgumentError, match="serving disabled"):
        create_serving_engine(port, config=object())


def test_default_device_is_cuda_and_raises_without_a_card(port):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=1,
                 num_heads=2, ffn_size=64, max_seq_len=16)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(port, **ENGINE)
