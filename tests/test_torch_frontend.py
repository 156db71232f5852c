"""paddle_tpu_torch's serving front door (``serving/frontend.py`` over
``router.py``, the resilience policy and ``io/checkpoint.py``) vs
paddle_tpu, on the CPU.

The port's model carries the weights of paddle_tpu's suite-wide small GPT;
the oracle is paddle_tpu's ``generate`` (greedy, memoised per test run).

- the reference acceptance case: 8 requests, 2 replicas, one injected
  mid-decode failure — with the default snapshot interval the victims
  restart from token 0, with a short one they resume from their
  snapshots; every completed stream equals ``generate``, the survivor
  leaks no page, the whole drive runs under the lock-order witness;
- the handle and admission surface: streaming and ``events()``, cancel
  mid-stream, the queue cap, a deadline at submit and a tiny one, the
  default deadline, least-outstanding-tokens placement, graceful drain,
  an ``engine_factory``'s engines sharing the fleet metrics, duplicate
  request ids, knob validation and the device policy;
- the disaggregated fleet: streams equal, pages shipped, and a denied
  ship decodes in place;
- restart recovery across packages: a request snapshot persisted by one
  package's engine through its ``CheckpointStore`` is finished by the
  other package's frontend (``recover_pending``), streams equal
  ``generate``; a corrupt slot is skipped by both; and the port's own
  frontend persists, dies and is recovered by a new frontend.
"""
import os

import numpy as np
import pytest

from paddle_tpu.io.checkpoint import CheckpointStore as JaxStore
from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import ServingFrontend as JaxFrontend
from paddle_tpu_torch.framework import concurrency
from paddle_tpu_torch.framework.errors import (AlreadyExistsError,
                                               DeadlineExceededError,
                                               InvalidArgumentError,
                                               ResourceExhaustedError)
from paddle_tpu_torch.io import CheckpointStore as PortStore
from paddle_tpu_torch.serving import (ServingEngine, ServingFrontend,
                                      create_serving_frontend)
from paddle_tpu_torch.serving.router import DEAD, HEALTHY
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.testing.chaos import ChaosPlan, Fault
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 50
ENGINE_KW = dict(page_size=4, max_batch_size=4, eos_id=0)
NO_EOS_KW = dict(page_size=4, max_batch_size=4, eos_id=-1)
BUDGET = 12


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


@pytest.fixture(autouse=True)
def _lock_witness():
    with concurrency.witness(raise_on_violation=False):
        yield
    concurrency.assert_clean()


_MEMO = None
_JAX_GPT = None


@pytest.fixture(autouse=True)
def _bind_ref_memo(greedy_ref_memo, shared_gpt_small):
    global _MEMO, _JAX_GPT
    _MEMO, _JAX_GPT = greedy_ref_memo, shared_gpt_small


def _reference(prompt, budget, end_id=0):
    """paddle_tpu's generate(greedy), truncated at the first EOS
    (inclusive) — the oracle of every completed stream."""
    w = _MEMO(_JAX_GPT, prompt, budget, end_id=end_id)
    if end_id >= 0 and (w == end_id).any():
        w = w[: int(np.argmax(w == end_id)) + 1]
    return w


def _frontend(port, **kw):
    kw.setdefault("engine_kwargs", dict(ENGINE_KW))
    return ServingFrontend(port, device="cpu", **kw)


def _no_leak(fe):
    for rep in fe._replicas:
        if rep.state != DEAD:
            assert rep.engine.cache.pages_in_use == 0, rep.id


# =============================================================================
# the acceptance case
# =============================================================================
@pytest.mark.parametrize("snapshot_interval", [16, 2])
def test_8_requests_2_replicas_1_injected_failure(port, snapshot_interval):
    fe = _frontend(port, replicas=2, queue_cap=32,
                   snapshot_interval=snapshot_interval)
    try:
        rng = np.random.RandomState(7)
        prompts = [rng.randint(1, VOCAB, (p,)).astype(np.int32)
                   for p in (3, 5, 9, 4, 7, 6, 8, 2)]
        handles = [fe.submit(p, max_new_tokens=8) for p in prompts]
        fe.inject_failure("replica-0", at_step=4)
        assert [h.wait(timeout=300) for h in handles] == ["completed"] * 8
        assert fe.metrics.snapshot()["retries"] >= 1
        assert any(h.retried for h in handles)
        if snapshot_interval == 2:
            # warm failover: the victims resumed from their snapshots
            assert any(h.resumed_from is not None for h in handles)
        else:
            assert all(h.resumed_from is None for h in handles)
        for p, h in zip(prompts, handles):
            np.testing.assert_array_equal(h.tokens, _reference(p, 8))
            assert h.ttft_ms is not None and h.e2e_ms >= h.ttft_ms
        hz = fe.health()
        states = {r["id"]: r["state"] for r in hz["replicas"]}
        assert states == {"replica-0": DEAD, "replica-1": HEALTHY}
        assert fe.router.get("replica-0").dead_reason == \
            "injected failure at step 4"
        _no_leak(fe)
        assert hz["status"] == "ok" and hz["inflight"] == 0
    finally:
        fe.close()


# =============================================================================
# handles and admission
# =============================================================================
def test_iterator_tokens_and_events(port):
    fe = _frontend(port, replicas=1)
    try:
        p = np.array([3, 7, 11, 2], np.int32)
        h = fe.submit(p, max_new_tokens=6)
        streamed = list(h)
        ref = _reference(p, 6)
        np.testing.assert_array_equal(np.asarray(streamed, np.int32), ref)
        np.testing.assert_array_equal(h.result(timeout=60), ref)
        evs = list(h.events())
        assert evs[-1] == ("end", "completed")
        assert [e[2] for e in evs if e[0] == "token"] == streamed
        assert h.retried is False
    finally:
        fe.close()


def test_cancel_mid_stream(port):
    fe = _frontend(port, replicas=1, engine_kwargs=dict(NO_EOS_KW))
    try:
        victim = fe.submit(np.array([3, 5, 9], np.int32),
                           max_new_tokens=48)
        survivor = fe.submit(np.array([2, 9], np.int32), max_new_tokens=8)
        for ev in victim.events():
            if ev[0] == "token":
                victim.cancel()
                break
        assert victim.wait(timeout=120) == "cancelled"
        assert 0 < victim.num_tokens < 48
        with pytest.raises(RuntimeError, match="cancelled"):
            victim.result(timeout=60)
        np.testing.assert_array_equal(
            survivor.result(timeout=120),
            _reference(np.array([2, 9], np.int32), 8, end_id=-1))
        assert fe.metrics.snapshot()["cancels"] == 1
        _no_leak(fe)
    finally:
        fe.close()


def test_queue_cap_rejects_on_overload(port):
    fe = _frontend(port, replicas=1, queue_cap=1,
                   engine_kwargs=dict(NO_EOS_KW))
    try:
        a = fe.submit(np.array([3, 5], np.int32), max_new_tokens=16)
        b = fe.submit(np.array([2, 9], np.int32), max_new_tokens=4)
        assert b.status == "rejected" and "queue_cap" in b.detail
        assert b.error_cls is ResourceExhaustedError
        with pytest.raises(RuntimeError, match="rejected"):
            b.result()
        assert a.wait(timeout=120) == "completed"
        assert fe.metrics.snapshot()["rejects"] == 1
    finally:
        fe.close()


def test_deadlines_at_submit_and_tiny(port):
    fe = _frontend(port, replicas=1)
    try:
        h = fe.submit(np.array([3, 5], np.int32), max_new_tokens=4,
                      deadline_ms=0)
        assert h.status == "deadline_miss"
        assert h.error_cls is DeadlineExceededError
        assert fe.metrics.snapshot()["deadline_miss"] == 1
        # 1 ms never covers a step: wherever the expiry lands, the
        # handle ends as a miss and frees everything
        h2 = fe.submit(np.array([3, 5, 7], np.int32), max_new_tokens=32,
                       deadline_ms=1)
        assert h2.wait(timeout=120) == "deadline_miss"
        assert fe.health()["inflight"] == 0
        _no_leak(fe)
    finally:
        fe.close()


def test_default_deadline_and_factory_knobs(port):
    fe = create_serving_frontend(port, device="cpu", page_size=4,
                                 max_batch_size=4, replicas=1, queue_cap=5,
                                 default_deadline_ms=0.0)
    try:
        assert fe.queue_cap == 5
        h = fe.submit(np.array([3], np.int32), max_new_tokens=2)
        assert h.status == "deadline_miss"          # default applied
        h2 = fe.submit(np.array([3], np.int32), max_new_tokens=2,
                       deadline_ms=60_000)          # explicit overrides
        assert h2.wait(timeout=120) == "completed"
    finally:
        fe.close()
    with pytest.raises(InvalidArgumentError, match="serving disabled"):
        create_serving_frontend(port, config=object(), device="cpu")


def test_least_outstanding_tokens_placement(port):
    fe = _frontend(port, replicas=2)
    try:
        h1 = fe.submit(np.array([3, 5], np.int32), max_new_tokens=8)
        with fe._lock:
            loads = sorted(r.outstanding_tokens for r in fe._replicas)
        assert loads == [0, 10]
        h2 = fe.submit(np.array([2, 9, 4], np.int32), max_new_tokens=8)
        with fe._lock:
            assert all(r.outstanding_tokens > 0 for r in fe._replicas)
        for h in (h1, h2):
            assert h.wait(timeout=120) == "completed"
    finally:
        fe.close()


def test_graceful_drain(port):
    fe = _frontend(port, replicas=2)
    try:
        fe.drain_replica("replica-0")
        handles = [fe.submit(np.array([3, 5 + i], np.int32),
                             max_new_tokens=4) for i in range(4)]
        assert all(h.wait(timeout=120) == "completed" for h in handles)
        rep0 = fe.router.get("replica-0")
        assert rep0.state == "draining" and rep0.steps == 0
        assert fe.health()["status"] == "ok"
    finally:
        fe.close()


def test_engine_factory_shares_fleet_metrics(port):
    fe = ServingFrontend(engine_factory=lambda: ServingEngine(
        port, device="cpu", **ENGINE_KW), device="cpu")
    try:
        h = fe.submit(np.array([3, 5], np.int32), max_new_tokens=4)
        assert h.wait(timeout=120) == "completed"
        esnap = fe.stats()["engines"]
        assert esnap["steps"] > 0 and esnap["tokens_generated"] >= 4
    finally:
        fe.close()
    with pytest.raises(ValueError, match="mutually exclusive"):
        ServingFrontend(engine_factory=lambda: None,
                        engine_kwargs={"page_size": 4}, device="cpu")


def test_duplicate_request_id_does_not_inflate_submitted(port):
    fe = _frontend(port, replicas=1, engine_kwargs=dict(NO_EOS_KW))
    try:
        h = fe.submit(np.array([3, 5], np.int32), max_new_tokens=8,
                      request_id="dup")
        with pytest.raises(AlreadyExistsError, match="already live"):
            fe.submit(np.array([2], np.int32), max_new_tokens=2,
                      request_id="dup")
        assert h.wait(timeout=120) == "completed"
        snap = fe.metrics.snapshot()
        assert snap["submitted"] == 1 == snap["completed"]
    finally:
        fe.close()


def test_knobs_and_device_policy(port, monkeypatch):
    for bad in (dict(slo="yes"), dict(slo_adaptive_brownout="on"),
                dict(slo=True, brownout=None, slo_adaptive_brownout=True),
                dict(prefill_replicas=-1), dict(prefill_replicas=True),
                dict(watchdog={"hang": 1}), dict(prefix_cache=1),
                dict(snapshot_interval=None, snapshot_store="x")):
        with pytest.raises(InvalidArgumentError):
            _frontend(port, replicas=1, **bad)
    fe = _frontend(port, replicas=1, slo=False)
    try:
        assert fe.healthz()["slo"] is None and fe.stats()["slo"] is None
    finally:
        fe.close()
    # the default device is the card: without one the frontend raises
    # instead of running on the CPU
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingFrontend(port, replicas=1, engine_kwargs=dict(ENGINE_KW))


def test_healthz_matches_jax_keys(port, shared_gpt_small):
    fe = _frontend(port, replicas=1)
    jfe = JaxFrontend(shared_gpt_small, replicas=1,
                      engine_kwargs=dict(ENGINE_KW))
    try:
        h = fe.submit(np.array([3, 5, 7], np.int32), max_new_tokens=4)
        assert h.wait(timeout=120) == "completed"
        hz, jhz = fe.healthz(), jfe.healthz()
        assert set(hz) == set(jhz)
        assert set(hz["tiers"]) == set(jhz["tiers"])
        assert set(hz["slo"]) == set(jhz["slo"])
        assert set(hz["slo"]["objectives"]) == set(jhz["slo"]["objectives"])
        assert hz["window"]["frontend"]["ttft_ms"]["count"] >= 1
        assert set(fe.stats()) == set(jfe.stats())
        assert set(fe.stats()["resilience"]) == \
            set(jfe.stats()["resilience"])
    finally:
        fe.close()
        jfe.close()


# =============================================================================
# disaggregated prefill / decode
# =============================================================================
def _colocated(port, prompts, budget):
    eng = ServingEngine(port, device="cpu", **ENGINE_KW)
    rids = [eng.add_request(p, max_new_tokens=budget) for p in prompts]
    outs = eng.drain()
    return [outs[r] for r in rids]


@pytest.mark.parametrize("deny", [False, True])
def test_disaggregated_fleet(port, deny):
    rng = np.random.RandomState(41)
    prompts = [rng.randint(1, VOCAB, (k,)).astype(np.int32)
               for k in (5, 9, 7, 12)]
    plan = ChaosPlan([Fault("kv.ship", at=1, action="deny",
                            count=10 ** 6)] if deny else [])
    fe = _frontend(port, replicas=1, prefill_replicas=1, queue_cap=32)
    try:
        with chaos.running(plan):
            handles = [fe.submit(p, max_new_tokens=10) for p in prompts]
            assert [h.wait(timeout=300) for h in handles] == \
                ["completed"] * 4
        st = fe.stats()
        assert st["router"]["healthy_by_role"] == {"prefill": 1,
                                                   "decode": 1}
        assert st["resilience"]["disaggregated"] is True
        roles = sorted((rep.id, rep.role) for rep in fe._replicas)
        assert roles == [("prefill-0", "prefill"), ("replica-0", "decode")]
        if deny:
            # colocated fallback: every request decoded where it filled
            assert any(e["site"] == "kv.ship" for e in plan.fired_log())
            assert st["engines"]["disagg"]["shipped_pages"] == 0
        else:
            assert st["engines"]["disagg"]["shipped_pages"] > 0
            assert st["engines"]["disagg"]["transfer_ms"]["count"] >= 1
            assert fe.router.get("replica-0").steps > 0
        _no_leak(fe)
    finally:
        fe.close()
    for p, h, ref in zip(prompts, handles,
                         _colocated(port, prompts, 10)):
        np.testing.assert_array_equal(h.tokens, ref)
        np.testing.assert_array_equal(h.tokens, _reference(p, 10))


# =============================================================================
# restart recovery
# =============================================================================
def _run_until(eng, rid, ntokens):
    for _ in range(200):
        seq = next((s for s in eng.scheduler.running if s.seq_id == rid),
                   None)
        if seq is not None and len(seq.generated) >= ntokens:
            return
        eng.step()
    raise AssertionError(f"{rid} never reached {ntokens} tokens")


def _persist(pkg, models, directory, prompt, rid, ntokens):
    """One package's engine decodes ``ntokens`` of ``rid``, snapshots it
    and persists the snapshot through that package's store the way the
    frontend does (slot ``req-<rid>``)."""
    if pkg == "jax":
        eng, store = JaxEngine(models[0], **NO_EOS_KW), JaxStore(directory)
    else:
        eng = ServingEngine(models[1], device="cpu", **NO_EOS_KW)
        store = PortStore(directory)
    eng.add_request(prompt, max_new_tokens=BUDGET, request_id=rid)
    _run_until(eng, rid, ntokens)
    snap = eng.snapshot(rid)
    store.save_named(f"req-{rid}", snap.to_state(),
                     metadata={"request_id": rid})
    return snap.num_generated


def _corrupt(directory, name):
    path = os.path.join(directory, f"slot-{name}.ckpt")
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    return path


def _wait_retired(store, names, timeout=30.0):
    import time

    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if not set(names) & set(store.named()):
            return
        time.sleep(0.02)
    raise AssertionError(f"slots {names} not retired: {store.named()}")


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_restart_recovery_across_packages(port, shared_gpt_small, tmp_path,
                                          writer, reader):
    models = (shared_gpt_small, port)
    rng = np.random.RandomState(13)
    good = rng.randint(1, VOCAB, (6,)).astype(np.int32)
    torn = rng.randint(1, VOCAB, (5,)).astype(np.int32)
    d = str(tmp_path)
    n = _persist(writer, models, d, good, "good", 5)
    _persist(writer, models, d, torn, "torn", 3)
    bad_path = _corrupt(d, "req-torn")
    if reader == "port":
        fe = _frontend(port, replicas=1, snapshot_store=d,
                       engine_kwargs=dict(NO_EOS_KW))
    else:
        fe = JaxFrontend(shared_gpt_small, replicas=1, snapshot_store=d,
                         engine_kwargs=dict(NO_EOS_KW))
    try:
        handles = fe.recover_pending()
        assert [h.request_id for h in handles] == ["good"]
        (h,) = handles
        assert h.wait(timeout=300) == "completed"
        assert h.retried and h.resumed_from == n >= 5
        np.testing.assert_array_equal(
            h.tokens, _reference(good, BUDGET, end_id=-1))
        store = fe._snapshot_store
        assert [p for p, _ in store.last_skipped] == [bad_path]
        # the finished request's slot retires; the corrupt one stays
        _wait_retired(store, ["req-good"])
        assert store.named() == ["req-torn"]
    finally:
        fe.close()


def test_restart_recovery_through_the_frontend(port, tmp_path):
    d = str(tmp_path)
    rng = np.random.RandomState(17)
    prompts = [rng.randint(1, VOCAB, (k,)).astype(np.int32)
               for k in (6, 9)]
    fe = _frontend(port, replicas=1, snapshot_interval=4,
                   snapshot_store=d, engine_kwargs=dict(NO_EOS_KW))
    try:
        # armed before submit: the only replica dies mid-decode
        fe.inject_failure("replica-0", at_step=10)
        handles = [fe.submit(p, max_new_tokens=BUDGET,
                             request_id=f"r{i}")
                   for i, p in enumerate(prompts)]
        assert [h.wait(timeout=300) for h in handles] == ["failed"] * 2
    finally:
        fe.close()
    store = PortStore(d)
    assert store.named() == ["req-r0", "req-r1"]   # slots survive close
    fe2 = _frontend(port, replicas=1, snapshot_interval=4,
                    snapshot_store=d, engine_kwargs=dict(NO_EOS_KW))
    try:
        rec = fe2.recover_pending()
        assert sorted(h.request_id for h in rec) == ["r0", "r1"]
        for h in rec:
            assert h.wait(timeout=300) == "completed"
            assert h.resumed_from >= 4
            p = prompts[int(h.request_id[1:])]
            np.testing.assert_array_equal(
                h.tokens, _reference(p, BUDGET, end_id=-1))
        _wait_retired(store, ["req-r0", "req-r1"])
        _no_leak(fe2)
    finally:
        fe2.close()
