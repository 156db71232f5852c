"""paddle_tpu_torch speculative decoding vs the JAX package and the
port's own references.

- the n-gram drafter and the accept rule (the units of
  ``tests/test_spec_decode.py``, on the port's copy), and the port's
  drafter proposing what paddle_tpu's proposes on the same streams;
- speculation-on streams are byte-identical to the port's ``generate``
  in pipelined, sync and fused modes and under int8_static KV, with
  drafts both accepted and rejected; the same drive through paddle_tpu's
  engine drafts and accepts the same counts;
- int8_dynamic KV verifies on the split sequential program and rolls
  rejected drafts back (spec-on streams equal spec-off);
- the fold-in: a ragged native engine builds no split verifier;
- chaos ``spec.draft`` denial and reservation denial degrade to plain
  decode without changing a stream.

Streams are compared token for token (greedy, f32 on the CPU).
"""
import numpy as np
import pytest

from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import NgramDrafter as JaxDrafter
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.slim import export_serving_quant as jax_export
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.profiler.flight_recorder import EV_SPECULATED
from paddle_tpu_torch.profiler.flight_recorder import recorder as flight
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.spec_decode import NgramDrafter, SpecDecoder
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.testing.chaos import ChaosPlan, Fault
from paddle_tpu_torch.text.generation import generate
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 50
ENGINE = dict(page_size=4, max_batch_size=4, eos_id=0, device="cpu")
BUDGET = 20


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


@pytest.fixture(scope="module")
def quant(shared_gpt_small):
    rng = np.random.RandomState(3)
    return jax_export(shared_gpt_small,
                      calib_prompts=rng.randint(1, VOCAB, (4, 12)).astype(
                          np.int32))


def _mixed_prompts(rng):
    """One cyclic prompt (accept-friendly), two structureless ones —
    drives accepted AND rejected drafts in one run."""
    pat = rng.randint(1, VOCAB, (5,)).astype(np.int32)
    return [np.tile(pat, 4),
            rng.randint(1, VOCAB, (9,)).astype(np.int32),
            rng.randint(1, VOCAB, (3,)).astype(np.int32)]


@pytest.fixture(scope="module")
def prompts():
    return _mixed_prompts(np.random.RandomState(0))


def _reference(model, prompt, budget, quant=None):
    w = generate(model, prompt[None], max_new_tokens=budget, end_id=0,
                 quant=quant)[0][0].numpy()
    if (w == 0).any():
        w = w[: int(np.argmax(w == 0)) + 1]
    return w


@pytest.fixture(scope="module")
def refs(port, prompts):
    return [_reference(port, p, BUDGET) for p in prompts]


def _drive(eng, prompts, budget=BUDGET):
    ids = [eng.add_request(p, max_new_tokens=budget) for p in prompts]
    outs = eng.drain()
    return ids, [outs[r] for r in ids]


# =============================================================================
# drafter and accept rule (pure host)
# =============================================================================
def test_self_history_cycle_with_extension():
    d = NgramDrafter(max_ngram=4, min_ngram=2)
    d.begin_lane("a", [7, 8, 9, 7, 8, 9, 7, 8, 9])
    np.testing.assert_array_equal(d.propose("a", 6), [7, 8, 9, 7, 8, 9])


def test_corpus_continuation_beats_prompt_region_self_match():
    d = NgramDrafter(max_ngram=4, min_ngram=2)
    d.ingest([5, 6, 5, 6, 5, 6, 40, 41, 42, 43])
    d.begin_lane("b", [5, 6, 5, 6, 5, 6])
    np.testing.assert_array_equal(d.propose("b", 4), [40, 41, 42, 43])


def test_generated_region_self_match_wins_over_corpus():
    d = NgramDrafter(max_ngram=4, min_ngram=2)
    d.ingest([1, 2, 3, 30, 31, 32])
    d.begin_lane("c", [9])
    for t in (1, 2, 3, 1, 2, 3):
        d.observe("c", t)
    np.testing.assert_array_equal(d.propose("c", 3), [1, 2, 3])


def test_cooldown_backoff_and_reset():
    d = NgramDrafter(max_ngram=3, min_ngram=2)
    d.begin_lane("a", [4, 5, 4, 5, 4, 5])
    assert len(d.propose("a", 2, tick=False)) == 2
    d.on_result("a", drafted=2, accepted=0)
    assert d._lanes["a"].cooldown == 2
    assert len(d.propose("a", 2)) == 0
    assert len(d.propose("a", 2)) == 0
    assert len(d.propose("a", 2)) == 2
    d.on_result("a", drafted=2, accepted=1)
    assert d._lanes["a"].miss_streak == 0
    for _ in range(9):
        d.on_result("a", 2, 0)
    assert d._lanes["a"].cooldown == NgramDrafter.COOLDOWN_CAP


def test_export_import_lane_state():
    d = NgramDrafter()
    d.begin_lane("a", [1, 2, 3, 1, 2, 3])
    d.on_result("a", 2, 0)
    state = d.export_lane("a")
    assert state == {"miss_streak": 1, "cooldown": 2}
    d2 = NgramDrafter()
    d2.begin_lane("a", [1, 2, 3, 1, 2, 3])
    d2.import_lane("a", state)
    assert d2.export_lane("a") == state
    d.forget("a")
    assert d.export_lane("a") == {}


def test_corpus_eviction_is_bounded():
    d = NgramDrafter(max_ngram=3, min_ngram=3, max_corpora=2)
    d.ingest([1, 2, 3, 4, 5])
    n_after_one = len(d._corpus_idx)
    d.ingest([6, 7, 8, 9, 10])
    d.ingest([11, 12, 13, 14, 15])
    assert len(d._corpora) == 2
    assert len(d._corpus_idx) == 2 * n_after_one
    d.begin_lane("x", [1, 2, 3])
    assert len(d.propose("x", 2)) == 0
    d.begin_lane("y", [11, 12, 13])
    np.testing.assert_array_equal(d.propose("y", 2), [14, 15])
    d.ingest([11, 12, 13, 14, 15])
    assert len(d._corpora) == 2


def test_validation():
    with pytest.raises(InvalidArgumentError):
        NgramDrafter(max_ngram=2, min_ngram=3)
    with pytest.raises(InvalidArgumentError):
        NgramDrafter(max_corpora=-1)
    with pytest.raises(InvalidArgumentError):
        SpecDecoder(1)
    with pytest.raises(InvalidArgumentError):
        SpecDecoder(4, drafter=object())


def test_accept_rule_is_prefix_match_then_verifier_token():
    s = SpecDecoder(4)
    col = np.array([10, 11, 12, 13], np.int32)
    assert s.accept_len(np.array([], np.int32), col) == 1
    assert s.accept_len(np.array([10, 11, 12], np.int32), col) == 4
    assert s.accept_len(np.array([10, 99, 12], np.int32), col) == 2
    assert s.accept_len(np.array([99], np.int32), col) == 1


def test_drafter_proposes_what_the_jax_drafter_proposes():
    """Random streams with planted repeats, observed token by token, a
    retired stream ingested, fully rejected drafts: both drafters
    propose the same tokens at every point."""
    rng = np.random.RandomState(9)
    ours, theirs = NgramDrafter(), JaxDrafter()
    corpus = rng.randint(1, 12, 40)
    for d in (ours, theirs):
        d.ingest(corpus)
    for lane in range(4):
        hist = rng.randint(1, 12, 6 + lane)
        for d in (ours, theirs):
            d.begin_lane(f"l{lane}", hist)
        for t in range(30):
            tok = int(rng.randint(1, 12)) if t % 3 else int(hist[t % 5])
            for d in (ours, theirs):
                d.observe(f"l{lane}", tok)
            got = ours.propose(f"l{lane}", 3)
            np.testing.assert_array_equal(got,
                                          theirs.propose(f"l{lane}", 3))
            if len(got) and t % 4 == 0:
                for d in (ours, theirs):
                    d.on_result(f"l{lane}", len(got), 0)
    assert ours.stats() == theirs.stats()


# =============================================================================
# engine byte identity
# =============================================================================
@pytest.mark.parametrize("mode", ["pipelined", "sync", "fused"])
def test_native_modes_match_generate(port, prompts, refs, mode):
    kw = {"sync": dict(sync_mode=True),
          "fused": dict(fused_steps=4)}.get(mode, {})
    eng = ServingEngine(port, spec_decode=4, **ENGINE, **kw)
    _, got = _drive(eng, prompts)
    for g, w in zip(got, refs):
        np.testing.assert_array_equal(g, w)
    s = eng.stats()["spec"]
    assert s["enabled"] and s["k"] == 4
    assert s["drafted"] > 0 and s["rejected"] > 0
    assert eng.cache.pages_in_use == 0
    # a split engine verifies on the split program, a ragged one folds
    calls = eng.stats()["programs"]
    assert (calls["spec_verify"] > 0) == (mode == "fused")


def test_split_spec_engine_matches_jax_engine(shared_gpt_small, port,
                                              prompts):
    """``ragged=False, spec_decode=4`` through both packages: the same
    streams, and the same drafted / accepted / rejected counts."""
    jeng = JaxEngine(shared_gpt_small, page_size=4, max_batch_size=4,
                     eos_id=0, ragged=False, spec_decode=4)
    _, want = _drive(jeng, prompts)
    eng = ServingEngine(port, ragged=False, spec_decode=4, **ENGINE)
    _, got = _drive(eng, prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    keys = ("steps", "drafted", "accepted", "rejected", "rollbacks")
    assert ({k: eng.stats()["spec"][k] for k in keys}
            == {k: jeng.stats()["spec"][k] for k in keys})
    assert eng.stats()["programs"]["spec_verify"] > 0


def test_speculated_lifecycle_events_recorded(port, prompts):
    eng = ServingEngine(port, spec_decode=4, **ENGINE)
    ids, _ = _drive(eng, prompts)
    evs = [e for rid in ids
           for e in (flight.trace(rid) or {"events": []})["events"]
           if e["kind"] == EV_SPECULATED]
    assert evs and all("drafted" in e and "accepted" in e for e in evs)
    assert eng.stats()["metrics"]["spec"]["drafted"] > 0


def test_int8_static_matches_quantized_generate(port, prompts, quant):
    q = {"kv_cache_dtype": "int8", "kv_scales": quant["kv_scales"]}
    eng = ServingEngine(port, spec_decode=4, kv_cache_dtype="int8",
                        quant_scales=quant, **ENGINE)
    assert not eng.spec.sequential and eng._spec_fn is None
    _, got = _drive(eng, prompts)
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _reference(port, p, BUDGET, q))
    assert eng.stats()["spec"]["drafted"] > 0


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "split"])
def test_int8_dynamic_rollback_restores_scales(port, prompts, ragged):
    """Dynamic per-page scales grow with every write, junk included: the
    restore-and-replay rollback makes a rejected draft invisible, so the
    spec-on stream equals the spec-off engine's."""
    def run(spec):
        eng = ServingEngine(port, spec_decode=spec, kv_cache_dtype="int8",
                            sync_mode=not spec, ragged=ragged, **ENGINE)
        return eng, _drive(eng, prompts)[1]

    e_off, off = run(False)
    e_on, on = run(4)
    assert e_on.spec.sequential and e_on._spec_fn is not None
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    s = e_on.stats()["spec"]
    assert s["drafted"] > 0 and s["rollbacks"] > 0
    calls = e_on.stats()["programs"]
    assert calls["spec_verify"] > 0
    # the replayed accepted tokens ride the prefill program one at a time
    assert calls["prefill"] > (0 if ragged else e_off.stats()[
        "programs"]["prefill"])
    assert e_on.cache.pages_in_use == 0


def test_ragged_native_engine_folds_the_verify(port, prompts, refs):
    eng = ServingEngine(port, spec_decode=4, **ENGINE)
    assert eng._spec_fn is None              # no split verifier built
    split = ServingEngine(port, spec_decode=4, ragged=False, **ENGINE)
    assert split._spec_fn is not None
    _, got = _drive(eng, prompts)
    _, want = _drive(split, prompts)
    for g, w, r in zip(got, want, refs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    snap = eng.stats()["metrics"]["ragged"]
    assert snap["spec_rows"] > 0
    assert eng.stats()["programs"]["spec_verify"] == 0


# =============================================================================
# degradation
# =============================================================================
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "split"])
def test_chaos_deny_degrades_to_plain_decode(port, prompts, ragged):
    plan = ChaosPlan([Fault("spec.draft", at=1, action="deny",
                            count=10_000)])
    eng = ServingEngine(port, spec_decode=4, ragged=ragged, **ENGINE)
    with chaos.running(plan):
        _, got = _drive(eng, prompts, budget=16)
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _reference(port, p, 16))
    s = eng.stats()["spec"]
    assert s["drafted"] == 0 and s["steps"] == 0 and s["degraded"] > 0
    assert any(f["site"] == "spec.draft" for f in plan.fired)


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "split"])
def test_reservation_denial_degrades_lane(port, prompts, ragged):
    eng = ServingEngine(port, spec_decode=4, ragged=ragged, **ENGINE)
    orig = eng.scheduler.reserve
    denied = {"n": 0}

    def deny_twice(seq, num_tokens):
        denied["n"] += 1
        if denied["n"] <= 2:
            return False
        return orig(seq, num_tokens)

    eng.scheduler.reserve = deny_twice
    _, got = _drive(eng, prompts, budget=16)
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _reference(port, p, 16))
    assert denied["n"] > 2 and eng.stats()["spec"]["degraded"] > 0
    assert eng.cache.pages_in_use == 0
