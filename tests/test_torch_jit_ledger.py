"""paddle_tpu_torch's compile ledger (``profiler/jit_cost.py``) against
paddle_tpu's, on the CPU.

- the ledger and budget units of ``tests/test_jit_ledger.py``, run on the
  port's ``CompileLedger`` / ``compile_budget``, and ``profiled_graph``
  feeding the global ledger once per signature (tensor shape, dtype and
  device; the value of any other leaf);
- the serving pins of ``tests/test_jit_ledger.py`` on the port's CPU
  engine: zero compiles over 32 steady steps at bucket 4, exactly one
  ``serving.ragged_step`` compile on a lane-bucket change, exactly one
  ``serving.decode_fused`` for the fused program; a donated pool
  replaced by another tensor raises; ``disable_jit`` runs eagerly and
  records nothing;
- the same request schedule through paddle_tpu's ``ServingEngine`` (JAX
  on the CPU, a fresh model) and the port's engine (its weights bridged):
  the ``serving.ragged_step`` / ``serving.decode*`` compile counts of
  both ledgers are equal, and so are the streams;
- the capture gate and the launch counters under many threads: no
  capture section overlaps another thread's device section, captures
  nested in a thread's own section take turns instead of deadlocking,
  and launches counted inside a capture land only in that capture.

On the CPU nothing is captured: a signature's first call counts one
compile and every call runs the function as written.  Streams are
compared token for token.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import get_state
from paddle_tpu.profiler.jit_cost import compile_budget as jax_budget
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.profiler.jit_cost import (CompileBudgetExceeded,
                                                CompileLedger,
                                                compile_budget,
                                                compile_ledger,
                                                cost_registry, disable_jit,
                                                profiled_graph)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.text.generation import generate
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB, HID, LAYERS, HEADS = 50, 32, 2, 2
SERVING = ("serving.ragged_step", "serving.decode", "serving.decode_fused")


def fresh_gpt(seed):
    """A private port GPT (its programs are captured per engine anyway)."""
    return GPTModel(vocab_size=VOCAB, hidden_size=HID, num_layers=LAYERS,
                    num_heads=HEADS, ffn_size=64, max_seq_len=64,
                    device="cpu", seed=seed)


def engine(model, **knobs):
    return ServingEngine(model, page_size=4, device="cpu",
                         **{"eos_id": -1, **knobs})


def prompt(rng, n):
    return rng.randint(1, VOCAB, (n,)).astype(np.int32)


# =============================================================================
# ledger + budget units (host-only), the twins of test_jit_ledger.py:45-90
# =============================================================================
def test_counts_total_events_reset():
    led = CompileLedger()
    led.on_compile("serving.decode", "(4,):int32")
    led.on_compile("serving.decode", "(8,):int32")
    led.on_compile("serving.prefill", "(4,):int32", fallback=True)
    assert led.counts() == {"serving.decode": 2, "serving.prefill": 1}
    assert led.counts("serving.d") == {"serving.decode": 2}
    assert led.total() == 3 and led.total("serving.p") == 1
    assert led.events()[-1] == ("serving.prefill", "(4,):int32", True)
    led.reset()
    assert led.counts() == {} and led.events() == []


def test_budget_record_mode_deltas():
    led = CompileLedger()
    led.on_compile("a.x", "s0")           # pre-existing history
    with compile_budget(None, ledger=led) as cb:
        assert cb.compiles() == {}
        led.on_compile("a.x", "s1")
        led.on_compile("b.y", "s0")
    assert cb.compiles() == {"a.x": 1, "b.y": 1}
    assert cb.total() == 2


def test_budget_raise_mode_names_the_drifted_program():
    led = CompileLedger()
    with pytest.raises(CompileBudgetExceeded, match="a.x x2"):
        with compile_budget(1, ledger=led):
            led.on_compile("a.x", "s0")
            led.on_compile("a.x", "s1")


@pytest.mark.parametrize("limit,scope,compiled", [
    (0, dict(prefix="serving."), "train.step"),  # out of prefix
    (0, dict(names=("a.x",)), "a.y"),            # out of names
    (1, {}, "a.x")],                             # exactly at the budget
    ids=["prefix", "names", "at-budget"])
def test_budget_scopes_and_exact_limit_do_not_raise(limit, scope, compiled):
    led = CompileLedger()
    with compile_budget(limit, ledger=led, **scope) as cb:
        led.on_compile(compiled, "s0")
    assert cb.total() == (0 if scope else 1)


def test_budget_does_not_mask_body_exception():
    led = CompileLedger()
    with pytest.raises(ValueError, match="body"):
        with compile_budget(0, ledger=led):
            led.on_compile("a.x", "s0")
            raise ValueError("body")


def test_profiled_graph_feeds_global_ledger_once_per_signature():
    f = profiled_graph("ledger.unit_add", lambda x, k: x + k)
    with compile_budget(None, prefix="ledger.") as cb:
        f(torch.zeros(4), 1)
        out = f(torch.ones(4), 1)          # same signature: no compile
        f(torch.zeros(8), 1)               # new shape
        f(torch.zeros(8, dtype=torch.float64), 1)   # new dtype
        f(torch.zeros(8), 2)               # a non-tensor leaf's value
    assert cb.compiles() == {"ledger.unit_add": 4}
    assert torch.equal(out, torch.full((4,), 2.0))
    name, _, fallback = compile_ledger.events()[-1]
    assert name == "ledger.unit_add" and not fallback
    snap = cost_registry.snapshot()["ledger.unit_add"]
    assert snap["calls"] == 5 and snap["compile_count"] == 4
    assert snap["replays"] == 0 and not snap["graphed"]


def test_profiled_graph_signature_covers_the_argument_tree():
    f = profiled_graph("ledger.unit_tree", lambda d: d["a"] + d["b"][0])
    with compile_budget(None, prefix="ledger.") as cb:
        f({"a": torch.ones(2), "b": [torch.ones(2)]})
        f({"a": torch.ones(2), "b": [torch.ones(2)]})
        f({"a": torch.ones(2), "b": (torch.ones(2),)})   # list -> tuple
        f({"b": [torch.ones(2)], "a": torch.ones(2)})    # key order
    assert cb.compiles() == {"ledger.unit_tree": 3}


def test_donated_argument_replaced_raises():
    f = profiled_graph("ledger.unit_donate",
                       lambda x, pool: pool.add_(x), donate_argnums=(1,))
    pool = torch.zeros(3)
    f(torch.ones(3), pool)
    f(torch.ones(3), pool)                 # the same storage: fine
    with pytest.raises(InvalidArgumentError, match="donated tensor leaf 0"):
        f(torch.ones(3), torch.zeros(3))
    assert torch.equal(pool, torch.full((3,), 2.0))


def test_disable_jit_runs_eagerly_and_records_nothing():
    f = profiled_graph("ledger.unit_eager", lambda x: x * 2)
    before = cost_registry.snapshot().get("ledger.unit_eager")
    with compile_budget(None, prefix="ledger.") as cb:
        with disable_jit():
            out = f(torch.ones(2))
    assert cb.compiles() == {} and before is None
    assert "ledger.unit_eager" not in cost_registry.snapshot()
    assert torch.equal(out, torch.full((2,), 2.0))


# =============================================================================
# serving compile pins on the port's CPU engine (test_jit_ledger.py:229-270)
# =============================================================================
def test_steady_state_decode_zero_compiles_32_steps():
    """Once the lane bucket is stable, 32 decode steps compile no serving
    program — compile_budget(0) raises on the first drift."""
    eng = engine(fresh_gpt(22), max_batch_size=4)
    rng = np.random.RandomState(5)
    for p in (3, 5, 7, 9):
        eng.add_request(prompt(rng, p), max_new_tokens=48)
    for _ in range(4):                       # admissions + compiles
        eng.step()
    assert all(s is not None for s in eng._lanes)
    with compile_budget(0, prefix="serving."):
        for _ in range(32):
            assert eng.step()["bucket"] == 4
    assert len(eng.drain()) == 4
    costs = eng.stats()["jit_costs"]["serving.ragged_step"]
    assert costs["calls"] >= 32 + 4 and not costs["graphed"]


def test_bucket_change_compiles_the_ragged_step_exactly_once():
    """Growing the lane bucket is the one sanctioned compile; the joining
    2-token prompt's 1-token chunk step shares the steady 1-row
    signature."""
    eng = engine(fresh_gpt(23), max_batch_size=2)
    rng = np.random.RandomState(9)
    eng.add_request(prompt(rng, 5), max_new_tokens=40, request_id="a")
    for _ in range(3):
        eng.step()                           # bucket 1 decoding
    assert eng._state_bucket == 1
    with compile_budget(None, names=("serving.ragged_step",)) as cb:
        eng.add_request(prompt(rng, 2), max_new_tokens=40, request_id="b")
        for _ in range(6):
            eng.step()                       # admit -> bucket 2
        assert eng._state_bucket == 2
    assert cb.compiles() == {"serving.ragged_step": 1}
    with compile_budget(0, prefix="serving."):
        for _ in range(8):
            eng.step()
    eng.drain()


def test_fused_program_compiles_exactly_once():
    """A fused split engine whose plain decode signature is already
    compiled (a first drive with budgets below K) compiles exactly the
    fused K-step program when fused dispatches start."""
    m = fresh_gpt(24)
    eng = engine(m, max_batch_size=2, fused_steps=4)
    rng = np.random.RandomState(4)

    def drive(budget):
        ps = [prompt(rng, n) for n in (3, 5)]
        ids = [eng.add_request(p, max_new_tokens=budget) for p in ps]
        outs = eng.drain()
        for p, rid in zip(ps, ids):
            want = generate(m, p[None], max_new_tokens=budget,
                            end_id=-1)[0][0].numpy()
            np.testing.assert_array_equal(outs[rid], want)

    with compile_budget(None, prefix="serving.") as first:
        drive(3)
    assert first.compiles() == {"serving.decode": 1}
    with compile_budget(None, prefix="serving.") as cb:
        drive(12)
    assert cb.compiles() == {"serving.decode_fused": 1}
    assert eng.stats()["programs"]["decode_fused"] > 0


def test_replaced_pool_raises():
    """The pools are donated to the ragged step: replacing one (not
    writing it in place) is refused at the next call."""
    eng = engine(fresh_gpt(25), max_batch_size=2)
    eng.add_request(prompt(np.random.RandomState(1), 4), max_new_tokens=8)
    for _ in range(3):
        eng.step()
    eng._kv["k"][1] = eng._kv["k"][1].clone()
    with pytest.raises(InvalidArgumentError, match="serving.ragged_step"):
        eng.step()


def test_disable_jit_engine_streams_equal_and_compile_nothing():
    m = fresh_gpt(26)
    rng = np.random.RandomState(6)
    ps = [prompt(rng, n) for n in (2, 7, 4)]
    streams = {}
    for eager in (True, False):
        eng = engine(m, max_batch_size=4)
        with compile_budget(None, prefix="serving.") as cb:
            if eager:
                with disable_jit():
                    ids = [eng.add_request(p, max_new_tokens=9) for p in ps]
                    outs = eng.drain()
            else:
                ids = [eng.add_request(p, max_new_tokens=9) for p in ps]
                outs = eng.drain()
        assert (cb.total() == 0) == eager
        streams[eager] = [outs[r] for r in ids]
    for a, b in zip(streams[True], streams[False]):
        np.testing.assert_array_equal(a, b)


# =============================================================================
# the same schedule through both packages
# =============================================================================
def _jax_gpt(seed):
    from paddle_tpu.text.models import GPTModel as JaxGPT

    paddle.seed(seed)
    m = JaxGPT(vocab_size=VOCAB, hidden_size=HID, num_layers=LAYERS,
               num_heads=HEADS, ffn_size=64, max_seq_len=64, dropout=0.0)
    m.eval()
    return m


@pytest.mark.parametrize("knobs", [{}, dict(fused_steps=4),
                                   dict(ragged=False)],
                         ids=["ragged", "fused4", "split"])
def test_compile_counts_equal_paddle_tpu_on_one_schedule(knobs):
    """Five requests, three admitted and stepped before two more join:
    bucket changes, prefill chunks of several sizes and (split) plain and
    fused decode.  paddle_tpu's engine runs on a fresh model, so its
    program cache is cold, as the port's per-engine graphs are."""
    jm = _jax_gpt(31)
    pm = load_numpy_state(fresh_gpt(0), {
        k: np.asarray(v) for k, v in get_state(jm)[0].items()})
    rng = np.random.RandomState(5)
    sched = [(prompt(rng, n), b) for n, b in
             ((3, 12), (9, 10), (5, 14), (2, 8), (13, 9))]
    kw = dict(page_size=4, max_batch_size=4, eos_id=-1, prefill_chunk=8,
              **knobs)
    got = {}
    for name, eng, budget in (
            ("paddle_tpu", JaxEngine(jm, **kw), jax_budget),
            ("port", ServingEngine(pm, device="cpu", **kw),
             compile_budget)):
        with budget(None, prefix="serving.") as cb:
            ids = []
            for i, (p, b) in enumerate(sched):
                ids.append(eng.add_request(p, max_new_tokens=b))
                if i == 2:
                    for _ in range(5):
                        eng.step()
            outs = eng.drain()
        counts = {k: v for k, v in cb.compiles().items() if k in SERVING}
        got[name] = ([np.asarray(outs[r]) for r in ids], counts)
    assert got["port"][1] == got["paddle_tpu"][1]
    assert got["port"][1], "the schedule compiled no serving program"
    for a, b in zip(got["paddle_tpu"][0], got["port"][0]):
        np.testing.assert_array_equal(a, b)


# =============================================================================
# several engines in one process: the capture gate, the launch counters
# =============================================================================
def test_capture_gate_and_launch_counters_under_many_threads(monkeypatch):
    """More threads than cores, a short switch interval: each thread
    loops over shared sections (an engine step) and, every few rounds,
    an exclusive section nested in one (a capture inside a step), which
    switches to its capture stream and counts its launches through that
    stream's sink; the other threads count theirs directly, on their own
    streams, all the while.  No exclusive section ever sees another
    thread in a shared or exclusive section, nothing deadlocks, and the
    counter ends at the direct launches plus every capture's launches
    once per replay — none lost, none doubled.  Each thread's current
    stream is a thread-local number here (torch's is thread-local too)."""
    import sys
    import threading

    from paddle_tpu_torch.profiler import jit_cost

    current = threading.local()
    monkeypatch.setattr(jit_cost, "_stream_key", lambda: current.stream)
    gate = jit_cost.CaptureGate()
    counts = {"cuda": 0}
    state = {"shared": 0, "writer": 0, "bad": 0, "direct": 0,
             "replayed": 0}
    lock = threading.Lock()
    n_threads, rounds, per_capture, replays = 12, 150, 3, 2

    def work(tid):
        current.stream = tid
        for r in range(rounds):
            with gate.shared():
                with lock:
                    state["shared"] += 1
                jit_cost.count_launch(counts, "cuda")
                with lock:
                    state["direct"] += 1
                if (r + tid) % 10 == 0:
                    with lock:
                        state["shared"] -= 1
                    with gate.exclusive():
                        with lock:
                            if state["shared"] or state["writer"]:
                                state["bad"] += 1
                            state["writer"] += 1
                        sink = []
                        side = n_threads + tid       # the capture stream
                        jit_cost._STREAM_SINKS[side] = sink
                        current.stream = side
                        try:
                            for _ in range(per_capture):
                                jit_cost.count_launch(counts, "cuda")
                        finally:
                            current.stream = tid
                            del jit_cost._STREAM_SINKS[side]
                        with lock:
                            state["writer"] -= 1
                    with lock:
                        state["shared"] += 1
                    delta = {"cuda": sum(n for _c, _k, n in sink)}
                    for _ in range(replays):
                        jit_cost._add_launches([(counts, delta)])
                    with lock:
                        state["replayed"] += replays * delta["cuda"]
                with lock:
                    state["shared"] -= 1

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,), daemon=True)
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(th.is_alive() for th in threads)
    assert state["bad"] == 0 and state["shared"] == 0
    assert state["direct"] == n_threads * rounds
    assert state["replayed"] == n_threads * (rounds // 10) * (
        per_capture * replays)
    assert counts["cuda"] == state["direct"] + state["replayed"]
    assert gate._shared == 0 and gate._writer is None and not gate._waiting
