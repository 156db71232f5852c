"""The span tracer of paddle_tpu_torch (``profiler/tracer.py``,
``profiler/chrome_trace.py``, ``utils/profiler.py``) and the spans at the
JAX package's sites, vs paddle_tpu, on the CPU.

- span hierarchy: nesting and parentage, span arguments, independent
  per-thread stacks, thread-safe aggregates, aggregates kept while
  tracing is off (``tests/test_profiler.py``'s cases, run on the port);
- the Chrome trace: schema and containment, ``stop_profiler`` writing
  ``profile_path`` and ``timeline_path`` (the host spans without a
  ``torch.profiler`` session, the profiler's trace with its
  ``record_function`` ranges inside one);
- a serving engine run under tracing: ``serving/ragged_step`` spans
  (with their bucket and row count) nested in ``serving/step``, the
  step-latency percentiles and the compile ledger.  The JAX test's
  FLOPs assertion is left out: the port attributes no FLOPs yet
  (ROADMAP queue 1 item 14);
- ``generate`` gives the span names and nesting of paddle_tpu's;
- ``GET /debug/requests/<id>?format=chrome`` through the port's HTTP
  server equals paddle_tpu's renderer on the same trace;
- a disabled RecordEvent costs under 150 us (the JAX test's bound), and
  runs no ``record_function`` while torch's profiler is off.
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jax_profiler
from paddle_tpu.jit.functional import get_state
from paddle_tpu.profiler.chrome_trace import \
    request_trace_events as jax_request_trace_events
from paddle_tpu.text.generation import generate as jax_generate
from paddle_tpu.utils import profiler as jax_utils_profiler
from paddle_tpu_torch import profiler
from paddle_tpu_torch.serving import (ServingEngine, ServingFrontend,
                                      start_http_server)
from paddle_tpu_torch.text.generation import generate
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state
from paddle_tpu_torch.utils import profiler as utils_profiler
from paddle_tpu_torch.utils.profiler import (RecordEvent, reset_profiler,
                                             start_profiler, stop_profiler,
                                             summary)

VOCAB = 50


@pytest.fixture(autouse=True)
def _clean_tracer():
    reset_profiler()
    profiler.disable_tracing()
    yield
    reset_profiler()
    profiler.disable_tracing()


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


class TestSpanHierarchy:
    def test_nesting_and_parentage(self):
        profiler.enable_tracing()
        with RecordEvent("outer"):
            with RecordEvent("mid"):
                with RecordEvent("leaf"):
                    pass
            with RecordEvent("mid2"):
                pass
        spans = {s.name: s for s in profiler.get_spans()}
        assert set(spans) == {"outer", "mid", "mid2", "leaf"}
        outer, mid, leaf = spans["outer"], spans["mid"], spans["leaf"]
        assert outer.parent_id is None and outer.depth == 0
        assert mid.parent_id == outer.span_id and mid.depth == 1
        assert leaf.parent_id == mid.span_id and leaf.depth == 2
        assert spans["mid2"].parent_id == outer.span_id
        assert outer.start_ns <= mid.start_ns <= mid.end_ns <= outer.end_ns
        assert mid.start_ns <= leaf.start_ns <= leaf.end_ns <= mid.end_ns

    def test_span_args_and_contextmanager(self):
        profiler.enable_tracing()
        with profiler.span("work", step=3, kind="decode") as sp:
            assert sp.name == "work"
        (got,) = profiler.get_spans()
        assert got.args == {"step": 3, "kind": "decode"}

    def test_sibling_threads_get_independent_stacks(self):
        profiler.enable_tracing()
        done = threading.Barrier(3)

        def worker(i):
            with profiler.span(f"t{i}.outer"):
                done.wait()                  # both threads mid-span
                with profiler.span(f"t{i}.inner"):
                    pass

        ts = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
        for t in ts:
            t.start()
        done.wait()
        for t in ts:
            t.join()
        spans = {s.name: s for s in profiler.get_spans()}
        for i in (0, 1):
            outer, inner = spans[f"t{i}.outer"], spans[f"t{i}.inner"]
            assert inner.parent_id == outer.span_id
            assert inner.tid == outer.tid

    def test_aggregate_thread_safety(self):
        N, T = 200, 8

        def hammer():
            for _ in range(N):
                with RecordEvent("contended"):
                    pass

        threads = [threading.Thread(target=hammer) for _ in range(T)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        agg = profiler.aggregates()["contended"]
        assert agg["calls"] == N * T
        assert agg["total_s"] > 0

    def test_disabled_tracing_keeps_aggregates_drops_spans(self):
        with RecordEvent("quiet"):
            pass
        assert profiler.get_spans() == []
        assert profiler.aggregates()["quiet"]["calls"] == 1

    def test_summary_table(self):
        with RecordEvent("ev_a"):
            pass
        table = summary()
        assert "ev_a" in table and "Calls" in table and "Max(ms)" in table

    def test_span_cap_counts_what_it_drops(self):
        tr = profiler.Tracer(max_spans=2)
        tr.enable()
        for name in "abc":
            with tr.span(name):
                pass
        tr.instant("marker")
        assert [s.name for s in tr.get_spans()] == ["a", "b"]
        assert tr.dropped == 1 and len(tr.get_instants()) == 1


class TestChromeTrace:
    def test_schema_and_containment(self, tmp_path):
        profiler.enable_tracing()
        with profiler.span("parent"):
            with profiler.span("child"):
                pass
        profiler.instant("step_marker", step=0)
        path = profiler.export_chrome_trace(str(tmp_path / "trace.json"))
        doc = json.load(open(path))
        events = doc["traceEvents"]
        complete = [e for e in events if e["ph"] == "X"]
        instants = [e for e in events if e["ph"] == "i"]
        metas = [e for e in events if e["ph"] == "M"]
        assert {e["name"] for e in complete} == {"parent", "child"}
        assert [e["name"] for e in instants] == ["step_marker"]
        assert any(e["name"] == "process_name" for e in metas)
        for e in complete:
            for k in ("pid", "tid", "ts", "dur", "cat", "args"):
                assert k in e, f"missing {k} in {e}"
        par = next(e for e in complete if e["name"] == "parent")
        chl = next(e for e in complete if e["name"] == "child")
        assert chl["args"]["parent_id"] == par["args"]["span_id"]
        assert par["ts"] <= chl["ts"]
        assert chl["ts"] + chl["dur"] <= par["ts"] + par["dur"] + 1e-3
        assert chl["tid"] == par["tid"]

    def test_stop_profiler_writes_profile_path(self, tmp_path):
        with RecordEvent("profiled_event"):
            pass
        ppath = tmp_path / "profile.txt"
        tpath = tmp_path / "timeline.json"
        stop_profiler(profile_path=str(ppath), timeline_path=str(tpath))
        assert "profiled_event" in ppath.read_text()
        assert "traceEvents" in tpath.read_text()

    def test_profiler_session_records_ranges_in_the_timeline(self,
                                                             tmp_path):
        """Inside a ``start_profiler`` session RecordEvent opens a
        ``record_function`` range: the timeline (torch.profiler's trace)
        holds it, with the work it bracketed inside it."""
        start_profiler()
        assert utils_profiler._torch_recording()
        with RecordEvent("session/outer"):
            with RecordEvent("session/inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        tpath = tmp_path / "device.json"
        ppath = tmp_path / "profile.txt"
        stop_profiler(profile_path=str(ppath), timeline_path=str(tpath))
        assert not utils_profiler._torch_recording()
        events = json.load(open(tpath))["traceEvents"]
        ranges = {e["name"]: e for e in events
                  if e.get("cat") == "user_annotation"}
        assert {"session/outer", "session/inner"} <= set(ranges)
        outer = ranges["session/outer"]
        mm = [e for e in events if e.get("name") == "aten::mm"]
        assert mm and all(outer["ts"] <= e["ts"] <= outer["ts"]
                          + outer["dur"] for e in mm)
        assert "session/inner" in ppath.read_text()
        assert [s.name for s in profiler.get_spans()] == [
            "session/inner", "session/outer"]

    def test_metrics_snapshot_carries_spans_and_device_memory(self):
        with RecordEvent("snap_event"):
            pass
        snap = profiler.metrics_snapshot()
        assert set(snap) == set(jax_profiler.metrics_snapshot())
        assert snap["span_aggregates"]["snap_event"]["calls"] == 1
        # no card here: empty, as the JAX package's on the CPU
        assert snap["device_memory"] == {} == \
            profiler.device_memory_stats()


def _shape(spans):
    """(name, depth, parent's name) of each span, in start order."""
    by_id = {s.span_id: s for s in spans}
    return [(s.name, s.depth,
             by_id[s.parent_id].name if s.parent_id in by_id else None)
            for s in sorted(spans, key=lambda s: s.start_ns)]


class TestServingTrace:
    def test_engine_end_to_end_trace_and_attribution(self, port, tmp_path):
        profiler.enable_tracing()
        profiler.cost_registry.reset()
        eng = ServingEngine(port, page_size=4, max_batch_size=4, eos_id=-1,
                            device="cpu")
        rng = np.random.RandomState(0)
        for i in range(4):
            eng.add_request(
                rng.randint(1, VOCAB, (4 + 3 * i,)).astype(np.int32),
                max_new_tokens=4)
        outs = eng.drain()
        assert len(outs) == 4
        snap = eng.metrics.snapshot()
        assert snap["step_latency_ms"]["count"] >= 4
        for k in ("p50", "p95", "p99"):
            assert snap["step_latency_ms"][k] > 0
        costs = eng.stats()["jit_costs"]
        assert costs["serving.ragged_step"]["compile_count"] >= 1
        assert snap["prefill_latency_ms"]["count"] == 4
        path = profiler.export_chrome_trace(str(tmp_path / "serve.json"))
        events = json.load(open(path))["traceEvents"]
        by_name = {}
        for e in events:
            if e["ph"] == "X":
                by_name.setdefault(e["name"], []).append(e)
        assert "serving/step" in by_name
        assert "serving/ragged_step" in by_name
        step_ids = {e["args"]["span_id"] for e in by_name["serving/step"]}
        for child in by_name["serving/ragged_step"]:
            assert child["args"]["parent_id"] in step_ids
        assert all("bucket" in e["args"] and "rows" in e["args"]
                   for e in by_name["serving/ragged_step"])

    @pytest.mark.parametrize("knobs", [{"ragged": False},
                                       {"spec_decode": 4}],
                             ids=["split", "spec"])
    def test_engine_span_names_match_jax(self, shared_gpt_small, port,
                                         knobs):
        """The split engine (decode_step, prefill, prefill_chunk) and the
        speculative one (spec_verify) open the JAX engine's spans, with
        the same names and parents."""
        from paddle_tpu.serving import ServingEngine as JaxEngine

        prompts = [np.random.RandomState(5 + i).randint(
            1, VOCAB, (5 + 4 * i,)).astype(np.int32) for i in range(3)]
        kw = dict(page_size=4, max_batch_size=4, eos_id=-1,
                  prefill_chunk=8, **knobs)
        names = {}
        for pkg, eng, prof in (
                ("jax", JaxEngine(shared_gpt_small, **kw), jax_profiler),
                ("port", ServingEngine(port, device="cpu", **kw),
                 profiler)):
            prof.enable_tracing()
            for p in prompts:
                eng.add_request(np.concatenate([p, p]), max_new_tokens=6)
            eng.drain()
            prof.disable_tracing()
            names[pkg] = sorted({(n, parent) for n, _, parent in
                                 _shape(prof.get_spans())})
            prof.clear_spans()
        assert names["port"] == names["jax"]
        assert ("serving/spec_verify" if "spec_decode" in knobs
                else "serving/prefill_chunk") in {n for n, _ in
                                                  names["port"]}

    def test_generate_spans_match_jax(self, shared_gpt_small, port):
        ids = np.random.RandomState(3).randint(1, VOCAB, (2, 6)).astype(
            np.int32)
        jax_profiler.enable_tracing()
        try:
            want_ids = np.asarray(jax_generate(shared_gpt_small, ids,
                                               max_new_tokens=5)[0].numpy())
        finally:
            jax_profiler.disable_tracing()
        want = _shape(jax_profiler.get_spans())
        jax_profiler.clear_spans()
        profiler.enable_tracing()
        got_ids = generate(port, ids, max_new_tokens=5)[0].numpy()
        got = _shape(profiler.get_spans())
        assert got == want
        assert [n for n, _, _ in got] == [
            "text.generation", "text.generation/prefill",
            "text.generation/decode"]
        args = {s.name: s.args for s in profiler.get_spans()}
        assert args["text.generation"] == {"strategy": "greedy",
                                           "batch": 2, "prompt_len": 6}
        np.testing.assert_array_equal(got_ids, want_ids)

    def test_optimizer_step_span(self, port):
        from paddle_tpu_torch.optimizer import SGD

        m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=1,
                     num_heads=2, ffn_size=64, max_seq_len=16,
                     device="cpu", seed=2)
        opt = SGD(0.1, parameters=list(m.parameters()))
        m(torch.ones((1, 4), dtype=torch.int64)).sum().backward()
        profiler.enable_tracing()
        opt.step()
        assert [s.name for s in profiler.get_spans()] == ["optimizer/step"]


def test_http_chrome_format_equals_jax_renderer(port):
    fe = ServingFrontend(port, replicas=1, device="cpu",
                         engine_kwargs=dict(page_size=4, max_batch_size=4,
                                            eos_id=-1))
    srv = start_http_server(fe, port=0)
    try:
        h = fe.submit(np.array([3, 5, 7], np.int32), max_new_tokens=4)
        assert h.wait(timeout=120) == "completed"
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        conn.request("GET", f"/debug/requests/{h.request_id}?format=chrome")
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
        assert r.status == 200
        trace = fe.trace(h.request_id)
        assert doc == json.loads(json.dumps(
            jax_request_trace_events(trace)))
        bars = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert f"{h.request_id}@replica-0" in bars
    finally:
        srv.stop()
        fe.close()


class TestRecordEventOverhead:
    def test_disabled_overhead_is_bounded(self):
        """With tracing off a RecordEvent is one aggregate update; under
        150 us per event (the JAX test's bound), and no record_function
        runs while torch's profiler is off."""
        n = 2000
        with RecordEvent("warm"):
            pass
        t0 = time.perf_counter()
        for _ in range(n):
            with RecordEvent("overhead_probe") as ev:
                assert ev._scope is None
        per_call = (time.perf_counter() - t0) / n
        assert per_call < 150e-6, f"{per_call * 1e6:.1f}us per event"
        # the JAX package's reset clears the JAX tracer only
        jax_utils_profiler.reset_profiler()
        assert profiler.aggregates()["overhead_probe"]["calls"] == n
