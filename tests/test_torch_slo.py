"""The front door's host-side state of paddle_tpu_torch vs paddle_tpu,
under one injected clock (no model, no device):

- ``framework/monitor.py``: ``WindowedHistogram`` and ``LabeledGauge``
  fed the same timed samples give equal snapshots;
- ``profiler/slo.py``: ``SLOTracker`` over the same counter and
  histogram sequences gives equal ``evaluate()``, ``active_alerts()``
  and ``alert_log()`` (error-budget and latency objectives, fire and
  clear with hysteresis, the brownout pressure floor);
- ``serving/router.py``: ``Router`` picks and ``healthz()`` after the
  same charge / discharge / mark sequence, and ``FleetMetrics`` over
  it;
- ``serving/metrics.py``: ``FrontendMetrics`` snapshots after the same
  outcomes;
- ``profiler/exposition.py``: ``prometheus_text`` of two registries fed
  the same stats is byte-equal;
- ``profiler/flight_recorder.py``: ``build_bundle`` has the same keys,
  and a dumped bundle is loadable JSON.
"""
import json

import numpy as np
import pytest

from paddle_tpu.framework import monitor as jax_monitor
from paddle_tpu.profiler import exposition as jax_exposition
from paddle_tpu.profiler import flight_recorder as jax_flight
from paddle_tpu.profiler import slo as jax_slo
from paddle_tpu.serving import metrics as jax_metrics
from paddle_tpu.serving import router as jax_router
from paddle_tpu_torch.framework import monitor as port_monitor
from paddle_tpu_torch.profiler import exposition as port_exposition
from paddle_tpu_torch.profiler import flight_recorder as port_flight
from paddle_tpu_torch.profiler import slo as port_slo
from paddle_tpu_torch.serving import metrics as port_metrics
from paddle_tpu_torch.serving import router as port_router

PACKAGES = {
    "jax": (jax_monitor, jax_slo, jax_router, jax_metrics, jax_exposition,
            jax_flight),
    "port": (port_monitor, port_slo, port_router, port_metrics,
             port_exposition, port_flight),
}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


def _timed_samples(seed: int, n: int = 400):
    """(clock advance s, value) pairs spanning several windows."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(0.6, n)
    vals = rng.lognormal(3.0, 1.2, n)
    return list(zip(gaps.tolist(), vals.tolist()))


def test_windowed_histogram_and_labeled_gauge_snapshots_equal():
    snaps = {}
    for pkg, (mon, *_rest) in PACKAGES.items():
        clk = FakeClock(1000.0)
        wh = mon.WindowedHistogram(window_s=60.0, slices=6, clock=clk)
        gauge = mon.LabeledGauge()
        out = []
        for i, (dt, v) in enumerate(_timed_samples(3)):
            clk.advance(dt)
            wh.observe(v)
            gauge.set(v, replica=f"replica-{i % 3}", role="any")
            gauge.add(1.0, replica="all", role="decode")
            if i % 25 == 0:
                out.append((wh.snapshot(), wh.percentile(95),
                            wh.exposition_state(), gauge.values()))
        clk.advance(61.0)                  # an idle gap empties the ring
        out.append((wh.snapshot(), wh.exposition_state(),
                    gauge.values()))
        snaps[pkg] = out
    assert snaps["port"] == snaps["jax"]


def _tracker(slo, mon, clk, prefix):
    """A tracker over an error-budget and a latency objective on
    package-private counter names."""
    objectives = (
        slo.SLOObjective(name="avail", target=0.99,
                         bad=(f"{prefix}.bad",),
                         total=(f"{prefix}.total",)),
        slo.SLOObjective(name="lat", kind="latency", target=0.95,
                         histogram=f"{prefix}.lat_ms", threshold_ms=250.0),
    )
    pol = slo.SLOPolicy(objectives=objectives, fast_window_s=60.0,
                        slow_window_s=300.0, budget_window_s=3600.0,
                        burn_threshold=10.0, fire_after=2, clear_after=3,
                        eval_interval_s=1.0)
    for name in (f"{prefix}.bad", f"{prefix}.total"):
        mon.stat_registry.get(name).reset()
    mon.stat_registry.histogram(f"{prefix}.lat_ms").reset()
    return slo.SLOTracker(pol, clock=clk)


@pytest.mark.parametrize("scenario", ["storm_then_clear", "latency_burn",
                                      "steady"])
def test_slo_tracker_same_verdicts(scenario):
    rng = np.random.RandomState({"storm_then_clear": 1, "latency_burn": 2,
                                 "steady": 3}[scenario])
    # one shared event script: (advance s, bad, total, latency samples)
    script = []
    for step in range(60):
        if scenario == "storm_then_clear":
            bad = 40 if 5 <= step < 12 else 0
        elif scenario == "latency_burn":
            bad = int(rng.randint(0, 2))
        else:
            bad = 0
        lat_hi = 2000.0 if (scenario == "latency_burn"
                            and 10 <= step < 30) else 240.0
        lats = rng.uniform(5.0, lat_hi, 20).tolist()
        script.append((10.0, bad, 100, lats))
    results = {}
    for pkg, (mon, slo, *_rest) in PACKAGES.items():
        clk = FakeClock(0.0)
        tr = _tracker(slo, mon, clk, "t.torch_slo")
        bad = mon.stat_registry.get("t.torch_slo.bad")
        total = mon.stat_registry.get("t.torch_slo.total")
        hist = mon.stat_registry.histogram("t.torch_slo.lat_ms")
        policy = jax_res_policy() if pkg == "jax" else port_res_policy()
        out = [tr.evaluate(now=0.0)]
        for dt, b, t, lats in script:
            clk.advance(dt)
            bad.add(b)
            total.add(t)
            for v in lats:
                hist.observe(v)
            out.append(tr.evaluate(now=clk.t))
            out.append(tr.active_alerts())
            out.append(tr.brownout_pressure_floor(policy))
        out.append([{k: v for k, v in e.items()} for e in tr.alert_log()])
        out.append(tr.status())
        results[pkg] = out
    assert results["port"] == results["jax"]
    if scenario != "steady":
        assert any(e["kind"] == "slo.fire" for e in results["jax"][-2])
    if scenario == "storm_then_clear":
        assert results["jax"][-2][-1]["kind"] == "slo.clear"


def jax_res_policy():
    from paddle_tpu.serving.resilience import BrownoutPolicy

    return BrownoutPolicy()


def port_res_policy():
    from paddle_tpu_torch.serving.resilience import BrownoutPolicy

    return BrownoutPolicy()


def test_default_slo_policy_equal():
    want = jax_slo.SLOPolicy.default()
    got = port_slo.SLOPolicy.default()
    assert [(o.name, o.kind, o.target, tuple(o.bad), tuple(o.total),
             o.histogram, o.threshold_ms) for o in got.objectives] == \
        [(o.name, o.kind, o.target, tuple(o.bad), tuple(o.total),
          o.histogram, o.threshold_ms) for o in want.objectives]
    assert (got.fast_window_s, got.slow_window_s, got.burn_threshold,
            got.fire_after, got.clear_after) == \
        (want.fast_window_s, want.slow_window_s, want.burn_threshold,
         want.fire_after, want.clear_after)


class _NoEngine:
    """A replica's engine stand-in: the router reads nothing of it."""


def _router_drive(router_mod, metrics_mod):
    r = router_mod.Router()
    reps = [router_mod.Replica("replica-0", _NoEngine()),
            router_mod.Replica("replica-1", _NoEngine()),
            router_mod.Replica("prefill-0", _NoEngine(), role="prefill"),
            router_mod.Replica("decode-0", _NoEngine(), role="decode",
                               mesh_size=4)]
    for rep in reps:
        r.add(rep)
    fleet = metrics_mod.FleetMetrics(r)
    rng = np.random.RandomState(9)
    log = []

    def pick(**kw):
        rep = r.pick(**kw)
        log.append(None if rep is None else rep.id)
        return rep

    for i in range(40):
        cost = int(rng.randint(3, 60))
        role = (None, "prefill", "decode")[i % 3]
        rep = pick(cost=cost, role=role)
        if rep is not None:
            r.charge(rep, cost)
        if i % 7 == 3:
            r.discharge(reps[i % 4], int(rng.randint(1, 20)))
        if i == 10:
            r.mark_suspect(reps[0])
        if i == 14:
            r.mark_healthy(reps[0])
        if i == 18:
            r.set_draining("replica-1")
        if i == 25:
            r.mark_dead(reps[2], "injected")
        if i == 30:
            pick(cost=5, exclude=reps[3])
        log.append(fleet.refresh())
    hz = r.healthz()
    for rep in hz["replicas"]:
        rep.pop("last_step_age_s")
        rep.pop("busy_for_s")
    log.append(hz)
    log.append([rep.outstanding_tokens for rep in reps])
    return log


def test_router_picks_healthz_and_fleet_rollup_equal():
    want = _router_drive(jax_router, jax_metrics)
    got = _router_drive(port_router, port_metrics)
    assert got == want
    assert None not in [x for x in want if not isinstance(x, (dict, list))]


def test_frontend_metrics_snapshots_equal():
    snaps = {}
    for pkg, (_mon, _slo, _router, metrics, *_rest) in PACKAGES.items():
        clk = FakeClock(50.0)
        fm = metrics.FrontendMetrics(clock=clk)
        rng = np.random.RandomState(4)
        out = []
        for i in range(60):
            clk.advance(float(rng.exponential(2.0)))
            fm.on_submit()
            kind = i % 6
            if kind == 0:
                fm.on_reject()
            elif kind == 1:
                fm.on_deadline_miss()
            elif kind == 2:
                fm.on_retry()
                fm.on_recompute_saved(int(rng.randint(1, 16)))
            elif kind == 3:
                fm.on_cancel()
            else:
                fm.on_complete(float(rng.uniform(0.01, 0.5)),
                               float(rng.uniform(0.5, 3.0)))
            fm.set_queue_depth(i % 5)
            fm.set_inflight(i % 9)
            if i % 10 == 0:
                out.append(fm.snapshot())
        fm.on_recovered()
        fm.on_failure()
        out.append(fm.snapshot())
        snaps[pkg] = out
    assert snaps["port"] == snaps["jax"]


def _feed_registry(mon):
    reg = mon.StatRegistry()
    clk = FakeClock(0.0)
    rng = np.random.RandomState(12)
    reg.get("serving.steps").add(17)
    reg.get("serving.frontend.completed").add(5)
    reg.get("t_mem").add(8)
    reg.labeled_gauge("t.mem").set(7, kind="host")
    reg.labeled_gauge("serving.fleet.state").set(
        2, replica='rep "zero"\\x', role="pre\nfill")
    reg.labeled_gauge("serving.slo.alert").set(1.0, objective="avail")
    h = reg.histogram("serving.step_ms")
    for v in rng.lognormal(0.5, 1.0, 200).tolist() + [1e9]:
        h.observe(v)
    reg.histogram("t_col").observe(2.0)
    reg.get("t.col").add(1)
    w = reg.windowed("serving.window.ttft_ms", 60.0, 6, clock=clk)
    for v in rng.uniform(1.0, 900.0, 50).tolist():
        clk.advance(0.7)
        w.observe(v)
    return reg


def test_prometheus_text_byte_equal():
    want = jax_exposition.prometheus_text(_feed_registry(jax_monitor))
    got = port_exposition.prometheus_text(_feed_registry(port_monitor))
    assert got == want
    assert "# TYPE serving_window_ttft_ms summary" in got


def test_flight_recorder_bundle_keys_equal(tmp_path):
    jrec = jax_flight.FlightRecorder(ring_size=8)
    prec = port_flight.FlightRecorder(ring_size=8)
    for rec in (jrec, prec):
        ctx = rec.start_trace("r-0")
        ctx.event("queued", prompt_tokens=3)
        rec.request_event("r-0", "placed", replica="replica-0")
        rec.on_step("replica-0", bucket=1, lanes=1, pages_in_use=2,
                    step_ms=1.5)
        rec.on_fault("replica.kill", "replica-0", "kill", 1)
        rec.on_transition("replica.dead", "replica-0", "injected")
        rec.register_context("fe", lambda: {"replicas": 2})
        rec.start_trace("r-1").terminal("completed", tokens=4)
    want = jrec.build_bundle("test")
    got = prec.build_bundle("test")
    assert set(got) == set(want)
    for key in ("events", "engine_steps", "chaos_faults", "transitions",
                "live_traces", "terminal_traces", "context"):
        strip = (lambda xs: [{k: v for k, v in x.items()
                              if k not in ("ts_ns", "t_ms")}
                             for x in xs])
        if key == "context":
            assert got[key] == want[key]
        elif key.endswith("traces"):
            assert [(t["request_id"], t["status"], strip(t["events"]))
                    for t in got[key]] == \
                [(t["request_id"], t["status"], strip(t["events"]))
                 for t in want[key]]
        else:
            assert strip(got[key]) == strip(want[key]), key
    assert prec.snapshot().keys() == jrec.snapshot().keys()
    assert [r["request_id"] for r in prec.recent_traces()] == \
        [r["request_id"] for r in jrec.recent_traces()]
    assert prec.live_request_ids() == jrec.live_request_ids() == ["r-0"]
    path = tmp_path / "bundle.json"
    prec.dump("manual", path=str(path))
    loaded = json.loads(path.read_text())
    assert loaded["reason"] == "manual" and loaded["context"] == {
        "fe": {"replicas": 2}}
    prec.configure(bundle_dir=str(tmp_path / "auto"))
    assert prec.auto_dump("replica died")["path"].endswith(
        "postmortem-0001.json")
