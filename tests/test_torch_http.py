"""paddle_tpu_torch's stdlib HTTP surface (``serving/http.py`` over the
front door, ``profiler/exposition.py`` and the error taxonomy's
``http_status_for``) vs paddle_tpu, on the CPU.

- ``POST /generate`` streams (chunked NDJSON) and returns (one JSON
  body) the tokens of paddle_tpu's ``generate``; malformed bodies are
  400, unknown routes 404, a chaos ``http.request`` fault answers its
  status;
- ``GET /healthz`` has paddle_tpu's keys; ``GET /metrics`` parses as
  Prometheus text with the ``serving.*`` families; the request-trace
  routes answer;
- ``http_status_for`` maps every error class of the taxonomy to the
  status paddle_tpu maps it to.
"""
import http.client
import inspect
import json

import numpy as np
import pytest

from paddle_tpu.framework import errors as jax_errors
from paddle_tpu.jit.functional import get_state
from paddle_tpu.serving import ServingFrontend as JaxFrontend
from paddle_tpu.serving import start_http_server as jax_start_http_server
from paddle_tpu_torch.framework import errors as port_errors
from paddle_tpu_torch.serving import ServingFrontend, start_http_server
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.testing.chaos import ChaosPlan, Fault
from paddle_tpu_torch.text.models import GPTModel, load_numpy_state

VOCAB = 50
ENGINE_KW = dict(page_size=4, max_batch_size=4, eos_id=0)


@pytest.fixture(scope="module")
def port(shared_gpt_small):
    state = {k: np.asarray(v)
             for k, v in get_state(shared_gpt_small)[0].items()}
    m = GPTModel(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                 num_heads=2, ffn_size=64, max_seq_len=64, device="cpu")
    return load_numpy_state(m, state)


def _reference(memo, gpt, prompt, budget):
    w = memo(gpt, prompt, budget, end_id=0)
    if (w == 0).any():
        w = w[: int(np.argmax(w == 0)) + 1]
    return w


def _get(conn, path):
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, r.read()


def _parse_prometheus(text):
    """{family: type} of a 0.0.4 text page; every sample line must
    belong to a declared family and carry a float value."""
    types = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            assert name not in types, f"duplicate TYPE {name}"
            types[name] = typ
        elif line and not line.startswith("#"):
            name = line.split("{", 1)[0].split(" ", 1)[0]
            base = next((f for f in types if name == f
                         or name.startswith(f + "_")), None)
            assert base is not None, line
            float(line.rsplit(" ", 1)[1])
    return types


def test_generate_stream_healthz_metrics(port, shared_gpt_small,
                                         greedy_ref_memo):
    fe = ServingFrontend(port, replicas=1, queue_cap=8,
                         engine_kwargs=dict(ENGINE_KW), device="cpu")
    srv = start_http_server(fe, port=0)
    jfe = JaxFrontend(shared_gpt_small, replicas=1,
                      engine_kwargs=dict(ENGINE_KW))
    jsrv = jax_start_http_server(jfe)
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
        prompt = [3, 7, 11, 2]
        ref = _reference(greedy_ref_memo, shared_gpt_small, prompt, 6)
        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt, "max_new_tokens": 6}),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type") == "application/x-ndjson"
        assert r.getheader("Transfer-Encoding") == "chunked"
        lines = [json.loads(ln) for ln in
                 r.read().decode().strip().split("\n")]
        toks = [ln["token"] for ln in lines if "token" in ln]
        assert toks == ref.tolist()
        assert [ln["index"] for ln in lines if "token" in ln] == \
            list(range(len(toks)))
        final = lines[-1]
        assert final["done"] and final["status"] == "completed"
        assert final["num_tokens"] == len(toks) and final["error"] is None
        assert final["ttft_ms"] > 0 and final["e2e_ms"] > 0

        conn.request("POST", "/generate",
                     json.dumps({"prompt": prompt, "max_new_tokens": 6,
                                 "stream": False}), {})
        r2 = conn.getresponse()
        body = json.loads(r2.read())
        assert r2.status == 200 and body["tokens"] == ref.tolist()

        status, raw = _get(conn, "/healthz")
        hz = json.loads(raw)
        assert status == 200 and hz["status"] == "ok"
        assert hz["healthy_replicas"] == 1
        jconn = http.client.HTTPConnection(jsrv.host, jsrv.port,
                                           timeout=300)
        jstatus, jraw = _get(jconn, "/healthz")
        jhz = json.loads(jraw)
        assert jstatus == status
        assert set(hz) == set(jhz)
        for key in ("slo", "tiers", "window"):
            assert set(hz[key]) == set(jhz[key]), key
        assert set(hz["replicas"][0]) == set(jhz["replicas"][0])

        status, raw = _get(conn, "/metrics")
        text = raw.decode()
        assert status == 200
        types = _parse_prometheus(text)
        for name in ("serving_frontend_ttft_ms", "serving_frontend_e2e_ms",
                     "serving_frontend_completed",
                     "serving_frontend_queue_depth", "serving_steps",
                     "serving_fleet_state", "serving_slo_attainment"):
            assert name in types, name
        assert types["serving_frontend_window_ttft_ms"] == "summary"

        status, raw = _get(conn, "/debug/requests")
        listing = json.loads(raw)
        assert status == 200 and listing["recent"]
        rid = listing["recent"][-1]["request_id"]
        status, raw = _get(conn, f"/debug/requests/{rid}")
        kinds = [e["kind"] for e in json.loads(raw)["events"]]
        assert status == 200 and kinds[0] == "queued"
        assert kinds[-1] == "terminal"
        assert _get(conn, "/debug/requests/nope")[0] == 404
        status, raw = _get(conn, f"/debug/requests/{rid}?format=chrome")
        chrome = json.loads(raw)
        assert status == 200 and chrome["traceEvents"]
        assert [e["name"] for e in chrome["traceEvents"]
                if e["ph"] == "i"] == kinds

        for bad in ({"prompt": []}, {"prompt": "xx"}, {},
                    {"prompt": [1], "max_new_tokens": 9999}):
            conn.request("POST", "/generate", json.dumps(bad), {})
            rb = conn.getresponse()
            assert rb.status == 400, bad
            rb.read()
        assert _get(conn, "/nope")[0] == 404

        plan = ChaosPlan([Fault("http.request", at=1, action="http_error",
                                status=503)])
        with chaos.running(plan):
            conn.request("POST", "/generate",
                         json.dumps({"prompt": prompt}), {})
            rc = conn.getresponse()
            assert rc.status == 503 and json.loads(rc.read())["chaos"]
    finally:
        srv.stop()
        fe.close()
        jsrv.stop()
        jfe.close()


def test_rejections_map_through_the_taxonomy(port):
    fe = ServingFrontend(port, replicas=1, queue_cap=1, device="cpu",
                         engine_kwargs=dict(page_size=4, max_batch_size=4,
                                            eos_id=-1))
    srv = start_http_server(fe)
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
        hold = fe.submit(np.array([3, 5], np.int32), max_new_tokens=24)
        conn.request("POST", "/generate",
                     json.dumps({"prompt": [2, 9], "max_new_tokens": 4}),
                     {})
        r = conn.getresponse()
        body = json.loads(r.read())
        assert r.status == 429 and body["status"] == "rejected"
        assert body["error"] == "ResourceExhaustedError"
        assert hold.wait(timeout=120) == "completed"
        conn.request("POST", "/generate",
                     json.dumps({"prompt": [2, 9], "max_new_tokens": 4,
                                 "deadline_ms": 0}), {})
        r = conn.getresponse()
        body = json.loads(r.read())
        assert r.status == 504 and body["error"] == "DeadlineExceededError"
    finally:
        srv.stop(close_frontend=True)


def _taxonomy(mod):
    return {name: cls for name, cls in inspect.getmembers(mod,
                                                          inspect.isclass)
            if issubclass(cls, mod.EnforceNotMet)}


def test_http_status_for_matches_jax_for_every_error_class():
    want, got = _taxonomy(jax_errors), _taxonomy(port_errors)
    assert set(got) == set(want)
    for name, cls in want.items():
        pcls = got[name]
        assert [b.__name__ for b in pcls.__mro__] == \
            [b.__name__ for b in cls.__mro__], name
        assert port_errors.http_status_for(pcls) == \
            jax_errors.http_status_for(cls), name
        assert port_errors.http_status_for(pcls("x")) == \
            jax_errors.http_status_for(cls("x")), name
    assert port_errors.http_status_for(KeyError) == \
        jax_errors.http_status_for(KeyError) == 500
