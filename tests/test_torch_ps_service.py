"""paddle_tpu_torch's PS service (``distributed/ps/service.py``) against
the JAX package's.

One cluster per package for the module (2 in-process ``PSServer``s and a
``PSClient``, the reference's brpc_service test pattern); every request
goes to both with the same numpy payload, and the answers are equal bit
for bit (the same numpy code behind the same routing, ``id % servers``):
sparse pull (lazy creation, ``create=False`` zeros), push (the sgd and
adagrad rules), weight deltas, save / load across the shards, dense
tables, the table size, errors shipped to the client, the heartbeat's
worker list, ``RemoteSparseTable`` and ``AsyncPushQueue``.

Then one process-level run through ``python -m
paddle_tpu_torch.distributed.launch``: 2 server processes and 2 trainer
processes in geo mode (k 4), as ``tests/test_ps_service.py`` runs the
JAX package's: both losses fall, rank 0 reads rank 1's rows from the
servers, the servers stop cleanly.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu.distributed.ps import service as jsvc
from paddle_tpu_torch.distributed.ps import service as tsvc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cluster(svc):
    servers = [svc.PSServer("127.0.0.1:0", server_id=i, num_servers=2)
               for i in range(2)]
    for s in servers:
        s.start()
    return servers, svc.PSClient([s.endpoint for s in servers],
                                 client_id="w0")


@pytest.fixture(scope="module")
def clusters():
    out = {"jax": _cluster(jsvc), "port": _cluster(tsvc)}
    yield {k: v[1] for k, v in out.items()}
    for servers, client in out.values():
        client.close()
        for s in servers:
            s.stop()


def _both(clusters, fn):
    got = fn(clusters["port"])
    want = fn(clusters["jax"])
    return got, want


def _equal(clusters, fn):
    got, want = _both(clusters, fn)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sparse_rpcs_equal_the_reference(clusters):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1000, 64)
    for c in clusters.values():
        c.create_table("emb", dim=6, rule="adagrad", seed=3)
    _equal(clusters, lambda c: c.pull_sparse("emb", ids))
    for step in range(3):
        g = rng.randn(64, 6).astype(np.float32)
        _both(clusters, lambda c: c.push_sparse("emb", ids, g, lr=0.1))
        _equal(clusters, lambda c: c.pull_sparse("emb", ids[::3]))
    d = rng.randn(5, 6).astype(np.float32)
    _both(clusters, lambda c: c.push_sparse_delta("emb", ids[:5], d))
    _equal(clusters, lambda c: c.pull_sparse("emb", [10 ** 7, int(ids[0])],
                                             create=False))
    _equal(clusters, lambda c: c.table_size("emb"))
    state, _ = _both(clusters, lambda c: c.save("emb"))
    _equal(clusters, lambda c: {k: np.sort(v, axis=0)
                                for k, v in c.save("emb").items()})
    for c in clusters.values():
        c.create_table("copy", dim=6, rule="adagrad")
        c.load("copy", state)
    _equal(clusters, lambda c: c.pull_sparse("copy", ids, create=False))


def test_dense_table_and_errors(clusters):
    for c in clusters.values():
        c.create_table("dense", kind="dense", shape=(3, 2), init="normal",
                       seed=1)
    _equal(clusters, lambda c: c.pull_dense("dense"))
    g = np.ones((3, 2), np.float32)
    _both(clusters, lambda c: c.push_dense("dense", g, lr=0.5))
    _equal(clusters, lambda c: c.pull_dense("dense"))
    with pytest.raises(RuntimeError, match="KeyError") as te:
        clusters["port"].pull_sparse("missing", [1])
    with pytest.raises(RuntimeError) as je:
        clusters["jax"].pull_sparse("missing", [1])
    assert str(te.value) == str(je.value)


def test_remote_table_and_async_queue(clusters):
    client = clusters["port"]
    table = tsvc.RemoteSparseTable(client, "remote", dim=4, rule="sgd",
                                   initializer="zeros")
    q = tsvc.AsyncPushQueue(table)
    g = np.ones((2, 4), np.float32)
    for _ in range(5):
        q.put([1, 2], g, 0.1)
    q.flush(timeout=30)
    np.testing.assert_allclose(table.pull([1, 2]), -0.5 * g, rtol=1e-6)
    q.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        q.put([1], g[:1], 0.1)
    jt = jsvc.RemoteSparseTable(clusters["jax"], "remote", dim=4,
                                rule="sgd", initializer="zeros")
    jt.push([1, 2], g, lr=0.5)
    np.testing.assert_array_equal(table.pull([1, 2, 3]),
                                  jt.pull([1, 2, 3]))
    assert table.size == jt.size == 3


def test_heartbeat_lists_the_workers(clusters):
    for c in clusters.values():
        c.barrier_ping()
    health, _ = _both(clusters, lambda c: c.health())
    assert len(health) == 2
    assert all("w0" in h["workers"] and h["dead"] == [] for h in health)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_geo_cluster_two_servers_two_launched_trainers(tmp_path):
    child = os.path.join(ROOT, "tests", "torch_fleet_child.py")
    server_list = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(2))
    env = dict(os.environ, PADDLE_PSERVERS_IP_PORT_LIST=server_list,
               PADDLE_DIST_BACKEND="gloo",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for k in ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ID"):
        env.pop(k, None)
    servers = [subprocess.Popen(
        [sys.executable, child, "server"],
        env=dict(env, TRAINING_ROLE="PSERVER", PADDLE_PSERVER_ID=str(sid)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for sid in range(2)]
    try:
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node=2", f"--started_port={_free_port()}",
             f"--gloo_port={_free_port()}", "--log_dir",
             str(tmp_path / "logs"), child, "trainer", str(tmp_path)],
            env=dict(env, TRAINING_ROLE="TRAINER"), cwd=ROOT,
            capture_output=True, text=True, timeout=240)
        logs = "".join(p.read_text() for p in (tmp_path / "logs").glob("*"))
        assert r.returncode == 0, r.stderr + logs
        outs = []
        for s in servers:
            stdout, stderr = s.communicate(timeout=60 - min(
                30, time.time() - t0))
            assert s.returncode == 0 and "SERVER STOPPED" in stdout, stderr
            outs.append(stdout)
    finally:
        for s in servers:
            if s.poll() is None:
                s.kill()
    res = {}
    for rank in range(2):
        with open(tmp_path / f"trainer{rank}.json") as f:
            res[rank] = json.load(f)
    for r in res.values():
        losses = r["losses"]
        assert np.mean(losses[-8:]) < np.mean(losses[:8]) * 0.9, losses
    assert res[0]["other_rows_nonzero"] is True
    assert res[0]["table_size"] > 0
