"""Cross-host PS service boundary: table shards behind an RPC server —
twin of ``paddle_tpu/distributed/ps/service.py`` (sockets and numpy
only: the same code, numpy on the wire).

Reference: distributed/service/server.h:64 PSServer (start/stop, tables
keyed by id), ps_client.h:60 PSClient (pull_sparse/push_sparse/
pull_dense/push_dense, save/load/clear, batched futures), brpc transport
(brpc_ps_server.cc / brpc_ps_client.cc), async send-queue in
service/communicator.cc.

Deployment note: the service rides the hosts' network (or localhost in
tests, exactly how the reference's own tests run their brpc servers);
a server process holds host memory only and creates no CUDA context.  Sparse ids are routed ``id % num_servers`` client-side; each
server holds a SparseTable shard per table name.  The wire format is the
same length-prefixed pickle as distributed/gloo.py — trainer processes
inside one trust boundary, the reference's brpc assumption."""
from __future__ import annotations

import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from ...framework.concurrency import OrderedCondition, OrderedLock
from ..gloo import _recv_msg, _send_msg, connect_with_retry
from .table import SparseTable

_DEFAULT_TIMEOUT = 300.0


class DenseTable:
    """Server-side dense parameter block (common_dense_table.cc analog):
    plain SGD on push, snapshot on pull."""

    def __init__(self, shape, lr: float = 0.01, init: str = "zeros",
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.values = (rng.randn(*shape).astype(np.float32) * 0.01
                       if init == "normal"
                       else np.zeros(shape, np.float32))
        self.lr = lr

    def pull(self) -> np.ndarray:
        return self.values.copy()

    def push(self, grad: np.ndarray, lr: Optional[float] = None) -> None:
        self.values -= (self.lr if lr is None else lr) * \
            np.asarray(grad, np.float32)


class PSServer:
    """One parameter-server process: hosts a shard of every table
    (server.h:64; start :80, stop :81)."""

    def __init__(self, endpoint: str, server_id: int = 0,
                 num_servers: int = 1, dead_after: float = 60.0):
        self.endpoint = endpoint
        self.server_id = server_id
        self.num_servers = num_servers
        self._sparse: Dict[str, SparseTable] = {}
        self._dense: Dict[str, DenseTable] = {}
        self._lock = OrderedLock("ps.server")
        self._stop_evt = threading.Event()
        self._srv: Optional[socket.socket] = None
        # heartbeat monitor (heart_beat_monitor.cc analog): last-seen per
        # client id; workers past `dead_after` report as dead in `health`
        self.dead_after = dead_after
        self._last_seen: Dict[str, float] = {}

    def start(self) -> int:
        """Bind + serve in background threads; returns the bound port."""
        host, port_s = self.endpoint.rsplit(":", 1)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port_s)))
        self._srv.listen(128)
        port = self._srv.getsockname()[1]
        self.endpoint = f"{host}:{port}"
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return port

    def run(self) -> None:
        """run_server(): block until a client sends stop (the reference
        server's joinable main loop)."""
        if self._srv is None:
            self.start()
        self._stop_evt.wait()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass

    # -- serving --

    def _accept_loop(self):
        while not self._stop_evt.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while True:
                req = _recv_msg(conn)
                try:
                    resp = self._handle(req)
                except Exception as e:  # noqa: BLE001 — ship to client
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                _send_msg(conn, resp)
                if req.get("op") == "stop":
                    self.stop()     # unblock run() — the server's main join
                    return
        except (ConnectionError, EOFError, OSError):
            return

    def _handle(self, req: dict) -> dict:
        op = req["op"]
        client = req.get("client")
        # a monitoring client must not register itself as a worker: only
        # WORK ops refresh liveness (review r4 finding: a status-page
        # poller would otherwise show up, then report "dead" on exit)
        if client is not None and op not in ("health", "bye"):
            with self._lock:
                self._last_seen[client] = time.time()
        if op == "bye":
            # clean worker shutdown: deregister so "dead" keeps meaning
            # CRASHED (heart_beat_monitor distinguishes completed workers)
            if client is not None:
                with self._lock:
                    self._last_seen.pop(client, None)
            return {"ok": True}
        if op == "health":
            now = time.time()
            with self._lock:
                ages = {c: round(now - t, 3)
                        for c, t in self._last_seen.items()}
            return {"ok": True, "workers": ages,
                    "dead": sorted(c for c, age in ages.items()
                                   if age > self.dead_after)}
        if op == "create_table":
            spec = dict(req["spec"])
            kind = spec.pop("kind", "sparse")
            with self._lock:
                if kind == "dense":
                    if req["name"] not in self._dense:
                        self._dense[req["name"]] = DenseTable(**spec)
                elif req["name"] not in self._sparse:
                    # fold the server id into the seed: shards must not
                    # draw identical init rows
                    spec.setdefault("seed", 0)
                    spec["seed"] = spec["seed"] * 97 + self.server_id
                    self._sparse[req["name"]] = SparseTable(**spec)
            return {"ok": True}
        if op == "pull_sparse":
            t = self._sparse[req["name"]]
            return {"ok": True,
                    "rows": t.pull(req["ids"], create=req.get("create",
                                                              True))}
        if op == "push_sparse":
            self._sparse[req["name"]].push(req["ids"], req["grads"],
                                           lr=req.get("lr", 0.01))
            return {"ok": True}
        if op == "push_sparse_delta":
            self._sparse[req["name"]].apply_deltas(req["ids"],
                                                   req["deltas"])
            return {"ok": True}
        if op == "pull_dense":
            return {"ok": True, "values": self._dense[req["name"]].pull()}
        if op == "push_dense":
            self._dense[req["name"]].push(req["grad"], lr=req.get("lr"))
            return {"ok": True}
        if op == "save":   # state_dict of this server's shard
            return {"ok": True,
                    "state": self._sparse[req["name"]].state_dict()}
        if op == "load":
            self._sparse[req["name"]].set_state_dict(req["state"])
            return {"ok": True}
        if op == "clear":
            with self._lock:
                name = req.get("name")
                if name is None:
                    self._sparse.clear()
                    self._dense.clear()
                else:
                    self._sparse.pop(name, None)
                    self._dense.pop(name, None)
            return {"ok": True}
        if op == "size":
            return {"ok": True, "size": self._sparse[req["name"]].size}
        if op == "ping" or op == "stop":
            return {"ok": True}
        raise ValueError(f"unknown op {op!r}")


class _ServerConn:
    """One client→server channel (socket + lock: PSClient calls come from
    multiple hogwild threads)."""

    def __init__(self, endpoint: str, timeout: float = _DEFAULT_TIMEOUT):
        host, port_s = endpoint.rsplit(":", 1)
        self.sock = connect_with_retry(host, int(port_s), timeout,
                                       what="PS server")
        self.lock = OrderedLock("ps.conn")

    def call(self, req: dict) -> dict:
        # holding the connection lock ACROSS the round-trip is the
        # design: one in-flight RPC per channel (the length-prefixed
        # wire format would interleave otherwise); concurrency comes
        # from one _ServerConn per server + the client's fan-out pool
        with self.lock:
            _send_msg(self.sock, req)  # analyze: allow[lock-discipline] per-channel serialization is the contract
            resp = _recv_msg(self.sock)  # analyze: allow[lock-discipline] per-channel serialization is the contract
        if not resp.get("ok"):
            raise RuntimeError(
                f"PS RPC {req.get('op')} failed: {resp.get('error')}")
        return resp

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class PSClient:
    """Client half (ps_client.h:60): batched pull/push routed id%n_servers."""

    def __init__(self, server_endpoints: Sequence[str],
                 client_id: Optional[str] = None,
                 heartbeat_interval: float = 0.0):
        if not server_endpoints:
            raise ValueError("PSClient needs at least one server endpoint")
        self._conns = [_ServerConn(ep) for ep in server_endpoints]
        self.num_servers = len(self._conns)
        import os as _os

        self.client_id = client_id or \
            f"worker-{_os.environ.get('PADDLE_TRAINER_ID', _os.getpid())}"
        self._hb_stop = threading.Event()
        self._hb_thread = None
        if heartbeat_interval > 0:
            # heart_beat_monitor analog: keep last-seen fresh even while
            # the trainer is busy between pulls.  weakref: the thread must
            # not keep a dropped client alive; transient RPC failures are
            # retried (one warning), not fatal — a single blip must not
            # let a healthy worker go "dead".
            import weakref

            ref = weakref.ref(self)
            stop = self._hb_stop

            def beat():
                import warnings

                warned = False
                while not stop.wait(heartbeat_interval):
                    c = ref()
                    if c is None:
                        return
                    try:
                        c.barrier_ping()
                    except Exception as e:  # noqa: BLE001 — monitor only
                        if not warned:
                            warned = True
                            warnings.warn(
                                f"PS heartbeat ping failed ({e}); "
                                "retrying", stacklevel=2)
                    del c

            self._hb_thread = threading.Thread(target=beat, daemon=True)
            self._hb_thread.start()
        # the reference client batches futures across servers
        # (ps_client.h pull_sparse); here: concurrent calls, one worker per
        # server, so a step's pull/push costs ~1 RTT instead of N
        self._pool = ThreadPoolExecutor(
            max_workers=self.num_servers,
            thread_name_prefix="ps-client") if self.num_servers > 1 else None

    def _call(self, server_idx: int, req: dict) -> dict:
        """Single-server RPC; stamps the client id (heartbeat last-seen)
        in ONE place so no call site can forget it."""
        req.setdefault("client", self.client_id)
        return self._conns[server_idx].call(req)

    def _fanout(self, requests):
        """[(server_idx, req)] -> [resp] in order, issued concurrently."""
        if self._pool is None or len(requests) <= 1:
            return [self._call(s, r) for s, r in requests]
        for _, r in requests:
            r.setdefault("client", self.client_id)
        futs = [self._pool.submit(self._conns[s].call, r)
                for s, r in requests]
        return [f.result() for f in futs]

    def create_table(self, name: str, **spec) -> None:
        self._fanout([(s, {"op": "create_table", "name": name,
                           "spec": spec})
                      for s in range(self.num_servers)])

    def _route(self, ids: np.ndarray):
        ids = np.asarray(ids).reshape(-1).astype(np.int64)
        return ids, ids % self.num_servers

    def pull_sparse(self, name: str, ids, create: bool = True) -> np.ndarray:
        ids, srv = self._route(ids)
        masks = [srv == s for s in range(self.num_servers)]
        reqs = [(s, {"op": "pull_sparse", "name": name, "ids": ids[m],
                     "create": create})
                for s, m in enumerate(masks) if m.any()]
        resps = self._fanout(reqs)
        rows: Optional[np.ndarray] = None
        for (s, _), resp in zip(reqs, resps):
            part = resp["rows"]
            if rows is None:
                rows = np.zeros((len(ids), part.shape[1]), part.dtype)
            rows[masks[s]] = part
        return rows if rows is not None else np.zeros((0, 0), np.float32)

    def push_sparse(self, name: str, ids, grads, lr: float = 0.01) -> None:
        ids, srv = self._route(ids)
        grads = np.asarray(grads)
        self._fanout([
            (s, {"op": "push_sparse", "name": name, "ids": ids[srv == s],
                 "grads": grads[srv == s], "lr": lr})
            for s in range(self.num_servers) if (srv == s).any()])

    def push_sparse_delta(self, name: str, ids, deltas) -> None:
        ids, srv = self._route(ids)
        deltas = np.asarray(deltas)
        self._fanout([
            (s, {"op": "push_sparse_delta", "name": name,
                 "ids": ids[srv == s], "deltas": deltas[srv == s]})
            for s in range(self.num_servers) if (srv == s).any()])

    def pull_dense(self, name: str) -> np.ndarray:
        return self._call(0, {"op": "pull_dense",
                              "name": name})["values"]

    def push_dense(self, name: str, grad, lr=None) -> None:
        self._call(0, {"op": "push_dense", "name": name,
                       "grad": np.asarray(grad), "lr": lr})

    def save(self, name: str) -> dict:
        """Merged state across all server shards."""
        parts = [r["state"] for r in self._fanout(
            [(s, {"op": "save", "name": name})
             for s in range(self.num_servers)])]
        out = {}
        for k in parts[0]:
            out[k] = np.concatenate([p[k] for p in parts])
        return out

    def load(self, name: str, state: dict) -> None:
        """Restore a merged state dict: rows route back id%num_servers
        (the save() counterpart — checkpoint restore on the service path)."""
        ids = np.asarray(state["ids"]).reshape(-1).astype(np.int64)
        srv = ids % self.num_servers
        reqs = []
        for s in range(self.num_servers):
            mask = srv == s
            if not mask.any():
                continue
            part = {k: np.asarray(v)[mask] for k, v in state.items()}
            reqs.append((s, {"op": "load", "name": name, "state": part}))
        self._fanout(reqs)

    def table_size(self, name: str) -> int:
        return sum(self._call(s, {"op": "size", "name": name})["size"]
                   for s in range(self.num_servers))

    def barrier_ping(self) -> None:
        for s in range(self.num_servers):
            self._call(s, {"op": "ping"})

    def health(self) -> list:
        """Per-server worker liveness (heart_beat_monitor analog):
        [{'workers': {client: age_s}, 'dead': [...]}] per server."""
        return [{k: r[k] for k in ("workers", "dead")}
                for r in self._fanout(
                    [(s, {"op": "health"})
                     for s in range(self.num_servers)])]

    def stop_servers(self) -> None:
        for c in self._conns:
            try:
                c.call({"op": "stop"})
            except (RuntimeError, ConnectionError, OSError):
                pass

    def close(self) -> None:
        for s in range(self.num_servers):
            try:
                self._call(s, {"op": "bye"})
            except Exception:  # noqa: BLE001 — best-effort deregister
                pass
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        for c in self._conns:
            c.close()


class RemoteSparseTable:
    """SparseTable-shaped adapter over a PSClient — SparseEmbedding and
    the Communicator work unchanged whether the table is in-process or
    behind the service (the runtime swaps this in when servers exist)."""

    def __init__(self, client: PSClient, name: str, dim: int,
                 rule: str = "sgd", **table_kw):
        self.client = client
        self.name = name
        self.dim = dim
        self.rule = rule
        client.create_table(name, dim=dim, rule=rule, **table_kw)

    def pull(self, ids, create: bool = True) -> np.ndarray:
        return self.client.pull_sparse(self.name, ids, create=create)

    def push(self, ids, grads, lr: float = 0.01) -> None:
        self.client.push_sparse(self.name, ids, grads, lr=lr)

    def apply_deltas(self, ids, deltas) -> None:
        self.client.push_sparse_delta(self.name, ids, deltas)

    @property
    def size(self) -> int:
        return self.client.table_size(self.name)

    def state_dict(self):
        return self.client.save(self.name)

    def set_state_dict(self, d):
        self.client.load(self.name, d)


class AsyncPushQueue:
    """The async communicator's send-queue (service/communicator.cc
    AsyncCommunicator: queued gradient sends drained by a worker thread).

    flush() honors its timeout and surfaces a dead drain thread instead of
    joining forever — a server loss mid-training must fail the trainer
    loudly, not hang its shutdown."""

    def __init__(self, table, maxsize: int = 1024):
        self.table = table
        self._items: list = []
        self._pending = 0
        self._cv = OrderedCondition("ps.push_queue")
        self._err: Optional[BaseException] = None
        self._stopped = False
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def put(self, ids, grads, lr) -> None:
        with self._cv:
            if self._err is not None:
                raise RuntimeError(
                    "async push thread died") from self._err
            if self._stopped:
                raise RuntimeError("async push queue is stopped")
            self._items.append((np.asarray(ids), np.asarray(grads), lr))
            self._pending += 1
            self._cv.notify_all()

    def _drain(self):
        while True:
            with self._cv:
                while not self._items and not self._stopped:
                    self._cv.wait()
                if not self._items and self._stopped:
                    return
                item = self._items.pop(0)
            try:
                ids, grads, lr = item
                self.table.push(ids, grads, lr=lr)
            except BaseException as e:  # noqa: BLE001
                with self._cv:
                    self._err = e
                    self._pending = 0      # unblock flush-waiters
                    self._cv.notify_all()
                return
            with self._cv:
                self._pending -= 1
                self._cv.notify_all()

    def flush(self, timeout: float = _DEFAULT_TIMEOUT) -> None:
        deadline = time.time() + timeout
        with self._cv:
            while self._pending > 0 and self._err is None:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(
                        f"async push queue: {self._pending} pushes still "
                        f"pending after {timeout}s")
                self._cv.wait(timeout=min(remaining, 1.0))
            if self._err is not None:
                raise RuntimeError(
                    "async push thread died") from self._err

    def stop(self, timeout: float = _DEFAULT_TIMEOUT) -> None:
        try:
            self.flush(timeout=timeout)
        finally:
            with self._cv:
                self._stopped = True
                self._cv.notify_all()
            self._thread.join(timeout=5.0)
