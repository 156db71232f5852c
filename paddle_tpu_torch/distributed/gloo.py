"""Host-side (CPU, TCP) collective backend for eager multi-process mode —
the port's copy of ``paddle_tpu/distributed/gloo.py`` (sockets and numpy
only, so it is the same code).

Reference analog: the Gloo wrapper the reference uses for CPU rendezvous,
barriers and small collectives outside the NCCL rings
(framework/fleet/gloo_wrapper.h; python role_maker.py:33 `class Gloo`).
The device mesh of one process runs its collectives inside
``shard_map``; this backend covers what those cannot: *eager* host-side
coordination between trainer processes — LocalSGD parameter averaging
between steps, role-maker rendezvous, barriers, and small object
exchange.

Design: rank 0 hosts a rendezvous server (one thread per connection).  Every
collective is gather-then-broadcast through the server keyed by
(group_id, op_name, sequence#): each participant sends its payload, the
server replies to every participant with the full ordered list once all
members have arrived.  Payloads are length-prefixed pickles — localhost /
intra-pod DCN traffic between mutually-trusting trainer processes, same
trust model as the reference's Gloo store.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

_MAGIC = b"PTGL"


def _send_msg(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_MAGIC + struct.pack("<Q", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("gloo peer closed connection")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket):
    head = _recv_exact(sock, 12)
    if head[:4] != _MAGIC:
        raise ConnectionError("gloo protocol error (bad magic)")
    (length,) = struct.unpack("<Q", head[4:])
    return pickle.loads(_recv_exact(sock, length))


def connect_with_retry(host: str, port: int, timeout: float,
                       what: str = "peer") -> socket.socket:
    """Retry-connect until `timeout` (shared by the rendezvous client and
    the PS service client — one place to tune connection behavior)."""
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            s = socket.create_connection((host, port), timeout=5.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(timeout)
            return s
        except OSError as e:
            last = e
            time.sleep(0.05)
    raise ConnectionError(
        f"could not reach {what} at {host}:{port}: {last}")


class _RendezvousServer:
    """Rank-0 side: collects per-key contributions, answers when complete."""

    def __init__(self, host: str, port: int):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(128)
        self.port = self._srv.getsockname()[1]
        self._lock = threading.Lock()
        # key -> {rank: payload}; key -> [(sock, expected_ranks)] waiting
        self._arrived: Dict[tuple, dict] = defaultdict(dict)
        self._waiters: Dict[tuple, list] = defaultdict(list)
        self._kv: Dict[str, object] = {}
        self._stop = False
        self._threads: List[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket):
        try:
            while True:
                msg = _recv_msg(conn)
                kind = msg["kind"]
                if kind == "collective":
                    self._on_collective(conn, msg)
                elif kind == "kv_set":
                    with self._lock:
                        self._kv[msg["key"]] = msg["value"]
                    _send_msg(conn, {"ok": True})
                elif kind == "kv_get":
                    deadline = time.time() + msg.get("timeout", 300.0)
                    while True:
                        with self._lock:
                            if msg["key"] in self._kv:
                                _send_msg(
                                    conn,
                                    {"ok": True,
                                     "value": self._kv[msg["key"]]})
                                break
                        if time.time() > deadline:
                            _send_msg(conn, {"ok": False})
                            break
                        time.sleep(0.005)
                elif kind == "shutdown":
                    _send_msg(conn, {"ok": True})
                    return
        except (ConnectionError, EOFError, OSError):
            return

    def _on_collective(self, conn, msg):
        key = (msg["group"], msg["op"], msg["seq"])
        ranks = tuple(msg["ranks"])
        with self._lock:
            self._arrived[key][msg["rank"]] = msg["payload"]
            self._waiters[key].append((conn, msg["rank"]))
            done = set(self._arrived[key]) >= set(ranks)
            if done:
                ordered = [self._arrived[key][r] for r in sorted(ranks)]
                waiters = self._waiters.pop(key)
                self._arrived.pop(key)
            else:
                return
        # rank 0 last: it hosts this server, and on getting its reply may
        # close the whole process (shutdown) — every other rank's reply must
        # already be on the wire by then, or they die mid-collective
        for sock, _rank in sorted(waiters, key=lambda w: -w[1]):
            try:
                _send_msg(sock, {"ok": True, "result": ordered})
            except OSError:
                pass

    def close(self):
        self._stop = True
        try:
            self._srv.close()
        except OSError:
            pass


class GlooBackend:
    """Client handle every rank holds (rank 0 also hosts the server)."""

    def __init__(self, rank: int, world_size: int, endpoint: str,
                 timeout: float = 300.0):
        self.rank = rank
        self.world_size = world_size
        self.timeout = timeout
        host, port_s = endpoint.rsplit(":", 1)
        port = int(port_s)
        self._server: Optional[_RendezvousServer] = None
        if rank == 0:
            self._server = _RendezvousServer(host, port)
            port = self._server.port
        self._sock = self._connect(host, port)
        self._seq: Dict[tuple, int] = defaultdict(int)
        self._lock = threading.Lock()

    def _connect(self, host, port):
        return connect_with_retry(host, port, self.timeout,
                                  what="gloo rendezvous")

    def _collective(self, op: str, payload, group_id=0, ranks=None):
        ranks = list(ranks) if ranks is not None \
            else list(range(self.world_size))
        with self._lock:
            key = (group_id, op)
            seq = self._seq[key]
            self._seq[key] += 1
            _send_msg(self._sock, {
                "kind": "collective", "op": op, "seq": seq,
                "group": group_id, "rank": self.rank, "ranks": ranks,
                "payload": payload,
            })
            reply = _recv_msg(self._sock)
        if not reply.get("ok"):
            raise RuntimeError(f"gloo collective {op} failed")
        return reply["result"]

    # -- public collectives (object-level; arrays ride through as numpy) --

    def all_gather(self, obj, group_id=0, ranks=None) -> list:
        return self._collective("all_gather", obj, group_id, ranks)

    def all_reduce(self, array: np.ndarray, op: str = "sum", group_id=0,
                   ranks=None) -> np.ndarray:
        parts = self._collective(f"all_reduce_{op}", np.asarray(array),
                                 group_id, ranks)
        stack = np.stack(parts)
        if op == "sum":
            return stack.sum(axis=0)
        if op == "avg":
            return stack.mean(axis=0).astype(stack.dtype)
        if op == "max":
            return stack.max(axis=0)
        if op == "min":
            return stack.min(axis=0)
        if op == "prod":
            return np.prod(stack, axis=0)
        raise ValueError(f"unknown reduce op {op!r}")

    def broadcast(self, obj, src: int = 0, group_id=0, ranks=None):
        parts = self._collective("broadcast", obj, group_id, ranks)
        ranks = sorted(ranks) if ranks is not None \
            else list(range(self.world_size))
        return parts[ranks.index(src)]

    def barrier(self, group_id=0, ranks=None) -> None:
        self._collective("barrier", None, group_id, ranks)

    # -- kv store (role-maker rendezvous analog) --

    def kv_set(self, key: str, value) -> None:
        with self._lock:
            _send_msg(self._sock, {"kind": "kv_set", "key": key,
                                   "value": value})
            _recv_msg(self._sock)

    def kv_get(self, key: str, timeout: float = 300.0):
        with self._lock:
            _send_msg(self._sock, {"kind": "kv_get", "key": key,
                                   "timeout": timeout})
            reply = _recv_msg(self._sock)
        if not reply.get("ok"):
            raise KeyError(key)
        return reply["value"]

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
        if self._server is not None:
            self._server.close()


_backend: Optional[GlooBackend] = None


def init_gloo(rank: Optional[int] = None, world_size: Optional[int] = None,
              endpoint: Optional[str] = None) -> GlooBackend:
    """Initialize the eager host-collective backend.  Arguments default to
    the launch env contract (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
    PADDLE_GLOO_ENDPOINT)."""
    global _backend
    if _backend is not None:
        return _backend
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0")) \
        if rank is None else rank
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1")) \
        if world_size is None else world_size
    endpoint = os.environ.get("PADDLE_GLOO_ENDPOINT", "") \
        if endpoint is None else endpoint
    if not endpoint:
        raise ValueError(
            "init_gloo needs an endpoint (PADDLE_GLOO_ENDPOINT=host:port)")
    _backend = GlooBackend(rank, world_size, endpoint)
    return _backend


def get_backend() -> Optional[GlooBackend]:
    return _backend


def shutdown() -> None:
    global _backend
    if _backend is not None:
        _backend.close()
        _backend = None
