"""PS runtime: table registry + server/worker lifecycle behind the fleet
facade — twin of ``paddle_tpu/distributed/ps/runtime.py`` (reference fleet/runtime/the_one_ps.py:400 — _init_server :448
loads tables, _run_server :826 joins the brpc server, _init_worker :759
starts the communicator; parameter_server_runtime.py:30).

Two deployments, one worker surface (sparse_embedding / pull / push):
- single-process (no PADDLE_PSERVERS_IP_PORT_LIST): tables live here
- service mode: fleet.init_server()/run_server() host table shards in
  PSServer processes; fleet.init_worker() connects a PSClient and
  sparse_embedding transparently binds RemoteSparseTable handles
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from .communicator import Communicator
from .embedding import SparseEmbedding
from .service import PSClient, PSServer, RemoteSparseTable
from .table import SparseTable

_tables: Dict[str, object] = {}
_embeddings: Dict[str, SparseEmbedding] = {}
_server: Optional[PSServer] = None
_client: Optional[PSClient] = None


def _server_endpoints():
    eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
    return eps.split(",") if eps else []


def _mode_from_strategy(strategy):
    """sync / async / geo from DistributedStrategy (proto:108-118).  A
    knob the JAX package never reads, set away from its default, raises
    (``fleet.strategy.refuse_unread``)."""
    from ..fleet.strategy import refuse_unread

    refuse_unread(strategy)
    if strategy is None or not getattr(strategy, "a_sync", False):
        return "sync", 1
    k = int(getattr(strategy.a_sync_configs, "k_steps", 0) or 0)
    if k > 0:
        return "geo", k
    return "async", 1


def sparse_embedding(name: str, dim: int, rule: str = None, lr: float = None,
                     strategy=None, cache_rows: int = 0, device=None,
                     **table_kw) -> SparseEmbedding:
    """Create or fetch the named embedding.  On fetch, any EXPLICITLY
    passed config (rule/lr) must match the original registration — a
    silent mismatch would train with the wrong optimizer settings.

    ``cache_rows > 0`` wraps the table in a DeviceCachedTable (heter_ps
    analog): hot rows live in device HBM, the host/remote table serves
    the tail — the right shape for zipf-skewed CTR vocabularies.  The
    device (of the cache and of the rows the layer hands on) is the
    default place unless ``device`` names one."""
    if name in _embeddings:
        emb = _embeddings[name]
        cm = emb.communicator
        mismatches = []
        if emb.dim != dim:
            mismatches.append(f"dim {emb.dim} != {dim}")
        if rule is not None and emb.table.rule != rule:
            mismatches.append(f"rule {emb.table.rule!r} != {rule!r}")
        if lr is not None and cm.lr != lr:
            mismatches.append(f"lr {cm.lr} != {lr}")
        if mismatches:
            raise ValueError(
                f"sparse_embedding {name!r} already registered; "
                + "; ".join(mismatches))
        return emb
    mode, k = _mode_from_strategy(strategy)
    table = _tables.get(name)
    if table is None:
        if _client is not None:
            table = RemoteSparseTable(_client, name, dim,
                                      rule=rule or "sgd", **table_kw)
        else:
            table = SparseTable(dim, rule=rule or "sgd", **table_kw)
        if cache_rows > 0:
            from .device_cache import DeviceCachedTable

            table = DeviceCachedTable(table, cache_rows=cache_rows,
                                      device=device)
        _tables[name] = table
    emb = SparseEmbedding(dim, table=table, device=device,
                          communicator=Communicator(
                              table, mode=mode, k_steps=k,
                              lr=0.01 if lr is None else lr,
                              use_async_queue=(mode == "async"
                                               and _client is not None)))
    _embeddings[name] = emb
    return emb


def get_table(name: str):
    return _tables[name]


def get_client() -> Optional[PSClient]:
    return _client


def init_server(*_a, **_k):
    """Create this process's PSServer from the env contract
    (PADDLE_PSERVERS_IP_PORT_LIST + PADDLE_PSERVER_ID).  Single-process
    mode (no endpoint list): nothing to host — tables are local."""
    global _server
    eps = _server_endpoints()
    if not eps:
        return None
    sid = int(os.environ.get("PADDLE_PSERVER_ID", "0"))
    _server = PSServer(eps[sid], server_id=sid, num_servers=len(eps))
    _server.start()
    return _server


def run_server():
    """Serve until a worker sends stop (the_one_ps.py:826 joins brpc)."""
    if _server is None:
        return None
    _server.run()
    return None


def init_worker(strategy=None):
    """Connect the PSClient when servers exist (the_one_ps.py:759)."""
    global _client
    eps = _server_endpoints()
    if eps and _client is None:
        _client = PSClient(eps)
        _client.barrier_ping()
    return _client


def stop_worker():
    """Flush pending pushes/deltas and stop drain threads (reference
    Communicator::Stop)."""
    for emb in _embeddings.values():
        emb.communicator.stop()


def shutdown_servers():
    """Test/teardown helper: worker 0 stops the server processes."""
    if _client is not None:
        _client.stop_servers()


def reset():
    """Test helper: drop all registered tables/embeddings + connections."""
    global _client, _server
    for emb in _embeddings.values():
        try:
            emb.communicator.stop()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
    _tables.clear()
    _embeddings.clear()
    if _client is not None:
        _client.close()
        _client = None
    if _server is not None:
        _server.stop()
        _server = None
