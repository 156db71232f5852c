"""paddle_tpu_torch's parameter-server tables (``distributed/ps``) against
the JAX package's on the same numpy inputs made from a seed.

- ``SparseTable``: every rule (sgd, adagrad, adam, sum) and the hogwild
  sgd path (the port's native scatter) after the same pulls, pushes and
  deltas: the rows and the accumulators of ``state_dict`` equal bit for
  bit (the same numpy code; the native ``scatter_axpy`` adds the same
  f32 products in the same order as the JAX package's ``np.add.at``);
- ``Communicator`` in sync, async (with and without the push queue) and
  geo modes on one gradient stream: the tables equal bit for bit, and
  the geo overlay;
- ``SparseEmbedding``: the forward on duplicated ids (exact: a gather)
  and the row gradient it hands the communicator (1e-6: duplicates are
  summed in another order);
- ``DeviceCachedTable`` on the CPU: for one id stream of pulls, pushes
  and deltas, the pulled rows (exact), the slot of every cached id (the
  evictions), the hit rate and the rows of the backing table;
- ``runtime.sparse_embedding`` / ``fleet.sparse_embedding``: the mode
  the strategy selects, re-fetching by name, the mismatch refusal, the
  cache it wraps; ``static.nn.sparse_embedding`` eagerly;
- the lock hierarchy the package declares, held by the witness while two
  hogwild threads train through one cached table.
"""
import threading

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.ps import Communicator as JComm
from paddle_tpu.distributed.ps import SparseEmbedding as JEmb
from paddle_tpu.distributed.ps import SparseTable as JTable
from paddle_tpu.distributed.ps import runtime as jruntime
from paddle_tpu.distributed.ps.device_cache import DeviceCachedTable as JCache
from paddle_tpu import static as jstatic

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.ps import Communicator as TComm
from paddle_tpu_torch.distributed.ps import SparseEmbedding as TEmb
from paddle_tpu_torch.distributed.ps import SparseTable as TTable
from paddle_tpu_torch.distributed.ps import runtime as truntime
from paddle_tpu_torch.distributed.ps.device_cache import \
    DeviceCachedTable as TCache
from paddle_tpu_torch.framework import concurrency as tcc
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch import static as tstatic
from torch_layer_parity import one_torch_thread_on_the_cpu


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


@pytest.fixture(autouse=True)
def _clean():
    jruntime.reset()
    truntime.reset()
    yield
    jruntime.reset()
    truntime.reset()


def _equal_state(a, b):
    da, db = a.state_dict(), b.state_dict()
    assert sorted(da) == sorted(db)
    order_a, order_b = np.argsort(da["ids"]), np.argsort(db["ids"])
    for k in da:
        np.testing.assert_array_equal(np.asarray(da[k])[order_a],
                                      np.asarray(db[k])[order_b], err_msg=k)


def _stream(seed, n_steps=6, vocab=90, batch=24, dim=5):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, batch),
             rng.randn(batch, dim).astype(np.float32))
            for _ in range(n_steps)]


@pytest.mark.parametrize("rule", ["sgd", "adagrad", "adam", "sum"])
@pytest.mark.parametrize("init", ["uniform", "normal"])
def test_every_rule_equals_the_reference(rule, init):
    j = JTable(5, rule=rule, num_shards=3, initializer=init, seed=4)
    t = TTable(5, rule=rule, num_shards=3, initializer=init, seed=4)
    for ids, g in _stream(1):
        np.testing.assert_array_equal(t.pull(ids), j.pull(ids))
        j.push(ids, g, lr=0.05)
        t.push(ids, g, lr=0.05)
    j.apply_deltas([3, 3, 500], np.ones((3, 5), np.float32))
    t.apply_deltas([3, 3, 500], np.ones((3, 5), np.float32))
    np.testing.assert_array_equal(t.pull([7, 10 ** 6], create=False),
                                  j.pull([7, 10 ** 6], create=False))
    assert t.size == j.size
    _equal_state(t, j)
    again = TTable(5, rule=rule, num_shards=2)
    again.set_state_dict(t.state_dict())
    _equal_state(again, j)


def test_hogwild_push_equals_the_reference():
    j = JTable(5, rule="sgd", num_shards=2, seed=2, hogwild=True)
    t = TTable(5, rule="sgd", num_shards=2, seed=2, hogwild=True)
    for ids, g in _stream(2):
        j.push(ids, g, lr=0.3)
        t.push(ids, g, lr=0.3)
    _equal_state(t, j)
    with pytest.raises(ValueError, match="hogwild"):
        TTable(5, rule="adam", hogwild=True)


@pytest.mark.parametrize("mode,queue", [("sync", False), ("async", False),
                                        ("async", True), ("geo", False)])
def test_communicators_equal_the_reference(mode, queue):
    k = 3 if mode == "geo" else 1
    jt, tt = JTable(5, rule="adagrad", seed=6), TTable(5, rule="adagrad",
                                                        seed=6)
    jc = JComm(jt, mode=mode, k_steps=k, lr=0.2, use_async_queue=queue)
    tc = TComm(tt, mode=mode, k_steps=k, lr=0.2, use_async_queue=queue)
    for ids, g in _stream(3, n_steps=7):
        if queue:       # the queue's thread pushes: wait for it
            jc.flush()
            tc.flush()
        np.testing.assert_array_equal(
            tc.apply_overlay(ids, tt.pull(ids)),
            jc.apply_overlay(ids, jt.pull(ids)))
        uids = np.unique(ids)
        jc.on_gradient(uids, g[:len(uids)])
        tc.on_gradient(uids, g[:len(uids)])
        jc.step()
        tc.step()
    jc.stop()
    tc.stop()
    _equal_state(tt, jt)


def _rows_hook(emb, sink):
    inner = emb.communicator.on_gradient

    def record(ids, grads):
        sink.append((np.asarray(ids), np.asarray(grads)))
        inner(ids, grads)

    emb.communicator.on_gradient = record


def test_sparse_embedding_forward_and_row_gradient():
    ids = np.random.RandomState(5).randint(0, 40, (6, 7))
    w = np.random.RandomState(6).randn(6, 7, 8).astype(np.float32)
    je = JEmb(8, rule="sgd", lr=0.1, seed=9)
    te = TEmb(8, rule="sgd", lr=0.1, seed=9, device="cpu")
    jrows, trows = [], []
    _rows_hook(je, jrows)
    _rows_hook(te, trows)
    jo = je(jpaddle.to_tensor(ids))
    to = te(pt.to_tensor(ids))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo._value))
    (jo * jpaddle.to_tensor(w)).sum().backward()
    (to * pt.to_tensor(w)).sum().backward()
    (ju, jg), = jrows
    (tu, tg), = trows
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)
    _equal_state(te.table, je.table)
    # eval: no rows created, unseen ids read as zeros
    je.eval()
    te.eval()
    probe = np.asarray([[1, 999]])
    np.testing.assert_array_equal(te(pt.to_tensor(probe)).numpy(),
                                  np.asarray(je(jpaddle.to_tensor(probe))
                                             ._value))
    assert te.table.size == je.table.size


def _cache_drive(cache, table, seed):
    """One stream of pulls (skewed ids), pushes and deltas; returns the
    pulled rows."""
    rng = np.random.RandomState(seed)
    out = []
    for step in range(12):
        ids = np.minimum(rng.zipf(1.3, 20), 60)
        out.append(np.asarray(cache.pull(ids)))
        if step % 3 == 1:
            u = np.unique(ids)
            cache.push(u, rng.randn(len(u), 4).astype(np.float32), lr=0.1)
        if step % 5 == 4:
            cache.apply_deltas([1, 2], np.ones((2, 4), np.float32))
    return out


def test_device_cache_on_the_cpu_equals_the_reference():
    jt, tt = JTable(4, rule="adagrad", seed=1), TTable(4, rule="adagrad",
                                                       seed=1)
    jc = JCache(jt, cache_rows=8)
    tc = TCache(tt, cache_rows=8, device="cpu")
    for a, b in zip(_cache_drive(tc, tt, 7), _cache_drive(jc, jt, 7)):
        np.testing.assert_array_equal(a, b)
    assert tc.hit_rate == jc.hit_rate and 0 < tc.hit_rate < 1
    assert tc.cached_rows == jc.cached_rows == 8
    np.testing.assert_array_equal(tc._id_at, jc._id_at)
    np.testing.assert_array_equal(tc._ref, jc._ref)
    assert tc._slot_of == jc._slot_of
    _equal_state(tt, jt)
    rows = tc.pull_device(np.asarray([1, 2, 70]))
    assert rows.device.type == "cpu"
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jc.pull_device([1, 2, 70])))
    tc.set_state_dict(tc.state_dict())
    assert tc.cached_rows == 0


def test_cached_embedding_takes_the_device_gather():
    """A training, non-geo SparseEmbedding over a cache reads the rows by
    ``pull_device`` (a difference by design: the JAX package pulls to the
    host); the rows and the updates equal the reference's."""
    ids = np.random.RandomState(3).randint(0, 30, (5, 4))
    jt, tt = JTable(6, rule="sgd", seed=3), TTable(6, rule="sgd", seed=3)
    je = JEmb(6, table=JCache(jt, cache_rows=16), lr=0.5)
    te = TEmb(6, table=TCache(tt, cache_rows=16, device="cpu"), lr=0.5)
    calls = []
    orig = te.table.pull_device
    te.table.pull_device = lambda u: calls.append(len(u)) or orig(u)
    for _ in range(3):
        jo, to = je(jpaddle.to_tensor(ids)), te(pt.to_tensor(ids))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo._value))
        jo.sum().backward()
        to.sum().backward()
    assert len(calls) == 3 and te.stats["calls"] == 3
    _equal_state(tt, jt)


def test_runtime_and_fleet_sparse_embedding():
    s_geo, j_geo = tfleet.DistributedStrategy(), JStrategy()
    for s in (s_geo, j_geo):
        s.a_sync = True
        s.a_sync_configs.k_steps = 4
    te = truntime.sparse_embedding("g", 4, rule="adam", lr=0.3,
                                   strategy=s_geo, device="cpu")
    je = jruntime.sparse_embedding("g", 4, rule="adam", lr=0.3,
                                   strategy=j_geo)
    assert (te.communicator.mode, te.communicator.k_steps) == (
        je.communicator.mode, je.communicator.k_steps) == ("geo", 4)
    assert truntime.sparse_embedding("g", 4) is te
    with pytest.raises(ValueError, match="already registered"):
        truntime.sparse_embedding("g", 4, rule="sgd")
    tfleet.init(strategy=tfleet.DistributedStrategy())
    emb = tfleet.sparse_embedding("c", 4, cache_rows=32, device="cpu")
    assert isinstance(emb.table, TCache) and emb.communicator.mode == "sync"
    assert truntime.get_table("c") is emb.table
    bad = tfleet.DistributedStrategy()
    bad.a_sync_configs.send_queue_size = 3
    with pytest.raises(InvalidArgumentError, match="send_queue_size"):
        truntime.sparse_embedding("d", 4, strategy=bad)


def test_static_sparse_embedding_eagerly():
    ids = np.random.RandomState(8).randint(0, 50, (3, 2))
    jt, tt = JTable(4, seed=5), TTable(4, seed=5)
    jo = jstatic.nn.sparse_embedding(jpaddle.to_tensor(ids), [50, 4],
                                     table=jt)
    to = tstatic.nn.sparse_embedding(pt.to_tensor(ids), [50, 4], table=tt)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo._value))
    with_default = tstatic.nn.sparse_embedding(pt.to_tensor(ids), [50, 4])
    assert tuple(with_default.shape) == (3, 2, 4)


def test_hogwild_threads_through_one_cache_keep_the_hierarchy():
    """Two threads pull, push and train through one cached table under
    the witness: no lock-order violation, the declared hierarchy holds,
    every step applied (adagrad's accumulators count every push)."""
    table = TTable(4, rule="adagrad", seed=0)
    emb = TEmb(4, table=TCache(table, cache_rows=16, device="cpu"), lr=0.1)
    errors = []

    def work(seed):
        try:
            rng = np.random.RandomState(seed)
            for _ in range(15):
                ids = np.minimum(rng.zipf(1.2, (4, 3)), 40)
                emb(pt.to_tensor(ids)).sum().backward()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    with tcc.witness(raise_on_violation=False):
        threads = [threading.Thread(target=work, args=(s,))
                   for s in (1, 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        tcc.assert_clean()
        edges = set(tcc.graph_edges())
    assert not errors, errors
    assert ("ps.device_cache_io", "ps.table") in edges
    assert emb.stats["calls"] == 30
    assert table.size > 0
