"""paddle_tpu_torch's multislot feed, fleet datasets and dataset trainer
against the JAX package's, on the same files written from a seed.

- ``io/multislot.py``: parsing (records equal, the same errors),
  batching and padding (sparse slots padded with -1, dense stacked):
  exact;
- ``InMemoryDataset``: ``local_shuffle`` and ``slots_shuffle`` from one
  seed give the same permutations (exact); ``QueueDataset`` deals files
  round-robin to threads alike;
- ``train_from_dataset``: a CTR model (an adagrad ``sparse_embedding``,
  mask-pooled, and a linear head on SGD) driven by one sync thread over
  the same shuffled dataset — the per-step losses within 1e-5 of the JAX
  package's (the same f32 math in another order), the tables bit for
  bit apart from that rounding (1e-5);
- ``Executor.train_from_dataset`` / ``infer_from_dataset`` on a recorded
  static Program fed by an ``InMemoryDataset``: the losses within 1e-5
  of the JAX package's Executor;
- ``MultiTrainer``: two hogwild threads consume every batch, a worker's
  error surfaces; two threads train one shared Linear stack with no
  lock (the trainer zeroes shared gradients in place);
- ``global_shuffle`` over two trainer processes started by
  ``python -m paddle_tpu_torch.distributed.launch`` (the host backend):
  every record lands on the trainer the JAX package's routing rule picks
  (a ``RandomState`` stream per rank), none lost or duplicated.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import static as jstatic
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.ps import runtime as jruntime
from paddle_tpu.io import multislot as jms

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.ps import runtime as truntime
from paddle_tpu_torch.io import multislot as tms
from paddle_tpu_torch.nn import state_from_numpy
from torch_layer_parity import one_torch_thread_on_the_cpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _slots(ms):
    return [ms.Slot("ids", dtype="int64"),
            ms.Slot("dense", dtype="float32", is_dense=True, dim=4),
            ms.Slot("label", dtype="float32", is_dense=True, dim=1)]


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


def _ctr_files(tmp_path, n_files=2, rows_per_file=64, vocab=500, seed=0):
    """``tests/test_dataset_trainer.py``'s synthetic CTR data, written by
    the port's ``write_multislot_file``."""
    rng = np.random.RandomState(seed)
    paths = []
    for fi in range(n_files):
        rows = []
        for _ in range(rows_per_file):
            ids = rng.randint(0, vocab, size=rng.randint(1, 4))
            dense = rng.randn(4).astype(np.float32)
            label = 1.0 if (ids < vocab // 2).any() + dense[0] > 0.5 else 0.
            rows.append({"ids": ids.tolist(),
                         "dense": [f"{v:.4f}" for v in dense],
                         "label": [label]})
        p = str(tmp_path / f"part-{fi}.txt")
        tms.write_multislot_file(p, rows, _slots(tms))
        paths.append(p)
    return paths


def _dataset(pkg_fleet, ms, paths, batch, kind="InMemoryDataset"):
    ds = pkg_fleet.DatasetFactory().create_dataset(kind)
    ds.set_slots(_slots(ms))
    ds.set_filelist(paths)
    ds.set_batch_size(batch)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
    return ds


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_multislot_parse_batch_and_errors(tmp_path):
    tfeed, jfeed = (tms.MultiSlotDataFeed(_slots(tms)),
                    jms.MultiSlotDataFeed(_slots(jms)))
    line = "3 7 9 11 4 0.5 -1.0 2.0 0.0 1 1.0"
    t, j = tfeed.parse_line(line), jfeed.parse_line(line)
    for k in j.slots:
        np.testing.assert_array_equal(t.slots[k], j.slots[k])
        assert t.slots[k].dtype == j.slots[k].dtype
    for bad in ("3 7 9", "1 7 3 0.5 1.0 2.0 1 1.0", "1 7 4 1 2 3 4 1 1 9"):
        with pytest.raises(ValueError) as te:
            tfeed.parse_line(bad)
        with pytest.raises(ValueError) as je:
            jfeed.parse_line(bad)
        assert str(te.value) == str(je.value)
    paths = _ctr_files(tmp_path, n_files=1, rows_per_file=20)
    trecs, jrecs = tfeed.read_file(paths[0]), jfeed.read_file(paths[0])
    _same_batches([tfeed.batch(trecs[i:i + 8]) for i in range(0, 20, 8)],
                  [jfeed.batch(jrecs[i:i + 8]) for i in range(0, 20, 8)])
    b = tfeed.batch(trecs[:8])
    assert b["ids"].shape[0] == 8 and (b["ids"] == tms.PAD_ID).any()
    assert [r.slots["ids"].tolist() for r in tfeed.iter_file(paths[0])] == \
        [r.slots["ids"].tolist() for r in trecs]


def test_shuffles_equal_the_reference(tmp_path):
    paths = _ctr_files(tmp_path, n_files=2, rows_per_file=30)
    tds, jds = (_dataset(tfleet, tms, paths, 7),
                _dataset(jfleet, jms, paths, 7))
    for ds in (tds, jds):
        ds.set_shuffle_seed(5)
        ds.local_shuffle()
        ds.local_shuffle()
        ds.set_fea_eval(40, True)
        ds.slots_shuffle(["dense"])
    _same_batches(tds.iter_batches(), jds.iter_batches())
    _same_batches(tds.iter_batches(1, 2), jds.iter_batches(1, 2))
    assert tds.get_memory_data_size() == 60
    tds.release_memory()
    with pytest.raises(RuntimeError, match="load_into_memory"):
        list(tds.iter_batches())
    tq, jq = (_dataset(tfleet, tms, paths, 8, "QueueDataset"),
              _dataset(jfleet, jms, paths, 8, "QueueDataset"))
    for tid in range(2):
        _same_batches(tq.iter_batches(tid, 2), jq.iter_batches(tid, 2))


def _ctr_step(pkg, F, runtime, head, opt, emb):
    def train_step(batch):
        ids = batch["ids"]
        mask = (ids >= 0).astype(np.float32)
        e = emb(pkg.to_tensor(np.where(ids >= 0, ids, 0)))
        pooled = (e * pkg.to_tensor(mask[..., None])).sum(axis=1)
        feats = pkg.concat([pooled, pkg.to_tensor(batch["dense"])], axis=1)
        loss = F.binary_cross_entropy_with_logits(
            head(feats), pkg.to_tensor(batch["label"]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.numpy())

    return train_step


def test_ctr_train_from_dataset_matches_the_reference(tmp_path):
    paths = _ctr_files(tmp_path, n_files=2, rows_per_file=64, seed=1)
    runs = {}
    jpaddle.seed(0)
    jhead = jnn.Linear(12, 1)
    state = {k: np.asarray(v._value) for k, v in jhead.state_dict().items()}
    thead = tnn.Linear(12, 1)
    thead.set_state_dict(state_from_numpy(state, "cpu"))
    for tag, pkg, F, fl, ms, rt, head, opt_mod in (
            ("jax", jpaddle, JF, jfleet, jms, jruntime, jhead, jopt),
            ("port", pt, TF, tfleet, tms, truntime, thead, topt)):
        ds = _dataset(fl, ms, paths, 16)
        ds.set_shuffle_seed(5)
        ds.local_shuffle()
        kw = {} if tag == "jax" else {"device": "cpu"}
        emb = rt.sparse_embedding("ctr_emb", 8, rule="adagrad", lr=0.1,
                                  **kw)
        opt = opt_mod.SGD(0.1, parameters=head.parameters())
        step = _ctr_step(pkg, F, rt, head, opt, emb)
        losses = []
        for _ in range(2):
            out = fl.train_from_dataset(ds, step, thread_num=1,
                                        ps_step=emb.step)
            losses += out["losses"]
        runs[tag] = (losses, emb.table.state_dict())
    (jl, jst), (tl, tst) = runs["jax"], runs["port"]
    assert len(tl) == len(jl) == 16
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    assert np.mean(tl[-4:]) < np.mean(tl[:4])
    oj, ot = np.argsort(jst["ids"]), np.argsort(tst["ids"])
    np.testing.assert_array_equal(tst["ids"][ot], jst["ids"][oj])
    for k in ("rows", "g2"):
        np.testing.assert_allclose(tst[k][ot], jst[k][oj], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_hogwild_trainer_consumes_every_batch_and_surfaces_errors(tmp_path):
    paths = _ctr_files(tmp_path, n_files=2, rows_per_file=32, seed=2)
    ds = _dataset(tfleet, tms, paths, 8)
    ds.set_thread(2)
    emb = truntime.sparse_embedding("hw", 8, rule="adagrad", lr=0.1,
                                    device="cpu")
    head = tnn.Linear(12, 1)
    step = _ctr_step(pt, TF, truntime, head,
                     topt.SGD(0.1, parameters=head.parameters()), emb)
    out = tfleet.MultiTrainer(ds, step, thread_num=2).run()
    assert out["batches"] == 8 and len(out["per_worker_losses"]) == 2
    assert all(len(w) == 4 for w in out["per_worker_losses"])

    def bad(batch):
        raise ValueError("boom")

    with pytest.raises(RuntimeError, match="worker 0 failed"):
        tfleet.MultiTrainer(ds, bad, thread_num=1).run()
    with pytest.raises(ValueError, match="per-trainer"):
        tfleet.train_from_dataset(ds, step, thread_num=2, ps_step=emb.step)


class _Batches:
    """A dataset of in-memory batches, dealt round-robin to threads."""

    thread_num = 2

    def __init__(self, batches):
        self.batches = batches

    def iter_batches(self, thread_id=0, num_threads=1):
        return iter(self.batches[thread_id::num_threads])


def test_hogwild_workers_share_dense_gradients_without_a_lock():
    """Two hogwild threads train one Linear stack with no lock of the
    caller's: each clears the gradients the other accumulates into and
    writes the parameters the other's ops save, as paddle's hogwild
    workers race on the scope.  Inside the run ``clear_grad`` zeroes a
    gradient in place and the update leaves the version counter alone
    (``tensor.shared_gradients``); outside it, ``grad`` is None again."""
    from paddle_tpu_torch.tensor import gradients_shared

    pt.seed(0)
    net = tnn.Sequential(tnn.Linear(16, 16), tnn.ReLU(), tnn.Linear(16, 1))
    opt = topt.SGD(0.01, parameters=net.parameters())
    rng = np.random.RandomState(4)
    batches = [(rng.randn(8, 16).astype(np.float32),
                (rng.rand(8, 1) > 0.5).astype(np.float32))
               for _ in range(1200)]
    seen = []

    def step(batch):
        x, y = batch
        loss = TF.binary_cross_entropy_with_logits(net(pt.to_tensor(x)),
                                                   pt.to_tensor(y))
        loss.backward()
        w = net[0].weight._value
        version = w._version
        opt.step()
        grad = w.grad
        opt.clear_grad()
        if len(seen) < 4:
            seen.append((gradients_shared(), w._version == version,
                         w.grad is grad, float(w.grad.abs().max())))
        return float(loss.numpy())

    out = tfleet.MultiTrainer(_Batches(batches), step, thread_num=2).run()
    assert out["batches"] == 1200
    assert all(len(w) == 600 for w in out["per_worker_losses"])
    assert np.isfinite(out["losses"]).all()
    assert seen and all(s[:3] == (True, True, True) for s in seen)
    assert not gradients_shared()
    loss = TF.binary_cross_entropy_with_logits(
        net(pt.to_tensor(batches[0][0])), pt.to_tensor(batches[0][1]))
    loss.backward()
    opt.clear_grad()
    assert net[0].weight.grad is None


def _regression(pkg, static, nn, F, opt_mod, state, tmp_path, ms, fl,
                train=True):
    rng = np.random.RandomState(0)
    w_true = np.asarray([0.5, -1.0, 2.0, 0.3], np.float32)
    rows = []
    for _ in range(64):
        x = rng.randn(4).astype(np.float32)
        rows.append({"dense": [f"{v:.5f}" for v in x],
                     "label": [f"{float(x @ w_true):.5f}"]})
    slots = [ms.Slot("dense", "float32", is_dense=True, dim=4),
             ms.Slot("label", "float32", is_dense=True, dim=1)]
    path = str(tmp_path / "reg.txt")
    ms.write_multislot_file(path, rows, slots)
    ds = fl.InMemoryDataset()
    ds.set_slots(slots)
    ds.set_filelist([path])
    ds.set_batch_size(16)
    ds.load_into_memory()
    lin = nn.Linear(4, 1)
    lin.set_state_dict(state if pkg is jpaddle
                       else state_from_numpy(state, "cpu"))
    main = static.Program()
    with static.program_guard(main):
        x = static.data("dense", [16, 4], "float32")
        y = static.data("label", [16, 1], "float32")
        loss = F.mse_loss(lin(x), y)
        if train:
            opt_mod.SGD(0.1, parameters=lin.parameters()).minimize(loss)
    exe = static.Executor()
    run = exe.train_from_dataset if train else exe.infer_from_dataset
    losses = []
    for _ in range(3 if train else 1):
        losses += run(program=main, dataset=ds, fetch_list=[loss])["losses"]
    return losses, {k: np.asarray(v.numpy())
                    for k, v in lin.state_dict().items()}


@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_executor_from_dataset_matches_the_reference(tmp_path, train):
    jpaddle.seed(0)
    state = {k: np.asarray(v._value)
             for k, v in jnn.Linear(4, 1).state_dict().items()}
    jl, jw = _regression(jpaddle, jstatic, jnn, JF, jopt, state, tmp_path,
                         jms, jfleet, train)
    pt.seed(0)
    tl, tw = _regression(pt, tstatic, tnn, TF, topt, state, tmp_path, tms,
                         tfleet, train)
    assert len(tl) == len(jl) == (12 if train else 4)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=1e-5, atol=1e-5)
    if train:
        assert tl[-1] < tl[0] * 0.5
    else:
        np.testing.assert_array_equal(tw["weight"], state["weight"])


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_global_shuffle_over_two_launched_trainers(tmp_path):
    env = dict(os.environ, PADDLE_DIST_BACKEND="gloo",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for k in ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ID"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", f"--started_port={_free_port()}",
         f"--gloo_port={_free_port()}", "--log_dir", str(tmp_path / "logs"),
         os.path.join(ROOT, "tests", "torch_fleet_child.py"), "shuffle",
         str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=240)
    logs = "".join(p.read_text() for p in (tmp_path / "logs").glob("*"))
    assert r.returncode == 0, r.stderr + logs
    got = {}
    for rank in range(2):
        with open(tmp_path / f"shuffle{rank}.json") as f:
            got[rank] = json.load(f)["ids"]
    # the JAX package's rule (fleet/dataset.py global_shuffle): rank r
    # sends its i-th record to RandomState(seed * 1000003 + r)'s i-th draw
    want = {0: [], 1: []}
    for rank in range(2):
        dest = np.random.RandomState((42 * 1000003 + rank) % 2 ** 31) \
            .randint(0, 2, size=40)
        for i, d in enumerate(dest):
            want[int(d)].append(rank * 1000 + i)
    assert {r: sorted(v) for r, v in got.items()} == \
        {r: sorted(v) for r, v in want.items()}
    assert any(i >= 1000 for i in got[0]) and any(i < 1000 for i in got[1])
