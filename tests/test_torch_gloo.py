"""paddle_tpu_torch's host backend, LocalSGD step and launcher against the
JAX package's — the twins of ``tests/test_gloo.py``,
``tests/test_localsgd.py`` and ``tests/test_launch_cli.py``.

- ``distributed/gloo.py``: each collective run by both packages'
  backends in a world of in-process threads gives the same results
  (exact);
- ``make_localsgd_train_step`` over dp 8 (``force_device_count(8)`` CPU
  slots against the JAX package's 8 forced host devices), SGD: k 1
  equals full-batch SGD within 2e-5 relative and 1e-6 absolute (the JAX
  test's bound), and equals the JAX package's step within 1e-5; k 4
  diverges between syncs and syncs every fourth step;
- ``python -m paddle_tpu_torch.distributed.launch`` with two trainer
  processes on the CPU: the env contract, a real cross-process
  collective through the gloo rendezvous, and LocalSGD at k 1 by eager
  all-reduce within 2e-5 of full-batch SGD.
"""
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import init_mesh as jinit_mesh
from paddle_tpu.distributed.gloo import GlooBackend as JGloo
from paddle_tpu.distributed.parallel import \
    make_localsgd_train_step as jlocalsgd
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.gloo import GlooBackend as TGloo
from paddle_tpu_torch.distributed.parallel import \
    make_localsgd_train_step as tlocalsgd
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import state_from_numpy
from torch_layer_parity import one_torch_thread_on_the_cpu


@pytest.fixture(scope="module", autouse=True)
def _cpu_slots():
    prev = tmesh.force_device_count(8)
    for _ in one_torch_thread_on_the_cpu():
        yield
    tmesh.force_device_count(prev)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_world(cls, world_size, fn):
    """Run fn(backend, rank) on world_size in-process threads."""
    endpoint = f"127.0.0.1:{_free_port()}"
    results = [None] * world_size
    errors = []
    backends = [None] * world_size

    def work(rank):
        try:
            backends[rank] = cls(rank, world_size, endpoint)
            results[rank] = fn(backends[rank], rank)
        except Exception as e:  # pragma: no cover
            errors.append((rank, e))

    threads = [threading.Thread(target=work, args=(r,))
               for r in range(1, world_size)]
    for t in threads:
        t.start()
    work(0)
    for t in threads:
        t.join(timeout=60)
    # rank 0 last: it owns the rendezvous server thread + listening port
    for be in backends[1:] + backends[:1]:
        if be is not None:
            be.close()
    assert not errors, errors
    return results


def _all_reduce(be, r):
    a = np.full((2, 3), float(r + 1), np.float32)
    return [be.all_reduce(a, op) for op in ("sum", "avg", "max", "min",
                                            "prod")]


def _subgroup(be, r):
    if r == 1:
        return None
    return be.all_reduce(np.asarray([float(r)]), "sum", group_id=7,
                         ranks=[0, 2])


def _kv(be, r):
    if r == 1:
        be.kv_set("answer", 42)
    return be.kv_get("answer", timeout=30)


def _broadcast(be, r):
    v = be.broadcast(f"from-{r}", src=1)
    be.barrier()
    return v


GLOO_CASES = {
    "all_gather_objects": (3, lambda be, r: be.all_gather({"r": r})),
    "all_reduce_ops": (2, _all_reduce),
    "broadcast_and_barrier": (2, _broadcast),
    "kv_store": (2, _kv),
    "subgroup_ranks_only": (3, _subgroup),
}


@pytest.mark.parametrize("name", sorted(GLOO_CASES))
def test_gloo_backend_matches_jax(name):
    world, fn = GLOO_CASES[name]
    got = _run_world(TGloo, world, fn)
    want = _run_world(JGloo, world, fn)
    for g, w in zip(got, want):
        if isinstance(w, list) and w and isinstance(w[0], np.ndarray):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _data(n_batches, B=16, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(6, 1).astype(np.float32)
    out = []
    for _ in range(n_batches):
        xv = rng.randn(B, 6).astype(np.float32)
        out.append((xv, (xv @ w).astype(np.float32)))
    return out


def _linear_pair(seed):
    jpaddle.seed(seed)
    jm = jnn.Linear(6, 1)
    tm = tnn.Linear(6, 1)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    assert tm.set_state_dict(state_from_numpy(state, "cpu")) == ([], [])
    return jm, tm


class TestLocalSGDSharded:
    def test_k1_equals_full_batch_sgd_and_jax(self):
        """Averaging after every local SGD step is full-batch SGD:
        mean_i(p - lr g_i) = p - lr mean_i(g_i)."""
        jinit_mesh({"dp": 8})
        mesh = tmesh.init_mesh({"dp": 8}, device_type="cpu")
        jm, tm = _linear_pair(0)
        _, ref = _linear_pair(0)
        jstep, jstate = jlocalsgd(jm, lambda o, y: JF.mse_loss(o, y),
                                  jopt.SGD(0.1, parameters=jm.parameters()),
                                  k_steps=1)
        tstep, tstate = tlocalsgd(tm, lambda o, y: TF.mse_loss(o, y),
                                  topt.SGD(0.1, parameters=tm.parameters()),
                                  k_steps=1, mesh=mesh)
        ref_opt = topt.SGD(0.1, parameters=ref.parameters())
        for xv, yv in _data(6):
            jstate, jl = jstep(jstate, xv, yv)
            tstate, tl = tstep(tstate, xv, yv)
            TF.mse_loss(ref(pt.to_tensor(xv)), pt.to_tensor(yv)).backward()
            ref_opt.step()
            ref_opt.clear_grad()
            np.testing.assert_allclose(float(tl), float(np.asarray(jl)),
                                       rtol=1e-5)
            w = np.asarray(tstate["params"]["weight"])
            np.testing.assert_allclose(w, np.asarray(
                jstate["params"]["weight"]), rtol=1e-5, atol=1e-6)
            for r in range(8):
                np.testing.assert_allclose(w[r], ref.weight.numpy(),
                                           rtol=2e-5, atol=1e-6)

    def test_k4_params_diverge_then_sync(self):
        mesh = tmesh.init_mesh({"dp": 8}, device_type="cpu")
        pt.seed(1)
        model = tnn.Linear(6, 1)
        step, state = tlocalsgd(model, lambda o, y: TF.mse_loss(o, y),
                                topt.SGD(0.05,
                                         parameters=model.parameters()),
                                k_steps=4, mesh=mesh)
        for i, (xv, yv) in enumerate(_data(8, seed=3), 1):
            state, _ = step(state, xv, yv)
            w = np.asarray(state["params"]["weight"])
            spread = np.abs(w - w.mean(axis=0, keepdims=True)).max()
            if i % 4 == 0:
                assert spread < 1e-6, f"step {i}: replicas not synced"
            else:
                assert spread > 1e-7, f"step {i}: replicas never diverged"


def test_two_proc_launch_env_gloo_and_localsgd(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch`` with two
    trainers: distinct endpoints, one gloo rendezvous, a real
    cross-process all-reduce (1 + 2), all_gather_object, LocalSGD at
    k 1 over the eager host backend equal to full-batch SGD,
    ``sync_params_buffers`` and ``DataParallel.apply_collective_grads``
    across the trainers."""
    here = os.path.dirname(__file__)
    repo = os.path.dirname(here)
    env = dict(os.environ)
    env.update({"LAUNCH_OUT_DIR": str(tmp_path),
                "PADDLE_DIST_BACKEND": "gloo",
                "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", "")})
    for k in ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ID"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", f"--started_port={_free_port()}",
         f"--gloo_port={_free_port()}", "--log_dir", str(tmp_path / "logs"),
         os.path.join(here, "torch_dist_launch_child.py")],
        env=env, capture_output=True, text=True, timeout=300, cwd=repo)
    logs = ""
    logdir = tmp_path / "logs"
    if logdir.exists():
        for f in sorted(logdir.iterdir()):
            logs += f"\n--- {f.name}\n{f.read_text()[-2000:]}"
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}\n{logs}"
    outs = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            outs.append(json.load(f))
    assert [o["world"] for o in outs] == [2, 2]
    assert [o["sum"] for o in outs] == [3.0, 3.0]
    assert outs[0]["gathered"] == outs[1]["gathered"] == [{"rank": 0},
                                                          {"rank": 1}]
    assert outs[0]["endpoint"] != outs[1]["endpoint"]
    assert outs[0]["gloo"] == outs[1]["gloo"]
    assert all(o["max_abs_err"] <= 2e-5 for o in outs), outs
    assert outs[0]["weight"] == outs[1]["weight"]
    # sync_params_buffers: rank 0's draw on both; DataParallel's
    # averaged half-batch gradients: the full batch's (f32 sums)
    assert outs[0]["synced"] == outs[1]["synced"]
    assert all(o["dp_grad_err"] <= 1e-6 for o in outs), outs


def test_spawn_in_a_world_of_one_calls_func():
    from paddle_tpu_torch.distributed import spawn

    got = []
    assert spawn(got.append, args=(7,), nprocs=1) is None
    assert got == [7]
