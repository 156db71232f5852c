"""paddle_tpu_torch's fleet (``distributed/fleet``) against the JAX
package's on the same parameters, gradients and inputs made with numpy
from a seed.

- the strategy stack: ``apply_meta_optimizers`` wraps in the same order;
  gradient merge (k 2, avg, 4 micro-steps over Adam: the parameters
  after each micro-step within 1e-6, the gradients cleared between
  boundaries), DGC (the kept gradient and the residual: exact, ties at
  the k-th magnitude kept), the "fp16" all-reduce's bfloat16 rounding
  (the rounded gradient exact, the SGD step within 1e-6), the Lars and
  Lamb swap-in (one step within 1e-6), LocalSGD at a world of one (no
  averaging: the inner step's parameters, within 1e-6);
- knobs the JAX package never reads raise ``InvalidArgumentError``
  where the strategy is acted on;
- ``recompute`` over a Layer and ``RecomputeSequential``: the input and
  parameter gradients within 1e-5 of the JAX package's; over a function,
  the input gradient so, and the parameters it closes over get theirs
  (none in the JAX package: a difference by design); with dropout, the
  port's recompute equals its own plain backward bit for bit
  (``preserve_rng_state`` replays the port's generator);
- ``shard_opt_state`` / ``shard_params`` / ``ShardingOptimizer`` over a
  dp 4 mesh: every accumulator's spec equals the JAX package's (dim 0
  split where it divides, replicated where not), its value unchanged;
  ``assign_group_by_size``;
- the role makers on the env contract, the facade's identity at a world
  of one, ``fleet.util``, ``fleet.metrics`` (exact at a world of one),
  ``LocalFS``.
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import recompute as jrec
from paddle_tpu.distributed.fleet import sharding as jshard
from paddle_tpu.tensor import Tensor as JTensor

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.fleet import meta_optimizers as tmeta
from paddle_tpu_torch.distributed.fleet import recompute as trec
from paddle_tpu_torch.distributed.fleet import sharding as tshard
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from torch_layer_parity import build, one_torch_thread_on_the_cpu

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _cpu_one_thread():
    yield from one_torch_thread_on_the_cpu()


def _net(nn):
    return nn.Sequential(nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 3))


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*p.shape).astype(np.float32) for p in params]


def _set_grads(jps, tps, grads):
    for jp, tp, g in zip(jps, tps, grads):
        jp._grad = JTensor(jax.numpy.asarray(g))
        tp.grad = pt.to_tensor(g)


def _same_params(jps, tps, tol=TOL):
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp._value),
                                   err_msg=str(i), **tol)


def _pair(make_j, make_t):
    """A net in both packages (the JAX package's weights), with an
    optimizer each."""
    jl, tl = build(_net)
    jps, tps = jl.parameters(), tl.parameters()
    return jps, tps, make_j(jps), make_t(tps)


def _strategy(pkg, **flags):
    s = pkg.DistributedStrategy()
    for k, v in flags.items():
        if "." in k:
            cfg, key = k.split(".")
            getattr(s, cfg)[key] = v
        else:
            setattr(s, k, v)
    return s


def _compiled(pkg, opt, **flags):
    return pkg.fleet.distributed_optimizer(opt, _strategy(pkg, **flags))


def test_the_stack_wraps_in_the_reference_order():
    flags = dict(dgc=True, fp16_allreduce=True, gradient_merge=True,
                 localsgd=True, recompute=True, sharding=True, lars=True)
    jps, tps, jo, to = _pair(lambda p: jopt.SGD(0.1, parameters=p),
                             lambda p: topt.SGD(0.1, parameters=p))
    jw, tw = _compiled(jfleet, jo, **flags), _compiled(tfleet, to, **flags)
    chain = []
    while True:
        chain.append((type(jw).__name__, type(tw).__name__))
        if not hasattr(jw, "inner"):
            break
        jw, tw = jw.inner, tw.inner
    assert all(a == b for a, b in chain), chain
    assert chain[-1] == ("Lars", "Lars") and len(chain) == 7


def test_gradient_merge_matches_the_reference():
    jps, tps, jo, to = _pair(lambda p: jopt.Adam(0.01, parameters=p),
                             lambda p: topt.Adam(0.01, parameters=p))
    flags = {"gradient_merge": True, "gradient_merge_configs.k_steps": 2,
             "gradient_merge_configs.avg": True}
    jw, tw = _compiled(jfleet, jo, **flags), _compiled(tfleet, to, **flags)
    assert isinstance(tw, tmeta.GradientMergeOptimizer)
    before = [p.numpy() for p in tps]
    for step in range(4):
        _set_grads(jps, tps, _grads(tps, step))
        jw.step()
        tw.step()
        if step % 2 == 0:          # between boundaries: cleared, unmoved
            assert all(p.grad is None for p in tps)
            for p, b in zip(tps, before):
                np.testing.assert_array_equal(p.numpy(), b)
        else:
            before = [p.numpy() for p in tps]
        _same_params(jps, tps)


def test_dgc_keeps_the_top_k_and_feeds_the_residual_back():
    jps, tps, jo, to = _pair(lambda p: jopt.SGD(0.1, parameters=p),
                             lambda p: topt.SGD(0.1, parameters=p))
    flags = {"dgc": True, "dgc_configs.sparsity": [0.7]}
    jw, tw = _compiled(jfleet, jo, **flags), _compiled(tfleet, to, **flags)
    owners = tw.inner._owners()
    for step in range(3):
        _set_grads(jps, tps, _grads(tps, 10 + step))
        jw.step()
        tw.step()
        for jp, tp in zip(jps, tps):
            np.testing.assert_array_equal(tp.grad.numpy(),
                                          np.asarray(jp._grad._value))
        for jp, tp in zip(jps, tps):
            name = owners[id(tp._value)].name
            np.testing.assert_array_equal(
                tw._residual[name].numpy(),
                np.asarray(jw._residual[jp.name]))
        _same_params(jps, tps)
    # ties at the k-th magnitude are all kept
    dgc = tmeta.DGCOptimizer(topt.SGD(0.1, parameters=tps), sparsity=0.9)
    g = torch.tensor([3.0, -3.0, 3.0, 1.0, 0.5, 2.0, 0.0, 0.1, 0.2, 0.3])
    kept, res = dgc.sparsify(g, torch.zeros_like(g))
    np.testing.assert_array_equal(kept.numpy(),
                                  [3, -3, 3, 0, 0, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal((kept + res).numpy(), g.numpy())


def test_fp16_allreduce_rounds_through_bfloat16():
    jps, tps, jo, to = _pair(lambda p: jopt.SGD(0.1, parameters=p),
                             lambda p: topt.SGD(0.1, parameters=p))
    jw = _compiled(jfleet, jo, fp16_allreduce=True)
    tw = _compiled(tfleet, to, fp16_allreduce=True)
    grads = _grads(tps, 20)
    _set_grads(jps, tps, grads)
    jw.step()
    tw.step()
    for jp, tp, g in zip(jps, tps, grads):
        got = tp.grad.numpy()
        np.testing.assert_array_equal(got, np.asarray(jp._grad._value))
        np.testing.assert_array_equal(
            got, torch.from_numpy(g).bfloat16().float().numpy())
        assert not np.array_equal(got, g)
    _same_params(jps, tps)


@pytest.mark.parametrize("flag", ["lars", "lamb"])
def test_lars_and_lamb_swap_in(flag):
    jps, tps, jo, to = _pair(lambda p: jopt.SGD(0.1, parameters=p),
                             lambda p: topt.SGD(0.1, parameters=p))
    jw = _compiled(jfleet, jo, **{flag: True})
    tw = _compiled(tfleet, to, **{flag: True})
    assert type(tw).__name__ == type(jw).__name__ == flag.capitalize()
    _set_grads(jps, tps, _grads(tps, 30))
    jw.step()
    tw.step()
    _same_params(jps, tps)


def test_localsgd_at_a_world_of_one_is_the_inner_step():
    jps, tps, jo, to = _pair(lambda p: jopt.SGD(0.1, parameters=p),
                             lambda p: topt.SGD(0.1, parameters=p))
    flags = {"localsgd": True, "localsgd_configs.k_steps": 2}
    jw, tw = _compiled(jfleet, jo, **flags), _compiled(tfleet, to, **flags)
    for step in range(4):
        _set_grads(jps, tps, _grads(tps, 40 + step))
        jw.step()
        tw.step()
        _same_params(jps, tps)
    assert tw.sync_params() is False


@pytest.mark.parametrize("knob,value", [
    ("amp", True), ("recompute_configs.checkpoints", ["x"]),
    ("pipeline", True), ("sharding_configs.sharding_degree", 2),
    ("a_sync_configs.thread_pool_size", 4), ("dgc_configs.rampup_step", 5),
    ("sync_batch_norm", True), ("tensor_parallel", True)])
def test_unread_knobs_raise(knob, value):
    _, tps, _, to = _pair(lambda p: None,
                          lambda p: topt.SGD(0.1, parameters=p))
    with pytest.raises(InvalidArgumentError, match=knob.split(".")[-1]):
        _compiled(tfleet, to, **{knob: value})


def _loss_grads(pkg, layer, x, fn):
    xt = pkg.to_tensor(x, stop_gradient=False)
    out = fn(layer, xt)
    w = np.random.RandomState(3).randn(*out.shape).astype(np.float32)
    (out * pkg.to_tensor(w)).sum().backward()
    grads = [xt.grad] + [p.grad for p in layer.parameters()]
    return [None if g is None else np.asarray(g.numpy()) for g in grads]


def test_recompute_matches_the_reference():
    x = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    for j_fn, t_fn in (
            (lambda l, xv: jrec.recompute(l, xv),
             lambda l, xv: trec.recompute(l, xv)),
            (lambda l, xv: jrec.RecomputeSequential(l)(xv),
             lambda l, xv: trec.RecomputeSequential(l)(xv))):
        jl, tl = build(_net)
        for a, b in zip(_loss_grads(pt, tl, x, t_fn),
                        _loss_grads(jpaddle, jl, x, j_fn)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_recompute_of_a_function_differentiates_its_closure():
    """A function's recompute: the input gradient equals the JAX
    package's; the parameters the function closes over get their
    gradients in the port (torch's checkpoint) and none in the JAX
    package (``jax.checkpoint`` of a pure function sees them as
    constants) — a difference by design."""
    x = np.random.RandomState(2).randn(4, 6).astype(np.float32)
    jl, tl = build(_net)
    tg = _loss_grads(pt, tl, x,
                     lambda l, v: trec.recompute(lambda u: l(u) * 2.0, v))
    jg = _loss_grads(jpaddle, jl, x,
                     lambda l, v: jrec.recompute(lambda u: l(u) * 2.0, v))
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-5, atol=1e-5)
    assert all(g is None for g in jg[1:])
    _, plain = build(_net)
    want = _loss_grads(pt, plain, x, lambda l, v: l(v) * 2.0)
    for a, b in zip(tg, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_recompute_replays_the_dropout_draws():
    x = np.random.RandomState(4).randn(16, 6).astype(np.float32)

    def make(nn):
        return nn.Sequential(nn.Linear(6, 32), nn.Dropout(0.5),
                             nn.Linear(32, 3))

    _, tl = build(make)
    runs = []
    for fn in (lambda l, v: l(v), lambda l, v: trec.recompute(l, v)):
        pt.seed(11)
        runs.append(_loss_grads(pt, tl, x, fn))
        for p in tl.parameters():
            p.clear_grad()
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def dp4():
    prev = tmesh.force_device_count(4)
    tm = tmesh.init_mesh({"dp": 4}, device_type="cpu")
    jm = jmesh.init_mesh({"dp": 4})
    yield jm, tm
    tmesh.force_device_count(prev)


def test_sharding_specs_equal_the_reference(dp4):
    rng = np.random.RandomState(6)
    params = {"w": rng.randn(8, 3).astype(np.float32),
              "b": rng.randn(6).astype(np.float32),
              "odd": rng.randn(5, 2).astype(np.float32)}
    jo = jopt.Adam(0.1, parameters=[jnn.Linear(2, 2).weight])
    to = topt.Adam(0.1, parameters=[tnn.Linear(2, 2).weight])
    jstate = jshard.shard_opt_state(jo.init_opt_state(
        {k: jax.numpy.asarray(v) for k, v in params.items()}))
    tstate = tmeta.ShardingOptimizer(to).init_opt_state(
        {k: torch.from_numpy(v) for k, v in params.items()})
    for kind in jstate:
        for name in params:
            j, t = jstate[kind][name], tstate[kind][name]
            assert tuple(t.spec) == tuple(j.sharding.spec), (kind, name)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tuple(tstate["moment1"]["w"].spec) == ("dp",)
    assert len(tstate["moment1"]["w"].shards) == 4
    tp = tshard.shard_params({k: torch.from_numpy(v)
                              for k, v in params.items()})
    jp = jshard.shard_params({k: jax.numpy.asarray(v)
                              for k, v in params.items()})
    assert {k: tuple(v.spec) for k, v in tp.items()} == {
        k: tuple(v.sharding.spec) for k, v in jp.items()}
    sizes = {f"p{i}": np.zeros((1 << 18,), np.float32) for i in range(9)}
    assert tshard.assign_group_by_size(sizes, 2.0) == \
        jshard.assign_group_by_size(sizes, 2.0)


ENV = {"PADDLE_TRAINER_ID": "3", "PADDLE_TRAINERS_NUM": "4",
       "PADDLE_TRAINER_ENDPOINTS": "a:1,b:2,c:3,d:4",
       "PADDLE_PSERVERS_IP_PORT_LIST": "s:1,s:2", "PADDLE_PSERVER_ID": "1"}


@pytest.mark.parametrize("role", ["TRAINER", "PSERVER"])
def test_role_makers_read_the_env_contract(monkeypatch, role):
    for k, v in dict(ENV, TRAINING_ROLE=role).items():
        monkeypatch.setenv(k, v)
    for mk in (lambda pkg: pkg.PaddleCloudRoleMaker(),
               lambda pkg: pkg.UserDefinedRoleMaker(current_id=1,
                                                    worker_num=2)):
        j, t = mk(jfleet), mk(tfleet)
        for name in ("is_worker", "is_server", "is_first_worker",
                     "worker_index", "worker_num", "server_num",
                     "server_index", "role_id", "get_trainer_endpoints",
                     "get_pserver_endpoints", "_generate_role"):
            assert getattr(t, name)() == getattr(j, name)(), name


def test_the_facade_at_a_world_of_one(tmp_path):
    f = tfleet.init(is_collective=True)
    assert f is tfleet.fleet
    assert (tfleet.worker_index(), tfleet.worker_num(),
            tfleet.is_first_worker(), tfleet.is_worker(),
            tfleet.server_num()) == (0, 1, True, True, 0)
    layer = tnn.Linear(2, 2)
    assert tfleet.distributed_model(layer) is layer
    assert tfleet.fleet.util.all_reduce(5) == 5
    assert tfleet.fleet.util.get_file_shard(["a", "b", "c"]) == [
        "a", "b", "c"]
    opt = tfleet.distributed_optimizer(
        topt.SGD(0.1, parameters=layer.parameters()))
    assert isinstance(opt, topt.SGD)
    fs = tfleet.LocalFS()
    d = str(tmp_path / "x")
    fs.mkdirs(d)
    fs.touch(d + "/f")
    assert fs.ls_dir(d) == ([], ["f"]) and fs.is_file(d + "/f")
    fs.delete(d)
    assert not fs.is_exist(d)


def test_metrics_at_a_world_of_one_equal_the_reference():
    rng = np.random.RandomState(9)
    pos, neg = rng.randint(0, 20, 50), rng.randint(0, 20, 50)
    v = rng.randn(7)
    for name, args in (("sum", (v,)), ("max", (v,)), ("min", (v,)),
                       ("auc", (pos, neg)), ("acc", (13, 20)),
                       ("mae", (v, 7)), ("rmse", (np.abs(v), 7))):
        got = getattr(tfleet.metrics, name)(*args)
        want = getattr(jfleet.metrics, name)(*args)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=name)
    assert tfleet.metrics.auc([0, 0], [0, 0]) == 0.5
