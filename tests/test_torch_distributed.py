"""paddle_tpu_torch.distributed against the JAX package's distributed
stack on the same inputs — the twins of ``tests/test_distributed.py``'s
mesh, collective (subgroups, PROD, gradients), data-parallel,
tensor-parallel, sharding and env-contract cases.

The port's mesh runs on ``force_device_count(8)`` CPU slots, the JAX
package's on the 8 forced host devices (``tests/conftest.py``).  Each
case runs the same numpy inputs (and, for the trained models, the JAX
package's weights carried across by name) through both.

Tolerances: collectives are exact (integer-valued f32 inputs);
parameters and losses of the f32 train steps within 1e-5 relative (the
mp partial sums and the dp mean change the summation order), 1e-6
absolute.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.mesh import shard_map as jshard_map
from paddle_tpu.tensor import Tensor as JTensor
from paddle_tpu.text import models as jmodels

import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.mesh import P as TP
from paddle_tpu_torch.nn import state_from_numpy
from paddle_tpu_torch.tensor import Tensor as TTensor
from paddle_tpu_torch.text import models as tmodels
from torch_layer_parity import one_torch_thread_on_the_cpu

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _cpu_slots():
    """Eight CPU slots, one torch thread (the slots run on threads), the
    CPU as the port's default place."""
    prev = tmesh.force_device_count(8)
    for _ in one_torch_thread_on_the_cpu():
        yield
    tmesh.force_device_count(prev)


def _meshes(axes):
    return (jdist.init_mesh(axes),
            tmesh.init_mesh(axes, device_type="cpu"))


class TestMesh:
    def test_init_mesh(self):
        jm, tm = _meshes({"dp": 4, "mp": 2})
        assert tm.shape == dict(jm.shape) == {"dp": 4, "mp": 2}
        assert tdist.get_mesh() is tm
        assert tdist.mesh_axis_size("mp") == jdist.mesh.mesh_axis_size("mp")

    def test_shard_array(self):
        jdist.init_mesh({"dp": 8})
        tmesh.init_mesh({"dp": 8}, device_type="cpu")
        x = np.arange(16, dtype=np.float32).reshape(8, 2)
        j, t = jdist.shard_array(x, "dp"), tdist.shard_array(x, "dp")
        assert len(t.shards) == len(j.sharding.device_set) == 8
        assert [tuple(s.shape) for s in t.shards] == [(1, 2)] * 8
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
        assert t.shape == j.shape

    def test_shard_array_two_axes(self):
        jdist.init_mesh({"dp": 4, "mp": 2})
        tmesh.init_mesh({"dp": 4, "mp": 2}, device_type="cpu")
        x = np.arange(32, dtype=np.float32).reshape(4, 8)
        t = tdist.shard_array(x, "dp", "mp")
        assert tuple(t.shards[1].shape) == (1, 4)
        np.testing.assert_array_equal(t.shards[1].numpy(), x[:1, 4:])
        np.testing.assert_array_equal(np.asarray(t),
                                      np.asarray(jdist.shard_array(
                                          x, "dp", "mp")))


def _sub(d, ranks):
    return d.new_group(ranks=ranks)


COLLECTIVES = {
    "all_reduce_sum": (np.arange(8, dtype=np.float32).reshape(8, 1),
                       lambda d, T: lambda s: d.all_reduce(T(s))._value),
    "all_reduce_max": (np.arange(8, dtype=np.float32).reshape(8, 1),
                       lambda d, T: lambda s: d.all_reduce(
                           T(s), op=d.ReduceOp.MAX)._value),
    "all_reduce_avg": (np.arange(8, dtype=np.float32).reshape(8, 1),
                       lambda d, T: lambda s: d.all_reduce(
                           T(s), op=d.ReduceOp.AVG)._value),
    "all_gather": (np.arange(8, dtype=np.float32).reshape(8, 1),
                   lambda d, T: lambda s: d.all_gather(None, T(s))._value),
    "broadcast": (np.arange(8, dtype=np.float32).reshape(8, 1),
                  lambda d, T: lambda s: d.broadcast(T(s), src=3)._value),
    "reduce": (np.arange(8, dtype=np.float32).reshape(8, 1),
               lambda d, T: lambda s: d.reduce(T(s), dst=2)._value),
    "reduce_scatter": (
        np.tile(np.arange(8, dtype=np.float32)[:, None], (8, 1)),
        lambda d, T: lambda s: d.reduce_scatter(None, T(s))._value),
    "p2p_shift": (np.arange(8, dtype=np.float32).reshape(8, 1),
                  lambda d, T: lambda s: d.p2p_shift(T(s), shift=1)._value),
    "alltoall": (np.arange(64, dtype=np.float32).reshape(64, 1),
                 lambda d, T: lambda s: d.alltoall(T(s))._value),
    "scatter": (np.arange(8, dtype=np.float32).reshape(8, 1),
                lambda d, T: lambda s: d.scatter(
                    T(s), [T(s * 0 + i) for i in range(8)])._value),
    "subgroup_all_reduce": (
        np.arange(8, dtype=np.float32).reshape(8, 1),
        lambda d, T: lambda s: d.all_reduce(
            T(s), group=_sub(d, [0, 1, 2, 3]))._value),
    "subgroup_all_reduce_min": (
        np.arange(8, dtype=np.float32).reshape(8, 1) - 3,
        lambda d, T: lambda s: d.all_reduce(
            T(s), op=d.ReduceOp.MIN, group=_sub(d, [1, 2, 5]))._value),
    "subgroup_all_gather_sum": (
        np.arange(8, dtype=np.float32).reshape(8, 1),
        lambda d, T: lambda s: (d.all_gather(
            None, T(s), group=_sub(d, [2, 3, 4, 5]))._value.sum()
            * (s * 0 + 1))),
    "subgroup_reduce_scatter": (
        np.tile(np.arange(4, dtype=np.float32)[:, None], (8, 1)),
        lambda d, T: lambda s: d.reduce_scatter(
            None, T(s), group=_sub(d, [0, 1, 2, 3]))._value),
    "subgroup_alltoall": (
        np.arange(32, dtype=np.float32).reshape(32, 1),
        lambda d, T: lambda s: d.alltoall(
            T(s), group=_sub(d, [0, 1, 2, 3]))._value),
    "prod_with_zero": (
        np.array([-2, 3, -1, 0, 1, 2, 1, 1], np.float32).reshape(8, 1),
        lambda d, T: lambda s: d.all_reduce(
            T(s), op=d.ReduceOp.PROD)._value),
    "prod_negatives": (
        np.array([-2, 3, -1, 1, 1, 2, 1, 1], np.float32).reshape(8, 1),
        lambda d, T: lambda s: d.all_reduce(
            T(s), op=d.ReduceOp.PROD)._value),
    "subgroup_prod": (
        np.array([-2, 3, -1, 4, 1, 2, 5, 1], np.float32).reshape(8, 1),
        lambda d, T: lambda s: d.all_reduce(
            T(s), op=d.ReduceOp.PROD, group=_sub(d, [0, 3, 6]))._value),
    "send_recv_single_edge": (
        np.arange(8, dtype=np.float32).reshape(8, 1),
        lambda d, T: lambda s: (d.send(T(s), dst=5, src=2),
                                d.recv(T(s), src=2, dst=5)._value)[1]),
    "subgroup_bool_max": (
        np.eye(8, 1, -1, dtype=bool),
        lambda d, T: lambda s: d.all_reduce(
            T(s), op=d.ReduceOp.MAX, group=_sub(d, [0, 1, 2, 3]))._value),
}


@pytest.fixture(scope="module")
def jax_collectives():
    """The JAX package's result of every case of COLLECTIVES, from one
    compiled shard_map over dp 8 (one compile for all of them)."""
    names = sorted(COLLECTIVES)
    jm = jdist.init_mesh({"dp": 8})

    def body(*shards):
        return tuple(COLLECTIVES[n][1](jdist, JTensor)(s)
                     for n, s in zip(names, shards))

    fn = jax.jit(jshard_map(body, mesh=jm,
                            in_specs=tuple(JP("dp") for _ in names),
                            out_specs=tuple(JP("dp") for _ in names)))
    outs = fn(*(jnp.asarray(COLLECTIVES[n][0]) for n in names))
    return {n: np.asarray(o) for n, o in zip(names, outs)}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_matches_jax(name, jax_collectives):
    """Each collective inside shard_map over dp 8, exact."""
    x, body = COLLECTIVES[name]
    tm = tmesh.init_mesh({"dp": 8}, device_type="cpu")
    t = tmesh.shard_map(lambda s: body(tdist, TTensor)(s), mesh=tm,
                        in_specs=(TP("dp"),), out_specs=TP("dp"))(x)
    t, j = t.detach().numpy(), jax_collectives[name]
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


def test_collectives_grad():
    """allreduce is differentiable through shard_map: d sum(out) / dx = 8
    in both packages."""
    jm, tm = _meshes({"dp": 8})
    x = np.ones((8, 1), np.float32)

    def jloss(xv):
        out = jshard_map(lambda s: jdist.all_reduce(JTensor(s))._value,
                         mesh=jm, in_specs=(JP("dp"),),
                         out_specs=JP("dp"))(xv)
        return jnp.sum(out)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    out = tmesh.shard_map(lambda s: tdist.all_reduce(TTensor(s))._value,
                          mesh=tm, in_specs=(TP("dp"),),
                          out_specs=TP("dp"))(xt)
    out.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), jg)
    np.testing.assert_array_equal(jg, np.full((8, 1), 8.0))


def test_gather_and_scatter_grads_are_adjoints():
    """all_gather's input cotangent is the sum of its slice's output
    cotangents, psum_scatter's the broadcast one, ppermute's the inverse
    shift — as jax.grad gives them inside shard_map."""
    from paddle_tpu_torch.distributed import lax as tlax

    jm, tm = _meshes({"dp": 4, "mp": 2})
    x = np.arange(16, dtype=np.float32).reshape(8, 2) + 1
    w = np.linspace(0.5, 2.0, 16, dtype=np.float32).reshape(8, 2)

    def jbody(s):
        g = jax.lax.all_gather(s, "dp", axis=0, tiled=True)
        r = jax.lax.psum_scatter(g * g, "mp", scatter_dimension=0,
                                 tiled=True)
        return jax.lax.ppermute(r, "dp", [(i, (i + 1) % 4)
                                          for i in range(4)])

    def tbody(s):
        g = tlax.all_gather(s, "dp", axis=0, tiled=True)
        r = tlax.psum_scatter(g * g, "mp", scatter_dimension=0, tiled=True)
        return tlax.ppermute(r, "dp", [(i, (i + 1) % 4) for i in range(4)])

    spec = ("dp", "mp")

    def jloss(xv):
        out = jshard_map(jbody, mesh=jm, in_specs=(JP(*spec),),
                         out_specs=JP(*spec), check_vma=False)(xv)
        return jnp.sum(out * jnp.asarray(np.tile(w, (2, 1))[:out.shape[0]]))

    jv = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tmesh.shard_map(tbody, mesh=tm, in_specs=(TP(*spec),),
                          out_specs=TP(*spec))(xt)
    (out * torch.tensor(np.tile(w, (2, 1))[:out.shape[0]])).sum().backward()
    # f32 sums of cotangents, in another order: 1e-6 relative
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jv), rtol=1e-6)


def test_slots_that_disagree_raise_instead_of_hanging():
    """Every slot must call the same collectives in the same order: a
    slot that skips one, calls another, or fails stops the run with an
    error in every case (the JAX package's SPMD program cannot express
    either)."""
    from paddle_tpu_torch.distributed import lax as tlax

    tm = tmesh.init_mesh({"dp": 4}, device_type="cpu")
    x = torch.ones(4, 1)

    def skips(s):
        return s if tlax.axis_index("dp") == 0 else tlax.psum(s, "dp")

    def differs(s):
        if tlax.axis_index("dp") == 1:
            return tlax.pmax(s, "dp")
        return tlax.psum(s, "dp")

    def fails(s):
        if tlax.axis_index("dp") == 2:
            raise ValueError("slot 2 failed")
        return tlax.psum(s, "dp")

    for body, err, match in ((skips, RuntimeError, "without joining"),
                             (differs, RuntimeError, "same collectives"),
                             (fails, ValueError, "slot 2 failed")):
        with pytest.raises(err, match=match):
            tmesh.shard_map(body, mesh=tm, in_specs=(TP("dp"),),
                            out_specs=TP("dp"))(x)


def test_eager_collective_identity_and_refusal(monkeypatch):
    """Eagerly, in a world of one, a collective is the identity; with two
    trainers and no host backend it raises in both packages."""
    x = np.arange(4, dtype=np.float32)
    out = tdist.all_reduce(pt.to_tensor(x))
    np.testing.assert_array_equal(out.numpy(), x)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    for d, t in ((tdist, pt.to_tensor(x)), (jdist, jpaddle.to_tensor(x))):
        with pytest.raises(RuntimeError, match="no host"):
            d.all_reduce(t)


# --- data-parallel and tensor-parallel train steps ---------------------------

def _carry(jlayer, tlayer):
    """The JAX layer's weights into the port's, by name."""
    state = {k: np.asarray(v._value) for k, v in jlayer.state_dict().items()}
    assert list(state) == list(tlayer.state_dict())
    assert tlayer.set_state_dict(state_from_numpy(state, "cpu")) == ([], [])


def _jax_step(layer, opt, axes, x, y, steps, loss):
    from paddle_tpu.distributed.parallel import make_sharded_train_step

    jdist.init_mesh(axes)
    step, state = make_sharded_train_step(layer, loss, opt)
    losses = []
    for _ in range(steps):
        state, lv = step(state, x, y)
        losses.append(float(np.asarray(lv)))
    return losses, {k: np.asarray(v) for k, v in state["params"].items()}, \
        {k: np.asarray(v) for k, v in state["buffers"].items()}


def _port_step(layer, opt, axes, x, y, steps, loss):
    from paddle_tpu_torch.distributed.parallel import make_sharded_train_step

    mesh = tmesh.init_mesh(axes, device_type="cpu")
    step, state = make_sharded_train_step(layer, loss, opt, mesh=mesh)
    losses = []
    for _ in range(steps):
        state, lv = step(state, x, y)
        losses.append(float(lv))
    return losses, {k: np.asarray(v) for k, v in state["params"].items()}, \
        {k: np.asarray(v) for k, v in state["buffers"].items()}, state


def _close(a, b):
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


class TestDataParallelStep:
    def _mlp(self, nn_):
        return nn_.Sequential(nn_.Linear(4, 16), nn_.ReLU(),
                              nn_.Linear(16, 2))

    def test_sharded_train_step_runs_and_replicates(self):
        """dp 8, Momentum: the losses fall and follow the JAX package's
        step from the same weights."""
        jpaddle.seed(0)
        jnet, tnet = self._mlp(jnn), self._mlp(tnn)
        _carry(jnet, tnet)
        rng = np.random.RandomState(0)
        x = rng.randn(16, 4).astype(np.float32)
        y = rng.randint(0, 2, (16,)).astype(np.int64)
        jl, jp, _ = _jax_step(jnet, jopt.Momentum(
            0.1, parameters=jnet.parameters()), {"dp": 8}, x,
            y.astype(np.int32), 10, lambda o, t: jnn.CrossEntropyLoss()(o, t))
        tl, tp, _, state = _port_step(tnet, topt.Momentum(
            0.1, parameters=tnet.parameters()), {"dp": 8}, x, y, 10,
            lambda o, t: tnn.CrossEntropyLoss()(o, t))
        assert tl[-1] < tl[0]
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        _close(tp, jp)
        # replicated over dp: every slot on the CPU shares one tensor
        shards = state["params"]["0.weight"].shards
        assert all(s is shards[0] for s in shards)

    def test_dp_matches_single_device(self):
        """DP over 8 slots equals the same batch on one slot (SGD)."""
        rng = np.random.RandomState(0)
        x = rng.randn(16, 4).astype(np.float32)
        y = np.random.RandomState(1).randint(0, 2, (16,)).astype(np.int64)
        out = {}
        for axes in ({"dp": 8}, {"dp": 1}):
            pt.seed(7)
            net = tnn.Linear(4, 2)
            _, out[len(out)], _, _ = _port_step(
                net, topt.SGD(0.1, parameters=net.parameters()), axes, x, y,
                5, lambda o, t: tnn.CrossEntropyLoss()(o, t))
        _close(out[0], out[1])

    def test_batch_norm_reduces_over_dp(self):
        """A batch norm (and its SyncBatchNorm form) inside the sharded
        step takes global-batch statistics: dp 8 equals dp 1 and the JAX
        package's pjit step, parameters and running statistics."""
        def net(nn_):
            return nn_.Sequential(nn_.Linear(4, 8), nn_.BatchNorm1D(8),
                                  nn_.ReLU(), nn_.Linear(8, 2))

        rng = np.random.RandomState(3)
        x = (rng.randn(16, 4) * 2 + 1).astype(np.float32)
        y = rng.randint(0, 2, (16,)).astype(np.int64)
        jpaddle.seed(1)
        jnet = net(jnn)
        runs = {}
        for tag, axes, sync in (("dp8", {"dp": 8}, False),
                                ("dp8_sync", {"dp": 8}, True),
                                ("dp1", {"dp": 1}, False)):
            tnet = net(tnn)
            _carry(jnet, tnet)
            if sync:
                tnet = tnn.SyncBatchNorm.convert_sync_batchnorm(tnet)
                assert isinstance(tnet[1], tnn.SyncBatchNorm)
            runs[tag] = _port_step(
                tnet, topt.SGD(0.1, parameters=tnet.parameters()), axes, x,
                y, 3, lambda o, t: tnn.CrossEntropyLoss()(o, t))
        jl, jp, jb = _jax_step(jnet, jopt.SGD(
            0.1, parameters=jnet.parameters()), {"dp": 8}, x,
            y.astype(np.int32), 3, lambda o, t: jnn.CrossEntropyLoss()(o, t))
        for tag in ("dp8", "dp8_sync"):
            np.testing.assert_allclose(runs[tag][0], runs["dp1"][0],
                                       rtol=RTOL)
            _close(runs[tag][1], runs["dp1"][1])
            _close(runs[tag][2], runs["dp1"][2])
        np.testing.assert_allclose(runs["dp8"][0], jl, rtol=RTOL)
        _close(runs["dp8"][1], jp)
        _close(runs["dp8"][2], jb)

    def test_state_carried_from_jax(self):
        """``load_sharded_state``: the JAX package's step state (weights,
        Momentum velocities, batch-norm statistics, step count) after two
        steps carried into a fresh port step at dp 4 x mp 2; the next two
        steps then follow the JAX package's."""
        from paddle_tpu.distributed.parallel import \
            make_sharded_train_step as jmake
        from paddle_tpu_torch.distributed.parallel import (
            load_sharded_state, make_sharded_train_step)

        def net(nn_):
            n = nn_.Sequential(nn_.Linear(4, 8), nn_.BatchNorm1D(8),
                               nn_.ReLU(), nn_.Linear(8, 2))
            n[0].weight.partition_spec = (None, "mp")
            n[0].bias.partition_spec = ("mp",)
            return n

        rng = np.random.RandomState(4)
        batches = [(rng.randn(16, 4).astype(np.float32),
                    rng.randint(0, 2, (16,))) for _ in range(4)]
        jpaddle.seed(2)
        jnet = net(jnn)
        jdist.init_mesh({"dp": 4, "mp": 2})
        jstep, jst = jmake(jnet, lambda o, t: jnn.CrossEntropyLoss()(o, t),
                           jopt.Momentum(0.1,
                                         parameters=jnet.parameters()))
        for x, y in batches[:2]:
            jst, _ = jstep(jst, x, y.astype(np.int32))
        tnet = net(tnn)
        mesh = tmesh.init_mesh({"dp": 4, "mp": 2}, device_type="cpu")
        tstep, tst = make_sharded_train_step(
            tnet, lambda o, t: tnn.CrossEntropyLoss()(o, t),
            topt.Momentum(0.1, parameters=tnet.parameters()), mesh=mesh)
        tst = load_sharded_state(
            tst, params=jst["params"], buffers=jst["buffers"],
            opt={k: dict(v) for k, v in jst["opt"].items()},
            step=int(jst["step"]))
        assert tuple(tst["params"]["0.weight"].shards[0].shape) == (4, 4)
        for x, y in batches[2:]:
            jst, jl = jstep(jst, x, y.astype(np.int32))
            tst, tl = tstep(tst, x, y)
            np.testing.assert_allclose(float(tl), float(np.asarray(jl)),
                                       rtol=RTOL)
        for part in ("params", "buffers"):
            _close({k: np.asarray(v) for k, v in tst[part].items()},
                   {k: np.asarray(v) for k, v in jst[part].items()})

    def test_data_parallel_wrapper(self):
        """``paddle.DataParallel`` wraps a layer transparently in one
        process, as the JAX package's does."""
        assert pt.DataParallel is tdist.DataParallel
        pt.seed(0)
        inner = tnn.Linear(3, 2)
        dp = pt.DataParallel(inner)
        x = pt.to_tensor(np.ones((2, 3), np.float32))
        np.testing.assert_array_equal(dp(x).numpy(), inner(x).numpy())
        assert list(dp.state_dict()) == list(inner.state_dict())
        loss = dp.scale_loss(dp(x).sum())
        loss.backward()
        g = inner.weight.grad.numpy().copy()
        dp.apply_collective_grads()       # one process: nothing moves
        np.testing.assert_array_equal(inner.weight.grad.numpy(), g)


BERT = dict(num_classes=4, vocab_size=64, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, dropout=0.0)


@pytest.fixture(scope="module")
def jax_bert():
    """The JAX package's BERT of the module (its steps are functional:
    the layer keeps its weights)."""
    jpaddle.seed(0)
    return jmodels.BertForSequenceClassification(**BERT)


class TestTensorParallel:
    def test_bert_partition_specs_match_jax(self, jax_bert):
        jm = jax_bert
        tm = tmodels.BertForSequenceClassification(**BERT)
        jspecs = {n: tuple(getattr(p, "partition_spec", None) or ())
                  for n, p in jm.named_parameters()}
        tspecs = {n: tuple(getattr(p, "partition_spec", None) or ())
                  for n, p in tm.named_parameters()}
        assert tspecs == jspecs
        assert sum(1 for s in tspecs.values() if s) == 1 + 2 * 10

    def test_bert_dp4_mp2_equals_one_device_and_jax(self, jax_bert):
        """make_sharded_train_step on BERT at dp 4 x mp 2 (2 local heads a
        slot, the vocab rows split): the one-slot step's losses and
        parameters, and the JAX package's pjit step's."""
        jm = jax_bert
        rng = np.random.RandomState(0)
        x = rng.randint(0, 64, (8, 16))
        y = rng.randint(0, 4, (8,))
        runs = {}
        for axes in ({"dp": 4, "mp": 2}, {"dp": 1}):
            tm = tmodels.BertForSequenceClassification(**BERT)
            _carry(jm, tm)
            runs[len(runs)] = _port_step(
                tm, topt.SGD(0.5, parameters=tm.parameters()), axes,
                x.astype(np.int64), y.astype(np.int64), 2,
                lambda o, t: tnn.CrossEntropyLoss()(o, t))
        state = runs[0][3]
        q = state["params"]["bert.encoder.layers.0.self_attn.q_proj.weight"]
        assert tuple(q.shards[0].shape) == (32, 16) and q.shape == (32, 32)
        emb = state["params"]["bert.embeddings.word_embeddings.weight"]
        assert tuple(emb.shards[1].shape) == (32, 32)
        np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=RTOL)
        _close(runs[0][1], runs[1][1])
        jl, jp, _ = _jax_step(
            jm, jopt.SGD(0.5, parameters=jm.parameters()),
            {"dp": 4, "mp": 2}, jnp.asarray(x, jnp.int32),
            jnp.asarray(y, jnp.int32), 2,
            lambda o, t: jnn.CrossEntropyLoss()(o, t))
        np.testing.assert_allclose(runs[0][0], jl, rtol=RTOL)
        _close(runs[0][1], jp)

    def test_column_row_parallel_linear_shapes(self):
        _meshes({"dp": 4, "mp": 2})
        for d in (jdist, tdist):
            col = d.ColumnParallelLinear(8, 16, gather_output=True)
            assert col.weight.shape == [8, 8]
            assert tuple(col.weight.partition_spec) == (None, "mp")
            row = d.RowParallelLinear(8, 16)
            assert row.weight.shape == [4, 16]
            emb = d.VocabParallelEmbedding(100, 8)
            assert emb.weight.shape == [50, 8]

    def test_tp_layers_match_dense_and_jax(self):
        """Column -> Row Megatron pair, the vocab-parallel embedding and
        the vocab-parallel cross entropy under shard_map over mp 8 (each
        slot builds its layers; the shards set as weights) against the
        dense computation and the JAX package."""
        jm, tm = _meshes({"mp": 8})
        rng = np.random.RandomState(0)
        w1 = rng.randn(8, 16).astype(np.float32)
        w2 = rng.randn(16, 4).astype(np.float32)
        table = rng.randn(64, 4).astype(np.float32)
        x = rng.randn(2, 8).astype(np.float32)
        ids = rng.randint(0, 64, (2, 5)).astype(np.int32)
        logits = rng.randn(3, 16).astype(np.float32)
        labels = rng.randint(0, 16, (3,)).astype(np.int32)

        def body(d, T, wrap):
            def f(a, b, tab, xv, iv, lg, lb):
                col = d.ColumnParallelLinear(8, 16, gather_output=False,
                                             has_bias=False)
                row = d.RowParallelLinear(16, 4, input_is_parallel=True,
                                          has_bias=False)
                emb = d.VocabParallelEmbedding(64, 4)
                col.weight._value, row.weight._value = wrap(a), wrap(b)
                emb.weight._value = wrap(tab)
                ce = d.ParallelCrossEntropy()
                return (row(col(T(xv)))._value, emb(T(iv))._value,
                        ce(T(lg), T(lb))._value)
            return f

        specs = (JP(None, "mp"), JP("mp", None), JP("mp", None), JP(),
                 JP(), JP(None, "mp"), JP())
        args = (w1, w2, table, x, ids, logits, labels)
        j = jax.jit(jshard_map(body(jdist, JTensor, lambda v: v), mesh=jm,
                               in_specs=specs, out_specs=(JP(), JP(), JP())))(
                                   *map(jnp.asarray, args))
        t = tmesh.shard_map(body(tdist, TTensor, lambda v: v), mesh=tm,
                            in_specs=tuple(TP(*s) for s in specs),
                            out_specs=(TP(), TP(), TP()))(*args)
        ref_ce = (np.log(np.exp(logits).sum(-1))
                  - logits[np.arange(3), labels])
        for got, want, ref in zip(t, j, (x @ w1 @ w2, table[ids], ref_ce)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-4)


# --- the environment contract ---------------------------------------------

ENV_KEYS = ("PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_DIST_BACKEND",
            "PADDLE_GLOO_ENDPOINT")


class TestMultiProcessInitContract:
    def _clean(self, monkeypatch):
        from paddle_tpu.distributed import env as jenv
        from paddle_tpu_torch.distributed import env as tenv

        for mod in (jenv, tenv):
            monkeypatch.setattr(mod, "_initialized", False)
        for k in ENV_KEYS:
            monkeypatch.delenv(k, raising=False)
        return jenv, tenv

    def test_env_contract_reaches_init_process_group(self, monkeypatch):
        """The PADDLE_TRAINER_* contract reaches
        torch.distributed.init_process_group as it reaches
        jax.distributed.initialize: the first endpoint, the world size and
        the rank; idempotent."""
        jenv, tenv = self._clean(monkeypatch)
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
        monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                           "10.0.0.1:8371,10.0.0.2:8371")
        jcalls, tcalls = [], []
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: jcalls.append(kw))
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **kw: tcalls.append(kw))
        for env_mod in (jenv, tenv):
            env_mod.init_parallel_env()
            env_mod.init_parallel_env()
        assert len(jcalls) == len(tcalls) == 1
        assert tcalls[0]["init_method"] == \
            f"tcp://{jcalls[0]['coordinator_address']}"
        assert tcalls[0]["world_size"] == jcalls[0]["num_processes"] == 2
        assert tcalls[0]["rank"] == jcalls[0]["process_id"] == 1
        assert tcalls[0]["backend"] == "gloo"      # no card here
        assert (tenv.get_rank(), tenv.get_world_size()) == \
            (jenv.get_rank(), jenv.get_world_size()) == (1, 2)
        assert tenv.device_count() == jenv.device_count() == 8
        penv = tenv.ParallelEnv()
        assert (penv.rank, penv.nranks, penv.trainer_endpoints) == \
            (1, 2, ["10.0.0.1:8371", "10.0.0.2:8371"])

    def test_single_process_skips_rendezvous(self, monkeypatch):
        jenv, tenv = self._clean(monkeypatch)
        called = []
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda **kw: called.append(kw))
        tenv.init_parallel_env()
        assert called == []
        assert (tenv.get_rank(), tenv.get_world_size()) == \
            (jenv.get_rank(), jenv.get_world_size()) == (0, 1)

    def test_gloo_backend_requires_rendezvous_endpoint(self, monkeypatch):
        jenv, tenv = self._clean(monkeypatch)
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
        monkeypatch.setenv("PADDLE_DIST_BACKEND", "gloo")
        for env_mod in (jenv, tenv):
            with pytest.raises(ValueError, match="PADDLE_GLOO_ENDPOINT"):
                env_mod.init_parallel_env()

    def test_distributed_sampler_takes_the_environment(self, monkeypatch):
        """DistributedBatchSampler without num_replicas / rank reads
        get_world_size() / get_rank(), in both packages."""
        from paddle_tpu import io as jio
        from paddle_tpu_torch import io as tio

        self._clean(monkeypatch)
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
        data = list(range(10))
        s, j = (io.DistributedBatchSampler(data, 2) for io in (tio, jio))
        assert (s.nranks, s.local_rank) == (j.nranks, j.local_rank) == (3, 2)
        assert list(s) == list(j)
