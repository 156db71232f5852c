"""paddle_tpu_torch's pipeline parallelism, ZeRO update and hybrid
dp x pp x mp step against the JAX package's on the same inputs — the
twins of ``tests/test_pipeline.py``, ``tests/test_hybrid_step.py`` and a
ZeRO case.

The port's mesh runs on ``force_device_count(8)`` CPU slots, the JAX
package's on the 8 forced host devices.

Tolerances: f32 pipeline outputs and losses within 1e-5 relative of the
JAX package's, gradients within 1e-4 relative and 1e-5 absolute (the
JAX tests' bounds against their sequential references); the 1F1B issue
tables are equal; the ZeRO update within 1e-6; the hybrid step's losses
within 2e-4 relative of the JAX package's (its test's bound against its
reference) and its parameters within 1e-5 absolute after four Adam steps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed import zero as jzero
from paddle_tpu.distributed.hybrid_step import make_hybrid_step as jhybrid
from paddle_tpu.distributed.mesh import shard_map as jshard_map

from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed import pipeline as tpipe
from paddle_tpu_torch.distributed import zero as tzero
from paddle_tpu_torch.distributed.hybrid_step import \
    make_hybrid_step as thybrid
from torch_layer_parity import one_torch_thread_on_the_cpu


@pytest.fixture(scope="module", autouse=True)
def _cpu_slots():
    prev = tmesh.force_device_count(8)
    for _ in one_torch_thread_on_the_cpu():
        yield
    tmesh.force_device_count(prev)


def jstage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def tstage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def make_params(n_stages, d, seed=0):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(d, d) * 0.5).astype(np.float32),
             "b": (rng.randn(d) * 0.1).astype(np.float32)}
            for _ in range(n_stages)]


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree, grad=False):
    return tmesh.tree_map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=grad), tree)


def _meshes(axes):
    return jdist.init_mesh(axes), tmesh.init_mesh(axes, device_type="cpu")


def _close(a, b, rtol=1e-4, atol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


class TestPipeline:
    @pytest.mark.parametrize("mbs", [2, 4, 8])
    def test_forward_and_grads_match_jax(self, mbs):
        """pipeline_forward at pp 4, with 2 to 8 microbatches: outputs and
        the stage gradients of sum(out**2) (JAX: jax.grad of the same)."""
        jm, tm = _meshes({"pp": 4})
        per = make_params(4, 8, seed=9)
        x = np.random.RandomState(5).randn(16, 8).astype(np.float32)

        def jloss(st):
            out = jpipe.pipeline_forward(jm, jstage, st, jnp.asarray(x),
                                         micro_batch_size=mbs)
            return jnp.sum(out ** 2), out

        (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jpipe.stack_stage_params(_j(per)))
        st = tpipe.stack_stage_params(_t(per))
        st = tmesh.tree_map(lambda a: a.requires_grad_(True), st)
        tout = tpipe.pipeline_forward(tm, tstage, st, torch.tensor(x),
                                      micro_batch_size=mbs)
        tg = torch.autograd.grad((tout ** 2).sum(), [st["w"], st["b"]])
        _close(tout, jout, rtol=1e-5, atol=1e-5)
        _close(tg[0], jg["w"])
        _close(tg[1], jg["b"])
        ref = x
        for p in per:
            ref = np.tanh(ref @ p["w"] + p["b"])
        _close(tout, ref, rtol=1e-5, atol=1e-5)

    def test_pp_times_dp_mesh(self):
        """pipeline_apply inside a shard_map over pp 4 x dp 2, the batch
        split over dp."""
        _, tm = _meshes({"pp": 4, "dp": 2})
        d = 4
        per = make_params(4, d, seed=11)
        x = np.random.RandomState(1).randn(8, d).astype(np.float32)

        def inner(params_local, xloc):
            params_local = tmesh.tree_map(lambda p: p[0], params_local)
            outs = tpipe.pipeline_apply(tstage, params_local,
                                        xloc.reshape(2, 2, d),
                                        axis_name="pp")
            from paddle_tpu_torch.distributed import lax

            last = lax.axis_index("pp") == lax.axis_size("pp") - 1
            outs = lax.psum(outs * (1.0 if last else 0.0), "pp")
            return outs.reshape(4, d)

        out = tmesh.shard_map(inner, mesh=tm,
                              in_specs=(tmesh.P("pp"), tmesh.P("dp")),
                              out_specs=tmesh.P("dp"))(
            tpipe.stack_stage_params(_t(per)), x)
        ref = x
        for p in per:
            ref = np.tanh(ref @ p["w"] + p["b"])
        _close(out, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("schedule", ["remat", "f-then-b"])
    def test_head_tail_loss_and_grads_match_jax(self, schedule):
        """Embedding head and classifier tail around the stages: the loss
        and the head, stage and tail gradients (both schedules)."""
        V, D, K = 32, 8, 4
        jm, tm = _meshes({"pp": 4})
        rng = np.random.RandomState(5)
        head = {"emb": (rng.randn(V, D) * 0.5).astype(np.float32)}
        tail = {"w": (rng.randn(D, K) * 0.5).astype(np.float32)}
        per = make_params(4, D, seed=6)
        tok = np.random.RandomState(4).randint(0, V, (8, 5))
        y = np.random.RandomState(5).randint(0, K, (8,))

        def jloss(hp, st, tp):
            logits = jpipe.pipeline_forward(
                jm, jstage, st, jnp.asarray(tok, jnp.int32),
                micro_batch_size=2, head_fn=lambda h, t: h["emb"][t],
                head_params=hp,
                tail_fn=lambda t, h: h.mean(axis=1) @ t["w"],
                tail_params=tp, schedule=schedule)
            lse = jax.nn.logsumexp(logits, axis=-1)
            ll = jnp.take_along_axis(logits, jnp.asarray(y)[:, None],
                                     axis=-1)[:, 0]
            return jnp.mean(lse - ll)

        jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
            _j(head), jpipe.stack_stage_params(_j(per)), _j(tail))
        hp, tp = _t(head, True), _t(tail, True)
        st = tmesh.tree_map(lambda a: a.requires_grad_(True),
                            tpipe.stack_stage_params(_t(per)))
        logits = tpipe.pipeline_forward(
            tm, tstage, st, torch.tensor(tok), micro_batch_size=2,
            head_fn=lambda h, t: h["emb"][t], head_params=hp,
            tail_fn=lambda t, h: h.mean(dim=1) @ t["w"], tail_params=tp,
            schedule=schedule)
        assert tuple(logits.shape) == (8, K)
        tl = torch.nn.functional.cross_entropy(logits, torch.tensor(y))
        tg = torch.autograd.grad(tl, [hp["emb"], st["w"], st["b"],
                                      tp["w"]])
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for a, b in zip(tg, (jg[0]["emb"], jg[1]["w"], jg[1]["b"],
                             jg[2]["w"])):
            _close(a, b)

    def test_shape_preserving_violation_raises(self):
        _, tm = _meshes({"pp": 4})
        st = tpipe.stack_stage_params(_t(make_params(4, 8)))
        with pytest.raises(Exception, match="preserve the carried"):
            tpipe.pipeline_forward(tm, lambda p, v: (v @ p["w"])[:, :4], st,
                                   torch.ones(8, 8), micro_batch_size=2)

    def test_1f1b_alias_removed(self):
        with pytest.raises(ValueError, match="pipeline_train_1f1b"):
            tpipe.pipeline_apply(tstage, {}, torch.zeros(2, 2, 4),
                                 schedule="1f1b")


class Test1F1B:
    @pytest.mark.parametrize("M,n", [(8, 4), (16, 4), (5, 2), (3, 4)])
    def test_schedule_tables_equal_jax(self, M, n):
        f, b = tpipe.build_1f1b_schedule(M, n)
        jf, jb = jpipe.build_1f1b_schedule(M, n)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(b, jb)
        assert tpipe.schedule_peak_in_flight(f, b) == \
            jpipe.schedule_peak_in_flight(jf, jb) <= n

    @pytest.mark.parametrize("B,mbs,head", [(8, 2, True), (24, 2, False)])
    def test_train_step_matches_jax_and_sequential(self, B, mbs, head):
        """pipeline_train_step (interleaved 1F1B) against the JAX
        package's on the same inputs, and against the stages in
        sequence."""
        jm, tm = _meshes({"pp": 4})
        n, d = 4, 8
        M = B // mbs
        per = make_params(n, d, seed=11)
        rng = np.random.RandomState(3)
        hp = {"w": (rng.randn(6, d) * 0.3).astype(np.float32)}
        x = rng.randn(B, 6 if head else d).astype(np.float32)
        y = rng.randn(B, d).astype(np.float32)
        kw_j = dict(head_fn=lambda h, xb: xb @ h["w"], head_params=_j(hp)) \
            if head else {}
        kw_t = dict(head_fn=lambda h, xb: xb @ h["w"], head_params=_t(hp)) \
            if head else {}

        def loss_fn(out, tgt):
            return ((out - tgt) ** 2).sum()

        jl, jgs, jgh = jax.jit(lambda st, xx, yy: jpipe.pipeline_train_step(
            jm, jstage, st, xx, yy, mbs, loss_fn, **kw_j))(
                jpipe.stack_stage_params(_j(per)), jnp.asarray(x),
                jnp.asarray(y))
        tl, tgs, tgh = tpipe.pipeline_train_step(
            tm, tstage, tpipe.stack_stage_params(_t(per)), torch.tensor(x),
            torch.tensor(y), mbs, loss_fn, **kw_t)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _close(tgs["w"], jgs["w"])
        _close(tgs["b"], jgs["b"])
        if head:
            _close(tgh["w"], jgh["w"])
        # the stages in sequence
        leaves = _t(per, True)
        hw = torch.tensor(hp["w"], requires_grad=True)
        h = torch.tensor(x) @ hw if head else torch.tensor(x)
        for p in leaves:
            h = tstage(p, h)
        ref = loss_fn(h, torch.tensor(y)) / M
        g = torch.autograd.grad(ref, [p["w"] for p in leaves])
        np.testing.assert_allclose(float(tl), float(ref), rtol=1e-5)
        for i in range(n):
            _close(tgs["w"][i], g[i])


class TestZero:
    def test_zero_adam_update_matches_jax(self):
        """zero_adam_update inside shard_map over dp 4 (sizes that do not
        divide by 4 included, weight decay on): the new parameters and
        each rank's [dp, chunk] state, two steps."""
        jm, tm = _meshes({"dp": 4})
        rng = np.random.RandomState(0)
        shapes = {"a": (5, 3), "b": (7,), "c": (4, 4)}
        params = {k: rng.randn(*s).astype(np.float32)
                  for k, s in shapes.items()}
        grads = [{k: rng.randn(4, *s).astype(np.float32)
                  for k, s in shapes.items()} for _ in range(2)]
        chunk = {k: tzero._chunk_len(int(np.prod(s)), 4)
                 for k, s in shapes.items()}
        assert chunk == {k: jzero._chunk_len(int(np.prod(s)), 4)
                         for k, s in shapes.items()}
        state0 = {kind: {k: np.zeros((4, c), np.float32)
                         for k, c in chunk.items()} for kind in ("m", "v")}
        kw = dict(axis_name="dp", axis_size=4, lr=1e-2, weight_decay=0.01)

        def jbody(p, g, z, count):
            g = {k: v[0] for k, v in g.items()}
            z = {kind: {k: v.reshape(-1) for k, v in d.items()}
                 for kind, d in z.items()}
            new_p, new_z = jzero.zero_adam_update(p, g, z, count, **kw)
            return new_p, {kind: {k: v[None] for k, v in d.items()}
                           for kind, d in new_z.items()}

        def tbody(p, g, z, count):
            g = {k: v[0] for k, v in g.items()}
            z = {kind: {k: v.reshape(-1) for k, v in d.items()}
                 for kind, d in z.items()}
            new_p, new_z = tzero.zero_adam_update(p, g, z, count, **kw)
            return new_p, {kind: {k: v[None] for k, v in d.items()}
                           for kind, d in new_z.items()}

        jfn = jax.jit(jshard_map(jbody, mesh=jm,
                                 in_specs=(JP(), JP("dp"), JP("dp"), JP()),
                                 out_specs=(JP(), JP("dp")),
                                 check_vma=False))
        tfn = tmesh.shard_map(tbody, mesh=tm,
                              in_specs=(tmesh.P(), tmesh.P("dp"),
                                        tmesh.P("dp"), tmesh.P()),
                              out_specs=(tmesh.P(), tmesh.P("dp")))
        jp, jz, tp, tz = params, state0, params, state0
        for step in (1, 2):
            jp, jz = jfn(_j(jp), _j(grads[step - 1]), _j(jz),
                         jnp.asarray(step, jnp.int32))
            tp, tz = tfn(tp, grads[step - 1], tz, step)
            tp = {k: v.numpy() for k, v in tp.items()}
            tz = {kind: {k: v.numpy() for k, v in d.items()}
                  for kind, d in tz.items()}
            for k in shapes:
                _close(tp[k], jp[k], rtol=1e-6, atol=1e-6)
                for kind in ("m", "v"):
                    _close(tz[kind][k], jz[kind][k], rtol=1e-6, atol=1e-7)


def _hybrid_meshes():
    devs = np.asarray(jax.devices()[:8]).reshape(2, 2, 2)
    return (JMesh(devs, ("dp", "pp", "mp")),
            tmesh.init_mesh({"dp": 2, "pp": 2, "mp": 2}, device_type="cpu"))


class TestHybridStep:
    def test_hybrid_matches_jax(self):
        """dp 2 x pp 2 x mp 2 + ZeRO, the JAX package's draws: four steps,
        each loss and then every parameter and ZeRO moment."""
        jm, tm = _hybrid_meshes()
        kw = dict(vocab=64, d_model=32, d_ff=64, n_classes=4, seq=8,
                  micro_batch=1, lr=1e-2, seed=0)
        jstep, jst = jhybrid(jm, **kw)
        tstep, tst = thybrid(tm, **kw)
        for k in jst[0]:
            np.testing.assert_array_equal(np.asarray(tst[0][k]),
                                          np.asarray(jst[0][k]))
        rng = np.random.RandomState(1)
        x = rng.randint(0, 64, (4, 8)).astype(np.int32)
        y = rng.randint(0, 4, (4,)).astype(np.int32)
        for i in range(4):
            jst, jl = jstep(jst, jnp.asarray(x), jnp.asarray(y))
            tst, tl = tstep(tst, x, y)
            np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4,
                                       err_msg=f"step {i}")
        for k in jst[0]:
            _close(np.asarray(tst[0][k]), jst[0][k], rtol=0, atol=1e-5)
            _close(np.asarray(tst[1]["m"][k]), jst[1]["m"][k], rtol=0,
                   atol=1e-5)
        # the ZeRO state really is dp-sharded
        assert tst[1]["m"]["emb"].shape == tuple(jst[1]["m"]["emb"].shape)
        assert tst[1]["m"]["emb"].shape[-2] == 2
        assert tuple(tst[1]["m"]["emb"].shards[0].shape)[-2] == 1

    def test_hybrid_state_carried_from_jax(self):
        """``load_sharded_state`` on the hybrid step: the JAX package's
        parameters and ZeRO moments after two steps (another seed's
        draws in the port's own state) carried in; the next two steps
        follow the JAX package's."""
        from paddle_tpu_torch.distributed.parallel import load_sharded_state

        jm, tm = _hybrid_meshes()
        kw = dict(vocab=64, d_model=32, d_ff=64, n_classes=4, seq=8,
                  micro_batch=1, lr=1e-2)
        jstep, jst = jhybrid(jm, seed=0, **kw)
        tstep, tst = thybrid(tm, seed=5, **kw)
        rng = np.random.RandomState(7)
        x = rng.randint(0, 64, (4, 8)).astype(np.int32)
        y = rng.randint(0, 4, (4,)).astype(np.int32)
        for _ in range(2):
            jst, _ = jstep(jst, jnp.asarray(x), jnp.asarray(y))
        tst = load_sharded_state(tst, params=dict(jst[0]),
                                 opt={k: dict(v) for k, v in jst[1].items()},
                                 step=int(jst[2]))
        for _ in range(2):
            jst, jl = jstep(jst, jnp.asarray(x), jnp.asarray(y))
            tst, tl = tstep(tst, x, y)
            np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4)
        for k in jst[0]:
            _close(np.asarray(tst[0][k]), jst[0][k], rtol=0, atol=1e-5)

    def test_hybrid_loss_decreases_multi_step(self):
        _, tm = _hybrid_meshes()
        step, state = thybrid(tm, vocab=64, d_model=32, d_ff=64,
                              n_classes=4, seq=8, micro_batch=2, lr=2e-2,
                              seed=3)
        rng = np.random.RandomState(2)
        x = rng.randint(0, 64, (8, 8))
        y = rng.randint(0, 4, (8,))
        losses = []
        for _ in range(6):
            state, loss = step(state, x, y)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.9, losses
