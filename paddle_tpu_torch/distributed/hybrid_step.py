"""Hybrid dp×pp×mp training step with ZeRO optimizer sharding — twin of
``paddle_tpu/distributed/hybrid_step.py``: the explicit-collective
composition of every parallelism axis over one ('dp','pp','mp') mesh.

Reference analog: the fleet meta-optimizer stack composing sharding + pipeline
+ tensor parallel rewrites over one Program (sharding_optimizer.py:69,
pipeline_optimizer.py:151, collective.py:811 `split`).  Per slot:
  pp: microbatch pipeline over the ticks via ppermute (distributed/pipeline.py)
  mp: Megatron column/row-parallel MLP with in-body psum; the classifier
      head is column-sharded with an all_gather of logits
  dp: batch sharding; gradients reduce-scattered and optimizer state sharded
      by ZeRO-1/2 (distributed/zero.py), updated params all-gathered

Model (toy but structurally faithful): embedding -> pp pipeline of
[residual MLP stage] -> mean-pool -> column-parallel classifier.

The step runs as the JAX package's does inside ``shard_map``: each slot's
gradient is that of the SUM of every slot's loss (the slots' losses are
one autograd graph, joined by the collectives, whose transposes are the
adjoints ``shard_map`` gives them: a psum's input cotangent is the sum of
its group's output cotangents), then each slot runs the update.

Gradient bookkeeping (why the psums below are correct):
  - the scalar loss is DEFINED as psum(mask_last_stage * local_loss, 'pp'),
    so only the last pp rank's head/loss computation receives cotangents —
    psum'ing param grads over 'pp' cannot double-count;
  - activation cotangents flowing up the network are PARTIAL over 'mp'
    (each mp rank back-propagates through its own head/W1 shard while the
    residual identity path replicates).  Megatron's ``f`` operator
    (``_mp_copy``: identity forward, psum-over-'mp' backward — reference
    collective.py:811 `_c_identity`) sits at the pipeline input, so the
    embedding grad arrives complete on every mp rank (then psum over 'pp'
    only, since it is nonzero only on the ingest stage);
  - W1/b1/W2 grads are exact locally because the in-stage psum's transpose
    re-totals the partial cotangents; b2 (added after the psum) sees the
    partial cotangent directly, so its grad needs an explicit psum('mp');
  - only the 'dp' reduction (inside the ZeRO update) applies beyond that.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lax
from .mesh import PartitionSpec as P
from .mesh import ShardedArray, _split, psum, run_slots
from .pipeline import pipeline_apply
from .zero import _chunk_len, zero_adam_update

__all__ = ["make_hybrid_step"]


def _mp_copy(x):
    """Megatron f-operator: identity forward, psum over 'mp' backward."""
    return lax.joint("mp_copy", x, "mp", forward=list, backward=psum)


def make_hybrid_step(mesh, vocab=64, d_model=32, d_ff=64, n_classes=4,
                     seq=8, micro_batch=1, lr=1e-2, seed=0):
    """Returns (step_fn, state); step_fn(state, x, y) -> (state, loss).

    x: [B, seq] int tokens (B divisible by dp*micro_batch), y: [B] labels.
    ``state = (params, zstate, count)``: ``params[name]`` and
    ``zstate['m' | 'v'][name]`` are :class:`~.mesh.ShardedArray`s laid
    out by the specs below, ``count`` the step count.  The weights are
    the JAX package's draws (``np.random.RandomState(seed)``)."""
    dp = mesh.shape["dp"]
    pp = mesh.shape["pp"]
    mp = mesh.shape["mp"]
    assert d_ff % mp == 0 and n_classes % mp == 0
    rng = np.random.RandomState(seed)

    def init(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)

    params = {
        "emb": init(vocab, d_model),
        "w1": init(pp, d_model, d_ff),      # sharded (pp, -, mp)
        "b1": np.zeros((pp, d_ff), np.float32),
        "w2": init(pp, d_ff, d_model),      # sharded (pp, mp, -)
        "b2": np.zeros((pp, d_model), np.float32),
        "head": init(d_model, n_classes),   # sharded (-, mp)
    }
    specs = {
        "emb": P(), "w1": P("pp", None, "mp"), "b1": P("pp", "mp"),
        "w2": P("pp", "mp", None), "b2": P("pp", None),
        "head": P(None, "mp"),
    }

    # ZeRO state: chunks sized by the LOCAL shard of each param
    def local_size(name):
        full = params[name].shape
        s = tuple(specs[name]) + (None,) * (len(full) - len(specs[name]))
        n = 1
        for dim, ax in zip(full, s):
            n *= dim // (mesh.shape[ax] if ax else 1)
        return n

    zstate, zspecs = {"m": {}, "v": {}}, {}
    for name in params:
        c = _chunk_len(local_size(name), dp)
        lead = tuple(ax for ax in specs[name] if ax)
        shape = tuple(mesh.shape[a] for a in lead) + (dp, c)
        zspecs[name] = P(*(lead + ("dp",)))
        for kind in ("m", "v"):
            zstate[kind][name] = np.zeros(shape, np.float32)

    dev0 = mesh.slots[0]

    def place(arr, spec_):
        return ShardedArray([t.clone() for t in _split(
            torch.as_tensor(arr, device=dev0), spec_, mesh)], spec_, mesh)

    mb = micro_batch

    def stage_fn(sp, x):
        w1, b1, w2, b2 = sp
        h = torch.nn.functional.gelu(
            torch.einsum("mtd,df->mtf", x, w1) + b1, approximate="tanh")
        y = torch.einsum("mtf,fd->mtd", h, w2)
        y = lax.psum(y, "mp") + b2
        return x + y

    def loss_of(pt, x, y):
        pp_idx = lax.axis_index("pp")
        Bl = x.shape[0]
        M = Bl // mb
        e = _mp_copy(pt["emb"][x.long()])           # [Bl, seq, d]
        xm = e.reshape(M, mb, seq, d_model)
        outs = pipeline_apply(
            stage_fn, (pt["w1"], pt["b1"], pt["w2"], pt["b2"]), xm,
            axis_name="pp", schedule="f-then-b")
        pooled = outs.reshape(Bl, seq, d_model).mean(dim=1)
        logits_l = pooled @ pt["head"]               # [Bl, n_classes/mp]
        logits = lax.all_gather(logits_l, "mp", axis=0, tiled=False)
        logits = logits.movedim(0, 1).reshape(Bl, n_classes)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, y.long()[:, None])[:, 0]
        local = torch.mean(lse - ll)
        # the loss lives on the last pp stage only (module docstring)
        mask = 1.0 if pp_idx == pp - 1 else 0.0
        return lax.psum(local * mask, "pp")

    def squeeze(p):
        return {"emb": p["emb"], "w1": p["w1"][0], "b1": p["b1"][0],
                "w2": p["w2"][0], "b2": p["b2"][0], "head": p["head"]}

    def forward_body(p, x, y):
        return loss_of(squeeze(p), x, y)

    def update_body(p, g, z, count, loss):
        grads = squeeze(g)
        # cross-axis grad totals (dp inside the ZeRO update); the module
        # docstring says why each psum is exactly right
        grads["emb"] = lax.psum(grads["emb"], "pp")
        grads["head"] = lax.psum(grads["head"], "pp")
        grads["b2"] = lax.psum(grads["b2"], "mp")
        zlocal = {kind: {k: a.reshape(a.shape[-1:]) for k, a in d.items()}
                  for kind, d in z.items()}
        new_p, new_z = zero_adam_update(
            {k: v.detach() for k, v in squeeze(p).items()}, grads, zlocal,
            count, "dp", dp, lr=lr)
        new_z = {kind: {k: a.reshape(z[kind][k].shape)
                        for k, a in d.items()} for kind, d in new_z.items()}
        out = {"emb": new_p["emb"], "w1": new_p["w1"][None],
               "b1": new_p["b1"][None], "w2": new_p["w2"][None],
               "b2": new_p["b2"][None], "head": new_p["head"]}
        with torch.no_grad():
            loss_mean = lax.psum(loss.detach(), "dp") / dp
        return out, new_z, loss_mean

    def step(state, x, y):
        pstate, zst, count = state
        xs = _split(torch.as_tensor(np.asarray(x), device=dev0), P("dp"),
                    mesh)
        ys = _split(torch.as_tensor(np.asarray(y), device=dev0), P("dp"),
                    mesh)
        leaves = [{k: sa.shards[i].detach().requires_grad_(True)
                   for k, sa in pstate.items()} for i in range(mesh.size)]
        losses = run_slots(mesh, forward_body,
                           [(leaves[i], xs[i], ys[i])
                            for i in range(mesh.size)])
        flat = [t for d in leaves for t in d.values()]
        total = sum(l.to(dev0) for l in losses)
        gflat = iter(torch.autograd.grad(total, flat))
        grads = [{k: next(gflat) for k in d} for d in leaves]
        count = count + 1
        outs = run_slots(mesh, update_body, [
            ({k: sa.shards[i] for k, sa in pstate.items()}, grads[i],
             {kind: {k: sa.shards[i] for k, sa in d.items()}
              for kind, d in zst.items()}, count, losses[i])
            for i in range(mesh.size)])
        new_p = {k: ShardedArray([o[0][k] for o in outs], specs[k], mesh)
                 for k in pstate}
        new_z = {kind: {k: ShardedArray([o[1][kind][k] for o in outs],
                                        zspecs[k], mesh) for k in d}
                 for kind, d in zst.items()}
        return (new_p, new_z, count), outs[0][2]

    state = ({k: place(v, specs[k]) for k, v in params.items()},
             {kind: {k: place(v, zspecs[k]) for k, v in d.items()}
              for kind, d in zstate.items()}, 0)
    return step, state
