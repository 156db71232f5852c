"""Pipeline parallelism over the 'pp' mesh axis — twin of
``paddle_tpu/distributed/pipeline.py``.

Reference analog: PipelineOptimizer (fluid/optimizer.py:3718 — program cut by
device_guard into stage sub-programs, send_v2/recv_v2 p2p, micro-batch loop in
SectionWorker, F-then-B and 1F1B schedules; fleet
meta_optimizers/pipeline_optimizer.py:25).

Every slot runs the same body under :func:`~.mesh.shard_map` over 'pp';
each holds its stage's parameters; microbatches stream through the ring,
one ``lax.ppermute`` a tick, over fill + steady + drain ticks.  The
activations move between slots with ``.to(slot)`` inside the permute: a
copy on one card, a peer copy across cards.

- :func:`pipeline_apply` is the forward pipeline; its backward is
  autograd over the ticks (the F-then-B order).  ``schedule="remat"``
  recomputes each stage in the backward (``torch.utils.checkpoint``),
  which must then hold no collective: the recompute runs in the autograd
  engine, outside the body; ``"f-then-b"`` keeps every activation.
- :func:`pipeline_train_1f1b` is the interleaved 1F1B schedule, with its
  static issue tables (:func:`build_1f1b_schedule`, host code): each
  microbatch's backward is ``torch.autograd.grad`` of the stage
  recomputed at its stashed input, so a stage keeps at most ``n_stages``
  inputs in flight.  Its stage function holds no collective over the
  pipeline axis.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from . import lax
from .mesh import PartitionSpec, shard_map, tree_leaves, tree_map

__all__ = ["pipeline_apply", "pipeline_forward", "stack_stage_params",
           "build_1f1b_schedule", "schedule_peak_in_flight",
           "pipeline_train_1f1b", "pipeline_train_step"]


def _checkpointed(fn):
    from torch.utils.checkpoint import checkpoint

    def run(params, x):
        leaves = tree_leaves(params)
        return checkpoint(lambda x_, *ls: fn(_rebuild(params, ls), x_), x,
                          *leaves, use_reentrant=False)

    return run


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def pipeline_apply(stage_fn: Callable, stage_params, x_microbatches,
                   axis_name: str = "pp", remat: bool = None,
                   head_fn: Callable = None, head_params=None,
                   tail_fn: Callable = None, tail_params=None,
                   schedule: str = "remat"):
    """Run microbatches through the pipeline inside a shard_map body.

    stage_fn(params, x) -> y : one stage's computation (same code every
      stage); must preserve the activation shape (the carried type).
    stage_params: this slot's stage parameters (pytree).
    x_microbatches: [M, mb, ...] microbatches, valid on EVERY slot;
      stage 0 consumes them in order.
    head_fn(head_params, x_mb) -> activation: OPTIONAL shape/dtype-changing
      ingest applied on stage 0 as each microbatch enters the pipe.
    tail_fn(tail_params, activation) -> out: OPTIONAL final projection
      applied on the last stage as each microbatch finishes.
    schedule: 'remat' (default) recomputes each stage in the backward
      (module docstring), 'f-then-b' keeps every intermediate.  The
      interleaved 1F1B order is :func:`pipeline_train_1f1b`'s.
    Returns [M, mb, ...] outputs (valid on the last stage; zeros
    elsewhere).
    """
    if schedule == "1f1b":
        raise ValueError(
            "schedule='1f1b' interleaves forward AND backward per "
            "microbatch; a forward-only pipeline cannot express it. Use "
            "pipeline_train_1f1b (inside shard_map) or "
            "pipeline_train_step (whole-array) for the real interleaved "
            "schedule, or schedule='remat' for 1F1B-class memory.")
    if schedule not in ("remat", "f-then-b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    want_remat = schedule == "remat"
    if remat is None:
        remat = want_remat
    elif remat != want_remat:
        raise ValueError(
            f"remat={remat} contradicts schedule={schedule!r} "
            "(remat = rematerialized, f-then-b = full stash); pass only "
            "schedule=")
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    M = x_microbatches.shape[0]
    fn = _checkpointed(stage_fn) if remat else stage_fn
    hfn = head_fn
    if hfn is not None and remat:
        hfn = _checkpointed(head_fn)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def ingest(t):
        feed = x_microbatches[min(max(t, 0), M - 1)]
        return hfn(head_params, feed) if hfn is not None else feed

    cur = None
    outs: List = [None] * M
    for t in range(M + n - 1):
        # stage 0 ingests microbatch t; the others use the activation
        # that arrived from the previous stage
        if idx == 0:
            cur = ingest(t)
        elif cur is None:
            cur = torch.zeros_like(ingest(0))
        y = fn(stage_params, cur)
        if y.shape != cur.shape or y.dtype != cur.dtype:
            raise ValueError(
                "pipeline stage_fn must preserve the carried activation "
                f"type (got {tuple(cur.shape)}/{cur.dtype} -> "
                f"{tuple(y.shape)}/{y.dtype}); move shape-changing layers "
                "into head_fn / tail_fn")
        out_t = t - (n - 1)
        if idx == n - 1 and out_t >= 0:
            outs[out_t] = tail_fn(tail_params, y) if tail_fn is not None \
                else y
        cur = lax.ppermute(y, axis_name, perm)
    if idx != n - 1:
        probe = tail_fn(tail_params, cur) if tail_fn is not None else cur
        outs = [torch.zeros_like(probe)] * M
    return torch.stack(outs, dim=0)


def _squeeze0(tree):
    return tree_map(lambda p: p.squeeze(0), tree)


def pipeline_forward(mesh, stage_fn, params_by_stage, x, micro_batch_size,
                     axis_name: str = "pp", remat: bool = None,
                     head_fn=None, head_params=None,
                     tail_fn=None, tail_params=None, schedule: str = "remat"):
    """Whole-array entry: params_by_stage is a pytree whose leaves have a
    leading stage dimension (sharded over 'pp'); x is the global batch
    (replicated); head/tail params are replicated.  Returns final-stage
    outputs for the full batch (head/tail may change shape and dtype)."""
    B = x.shape[0]
    M = B // micro_batch_size
    xm = x.reshape((M, micro_batch_size) + tuple(x.shape[1:]))

    def inner(params_local, xm_local, head_p, tail_p):
        outs = pipeline_apply(stage_fn, _squeeze0(params_local), xm_local,
                              axis_name=axis_name, remat=remat,
                              head_fn=head_fn, head_params=head_p,
                              tail_fn=tail_fn, tail_params=tail_p,
                              schedule=schedule)
        # the last stage's outputs on every stage (replicated out_specs)
        n = lax.axis_size(axis_name)
        mask = 1.0 if lax.axis_index(axis_name) == n - 1 else 0.0
        return lax.psum(outs * mask, axis_name)

    fn = shard_map(inner, mesh=mesh,
                   in_specs=(PartitionSpec(axis_name), PartitionSpec(),
                             PartitionSpec(), PartitionSpec()),
                   out_specs=PartitionSpec())
    outs = fn(params_by_stage, xm, head_params, tail_params)
    return outs.reshape((B,) + tuple(outs.shape[2:]))


def stack_stage_params(per_stage_params: List):
    """Stack a list of per-stage parameter pytrees along a new leading
    axis (to be sharded over 'pp')."""
    first = per_stage_params[0]
    leaves = [tree_leaves(p) for p in per_stage_params]
    stacked = [torch.stack([torch.as_tensor(ls[j]) for ls in leaves], dim=0)
               for j in range(len(leaves[0]))]
    return _rebuild(first, stacked)


# ---------------------------------------------------------------------------
# True interleaved 1F1B (reference section_worker.cc:98-129 issue order;
# program transform fluid/optimizer.py:4324,4351)
# ---------------------------------------------------------------------------

def build_1f1b_schedule(n_microbatches: int, n_stages: int):
    """Static 1F1B issue tables (the reference's SectionWorker also runs
    a FIXED schedule per config).

    One tick = one forward slot + one backward slot per stage (they are
    different microbatches in steady state).  Constraints:
    - activations travel one stage per tick, grads likewise;
    - the last stage runs B(j) in the same tick as F(j);
    - stage s keeps at most (n_stages - s) microbatches in flight — the
      1F1B memory bound (warmup), vs M for full-stash F-then-B.

    Returns (f_tab, b_tab) int32 arrays [T, n_stages]: the microbatch
    forwarded/backwarded by each stage at each tick, -1 = idle slot.
    """
    M, n = n_microbatches, n_stages
    next_f = [0] * n
    next_b = [0] * n
    f_time = [[-1] * n for _ in range(M)]
    b_time = [[-1] * n for _ in range(M)]
    f_rows, b_rows = [], []
    t = 0
    while min(next_b) < M:
        ft = [-1] * n
        bt = [-1] * n
        for s in range(n):
            i = next_f[s]
            if i < M:
                avail = s == 0 or (0 <= f_time[i][s - 1] < t)
                in_flight = next_f[s] - next_b[s]
                if avail and in_flight < n - s:
                    ft[s] = i
                    f_time[i][s] = t
                    next_f[s] += 1
        for s in range(n):  # B issues after F within a tick
            j = next_b[s]
            if j < M and j < next_f[s]:
                avail = (f_time[j][s] <= t if s == n - 1
                         else 0 <= b_time[j][s + 1] < t)
                if avail:
                    bt[s] = j
                    b_time[j][s] = t
                    next_b[s] += 1
        f_rows.append(ft)
        b_rows.append(bt)
        t += 1
        if t > 4 * (M + n) + 8:
            raise RuntimeError("1f1b schedule did not converge")
    return (np.asarray(f_rows, np.int32), np.asarray(b_rows, np.int32))


def schedule_peak_in_flight(f_tab, b_tab) -> int:
    """Max microbatches stashed on any stage at any tick — the measured
    peak live-activation count of the schedule (must be <= n_stages; a
    full-stash F-then-B schedule peaks at M)."""
    n = f_tab.shape[1]
    live = [0] * n
    peak = 0
    for ft, bt in zip(f_tab, b_tab):
        for s in range(n):
            if ft[s] >= 0:
                live[s] += 1
        peak = max(peak, max(live))
        for s in range(n):
            if bt[s] >= 0:
                live[s] -= 1
    return peak


def _accumulate(acc_tree, grads):
    """``acc_tree`` plus the leaf gradients ``grads`` (None adds
    nothing)."""
    it = iter(grads)

    def add(acc):
        g = next(it)
        return acc if g is None else acc + g

    return tree_map(add, acc_tree)


def _grad_leaves(tree):
    """``tree`` detached, every leaf requiring grad (a fresh graph)."""
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def pipeline_train_1f1b(stage_fn, stage_params, x_microbatches,
                        y_microbatches, loss_fn, head_fn=None,
                        head_params=None, axis_name: str = "pp"):
    """One interleaved-1F1B training step, called INSIDE a shard_map body.

    Every tick each stage (maybe) forwards one microbatch and (maybe)
    backwards another, per the static issue tables; activations flow
    s->s+1 and cotangents s+1->s by ``lax.ppermute``.  The backward of a
    microbatch recomputes the stage at its stashed INPUT and takes
    ``torch.autograd.grad`` of it, so the stash holds at most n_stages
    activations per stage.

    stage_fn(params, x) -> y        shape/dtype-preserving stage
    head_fn(head_params, x_mb) -> a optional ingest on stage 0
    loss_fn(y, y_mb) -> scalar      final projection + loss on the last
                                    stage (fold tail layers in here)
    Returns (loss_sum, stage_param_grads, head_param_grads); divide by M
    for mean-loss semantics.  Reference: section_worker.cc:98,115,129.
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    M = x_microbatches.shape[0]
    f_tab, b_tab = build_1f1b_schedule(M, n)
    T = f_tab.shape[0]
    # arrival tables: what lands on me this tick (sent by my neighbour in
    # the PREVIOUS tick) — static, so no metadata rides the wire
    ra = np.full_like(f_tab, -1)
    ra[1:, 1:] = f_tab[:-1, :-1]
    rg = np.full_like(b_tab, -1)
    rg[1:, :-1] = b_tab[:-1, 1:]
    perm_fwd = [(i, (i + 1) % n) for i in range(n)]
    perm_bwd = [(i, (i - 1) % n) for i in range(n)]

    def ingest(mb):
        feed = x_microbatches[mb]
        return head_fn(head_params, feed) if head_fn is not None else feed

    with torch.no_grad():
        probe = ingest(0)
    act_shape, act_dtype = probe.shape, probe.dtype
    zeros = torch.zeros(act_shape, dtype=act_dtype, device=probe.device)
    act_in, grad_in, stash = {}, {}, {}
    act_recv = grad_recv = zeros
    g_stage = tree_map(torch.zeros_like, stage_params)
    g_head = (tree_map(torch.zeros_like, head_params)
              if head_params is not None else None)
    loss_sum = torch.zeros((), dtype=torch.float32, device=probe.device)

    for t in range(T):
        fm, bm = int(f_tab[t, idx]), int(b_tab[t, idx])
        if ra[t, idx] >= 0:
            act_in[int(ra[t, idx])] = act_recv
        if rg[t, idx] >= 0:
            grad_in[int(rg[t, idx])] = grad_recv
        # ---- forward slot ----
        y_send = zeros
        if fm >= 0:
            with torch.no_grad():
                x_f = ingest(fm) if idx == 0 else act_in.pop(fm)
                y_send = stage_fn(stage_params, x_f)
                if y_send.shape != act_shape or y_send.dtype != act_dtype:
                    raise ValueError(
                        "pipeline stage_fn must preserve the carried "
                        f"activation type (got {tuple(act_shape)}/"
                        f"{act_dtype} -> {tuple(y_send.shape)}/"
                        f"{y_send.dtype}); move shape-changing layers "
                        "into head_fn / loss_fn")
            stash[fm] = x_f
        # ---- backward slot ----
        g_send = zeros
        if bm >= 0:
            params_g = _grad_leaves(stage_params)
            x_b = stash.pop(bm).detach().requires_grad_(True)
            with torch.enable_grad():
                y_b = stage_fn(params_g, x_b)
                ins = tree_leaves(params_g) + [x_b]
                if idx == n - 1:
                    loss_j = loss_fn(y_b, y_microbatches[bm])
                    grads = torch.autograd.grad(loss_j, ins,
                                                allow_unused=True)
                    loss_sum = loss_sum + loss_j.detach().float()
                else:
                    grads = torch.autograd.grad(
                        y_b, ins, grad_outputs=grad_in.pop(bm),
                        allow_unused=True)
            g_stage = _accumulate(g_stage, grads[:-1])
            g_send = grads[-1] if grads[-1] is not None else zeros
            if head_fn is not None and idx == 0:
                hp = _grad_leaves(head_params)
                with torch.enable_grad():
                    a = head_fn(hp, x_microbatches[bm])
                    gh = torch.autograd.grad(a, tree_leaves(hp),
                                             grad_outputs=g_send,
                                             allow_unused=True)
                g_head = _accumulate(g_head, gh)
        # ---- p2p for the next tick ----
        act_recv = lax.ppermute(y_send, axis_name, perm_fwd)
        grad_recv = lax.ppermute(g_send, axis_name, perm_bwd)
    return loss_sum, g_stage, g_head


def pipeline_train_step(mesh, stage_fn, params_by_stage, x, y,
                        micro_batch_size, loss_fn, head_fn=None,
                        head_params=None, axis_name: str = "pp"):
    """Whole-array interleaved-1F1B step (reference PipelineOptimizer
    minimize + SectionWorker run): shards stage params over `axis_name`,
    runs the 1F1B schedule, and returns (mean_loss, stage_grads_by_stage,
    head_grads) — grads stacked/replicated to match the inputs."""
    B = x.shape[0]
    M = B // micro_batch_size
    xm = x.reshape((M, micro_batch_size) + tuple(x.shape[1:]))
    ym = y.reshape((M, micro_batch_size) + tuple(y.shape[1:]))
    n = mesh.shape[axis_name]

    def inner(params_local, xm_, ym_, head_p):
        loss_sum, g_stage, g_head = pipeline_train_1f1b(
            stage_fn, _squeeze0(params_local), xm_, ym_, loss_fn,
            head_fn=head_fn, head_params=head_p, axis_name=axis_name)
        last = lax.axis_index(axis_name) == n - 1
        first = lax.axis_index(axis_name) == 0
        loss = lax.psum(loss_sum if last else torch.zeros_like(loss_sum),
                        axis_name) / M
        g_stage = tree_map(lambda g: (g / M)[None], g_stage)
        if g_head is not None:
            g_head = tree_map(lambda g: lax.psum(
                g if first else torch.zeros_like(g), axis_name) / M, g_head)
        return loss, g_stage, g_head

    fn = shard_map(inner, mesh=mesh,
                   in_specs=(PartitionSpec(axis_name), PartitionSpec(),
                             PartitionSpec(), PartitionSpec()),
                   out_specs=(PartitionSpec(), PartitionSpec(axis_name),
                              PartitionSpec()))
    return fn(params_by_stage, xm, ym, head_params)
