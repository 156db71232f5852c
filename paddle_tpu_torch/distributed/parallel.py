"""Data parallelism and the sharded train step — twin of
``paddle_tpu/distributed/parallel.py``.

Reference analog: paddle.DataParallel (fluid/dygraph/parallel.py:322) backed
by the C++ Reducer (imperative/reducer.cc:587 MarkVarReady, :685
FusedAllReduceSchedule).

:func:`make_sharded_train_step` is the twin of the JAX package's pjit'd
step, and pjit computes the UNSHARDED function: the step equals the
one-device step on the global batch.  On the port's mesh
(``distributed/mesh.py``):

- the batch is split over the first data axis (``dp``);
- each slot runs a replica of the layer on its part.  A parameter whose
  ``partition_spec`` names a mesh axis (``mp``) lives as one shard per
  position on that axis, and so does its optimizer state; the replica
  computes with its shard the way Megatron-LM does — a column-parallel
  ``Linear`` (weight ``(None, "mp")``) keeps its output columns local
  where a row-parallel one (``("mp", None)``) takes them (the q/k/v and
  output projections of a ``MultiHeadAttention``, which then runs its
  ``num_heads / mp`` local heads; ``linear1`` / ``linear2`` of a
  Transformer layer), and gathers them for any other consumer; a
  row-parallel ``Linear`` adds its partial products over ``mp`` before
  its bias; an ``Embedding`` split by rows looks up the ids it holds and
  adds the slots' lookups.  Any other sharded parameter is gathered
  whole before the forward.  Every such sum or gather is a collective of
  ``distributed.lax``, so one autograd graph spans the slots;
- a batch norm in training (``BatchNorm*`` and ``SyncBatchNorm``) takes
  its statistics over every data slot's part of the batch;
- the loss is the mean over the slots of each slot's loss — for a
  mean-reduced loss, the mean over the global batch, as every slot holds
  an equal part.  One backward gives each shard its gradient; a
  replicated parameter's gradient is the sum over the slots that hold
  it, so it is averaged over ``dp`` as the one-device gradient is;
- the update is ``optimizer.fused_step`` on each shard with its own
  optimizer state.

Slots that share a device share one tensor for a parameter block they
both hold (autograd adds their gradients), and it is updated once; the
buffers (a batch norm's running statistics, updated in place by each
slot) are one copy per slot.

``DataParallel`` is the eager wrapper: transparent in one process; with
several trainer processes ``apply_collective_grads`` averages the
gradients over them through the host backend.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..jit.functional import get_state
from ..nn.layer import Layer
from ..ops._helpers import to_tensor_like
from ..ops.dispatch import apply
from ..tensor import Tensor
from . import lax
from .env import get_rank, get_world_size, init_parallel_env  # noqa: F401
from .mesh import (Mesh, PartitionSpec, ShardedArray, _block, _norm_spec,
                   _split, get_mesh, psum, run_slots)

__all__ = ["DataParallel", "make_sharded_train_step",
           "make_localsgd_train_step", "sync_params_buffers",
           "load_sharded_state"]


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.add_sublayer("_layers", layers)
        self.find_unused_parameters = find_unused_parameters
        self._group = group

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """The Reducer's job: in one process nothing; across trainer
        processes each gradient is averaged over them (host backend —
        raises when there is none)."""
        if get_world_size() <= 1:
            return
        from .collective import ReduceOp, all_reduce

        for p in self._layers.parameters():
            if p.grad is not None:
                p._value.grad = all_reduce(Tensor(p._value.grad),
                                           op=ReduceOp.AVG,
                                           group=self._group)._value


# --- specs on a mesh ---------------------------------------------------------

def _mesh_spec(spec, mesh: Mesh, ndim: int) -> tuple:
    """``spec`` restricted to the axes of ``mesh`` of size > 1: one tuple
    of axis names per dim (empty: replicated)."""
    out = []
    for axes in _norm_spec(spec, ndim):
        out.append(tuple(a for a in axes if mesh.shape.get(a, 1) > 1))
    return tuple(out)


def _as_pspec(dims: tuple) -> PartitionSpec:
    return PartitionSpec(*[(d[0] if len(d) == 1 else d) if d else None
                           for d in dims])


def _split_shared(value: torch.Tensor, dims: tuple, mesh: Mesh
                  ) -> List[torch.Tensor]:
    """Each slot's block of ``value`` (a fresh tensor), one tensor per
    (block, device): slots that hold the same block on one device share
    it."""
    pieces = _split(value.detach(), _as_pspec(dims), mesh)
    seen: Dict[tuple, torch.Tensor] = {}
    out = []
    for i, (dev, piece) in enumerate(zip(mesh.slots, pieces)):
        key = (_block_key(dims, mesh, i), str(dev))
        t = seen.get(key)
        if t is None:
            t = seen[key] = piece.clone()
        out.append(t)
    return out


def _block_key(dims: tuple, mesh: Mesh, i: int) -> tuple:
    c = mesh.coords(i)
    return tuple(_block(axes, mesh, c)[0] for axes in dims if axes)


def _gather_whole(v: torch.Tensor, dims: tuple) -> torch.Tensor:
    """Inside a body: the whole parameter from this slot's block."""
    for d, axes in enumerate(dims):
        if axes:
            v = lax.all_gather(v, axes if len(axes) > 1 else axes[0],
                               axis=d, tiled=True)
    return v


# --- the per-slot replica ------------------------------------------------------

def _col(dims):
    return len(dims) == 2 and not dims[0] and len(dims[1]) == 1


def _row(dims):
    return len(dims) == 2 and len(dims[0]) == 1 and not dims[1]


def _spec_dims(p, mesh) -> tuple:
    return _mesh_spec(getattr(p, "partition_spec", None), mesh,
                      len(p.shape))


def _tp_plan(layer: Layer, mesh: Mesh):
    """What the replica computes locally: ``{id(Linear): "col_local" |
    "col_gather" | "row"}``, ``{id(Embedding): axis}``, the attention
    layers to run on local heads ``{id(mha): axis}``, and the names of the
    parameters to gather whole before the forward."""
    from ..nn import (Embedding, Linear, MultiHeadAttention,
                      TransformerDecoderLayer, TransformerEncoderLayer)

    linears, embeds, heads = {}, {}, {}
    for sub in layer.sublayers(include_self=True):
        if isinstance(sub, MultiHeadAttention):
            qkv = [_spec_dims(p.weight, mesh)
                   for p in (sub.q_proj, sub.k_proj, sub.v_proj)]
            out = _spec_dims(sub.out_proj.weight, mesh)
            if all(_col(d) for d in qkv) and _row(out) and \
                    len({d[1] for d in qkv} | {out[0]}) == 1:
                axis = out[0][0]
                n = mesh.shape[axis]
                if sub.num_heads % n == 0:
                    heads[id(sub)] = axis
                    for p in (sub.q_proj, sub.k_proj, sub.v_proj):
                        linears[id(p)] = "col_local"
        if isinstance(sub, (TransformerEncoderLayer, TransformerDecoderLayer)):
            d1 = _spec_dims(sub.linear1.weight, mesh)
            d2 = _spec_dims(sub.linear2.weight, mesh)
            if _col(d1) and _row(d2) and d1[1] == d2[0]:
                linears[id(sub.linear1)] = "col_local"
    handled = set()
    for name, sub in layer.named_sublayers(include_self=True):
        pre = f"{name}." if name else ""
        if isinstance(sub, Linear):
            d = _spec_dims(sub.weight, mesh)
            bias_dims = (_spec_dims(sub.bias, mesh) if sub.bias is not None
                         else None)
            if _col(d) and bias_dims in (None, (d[1],)):
                linears.setdefault(id(sub), "col_gather")
            elif _row(d) and bias_dims in (None, ((),)):
                linears[id(sub)] = "row"
            else:
                linears.pop(id(sub), None)
                continue
            if any(d):
                handled.update({pre + "weight", pre + "bias"})
        elif isinstance(sub, Embedding):
            d = _spec_dims(sub.weight, mesh)
            if _row(d):
                embeds[id(sub)] = d[0][0]
                handled.add(pre + "weight")
    gather = {n for n, p in layer.named_parameters()
              if any(_spec_dims(p, mesh)) and n not in handled}
    return linears, embeds, heads, gather


def _col_forward(lin, axis, gather_out):
    from ..nn import functional as F

    def forward(x):
        out = F.linear(x, lin.weight, lin.bias)
        if gather_out:
            out = apply("c_concat", lambda v: lax.all_gather(
                v, axis, axis=v.dim() - 1, tiled=True), out)
        return out

    return forward


def _row_forward(lin, axis):
    from ..nn import functional as F

    def forward(x):
        x = to_tensor_like(x)
        k = lin.weight.shape[0]
        if x.shape[-1] != k:          # a whole input: take this slot's part
            x = apply("c_split", lambda v: v.narrow(
                v.dim() - 1, lax.axis_index(axis) * k, k), x)
        out = F.linear(x, lin.weight, None)
        out = apply("mp_allreduce_sum", lambda v: lax.psum(v, axis), out)
        return out + lin.bias if lin.bias is not None else out

    return forward


def _embed_forward(emb, axis):
    from .parallel_layers import _masked_lookup

    def forward(x):
        x = to_tensor_like(x)
        pad = emb._padding_idx

        def f(idx, w):
            k = w.shape[0]
            out = _masked_lookup(idx, w, lax.axis_index(axis) * k, k)
            out = lax.psum(out, axis)
            if pad is not None:
                out = torch.where((idx.long() == pad)[..., None],
                                  torch.zeros_like(out), out)
            return out

        return apply("parallel_embedding", f, x, emb.weight)

    return forward


def _synced_batch_norm(bn, axis):
    """A batch norm's training forward with statistics over every slot
    of ``axis`` (the global batch); running statistics updated as
    ``nn.functional.batch_norm`` updates them."""
    from ..nn.functional.norm import batch_norm

    def forward(x):
        if not bn.training or bn._use_global_stats:
            return batch_norm(x, bn._mean, bn._variance, bn.weight, bn.bias,
                              training=bn.training, momentum=bn._momentum,
                              epsilon=bn._epsilon,
                              data_format=bn._data_format,
                              use_global_stats=bn._use_global_stats,
                              act=bn._fused_act)
        x = to_tensor_like(x)
        nd = x.ndim
        ch = 1 if bn._data_format in ("NCHW", "NCL", "NCDHW", "NC") \
            else nd - 1
        axes = tuple(i for i in range(nd) if i != ch)
        shape = [1] * nd
        shape[ch] = -1
        has_w, has_b = bn.weight is not None, bn.bias is not None
        extra = ([bn.weight] if has_w else []) + ([bn.bias] if has_b else [])
        eps, relu = bn._epsilon, bn._fused_act == "relu"

        def f(v, *wb):
            vf = v.float()
            count = (vf.numel() // vf.shape[ch]) * lax.axis_size(axis)
            mean = lax.psum(vf.sum(dim=axes), axis) / count
            d = vf - mean.reshape(shape)
            var = lax.psum((d * d).sum(dim=axes), axis) / count
            out = d * torch.rsqrt(var + eps).reshape(shape)
            if has_w:
                out = out * wb[0].float().reshape(shape)
            if has_b:
                out = out + wb[-1].float().reshape(shape)
            if relu:
                out = torch.clamp_min(out, 0)
            return out.to(v.dtype), mean, var

        out, m, var = apply("batch_norm", f, x, *extra)
        with torch.no_grad():
            for stat, batch in ((bn._mean._value, m._value),
                                (bn._variance._value, var._value)):
                stat.mul_(bn._momentum).add_(
                    batch.to(stat.dtype) * (1 - bn._momentum))
        return out

    return forward


def _make_replica(layer: Layer, mesh: Mesh, data_axis: Optional[str]):
    """A copy of ``layer`` whose forward computes with one slot's shards
    (the module docstring): the Megatron-style forwards, local heads, and
    batch norms over the data axis."""
    from ..nn.norm_layers import _BatchNormBase

    linears, embeds, heads, gather = _tp_plan(layer, mesh)
    rep = copy.deepcopy(layer)
    orig = dict(zip((id(s) for s in layer.sublayers(include_self=True)),
                    rep.sublayers(include_self=True)))
    for key, mode in linears.items():
        lin = orig[key]
        d = _spec_dims(lin.weight, mesh)
        if mode == "row":
            object.__setattr__(lin, "forward", _row_forward(lin, d[0][0]))
        elif any(d):
            object.__setattr__(lin, "forward", _col_forward(
                lin, d[1][0], gather_out=(mode == "col_gather")))
    for key, axis in embeds.items():
        emb = orig[key]
        object.__setattr__(emb, "forward", _embed_forward(emb, axis))
    for key, axis in heads.items():
        mha = orig[key]
        n = mesh.shape[axis]
        mha.num_heads //= n
        mha.embed_dim //= n
    if data_axis is not None and mesh.shape.get(data_axis, 1) > 1:
        for sub in rep.sublayers(include_self=True):
            if isinstance(sub, _BatchNormBase):
                object.__setattr__(sub, "forward",
                                   _synced_batch_norm(sub, data_axis))
    return rep, gather


# --- the sharded state ---------------------------------------------------------

def _carry(old: Dict[str, ShardedArray], new,
           shared: bool = True) -> Dict[str, ShardedArray]:
    """``old`` with each array of ``new`` (numpy or torch, by name) split
    over its slots as ``old`` lays that name out — one tensor per block
    and device (``shared``), or one per slot (the buffers, which each
    slot updates in place)."""
    out = dict(old)
    for name, arr in (new or {}).items():
        if name not in old:
            raise KeyError(f"the sharded state holds no {name!r}")
        ref = old[name]
        t = (arr if isinstance(arr, torch.Tensor)
             else torch.from_numpy(np.array(arr))).to(ref.dtype)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} but the state "
                             f"holds {ref.shape}")
        dims = _norm_spec(ref.spec, len(ref.shape))
        shards = (_split_shared(t, dims, ref.mesh) if shared else
                  [x.clone() for x in _split(t, ref.spec, ref.mesh)])
        out[name] = ShardedArray(shards, ref.spec, ref.mesh)
    return out


def load_sharded_state(state, params=None, buffers=None, opt=None,
                       step=None):
    """A sharded step's state with weights carried in from arrays (numpy
    or torch, by the JAX package's ``get_state`` names — its own
    state's arrays, say), each split over its slots as ``state`` lays it
    out; a name ``state`` does not hold is an error.

    ``state`` is ``make_sharded_train_step``'s ``{'params', 'buffers',
    'opt', 'step'}`` (``opt``: ``{kind: {name: array}}``) or
    ``make_hybrid_step``'s ``(params, zstate, count)`` (``opt``: the
    ZeRO moments ``{'m' | 'v': {name: array}}``); ``step`` sets the
    update count."""
    opt = opt or {}
    if isinstance(state, tuple):
        p, z, count = state
        return (_carry(p, params), {k: _carry(z[k], opt.get(k)) for k in z},
                count if step is None else int(step))
    new = dict(state)
    new["params"] = _carry(state["params"], params)
    new["buffers"] = _carry(state["buffers"], buffers, shared=False)
    new["opt"] = {k: _carry(state["opt"][k], opt.get(k))
                  for k in state["opt"]}
    if step is not None:
        new["step"] = int(step)
    return new


def _unique(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    seen, out = set(), []
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def make_sharded_train_step(layer: Layer, loss_fn: Callable, optimizer,
                            mesh: Optional[Mesh] = None, data_axes=("dp",),
                            donate=True):
    """Build the sharded train step (the module docstring).

    Returns ``(step_fn, state)`` where ``state = {'params', 'buffers',
    'opt', 'step'}``: ``params`` / ``buffers`` map each name to a
    :class:`~.mesh.ShardedArray`, ``opt`` each accumulator kind to such
    a map, ``step`` the update count.  ``step_fn(state, x, y, key=None)
    -> (state, loss)``: ``x`` / ``y`` are the global batch (split over
    ``data_axes[0]``; ``x`` may be a tuple of the layer's inputs, each
    split so), ``loss`` the global mean loss (a 0-d tensor);
    ``key`` is accepted for the JAX signature (each slot draws from its
    own generator).  ``donate`` is accepted and ignored."""
    mesh = mesh or get_mesh()
    data_axis = data_axes[0] if data_axes else None
    if data_axis is not None and data_axis not in mesh.shape:
        data_axis = None
    params, buffers = get_state(layer)
    param_objs = dict(layer.named_parameters())
    dims = {n: _spec_dims(param_objs[n], mesh) for n in params}
    sharded = any(any(d) for d in dims.values())
    if sharded and getattr(optimizer, "_grad_clip", None) is not None:
        from ..framework.errors import InvalidArgumentError

        raise InvalidArgumentError(
            "make_sharded_train_step: a gradient clip with parameters "
            "sharded over the mesh is not supported (each shard would be "
            "clipped by its own norm)")

    replicas, gathers = [], None
    for _ in mesh.slots:
        rep, gather = _make_replica(layer, mesh, data_axis)
        replicas.append(rep)
        gathers = gather
    rep_params = [dict(r.named_parameters()) for r in replicas]
    rep_buffers = [dict(r.named_buffers()) for r in replicas]

    def lay(values: Dict[str, torch.Tensor], layout) -> Dict[str,
                                                              ShardedArray]:
        return {n: ShardedArray(_split_shared(v, layout(n), mesh),
                                _as_pspec(layout(n)), mesh)
                for n, v in values.items()}

    state = {
        "params": lay(params, dims.__getitem__),
        "buffers": {n: ShardedArray(
            [v.detach().to(dev).clone() for dev in mesh.slots],
            PartitionSpec(), mesh) for n, v in buffers.items()},
        "step": 0,
    }
    state["opt"] = _init_opt(optimizer, state["params"], mesh)
    data_spec = PartitionSpec(data_axis) if data_axis else PartitionSpec()

    def body(i, x_i, y_i, leaves, bufs):
        rep = replicas[i]
        for n, pobj in rep_params[i].items():
            v = leaves[n]
            pobj._value = _gather_whole(v, dims[n]) if n in gathers else v
        for n, bobj in rep_buffers[i].items():
            bobj._value = bufs[n]
        rep.train()
        out = rep(*[None if a is None else Tensor(a) for a in x_i])
        loss = loss_fn(out, Tensor(y_i))
        return to_tensor_like(loss)._value.float()

    def run(state, x, y, key=None):
        inputs = x if isinstance(x, (tuple, list)) else (x,)
        xs = list(zip(*[[None] * mesh.size if a is None else
                        _split(_input(a, mesh), data_spec, mesh)
                        for a in inputs]))
        ys = _split(_input(y, mesh), data_spec, mesh)
        all_leaves = _unique([t for sa in state["params"].values()
                              for t in sa.shards])
        for t in all_leaves:
            t.requires_grad_(True)
        per_slot = [(i, xs[i], ys[i],
                     {n: sa.shards[i] for n, sa in state["params"].items()},
                     {n: sa.shards[i] for n, sa in state["buffers"].items()})
                    for i in range(mesh.size)]
        try:
            losses = run_slots(mesh, body, per_slot)
            dev0 = mesh.slots[0]
            total = torch.stack([l.to(dev0) for l in losses]).mean()
            grads = torch.autograd.grad(total, all_leaves, allow_unused=True)
        finally:
            for t in all_leaves:
                t.requires_grad_(False)
        grad_of = {id(t): g for t, g in zip(all_leaves, grads)}
        params = state["params"]
        # a block's gradient: the sum over the devices that hold it
        for n, sa in params.items():
            by_block: Dict[tuple, list] = {}
            for i, t in enumerate(sa.shards):
                held = by_block.setdefault(_block_key(dims[n], mesh, i), [])
                if all(t is not u for u in held):
                    held.append(t)
            for held in by_block.values():
                gs = [grad_of[id(t)] for t in held]
                if len(held) > 1 and all(g is not None for g in gs):
                    for t, g in zip(held, psum(gs)):
                        grad_of[id(t)] = g
        # one update per distinct tensor, with its own optimizer state
        count = state["step"] + 1
        new_of: Dict[int, tuple] = {}
        for i in range(mesh.size):
            names = [n for n, sa in params.items()
                     if id(sa.shards[i]) not in new_of]
            if not names:
                continue
            old = {n: params[n].shards[i] for n in names}
            new_p, new_o = optimizer.fused_step(
                {n: t.detach() for n, t in old.items()},
                {n: grad_of[id(t)] for n, t in old.items()},
                {k: {n: state["opt"][k][n].shards[i] for n in names}
                 for k in state["opt"]}, count)
            for n, t in old.items():
                new_of[id(t)] = (new_p[n], {k: new_o[k][n] for k in new_o})
        new_state = {
            "params": {n: ShardedArray([new_of[id(t)][0] for t in sa.shards],
                                       sa.spec, mesh)
                       for n, sa in params.items()},
            "buffers": state["buffers"],
            "opt": {k: {n: ShardedArray([new_of[id(t)][1][k]
                                         for t in sa.shards], sa.spec, mesh)
                        for n, sa in params.items()} for k in state["opt"]},
            "step": count,
        }
        return new_state, total.detach()

    return run, state


def _init_opt(optimizer, params: Dict[str, ShardedArray], mesh: Mesh):
    """``{kind: {name: ShardedArray}}``: each parameter block's optimizer
    state, shared where the block is (one per block and device)."""
    out: Dict[str, Dict[str, ShardedArray]] = {}
    made: Dict[int, dict] = {}
    for n, sa in params.items():
        per_slot = []
        for t in sa.shards:
            acc = made.get(id(t))
            if acc is None:
                acc = made[id(t)] = optimizer.init_opt_state({n: t})
            per_slot.append(acc)
        for kind in per_slot[0]:
            out.setdefault(kind, {})[n] = ShardedArray(
                [a[kind][n] for a in per_slot], sa.spec, mesh)
    return out


def _input(x, mesh: Mesh) -> torch.Tensor:
    from .mesh import _as_tensor

    t = _as_tensor(x, mesh.slots[0])
    if t.dtype == torch.int32:
        t = t.long()
    return t


def make_localsgd_train_step(layer: Layer, loss_fn: Callable, optimizer,
                             k_steps: int, mesh: Optional[Mesh] = None,
                             axis: str = "dp", begin_step: int = 1):
    """LocalSGD step (reference localsgd_optimizer.py semantics): every
    replica along ``axis`` holds its OWN parameter and optimizer-state
    copy and takes purely local steps (no gradient collective); every
    ``k_steps``-th step past ``begin_step``, parameters and optimizer
    state are averaged across the axis.

    Returns ``(step_fn, state)``; ``step_fn(state, x, y) -> (state,
    mean_loss)``.  ``x`` / ``y`` are global batches split over ``axis``;
    ``state['params'][name]`` stacks the replicas' copies along a leading
    dim of size ``n``."""
    mesh = mesh or get_mesh()
    n = mesh.shape[axis]
    if mesh.size != n:
        raise ValueError(f"make_localsgd_train_step runs on a mesh of the "
                         f"one axis {axis!r}, got {mesh.shape}")
    params0, buffers0 = get_state(layer)
    replicas = [copy.deepcopy(layer) for _ in mesh.slots]
    rep_params = [dict(r.named_parameters()) for r in replicas]
    rep_buffers = [dict(r.named_buffers()) for r in replicas]

    def stack(values):
        return {name: ShardedArray([v.detach()[None].to(dev).clone()
                                    for dev in mesh.slots],
                                   PartitionSpec(axis), mesh)
                for name, v in values.items()}

    opt0 = optimizer.init_opt_state({k: v.detach()
                                     for k, v in params0.items()})
    state = {"params": stack(params0), "buffers": stack(buffers0),
             "opt": {k: stack(d) for k, d in opt0.items()}, "step": 0}
    spec = PartitionSpec(axis)

    def body(i, x_i, y_i, leaves, bufs):
        for name, pobj in rep_params[i].items():
            pobj._value = leaves[name]
        for name, bobj in rep_buffers[i].items():
            bobj._value = bufs[name]
        replicas[i].train()
        loss = loss_fn(replicas[i](Tensor(x_i)), Tensor(y_i))
        return to_tensor_like(loss)._value.float()

    def run(state, x, y, key=None):
        xs = _split(_input(x, mesh), spec, mesh)
        ys = _split(_input(y, mesh), spec, mesh)
        leaves = [{k: sa.shards[i][0].detach().requires_grad_(True)
                   for k, sa in state["params"].items()}
                  for i in range(n)]
        bufs = [{k: sa.shards[i][0] for k, sa in state["buffers"].items()}
                for i in range(n)]
        losses = run_slots(mesh, body, [(i, xs[i], ys[i], leaves[i], bufs[i])
                                        for i in range(n)])
        flat = [t for d in leaves for t in d.values()]
        grads = iter(torch.autograd.grad(sum(l.to(losses[0].device)
                                             for l in losses), flat,
                                         allow_unused=True))
        count = state["step"] + 1
        new_p, new_o = [], []
        for i in range(n):
            g = {k: next(grads) for k in leaves[i]}
            ps = {k: v.detach() for k, v in leaves[i].items()}
            os_ = {kind: {k: sa.shards[i][0] for k, sa in d.items()}
                   for kind, d in state["opt"].items()}
            p1, o1 = optimizer.fused_step(ps, g, os_, count)
            new_p.append(p1)
            new_o.append(o1)
        if count >= begin_step and count % k_steps == 0:
            for k in new_p[0]:
                if new_p[0][k].is_floating_point():
                    avg = [t / n for t in psum([p[k] for p in new_p])]
                    for p, a in zip(new_p, avg):
                        p[k] = a
            for kind in new_o[0]:
                for k in new_o[0][kind]:
                    if new_o[0][kind][k].is_floating_point():
                        avg = [t / n for t in psum([o[kind][k]
                                                    for o in new_o])]
                        for o, a in zip(new_o, avg):
                            o[kind][k] = a
        new_state = {
            "params": {k: ShardedArray([p[k][None] for p in new_p], spec,
                                       mesh) for k in new_p[0]},
            "buffers": {k: ShardedArray([b[k][None] for b in bufs], spec,
                                        mesh) for k in bufs[0]},
            "opt": {kind: {k: ShardedArray([o[kind][k][None]
                                            for o in new_o], spec, mesh)
                           for k in new_o[0][kind]} for kind in new_o[0]},
            "step": count,
        }
        mean = torch.stack([l.detach().to(losses[0].device)
                            for l in losses]).mean()
        return new_state, mean

    return run, state


def sync_params_buffers(model, comm_group=None, src_rank=0,
                        is_model_parallel=False):
    """Broadcast-parameters analog (parallel.py sync_params_buffers):
    across trainer processes every parameter and buffer takes
    ``src_rank``'s value (host backend); in one process the copies are
    already the same, so nothing moves."""
    if get_world_size() <= 1:
        return
    from .collective import broadcast

    with torch.no_grad():
        for _, p in list(model.named_parameters()) + \
                list(model.named_buffers()):
            got = broadcast(Tensor(p._value.detach().clone()), src=src_rank,
                            group=comm_group)
            p._value.copy_(got._value)
