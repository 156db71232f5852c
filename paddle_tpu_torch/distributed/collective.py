"""Collective communication API — twin of
``paddle_tpu/distributed/collective.py``.

Reference analog: python/paddle/distributed/collective.py (all_reduce :365,
new_group :163, broadcast/scatter/all_gather/…) over the C++ collective ops
(operators/collective/: c_allreduce_sum, c_broadcast, c_allgather,
c_reducescatter, send_v2/recv_v2) and NCCL rings.

A Group is a named mesh axis (ring_id ↔ axis name).  Each entry has two
paths:

- inside a :func:`~.mesh.shard_map` body it is the collective of
  ``distributed.lax`` over the group's axis — differentiable, every slot
  of the run taking part (the twin of the JAX package's traced path);
- called eagerly it goes through the host backend of
  ``distributed/gloo.py`` between trainer processes, and is the identity
  in a world of one.  With more than one trainer and no backend it
  raises: it never skips the synchronisation.

Each entry runs inside a ``RecordEvent("dist/<name>")`` span.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..ops._helpers import to_tensor_like
from ..ops.dispatch import apply
from ..tensor import Tensor
from . import lax
from .env import get_rank, get_world_size
from .mesh import in_shard_map, mesh_axis_size

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "is_initialized",
           "all_reduce", "reduce", "all_gather", "all_gather_object",
           "broadcast", "reduce_scatter", "scatter", "alltoall", "send",
           "recv", "p2p_shift", "barrier", "wait", "split"]


def _traced_span(fn):
    """Profiler span around each collective entry."""
    name = f"dist/{fn.__name__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from ..utils.profiler import RecordEvent

        with RecordEvent(name):
            return fn(*args, **kwargs)

    return wrapper


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


class Group:
    """A communication group = a mesh axis (ring_id analog), optionally
    restricted to a subset of its ranks.

    Subgroup semantics (reference collective.py:163 — new_group = its own
    ring): a collective over a subgroup is ONE full-axis collective with
    a member mask — members contribute their value, outsiders the
    identity element, and outsiders keep their own value afterwards."""

    _next_id = 0

    def __init__(self, ranks=None, axis_name: str = "dp",
                 id: Optional[int] = None):
        if id is None:
            Group._next_id += 1
            id = Group._next_id
        self.id = id
        self.axis_name = axis_name
        self._ranks = sorted(ranks) if ranks is not None else None

    @property
    def nranks(self):
        if self._ranks is not None:
            return len(self._ranks)
        return mesh_axis_size(self.axis_name) * max(get_world_size(), 1)

    @property
    def ranks(self):
        return self._ranks if self._ranks is not None \
            else list(range(self.nranks))

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    @property
    def world_size(self):
        return self.nranks

    def member_mask(self) -> Optional[bool]:
        """Inside a body: is this slot's axis position a member?"""
        if self._ranks is None:
            return None
        return lax.axis_index(self.axis_name) in self._ranks

    def group_local_index(self) -> int:
        """Inside a body: this member's position within the sorted ranks
        (meaningless for outsiders, but in range, as a dynamic slice
        clamps it)."""
        pos = int(np.searchsorted(np.asarray(self.ranks),
                                  lax.axis_index(self.axis_name)))
        return min(pos, len(self.ranks) - 1)

    def __repr__(self):
        return (f"Group(id={self.id}, axis={self.axis_name!r}, "
                f"nranks={self.nranks})")


_default_group = Group(axis_name="dp", id=0)
_groups = {0: _default_group}


def _get_default_group():
    return _default_group


def new_group(ranks=None, backend=None, axis_name=None):
    g = Group(ranks=ranks, axis_name=axis_name or "dp")
    _groups[g.id] = g
    return g


def get_group(gid=0):
    return _groups.get(gid, _default_group)


def is_initialized():
    return True


_EAGER_OP_NAMES = {ReduceOp.SUM: "sum", ReduceOp.MAX: "max",
                   ReduceOp.MIN: "min", ReduceOp.PROD: "prod",
                   ReduceOp.AVG: "avg"}


def _eager_backend(group: "Group"):
    """Host-side (gloo) backend for eager multi-process collectives.

    None in a world of one (eager collectives are identities there, as
    in the reference for nranks=1).  In a real multi-process run the
    backend must exist — an identity would silently train without
    synchronization — so this raises instead."""
    if get_world_size() <= 1:
        return None
    from . import gloo

    be = gloo.get_backend()
    if be is None:
        raise RuntimeError(
            "eager collective with PADDLE_TRAINERS_NUM > 1 but no host "
            "backend: call paddle_tpu_torch.distributed.init_parallel_env() "
            "(with PADDLE_GLOO_ENDPOINT set) or distributed.gloo.init_gloo() "
            "first — otherwise cross-process synchronization would be "
            "silently skipped")
    return be


def _eager_member(group: "Group") -> bool:
    return group._ranks is None or get_rank() in group._ranks


def _eager_members(group: "Group") -> list:
    """Participants of an eager (host-side) collective, in PROCESS-rank
    space (``group.ranks`` counts mesh positions, right inside a body and
    wrong for the gloo backend, which coordinates processes)."""
    if group._ranks is not None:
        return sorted(group._ranks)
    return list(range(get_world_size()))


def _host(t: Tensor) -> np.ndarray:
    v = t._value.detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.cpu().numpy()


def _from_host(arr, like: Tensor) -> Tensor:
    return Tensor(torch.as_tensor(np.asarray(arr),
                                  device=like._value.device).to(
                                      like._value.dtype))


def _adopt(tensor, out: Tensor):
    """An in-place collective's result: written into ``tensor`` when it
    is a Tensor (returned), else returned."""
    if isinstance(tensor, Tensor):
        tensor._replace_from(out)
        return tensor
    return out


def _reduce_identity(op, dtype):
    """Identity element an outsider contributes to a masked reduction."""
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        return 0
    if dtype == torch.bool:
        return False if op == ReduceOp.MAX else True
    if dtype.is_floating_point:
        return -float("inf") if op == ReduceOp.MAX else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == ReduceOp.MAX else info.max


def _reduce_fn(op, group: Group):
    """Collective reduction over a group's axis, inside a body.  A full
    axis reduces directly; a subgroup uses the masked-identity form (the
    class docstring).  PROD gathers, then multiplies — exact for zeros
    and negatives (exp∘psum∘log is not).  AVG divides by the group's
    size (a subgroup) or the axis' (the full axis) — not by ``nranks``,
    which also counts processes."""
    axis = group.axis_name
    sub = group._ranks is not None
    reducers = {ReduceOp.SUM: lax.psum, ReduceOp.AVG: lax.psum,
                ReduceOp.MAX: lax.pmax, ReduceOp.MIN: lax.pmin}

    def fn(v):
        member = group.member_mask() if sub else True
        if op == ReduceOp.PROD:
            gathered = lax.all_gather(v, axis, axis=0)
            if sub:
                rows = gathered[torch.as_tensor(group.ranks,
                                                device=v.device)]
                return torch.prod(rows, dim=0) if member else v
            return torch.prod(gathered, dim=0)
        if op not in reducers:
            raise ValueError(f"unknown ReduceOp {op}")
        if sub:
            contrib = v if member else torch.full_like(
                v, _reduce_identity(op, v.dtype))
        else:
            contrib = v
        if v.dtype == torch.bool and op in (ReduceOp.MAX, ReduceOp.MIN):
            red = reducers[op](contrib.to(torch.uint8), axis).bool()
        else:
            red = reducers[op](contrib, axis)
        if op == ReduceOp.AVG:
            red = red / (len(group.ranks) if sub
                         else lax.axis_size(axis))
        return red if member else v

    return fn


@_traced_span
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In-place allreduce (reference c_allreduce_sum, collective.py:365)."""
    group = group or _default_group
    t = to_tensor_like(tensor)
    if in_shard_map():
        return _adopt(tensor, apply("c_allreduce", _reduce_fn(op, group), t))
    be = _eager_backend(group)
    if be is None or not _eager_member(group):
        # world of one (or outsider to a subgroup) → identity
        return tensor
    red = be.all_reduce(_host(t), _EAGER_OP_NAMES[op], group_id=group.id,
                        ranks=group._ranks)
    return _adopt(tensor, _from_host(red, t))


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    group = group or _default_group
    t = to_tensor_like(tensor)
    if in_shard_map():
        def f(v):
            red = _reduce_fn(op, group)(v)
            return red if lax.axis_index(group.axis_name) == dst else v

        return _adopt(tensor, apply("c_reduce", f, t))
    be = _eager_backend(group)
    if be is not None and _eager_member(group):
        red = be.all_reduce(_host(t), _EAGER_OP_NAMES[op],
                            group_id=group.id, ranks=group._ranks)
        if get_rank() == dst:
            return _adopt(tensor, _from_host(red, t))
    return tensor


@_traced_span
def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """reference c_allgather: gather shards from every rank."""
    group = group or _default_group
    t = to_tensor_like(tensor)
    if in_shard_map():
        def f(v):
            g = lax.all_gather(v, group.axis_name, axis=0)
            if group._ranks is not None:
                # subgroup: member rows only (every slot sees the
                # group's view)
                g = g[torch.as_tensor(group.ranks, device=v.device)]
            return g

        out = apply("c_allgather", f, t)
        if isinstance(tensor_list, list):
            tensor_list.extend(out[i] for i in range(out.shape[0]))
            return None
        return out
    be = _eager_backend(group)
    if be is not None and _eager_member(group):
        parts = [_from_host(p, t) for p in be.all_gather(
            _host(t), group_id=group.id, ranks=group._ranks)]
        if isinstance(tensor_list, list):
            tensor_list.extend(parts)
            return None
        return Tensor(torch.stack([p._value for p in parts], dim=0))
    if isinstance(tensor_list, list):
        tensor_list.append(t)
        return None
    return t


def all_gather_object(object_list, obj, group=None):
    group = group or _default_group
    be = _eager_backend(group)
    if be is not None and _eager_member(group):
        object_list.extend(be.all_gather(obj, group_id=group.id,
                                         ranks=group._ranks))
        return
    object_list.append(obj)


@_traced_span
def broadcast(tensor, src, group=None, sync_op=True):
    group = group or _default_group
    t = to_tensor_like(tensor)
    if in_shard_map():
        def f(v):
            # src's shard on every member: gather, then index; outsiders
            # of a subgroup keep their own value
            got = lax.all_gather(v, group.axis_name, axis=0)[src]
            if group._ranks is not None and not group.member_mask():
                return v
            return got

        return _adopt(tensor, apply("c_broadcast", f, t))
    be = _eager_backend(group)
    if be is not None and _eager_member(group):
        payload = _host(t) if get_rank() == src else None
        got = be.broadcast(payload, src=src, group_id=group.id,
                           ranks=group._ranks)
        return _adopt(tensor, _from_host(got, t))
    return tensor


@_traced_span
def reduce_scatter(tensor, tensor_list_or_input, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    group = group or _default_group
    inp = tensor_list_or_input
    if isinstance(inp, (list, tuple)):
        from ..ops.manipulation import concat

        inp = concat(list(inp), axis=0)
    t = to_tensor_like(inp)
    if in_shard_map():
        def f(v):
            if group._ranks is not None:
                # subgroup: one masked psum, then each member takes its
                # chunk; outsiders get zeros (they hold no shard)
                m = len(group.ranks)
                if v.shape[0] % m:
                    raise ValueError(
                        f"reduce_scatter: leading dim {v.shape[0]} not "
                        f"divisible by subgroup size {m}")
                k = v.shape[0] // m
                member = group.member_mask()
                red = lax.psum(v if member else torch.zeros_like(v),
                               group.axis_name)
                chunk = red.narrow(0, group.group_local_index() * k, k)
                return chunk if member else torch.zeros_like(chunk)
            return lax.psum_scatter(v, group.axis_name,
                                    scatter_dimension=0, tiled=True)

        return _adopt(tensor, apply("c_reducescatter", f, t))
    be = _eager_backend(group)
    if be is not None and _eager_member(group):
        red = be.all_reduce(_host(t), _EAGER_OP_NAMES[op],
                            group_id=group.id, ranks=group._ranks)
        members = _eager_members(group)
        if red.shape[0] % len(members):
            raise ValueError(
                f"reduce_scatter: leading dim {red.shape[0]} not divisible "
                f"by group size {len(members)}")
        k = red.shape[0] // len(members)
        pos = members.index(get_rank())
        return _adopt(tensor, _from_host(red[pos * k:(pos + 1) * k], t))
    return _adopt(tensor, t)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    group = group or _default_group
    t = None
    if tensor_list:
        from ..ops.manipulation import stack

        t = to_tensor_like(stack(list(tensor_list), axis=0))
        if in_shard_map():
            out = apply("c_scatter",
                        lambda v: v[lax.axis_index(group.axis_name)], t)
            return _adopt(tensor, out)
    be = _eager_backend(group)
    if be is not None and _eager_member(group):
        # only src's tensor_list matters (reference scatter semantics);
        # every member takes part in the broadcast rendezvous
        members = _eager_members(group)
        payload = _host(t) if (get_rank() == src and t is not None) \
            else None
        rows = be.broadcast(payload, src=src, group_id=group.id,
                            ranks=group._ranks)
        if rows is None:
            raise ValueError("scatter: src rank must pass tensor_list")
        like = to_tensor_like(tensor)
        return _adopt(tensor, _from_host(rows[members.index(get_rank())],
                                         like))
    if tensor_list:
        return _adopt(tensor, to_tensor_like(tensor_list[0]))
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """reference alltoall: exchange the i-th shard with rank i."""
    group = group or _default_group
    from ..ops.manipulation import stack

    if isinstance(in_tensor_list, (list, tuple)):
        x = to_tensor_like(stack(list(in_tensor_list), axis=0))
    else:
        x = to_tensor_like(in_tensor_list)
    if in_shard_map():
        def a2a(v):
            if group._ranks is not None:
                # subgroup: full gather, then member p takes the p-th slice
                # of every member's contribution
                m = len(group.ranks)
                if v.shape[0] % m:
                    raise ValueError(
                        f"alltoall: leading dim {v.shape[0]} not divisible "
                        f"by subgroup size {m}")
                k = v.shape[0] // m
                g = lax.all_gather(v, group.axis_name, axis=0)
                rows = g[torch.as_tensor(group.ranks, device=v.device)]
                sel = rows.narrow(1, group.group_local_index() * k, k)
                out = sel.reshape((m * k,) + tuple(v.shape[1:]))
                return out if group.member_mask() else torch.zeros_like(out)
            return lax.all_to_all(v, group.axis_name, split_axis=0,
                                  concat_axis=0, tiled=False)

        out = apply("alltoall", a2a, x)
        if out_tensor_list is not None:
            out_tensor_list.extend(out[i] for i in range(out.shape[0]))
            return None
        return out
    be = _eager_backend(group)
    if be is not None and _eager_member(group):
        # exchange: gather everyone's stacked input, take my slice of each
        members = _eager_members(group)
        parts = be.all_gather(_host(x), group_id=group.id,
                              ranks=group._ranks)
        pos = members.index(get_rank())
        mine = [_from_host(p[pos], x) for p in parts]
        if out_tensor_list is not None:
            out_tensor_list.extend(mine)
            return None
        return Tensor(torch.stack([m._value for m in mine], dim=0))
    if out_tensor_list is not None:
        items = in_tensor_list if isinstance(in_tensor_list, (list, tuple)) \
            else [x]
        out_tensor_list.extend(to_tensor_like(t) for t in items)
        return None
    return x


def _p2p(t, src, dst, group):
    """The one p2p: a single-edge ppermute (src→dst).  Every member takes
    part; dst receives src's value, everyone else zeros (reference
    send_v2/recv_v2 semantics)."""
    return apply("p2p", lambda v: lax.ppermute(v, group.axis_name,
                                               [(src, dst)]), t)


@_traced_span
def send(tensor, dst=0, group=None, sync_op=True, src=None):
    """p2p send (reference send_v2).

    Inside a body: the single-edge ppermute (src→dst).  ``src`` defaults
    to this process's rank — right between processes; inside a body pass
    ``src`` explicitly (or use :func:`p2p_shift` for ring patterns).  The
    matching :func:`recv` runs the same collective."""
    group = group or _default_group
    t = to_tensor_like(tensor)
    if in_shard_map():
        s = get_rank() if src is None else src
        return _p2p(t, s, dst, group)
    if _eager_backend(group) is not None:
        raise NotImplementedError(
            "eager multi-process send/recv is not supported — p2p is a "
            "collective of a shard_map body (ppermute, reference send_v2); "
            "use broadcast/scatter for host-side exchange")
    return None


@_traced_span
def recv(tensor, src=0, group=None, sync_op=True, dst=None):
    """p2p recv (reference recv_v2): the other half of the matched
    single-edge ppermute. ``dst`` defaults to this process's rank."""
    group = group or _default_group
    t = to_tensor_like(tensor)
    if in_shard_map():
        d = get_rank() if dst is None else dst
        return _adopt(tensor, _p2p(t, src, d, group))
    if _eager_backend(group) is not None:
        raise NotImplementedError(
            "eager multi-process send/recv is not supported — p2p is a "
            "collective of a shard_map body (ppermute, reference recv_v2); "
            "use broadcast/scatter for host-side exchange")
    return tensor


def p2p_shift(tensor, group=None, shift=1):
    """Ring shift: every member passes its value to (rank+shift) — the
    building block of ring attention / pipeline p2p."""
    group = group or _default_group
    t = to_tensor_like(tensor)
    if in_shard_map():
        n = lax.axis_size(group.axis_name)
        perm = [(i, (i + shift) % n) for i in range(n)]
        return apply("ppermute",
                     lambda v: lax.ppermute(v, group.axis_name, perm), t)
    if _eager_backend(group) is not None:
        raise NotImplementedError(
            "eager multi-process p2p_shift is not supported — ring p2p is "
            "a collective of a shard_map body (ppermute); an eager identity "
            "here would silently skip the exchange")
    return t


@_traced_span
def barrier(group=None):
    """reference barrier_op: a cross-process rendezvous when running
    multi-process (torch.distributed, or the host gloo backend), a sync
    of the card otherwise."""
    group = group or _default_group
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        dist.barrier()
        return
    # raises when world_size > 1 with no host backend — two processes
    # going on unsynchronized must not look like a successful barrier
    be = _eager_backend(group)
    if be is not None and _eager_member(group):
        be.barrier(group_id=group.id, ranks=group._ranks)
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def wait(tensor, group=None, use_calc_stream=True):
    """reference c_wait_*: the card's work is done when this returns."""
    if not in_shard_map() and torch.cuda.is_available():
        torch.cuda.synchronize()
    return tensor


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Tensor-parallel building block (reference collective.py:811
    paddle.distributed.split: parallel embedding / row- / column-parallel
    linear); the layer forms are in ``parallel_layers``."""
    from .parallel_layers import split as _split

    return _split(x, size, operation, axis=axis, num_partitions=num_partitions,
                  gather_out=gather_out, weight_attr=weight_attr,
                  bias_attr=bias_attr, name=name)
