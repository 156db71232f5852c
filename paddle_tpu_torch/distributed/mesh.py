"""The single-controller device mesh and the ``shard_map`` twin — the
port's copy of ``paddle_tpu/distributed/mesh.py``.

The JAX package runs parallel work as ONE program over a named mesh of
``jax.devices()``: one process, every shard's tensors on its own device,
the collectives inside the program.  The port keeps that design.  A mesh
is a grid of device *slots*; each shard's tensors live on its slot and
one process drives every shard.  Several slots may name one device: on
one card, four slots share ``cuda:0``; on a machine with several cards
the same code spreads them over the cards.

Two ways of driving the shards:

- the serving mesh calls each shard in turn and joins their outputs with
  the list collectives :func:`pmax`, :func:`psum`, :func:`pmin` and the
  tiled :func:`all_gather` (tensor operations over the shards' outputs
  that leave their result on every shard's slot);
- :func:`shard_map` runs a per-shard body, once per slot, each on a
  thread of its own with the slot's coordinates bound, so that
  ``distributed.lax.axis_index`` and the collectives inside the body
  (``distributed.lax``, ``distributed.collective``) resolve.  Every slot
  calls the same collectives in the same order, as every device runs the
  same program in the JAX package.  At a collective the shards meet: the
  last to arrive computes it over all of them with plain tensor
  operations and hands each shard its piece.  So every collective is one
  joint node of ONE autograd graph over all the shards, and one
  ``backward()`` from the caller differentiates through it; no backward
  waits for another shard (the autograd engine runs one device's
  backward on one thread, where a waiting collective would deadlock).

  Each body runs under the caller's grad mode, ``torch.autocast`` state
  and the port's ``amp.auto_cast`` state, and draws random numbers from a
  generator of its own slot (``framework.random.slot_generators``),
  seeded from the caller's stream.

:func:`force_device_count` is the twin of XLA's
``--xla_force_host_platform_device_count``: an explicit call that makes
:func:`devices` return n slots spread round-robin over the real devices.
Nothing calls it behind the caller's back.  Without a card a mesh of
CUDA slots raises; the CPU is used only when ``device_type="cpu"`` is
asked for.
"""
from __future__ import annotations

import threading
from contextlib import ExitStack
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["devices", "force_device_count", "Mesh", "init_mesh",
           "get_mesh", "set_mesh", "mesh_axis_size", "pmax", "psum",
           "pmin", "all_gather", "PartitionSpec", "P", "spec",
           "NamedSharding", "sharding", "replicated_sharding",
           "ShardedArray", "shard_array", "shard_map", "run_slots",
           "in_shard_map", "tree_map", "tree_leaves"]

_FORCED: Optional[int] = None
_GLOBAL_MESH: Optional["Mesh"] = None


def _real_devices(device_type: Optional[str]) -> List[torch.device]:
    """Every device of ``device_type``: None means the CUDA cards, as for
    every entry point of the port (``paddle_tpu_torch.resolve_device``),
    and raises without one; the CPU only when the caller names it."""
    if device_type is None or device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the mesh's devices are the CUDA cards, but "
                "torch.cuda.is_available() is False — pass "
                "device_type='cpu' to build a mesh on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type!r} (cuda or "
                     "cpu)")


def _device_slots(device_type: Optional[str] = None) -> List[torch.device]:
    """The mesh's device slots: every CUDA card (``device_type`` None or
    ``"cuda"``; raises without one), or the CPU (``"cpu"``) — or, after
    :func:`force_device_count`, that many slots round-robin over them."""
    real = _real_devices(device_type)
    if _FORCED is None or not real:
        return real
    return [real[i % len(real)] for i in range(_FORCED)]


devices = _device_slots


def force_device_count(n: Optional[int]) -> Optional[int]:
    """Make :func:`devices` return ``n`` slots (None restores the real
    count); returns the previous setting, so a caller can put it back."""
    global _FORCED
    if n is not None and int(n) < 1:
        raise ValueError(f"device count must be >= 1, got {n}")
    prev, _FORCED = _FORCED, None if n is None else int(n)
    return prev


def _axes_tuple(axis_name) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


class Mesh:
    """Named axes over a grid of device slots: ``slot(**coords)`` is the
    device of one shard (missing axes at 0), ``shape[name]`` an axis'
    size, ``slots`` the flat list in row-major order of ``axis_names``."""

    def __init__(self, axes: Dict[str, int], slots: Sequence[torch.device]):
        self.axis_names = tuple(axes)
        self.shape = {name: int(n) for name, n in axes.items()}
        size = 1
        for n in self.shape.values():
            size *= n
        if len(slots) != size:
            raise ValueError(f"mesh {axes} needs {size} slots, got "
                             f"{len(slots)}")
        self.slots = list(slots)
        self.size = size
        self._groups: Dict[Tuple[str, ...], list] = {}

    def slot(self, **coords) -> torch.device:
        return self.slots[self.index(**coords)]

    def index(self, **coords) -> int:
        """The flat slot index of ``coords`` (missing axes at 0)."""
        idx = 0
        for name in self.axis_names:
            idx = idx * self.shape[name] + int(coords.get(name, 0))
        return idx

    def coords(self, idx: int) -> Dict[str, int]:
        """``{axis: position}`` of flat slot ``idx``."""
        out = {}
        for name in reversed(self.axis_names):
            out[name] = idx % self.shape[name]
            idx //= self.shape[name]
        return {name: out[name] for name in self.axis_names}

    def groups(self, axis_name) -> List[List[int]]:
        """The slots that a collective over ``axis_name`` (an axis or a
        tuple of axes) joins: one list per group, each in the order of
        the group's axis positions (row-major over the named axes)."""
        axes = _axes_tuple(axis_name)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in the mesh "
                                 f"{self.shape}")
        got = self._groups.get(axes)
        if got is None:
            by_rest: Dict[tuple, list] = {}
            for i in range(self.size):
                c = self.coords(i)
                rest = tuple(c[n] for n in self.axis_names if n not in axes)
                pos = 0
                for a in axes:
                    pos = pos * self.shape[a] + c[a]
                by_rest.setdefault(rest, []).append((pos, i))
            got = [[i for _, i in sorted(g)] for g in by_rest.values()]
            self._groups[axes] = got
        return got

    def axis_size(self, axis_name) -> int:
        n = 1
        for a in _axes_tuple(axis_name):
            n *= self.shape[a]
        return n

    def __repr__(self):
        return f"Mesh({self.shape})"


def init_mesh(axes: Dict[str, int], devices=None,
              device_type: Optional[str] = None) -> Mesh:
    """Create and install the global mesh, e.g. ``init_mesh({"dp": 4,
    "mp": 2})``, over the first ``prod(axes)`` of ``devices`` (default
    the slots of :func:`devices` for ``device_type``).  Raises
    ``ValueError`` when the mesh needs more slots than there are
    devices."""
    global _GLOBAL_MESH
    devs = list(devices if devices is not None
                else _device_slots(device_type))
    total = 1
    for n in axes.values():
        total *= int(n)
    if total > len(devs):
        raise ValueError(f"mesh {axes} needs {total} devices, have "
                         f"{len(devs)}")
    _GLOBAL_MESH = Mesh(axes, devs[:total])
    return _GLOBAL_MESH


def get_mesh() -> Mesh:
    """The installed mesh, or a one-axis ``dp`` mesh over every slot."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        devs = _device_slots()
        _GLOBAL_MESH = Mesh({"dp": len(devs)}, devs)
    return _GLOBAL_MESH


def set_mesh(mesh: Mesh) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def mesh_axis_size(name: str) -> int:
    """The size of axis ``name`` of the installed mesh (1 if absent)."""
    return get_mesh().shape.get(name, 1)


# --- the list collectives of the serving mesh --------------------------------

def _everywhere(result: torch.Tensor, xs: Sequence[torch.Tensor]):
    """``result`` on every shard's slot (one copy per distinct device)."""
    on = {}
    out = []
    for x in xs:
        t = on.get(x.device)
        if t is None:
            t = on[x.device] = result.to(x.device)
        out.append(t)
    return out


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise max over the shards' tensors, on every shard's slot."""
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.maximum(acc, x.to(acc.device))
    return _everywhere(acc, xs)


def pmin(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise min over the shards' tensors, on every shard's slot."""
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.minimum(acc, x.to(acc.device))
    return _everywhere(acc, xs)


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum over the shards' tensors in shard order, on every shard's
    slot."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    return _everywhere(acc, xs)


def all_gather(xs: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """The tiled all-gather: the shards' tensors concatenated along
    ``dim`` in shard order, on every shard's slot."""
    dev = xs[0].device
    full = torch.cat([x.to(dev) for x in xs], dim=dim)
    return _everywhere(full, xs)


# --- partition specs and sharded arrays --------------------------------------

class PartitionSpec(tuple):
    """``PartitionSpec("dp", None)``: dim i of an array is split over the
    mesh axis named by entry i (a name, a tuple of names, or None for a
    replicated dim); missing trailing entries are None."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec(*names) -> PartitionSpec:
    return PartitionSpec(*names)


class NamedSharding:
    """A mesh and a spec: where each block of an array lives."""

    def __init__(self, mesh: Mesh, spec_: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec_)

    @property
    def device_set(self):
        return set(self.mesh.slots)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def sharding(*names) -> NamedSharding:
    return NamedSharding(get_mesh(), PartitionSpec(*names))


def replicated_sharding() -> NamedSharding:
    return NamedSharding(get_mesh(), PartitionSpec())


def _norm_spec(spec_, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """One tuple of axis names per dim (empty: replicated)."""
    entries = tuple(spec_ or ())
    if len(entries) > ndim:
        raise ValueError(f"spec {spec_} has more entries than the array "
                         f"has dims ({ndim})")
    entries = entries + (None,) * (ndim - len(entries))
    return tuple(() if e is None else _axes_tuple(e) for e in entries)


def _block(axes: Tuple[str, ...], mesh: Mesh, coords) -> Tuple[int, int]:
    """(block index, block count) of a dim split over ``axes``."""
    pos, n = 0, 1
    for a in axes:
        pos = pos * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return pos, n


def _split(x: torch.Tensor, spec_, mesh: Mesh) -> List[torch.Tensor]:
    """The shard of ``x`` each slot holds under ``spec_``, on the slot's
    device (a view where it already lies there; differentiable)."""
    dims = _norm_spec(spec_, x.dim())
    out = []
    for i, dev in enumerate(mesh.slots):
        c = mesh.coords(i)
        t = x
        for d, axes in enumerate(dims):
            if not axes:
                continue
            pos, n = _block(axes, mesh, c)
            if x.shape[d] % n:
                raise ValueError(
                    f"dim {d} of size {x.shape[d]} does not split over "
                    f"{axes} ({n} blocks)")
            k = x.shape[d] // n
            t = t.narrow(d, pos * k, k)
        out.append(t.to(dev))
    return out


def _assemble(shards: Sequence[Any], spec_, mesh: Mesh,
              device=None) -> Any:
    """The global array of per-slot ``shards`` laid out by ``spec_``, on
    ``device`` (default the first slot's): one shard per block, from the
    slots at position 0 of every axis the spec does not name."""
    first = shards[0]
    if not isinstance(first, torch.Tensor):
        return first
    device = device if device is not None else mesh.slots[0]
    dims = _norm_spec(spec_, first.dim())
    used = {a for axes in dims for a in axes}
    blocks = {}
    for i, t in enumerate(shards):
        c = mesh.coords(i)
        if any(c[a] for a in mesh.axis_names if a not in used):
            continue
        blocks[tuple(_block(axes, mesh, c)[0] for axes in dims if axes)] = t
    sharded = [(d, axes) for d, axes in enumerate(dims) if axes]

    def build(level, prefix):
        if level == len(sharded):
            return blocks[prefix].to(device)
        d, axes = sharded[level]
        n = _block(axes, mesh, mesh.coords(0))[1]
        return torch.cat([build(level + 1, prefix + (b,)) for b in range(n)],
                         dim=d)

    return build(0, ())


class ShardedArray:
    """A global array stored as one shard per mesh slot (the twin of a
    ``jax.Array`` with a ``NamedSharding``): ``shards[i]`` lies on
    ``mesh.slots[i]``.  ``np.asarray`` / :meth:`numpy` assemble the
    global value on the host; :meth:`global_tensor` on a device."""

    def __init__(self, shards: List[torch.Tensor], spec_, mesh: Mesh):
        self.shards = list(shards)
        self.spec = PartitionSpec(*(spec_ or ()))
        self.mesh = mesh
        shape = list(self.shards[0].shape)
        for d, axes in enumerate(_norm_spec(self.spec, len(shape))):
            if axes:
                shape[d] *= mesh.axis_size(axes)
        self.shape = tuple(shape)
        self.dtype = self.shards[0].dtype

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def global_tensor(self, device=None) -> torch.Tensor:
        return _assemble(self.shards, self.spec, self.mesh, device)

    def numpy(self) -> np.ndarray:
        t = self.global_tensor(torch.device("cpu")).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self):
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec!r}, mesh={self.mesh!r})")


def _as_tensor(x, device=None) -> torch.Tensor:
    from ..tensor import Tensor

    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


def shard_array(x, *axis_names, mesh: Optional[Mesh] = None) -> ShardedArray:
    """Place a host (or device) array onto the mesh with dim i split over
    ``axis_names[i]`` (None entries: replicated dims)."""
    mesh = mesh or get_mesh()
    t = _as_tensor(x, mesh.slots[0])
    return ShardedArray(_split(t, PartitionSpec(*axis_names), mesh),
                        PartitionSpec(*axis_names), mesh)


# --- pytrees -----------------------------------------------------------------

def _is_node(x) -> bool:
    return (isinstance(x, (dict, list)) or
            (isinstance(x, tuple) and not isinstance(x, PartitionSpec)))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples are
    nodes; None, a PartitionSpec and anything else are leaves), with the
    matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if _is_node(tree):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _map_spec(fn: Callable, spec_tree, tree):
    """``fn(spec, leaf)`` over ``tree``, where ``spec_tree`` is a prefix
    of it: a PartitionSpec (or None) applies to every leaf below it."""
    if spec_tree is None or isinstance(spec_tree, PartitionSpec):
        return tree_map(lambda leaf: fn(spec_tree, leaf), tree)
    if isinstance(spec_tree, dict):
        return {k: _map_spec(fn, spec_tree[k], v) for k, v in tree.items()}
    return type(tree)(_map_spec(fn, s, v) for s, v in zip(spec_tree, tree))


# --- the per-shard runner ----------------------------------------------------

class _Aborted(RuntimeError):
    """Another slot of the same run failed: this one stops too."""


class _Gang:
    """The rendezvous of one run's slots.  Each slot's k-th collective
    meets every other slot's k-th; the last to arrive computes it."""

    def __init__(self, n: int):
        self.n = n
        self.cond = threading.Condition()
        self.pending: Dict[int, dict] = {}
        self.error: Optional[BaseException] = None
        self.left: set = set()

    def abort(self, err: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = err
            self.cond.notify_all()

    def leave(self, idx: int) -> None:
        """Slot ``idx``'s body returned: a collective it did not join can
        no longer complete."""
        with self.cond:
            self.left.add(idx)
            self.cond.notify_all()

    def _stranded(self, seq: int, ent: dict) -> bool:
        missing = [i for i in self.left if ent["vals"][i] is None]
        if missing and self.error is None:
            self.error = RuntimeError(
                f"shard_map: slot {missing[0]} returned without joining "
                f"collective #{seq} ({ent['key']}): every slot must call "
                "the same collectives in the same order")
        return bool(missing)

    def exchange(self, seq: int, key, idx: int, value,
                 compute: Callable[[list], list]):
        with self.cond:
            if self.error is not None:
                raise _Aborted("another slot failed")
            ent = self.pending.setdefault(
                seq, {"key": key, "vals": [None] * self.n, "count": 0,
                      "out": None, "taken": 0})
            if ent["key"] != key:
                err = RuntimeError(
                    f"shard_map: the slots' collective #{seq} differ "
                    f"({ent['key']} and {key}): every slot must call the "
                    "same collectives in the same order")
                self.error = self.error or err
                self.cond.notify_all()
                raise err
            ent["vals"][idx] = value
            ent["count"] += 1
            if ent["count"] == self.n:
                try:
                    ent["out"] = compute(ent["vals"])
                except BaseException as e:
                    self.error = self.error or e
                    self.cond.notify_all()
                    raise
                ent["vals"] = None
                self.cond.notify_all()
            else:
                while (ent["out"] is None and self.error is None
                       and not self._stranded(seq, ent)):
                    self.cond.wait()
                if ent["out"] is None:
                    raise _Aborted("another slot failed")
            out = ent["out"][idx]
            ent["taken"] += 1
            if ent["taken"] == self.n:
                del self.pending[seq]
            return out


class _SlotContext:
    def __init__(self, mesh: Mesh, index: int, gang: _Gang):
        self.mesh = mesh
        self.index = index
        self.coords = mesh.coords(index)
        self.gang = gang
        self.seq = 0


_TLS = threading.local()


def _context() -> Optional[_SlotContext]:
    return getattr(_TLS, "ctx", None)


def in_shard_map() -> bool:
    """True inside a :func:`shard_map` body."""
    return _context() is not None


def current_slot() -> _SlotContext:
    ctx = _context()
    if ctx is None:
        raise RuntimeError("not inside a shard_map body: axis names are "
                           "bound only there")
    return ctx


def exchange(op: str, axis_name, value, compute: Callable[[list], list]):
    """Meet every slot of the run at this collective: ``compute`` gets
    every slot's ``value`` (by flat slot index) and returns every slot's
    result.  The building block of ``distributed.lax``."""
    ctx = current_slot()
    seq = ctx.seq
    ctx.seq += 1
    return ctx.gang.exchange(seq, (op, axis_name), ctx.index, value,
                             compute)


def _carried_locals():
    """The port's per-thread states a body runs under: AMP's, the sparse
    gradient switch and ``disable_jit``."""
    from ..amp.auto_cast import amp_state
    from ..profiler import jit_cost
    from ..sparse_grad import _mode

    return [amp_state(), _mode, jit_cost._EAGER]


def _caller_state():
    grad = torch.is_grad_enabled()
    autocast = []
    for dev in ("cuda", "cpu"):
        try:
            if torch.is_autocast_enabled(dev):
                autocast.append((dev, torch.get_autocast_dtype(dev)))
        except (TypeError, AttributeError, RuntimeError):
            pass
    carried = [(obj, dict(obj.__dict__)) for obj in _carried_locals()]

    def enter(stack: ExitStack):
        stack.enter_context(torch.set_grad_enabled(grad))
        for dev, dtype in autocast:
            stack.enter_context(torch.autocast(dev, dtype=dtype))
        for obj, state in carried:
            obj.__dict__.update(state)

    return enter


def _slot_generators(mesh: Mesh) -> List[Dict[str, torch.Generator]]:
    """One generator per slot, seeded from the caller's CPU stream."""
    from ..framework.random import generator

    base = int(torch.randint(0, 2 ** 62, (1,),
                             generator=generator("cpu")).item())
    out = []
    for i, dev in enumerate(mesh.slots):
        g = torch.Generator(device=dev)
        g.manual_seed(base + 7919 * i)
        out.append({str(dev): g})
    return out


def run_slots(mesh: Mesh, body: Callable, per_slot_args: Sequence[tuple]):
    """``body(*per_slot_args[i])`` once per slot i, each on its own
    thread with slot i's coordinates bound (see the module docstring);
    returns the bodies' results by slot.  A failing slot stops the
    others at their next collective and its error is raised here."""
    from ..framework.random import slot_generators

    if in_shard_map():
        raise RuntimeError("shard_map inside a shard_map body is not "
                           "supported")
    n = mesh.size
    gang = _Gang(n)
    enter = _caller_state()
    gens = _slot_generators(mesh)
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n

    def work(i):
        _TLS.ctx = _SlotContext(mesh, i, gang)
        try:
            with ExitStack() as stack:
                enter(stack)
                dev = mesh.slots[i]
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                stack.enter_context(slot_generators(gens[i]))
                results[i] = body(*per_slot_args[i])
            gang.leave(i)
        except BaseException as e:       # noqa: BLE001 - re-raised below
            errors[i] = e
            gang.abort(e)
        finally:
            _TLS.ctx = None

    if n == 1:
        work(0)
    else:
        threads = [threading.Thread(target=work, args=(i,),
                                    name=f"shard_map-slot{i}", daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    real = [e for e in errors if e is not None and not isinstance(e, _Aborted)]
    if real:
        raise real[0]
    if gang.error is not None:
        raise gang.error
    return results


class _PerSlot:
    """One input leaf's pieces, by slot (a leaf of the input tree)."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = items


def _shards_of(spec_, leaf, mesh: Mesh) -> _PerSlot:
    """Slot i's piece of one input leaf under ``spec_``."""
    if isinstance(leaf, ShardedArray):
        same = (leaf.mesh is mesh and
                _norm_spec(leaf.spec, len(leaf.shape)) ==
                _norm_spec(spec_, len(leaf.shape)))
        if same:
            return _PerSlot(leaf.shards)
        leaf = leaf.global_tensor()
    if leaf is None or isinstance(leaf, (int, float, bool, str)):
        return _PerSlot([leaf] * mesh.size)
    whole = _as_tensor(leaf, mesh.slots[0])
    # each slot's piece is its own copy, as a JAX array is immutable: an
    # in-place collective on a shard must not write into the caller's
    # array (or into another slot's piece of it)
    return _PerSlot([t.clone() if _aliases(t, whole) else t
                     for t in _split(whole, spec_, mesh)])


def _aliases(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.device == b.device and \
        a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def shard_map(f: Callable, mesh: Optional[Mesh] = None, in_specs=None,
              out_specs=None, check_vma=None, check_rep=None):
    """The twin of ``jax.shard_map``: ``shard_map(f, mesh, in_specs,
    out_specs)(*args)`` splits each argument by its spec (a spec may be
    a prefix of the argument's pytree; a :class:`ShardedArray` laid out
    by the same spec passes its shards as they are), runs ``f`` once per
    slot on its shards (:func:`run_slots`), and assembles the outputs by
    ``out_specs`` on the first slot's device — a replicated output
    (``P()``) is the first slot's.  Inputs may be torch tensors, port
    Tensors (the body gets their torch values), numpy arrays or Python
    scalars.  ``check_vma`` / ``check_rep`` are accepted and ignored."""
    def run(*args):
        m = mesh or get_mesh()
        specs = (tuple(in_specs) if isinstance(in_specs, (tuple, list))
                 and not isinstance(in_specs, PartitionSpec)
                 else (in_specs,))
        if len(specs) != len(args):
            raise ValueError(f"shard_map: {len(args)} arguments but "
                             f"{len(specs)} in_specs")
        per_arg = [_map_spec(lambda s, leaf: _shards_of(s, leaf, m), s, a)
                   for s, a in zip(specs, args)]
        per_slot = [tuple(tree_map(lambda ps: ps.items[i], pa)
                          for pa in per_arg) for i in range(m.size)]
        outs = run_slots(m, f, per_slot)
        return _gather_outputs(outs, out_specs, m)

    return run


def _gather_outputs(outs: list, out_specs, mesh: Mesh):
    first = outs[0]

    def one(spec_, path):
        return _assemble([path(o) for o in outs], spec_, mesh)

    def walk(spec_tree, tree, path):
        if spec_tree is None or isinstance(spec_tree, PartitionSpec):
            if _is_node(tree):
                return _subtree(spec_tree, tree, path)
            return one(spec_tree, path)
        if isinstance(spec_tree, dict):
            return {k: walk(spec_tree[k], v,
                            (lambda o, k=k, p=path: p(o)[k]))
                    for k, v in tree.items()}
        return type(tree)(walk(s, v, (lambda o, i=i, p=path: p(o)[i]))
                          for i, (s, v) in enumerate(zip(spec_tree, tree)))

    def _subtree(spec_, tree, path):
        if isinstance(tree, dict):
            return {k: _subtree(spec_, v, (lambda o, k=k, p=path: p(o)[k]))
                    for k, v in tree.items()}
        if _is_node(tree):
            return type(tree)(_subtree(spec_, v,
                                       (lambda o, i=i, p=path: p(o)[i]))
                              for i, v in enumerate(tree))
        return one(spec_, path)

    return walk(out_specs, first, lambda o: o)
