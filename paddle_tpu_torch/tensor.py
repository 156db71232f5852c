"""Tensor — twin of ``paddle_tpu/tensor.py``: the paddle eager tensor
over a torch tensor.

``_value`` is the torch tensor.  Autograd is torch's: a leaf with
``stop_gradient=False`` is a torch leaf that requires grad, an op's
output carries its ``grad_fn``.  Paddle's semantics on top:

- ``stop_gradient`` (default True) is the inverse of ``requires_grad``;
  setting it True on an op's output cuts the graph there (detach);
- ``grad`` is a Tensor or None; grads accumulate over backward calls
  until ``clear_grad``, which sets them to None; a non-leaf keeps its
  grad only after ``retain_grads()``;
- ``shape`` is a list; ``dtype`` is the torch dtype (``str`` of it ends
  in the paddle name, ``"torch.bfloat16"``);
- ``backward()`` consumes the graph of the tensor it runs from (unless
  ``retain_graph``), and ``Optimizer.minimize`` runs the backward only
  while it has not been consumed: the reference's rule, for which a
  torch ``grad_fn`` (set until the tensor dies) cannot stand;
- ``__setitem__`` and the in-place method forms (``add_``, ``scale_``,
  ...) adopt an out-of-place result as the reference's ``_replace_from``
  does: where an autograd graph was recorded the tensor takes the new
  value and its graph, else the value is copied into the tensor's own
  storage, so a parameter keeps the storage its optimizer and CUDA
  graphs hold.  On a leaf that requires grad (a trainable parameter)
  such an op raises while grad is recorded, as torch and paddle do:
  adopting the result would leave the optimizer with a tensor the model
  no longer uses.  Under ``no_grad`` it writes the leaf in place.

The reference's in-place version guard (``paddle_tpu/autograd/tape.py:
84-100``): every Tensor counts its in-place writes (``inplace_version``:
the in-place aliases, ``set_value``, ``__setitem__``, ``_replace_from``,
an optimizer's update); ``ops.dispatch.apply`` notes the version of each
non-leaf input of an op it records, and the backward raises
``RuntimeError`` when it reaches that op after such an input was written.
The op whose result a tensor adopts refreshes its own note.  A leaf is
exempt, as there: a leaf written in place after an op saved it (an
``optimizer.step()`` or ``set_value`` between the forward and the
backward) hands that op the value it saved (``preserve_saved``), as the
JAX package's immutable arrays do.

The comparison operators are elementwise (a bool Tensor, dispatched as
"eq", "lt", ...), as in the reference, and ``__hash__`` is
identity: compare Tensors by ``is`` or ``id()``, never with ``==`` or
``in``.  A row-sparse gradient (``embedding(sparse=True)``) lies in the
torch tensor's ``grad`` as a sparse COO tensor; ``grad`` reads it as an
``IndexedSlices`` (``sparse_grad.py``).

Every operator goes through ``ops.dispatch.apply`` under paddle_tpu's op
names, so AMP, the NaN/Inf sweep and the operator error prefix apply.
The method forms of the top-level ops (``x.exp()``, ``x.topk(2)``) are
attached by the package's ``__init__``, as the reference's
``_patch_tensor_methods`` attaches them."""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from .framework.dtype import convert_dtype, is_floating
from .framework.errors import InvalidArgumentError

__all__ = ["Tensor", "Parameter", "to_tensor", "graph_consumed",
           "preserve_saved"]

# set on a torch tensor whose graph a backward has freed
_CONSUMED = "_paddle_graph_consumed"
# set on a torch leaf: the saved copies (``_SavedLeaf``) ops hold of it
_SAVED = "_paddle_saved"


class _SavedLeaf:
    """What an op saved of a leaf: its value, until the leaf is written
    in place, then a copy of the value it had."""

    __slots__ = ("value", "__weakref__")

    def __init__(self, value):
        self.value = value


def pack_saved(t):
    """``saved_tensors_hooks`` pack: a leaf as a ``_SavedLeaf`` the leaf
    lists (so a later in-place write can hand it the old value); any
    other tensor detached (torch re-attaches its history on unpack) with
    its version, which unpacking checks as torch's own saving does."""
    if t.grad_fn is None:
        box = _SavedLeaf(t.detach())
        boxes = getattr(t, _SAVED, None)
        if boxes is None:
            boxes = weakref.WeakSet()
            setattr(t, _SAVED, boxes)
        boxes.add(box)
        return box
    return t.detach(), t._version


def unpack_saved(packed):
    if isinstance(packed, _SavedLeaf):
        return packed.value
    v, version = packed
    if v._version != version:
        raise RuntimeError(
            "one of the variables needed for gradient computation has been "
            f"modified by an inplace operation: it is at version "
            f"{v._version}; expected version {version} instead")
    return v


def preserve_saved(v: torch.Tensor):
    """Before ``v`` (a leaf) is written in place: the ops that saved it
    get a copy of its current value."""
    boxes = getattr(v, _SAVED, None)
    if boxes:
        snap = v.detach().clone()
        for box in list(boxes):
            box.value = snap
        boxes.clear()


def graph_consumed(value) -> bool:
    """Whether a backward has freed the graph behind ``value`` (a torch
    tensor or a Tensor): the reference's "the loss's grad node has no
    vjp left" (``paddle_tpu/optimizer/optimizer.py:289-292``)."""
    v = value._value if isinstance(value, Tensor) else value
    return v.grad_fn is None or getattr(v, _CONSUMED, False)


def _mark_consumed(values, retain_graph):
    if not retain_graph:
        for v in values:
            if v.grad_fn is not None:
                setattr(v, _CONSUMED, True)


class Tensor:
    __slots__ = ("_value", "name", "_inplace_version", "__weakref__")

    def __init__(self, value, stop_gradient: bool = True,
                 name: Optional[str] = None):
        if isinstance(value, Tensor):
            value = value._value
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        self._value = value
        self._inplace_version = 0
        if not stop_gradient:
            self.stop_gradient = False
        self.name = name

    # --- metadata -----------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        v = self._value
        if value:
            if v.grad_fn is not None:
                self._value = v.detach()
            else:
                v.requires_grad_(False)
        elif v.grad_fn is None and is_floating(v.dtype):
            v.requires_grad_(True)

    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def size(self):
        return self._value.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self._value.dtype

    @property
    def place(self) -> torch.device:
        return self._value.device

    @property
    def is_leaf(self) -> bool:
        return self._value.grad_fn is None

    @property
    def grad(self):
        """The gradient: a Tensor, an ``IndexedSlices`` for a row-sparse
        one, or None."""
        v = self._value
        if not (v.is_leaf or v.retains_grad) or v.grad is None:
            return None
        if v.grad.is_sparse:
            from .sparse_grad import IndexedSlices

            return IndexedSlices.from_coo(v.grad)
        return Tensor(v.grad)

    @grad.setter
    def grad(self, g):
        from .sparse_grad import IndexedSlices

        if isinstance(g, IndexedSlices):
            g = g.to_coo()
        self._value.grad = None if g is None else _unwrap(g)

    @property
    def value(self) -> torch.Tensor:
        return self._value

    @property
    def inplace_version(self) -> int:
        """The count of in-place writes to this Tensor."""
        return self._inplace_version

    def numel(self) -> int:
        return self.size

    def dim(self) -> int:
        return self.ndim

    def rank(self) -> int:
        return self.ndim

    # --- host interop -------------------------------------------------
    def numpy(self):
        """A copy of the value as a numpy array (bf16 as float32): later
        in-place updates of the tensor do not reach it."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            return v.float().cpu().numpy()
        if v.device.type != "cpu":
            return v.cpu().numpy()
        return v.numpy().copy()

    def item(self, *args):
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def _check_scalar_coercion(self, what):
        """Loud dy2static (reference program_translator.py:233): inside
        ``jit.to_static`` and while a static Program records, a Tensor's
        value may not become a Python scalar — Python would branch on it
        once and bake that branch (or a placeholder's number) in.  The
        dy2static pass converts what it can onto ``jit.control_flow``;
        what is left raises here, as a traced value does in the JAX
        package."""
        from .framework.export_compat import capturing, is_placeholder
        from .ops.dispatch import _recording_program

        recording = _recording_program() is not None
        if capturing() or (is_placeholder(self._value) and not recording):
            raise TypeError(
                f"cannot convert a traced Tensor to a Python {what} inside "
                "to_static/jit capture: data-dependent Python control flow "
                "would specialize to one branch. Use "
                "paddle_tpu_torch.jit.control_flow.cond / while_loop, or "
                "move the condition to a non-tensor value.")
        if recording or is_placeholder(self._value):
            raise TypeError(
                f"cannot convert a Tensor to a Python {what} while a "
                "static Program is recording: the build-time placeholder "
                "has no value to bake into the program (`if`/`while` "
                "would record a single branch; scalar coercion a stale "
                "number — reference dy2static rewrites these into "
                "conditional_block/while ops). Use "
                "paddle_tpu_torch.jit.control_flow.traced_cond / "
                "while_loop with explicit operands, or compute the value "
                "outside program capture.")

    def __float__(self):
        self._check_scalar_coercion("float")
        return float(self.item())

    def __int__(self):
        self._check_scalar_coercion("int")
        return int(self.item())

    def __bool__(self):
        self._check_scalar_coercion("bool")
        return bool(self.numpy())

    def __index__(self):
        self._check_scalar_coercion("index")
        return int(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, idx) -> "Tensor":
        """Indexing as torch's (ints, slices, None, ``...``, integer or
        bool Tensors), dispatched as "slice"."""
        from .ops.dispatch import apply

        cidx = _clean_index(idx)
        return apply("slice", lambda v: v[cidx], self)

    def __setitem__(self, idx, value):
        """``x[idx] = value`` as the reference's: an out-of-place
        "set_value" op whose result the tensor adopts."""
        from .ops.dispatch import apply

        cidx = _clean_index(idx)
        if not isinstance(value, Tensor):
            value = Tensor(torch.as_tensor(np.asarray(value),
                                           device=self._value.device))

        def f(x, v):
            out = x.clone()
            out[cidx] = v.to(dtype=x.dtype, device=x.device)
            return out

        self._replace_from(apply("set_value", f, self, value))

    # --- autograd -----------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        """Accumulate d(self)/d(leaf) into every leaf that requires grad
        (ones as the seed gradient, as paddle, also for a non-scalar)."""
        if grad_tensor is None:
            grad = torch.ones_like(self._value)
        else:
            grad = (grad_tensor._value if isinstance(grad_tensor, Tensor)
                    else torch.as_tensor(grad_tensor,
                                         device=self._value.device))
        torch.autograd.backward(self._value, grad, retain_graph=retain_graph)
        _mark_consumed([self._value], retain_graph)

    def register_hook(self, hook):
        """Call ``hook(grad)`` (a Tensor) when this tensor's gradient is
        computed; a Tensor it returns replaces the gradient.  Returns a
        handle whose ``remove()`` drops the hook."""
        def torch_hook(g):
            out = hook(Tensor(g))
            return None if out is None else _unwrap(out)

        return self._value.register_hook(torch_hook)

    def retain_grads(self):
        self._value.retain_grad()

    def clear_grad(self):
        self._value.grad = None

    clear_gradient = clear_grad

    def detach(self) -> "Tensor":
        return Tensor(self._value.detach())

    def detach_(self):
        self._value = self._value.detach()
        return self

    def clone(self) -> "Tensor":
        from .ops.dispatch import apply

        return apply("clone", lambda v: v.clone(), self)

    # --- mutation -----------------------------------------------------
    def set_value(self, value):
        """Write ``value`` (same shape; cast to this dtype and device)
        into the tensor, outside autograd.  A leaf is written in place,
        so a parameter keeps the storage its optimizer holds."""
        v = _unwrap(value)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        cur = self._value
        if tuple(v.shape) != tuple(cur.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(v.shape)} "
                             f"vs {tuple(cur.shape)}")
        v = v.detach().to(dtype=cur.dtype, device=cur.device)
        if cur.grad_fn is None:
            preserve_saved(cur)
            with torch.no_grad():
                cur.copy_(v)
        else:
            self._value = v.clone()
        self._inplace_version += 1
        return self

    def _replace_from(self, other: "Tensor"):
        """Adopt an in-place op's out-of-place result: its value and
        graph where it recorded one, else its value copied into this
        tensor's storage (same shape, dtype and device)."""
        v, cur = other._value, self._value
        if v.grad_fn is not None and cur.is_leaf and cur.requires_grad:
            raise InvalidArgumentError(
                "an in-place op on a leaf tensor that requires grad (a "
                "trainable parameter) while grad is recorded; run it "
                "under paddle.no_grad()")
        if (v.grad_fn is None and cur.grad_fn is None
                and v.shape == cur.shape and v.dtype == cur.dtype
                and v.device == cur.device):
            preserve_saved(cur)
            with torch.no_grad():
                cur.copy_(v)
        else:
            self._value = v
        self._inplace_version += 1
        # the op adopted here noted this tensor's version before the
        # bump: its own note is refreshed, only later writes trip it
        for note in getattr(v, "_paddle_notes", ()):
            if note[0]() is self:
                note[1] = self._inplace_version
        return self

    # --- movement -----------------------------------------------------
    def cpu(self) -> "Tensor":
        return Tensor(self._value.cpu())

    def to(self, place_or_dtype) -> "Tensor":
        """A copy on a place (a ``Place``, a place string or a torch
        device) or in a dtype."""
        from .framework.place import Place, to_device

        x = place_or_dtype
        if isinstance(x, (Place, torch.device)) or (
                isinstance(x, str) and x.split(":")[0].lower()
                in ("cpu", "gpu", "cuda", "tpu", "xpu")):
            return Tensor(self._value.to(to_device(x)))
        return self.astype(x)

    def pin_memory(self) -> "Tensor":
        """The tensor in page-locked host memory (itself without a card
        or when it lies on one)."""
        v = self._value
        if v.device.type == "cpu" and torch.cuda.is_available():
            return Tensor(v.pin_memory())
        return self

    def contiguous(self) -> "Tensor":
        v = self._value
        return self if v.is_contiguous() else Tensor(v.contiguous())

    def is_contiguous(self) -> bool:
        return self._value.is_contiguous()

    # --- ops ----------------------------------------------------------
    def astype(self, dtype) -> "Tensor":
        from .ops.dispatch import apply

        d = convert_dtype(dtype)
        return apply("cast", lambda x: x.to(d), self)

    cast = astype

    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"place={self.place}{grad_info},\n       "
                f"{self.numpy()!r})")

    __str__ = __repr__


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


def _clean_index(idx):
    """An index with its Tensors unwrapped to their torch values."""
    if isinstance(idx, tuple):
        return tuple(_clean_index(i) for i in idx)
    return idx._value if isinstance(idx, Tensor) else idx


def _binary(name, fn, reverse=False):
    def method(self, other):
        from .ops.dispatch import apply

        if reverse:
            return apply(name, lambda b, a: fn(a, b), self, other)
        return apply(name, fn, self, other)

    return method


def _unary(name, fn):
    def method(self):
        from .ops.dispatch import apply

        return apply(name, fn, self)

    return method


for _op, _fn in {
    "__add__": torch.add,
    "__sub__": torch.sub,
    "__mul__": torch.mul,
    "__truediv__": torch.true_divide,
    "__floordiv__": torch.floor_divide,
    "__mod__": torch.remainder,
    "__pow__": torch.pow,
    "__matmul__": torch.matmul,
}.items():
    setattr(Tensor, _op, _binary(_op.strip("_"), _fn))
    _rop = "__r" + _op[2:]
    setattr(Tensor, _rop, _binary(_rop.strip("_"), _fn, reverse=True))

for _op, _fn in {
    "__eq__": torch.eq,
    "__ne__": torch.ne,
    "__lt__": torch.lt,
    "__le__": torch.le,
    "__gt__": torch.gt,
    "__ge__": torch.ge,
}.items():
    setattr(Tensor, _op, _binary(_op.strip("_"), _fn))

Tensor.__hash__ = object.__hash__
Tensor.__neg__ = _unary("neg", torch.neg)
Tensor.__abs__ = _unary("abs", torch.abs)
Tensor.__invert__ = _unary("invert", torch.logical_not)


class Parameter(Tensor):
    """A trainable leaf (paddle's ParamBase): ``stop_gradient`` is
    ``not trainable``.  ``optimize_attr["learning_rate"]`` scales the
    optimizer's learning rate for it, ``regularizer`` (when set) takes
    the place of the optimizer's, and ``need_clip=False`` keeps its
    gradient out of the clips, as ``ParamAttr`` sets them.  A Parameter
    made without a name is named ``generated_tensor_{n}``, as the
    reference names it (its counter also counts the unnamed Tensors the
    ops make; this one counts the Parameters only)."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "need_clip",
                 "do_model_average", "partition_spec")
    _name_counter = 0

    def __init__(self, value, name=None, trainable=True):
        if isinstance(value, Tensor):
            value = value._value
        if name is None:
            Parameter._name_counter += 1
            name = f"generated_tensor_{Parameter._name_counter}"
        super().__init__(torch.as_tensor(value).detach(),
                         stop_gradient=not trainable, name=name)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.do_model_average = True
        # the mesh axis each dim is sharded over in a sharded train step
        # (None: replicated), as ``paddle_tpu``'s ``partition_spec``
        self.partition_spec = None


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """Twin of ``paddle_tpu/ops/creation.py:28``: a new leaf on ``place``
    (the default place when None), copied from a list, a numpy array, a
    torch tensor or a Tensor.  float64 data becomes float32 unless
    ``dtype`` says otherwise (paddle's default dtype)."""
    from .framework.place import to_device

    dev = to_device(place)
    if isinstance(data, Tensor):
        data = data._value
    if isinstance(data, torch.Tensor):
        v = data.detach().clone()
    else:
        arr = np.array(data, copy=True)
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(np.float32)
        v = torch.from_numpy(arr)
    if dtype is not None:
        v = v.to(convert_dtype(dtype))
    return Tensor(v.to(dev), stop_gradient=stop_gradient)
