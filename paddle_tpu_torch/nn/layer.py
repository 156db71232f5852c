"""nn.Layer — twin of ``paddle_tpu/nn/layer.py:34``, the paddle module
base class over the port's ``Parameter``.

Parameters and sublayers register by assignment (``self.w = Parameter``,
``self.fc = Layer``) or by ``add_parameter``/``add_sublayer``; buffers
(a ``BatchNorm``'s running ``_mean`` and ``_variance``) by
``register_buffer``, after which assigning a Tensor to the name rebinds
the buffer.  ``named_parameters``, ``named_buffers`` and ``state_dict``
use paddle's structured names (``"fc.0.weight"``, ``"bn1._mean"``): the
parameters first, then the persistable buffers, as in paddle_tpu, so a
paddle_tpu ``state_dict`` loads unchanged.  Forward pre- and post-hooks
(``register_forward_pre_hook`` / ``register_forward_post_hook``) run
around ``forward`` in ``__call__``, as in the reference.  ``set_state_dict`` copies
into each parameter and buffer IN PLACE (the optimizer, the layer and a
CUDA graph that captured them keep holding the same tensors); with
:func:`state_from_numpy` it is the weight bridge from paddle_tpu::

    state = {k: np.asarray(v._value) for k, v in jax_layer.state_dict().items()}
    port_layer.set_state_dict(state_from_numpy(state, "cuda"))
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, Optional

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.place import default_device
from ..tensor import Parameter, Tensor, preserve_saved

__all__ = ["Layer", "state_from_numpy", "make_parameter"]


class HookRemoveHelper:
    """The handle of a forward hook: ``remove()`` drops it."""

    _next_id = 0

    def __init__(self, hooks):
        self._hooks = hooks
        HookRemoveHelper._next_id += 1
        self._id = HookRemoveHelper._next_id

    def remove(self):
        self._hooks.pop(self._id, None)


def make_parameter(shape, dtype, attr=None, is_bias=False,
                   default_initializer=None, name=None):
    """A new Parameter on the default place, set up as the reference's
    ``Layer.create_parameter`` sets one up: ``attr`` (a ``ParamAttr``, a
    name or an initializer) gives its name, initializer (before
    ``default_initializer``; else zeros for a bias and XavierNormal
    otherwise), ``trainable``, learning-rate scale, regularizer and
    ``need_clip``."""
    from ..param_attr import ParamAttr
    from . import initializer as init

    attr = ParamAttr._to_attr(attr)
    p = Parameter(torch.zeros(tuple(int(s) for s in shape), dtype=dtype,
                              device=default_device()),
                  name=attr.name if attr.name is not None else name,
                  trainable=attr.trainable)
    initializer = attr.initializer or default_initializer
    if initializer is None:
        initializer = init.Constant(0.0) if is_bias else init.XavierNormal()
    initializer(p)
    p.optimize_attr["learning_rate"] = attr.learning_rate
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    p.do_model_average = attr.do_model_average
    return p


def state_from_numpy(state: dict, device=None) -> "OrderedDict":
    """``{name: array}`` (a paddle_tpu ``state_dict`` read out with
    ``np.asarray``) as ``{name: torch tensor on device}``, for
    :meth:`Layer.set_state_dict`; ``device=None`` is the default place."""
    from ..framework.place import to_device

    dev = to_device(device)
    return OrderedDict((k, torch.from_numpy(np.array(v, copy=True)).to(dev))
                       for k, v in state.items())


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self.training = True
        self._dtype = convert_dtype(dtype)
        self._parameters: "OrderedDict[str, Parameter]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self._buffers: "OrderedDict[str, Optional[Tensor]]" = OrderedDict()
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self._name_scope = name_scope or type(self).__name__.lower()

    # --- construction helpers -------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Optional[Parameter]:
        """A new Parameter on the default place (:func:`make_parameter`:
        ``attr`` is a ``ParamAttr``); ``attr=False`` means none."""
        if attr is False:
            return None
        dtype = convert_dtype(dtype) if dtype is not None else self._dtype
        return make_parameter(shape, dtype, attr, is_bias,
                              default_initializer)

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor, persistable=True):
        """Register ``tensor`` (a Tensor, a torch tensor or None) as the
        buffer ``name``: moved by ``to``, carried by ``state_dict`` unless
        ``persistable`` is False, never trained."""
        if isinstance(tensor, torch.Tensor):
            tensor = Tensor(tensor)
        self._buffers[name] = tensor
        if persistable:
            self._non_persistable_buffer_names.discard(name)
        else:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # --- attribute plumbing ---------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning parameters")
            params[name] = value
            if buffers is not None:
                buffers.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError(
                    "call Layer.__init__ before assigning sublayers")
            layers[name] = value
        else:
            if params is not None and name in params:
                if value is None:
                    params[name] = None
                    return
                del params[name]
            if layers is not None and name in layers:
                del layers[name]
            if buffers is not None and name in buffers:
                if isinstance(value, Tensor) or value is None:
                    buffers[name] = value
                    return
                del buffers[name]
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    # --- traversal ------------------------------------------------------
    def children(self) -> Iterator["Layer"]:
        for _, layer in self.named_children():
            yield layer

    def named_children(self):
        seen = set()
        for name, layer in self._sub_layers.items():
            if layer is not None and id(layer) not in seen:
                seen.add(id(layer))
                yield name, layer

    def sublayers(self, include_self=False):
        return [layer for _, layer in
                self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, layer in self.named_children():
            sub = prefix + ("." if prefix else "") + name
            yield from layer.named_sublayers(prefix=sub, include_self=True,
                                             layers_set=layers_set)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        layers = (self.named_sublayers(prefix=prefix, include_self=True)
                  if include_sublayers else [(prefix, self)])
        for lp, layer in layers:
            for name, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield lp + ("." if lp else "") + name, p

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        layers = (self.named_sublayers(prefix=prefix, include_self=True)
                  if include_sublayers else [(prefix, self)])
        for lp, layer in layers:
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield lp + ("." if lp else "") + name, b

    # --- mode switches --------------------------------------------------
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    def to(self, device=None, dtype=None, blocking=None):
        """Move every parameter and buffer to ``device`` and cast the
        floating ones to ``dtype``.  Each gets a new torch tensor (a
        parameter stays a trainable leaf): build the optimizer, and
        capture any graph, after the move."""
        from ..framework.place import to_device

        dev = None if device is None else to_device(device)
        dt = None if dtype is None else convert_dtype(dtype)
        for t in self.parameters() + self.buffers():
            v = t._value.detach()
            if dt is not None and v.is_floating_point():
                v = v.to(dt)
            if dev is not None:
                v = v.to(dev)
            if v is not t._value:
                t._value = v.requires_grad_(t._value.requires_grad)
        if dt is not None:
            self._dtype = dt
        return self

    def apply(self, fn):
        """Call ``fn`` on every sublayer and this layer."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # --- hooks ----------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        """``hook(layer, inputs)`` before ``forward``; what it returns
        (a tuple, or one input) replaces the inputs."""
        helper = HookRemoveHelper(self._forward_pre_hooks)
        self._forward_pre_hooks[helper._id] = hook
        return helper

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after ``forward``; what it
        returns replaces the output."""
        helper = HookRemoveHelper(self._forward_post_hooks)
        self._forward_post_hooks[helper._id] = hook
        return helper

    # --- call -----------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        pre = self.__dict__.get("_forward_pre_hooks")
        post = self.__dict__.get("_forward_post_hooks")
        for hook in list(pre.values()) if pre else ():
            res = hook(self, inputs)
            if res is not None:
                inputs = res if isinstance(res, tuple) else (res,)
        out = self.forward(*inputs, **kwargs)
        for hook in list(post.values()) if post else ():
            res = hook(self, inputs, out)
            if res is not None:
                out = res
        return out

    # --- state dict -----------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        """``{structured name: Parameter or buffer Tensor}``: the
        parameters in registration order, then the persistable
        buffers."""
        dest = OrderedDict() if destination is None else destination
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p
        skip = {(lp + "." if lp else "") + b
                for lp, layer in self.named_sublayers(include_self=True)
                for b in layer._non_persistable_buffer_names}
        for name, b in self.named_buffers(
                include_sublayers=include_sublayers):
            if name not in skip:
                dest[structured_name_prefix + name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry (a Tensor, a torch tensor or an array) into
        the parameter or buffer of that name, in place, cast to its
        dtype; returns ``(missing, unexpected)`` names.  A shape
        mismatch raises ``ValueError``."""
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        for k, v in state_dict.items():
            if k not in own:
                continue
            target = own[k]._value
            if isinstance(v, Tensor):
                v = v._value
            src = (v if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.array(v, copy=True)))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {k}: checkpoint "
                    f"{tuple(src.shape)} vs model {tuple(target.shape)}")
            preserve_saved(target)
            with torch.no_grad():
                target.copy_(src.to(target.dtype))
            own[k]._inplace_version += 1
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def full_name(self):
        return self._name_scope

    def extra_repr(self):
        return ""

    def __repr__(self):
        lines = []
        for name, layer in self.named_children():
            sub = "\n  ".join(repr(layer).split("\n"))
            lines.append(f"({name}): {sub}")
        main = type(self).__name__ + "(" + self.extra_repr()
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"
