"""``jit.save`` / ``jit.load`` — twin of ``paddle_tpu/jit/save_load.py``
(reference: paddle.jit.save, fluid/dygraph/jit.py; dygraph/io.py
TranslatedLayer): an inference program and its weights that reload
WITHOUT the model's Python class.

The artifact has the reference's three parts:

- ``<path>.pdmodel``: a ``torch.export`` program (``torch.export.save``)
  of the Layer's eval-mode forward, traced with ``strict=False`` over
  ``jit.functional_call`` under ``framework.export_compat.export_scope``
  — the attention is the ``paddle_tpu_torch::attention`` operator, whose
  route (the flash kernels or the plain one) is decided when the program
  runs, and converted control flow is ``torch.cond`` / ``while_loop``.
  The weights are inputs of the program, not constants in it;
- ``<path>.pdiparams``: the pickled ``{name: numpy array}`` state
  (parameters, then buffers), the JAX package's layout;
- ``<path>.pdmeta``: the input and output names, the op-version map,
  and what the port needs to call the program: the state's names in
  order, each input's shape and dtype and the output tree.

Shapes are static (``InputSpec`` dims must be ints), as in the JAX
package: the exported batch is the predictor's bucket
(``inference/predictor.py``).  ``load`` moves the program to its device
(the default place unless ``device=`` says otherwise) with
``move_to_device_pass``, so an artifact saved on the CPU runs on the
card and one saved on the card runs on the CPU.  Importing this module
registers the attention operator, so a fresh process can load.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..framework.export_compat import export_scope, torch_export
from ..nn.layer import Layer
from ..ops import attention as _attention  # noqa: F401  (registers the op)
from ..tensor import Tensor
from .functional import functional_call, get_state

__all__ = ["save", "load", "TranslatedLayer", "load_artifact"]

_PDMODEL_SUFFIX = ".pdmodel"
_PDPARAMS_SUFFIX = ".pdiparams"
_PDMETA_SUFFIX = ".pdmeta"


def _example(spec, device):
    """A real zero input of ``spec``'s shape and dtype (an InputSpec or a
    Tensor)."""
    from .to_static import InputSpec

    if isinstance(spec, Tensor):
        shape, dtype = tuple(spec.shape), spec.dtype
    elif isinstance(spec, InputSpec):
        shape, dtype = spec.shape, spec.dtype
    else:
        raise TypeError(f"bad input spec {spec!r}")
    if any(d is None or int(d) < 0 for d in shape):
        raise ValueError(
            f"jit.save needs static shapes, got {shape}: the exported "
            "batch is the predictor's bucket (smaller batches are padded, "
            "larger ones chunked)")
    return torch.zeros(tuple(int(d) for d in shape), dtype=dtype,
                       device=device)


def save(layer, path, input_spec=None, **configs):
    """Export ``layer``'s eval-mode forward at ``input_spec`` (a list of
    InputSpec or Tensors) as ``<path>.pdmodel`` / ``.pdiparams`` /
    ``.pdmeta``."""
    from ..framework.op_version import op_version_registry
    from ..framework.place import default_device

    if input_spec is None:
        raise ValueError("jit.save requires input_spec (the exported "
                         "shapes are static)")
    ex = torch_export()
    params, buffers = get_state(layer)
    names = list(params) + list(buffers)
    n_params = len(params)
    state = tuple(v.detach() for v in [*params.values(), *buffers.values()])
    device = state[0].device if state else default_device()
    args = [_example(s, device) for s in input_spec]
    out_spec = {}

    class Infer(torch.nn.Module):
        def forward(self, state_vals, *xs):
            p = dict(zip(names[:n_params], state_vals[:n_params]))
            b = dict(zip(names[n_params:], state_vals[n_params:]))
            out, _ = functional_call(layer, p, b, xs, training=False)
            leaves, out_spec["spec"] = pytree.tree_flatten(out)
            return tuple(leaves)

    with torch.no_grad(), export_scope():
        prog = ex.export(Infer(), (state, *args), strict=False)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    ex.save(prog, path + _PDMODEL_SUFFIX)
    with open(path + _PDPARAMS_SUFFIX, "wb") as f:
        pickle.dump({n: Tensor(v).numpy() for n, v in zip(names, state)}, f,
                    protocol=4)
    input_names = [getattr(s, "name", None) or f"x{i}"
                   for i, s in enumerate(input_spec)]
    n_out = out_spec["spec"].num_leaves
    with open(path + _PDMETA_SUFFIX, "wb") as f:
        pickle.dump({"input_names": input_names,
                     "output_names": [f"out_{i}" for i in range(n_out)],
                     "op_version_map": op_version_registry.version_map(),
                     "state_names": names,
                     "input_specs": [(tuple(a.shape), str(a.dtype))
                                     for a in args],
                     "out_spec": pytree.treespec_dumps(out_spec["spec"])},
                    f, protocol=4)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name.replace("torch.", ""))


def load_artifact(prefix, device, params_file=None):
    """``(program callable, state tuple on device, meta)`` of a saved
    artifact; the op-version map is checked against this build."""
    import warnings

    from ..framework.op_version import op_version_registry

    ex = torch_export()
    prog = ex.move_to_device_pass(ex.load(prefix + _PDMODEL_SUFFIX), device)
    with open(params_file or prefix + _PDPARAMS_SUFFIX, "rb") as f:
        arrays = pickle.load(f)
    with open(prefix + _PDMETA_SUFFIX, "rb") as f:
        meta = pickle.load(f)
    saved = meta.get("op_version_map")
    if saved is not None:
        for msg in op_version_registry.check_compat(saved):
            warnings.warn(f"loaded program compat: {msg}", stacklevel=3)
    state = tuple(torch.from_numpy(np.array(arrays[n], copy=True)).to(device)
                  for n in meta["state_names"])
    meta["input_specs"] = [(tuple(s), _torch_dtype(d))
                           for s, d in meta["input_specs"]]
    meta["out_spec"] = pytree.treespec_loads(meta["out_spec"])
    return prog, state, meta


class TranslatedLayer(Layer):
    """A reloaded inference program (reference fluid/dygraph/io.py
    TranslatedLayer): ``forward`` runs the saved program on its device
    and returns Tensors in the saved output structure (or the outputs
    ``onnx.export(output_spec=)`` kept)."""

    def __init__(self, program, state, meta, device):
        super().__init__()
        self._program = program
        self._fn = program.module()
        self._state = state
        self._meta = meta
        self._device = device
        self._output_indices = meta.get("output_indices")

    def forward(self, *args):
        xs = []
        for a, (_, dtype) in zip(args, self._meta["input_specs"]):
            v = a._value if isinstance(a, Tensor) else torch.as_tensor(
                np.asarray(a))
            xs.append(v.to(device=self._device, dtype=dtype))
        with torch.no_grad():
            leaves = list(self._fn(self._state, *xs))
        if self._output_indices is not None:
            out = [Tensor(leaves[i]) for i in self._output_indices]
            return out[0] if len(out) == 1 else out
        return pytree.tree_unflatten([Tensor(v) for v in leaves],
                                     self._meta["out_spec"])

    def program(self):
        """The ``torch.export`` program."""
        return self._program


def load(path, **configs):
    """Reload a ``jit.save`` artifact as a :class:`TranslatedLayer` on
    ``configs["device"]`` (the default place when absent)."""
    from ..framework.place import to_device

    device = to_device(configs.get("device"))
    prog, state, meta = load_artifact(path, device)
    return TranslatedLayer(prog, state, meta, device)
