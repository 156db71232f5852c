"""The fluid-era top-level names — twin of ``paddle_tpu/compat.py``:
thin implementations over the ported ops in fluid's argument spellings
(``dim`` / ``keep_dim``, ``elementwise_*``'s mid-axis broadcast), the
legacy type names and the CUDA helpers.

``get_tensor_from_selected_rows`` densifies a row-sparse gradient
(``IndexedSlices``).  The static-mode names (``enable_dygraph``,
``disable_dygraph``, ``in_dygraph_mode``) flip ``static/_mode.py``'s
switch; ``create_global_var`` makes a persistent non-parameter
Tensor.
``flops`` counts the multiply-adds of the matmuls and convolutions of
one forward (``torch.utils.flop_counter``), where the reference asks
XLA's cost model of the compiled forward, which also counts the
elementwise work: the two counts differ by design."""
from __future__ import annotations

import numpy as np
import torch

from .tensor import Tensor

__all__ = ["cast", "mv", "addmm", "rank", "shape", "has_inf", "has_nan",
           "tanh_", "scatter_", "fill_constant", "crop_tensor",
           "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "elementwise_add", "elementwise_sub",
           "elementwise_div", "elementwise_mod", "elementwise_pow",
           "elementwise_floordiv", "elementwise_mul", "set_printoptions",
           "get_cuda_rng_state", "set_cuda_rng_state", "get_cudnn_version",
           "VarBase", "LoDTensor", "LoDTensorArray",
           "monkey_patch_math_varbase", "monkey_patch_variable", "flops",
           "get_tensor_from_selected_rows", "enable_dygraph",
           "disable_dygraph", "in_dygraph_mode", "create_global_var"]


def _t(x):
    from .ops._helpers import to_tensor_like

    return to_tensor_like(x)


def cast(x, dtype):
    """paddle.cast (fluid layers.cast)."""
    return _t(x).astype(dtype)


def mv(x, vec, name=None):
    """Matrix-vector product."""
    from .ops import linalg

    return linalg.matmul(_t(x), _t(vec))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """``beta * input + alpha * (x @ y)``."""
    from .ops import linalg, math

    return math.add(math.scale(_t(input), beta),
                    math.scale(linalg.matmul(_t(x), _t(y)), alpha))


def rank(input):
    """A 0-d int32 tensor holding the input's number of axes."""
    x = _t(input)
    return Tensor(torch.full((), x.ndim, dtype=torch.int32,
                             device=x._value.device))


def shape(input):
    """An int32 tensor holding the input's shape (on its device)."""
    x = _t(input)
    return Tensor(torch.tensor(x.shape, dtype=torch.int32).to(
        x._value.device))


def has_inf(x):
    return Tensor(torch.isinf(_t(x)._value).any())


def has_nan(x):
    return Tensor(torch.isnan(_t(x)._value).any())


def tanh_(x):
    """In-place tanh: the op's result adopted by x."""
    from .ops import math

    x = _t(x)
    return x._replace_from(math.tanh(x))


def scatter_(x, index, updates, overwrite=True, name=None):
    """In-place scatter."""
    from .ops import manipulation

    x = _t(x)
    return x._replace_from(manipulation.scatter(
        x, _t(index), _t(updates), overwrite=overwrite))


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    """fluid layers.fill_constant."""
    from .ops import creation

    res = creation.full(shape, value, dtype=dtype)
    if out is not None:
        return out._replace_from(res)
    return res


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """fluid layers.create_global_var: a persistent (non-parameter)
    Tensor filled with ``value`` (``persistable`` and ``force_cpu`` are
    accepted: every Tensor persists while referenced)."""
    from .ops import creation

    t = creation.full(shape, value, dtype=dtype)
    t.stop_gradient = True
    if name:
        t.name = name
    return t


def enable_dygraph(place=None):
    """Leave static mode (dygraph is the default)."""
    from .static import _mode

    _mode.disable_static()


def disable_dygraph():
    """Enter static mode (``paddle.enable_static``)."""
    from .static import _mode

    _mode.enable_static()


def in_dygraph_mode():
    from .static import _mode

    return not _mode.static_mode_enabled()


def crop_tensor(x, shape=None, offsets=None, name=None):
    """A window of ``shape`` at ``offsets`` (-1 in ``shape``: to the end
    of that axis)."""
    x = _t(x)
    if shape is None:
        shape = list(x.shape)
    shape = [int(s) for s in np.asarray(shape).reshape(-1)]
    offsets = ([0] * len(shape) if offsets is None
               else [int(o) for o in np.asarray(offsets).reshape(-1)])
    shape = [x.shape[i] - offsets[i] if s == -1 else s
             for i, s in enumerate(shape)]
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


def _fluid_reduce(op_name):
    def f(input, dim=None, keep_dim=False, name=None):
        from .ops import math

        return getattr(math, op_name)(_t(input), axis=dim, keepdim=keep_dim)

    f.__name__ = "reduce_" + op_name
    f.__doc__ = f"fluid layers.reduce_{op_name} (dim / keep_dim spelling)."
    return f


reduce_sum = _fluid_reduce("sum")
reduce_mean = _fluid_reduce("mean")
reduce_max = _fluid_reduce("max")
reduce_min = _fluid_reduce("min")
reduce_prod = _fluid_reduce("prod")


def _fluid_elementwise(op_name):
    def f(x, y, axis=-1, act=None, name=None):
        from .ops import manipulation, math

        x, y = _t(x), _t(y)
        if 0 <= axis and y.ndim < x.ndim:
            # fluid's mid-axis broadcast: y aligns at ``axis``, trailing
            # unit axes appended (the NCHW bias add)
            y = manipulation.reshape(
                y, list(y.shape) + [1] * (x.ndim - axis - y.ndim))
        out = getattr(math, op_name)(x, y)
        if act is not None:
            from .nn import functional as F

            out = getattr(F, act)(out)
        return out

    f.__name__ = "elementwise_" + op_name
    return f


elementwise_add = _fluid_elementwise("add")
elementwise_sub = _fluid_elementwise("subtract")
elementwise_div = _fluid_elementwise("divide")
elementwise_mod = _fluid_elementwise("mod")
elementwise_pow = _fluid_elementwise("pow")
elementwise_floordiv = _fluid_elementwise("floor_divide")
elementwise_mul = _fluid_elementwise("multiply")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Numpy's print options (a Tensor's repr prints its numpy value)."""
    kw = {}
    if precision is not None:
        kw["precision"] = int(precision)
    if threshold is not None:
        kw["threshold"] = int(threshold)
    if edgeitems is not None:
        kw["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        kw["linewidth"] = int(linewidth)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def get_cuda_rng_state():
    """The port's device generators' states (``framework.random``)."""
    from .framework import random as _r

    return _r.get_rng_state()


def set_cuda_rng_state(state):
    from .framework import random as _r

    _r.set_rng_state(state)


def get_cudnn_version():
    """cuDNN's version as an int, or None without cuDNN."""
    if not torch.backends.cudnn.is_available():
        return None
    return torch.backends.cudnn.version()


VarBase = Tensor
LoDTensor = Tensor


class LoDTensorArray(list):
    """fluid's LoDTensorArray: a list of tensors."""


def get_tensor_from_selected_rows(x, name=None):
    """A row-sparse gradient (``IndexedSlices``) as its dense Tensor; any
    other value as a Tensor."""
    from .sparse_grad import IndexedSlices

    if isinstance(x, IndexedSlices):
        return Tensor(x.to_dense())
    return _t(x)


def monkey_patch_math_varbase():
    """Nothing to do: the operators are bound when the package loads."""


def monkey_patch_variable():
    """Nothing to do: see monkey_patch_math_varbase."""


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The floating-point operations of one forward of ``net`` on a zero
    f32 input of ``input_size`` (on the parameters' device): two per
    multiply-add of each matmul and convolution, as
    ``torch.utils.flop_counter`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    params = list(net.parameters())
    dev = params[0]._value.device if params else None
    x = Tensor(torch.zeros(tuple(input_size), dtype=torch.float32,
                           device=dev))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            net(x)
    finally:
        if was_training:
            net.train()
    total = int(counter.get_total_flops())
    if print_detail:
        print(f"Total Flops: {total}  (matmuls and convolutions of one "
              f"forward, input {list(input_size)})")
    return total
