"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its layout module for module (``paddle_tpu_torch/text/generation.py`` is
the twin of ``paddle_tpu/text/generation.py``) and imports only ``torch``
and numpy.  Every Pallas kernel on a ported path has a hand-written
CUDA twin under ``ops/csrc/``; plain tensor code is PyTorch.

``import paddle_tpu_torch as paddle`` serves a paddle-style eager
program, as ``paddle_tpu/__init__.py`` does: the dtypes and places, the
flat op namespace (creation, math, manipulation, logic, search, linalg
and random ops, ``paddle.weight_only_matmul`` on the int8 matmul
kernel), ``Tensor`` with the method form of every op, ``no_grad`` and
``grad``, ``save`` / ``load``, ``ParamAttr``, the fluid-era names of
``compat``, and the subpackages (``nn``, ``optimizer``, ``amp``, ``io``,
``text``, ``vision``, ``Model``, ...).  The declarative half is here
too: ``static`` (Program / Executor), ``jit`` (``to_static``, ``save``,
``load``), ``inference`` (``create_predictor``) and ``onnx``, with the
top-level ``data``, ``to_static``, ``enable_static`` /
``disable_static`` and ``in_dynamic_mode``, and ``DataParallel``
(``distributed/parallel.py``).

Device policy: entry points run on the default place, which is the CUDA
card; without one they raise instead of falling back to the CPU.
``set_device("cpu")`` (or an explicit ``device="cpu"`` / ``place``) asks
for the CPU, where every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    A CUDA device without a card raises — the port never silently runs a
    GPU entry point on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False — pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        # pin the index, so "cuda" and the tensors' "cuda:0" compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# framework primitives
from .framework import (  # noqa: E402,F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace, XPUPlace, bfloat16,
    bool_, complex64, complex128, float16, float32, float64,
    get_default_dtype, get_device, get_flags, int8, int16, int32, int64,
    is_compiled_with_cuda, is_compiled_with_tpu, is_compiled_with_xpu, seed,
    set_default_dtype, set_device, set_flags, uint8)
from .framework.random import get_rng_state, set_rng_state  # noqa: E402,F401
from .tensor import Parameter, Tensor, to_tensor  # noqa: E402,F401

# autograd
from .autograd import (enable_grad, grad, is_grad_enabled,  # noqa: E402,F401
                       no_grad, set_grad_enabled)

# the flat op namespace, as paddle.*
from .ops.creation import *  # noqa: E402,F401,F403
from .ops.math import *  # noqa: E402,F401,F403
from .ops.manipulation import *  # noqa: E402,F401,F403
from .ops.logic import *  # noqa: E402,F401,F403
from .ops.search import *  # noqa: E402,F401,F403
from .ops.linalg import *  # noqa: E402,F401,F403
from .ops.random_ops import *  # noqa: E402,F401,F403
from .ops import linalg  # noqa: E402,F401

# saving and loading
from .framework_io import load, save  # noqa: E402,F401

# subpackages
from . import amp, autograd, distributed, inference, io, jit  # noqa: E402,F401
from . import metric, nn, optimizer, profiler, regularizer  # noqa: E402,F401
from . import onnx, slim, static, text, utils, vision  # noqa: E402,F401
from .static import data  # noqa: E402,F401
from .jit import to_static  # noqa: E402,F401
from .hapi import Model, callbacks, summary  # noqa: E402,F401
from .param_attr import ParamAttr  # noqa: E402,F401
from .distributed.parallel import DataParallel  # noqa: E402,F401
from .compat import (  # noqa: E402,F401
    LoDTensor, LoDTensorArray, VarBase, addmm, cast, create_global_var,
    crop_tensor, disable_dygraph, enable_dygraph, in_dygraph_mode,
    elementwise_add, elementwise_div, elementwise_floordiv, elementwise_mod,
    elementwise_mul, elementwise_pow, elementwise_sub, fill_constant, flops,
    get_cuda_rng_state, get_cudnn_version, get_tensor_from_selected_rows,
    has_inf, has_nan, monkey_patch_math_varbase, monkey_patch_variable, mv, rank, reduce_max,
    reduce_mean, reduce_min, reduce_prod, reduce_sum, scatter_,
    set_cuda_rng_state, set_printoptions, shape, tanh_)


def is_grad_enabled_():  # the reference's private alias
    return is_grad_enabled()


# the mode switches: dygraph (eager) is the default; enable_static makes
# hapi's Model.prepare take the static-graph adapter (static/_mode.py)
from .static import _mode as _static_mode  # noqa: E402


def in_dynamic_mode() -> bool:
    return not _static_mode.static_mode_enabled()


def enable_static():
    _static_mode.enable_static()


def disable_static():
    _static_mode.disable_static()


def _patch_tensor_methods():
    """Attach the ops as Tensor methods (``x.exp()``, ``x.topk(2)``), as
    the reference's ``_patch_tensor_methods`` does (with its skip list
    and in-place aliases); an attribute Tensor has already is kept."""
    from .ops import linalg, logic, manipulation, math, search
    from .ops import random_ops as _random

    skip = {"cond", "is_tensor", "broadcast_shape"}
    for mod in (math, manipulation, logic, search, linalg):
        for name in mod.__all__:
            if name not in skip and not hasattr(Tensor, name):
                setattr(Tensor, name, getattr(mod, name))
    Tensor.add_ = lambda self, y: self._replace_from(math.add(self, y))
    Tensor.subtract_ = lambda self, y: self._replace_from(
        math.subtract(self, y))
    Tensor.multiply_ = lambda self, y: self._replace_from(
        math.multiply(self, y))
    Tensor.scale_ = lambda self, *a, **k: self._replace_from(
        math.scale(self, *a, **k))
    Tensor.clip_ = lambda self, *a, **k: self._replace_from(
        math.clip(self, *a, **k))
    Tensor.zero_ = lambda self: self.set_value(torch.zeros_like(self._value))
    Tensor.fill_ = lambda self, v: self.set_value(
        torch.full_like(self._value, v))
    Tensor.uniform_ = _random.uniform_
    Tensor.normal_ = _random.normal_
    Tensor.exponential_ = _random.exponential_
    Tensor.mm = linalg.mm
    Tensor.matmul = linalg.matmul
    Tensor.dot = linalg.dot
    Tensor.norm = linalg.norm


_patch_tensor_methods()
del _patch_tensor_methods
