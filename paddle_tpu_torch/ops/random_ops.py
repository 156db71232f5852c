"""Random sampling ops — twin of ``paddle_tpu/ops/random_ops.py``.

Every draw comes from the port's generator of the tensor's device
(``framework.random.generator``), so ``paddle.seed`` governs it and a
CUDA graph that registered the generator draws anew at each replay.  A
nonzero ``seed`` argument draws from a fresh generator seeded with it.
The bits are Philox's (CUDA) or the Mersenne Twister's (CPU), not the
reference's threefry bits: only the distributions match.  Creation ops
land on the default place; the in-place forms (``uniform_``,
``normal_``, ``exponential_``) write the tensor's own storage."""
from __future__ import annotations

import torch

from ..framework import dtype as _dt
from ..framework.place import default_device
from ..framework.random import generator
from ..tensor import Tensor, preserve_saved
from ._helpers import norm_shape, resolve_dtype, to_tensor_like, value_of

__all__ = ["rand", "randn", "uniform", "uniform_", "normal", "normal_",
           "standard_normal", "randint", "randint_like", "randperm",
           "multinomial", "bernoulli", "poisson", "exponential_"]


def _gen(device, seed=0):
    if seed:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g
    return generator(device)


def rand(shape, dtype=None, name=None) -> Tensor:
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None) -> Tensor:
    dev = default_device()
    return Tensor(torch.randn(norm_shape(shape), dtype=resolve_dtype(dtype),
                              device=dev, generator=_gen(dev)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,
            name=None) -> Tensor:
    dev = default_device()
    out = torch.empty(norm_shape(shape), dtype=resolve_dtype(dtype),
                      device=dev)
    out.uniform_(float(value_of(min)), float(value_of(max)),
                 generator=_gen(dev, seed))
    return Tensor(out)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    x = to_tensor_like(x)
    v = x._value
    preserve_saved(v)
    with torch.no_grad():
        v.uniform_(min, max, generator=_gen(v.device, seed))
    x._inplace_version += 1
    return x


def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    """Normal draws of the default dtype: ``shape`` with float ``mean`` /
    ``std``, or the broadcast shape of Tensor ones."""
    d = _dt.get_default_dtype()
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = value_of(mean), value_of(std)
        like = m if isinstance(m, torch.Tensor) else s
        shp = torch.broadcast_shapes(
            getattr(m, "shape", ()), getattr(s, "shape", ()))
        z = torch.randn(shp, dtype=d, device=like.device,
                        generator=_gen(like.device))
        return Tensor(z * s + m)
    dev = default_device()
    shp = norm_shape(shape) if shape is not None else ()
    z = torch.randn(shp, dtype=d, device=dev, generator=_gen(dev))
    return Tensor(z * std + mean)


def normal_(x, mean=0.0, std=1.0, name=None):
    x = to_tensor_like(x)
    v = x._value
    preserve_saved(v)
    with torch.no_grad():
        v.normal_(mean, std, generator=_gen(v.device))
    x._inplace_version += 1
    return x


def standard_normal(shape, dtype=None, name=None) -> Tensor:
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype="int64",
            name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    dev = default_device()
    return Tensor(torch.randint(int(low), int(high), norm_shape(shape),
                                dtype=_dt.convert_dtype(dtype), device=dev,
                                generator=_gen(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None) -> Tensor:
    """Integers in ``[low, high)`` of x's shape, on x's device, in
    ``dtype`` (x's by default)."""
    x = to_tensor_like(x)
    v = x._value
    if high is None:
        low, high = 0, low
    d = _dt.convert_dtype(dtype) if dtype is not None else v.dtype
    out = torch.randint(int(low), int(high), v.shape, device=v.device,
                        generator=_gen(v.device))
    return Tensor(out.to(d))


def randperm(n, dtype="int64", name=None) -> Tensor:
    dev = default_device()
    return Tensor(torch.randperm(int(n), dtype=_dt.convert_dtype(dtype),
                                 device=dev, generator=_gen(dev)))


def multinomial(x, num_samples=1, replacement=False, name=None) -> Tensor:
    """int64 draws of category indices from the (unnormalized)
    probabilities of x's last axis."""
    v = to_tensor_like(x)._value
    return Tensor(torch.multinomial(v.float(), num_samples,
                                    replacement=replacement,
                                    generator=_gen(v.device)))


def bernoulli(x, name=None) -> Tensor:
    v = to_tensor_like(x)._value
    return Tensor(torch.bernoulli(v.float(), generator=_gen(v.device))
                  .to(v.dtype))


def poisson(x, name=None) -> Tensor:
    v = to_tensor_like(x)._value
    return Tensor(torch.poisson(v.float(), generator=_gen(v.device))
                  .to(v.dtype))


def exponential_(x, lam=1.0, name=None):
    x = to_tensor_like(x)
    v = x._value
    preserve_saved(v)
    with torch.no_grad():
        v.exponential_(lam, generator=_gen(v.device))
    x._inplace_version += 1
    return x
