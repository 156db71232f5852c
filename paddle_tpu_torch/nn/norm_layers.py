"""Norm layers — twin of ``paddle_tpu/nn/norm_layers.py``: ``BatchNorm``,
``BatchNorm1D/2D/3D``, ``SyncBatchNorm``, ``LayerNorm``, ``GroupNorm``,
``InstanceNorm1D/2D/3D``, ``LocalResponseNorm`` and ``SpectralNorm``.

A batch norm keeps its running statistics as the persistable buffers
``_mean`` (zeros) and ``_variance`` (ones), f32, on the default place —
the JAX package's ``state_dict`` names — and updates them in place in
training (``nn/functional/norm.py``); ``act="relu"`` folds the ReLU into
the norm's autograd op (``ops/fused_norm.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError
from ..framework.place import default_device
from ..tensor import Tensor
from . import functional as F
from . import initializer as init
from .layer import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


def _affine_params(layer, shape, weight_attr, bias_attr):
    """``weight`` (ones) and ``bias`` (zeros), or None where the attr is
    False."""
    layer.weight = None if weight_attr is False else layer.create_parameter(
        shape=shape, attr=weight_attr, default_initializer=init.Constant(1.0))
    layer.bias = None if bias_attr is False else layer.create_parameter(
        shape=shape, attr=bias_attr, is_bias=True)


class _BatchNormBase(Layer):
    """``act='relu'`` fuses the activation into the norm's autograd op
    (the reference's ``fluid.layers.batch_norm(act=...)``)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, act=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self._fused_act = act
        _affine_params(self, [num_features], weight_attr, bias_attr)
        dev = default_device()
        self.register_buffer("_mean", Tensor(torch.zeros(
            num_features, dtype=torch.float32, device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(
            num_features, dtype=torch.float32, device=dev)))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats, act=self._fused_act)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    """The legacy ``fluid.dygraph.BatchNorm`` signature: ``act`` None or
    ``"relu"`` folds into the norm, any other names an activation of
    ``nn.functional`` applied after it."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        if self._act in (None, "relu"):
            self._fused_act = self._act
            return super().forward(x)
        return getattr(F, self._act)(super().forward(x))


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics span the whole batch.  Inside
    ``distributed.make_sharded_train_step`` it (as every batch norm
    there) takes them over every data slot of the mesh; alone in one
    process it is ``BatchNorm``.  Across processes the statistics'
    all-reduce is not ported (ROADMAP queue 1 item 11), so it raises
    there instead of normalizing with one process's batch."""

    def forward(self, x):
        dist = torch.distributed
        if (self.training and dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise InvalidArgumentError(
                "SyncBatchNorm across processes is not ported yet (ROADMAP "
                "queue 1 item 11)")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        ``SyncBatchNorm`` holding the same parameters and buffers."""
        for name, sub in list(layer._sub_layers.items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                use_global_stats=layer._use_global_stats,
                                act=layer._fused_act)
            new.weight = layer.weight
            new.bias = layer.bias
            new._mean = layer._mean
            new._variance = layer._variance
            return new
        return layer


class LayerNorm(Layer):
    """Normalize over the trailing ``normalized_shape`` axes; ``weight``
    starts at one and ``bias`` at zero (``weight_attr`` / ``bias_attr``
    False: none)."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _affine_params(self, self._normalized_shape, weight_attr, bias_attr)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, " \
               f"epsilon={self._epsilon}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups, self._num_channels = num_groups, num_channels
        self._epsilon, self._data_format = epsilon, data_format
        _affine_params(self, [num_channels], weight_attr, bias_attr)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon, self._momentum = epsilon, momentum
        self._data_format = data_format
        _affine_params(self, [num_features], weight_attr, bias_attr)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``weight / sigma``, ``sigma`` its largest singular value estimated
    by ``power_iters`` steps of power iteration from the parameters
    ``weight_u`` and ``weight_v`` (which it does not update)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            shape=[h], default_initializer=init.Normal(0, 1))
        self.weight_v = self.create_parameter(
            shape=[w], default_initializer=init.Normal(0, 1))

    def forward(self, weight):
        from ..ops.dispatch import apply

        dim, iters, eps = self._dim, self._power_iters, self._eps

        def f(w, u, v):
            wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
            for _ in range(iters):
                v = wm.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = wm @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            sigma = u @ wm @ v
            return w / sigma

        return apply("spectral_norm", f, weight, self.weight_u,
                     self.weight_v)
