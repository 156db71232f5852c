"""ResNet family — twin of ``paddle_tpu/vision/models/resnet.py``
(reference ``python/paddle/vision/models/resnet.py``: BasicBlock :54,
BottleneckBlock :92, ResNet :151, resnet50 :312), with the JAX
package's parameter and buffer names.

``data_format="NHWC"`` runs the whole network channel-last: every conv,
batch norm and pool takes ``[N, H, W, C]`` and hands ATen a
``channels_last`` view (``nn/functional/conv.py``), so no layer copies
its input.  Each batch norm followed by a ReLU is built with
``act="relu"``, one autograd op (``ops/fused_norm.py``), where the
norm layer takes it (``_norm``).

``remat=True`` recomputes each residual block's interior in the
backward from the block's input (``torch.utils.checkpoint``,
non-reentrant), as the JAX package's ``jax.checkpoint``
(``_remat_block``).  The recompute must not update the running
statistics a second time, nor see other ones than the first run saw:
the block's buffers are saved before its first run and put back (in
place) for the recompute, and the values the first run left are
restored after it.  The port's AMP state and its generator's state
(dropout) are carried into the recompute the same way; the generator's
state cannot be read while a CUDA graph captures, so a block holding a
``Dropout`` refuses to be recomputed inside one."""
from __future__ import annotations

import inspect
from contextlib import contextmanager

import torch

from ... import nn
from ...framework.errors import InvalidArgumentError

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2"]


def _norm_kwargs(norm_layer, df, act=None):
    """The keyword arguments ``norm_layer`` takes (a custom norm callable
    may take neither ``data_format`` nor ``act``)."""
    try:
        params = inspect.signature(norm_layer).parameters
        has_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                     for p in params.values())
    except (TypeError, ValueError):
        params, has_kw = {}, False
    kw = {}
    if "data_format" in params or has_kw:
        kw["data_format"] = df
    if act is not None and ("act" in params or has_kw):
        kw["act"] = act
    return kw


def _norm(norm_layer, ch, df, act=None):
    """A norm layer with a following ReLU fused into it where the layer
    takes ``act``; returns ``(layer, relu_was_fused)``."""
    layer = norm_layer(ch, **_norm_kwargs(norm_layer, df, act))
    return layer, act is not None and getattr(layer, "_fused_act",
                                              None) == act


def _amp_fields(state):
    return (state.enabled, state.dtype, state.level, state.custom_white,
            state.custom_black)


def _set_amp_fields(state, fields):
    (state.enabled, state.dtype, state.level, state.custom_white,
     state.custom_black) = fields


def _remat_block(layer, x):
    """``layer._body(x)`` with its interior recomputed in the backward
    (see the module docstring)."""
    from torch.utils.checkpoint import (checkpoint,
                                        set_checkpoint_early_stop)

    from ...amp.auto_cast import amp_state
    from ...framework.random import generator
    from ...tensor import Tensor

    bufs = [b._value for b in layer.buffers()]
    gen = generator(x._value.device)
    saved = {}

    @contextmanager
    def first_run():
        saved["bufs"] = [b.clone() for b in bufs]
        saved["amp"] = _amp_fields(amp_state())
        saved["rng"] = None
        if not (x._value.is_cuda and torch.cuda.is_current_stream_capturing()):
            saved["rng"] = gen.get_state()
        elif any(isinstance(sub, nn.Dropout) for sub in layer.sublayers()):
            raise InvalidArgumentError(
                "remat of a block with dropout inside a CUDA graph: the "
                "generator's state cannot be saved during a capture")
        yield

    @contextmanager
    def recompute():
        state = amp_state()
        after = [b.clone() for b in bufs]
        prev_amp, prev_rng = _amp_fields(state), None
        with torch.no_grad():
            for b, v in zip(bufs, saved["bufs"]):
                b.copy_(v)
        _set_amp_fields(state, saved["amp"])
        if saved["rng"] is not None:
            prev_rng = gen.get_state()
            gen.set_state(saved["rng"])
        try:
            yield
        finally:
            with torch.no_grad():
                for b, v in zip(bufs, after):
                    b.copy_(v)
            _set_amp_fields(state, prev_amp)
            if prev_rng is not None:
                gen.set_state(prev_rng)

    # the recompute runs the whole block: an early stop unwinds it with an
    # exception, which the dispatcher would re-raise as an op's error
    with set_checkpoint_early_stop(False):
        out = checkpoint(lambda v: layer._body(Tensor(v))._value, x._value,
                         use_reentrant=False, preserve_rng_state=False,
                         context_fn=lambda: (first_run(), recompute()))
    return Tensor(out)


class _Block(nn.Layer):
    def forward(self, x):
        if getattr(self, "_remat", False) and torch.is_grad_enabled():
            return _remat_block(self, x)
        return self._body(x)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        df = data_format
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=df)
        self.bn1, self._fused1 = _norm(norm_layer, planes, df, act="relu")
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               data_format=df)
        self.bn2, _ = _norm(norm_layer, planes, df)
        self.downsample = downsample
        self.stride = stride

    def _body(self, x):
        identity = x
        out = self.bn1(self.conv1(x))
        if not self._fused1:
            out = self.relu(out)
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        norm_layer = norm_layer or nn.BatchNorm2D
        df = data_format
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               data_format=df)
        self.bn1, self._fused1 = _norm(norm_layer, width, df, act="relu")
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False,
                               data_format=df)
        self.bn2, self._fused2 = _norm(norm_layer, width, df, act="relu")
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, data_format=df)
        self.bn3, _ = _norm(norm_layer, planes * self.expansion, df)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def _body(self, x):
        identity = x
        out = self.bn1(self.conv1(x))
        if not self._fused1:
            out = self.relu(out)
        out = self.bn2(self.conv2(out))
        if not self._fused2:
            out = self.relu(out)
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ResNet (reference resnet.py:151) of ``depth`` 18, 34, 50, 101 or
    152; ``width`` 128 makes the wide variants."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW",
                 remat=False):
        super().__init__()
        self._remat = remat
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = nn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        self.data_format = df = data_format
        self.conv1 = nn.Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                               padding=3, bias_attr=False, data_format=df)
        self.bn1, self._fused1 = _norm(self._norm_layer, self.inplanes, df,
                                       act="relu")
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1,
                                    data_format=df)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if remat:
            for blk in self.sublayers():
                if isinstance(blk, _Block):
                    blk._remat = True
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1), data_format=df)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        df = self.data_format
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, data_format=df),
                _norm(norm_layer, planes * block.expansion, df)[0],
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer,
                        data_format=df)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, data_format=df))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.bn1(self.conv1(x))
        if not self._fused1:
            x = self.relu(x)
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            from ...ops.manipulation import flatten

            x = self.fc(flatten(x, 1, -1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise InvalidArgumentError(
            "pretrained=True is not ported: the weights need a download "
            "(the JAX package ignores it)")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)
