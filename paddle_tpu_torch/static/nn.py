"""static.nn — twin of ``paddle_tpu/static/nn.py``: the declarative
layer functions (reference paddle.static.nn, fluid/layers/nn.py) and
control flow (while_op.cc, conditional_block_op.cc).

Each layer function builds its layer (fresh parameters on the default
place) and calls it, so inside ``program_guard`` it records; the
control flow is ``jit.control_flow``'s.  The functions over the fluid
functional surface the port does not have yet (``nn/functional/
extension.py``, the detection ops, the parameter-server embedding)
raise ``InvalidArgumentError`` naming it.
"""
from __future__ import annotations

from ..framework.errors import InvalidArgumentError
from ..jit.control_flow import scan, traced_cond, while_loop  # noqa: F401
from .compat import create_parameter, py_func  # noqa: F401


def _act(out, act):
    if act:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def cond(pred, true_fn=None, false_fn=None, name=None):
    from ..ops.logic import cond as _cond

    return _cond(pred, true_fn, false_fn)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Legacy fluid.layers.fc."""
    from ..nn import Linear
    from ..ops._helpers import to_tensor_like
    from ..ops.manipulation import flatten

    x = to_tensor_like(x)
    xf = flatten(x, num_flatten_dims, -1) if x.ndim > num_flatten_dims + 1 \
        else x
    layer = Linear(xf.shape[-1], size, weight_attr, bias_attr)
    return _act(layer(xf), activation)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    from ..nn import Embedding

    return Embedding(size[0], size[1], padding_idx=padding_idx,
                     weight_attr=param_attr)(input)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-05,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               is_test=False, name=None):
    from ..nn import BatchNorm

    ch = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    layer = BatchNorm(ch, act=act, momentum=momentum, epsilon=epsilon,
                      param_attr=param_attr, bias_attr=bias_attr,
                      data_layout=data_layout)
    if is_test:
        layer.eval()
    return layer(input)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None):
    from ..nn import Conv2D

    in_c = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    layer = Conv2D(in_c, num_filters, filter_size, stride, padding, dilation,
                   groups, weight_attr=param_attr, bias_attr=bias_attr,
                   data_format=data_format)
    return _act(layer(input), act)


def conv2d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", name=None):
    from ..nn import Conv2DTranspose

    in_c = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    layer = Conv2DTranspose(in_c, num_filters, filter_size, stride, padding,
                            dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr,
                            data_format=data_format)
    return _act(layer(input), act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCDHW", name=None):
    from ..nn import Conv3D

    in_c = input.shape[1] if data_format == "NCDHW" else input.shape[-1]
    layer = Conv3D(in_c, num_filters, filter_size, stride, padding, dilation,
                   groups, weight_attr=param_attr, bias_attr=bias_attr,
                   data_format=data_format)
    return _act(layer(input), act)


def conv3d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCDHW", name=None):
    from ..nn import Conv3DTranspose

    in_c = input.shape[1] if data_format == "NCDHW" else input.shape[-1]
    layer = Conv3DTranspose(in_c, num_filters, filter_size, stride, padding,
                            dilation=dilation, groups=groups,
                            weight_attr=param_attr, bias_attr=bias_attr,
                            data_format=data_format)
    return _act(layer(input), act)


def group_norm(input, groups, epsilon=1e-05, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from ..nn import GroupNorm

    ch = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    layer = GroupNorm(groups, ch, epsilon=epsilon, weight_attr=param_attr,
                      bias_attr=bias_attr)
    return _act(layer(input), act)


def instance_norm(input, epsilon=1e-05, param_attr=None, bias_attr=None,
                  name=None):
    from ..nn import InstanceNorm2D

    return InstanceNorm2D(input.shape[1], epsilon=epsilon,
                          weight_attr=param_attr,
                          bias_attr=bias_attr)(input)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ..nn import LayerNorm

    layer = LayerNorm(list(input.shape[begin_norm_axis:]), epsilon=epsilon,
                      weight_attr=param_attr if scale else False,
                      bias_attr=bias_attr if shift else False)
    return _act(layer(input), act)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    from ..nn import PReLU

    n = 1
    if mode == "channel":
        n = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    elif mode == "element":
        n = 1
        for d in x.shape[1:]:
            n *= int(d)
    return PReLU(num_parameters=n, weight_attr=param_attr)(x)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, weight_attr=None, bias_attr=None,
                  name=None):
    from ..nn.functional.conv import deformable_conv

    fs = (filter_size, filter_size) if isinstance(filter_size, int) \
        else tuple(filter_size)
    w = create_parameter([num_filters, x.shape[1] // groups, fs[0], fs[1]],
                         "float32")
    b = (create_parameter([num_filters], "float32", is_bias=True)
         if bias_attr is not False else None)
    return deformable_conv(x, offset, mask, w, bias=b, stride=stride,
                           padding=padding, dilation=dilation,
                           deformable_groups=deformable_groups,
                           groups=groups)


def case(pred_fn_pairs, default=None, name=None):
    """static.nn.case (fluid case op): the first true predicate's
    function runs — a chain of ``cond``."""
    from ..ops.logic import cond as _cond

    if not pred_fn_pairs:
        raise ValueError("case: pred_fn_pairs must be non-empty")

    def build(pairs):
        pred, fn = pairs[0]
        rest = pairs[1:]
        if not rest:
            return fn() if default is None else _cond(pred, fn, default)
        return _cond(pred, fn, lambda: build(rest))

    return build(list(pred_fn_pairs))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """static.nn.switch_case: the branch of ``branch_index`` (a list's
    position or a dict's key) runs; a mismatched index runs ``default``,
    or the last branch without one (the reference's contract).  The
    index is read to the host once; while a Program records it raises,
    as ``cond`` with closures does."""
    from ..ops._helpers import to_tensor_like
    from ..ops.dispatch import _recording_program

    if _recording_program() is not None:
        raise TypeError(
            "switch_case(no-arg closures) is not recordable into a static "
            "Program: use control_flow.traced_cond with explicit operands")
    idx = int(to_tensor_like(branch_index)._value.reshape(-1)[0].item())
    if isinstance(branch_fns, dict):
        fn = branch_fns.get(idx)
        fns = [branch_fns[k] for k in sorted(branch_fns)]
    else:
        fns = list(branch_fns)
        fn = fns[idx] if 0 <= idx < len(fns) else None
    if fn is None:
        fn = default if default is not None else fns[-1]
    return fn()


def _unported(what, where):
    def f(*args, **kwargs):
        raise InvalidArgumentError(
            f"static.nn.{what} needs {where}, which is not ported "
            "(ROADMAP queue 1 item 13)")

    f.__name__ = what
    return f


bilinear_tensor_product = _unported("bilinear_tensor_product",
                                    "nn/functional/extension.py")
row_conv = _unported("row_conv", "ops/misc.py's row_conv")
data_norm = _unported("data_norm", "nn/functional/extension.py")
nce = _unported("nce", "nn/functional/extension.py")
spectral_norm = _unported("spectral_norm", "nn/functional/extension.py")
crf_decoding = _unported("crf_decoding", "nn/functional/extension.py")
multi_box_head = _unported("multi_box_head", "nn/functional/extension.py")
sparse_embedding = _unported("sparse_embedding",
                             "the parameter-server embedding (item 11)")
