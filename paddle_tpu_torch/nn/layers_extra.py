"""The rest of the reference's ``nn`` layer surface — twin of
``paddle_tpu/nn/layers_extra.py``: ``PairwiseDistance``,
``HSigmoidLoss``, ``NCELoss``, ``TreeConv``, ``ctc_greedy_decoder`` and
the fluid ``DynamicRNN`` / ``StaticRNN`` names, whose ``block()`` raises
as the reference's does.  ``HSigmoidLoss``'s ``is_custom`` and
``is_sparse``, which the JAX package accepts and never reads, raise."""
from __future__ import annotations

import torch

from ..framework.errors import InvalidArgumentError
from ..ops._helpers import to_tensor_like
from ..ops.dispatch import apply
from .layer import Layer

__all__ = ["PairwiseDistance", "HSigmoidLoss", "NCELoss", "TreeConv",
           "ctc_greedy_decoder", "DynamicRNN", "StaticRNN"]


class PairwiseDistance(Layer):
    """The p-norm of ``x - y + epsilon`` over the last dim."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        def f(a, b):
            d = a - b + self.epsilon
            out = torch.pow(torch.sum(torch.pow(torch.abs(d), self.p),
                                      dim=-1), 1.0 / self.p)
            return out[..., None] if self.keepdim else out

        return apply("pairwise_distance", f, to_tensor_like(x),
                     to_tensor_like(y))


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid loss owning the tree's ``K-1`` node weights
    ``[K-1, D]`` and bias ``[K-1]`` (``functional.hsigmoid_loss``)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if is_custom or is_sparse:
            raise InvalidArgumentError(
                "HSigmoidLoss(is_custom=, is_sparse=) is not supported: the "
                "JAX package accepts them and never reads them")
        self.num_classes = num_classes
        n_nodes = max(num_classes - 1, 1)
        self.weight = self.create_parameter([n_nodes, feature_size],
                                            attr=weight_attr)
        self.bias = (self.create_parameter([n_nodes], attr=bias_attr,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, input, label):
        from .functional.extension import hsigmoid_loss

        return hsigmoid_loss(input, label, self.num_classes, self.weight,
                             bias=self.bias)


class NCELoss(Layer):
    """NCE loss owning the class embedding ``[K, D]`` and bias ``[K]``
    (``functional.nce``)."""

    def __init__(self, feature_size, num_total_classes, num_neg_samples=10,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.num_total_classes = num_total_classes
        self.num_neg_samples = num_neg_samples
        self.weight = self.create_parameter(
            [num_total_classes, feature_size], attr=weight_attr)
        self.bias = (self.create_parameter([num_total_classes],
                                           attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, input, label):
        from .functional.extension import nce

        return nce(input, label, self.num_total_classes,
                   num_neg_samples=self.num_neg_samples, weight=self.weight,
                   bias=self.bias)


class TreeConv(Layer):
    """Tree-based convolution: node features ``[B, N, D]`` and an edge set
    ``[B, E, 2]`` (parent, child); each node sums its ``max_depth - 1``
    hops of children through the filters ``[D, max_depth, out·filters]``,
    then ``act``."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        self.max_depth = max_depth
        self.weight = self.create_parameter(
            [feature_size, max_depth, output_size * num_filters],
            attr=param_attr)
        self.bias = (self.create_parameter(
            [1, 1, output_size * num_filters], attr=bias_attr,
            is_bias=True) if bias_attr is not False else None)
        self.act = act
        self.output_size = output_size
        self.num_filters = num_filters

    def forward(self, nodes_vector, edge_set):
        depth = self.max_depth

        def f(feat, edges, w, *mb):
            b, n, _ = feat.shape
            adj = torch.zeros((b, n, n), dtype=feat.dtype,
                              device=feat.device)
            src = edges[..., 0].long()
            dst = edges[..., 1].long()
            b_idx = torch.arange(b, device=feat.device)[:, None].expand(
                b, edges.shape[1])
            adj[b_idx, dst, src] = 1.0
            hops, cur = [feat], feat
            for _ in range(depth - 1):
                cur = torch.einsum("bnm,bmd->bnd", adj, cur)
                hops.append(cur)
            out = sum(torch.einsum("bnd,do->bno", h, w[:, i])
                      for i, h in enumerate(hops))
            return out + mb[0] if mb else out

        args = [to_tensor_like(nodes_vector), to_tensor_like(edge_set),
                self.weight]
        if self.bias is not None:
            args.append(self.bias)
        out = apply("tree_conv", f, *args)
        if self.act:
            from . import functional as F

            out = getattr(F, self.act)(out)
        return out


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """Greedy CTC decoding of ``[B, T, C]`` scores: the argmax per step,
    repeats collapsed, blanks dropped; returns the ids left-aligned in a
    ``[B, T]`` int64 tensor padded with ``padding_value`` and each row's
    length."""
    args = [to_tensor_like(input)]
    if input_length is not None:
        args.append(to_tensor_like(input_length))

    def f(v, *maybe_len):
        b, t = v.shape[0], v.shape[1]
        ids = v.argmax(dim=-1)                              # [B, T]
        prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype,
                                     device=ids.device), ids[:, :-1]], dim=1)
        keep = (ids != blank) & (ids != prev)
        steps = torch.arange(t, device=ids.device)[None]
        if maybe_len:
            keep = keep & (steps < maybe_len[0].reshape(-1, 1))
        order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
        packed = torch.gather(ids, 1, order)
        n = keep.sum(dim=1)
        packed = torch.where(steps < n[:, None], packed,
                             torch.full_like(packed, padding_value))
        return packed.long(), n.long()

    return apply("ctc_greedy_decoder", f, *args)


class _FluidRNNBase:
    """``DynamicRNN`` / ``StaticRNN``: the reference's fluid static-graph
    RNN builders, whose ``with rnn.block():`` body is captured into a
    sub-block.  An eager framework cannot re-run a with-block per step,
    so ``block()`` raises with the mapping, as the JAX package's does."""

    def __init__(self, name=None):
        pass

    def block(self):
        raise NotImplementedError(
            f"{type(self).__name__} is the fluid static-graph RNN builder; "
            "write the cell as a function or Layer and run it with "
            "paddle.nn.RNN or a Python loop")

    step = block


DynamicRNN = _FluidRNNBase
StaticRNN = _FluidRNNBase
