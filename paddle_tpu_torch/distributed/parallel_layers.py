"""Tensor-parallel layers — twin of ``paddle_tpu/distributed/parallel_layers.py``
(reference: paddle.distributed.split collective.py:737,771,811 — parallel
embedding, row-parallel linear, column-parallel linear).

Port ``nn.Layer``s with paddle's ``[in, out]`` weight layout.  Each
weight holds one slot's shard and carries its ``partition_spec`` over the
``mp`` axis.  Inside a :func:`~.mesh.shard_map` body the layers run their
collectives over that axis (``distributed.lax``); eagerly (one process,
no body) the spec is metadata and the layer computes on its shard alone,
as in the JAX package.
"""
from __future__ import annotations

import torch

from ..nn import functional as F
from ..nn import initializer as init
from ..nn.layer import Layer
from ..ops._helpers import to_tensor_like
from ..ops.dispatch import apply
from . import lax
from .env import get_rank
from .mesh import in_shard_map, mesh_axis_size

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "split"]


class ColumnParallelLinear(Layer):
    """Weight [in, out/mp]; forward: local matmul; ``gather_output`` →
    all-gather over 'mp' (reference _c_split/_c_concat pattern,
    collective.py:811)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, axis_name="mp",
                 name=None):
        super().__init__()
        self.axis_name = axis_name
        self.gather_output = gather_output
        nparts = max(mesh_axis_size(axis_name), 1)
        assert out_features % nparts == 0
        self.out_per_part = out_features // nparts
        self.weight = self.create_parameter(
            [in_features, self.out_per_part], attr=weight_attr,
            default_initializer=init.XavierNormal())
        self.weight.partition_spec = (None, axis_name)
        self.bias = (self.create_parameter([self.out_per_part], is_bias=True)
                     if has_bias else None)
        if self.bias is not None:
            self.bias.partition_spec = (axis_name,)

    def forward(self, x):
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output and in_shard_map():
            out = apply("c_concat", lambda v: lax.all_gather(
                v, self.axis_name, axis=v.dim() - 1, tiled=True), out)
        return out


class RowParallelLinear(Layer):
    """Weight [in/mp, out]; the input comes split (or is split here);
    local matmul, then psum over 'mp'."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, axis_name="mp",
                 name=None):
        super().__init__()
        self.axis_name = axis_name
        self.input_is_parallel = input_is_parallel
        nparts = max(mesh_axis_size(axis_name), 1)
        assert in_features % nparts == 0
        self.in_per_part = in_features // nparts
        self.weight = self.create_parameter(
            [self.in_per_part, out_features], attr=weight_attr,
            default_initializer=init.XavierNormal())
        self.weight.partition_spec = (axis_name, None)
        self.bias = (self.create_parameter([out_features], is_bias=True)
                     if has_bias else None)
        if self.bias is not None:
            self.bias.partition_spec = (None,)

    def forward(self, x):
        x = to_tensor_like(x)
        inside = in_shard_map()
        if not self.input_is_parallel and inside:
            def local_slice(v):
                idx = lax.axis_index(self.axis_name)
                return v.narrow(v.dim() - 1, idx * self.in_per_part,
                                self.in_per_part)

            x = apply("c_split", local_slice, x)
        out = F.linear(x, self.weight, None)
        if inside:
            out = apply("mp_allreduce_sum",
                        lambda v: lax.psum(v, self.axis_name), out)
        if self.bias is not None:
            out = out + self.bias
        return out


def _masked_lookup(idx, w, lo, per_part):
    """Rows of ``w`` for the ids in ``[lo, lo + per_part)``, zeros for
    the others (another slot holds them)."""
    local = idx.long() - lo
    valid = (local >= 0) & (local < per_part)
    emb = w[local.clamp(0, per_part - 1)]
    return torch.where(valid[..., None], emb, torch.zeros_like(emb))


class VocabParallelEmbedding(Layer):
    """Row-split embedding table + psum (reference parallel embedding,
    collective.py:737)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 axis_name="mp", name=None):
        super().__init__()
        self.axis_name = axis_name
        nparts = max(mesh_axis_size(axis_name), 1)
        assert num_embeddings % nparts == 0
        self.per_part = num_embeddings // nparts
        self.num_embeddings = num_embeddings
        self.weight = self.create_parameter(
            [self.per_part, embedding_dim], attr=weight_attr,
            default_initializer=init.XavierNormal())
        self.weight.partition_spec = (axis_name, None)

    def forward(self, x):
        x = to_tensor_like(x)
        if in_shard_map():
            def f(idx, w):
                lo = lax.axis_index(self.axis_name) * self.per_part
                return lax.psum(_masked_lookup(idx, w, lo, self.per_part),
                                self.axis_name)

            return apply("parallel_embedding", f, x, self.weight)

        # eager (one participant): the same masked local lookup — ids
        # outside this rank's rows give zeros (the psum across ranks would
        # fill them in), never an out-of-range read
        return apply("parallel_embedding",
                     lambda idx, w: _masked_lookup(
                         idx, w, get_rank() * self.per_part, self.per_part),
                     x, self.weight)


class ParallelCrossEntropy(Layer):
    """Vocab-parallel softmax cross entropy over the 'mp' axis: max/psum
    over shards without the full vocab logits on one slot."""

    def __init__(self, axis_name="mp", ignore_index=-100, name=None):
        super().__init__()
        self.axis_name = axis_name
        self.ignore_index = ignore_index

    def forward(self, logits, label):
        logits, label = to_tensor_like(logits), to_tensor_like(label)
        axis_name = self.axis_name
        if not in_shard_map():
            return F.cross_entropy(logits, label, reduction="none")
        per_part = logits.shape[-1]

        def f(z, y):
            zf = z.float()
            m = lax.pmax(zf.max(dim=-1, keepdim=True).values, axis_name)
            e = torch.exp(zf - m)
            denom = lax.psum(e.sum(dim=-1, keepdim=True), axis_name)
            lo = lax.axis_index(axis_name) * per_part
            local = y.long() - lo
            valid = (local >= 0) & (local < per_part)
            zy = torch.gather(zf, -1, local.clamp(0, per_part - 1)[..., None])
            zy = torch.where(valid, zy[..., 0], torch.zeros_like(zy[..., 0]))
            zy = lax.psum(zy, axis_name)
            return (torch.log(denom[..., 0]) + m[..., 0]) - zy

        return apply("parallel_cross_entropy", f, logits, label)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """reference paddle.distributed.split (collective.py:811): build and
    apply a parallel layer in one call."""
    if operation == "linear":
        in_f, out_f = size
        if axis == 0:
            layer = RowParallelLinear(in_f, out_f, weight_attr,
                                      has_bias=bias_attr is not False)
        else:
            layer = ColumnParallelLinear(in_f, out_f, weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
        return layer(x)
    if operation == "embedding":
        num_emb, emb_dim = size
        layer = VocabParallelEmbedding(num_emb, emb_dim, weight_attr)
        return layer(x)
    raise ValueError(f"unknown split operation {operation!r}")
