"""Row-sparse gradients — twin of ``paddle_tpu/sparse_grad.py``, the
SelectedRows analog: an embedding's gradient as (touched rows, row
gradients), and the optimizers' row-wise update over them.

The carrier is torch's own sparse COO gradient of an embedding lookup
(``torch.nn.functional.embedding(sparse=True)``: indices ``[1, N]``,
values ``[N, D]``, one row per id of the batch, uncoalesced), which lies
in the parameter's ``grad``; ``Tensor.grad`` reads it as an
``IndexedSlices``.  Torch's accumulation is the reference's rule
(``paddle_tpu/ops/dispatch.py:299-311``): two sparse backwards
concatenate, a sparse gradient plus a dense one gives a dense one.

Every shape stays static, so nothing is read back to the host:
``merged`` keeps N slots (the reference's ``jnp.unique(size=n)``): the
duplicate ids segment-summed into the first slots in ascending row order,
the padding slots given the out-of-range row ``dense_shape[0]`` and zero
values.  Torch has no scatter that drops an out-of-range row (JAX's
``mode="drop"``; ``index_copy_`` raises on the CPU and asserts on the
card), so the writes mask the padding slots or redirect them onto slot 0
with slot 0's own value; none aliases a real row with another value.

``rows`` are int64 (torch's index dtype; the reference's are int32).
``rowwise_update`` writes the parameter and its accumulators in place
(the reference returns new arrays): the ``[vocab, dim]`` table is never
copied, nor its dense gradient formed."""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

import torch

__all__ = ["IndexedSlices", "embedding_sparse_vjp", "rowwise_update",
           "dense_grads", "sparse_grads_enabled"]


class IndexedSlices:
    """Sparse gradient: ``values[i]`` is the gradient of row ``rows[i]``
    of a ``[dense_shape[0], ...]`` parameter."""

    __slots__ = ("rows", "values", "dense_shape", "stop_gradient")

    def __init__(self, rows, values, dense_shape):
        self.rows = rows              # int64 [N]
        self.values = values          # [N, *dense_shape[1:]]
        self.dense_shape = tuple(dense_shape)
        self.stop_gradient = True

    @classmethod
    def from_coo(cls, g: torch.Tensor) -> "IndexedSlices":
        """A torch sparse COO gradient (indices ``[1, N]``) as slices."""
        return cls(g._indices()[0], g._values(), tuple(g.shape))

    def to_coo(self) -> torch.Tensor:
        """The slices as a torch sparse COO tensor (padding slots become
        zero rows of row 0)."""
        rows, values = self._masked()
        return torch.sparse_coo_tensor(rows[None], values, self.dense_shape)

    def detach(self):
        return self

    @property
    def shape(self):
        return list(self.dense_shape)

    @property
    def dtype(self):
        return self.values.dtype

    def __repr__(self):
        return (f"IndexedSlices(nnz_rows={self.rows.shape[0]}, "
                f"dense_shape={self.dense_shape})")

    def _masked(self):
        """(rows, values) with every out-of-range slot turned into a zero
        row of row 0."""
        valid = self.rows < self.dense_shape[0]
        rows = torch.where(valid, self.rows, torch.zeros_like(self.rows))
        shape = (-1,) + (1,) * (self.values.dim() - 1)
        values = torch.where(valid.view(shape), self.values,
                             torch.zeros_like(self.values))
        return rows, values

    # --- conversions ---------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """The dense gradient, accumulated as the dense lookup's backward
        accumulates it (``index_put_``), so the two sum in one order."""
        rows, values = self._masked()
        out = torch.zeros(self.dense_shape, dtype=values.dtype,
                          device=values.device)
        return out.index_put_((rows,), values, accumulate=True)

    def merged(self) -> "IndexedSlices":
        """Duplicate rows merged (SelectedRows::Merge): N slots, the unique
        rows ascending with their segment-summed values first, then the
        padding slots at row ``dense_shape[0]`` with zero values."""
        n = self.rows.shape[0]
        dev = self.rows.device
        rows, perm = torch.sort(self.rows, stable=True)
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = rows[1:] != rows[:-1]
        seg = torch.cumsum(first, 0) - 1
        urows = torch.full((n,), self.dense_shape[0], dtype=rows.dtype,
                           device=dev).scatter_(0, seg, rows)
        summed = torch.zeros_like(self.values).index_add_(
            0, seg, self.values[perm])
        return IndexedSlices(urows, summed, self.dense_shape)

    def add(self, other):
        """Accumulate with another IndexedSlices (concatenated) or, mixed
        with a dense tensor, the dense sum."""
        if isinstance(other, IndexedSlices):
            return IndexedSlices(torch.cat([self.rows, other.rows]),
                                 torch.cat([self.values, other.values]),
                                 self.dense_shape)
        return self.to_dense() + getattr(other, "_value", other)


class _Mode(threading.local):
    def __init__(self):
        self.dense = False


_mode = _Mode()


def sparse_grads_enabled() -> bool:
    return not _mode.dense


@contextlib.contextmanager
def dense_grads():
    """``embedding(sparse=True)`` gives a dense gradient inside: the hapi
    graphed step, whose reference (a functional ``jax.grad`` outside the
    tape) differentiates the lookup densely."""
    prev = _mode.dense
    _mode.dense = True
    try:
        yield
    finally:
        _mode.dense = prev


def embedding_sparse_vjp(idx, vocab_size, padding_idx=None):
    """The weight-cotangent function of a sparse lookup: ``ct [*, dim]``
    -> ``(flat ids, flat cts)``, the rows of ``padding_idx`` zeroed."""
    flat_idx = idx.reshape(-1).long()

    def wgrad(ct):
        values = ct.reshape(flat_idx.shape[0], -1)
        if padding_idx is not None:
            keep = (flat_idx != padding_idx)[:, None]
            values = torch.where(keep, values, torch.zeros_like(values))
        return flat_idx, values

    return wgrad


def rowwise_update(rule, p: torch.Tensor, slices: IndexedSlices,
                   accs: Dict[str, torch.Tensor], lr, step
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply a dense optimizer rule to the touched rows only (the lazy /
    sparse optimizer kernels): gather the rows of the parameter and its
    accumulators, run ``rule`` on the ``[N, dim]`` slice, write the
    results back in place.  The padding slots of ``merged`` gather the
    last row (the reference's clamp, so a rule that reduces over the
    slice sees what the reference's sees) and are never written."""
    m = slices.merged()
    n_rows = slices.dense_shape[0]
    rows = m.rows
    gather = rows.clamp(max=n_rows - 1)
    p_rows = p[gather]
    acc_rows = {k: v[gather] for k, v in accs.items()}
    new_rows, new_acc_rows = rule(p_rows, m.values.to(p_rows.dtype),
                                  acc_rows, lr, step)
    # padding slots write slot 0's row with slot 0's value
    slot = torch.arange(rows.shape[0], device=rows.device)
    src = torch.where(rows < n_rows, slot, torch.zeros_like(slot))
    dst = rows[src]
    p.index_copy_(0, dst, new_rows[src].to(p.dtype))
    for k, v in accs.items():
        v.index_copy_(0, dst, new_acc_rows[k][src].to(v.dtype))
    return p, accs
