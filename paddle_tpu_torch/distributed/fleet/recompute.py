"""Activation recompute — twin of
``paddle_tpu/distributed/fleet/recompute.py`` (reference: backward.py:725
_append_backward_ops_with_checkpoints_ + RecomputeOptimizer
fluid/optimizer.py:4818; RecomputeConfig proto:25).

Where the JAX package wraps the segment in ``jax.checkpoint``, the port
runs it under ``torch.utils.checkpoint`` in its reentrant form: the
forward runs without recording a graph, and the backward runs the
segment again with grad and backpropagates through that run.  (The
non-reentrant form finds the activations to drop through
``saved_tensors_hooks``, and the port's dispatcher installs hooks of its
own around every op, which would hide them: nothing would be recomputed.)
The port's dropout draws from its own generator (``framework.random``),
which torch's ``preserve_rng_state`` does not cover, so the recompute
carries that generator's state itself (with ``preserve_rng_state``, the
default), and the AMP state, into the second run; a layer's buffers are
put back to what the first run saw for the second run and restored after
it, so a batch norm's statistics move once.  Parameters, a Layer's or a
closure's, get their gradients from the second run's backward.
"""
from __future__ import annotations

import torch

from ...tensor import Tensor

__all__ = ["recompute", "RecomputeSequential"]


def _unwrap(tree):
    if isinstance(tree, Tensor):
        return tree._value
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unwrap(t) for t in tree)
    return tree


def _wrap(tree):
    if isinstance(tree, torch.Tensor):
        return Tensor(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_wrap(t) for t in tree)
    return tree


def recompute(function, *args, **kwargs):
    """paddle.distributed.fleet.utils.recompute: run ``function`` (a
    callable or a Layer) on ``args`` with its activations recomputed in
    the backward.  ``preserve_rng_state`` (default True) replays the same
    dropout draws."""
    from torch.utils.checkpoint import checkpoint

    from ...amp.auto_cast import amp_state
    from ...framework.random import generator
    from ...nn.layer import Layer

    preserve = kwargs.pop("preserve_rng_state", True)
    vals = [_unwrap(a) for a in args]
    device = next((v.device for v in vals if isinstance(v, torch.Tensor)),
                  torch.device("cpu"))
    bufs = ([b._value for b in function.buffers()]
            if isinstance(function, Layer) else [])
    gen = generator(device)
    saved = {}

    def fields(state):
        return (state.enabled, state.dtype, state.level, state.custom_white,
                state.custom_black)

    def set_fields(state, f):
        (state.enabled, state.dtype, state.level, state.custom_white,
         state.custom_black) = f

    def run(*vs):
        xs = _wrap(list(vs[:-1]))        # the last is the grad anchor
        if not saved:                    # the first run, without grad
            saved["bufs"] = [b.clone() for b in bufs]
            saved["amp"] = fields(amp_state())
            saved["rng"] = gen.get_state() if preserve else None
            return _unwrap(function(*xs, **kwargs))
        state = amp_state()               # the recompute, with grad
        after = [b.clone() for b in bufs]
        prev_amp, prev_rng = fields(state), None
        with torch.no_grad():
            for b, v in zip(bufs, saved["bufs"]):
                b.copy_(v)
        set_fields(state, saved["amp"])
        if saved["rng"] is not None:
            prev_rng = gen.get_state()
            gen.set_state(saved["rng"])
        try:
            return _unwrap(function(*xs, **kwargs))
        finally:
            with torch.no_grad():
                for b, v in zip(bufs, after):
                    b.copy_(v)
            set_fields(state, prev_amp)
            if prev_rng is not None:
                gen.set_state(prev_rng)

    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    # the reentrant form backpropagates only when an input requires grad:
    # an anchor that does lets a closure's parameters get theirs too
    anchor = torch.zeros((), device=device, requires_grad=True)
    out = checkpoint(run, *vals, anchor, use_reentrant=True,
                     preserve_rng_state=False)
    return _wrap(out)


class RecomputeSequential:
    """Wrap a Sequential's blocks so each block is a recompute segment."""

    def __init__(self, sequential):
        self.sequential = sequential

    def __call__(self, x):
        for layer in self.sequential._sub_layers.values():
            x = recompute(layer, x)
        return x
