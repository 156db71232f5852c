"""``AmpScaler`` and ``GradScaler`` — twins of
``paddle_tpu/amp/grad_scaler.py``: dynamic loss scaling for fp16.

The JAX package's state machine, kept as it is: ``scale(loss)``
multiplies by the current scale; ``unscale_(opt)`` divides the
optimizer's gradients by it and records, for that optimizer, whether any
of them is non-finite; ``step(opt)`` unscales if that was not done and
runs ``opt.step()`` only when the record is finite; ``update()`` halves
the scale (``decr_ratio``, never below 1) after ``decr_every_n_nan_or_inf``
bad steps and doubles it (``incr_ratio``) after ``incr_every_n_steps``
good ones.  ``unscale_`` twice, or ``step`` twice, without an
``update()`` between raises; ``enable=False`` passes everything
through.

The reference reads ``isfinite`` back once per parameter; here the
gradients are unscaled on their device (``g.float() * (1 / scale)``,
written back in the gradient's dtype) and one reduction over all of them
gives one flag, which ``step`` reads to the host once: a ``step()`` costs
one host read whatever the number of parameters.  A row-sparse gradient
has its values unscaled (reference ``amp/grad_scaler.py:52-66``).
"""
from __future__ import annotations

import torch

from ..tensor import Tensor, graph_consumed

__all__ = ["AmpScaler", "GradScaler"]


def _grads(optimizer):
    """The gradients of the optimizer's parameters that have one."""
    return [p.grad for p in optimizer._param_list() if p.grad is not None]


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # this cycle's record per optimizer (id -> a bool, or the device
        # flag until step() reads it) and the optimizers already stepped;
        # update() clears both
        self._unscaled: dict = {}
        self._stepped: set = set()

    def scale(self, var):
        """``var`` times the current scale (a port Tensor or a torch
        tensor, returned as the same kind)."""
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide ``optimizer``'s gradients by the scale in place and
        record whether any is non-finite (on the device: nothing is read
        back here)."""
        if not self._enable:
            return
        if id(optimizer) in self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer since "
                "the last update()")
        inv = 1.0 / self._scale
        finite = []
        for g in _grads(optimizer):
            if g.is_sparse:   # a row-sparse gradient: its values
                g = g._values()
            u = g.float() * inv
            finite.append(torch.isfinite(u).all())
            g.copy_(u)
        found = (~torch.stack(finite).all() if finite else False)
        self._unscaled[id(optimizer)] = found
        self._found_inf = found

    def _read(self, optimizer) -> bool:
        """The optimizer's record as a host bool (the one read)."""
        found = self._unscaled[id(optimizer)]
        if isinstance(found, torch.Tensor):
            found = bool(found)
            self._unscaled[id(optimizer)] = found
        return found

    def minimize(self, optimizer, scaled_loss):
        """``scaled_loss.backward()`` while its graph has not been
        consumed (the rule of ``Optimizer.minimize``), then ``step`` and
        ``update``."""
        if not graph_consumed(scaled_loss):
            (scaled_loss if isinstance(scaled_loss, Tensor)
             else Tensor(scaled_loss)).backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if id(optimizer) in self._stepped:
            raise RuntimeError(
                "step() has already been called on this optimizer since the "
                "last update()")
        if id(optimizer) not in self._unscaled:
            self.unscale_(optimizer)
        self._stepped.add(id(optimizer))
        if not self._read(optimizer):
            optimizer.step()

    def update(self):
        # an inf in ANY optimizer unscaled this cycle marks the step bad
        if self._unscaled:
            self._found_inf = any(bool(v) for v in self._unscaled.values())
        self._unscaled.clear()
        self._stepped.clear()
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, d):
        self._scale = d.get("scale", self._scale)
        self._good_steps = d.get("good_steps", 0)
        self._bad_steps = d.get("bad_steps", 0)


class GradScaler(AmpScaler):
    def get_incr_ratio(self):
        return self._incr_ratio

    def set_incr_ratio(self, v):
        self._incr_ratio = v

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_decr_ratio(self, v):
        self._decr_ratio = v
