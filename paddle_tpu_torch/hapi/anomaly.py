"""Numerical self-healing for the hapi train loop — twin of
``paddle_tpu/hapi/anomaly.py``.

Three graduated responses, cheapest first, as in the JAX package:

1. **Skip-step**: the guarded train step (``Model.fit(anomaly=)``)
   computes ``isfinite(loss) & isfinite(global grad norm)`` on the
   device, inside the step's CUDA graph, and the host reads it with the
   loss in one read.  A non-finite step is discarded: the step made a
   copy of everything it updates in place before it started
   (parameters, accumulators, buffers), and the host copies it back;
   the port's generator, numpy's stream and ``py_random`` rewind to
   their state before the step, so the run goes on as if the poisoned
   batch had never come (``train.anomaly.skipped_steps``).
2. **Spike detection**: a rolling median/MAD detector over the accepted
   losses flags a finite divergence; ``spike_action`` skips it like a
   non-finite step or tolerates it (``train.anomaly.loss_spikes``).
3. **Rollback**: ``rollback_after`` damage events within
   ``rollback_window`` observed steps, or a corrupted parameter named by
   the audit, restore the newest checkpoint of the fit's
   ``TrainCheckpointer`` that passes its per-leaf CRC check and a
   finiteness sweep (others count as
   ``train.anomaly.corrupt_checkpoints``), copied into the live tensors
   in place so a captured step stays valid; the batches that caused the
   damage are passed over on the replay.  ``rollback_budget`` bounds the
   loop: past it, ``FatalError`` with the flight recorder's postmortem.

The **audit** (:class:`ParameterAudit`) sweeps the live parameters on
the device: one ``[n_leaves]`` bool tensor in sorted-name order, read
once (``train.anomaly.audit_ms``).  It catches what the chaos
``corrupt_param`` injects, a non-finite element; a flip that leaves a
value finite is caught at the durability boundary, by the store's
per-leaf CRC records.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..framework.errors import (CheckpointCorruptError,
                                CheckpointIncompatibleError, FatalError,
                                InvalidArgumentError,
                                ParameterCorruptionError)
from ..framework.monitor import histogram_observe, stat_add
from ..profiler.flight_recorder import recorder as flight

__all__ = ["AnomalyPolicy", "LossSpikeDetector", "ParameterAudit",
           "AnomalyRuntime"]

_SPIKE_ACTIONS = ("skip", "tolerate")


@dataclass
class AnomalyPolicy:
    """The knobs of ``Model.fit(anomaly=)`` (``anomaly=True`` takes the
    defaults), with the JAX package's names, defaults and validation:

    - ``spike_window`` / ``spike_k`` / ``spike_warmup``: a finite loss
      above ``median + k * MAD`` of the last ``window`` accepted losses
      is a spike once ``warmup`` losses were seen (``spike_window=0``
      turns detection off);
    - ``spike_action``: ``"skip"`` discards the update like a non-finite
      step, ``"tolerate"`` keeps it and counts the damage;
    - ``rollback_after`` / ``rollback_window``: that many damage events
      within the window roll back to a checkpoint (``None``: skip only,
      no ``checkpoint_dir`` needed);
    - ``rollback_budget``: rollbacks allowed before ``FatalError``;
    - ``audit_interval``: audit the parameters every N trained steps
      (None: only ``audit_on_checkpoint``, after every committed
      checkpoint).
    """

    spike_window: int = 32
    spike_k: float = 10.0
    spike_warmup: int = 8
    spike_action: str = "skip"
    rollback_after: Optional[int] = 3
    rollback_window: int = 16
    rollback_budget: int = 2
    audit_interval: Optional[int] = None
    audit_on_checkpoint: bool = True

    def __post_init__(self):
        if self.spike_action not in _SPIKE_ACTIONS:
            raise InvalidArgumentError(
                f"spike_action must be one of {_SPIKE_ACTIONS}, got "
                f"{self.spike_action!r}")
        if self.spike_window < 0:
            raise InvalidArgumentError("spike_window must be >= 0")
        if self.spike_k <= 0:
            raise InvalidArgumentError("spike_k must be > 0")
        if 0 < self.spike_window < self.spike_warmup:
            # the history holds at most spike_window losses, so a larger
            # warmup would keep detection off while the policy says on
            raise InvalidArgumentError(
                f"spike_warmup ({self.spike_warmup}) exceeds "
                f"spike_window ({self.spike_window}) — the rolling "
                "window can never satisfy the warmup gate, so spike "
                "detection would silently never fire")
        if self.rollback_after is not None and self.rollback_after < 1:
            raise InvalidArgumentError(
                "rollback_after must be >= 1 (or None to disarm)")
        if self.rollback_window < 1:
            raise InvalidArgumentError("rollback_window must be >= 1")
        if self.rollback_budget < 0:
            raise InvalidArgumentError("rollback_budget must be >= 0")
        if self.audit_interval is not None and self.audit_interval < 1:
            raise InvalidArgumentError(
                "audit_interval must be >= 1 (or None)")


class LossSpikeDetector:
    """Rolling median/MAD spike detector over accepted losses.  A spike
    is not admitted into the window (a burst must not raise its own
    baseline); the MAD is floored at 1e-3 of the median's magnitude, so
    a flat plateau does not turn noise into spikes."""

    def __init__(self, window: int, k: float, warmup: int):
        self.window = int(window)
        self.k = float(k)
        self.warmup = max(1, int(warmup))
        self._hist: deque = deque(maxlen=self.window or 1)

    def threshold(self) -> Optional[float]:
        """The spike threshold, or None during warm-up or when off."""
        if self.window <= 0 or len(self._hist) < self.warmup:
            return None
        arr = np.asarray(self._hist, np.float64)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        scale = max(mad, 1e-3 * abs(med), 1e-8)
        return med + self.k * scale

    def observe(self, loss: float) -> bool:
        """Feed one loss; True means a spike (not admitted).  A
        non-finite loss is the guard's business, never a spike."""
        if self.window <= 0 or not np.isfinite(loss):
            return False
        thr = self.threshold()
        if thr is not None and loss > thr:
            return True
        self._hist.append(float(loss))
        return False

    def reset(self):
        self._hist.clear()


class ParameterAudit:
    """Finiteness sweep over the live parameters on their device: one
    ``[n_leaves]`` bool tensor in sorted-name order (the JAX package's
    leaf order), read to the host once.  Integer leaves are clean by
    construction."""

    def corrupted_leaf(self, model) -> Optional[str]:
        """The first parameter (in sorted-name order) holding a
        non-finite value, or None when every leaf is clean."""
        leaves = sorted((name, p._value if hasattr(p, "_value") else p)
                        for name, p in model.network.named_parameters())
        if not leaves:
            return None
        flags = torch.stack([
            torch.isfinite(t).all() if t.is_floating_point()
            else torch.ones((), dtype=torch.bool, device=t.device)
            for _, t in leaves]).cpu().numpy()
        for (name, _), ok in zip(leaves, flags):
            if not ok:
                return name
        return None


class _RollbackRequested(Exception):
    """The fit loop catches it at the epoch boundary and restores the
    newest verified checkpoint."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class AnomalyRuntime:
    """One fit's state machine: consulted after every train step
    (:meth:`on_step_outcome`) and on the audit cadence
    (:meth:`maybe_audit`); raises :class:`_RollbackRequested` when the
    damage crosses the policy's threshold, which the fit loop turns into
    :meth:`perform_rollback`."""

    def __init__(self, policy: AnomalyPolicy, checkpointer=None):
        self.policy = policy
        self.ckpt = checkpointer
        self.spikes = LossSpikeDetector(
            policy.spike_window, policy.spike_k, policy.spike_warmup)
        self.audit = ParameterAudit()
        # (event clock, epoch, batch, poison) of recent damage events
        self._damage: deque = deque()
        self._clock = 0                 # observed steps (trained + skipped)
        self._steps_since_audit = 0
        # (epoch, batch) pairs a post-rollback replay passes over
        self.poisoned = set()
        self.rollbacks_used = 0
        self.skipped_steps = 0
        self.loss_spikes = 0

    # --- damage accounting --------------------------------------------------
    def _note_damage(self, epoch: int, batch: int, kind: str,
                     poison: bool):
        pol = self.policy
        self._damage.append((self._clock, epoch, batch, poison))
        while self._damage and \
                self._clock - self._damage[0][0] >= pol.rollback_window:
            self._damage.popleft()
        if pol.rollback_after is not None \
                and len(self._damage) >= pol.rollback_after:
            n = len(self._damage)
            for _, e, b, p in self._damage:
                if p:
                    self.poisoned.add((e, b))
            self._damage.clear()
            raise _RollbackRequested(
                f"{n} damage events within {pol.rollback_window} steps "
                f"(last: {kind} at epoch {epoch} batch {batch})")

    def on_step_outcome(self, model, outs, *, epoch: int, batch: int,
                        global_step: int) -> str:
        """Classify one finished step: ``"ok"`` keeps the update,
        ``"skip"`` means it was discarded here (the caller rewinds the
        generators).  Raises :class:`_RollbackRequested` when the damage
        window fills."""
        self._clock += 1
        guard = model._last_guard
        pol = self.policy
        if guard is not None and not guard["ok"]:
            self.skipped_steps += 1
            stat_add("train.anomaly.skipped_steps", 1)
            flight.on_transition(
                "train.anomaly", "skip",
                f"non-finite step (loss={guard['loss']}, "
                f"grad_norm={guard['grad_norm']}) at epoch {epoch} "
                f"batch {batch}")
            model._discard_step()
            self._note_damage(epoch, batch, "nonfinite", poison=True)
            return "skip"
        loss = float(outs[0])
        if self.spikes.observe(loss):
            self.loss_spikes += 1
            stat_add("train.anomaly.loss_spikes", 1)
            skip = pol.spike_action == "skip" and model._can_discard()
            flight.on_transition(
                "train.anomaly", "spike",
                f"loss {loss:.6g} above median+{pol.spike_k}*MAD at "
                f"epoch {epoch} batch {batch} "
                f"({'skipped' if skip else 'tolerated'})")
            if skip:
                model._discard_step()
                stat_add("train.anomaly.skipped_steps", 1)
                self.skipped_steps += 1
            self._note_damage(epoch, batch, "loss_spike", poison=skip)
            return "skip" if skip else "ok"
        return "ok"

    # --- the audit ----------------------------------------------------------
    def maybe_audit(self, model, *, global_step: int, epoch: int,
                    batch: int, force: bool = False):
        """Audit when due (every ``audit_interval`` trained steps, or
        ``force=True`` right after a committed checkpoint).  A corrupted
        leaf raises :class:`_RollbackRequested` (rollback armed) or
        ``ParameterCorruptionError`` naming the leaf (skip-only)."""
        pol = self.policy
        self._steps_since_audit += 1
        due = force and pol.audit_on_checkpoint
        if pol.audit_interval is not None \
                and self._steps_since_audit >= pol.audit_interval:
            due = True
        if not due:
            return
        self._steps_since_audit = 0
        t0 = time.perf_counter()
        leaf = self.audit.corrupted_leaf(model)
        histogram_observe("train.anomaly.audit_ms",
                          (time.perf_counter() - t0) * 1e3)
        if leaf is None:
            return
        flight.on_transition(
            "train.corruption", leaf,
            f"SDC audit: non-finite values at step {global_step}")
        if pol.rollback_after is not None and self.ckpt is not None:
            raise _RollbackRequested(
                f"SDC audit named corrupted parameter leaf {leaf!r} at "
                f"step {global_step}")
        flight.auto_dump(f"parameter corruption with rollback disarmed: "
                         f"{leaf}")
        raise ParameterCorruptionError(
            f"SDC audit: parameter leaf {leaf!r} contains non-finite "
            f"values at step {global_step} and rollback is disarmed "
            "(pass AnomalyPolicy(rollback_after=...) + checkpoint_dir= "
            "to heal automatically)")

    # --- rollback -----------------------------------------------------------
    @staticmethod
    def _first_nonfinite_leaf(tree, path="model") -> Optional[str]:
        """Host finiteness walk of a loaded checkpoint's model tree: a
        capture made after the damage passes its own CRCs."""
        if isinstance(tree, dict):
            for k in sorted(tree):
                bad = AnomalyRuntime._first_nonfinite_leaf(
                    tree[k], f"{path}/{k}")
                if bad is not None:
                    return bad
            return None
        if isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                bad = AnomalyRuntime._first_nonfinite_leaf(
                    v, f"{path}/{i}")
                if bad is not None:
                    return bad
            return None
        try:
            arr = np.asarray(tree)
        except Exception:
            return None
        if arr.dtype != object and np.issubdtype(arr.dtype, np.inexact) \
                and not np.all(np.isfinite(arr)):
            return path
        return None

    def perform_rollback(self, model, reason: str) -> dict:
        """Restore the newest checkpoint that passes the per-leaf CRC
        check and the finiteness sweep (in place: a captured step keeps
        its addresses); returns the loader position.  A spent budget or
        a store with nothing restorable raises ``FatalError`` after the
        flight recorder's postmortem."""
        from .checkpoint import restore_train_state

        self.rollbacks_used += 1
        pol = self.policy
        if self.rollbacks_used > pol.rollback_budget:
            flight.on_transition("train.rollback", "budget_exhausted",
                                 reason)
            flight.auto_dump(
                f"anomaly rollback budget exhausted: {reason}")
            raise FatalError(
                f"anomaly rollback budget ({pol.rollback_budget}) "
                f"exhausted — numerical damage persists: {reason}")
        store = self.ckpt.store
        try:
            self.ckpt.flush()
        except Exception:  # noqa: BLE001 — a failed queued write only
            pass           # shrinks the candidate set; older ones remain
        for step in reversed(store.steps()):
            try:
                state, _manifest = store.load(step=step, verify=True)
            except (CheckpointCorruptError,
                    CheckpointIncompatibleError) as e:
                stat_add("train.anomaly.corrupt_checkpoints", 1)
                flight.on_transition("train.ckpt_corrupt",
                                     f"step-{step}", str(e))
                continue
            bad = self._first_nonfinite_leaf(state.get("model"))
            if bad is not None:
                # consistent but poisoned: captured after the damage
                stat_add("train.anomaly.corrupt_checkpoints", 1)
                flight.on_transition("train.ckpt_poisoned",
                                     f"step-{step}", bad)
                continue
            pos = restore_train_state(model, state)
            model._last_guard = None
            self._damage.clear()
            self.spikes.reset()
            self._steps_since_audit = 0
            stat_add("train.anomaly.rollbacks", 1)
            flight.on_transition(
                "train.rollback", f"step-{pos['global_step']}", reason)
            return pos
        flight.auto_dump(
            f"numerical damage with no restorable checkpoint: {reason}")
        raise FatalError(
            f"numerical damage ({reason}) but no verified restorable "
            f"checkpoint in {store.directory}")
