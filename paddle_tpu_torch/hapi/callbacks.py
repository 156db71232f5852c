"""hapi callbacks — twin of ``paddle_tpu/hapi/callbacks.py``: ``Callback``,
``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``
(steps the optimizer's scheduler on the host after each batch or epoch;
the next step's update reads the new value from the optimizer's device
scalar), ``EarlyStopping``, ``ReduceLROnPlateau`` and ``VisualDL``
(TSV scalars, no package needed)."""
from __future__ import annotations

import numbers
import os
import time

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "VisualDL", "ReduceLROnPlateau"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin", lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end", lambda s, l=None: None)(step, logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None, model=None, **params):
        self.callbacks = list(callbacks or [])
        if params.get("verbose", 2):
            self.callbacks.insert(0, ProgBarLogger(params.get("log_freq", 10),
                                                   params.get("verbose", 2)))
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._epoch_t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose and (step + 1) % self.log_freq == 0:
            items = []
            for k, v in logs.items():
                if isinstance(v, numbers.Number):
                    items.append(f"{k}: {v:.4f}")
            rate = (step + 1) / max(time.time() - self._epoch_t0, 1e-9)
            print(f"step {step + 1}/{self.steps or '?'} - "
                  + " - ".join(items) + f" - {rate:.2f} step/s")

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.verbose:
            items = [f"{k}: {v:.4f}" for k, v in logs.items()
                     if isinstance(v, numbers.Number)]
            dt = time.time() - self._epoch_t0
            print(f"Epoch {epoch + 1} done in {dt:.1f}s - " + " - ".join(items))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched

        if opt is not None and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda a, b: a > b + self.min_delta
            self.best = -float("inf")
        else:
            self.better = lambda a, b: a < b - self.min_delta
            self.best = float("inf")
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor, logs.get(f"eval_{self.monitor}"))
        if value is None:
            return
        if isinstance(value, (list, tuple)):
            value = value[0]
        if self.better(value, self.best):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping at epoch {epoch + 1}: best "
                          f"{self.monitor}={self.best:.5f}")


class VisualDL(Callback):
    """Scalar logging: one TSV file of ``step\tvalue`` lines per tag,
    readable by any dashboard (the VisualDL package is not needed)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._files = {}

    def _write(self, tag, step, value):
        os.makedirs(self.log_dir, exist_ok=True)
        if tag not in self._files:
            self._files[tag] = open(
                os.path.join(self.log_dir, tag.replace("/", "_") + ".tsv"), "a")
        self._files[tag].write(f"{step}\t{value}\n")
        self._files[tag].flush()

    def on_train_batch_end(self, step, logs=None):
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                self._write(f"train/{k}", step, v)

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                self._write(f"epoch/{k}", epoch, v)

    def on_train_end(self, logs=None):
        for f in self._files.values():
            f.close()


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.wait = 0
        self.cooldown_counter = 0
        self.best = float("inf") if "loss" in monitor else -float("inf")
        self.mode = "min" if "loss" in monitor else "max"

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor, logs.get(f"eval_{self.monitor}"))
        if value is None:
            return
        if isinstance(value, (list, tuple)):
            value = value[0]
        improved = value < self.best if self.mode == "min" else value > self.best
        if improved:
            self.best = value
            self.wait = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.wait += 1
            if self.wait >= self.patience:
                opt = self.model._optimizer
                try:
                    lr = opt.get_lr()
                    new = max(lr * self.factor, self.min_lr)
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr -> {new:.2e}")
                except RuntimeError:
                    pass
                self.wait = 0
                self.cooldown_counter = self.cooldown
