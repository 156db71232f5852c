"""hapi ``Model`` — twin of ``paddle_tpu/hapi/model.py``, the dynamic path:
``prepare``, ``train_batch`` / ``eval_batch`` / ``predict_batch``,
``fit``, ``evaluate``, ``predict``, ``save`` / ``load``, ``parameters``,
``state_dict`` and ``summary``.

``network`` is a port ``nn.Layer`` (LeNet, ``nn.Transformer``: called on
port Tensors) or a ``torch.nn.Module`` (the GPT of ``text/models.py``:
called on torch tensors).  Its parameters stay in it and are updated in
place; the loss gets the outputs and the label as port Tensors, as in
the JAX package, and may return a Tensor or a torch tensor.

``prepare(accelerate=True)`` (the default) builds the JAX package's fast
path: one train step — forward, loss, ``torch.autograd.grad``, the
optimizer's clip and update — as ``profiled_graph("hapi/train_step",
...)``, one CUDA graph per input signature, its parameters, the
network's buffers (a batch norm's running statistics, which each replay
updates in place) and the optimizer state donated (bound by address).
On the host before each call the optimizer writes its learning rate and
step count into its device scalars, so a running LR scheduler changes
no signature and the step captures once.  On the CPU the same function
runs as written.  ``accelerate=False`` steps eagerly: ``loss.backward();
opt.step(); opt.clear_grad()``.  ``evaluate`` and ``predict`` run the
network in eval mode (a batch norm on its running statistics).  Both
paths apply the optimizer's eager semantics
(the scheduler, ``grad_clip``, ``L1Decay`` and ``L2Decay``), which the
JAX package's own fused step does not (ROADMAP "Known facts about the
reference"); on the card they give the same bits.  Every step reads its
loss back (``float(loss)``), as the JAX package's ``fit`` does.

On the card ``fit`` stages each batch with ``io.prefetch_to_device``
(pinned memory, a side stream, an event).  The numpy state it saves in a
checkpoint is the one before the next batch's fetch, as without
prefetching, so a resume is bit-exact also for datasets that draw from
numpy's stream.

``fit(anomaly=)`` turns on numerical self-healing (``hapi/anomaly.py``):
the graphed step is captured in its guarded form, which first copies
everything it updates in place (parameters, accumulators, buffers) into
a pre-step copy and also returns ``isfinite(loss) & isfinite(global grad
norm)``, computed in the graph and read with the loss in one host read.
A skipped step (non-finite, or a loss spike under ``spike_action=
"skip"``) is discarded by copying the pre-step copy back in place — the
JAX package keeps its undonated pre-step state instead — and rewinds the
port's generator, numpy's stream and ``py_random``.  The eager path's
guard is one device reduction and one read; its non-finite step never
runs the optimizer.

A sparse embedding (``Embedding(sparse=True)``) takes a dense gradient
and the dense update in the graphed step, as in the JAX package, whose
accelerated step differentiates the functional forward outside its tape
(``jax.value_and_grad``), where the lookup's sparse gradient never
forms; ``accelerate=False`` steps it row-sparse, as the JAX package's
eager step does.

``prepare(amp_configs=)`` is accepted and ignored, in both packages: the
precision is set by ``amp.auto_cast`` around ``fit`` and by
``amp.decorate``.

Static-graph mode: with ``paddle.enable_static()`` on, ``prepare``
selects :class:`StaticGraphAdapter` (the JAX package's ``:194-197``),
and ``train_batch`` / ``eval_batch`` / ``predict_batch`` — so ``fit``,
``evaluate`` and ``predict`` — run recorded Programs through
``static.Executor``.

Not ported (raises ``InvalidArgumentError``): ``update=False``
(gradient accumulation) on the graphed path — it runs with
``accelerate=False``.
"""
from __future__ import annotations

import time as _time
from typing import List

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError
from ..framework.monitor import histogram_observe
from ..framework.random import get_rng_state, py_random, set_rng_state
from ..metric.metrics import Metric
from ..sparse_grad import dense_grads
from ..tensor import Tensor
from ..utils.profiler import RecordEvent
from .callbacks import CallbackList

__all__ = ["Model", "StaticGraphAdapter"]


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _batch_size_of(x):
    try:
        return int(x.shape[0])
    except Exception:
        return 1


def _value(x):
    return x._value if isinstance(x, Tensor) else x


def _guard_values(loss, grads) -> torch.Tensor:
    """``[loss, global grad norm, ok]`` (f32, on the loss's device) with
    ``ok = isfinite(loss) & isfinite(grad norm)``: the norm over every
    gradient there is, each squared and summed in f32, as the JAX
    package's guard."""
    gs = [g for g in grads if g is not None]
    sq = (torch.stack([g.float().square().sum() for g in gs]).sum()
          if gs else torch.zeros((), device=loss.device))
    gn = torch.sqrt(sq)
    ok = torch.isfinite(loss) & torch.isfinite(gn)
    return torch.stack([loss.detach().float(), gn, ok.float()])


def _read_guard(guard: torch.Tensor) -> dict:
    """The guard vector read to the host (the step's one read)."""
    loss, gn, ok = guard.tolist()
    return {"ok": ok == 1.0, "loss": loss, "grad_norm": gn}


class StaticGraphAdapter:
    """The static-graph execution path (reference hapi/model.py:224;
    ``paddle_tpu/hapi/model.py:43-160``): records a train, an eval and a
    predict Program from the network, the loss and
    ``optimizer.minimize`` — each once, on the first batch of its mode —
    and runs every batch through ``static.Executor`` on the network's
    device.  ``fit`` / ``evaluate`` / ``predict`` run their usual loops;
    only the per-batch engine differs.

    ``Model.prepare`` selects it while ``paddle.enable_static()`` is on;
    it needs ``Model(network, inputs=[InputSpec...], labels=[InputSpec
    ...])``, as the reference does, so the feeds are known when the
    programs are built."""

    def __init__(self, model: "Model"):
        from .. import static as _static

        self.model = model
        if not model._inputs:
            raise ValueError(
                "static mode requires Model(network, inputs=[InputSpec], "
                "labels=[InputSpec]) so the feed layout is known at "
                "program-build time (reference hapi/model.py:224)")
        self._static = _static
        self._exe = _static.Executor(model._device())
        self._progs = {}
        self._fetches = {}

    def _build(self, mode):
        """Record the program of ``mode`` once (reference
        _make_program)."""
        if mode in self._progs:
            return
        from ..static.program import feed_placeholder

        st, model = self._static, self.model
        dev = model._device()
        prog = st.Program()
        with st.program_guard(prog):
            ins = [feed_placeholder(s.name or f"input_{i}", s.shape,
                                    s.dtype, dev)
                   for i, s in enumerate(_to_list(model._inputs))]
            outs = _to_list(model.network(*ins))
            fetches = list(outs)
            if mode != "predict" and model._loss is not None:
                labels = [feed_placeholder(s.name or f"label_{i}", s.shape,
                                           s.dtype, dev)
                          for i, s in enumerate(_to_list(model._labels))]
                loss = model._loss(*outs, *labels)
                fetches = [loss] + fetches
                if mode == "train":
                    model._optimizer.minimize(loss)
        self._progs[mode] = prog
        self._fetches[mode] = fetches

    def _feed_dict(self, inputs, labels, mode):
        def host(v):
            v = _value(v)
            return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)

        model = self.model
        feed = {}
        for i, (spec, v) in enumerate(zip(_to_list(model._inputs), inputs)):
            feed[spec.name or f"input_{i}"] = host(v)
        if mode != "predict":
            for i, (spec, v) in enumerate(zip(_to_list(model._labels),
                                              labels)):
                feed[spec.name or f"label_{i}"] = host(v)
        return feed

    def _run(self, mode, inputs, labels):
        return self._exe.run(self._progs[mode],
                             feed=self._feed_dict(inputs, labels, mode),
                             fetch_list=self._fetches[mode])

    def _metrics(self, out, y):
        y = _value(y)
        y = y.detach().cpu() if isinstance(y, torch.Tensor) \
            else torch.from_numpy(np.asarray(y))
        return self.model._update_metrics(torch.from_numpy(out), y)

    def train_batch(self, inputs, labels=None, update=True):
        if not update:
            raise ValueError(
                "update=False (gradient accumulation) is not supported in "
                "static mode — the train program records the optimizer "
                "update; use dygraph mode")
        self.model.network.train()
        self._build("train")
        res = self._run("train", inputs, labels)
        return [float(res[0])] + self._metrics(res[1], labels[0])

    def eval_batch(self, inputs, labels=None):
        self.model.network.eval()
        labeled = bool(labels) and labels[0] is not None
        mode = "eval" if (labeled and self.model._loss is not None) \
            else "predict"
        self._build(mode)
        res = self._run(mode, inputs, labels)
        out = []
        if labeled:
            if mode == "eval":
                out.append(float(res[0]))
            # metrics update for ANY labeled batch, loss or not — the
            # dynamic path's contract
            out += self._metrics(res[1] if mode == "eval" else res[0],
                                 labels[0])
        return out

    def predict_batch(self, inputs):
        self.model.network.eval()
        self._build("predict")
        return [self._run("predict", inputs, None)[0]]


class _Tracked:
    """An iterator that records numpy's and ``py_random``'s state just
    before each fetch, so a checkpoint can save the state before the
    next batch was fetched even when prefetching has fetched further."""

    def __init__(self, it, first_index: int):
        self._it = it
        self._next = first_index
        self.states = {}

    def __iter__(self):
        return self

    def __next__(self):
        self.states[self._next] = (np.random.get_state(),
                                   py_random.getstate())
        out = next(self._it)
        self._next += 1
        return out

    def state_before(self, index: int):
        """The states before batch ``index``'s fetch (now, if not yet
        fetched); forgets the earlier ones."""
        for k in [k for k in self.states if k < index]:
            del self.states[k]
        return self.states.get(index, (np.random.get_state(),
                                       py_random.getstate()))


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._accelerate = True
        self._graph = None
        self._graph_guarded = False
        self._train_state = None
        self._train_params = None
        self.stop_training = False
        # numerical self-healing: with fit(anomaly=) the step runs
        # guarded; _last_guard is its verdict {"ok", "loss", "grad_norm"},
        # _backup the graphed step's pre-step copy (None when unguarded)
        self._anomaly_guard = False
        self._last_guard = None
        self._backup = None
        self._pre_scalars = None    # (step count, LR) before the step
        self._lr_written = None     # the LR the last step wrote
        self._adapter = None        # StaticGraphAdapter in static mode

    # --- prepare -----------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, accelerate=True):
        """``amp_configs`` is accepted and ignored, as the JAX package
        does."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._accelerate = accelerate
        self._graph = None
        if optimizer is not None and optimizer._parameters is None:
            optimizer._param_objs = list(self.parameters())
            optimizer._parameters = [_value(p) for p in
                                     optimizer._param_objs]
        from .. import in_dynamic_mode

        self._adapter = None if in_dynamic_mode() else \
            StaticGraphAdapter(self)
        return self

    # --- network plumbing ---------------------------------------------------
    def _is_module(self) -> bool:
        return isinstance(self.network, torch.nn.Module)

    def _device(self) -> torch.device:
        for p in self.parameters():
            return _value(p).device
        return torch.device("cpu")

    def _as_input(self, x):
        """A batch entry as a torch tensor on the network's device."""
        v = _value(x)
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        dev = self._device()
        return v if v.device == dev else v.to(dev)

    def _forward(self, x):
        """The network's outputs on ``x`` as a list of torch tensors."""
        out = self.network(x if self._is_module() else Tensor(x))
        return [_value(o) for o in _to_list(out)]

    def _loss_value(self, outs, y):
        loss = self._loss(*[Tensor(o) for o in outs], Tensor(y))
        return _value(loss).float()

    # --- the train step -------------------------------------------------------
    def _build_train_step(self, guarded: bool = False):
        """The graphed step over the optimizer's trainable parameters,
        the network's buffers, the accumulators and the optimizer's
        device scalars (all donated: the step updates them in place).
        ``guarded``: the step first copies the parameters, accumulators
        and buffers into ``_backup`` (a skip copies them back) and also
        returns ``[loss, grad norm, ok]`` for the host's one read."""
        from ..profiler.jit_cost import profiled_graph

        opt = self._optimizer
        params = [p for p in opt._param_list() if p.requires_grad]
        opt._ensure_state(params)
        lr_t, step_t = opt._scalars()
        accs = [opt._accumulators[kind][id(p)]
                for kind in opt._acc_kinds() for p in params]
        buffers = [_value(b) for b in self.network.buffers()]
        kept = list(params) + accs + buffers
        backup = ([torch.empty_like(t) for t in kept] if guarded
                  else None)

        def train_step(state, x, y):
            if guarded:
                with torch.no_grad():
                    torch._foreach_copy_(backup, kept)
            with dense_grads():
                outs = self._forward(x)
            loss = self._loss_value(outs, y)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            if guarded:
                verdict = _guard_values(loss, grads)
            opt._apply_gradients(list(zip(params, grads)))
            if guarded:
                return loss.detach(), outs[0].detach(), verdict
            return loss.detach(), outs[0].detach()

        self._train_params = params
        self._train_state = kept + [lr_t, step_t]
        self._backup = backup
        self._graph_guarded = guarded
        self._graph = profiled_graph("hapi/train_step", train_step,
                                     donate_argnums=(0,))

    def _run_train_step(self, x, y, update=True):
        """One training step on device tensors; returns ``(loss, first
        output, guard)`` as device tensors, nothing read back (a graphed
        step's are its static outputs: the next step overwrites them).
        ``guard`` is the ``[loss, grad norm, ok]`` vector of a graphed
        guarded step, else None; an eager guarded step reads it itself
        (``guard`` is then its host dict) and runs the optimizer only
        when it is finite."""
        self.network.train()
        guarded = self._anomaly_guard
        opt = self._optimizer
        if self._accelerate:
            if not update:
                raise InvalidArgumentError(
                    "train_batch(update=False) (gradient accumulation) "
                    "needs prepare(accelerate=False)")
            if self._graph is None or self._graph_guarded != guarded:
                self._build_train_step(guarded)
            self._pre_scalars = (opt._step_count, self._lr_written)
            opt._prepare_step()
            self._lr_written = opt.get_lr()
            out = self._graph(self._train_state, x, y)
            return out if guarded else out + (None,)
        outs = self._forward(x)
        loss = self._loss_value(outs, y)
        loss.backward()
        guard = None
        if guarded:
            guard = _read_guard(_guard_values(
                loss, [p.grad for p in opt._param_list()]))
            if not guard["ok"]:
                # the optimizer never runs: the parameters are untouched
                opt.clear_grad()
                return loss.detach(), outs[0].detach(), guard
        if update:
            opt.step()
            opt.clear_grad()
        return loss.detach(), outs[0].detach(), guard

    def _can_discard(self) -> bool:
        """Whether the last step's update can be taken back (the graphed
        guarded step keeps a pre-step copy)."""
        return self._accelerate and self._backup is not None

    @torch.no_grad()
    def _discard_step(self):
        """Take the last guarded step's update back: the pre-step copy
        into the parameters, accumulators and buffers in place (their
        addresses stay the graph's), the step count and the LR scalars as
        they were.  An eager step has nothing to take back: its
        non-finite update never ran."""
        if not self._can_discard():
            return
        kept = self._train_state[:len(self._backup)]
        torch._foreach_copy_(kept, self._backup)
        opt = self._optimizer
        count, lr = self._pre_scalars
        opt._step_count = count
        lr_t, step_t = opt._scalars()
        step_t.fill_(float(count))
        if lr is not None:
            lr_t.fill_(lr)
        self._lr_written = lr

    # --- single-batch API ----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        inputs = _to_list(inputs)
        labels = _to_list(labels)
        if self._adapter is not None:
            return self._adapter.train_batch(inputs, labels, update)
        x = self._as_input(inputs[0])
        y = self._as_input(labels[0]) if labels and labels[0] is not None \
            else None
        loss, out, guard = self._run_train_step(x, y, update)
        if guard is None:
            self._last_guard = None
            lossf = float(loss)
        else:
            self._last_guard = (guard if isinstance(guard, dict)
                                else _read_guard(guard))
            lossf = self._last_guard["loss"]
            if not self._last_guard["ok"]:
                # a poisoned step never reaches the metrics
                return [lossf]
        metrics_out = self._update_metrics(out, y)
        return [lossf] + metrics_out

    def _update_metrics(self, out, y):
        res = []
        for m in self._metrics:
            c = m.compute(Tensor(out), Tensor(y))
            res.append(m.update(*c) if isinstance(c, tuple) else m.update(c))
        return res

    @torch.no_grad()
    def _eval_outputs(self, x):
        self.network.eval()
        return self._forward(x)

    def eval_batch(self, inputs, labels=None):
        inputs = _to_list(inputs)
        labels = _to_list(labels)
        if self._adapter is not None:
            return self._adapter.eval_batch(inputs, labels)
        outs = self._eval_outputs(self._as_input(inputs[0]))
        res = []
        if labels and labels[0] is not None:
            y = self._as_input(labels[0])
            if self._loss is not None:
                with torch.no_grad():
                    res.append(float(self._loss_value(outs, y)))
            res += self._update_metrics(outs[0], y)
        return res

    def predict_batch(self, inputs):
        inputs = _to_list(inputs)
        if self._adapter is not None:
            return self._adapter.predict_batch(inputs)
        out = self._eval_outputs(self._as_input(inputs[0]))[0]
        return [out.float().cpu().numpy() if out.is_floating_point()
                else out.cpu().numpy()]

    # --- loops ---------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None,
            checkpoint_dir=None, checkpoint_interval=None,
            checkpoint_async=True, keep_checkpoints=3, resume=False,
            step_retries=0, step_retry_backoff_s=0.05, anomaly=None):
        """The train loop, with the JAX package's crash-consistency
        knobs:

        - ``checkpoint_dir`` + ``checkpoint_interval``: commit a train
          state checkpoint (weights, optimizer state and scheduler, the
          generators, the loader position, the step counter) every K
          steps through a ``CheckpointStore``; ``checkpoint_async``
          writes on a background thread, ``keep_checkpoints`` keeps the
          last K.
        - ``resume``: True resumes from ``checkpoint_dir``'s newest valid
          checkpoint (a path or store resumes from there): the same epoch
          permutation is drawn again, the trained batches are skipped,
          the streams rejoin where the capture left them, and the run
          continues bit-identical to the uninterrupted one.
        - ``step_retries`` + ``step_retry_backoff_s``: a failed batch
          fetch (the ``loader.next`` chaos site) or train step is retried
          with exponential backoff, the generators restored first; a
          ``FatalError`` (a ``train.step`` chaos ``kill``) is not.
        - ``anomaly``: True or an ``AnomalyPolicy`` turns on numerical
          self-healing (``hapi/anomaly.py``): the guarded step, skip-step
          on a non-finite loss or gradient norm, the loss-spike
          detector, the parameter audit, and rollback to the newest
          verified checkpoint (``checkpoint_dir`` needed when rollback
          is armed), bounded by a budget past which ``FatalError``.
        """
        from ..framework.errors import FatalError
        from ..framework.monitor import stat_add
        from ..io import DataLoader
        from ..io.dataloader import prefetch_to_device
        from ..io.dataset import Dataset
        from ..testing.chaos import KILL, chaos_site
        from .anomaly import _RollbackRequested

        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data

        ckpt = None
        if checkpoint_dir is not None:
            from .checkpoint import TrainCheckpointer

            ckpt = TrainCheckpointer(
                checkpoint_dir,
                interval=(1 if checkpoint_interval is None
                          else checkpoint_interval),
                async_write=checkpoint_async, keep_last=keep_checkpoints)
        resume_pos = None
        if resume:
            from .checkpoint import TrainCheckpointer

            if resume is True:
                if ckpt is None:
                    raise InvalidArgumentError(
                        "resume=True needs checkpoint_dir= (or pass the "
                        "store/path to resume from as resume=)")
                resume_pos = ckpt.resume(self)
            else:
                resume_pos = TrainCheckpointer(
                    resume, async_write=False).resume(self)
        anomaly_rt = self._anomaly_runtime(anomaly, ckpt)

        staged = self._device().type == "cuda"
        steps = None
        try:
            steps = len(train_loader)
        except TypeError:
            pass
        cbks = CallbackList(callbacks, model=self, verbose=verbose,
                            metrics=["loss"] + self._metric_names(),
                            epochs=epochs, steps=steps, log_freq=log_freq)
        cbks.on_begin("train")
        self.stop_training = False
        global_step = 0 if resume_pos is None else resume_pos["global_step"]
        start_epoch = 0 if resume_pos is None else resume_pos["epoch"]
        trained_any = False
        logs = {}
        try:
            epoch = start_epoch
            while epoch < epochs:
                skip_batches = 0
                if resume_pos is not None and epoch == start_epoch:
                    # replay the epoch permutation the interrupted (or
                    # rolled back) run drew, then (below) skip what it
                    # trained and rejoin its streams before the first
                    # batch left to train
                    np.random.set_state(resume_pos["np_state_epoch_start"])
                    if resume_pos.get("py_state_epoch_start") is not None:
                        py_random.setstate(
                            resume_pos["py_state_epoch_start"])
                    skip_batches = resume_pos["next_batch"]
                try:
                    with RecordEvent("hapi/fit.epoch", epoch=epoch):
                        logs, global_step, trained = self._fit_epoch(
                            epoch, train_loader, skip_batches, resume_pos,
                            staged, prefetch_to_device, cbks, ckpt,
                            anomaly_rt, num_iters, global_step,
                            step_retries, step_retry_backoff_s, chaos_site,
                            stat_add, KILL, FatalError)
                        trained_any = trained_any or trained
                        if eval_loader is not None \
                                and (epoch + 1) % eval_freq == 0:
                            eval_logs = self.evaluate(
                                eval_loader, verbose=0, _inside_fit=True)
                            logs.update({f"eval_{k}": v
                                         for k, v in eval_logs.items()})
                        cbks.on_epoch_end(epoch, logs)
                except _RollbackRequested as rb:
                    # restore the newest verified checkpoint and re-enter
                    # at its position; the poisoned set passes over the
                    # batches that did the damage
                    resume_pos = anomaly_rt.perform_rollback(self,
                                                             rb.reason)
                    global_step = resume_pos["global_step"]
                    start_epoch = epoch = resume_pos["epoch"]
                    continue
                if save_dir and (epoch + 1) % save_freq == 0:
                    self.save(f"{save_dir}/{epoch}")
                if self.stop_training:
                    break
                epoch += 1
            if ckpt is not None and (trained_any or resume_pos is None):
                # terminal checkpoint at (epochs, 0): resuming with the
                # same budget is a no-op, a larger one continues
                ckpt.snapshot(self, global_step=global_step,
                              epoch=epochs, next_batch=0,
                              np_state_epoch_start=np.random.get_state(),
                              py_state_epoch_start=py_random.getstate())
        finally:
            # guard mode is per fit: disarm it and drop the guarded
            # step with its pre-step copy
            self._anomaly_guard = False
            self._last_guard = None
            if self._graph_guarded:
                self._graph = None
                self._graph_guarded = False
            self._backup = None
            if ckpt is not None:
                import sys as _sys

                in_flight = _sys.exc_info()[0] is not None
                try:
                    ckpt.close()
                except Exception:  # noqa: BLE001 — see re-raise below
                    # a close failure must not mask a training exception
                    # already propagating
                    if not in_flight:
                        raise
        cbks.on_end("train", logs)
        if save_dir:
            self.save(f"{save_dir}/final")
        return self

    def _anomaly_runtime(self, anomaly, ckpt):
        """The fit's ``AnomalyRuntime`` (None without ``anomaly``), with
        the JAX package's checks of the policy against the fit."""
        if not anomaly:
            self._anomaly_guard = False
            return None
        from .anomaly import AnomalyPolicy, AnomalyRuntime

        if anomaly is not True and not isinstance(anomaly, AnomalyPolicy):
            raise InvalidArgumentError(
                f"anomaly must be True or an AnomalyPolicy, got {anomaly!r}")
        policy = (anomaly if isinstance(anomaly, AnomalyPolicy)
                  else AnomalyPolicy())
        if policy.rollback_after is not None and ckpt is None:
            raise InvalidArgumentError(
                "AnomalyPolicy with rollback armed (rollback_after is not "
                "None) needs checkpoint_dir= — rollback restores from the "
                "TrainCheckpointer's store; pass AnomalyPolicy("
                "rollback_after=None) for skip-only operation")
        if not self._accelerate and policy.spike_window > 0 \
                and policy.spike_action == "skip":
            # the eager update has run when the spike is seen
            raise InvalidArgumentError(
                "spike_action='skip' needs the accelerated (graphed) train "
                "path; with accelerate=False use spike_action='tolerate' "
                "or spike_window=0")
        self._anomaly_guard = True
        return AnomalyRuntime(policy, checkpointer=ckpt)

    def _fit_epoch(self, epoch, train_loader, skip_batches, resume_pos,
                   staged, prefetch_to_device, cbks, ckpt, anomaly_rt,
                   num_iters, global_step, step_retries, backoff_s,
                   chaos_site, stat_add, KILL, FatalError):
        """One epoch of ``fit``; returns ``(logs, global step, trained
        any)``."""
        cbks.on_epoch_begin(epoch)
        for m in self._metrics:
            m.reset()
        logs = {}
        trained = False
        np_epoch_start = np.random.get_state()
        py_epoch_start = py_random.getstate()
        raw = iter(train_loader)
        for _ in range(skip_batches):
            if self._fetch_with_retry(raw, step_retries, backoff_s,
                                      chaos_site, stat_add) is None:
                break
        if skip_batches:
            np.random.set_state(resume_pos["np_random"])
            if resume_pos.get("py_random") is not None:
                py_random.setstate(resume_pos["py_random"])
        tracked = _Tracked(raw, skip_batches)
        it = (prefetch_to_device(tracked, device=self._device())
              if staged else tracked)
        step = skip_batches
        while num_iters is None or step < num_iters:
            batch = self._fetch_with_retry(it, step_retries, backoff_s,
                                           chaos_site, stat_add)
            if batch is None:
                break
            if anomaly_rt is not None \
                    and (epoch, step) in anomaly_rt.poisoned:
                # a batch whose damage caused the rollback: passed over
                # for good (its skip rewound the streams, so the replay
                # stays exact past it)
                step += 1
                continue
            cbks.on_batch_begin("train", step, logs)
            x = batch[0]
            y = batch[1] if len(batch) > 1 else None
            t0 = _time.perf_counter()
            with RecordEvent("hapi/train_batch"):
                outs = self._step_with_retry(
                    x, y, step_retries, backoff_s, chaos_site, stat_add,
                    KILL, FatalError, runtime=anomaly_rt, epoch=epoch,
                    batch=step, global_step=global_step)
            histogram_observe("hapi.train_batch_ms",
                              (_time.perf_counter() - t0) * 1e3)
            if outs is None:
                # skipped: the step never happened.  The callbacks keep
                # their begin/end pairing (logs are the last batch's)
                # and the audit still ticks: a corrupted parameter makes
                # every step skip, and the audit must name it
                cbks.on_batch_end("train", step, logs)
                anomaly_rt.maybe_audit(self, global_step=global_step,
                                       epoch=epoch, batch=step)
                step += 1
                continue
            global_step += 1
            trained = True
            logs = {"loss": outs[0], "batch_size": _batch_size_of(x)}
            for name, val in zip(self._metric_names(), outs[1:]):
                logs[name] = val
            cbks.on_batch_end("train", step, logs)
            step += 1
            snapped = False
            if ckpt is not None:
                ckpt.note_step(global_step)
                if ckpt.due(global_step):
                    np_mid, py_mid = tracked.state_before(step)
                    ckpt.snapshot(
                        self, global_step=global_step, epoch=epoch,
                        next_batch=step, np_state_epoch_start=np_epoch_start,
                        py_state_epoch_start=py_epoch_start,
                        np_random=np_mid, py_random=py_mid)
                    snapped = True
            if anomaly_rt is not None:
                # the audit's cadence: every N trained steps, and right
                # after a committed checkpoint
                anomaly_rt.maybe_audit(self, global_step=global_step,
                                       epoch=epoch, batch=step - 1,
                                       force=snapped)
            if self.stop_training:
                break
        return logs, global_step, trained

    def _fetch_with_retry(self, it, retries, backoff_s, chaos_site,
                          stat_add):
        """Next batch through the ``loader.next`` chaos site with
        bounded-backoff retry; None when the epoch is exhausted.  Only
        the site's faults are retried: a real ``next()`` may already have
        consumed a sampler index when it fails."""
        from ..profiler.flight_recorder import recorder as _flight

        attempt = 0
        while True:
            try:
                chaos_site("loader.next")
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                attempt += 1
                if attempt > retries:
                    raise
                stat_add("train.step_retries", 1)
                _flight.on_transition("train.retry", "loader.next",
                                      f"{type(e).__name__}: {e}")
                _time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            return next(it)
        except StopIteration:
            return None

    def _step_with_retry(self, x, y, retries, backoff_s, chaos_site,
                         stat_add, KILL, FatalError, runtime=None,
                         epoch=0, batch=0, global_step=0):
        """One train step through the ``train.step`` chaos site; a
        transient failure retries after restoring the generators (so a
        retried step draws the same numbers); a chaos ``kill`` raises
        ``FatalError`` (never retried) and dumps the flight recorder.
        The numeric actions poison a copy of the batch (``nan_loss``,
        ``nan_grad``) or a named parameter (``corrupt_param``).  With
        ``runtime`` (an ``AnomalyRuntime``) the guard's verdict applies
        here: a skip returns None after rewinding the port's generator,
        numpy's stream and ``py_random`` to their state before the
        step, so the next batch draws what it would have drawn had this
        one never come."""
        from ..profiler.flight_recorder import recorder as _flight
        from ..testing.chaos import CORRUPT_PARAM, NAN_GRAD, NAN_LOSS

        attempt = 0
        while True:
            rng_state = get_rng_state()
            np_state = np.random.get_state()
            py_state = py_random.getstate()
            xin = x
            try:
                fault = chaos_site("train.step")
                if fault is not None:
                    if fault.action == KILL:
                        raise FatalError(fault.message)
                    if fault.action in (NAN_LOSS, NAN_GRAD):
                        xin = self._poison_batch(fault.action, x, NAN_LOSS)
                    elif fault.action == CORRUPT_PARAM:
                        self._corrupt_param(fault)
                outs = self.train_batch([xin], [y])
            except (KeyboardInterrupt, SystemExit):
                raise
            except FatalError as e:
                _flight.on_transition("train.fatal", "train.step", str(e))
                _flight.auto_dump(f"train step fatal: {e}")
                raise
            except Exception as e:
                attempt += 1
                set_rng_state(rng_state)
                np.random.set_state(np_state)
                py_random.setstate(py_state)
                if attempt > retries:
                    raise
                stat_add("train.step_retries", 1)
                _flight.on_transition("train.retry", "train.step",
                                      f"{type(e).__name__}: {e}")
                _time.sleep(backoff_s * (2 ** (attempt - 1)))
                continue
            # the policy applies outside the retry block: a rollback
            # request must propagate, never be retried
            if runtime is None or self._last_guard is None:
                return outs
            verdict = runtime.on_step_outcome(
                self, outs, epoch=epoch, batch=batch,
                global_step=global_step)
            if verdict == "skip":
                set_rng_state(rng_state)
                np.random.set_state(np_state)
                py_random.setstate(py_state)
                return None
            return outs

    def _poison_batch(self, action, x, NAN_LOSS):
        """Chaos ``nan_loss`` / ``nan_grad``: a poisoned copy of the batch
        input (NaN, or the dtype's largest finite value), on the
        network's device; the staged batch itself is not touched."""
        v = self._as_input(x)
        if not v.is_floating_point():
            raise InvalidArgumentError(
                f"chaos {action} needs a floating-point input batch to "
                f"poison, got dtype {v.dtype}")
        fill = float("nan") if action == NAN_LOSS \
            else torch.finfo(v.dtype).max
        return torch.full_like(v, fill)

    @torch.no_grad()
    def _corrupt_param(self, fault):
        """Chaos ``corrupt_param``: set one element of the parameter
        ``fault.leaf`` names (row-major index ``fault.element_index``,
        the JAX package's) to NaN, in place on its device and outside
        any graph; it persists until a rollback restores a clean
        checkpoint (a skip does not heal it: its pre-step copy is
        already corrupt)."""
        from ..profiler.flight_recorder import recorder as _flight

        leaf = fault.leaf
        target = dict(self.network.named_parameters()).get(leaf)
        if target is None:
            raise InvalidArgumentError(
                f"corrupt_param leaf {leaf!r} not found among the "
                "network's named parameters")
        t = _value(target)
        idx = fault.element_index(t.numel() or 1)
        t[np.unravel_index(idx, tuple(t.shape))] = float("nan")
        _flight.on_transition("chaos.corrupt_param", leaf,
                              f"element {idx} set non-finite")

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None,
                 _inside_fit=False):
        from ..io import DataLoader
        from ..io.dataset import Dataset

        if isinstance(eval_data, Dataset):
            loader = DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = eval_data
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            x, y = batch[0], batch[1] if len(batch) > 1 else None
            outs = self.eval_batch([x], [y])
            if outs and self._loss is not None and y is not None:
                losses.append(outs[0])
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, list) else [vals]
            for n, v in zip(names, vals):
                logs[n] = v
        if verbose and not _inside_fit:
            print("Eval:", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        from ..io import DataLoader
        from ..io.dataset import Dataset

        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = test_data
        outputs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            outputs.append(self.predict_batch([x])[0])
        if stack_outputs:
            return [np.concatenate(outputs, axis=0)]
        return [outputs]

    # --- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        from ..framework_io import save as _save

        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        import os

        from ..framework_io import load as _load

        state = _load(path + ".pdparams", return_numpy=True)
        if self._is_module():
            with torch.no_grad():
                live = self.network.state_dict(keep_vars=True)
                for k, v in state.items():
                    live[k].copy_(torch.as_tensor(np.asarray(v)))
        else:
            self.network.set_state_dict(state)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt",
                                                 return_numpy=True))
        return self

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters(*args, **kwargs))

    def state_dict(self):
        return self.network.state_dict()

    def _metric_names(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names += n if isinstance(n, list) else [n]
        return names

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary

        return _summary(self.network, input_size, dtype)
