"""Inference Config — ``paddle_tpu/inference/config.py``'s twin (the
reference framework's AnalysisConfig).

Holds the model path and the execution knobs.  The GPU / TensorRT /
MKLDNN toggles of the reference are kept for API parity: the GPU ones
select the CUDA card (the default) or the CPU, the others are
documented no-ops.  ``enable_serving`` stores the serving engine's and
the frontend's knobs for ``serving.create_serving_engine(model, config)``
and ``serving.create_serving_frontend(model, config)``; unlike the JAX
package's, ``serving_config()`` also carries the device.
"""
from __future__ import annotations

import os
from typing import Optional


class Config:
    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        """prog_file: the path prefix of a saved model (the
        ``.pdmodel``/``.pdiparams`` suffixes are appended automatically, or
        pass the full ``.pdmodel`` path)."""
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._model_prefix = prog_file
        self._params_file = params_file
        # the CUDA card unless disable_gpu() selects the CPU
        self._device = "gpu"
        self._device_id = 0
        self._enable_memory_optim = True
        self._ir_optim = True          # kept for parity
        self._glog_info = False
        self._warmup = True            # kept for parity

    # --- model location ----------------------------------------------------
    def set_model(self, prog_file, params_file=None):
        if prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._model_prefix = prog_file
        self._params_file = params_file

    def model_dir(self):
        return os.path.dirname(self._model_prefix or "")

    def prog_file(self):
        return (self._model_prefix or "") + ".pdmodel"

    def params_file(self):
        return self._params_file or (self._model_prefix or "") + ".pdiparams"

    # --- device ------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Select the CUDA card ``cuda:<device_id>`` (the default is card
        0); ``memory_pool_init_size_mb`` is kept for parity."""
        self._device = "gpu"
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device == "gpu"

    def gpu_device_id(self):
        return self._device_id

    def _torch_device(self) -> str:
        """The torch device the serving entry points run on: ``cuda:<id>``
        or ``cpu``."""
        return f"cuda:{self._device_id}" if self.use_gpu() else "cpu"

    # --- serving (the continuous-batching engine and its frontend) ---------
    def enable_serving(self, max_batch_size=8, page_size=16, num_pages=None,
                       max_seq_len=None, eos_id=0, prefill_chunk=64,
                       sync_mode=False, fused_steps=1,
                       kv_cache_dtype=None, weight_dtype=None,
                       replicas=1, queue_cap=64, default_deadline_ms=None,
                       snapshot_interval=16, watchdog=None, brownout=None,
                       prefix_cache=False, spec_decode=False,
                       numeric_guards=True):
        """Opt in to the continuous-batching serving engine
        (docs/SERVING.md).  Stores the paged-KV / scheduler knobs plus the
        pipelining knobs (``prefill_chunk`` tokens per prefill program,
        ``sync_mode`` consume-immediately escape hatch, ``fused_steps``
        K-step fused decode) and the quantization knobs
        (``kv_cache_dtype="int8"`` int8 paged KV cache,
        ``weight_dtype="int8"`` weight-only int8 matmuls — see
        docs/SERVING.md "Quantized serving"; pass calibrated scales from
        ``slim.export_serving_quant`` to ``create_serving_engine`` via
        ``quant_scales=...``).  Build the engine with
        ``paddle_tpu_torch.serving.create_serving_engine(model, config)``
        — on the device this config selected.

        The FRONTEND knobs (docs/SERVING.md "Frontend & deployment")
        configure ``create_serving_frontend(model, config)`` instead:
        ``replicas`` engine replicas behind the least-outstanding-tokens
        router, ``queue_cap`` live requests before reject-on-overload
        (None = unbounded), ``default_deadline_ms`` applied to requests
        submitted without an explicit deadline (None = no SLO).

        Resilience knobs (docs/SERVING.md "Resilience"):
        ``snapshot_interval`` checkpoints every in-flight request each K
        consumed tokens so replica failover RESUMES from the checkpoint
        instead of replaying from token 0 (None disables);
        ``watchdog=True`` (or a serving.resilience.WatchdogConfig)
        enables hung-step detection with suspect/backoff/dead
        escalation; ``brownout=True`` (or a BrownoutPolicy) enables
        staged overload degradation (shed → clamp → reject).

        ``prefix_cache=True`` (docs/SERVING.md "Prefix caching") turns
        on the radix prefix index with refcounted copy-on-write page
        sharing: prompts sharing a resident full-page prefix (system
        prompts, few-shot templates, multi-turn history) skip straight
        to the first uncached token at prefill.  Requires native or
        int8_static KV (int8_dynamic engines bypass the index — the
        documented scale contract); per-request opt-out via
        ``submit(prefix_cache=False)``.

        ``spec_decode=True`` (docs/SERVING.md "Speculative decoding")
        turns on speculative decoding: a model-free n-gram /
        prompt-lookup drafter proposes continuation tokens and ONE
        fused ``serving.spec_verify`` dispatch scores all of them —
        accepted tokens cost ~1/K of the HBM bandwidth of plain
        decode while the emitted stream stays exactly the greedy
        stream, byte for byte.  Pass an int to set the K-token verify
        horizon (True = 4).

        ``numeric_guards=True`` (the default — docs/SERVING.md "Logit
        quarantine") folds a per-lane logit-finiteness flag
        into the decode/verify programs' already-consumed outputs: a
        lane whose logits come back non-finite fails exactly that
        request with a typed ``NumericalFaultError`` (HTTP 500) within
        one engine step, its lane is reset and its pages scrubbed +
        freed, while every other stream continues byte-identically.
        ``False`` removes the guard.

        Not reference API — the reference's serving story stops at
        AnalysisPredictor."""
        self._serving = {
            "max_batch_size": int(max_batch_size),
            "page_size": int(page_size),
            "num_pages": None if num_pages is None else int(num_pages),
            "max_seq_len": None if max_seq_len is None else int(max_seq_len),
            "eos_id": int(eos_id),
            "prefill_chunk": int(prefill_chunk),
            "sync_mode": bool(sync_mode),
            "fused_steps": int(fused_steps),
            "kv_cache_dtype": kv_cache_dtype,
            "weight_dtype": weight_dtype,
            "prefix_cache": bool(prefix_cache),
            # bool or int K-horizon — validated by the engine
            "spec_decode": spec_decode,
            "numeric_guards": bool(numeric_guards),
        }
        self._serving_frontend = {
            "replicas": int(replicas),
            "queue_cap": None if queue_cap is None else int(queue_cap),
            "default_deadline_ms": (
                None if default_deadline_ms is None
                else float(default_deadline_ms)),
            "snapshot_interval": (None if snapshot_interval is None
                                  else int(snapshot_interval)),
            "watchdog": watchdog,
            "brownout": brownout,
        }

    def serving_enabled(self) -> bool:
        return getattr(self, "_serving", None) is not None

    def serving_config(self) -> dict:
        """The engine's keyword arguments, the device included."""
        if not self.serving_enabled():
            raise ValueError("serving not enabled — call enable_serving()")
        return dict(self._serving, device=self._torch_device())

    def frontend_config(self) -> dict:
        """The ServingFrontend-side knobs of ``enable_serving`` —
        consumed by ``serving.create_serving_frontend``."""
        if not self.serving_enabled():
            raise ValueError("serving not enabled — call enable_serving()")
        return dict(self._serving_frontend)

    # --- optimization knobs (kept for parity) -------------------------------
    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self):
        self._enable_memory_optim = True

    def set_warmup(self, flag: bool):
        """Kept for parity (the JAX package compiles its exported artifact
        at predictor creation)."""
        self._warmup = flag

    def enable_tensorrt_engine(self, *a, **k):
        """No-op: the port's kernels are its own."""

    def enable_mkldnn(self):
        """No-op: the CPU path is plain PyTorch."""

    def disable_glog_info(self):
        self._glog_info = False

    def summary(self):
        return {
            "model": self._model_prefix,
            "device": self._torch_device(),
            "ir_optim": self._ir_optim,
            "warmup": self._warmup,
            "serving": getattr(self, "_serving", None),
        }
