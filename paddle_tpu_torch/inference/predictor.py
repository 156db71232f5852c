"""Predictor — twin of ``paddle_tpu/inference/predictor.py`` (reference
AnalysisPredictor, analysis_predictor.cc).

``create_predictor(config)`` loads a ``jit.save`` artifact — no model
class needed, also in a fresh process — on the config's device (the
card unless ``config.disable_gpu()``) and serves named inputs and
outputs::

    config = Config("model_prefix")
    predictor = create_predictor(config)
    h = predictor.get_input_handle(predictor.get_input_names()[0])
    h.copy_from_cpu(batch_np)
    predictor.run()
    out = predictor.get_output_handle(predictor.get_output_names()[0])
    result = out.copy_to_cpu()

Batch-size buckets: the exported artifact has a static batch B0; a smaller
feed batch is padded up to B0 (the last row repeated) and the fetch
sliced back, and a larger one runs in chunks of B0 whose outputs are
concatenated — one program serves every batch size (the JAX package's
rule; there a new shape would recompile, here the attention's route and
every op's shapes stay those the artifact was checked at).  The
attention in the program is the ``paddle_tpu_torch::attention``
operator: on the card it takes the flash kernels on their terms when
the program runs.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..jit.save_load import load_artifact
from ..tensor import Tensor
from .config import Config


class PredictorTensor:
    """Named feed/fetch handle (reference PaddleTensor / ZeroCopyTensor):
    host numpy arrays in and out."""

    def __init__(self, name, shape=None, dtype=None):
        self.name = name
        self._shape = shape
        self._dtype = dtype
        self._value: Optional[np.ndarray] = None

    def copy_from_cpu(self, arr):
        self._value = np.asarray(arr)

    def copy_to_cpu(self):
        return self._value

    def reshape(self, shape):
        self._shape = tuple(shape)

    @property
    def shape(self):
        return (tuple(self._value.shape) if self._value is not None
                else self._shape)

    @property
    def dtype(self):
        return self._dtype


class Predictor:
    def __init__(self, config: Config):
        self._config = config
        self._device = torch.device(config._torch_device())
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "create_predictor: the config selects the card but "
                "torch.cuda.is_available() is False — call "
                "config.disable_gpu() to run on the CPU")
        prefix = config.prog_file()[: -len(".pdmodel")]
        self._program, self._state, meta = load_artifact(
            prefix, self._device, config.params_file())
        self._fn = self._program.module()
        self._in_specs = meta["input_specs"]          # [(shape, dtype)]
        self._input_names = meta["input_names"]
        self._output_names = meta["output_names"]
        # optional pruning (onnx.export output_spec)
        self._output_indices = meta.get("output_indices")
        self._inputs: Dict[str, PredictorTensor] = {
            n: PredictorTensor(n, s, d)
            for n, (s, d) in zip(self._input_names, self._in_specs)}
        self._outputs: Dict[str, PredictorTensor] = {
            n: PredictorTensor(n) for n in self._output_names}
        if config._warmup:
            self._warmup_call()

    def _warmup_call(self):
        """Run the program once on zeros at load (analysis_predictor.cc:
        231 OptimizeInferenceProgram's place): the kernels are built
        and bound before the first request."""
        feeds = [np.zeros(s, dtype=str(d).replace("torch.", ""))
                 if d != torch.bfloat16 else np.zeros(s, np.float32)
                 for s, d in self._in_specs]
        try:
            self._call(feeds)
        except Exception as e:
            # zero ids may be out of an embedding's bounds — say so
            # instead of hiding a broken artifact
            import warnings

            warnings.warn(f"Predictor warmup call failed ({e!r}); the "
                          "first real run builds instead", stacklevel=2)

    # --- reference API ------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_input_handle(self, name) -> PredictorTensor:
        return self._inputs[name]

    def get_output_handle(self, name) -> PredictorTensor:
        return self._outputs[name]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Execute.  ``inputs``: optional positional feeds (else the
        values set on the input handles).  A feed batch smaller than the
        exported bucket is padded and sliced; a LARGER one is chunked
        over several calls and re-concatenated (analysis_predictor Run
        loop)."""
        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(a)
        vals = []
        for n in self._input_names:
            v = self._inputs[n]._value
            if v is None:
                raise ValueError(f"input {n!r} not set (copy_from_cpu first)")
            vals.append(v)

        shapes = [s for s, _ in self._in_specs]
        exported_b = shapes[0][0] if len(shapes[0]) else None
        actual_b = vals[0].shape[0] if vals and np.ndim(vals[0]) else None
        # an input is "batched" iff its exported spec shares the leading
        # batch dim; static side inputs pass through unsliced
        batched = [len(s) >= 1 and s[0] == exported_b for s in shapes]
        if (exported_b and actual_b and actual_b > exported_b
                and any(batched)
                and all((np.ndim(v) and v.shape[0] == actual_b) if b
                        else v.shape == tuple(s)
                        for v, b, s in zip(vals, batched, shapes))):
            chunks, sizes = [], []
            for lo in range(0, actual_b, exported_b):
                part = [v[lo:lo + exported_b] if b else v
                        for v, b in zip(vals, batched)]
                sizes.append(min(exported_b, actual_b - lo))
                chunks.append(self._run_once(part))
            merged = []
            for i in range(len(self._output_names)):
                outs_i = [c[i] for c in chunks]
                if all(o.ndim >= 1 and o.shape[0] == cs
                       for o, cs in zip(outs_i, sizes)):
                    merged.append(np.concatenate(outs_i, axis=0))
                else:
                    # a non-batched output: the chunks' values stacked,
                    # so nothing is silently dropped
                    merged.append(np.stack(outs_i, axis=0))
            for n, arr in zip(self._output_names, merged):
                self._outputs[n].copy_from_cpu(arr)
            return [self._outputs[n].copy_to_cpu()
                    for n in self._output_names]

        outs = self._run_once(vals)
        for n, arr in zip(self._output_names, outs):
            self._outputs[n].copy_from_cpu(arr)
        return [self._outputs[n].copy_to_cpu() for n in self._output_names]

    def _call(self, feeds):
        xs = [torch.as_tensor(np.ascontiguousarray(v)).to(
            device=self._device, dtype=d)
            for v, (_, d) in zip(feeds, self._in_specs)]
        with torch.no_grad():
            outs = list(self._fn(self._state, *xs))
        if self._output_indices is not None:
            outs = [outs[i] for i in self._output_indices]
        return outs

    def _run_once(self, vals):
        """One program call with bucket padding; numpy outputs sliced
        back to the fed batch."""
        feeds = []
        batch = None
        for n, (want, _), v in zip(self._input_names, self._in_specs, vals):
            v = np.asarray(v)
            if tuple(v.shape) != tuple(want):
                if (len(v.shape) == len(want)
                        and tuple(v.shape[1:]) == tuple(want[1:])
                        and v.shape[0] < want[0]):
                    batch = v.shape[0] if batch is None else batch
                    pad = np.repeat(v[-1:], want[0] - v.shape[0], axis=0)
                    v = np.concatenate([v, pad], axis=0)
                else:
                    raise ValueError(
                        f"input {n!r} shape {v.shape} incompatible with "
                        f"exported {tuple(want)}")
            feeds.append(v)
        result = []
        for o in self._call(feeds):
            arr = Tensor(o).numpy()
            if batch is not None and arr.ndim >= 1 \
                    and arr.shape[0] == self._in_specs[0][0][0]:
                arr = arr[:batch]
            result.append(arr)
        return result

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass


def create_predictor(config: Config) -> Predictor:
    """reference CreatePaddlePredictor (analysis_predictor.cc:602)."""
    return Predictor(config)
