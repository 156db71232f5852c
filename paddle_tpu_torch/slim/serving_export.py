"""PTQ → serving bridge: the quantization data the int8 serving arm
consumes — twin of ``paddle_tpu/slim/serving_export.py`` (and of
``_quantize_weight`` in ``paddle_tpu/slim/int8_layers.py``).

``export_serving_quant`` returns the JAX package's layout unchanged, so
an export made by either package loads into the other:

``{"weight_dtype", "kv_cache_dtype",
   "weights":   {param_name: (int8 [K, N], fp32 [N])},   # per-out-channel
   "kv_scales": {"k": [L x fp32 [H]], "v": [L x fp32 [H]]} | None}``

Weights are ``[in, out]`` (``x @ w``), read from ``text.models.
numpy_state``, and quantized by the same numpy recipe as the JAX
package, so the int8 bytes and scales are identical.  KV scales come
from teacher-forcing calibration prompts through the port's dense decode
step (per-layer-per-head abs-max of the K/V caches).  Without
calibration prompts the export carries ``kv_scales=None`` and the engine
runs dynamic per-page scales.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["export_serving_quant", "quantize_gpt_weights",
           "calibrate_kv_scales", "GPT_QUANT_WEIGHT_SUFFIXES"]

# the serving hot path's matmuls: attention projections + MLP.  The tied
# embedding/head (wte) stays float — it doubles as the token-embedding
# gather and feeds the greedy argmax, where rounding bites hardest.
GPT_QUANT_WEIGHT_SUFFIXES = (
    "attn.q_proj.weight", "attn.k_proj.weight", "attn.v_proj.weight",
    "attn.out_proj.weight", "fc1.weight", "fc2.weight",
)


def _quantize_weight(w, channel_axis, bits=8):
    """-> (int8 weights, per-channel f32 dequant scales)."""
    qmax = float(2 ** (bits - 1) - 1)
    w = np.asarray(w)
    axes = tuple(i for i in range(w.ndim) if i != channel_axis)
    scale = np.maximum(np.abs(w).max(axis=axes), 1e-9)
    shape = [1] * w.ndim
    shape[channel_axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape) * qmax), -qmax, qmax)
    return q.astype(np.int8), (scale / qmax).astype(np.float32)


def quantize_gpt_weights(model, weight_bits: int = 8
                         ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per-output-channel abs-max quantization of every serving-path
    matmul weight; data-free.  Returns {name: (int8 [K, N], fp32 [N])}
    keyed by the parameter names ``text/generation.py`` uses."""
    from ..text.models import numpy_state

    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for name, w in numpy_state(model).items():
        if not name.startswith("layers."):
            continue
        if not any(name.endswith(s) for s in GPT_QUANT_WEIGHT_SUFFIXES):
            continue
        # weights are [in, out] (x @ w): output channel axis is 1
        out[name] = _quantize_weight(w, channel_axis=1, bits=weight_bits)
    if not out:
        raise ValueError("model has no layers.*.{attn,fc}.weight params — "
                         "not a text.models.GPTModel?")
    return out


@torch.no_grad()
def calibrate_kv_scales(model, calib_prompts, margin: float = 1.0,
                        bits: int = 8) -> Dict[str, list]:
    """Per-layer-per-head KV scales from teacher-forcing calibration
    prompts ([B, P] int tokens) through the dense decode step, on the
    model's device.

    ``margin`` multiplies the observed abs-max (>1.0 leaves headroom for
    decode-time activations the calibration set missed; out-of-range
    values CLIP at ±qmax rather than wrapping)."""
    from ..text.generation import make_gpt_decode_step

    prompts = np.asarray(calib_prompts, np.int64).astype(np.int32)
    if prompts.ndim == 1:
        prompts = prompts[None, :]
    if prompts.ndim != 2 or prompts.size == 0:
        raise ValueError("calib_prompts must be a non-empty [B, P] token "
                         "array")
    B, P = prompts.shape
    step_fn, init_state = make_gpt_decode_step(model, max_len=P + 1)
    state = init_state(B)
    toks = torch.as_tensor(prompts, device=model.device)
    for t in range(P):
        _, state = step_fn(toks[:, t], state)
    qmax = float(2 ** (bits - 1) - 1)
    scales = {"k": [], "v": []}
    for side in ("k", "v"):
        for cache in state[side]:                       # [B, max_len, H, D]
            amax = cache[:, :P].abs().amax(dim=(0, 1, 3)).cpu().numpy()
            scales[side].append(np.maximum(
                amax * float(margin) / qmax, 1e-8).astype(np.float32))
    return scales


def export_serving_quant(model, calib_prompts=None,
                         weight_dtype: Optional[str] = "int8",
                         kv_cache_dtype: Optional[str] = "int8",
                         margin: float = 1.0) -> dict:
    """One-call export of everything the quantized serving path needs;
    feed the result to ``create_serving_engine(..., quant_scales=...)``
    or ``text.generation.generate(quant=...)``.

    ``calib_prompts=None`` skips KV calibration: the engine then runs
    dynamic per-page scales (``generate`` requires calibration for its
    dense int8 cache and rejects such an export)."""
    for d, knob in ((weight_dtype, "weight_dtype"),
                    (kv_cache_dtype, "kv_cache_dtype")):
        if d not in (None, "int8"):
            raise ValueError(f"{knob} must be None or 'int8', got {d!r}")
    out = {"weight_dtype": weight_dtype, "kv_cache_dtype": kv_cache_dtype,
           "weights": None, "kv_scales": None}
    if weight_dtype == "int8":
        out["weights"] = quantize_gpt_weights(model)
    if kv_cache_dtype == "int8" and calib_prompts is not None:
        out["kv_scales"] = calibrate_kv_scales(model, calib_prompts,
                                               margin=margin)
    return out
