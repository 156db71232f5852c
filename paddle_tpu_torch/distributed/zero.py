"""Manual-collective ZeRO (stage 1/2) optimizer sharding for shard_map code
— twin of ``paddle_tpu/distributed/zero.py``.

Reference analog: fleet/meta_optimizers/sharding_optimizer.py:161,224,308 —
params assigned to shards, gradients allreduced, each rank updating its slice
then broadcasting.  This module is the explicit version for code running
inside :func:`~.mesh.shard_map` (e.g. combined with pipeline/tensor axes):

  grads --psum_scatter('dp')--> per-rank chunk   (ZeRO-2: grad shard)
  chunk + sharded Adam state  --> updated param chunk
  chunk --all_gather('dp')--> full new param     (ZeRO-1: state shard)

Every rank holds 1/dp of the optimizer state.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import lax

__all__ = ["zero_adam_update"]


def _chunk_len(size: int, n: int) -> int:
    """Per-rank chunk length for a flattened param of `size` over n ranks.
    Callers build the [_leading axes_, axis_size, chunk] state arrays
    themselves (the leading dims depend on how the param is sharded over
    other mesh axes — see hybrid_step.make_hybrid_step)."""
    return -(-size // n)


@torch.no_grad()
def zero_adam_update(params, grads, state, count, axis_name: str,
                     axis_size: int, lr=1e-3, beta1=0.9, beta2=0.999,
                     eps=1e-8, weight_decay=0.0,
                     grad_mean: bool = True) -> Tuple[dict, dict]:
    """Per-rank ZeRO update, called INSIDE a shard_map body.

    params/grads: full (replicated-view) dicts of this rank.
    state: this rank's chunk of the Adam state — {'m': {...}, 'v': {...}},
      each entry holding ``_chunk_len(size, axis_size)`` elements.
    count: the new step count (int or 0-d tensor).
    Returns (new_params_full, new_state_local)."""
    count = float(count)
    new_params, new_m, new_v = {}, {}, {}
    b1c = 1.0 - beta1 ** count
    b2c = 1.0 - beta2 ** count
    idx = lax.axis_index(axis_name)
    for name, p in params.items():
        g = grads[name]
        size = p.numel()
        c = _chunk_len(size, axis_size)
        pad = axis_size * c - size
        gf = torch.nn.functional.pad(g.reshape(-1).float(), (0, pad))
        # reduce-scatter: each rank receives the SUM of its chunk
        g_chunk = lax.psum_scatter(gf.reshape(axis_size, c), axis_name,
                                   scatter_dimension=0, tiled=False)
        if grad_mean:
            g_chunk = g_chunk / axis_size
        pf = torch.nn.functional.pad(p.detach().reshape(-1).float(),
                                     (0, pad))
        p_chunk = pf[idx * c:(idx + 1) * c]
        if weight_decay:
            g_chunk = g_chunk + weight_decay * p_chunk
        m = state["m"][name].reshape(-1)
        v = state["v"][name].reshape(-1)
        m = beta1 * m + (1 - beta1) * g_chunk
        v = beta2 * v + (1 - beta2) * g_chunk * g_chunk
        update = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        p_new_chunk = p_chunk - lr * update
        full = lax.all_gather(p_new_chunk, axis_name, tiled=True)
        new_params[name] = full[:size].reshape(p.shape).to(p.dtype)
        new_m[name] = m.reshape(state["m"][name].shape)
        new_v[name] = v.reshape(state["v"][name].shape)
    return new_params, {"m": new_m, "v": new_v}
