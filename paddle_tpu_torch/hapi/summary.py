"""Model summary — twin of ``paddle_tpu/hapi/summary.py``: a table of each
sublayer's own parameter count, and the totals, for a port ``nn.Layer``
or a ``torch.nn.Module`` (its ``named_modules``)."""
from __future__ import annotations

import torch

__all__ = ["summary", "flops"]


def _own_params(layer):
    if isinstance(layer, torch.nn.Module):
        return [(p, p.requires_grad) for p in layer.parameters(recurse=False)]
    return [(p._value, getattr(p, "trainable", True))
            for _, p in layer.named_parameters(include_sublayers=False)]


def _layers(net):
    if isinstance(net, torch.nn.Module):
        return [(name, m, not any(True for _ in m.children()))
                for name, m in net.named_modules()]
    return [(name, layer, not layer._sub_layers)
            for name, layer in net.named_sublayers(include_self=True)]


def summary(net, input_size=None, dtypes=None, input=None):
    rows = []
    total_params = 0
    trainable_params = 0
    for name, layer, leaf in _layers(net):
        n_params = 0
        for p, trainable in _own_params(layer):
            n_params += p.numel()
            total_params += p.numel()
            if trainable:
                trainable_params += p.numel()
        if n_params or leaf:
            rows.append((name or type(net).__name__, type(layer).__name__,
                         n_params))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Layer':<{width}}{'Type':<28}{'Params':>12}",
             "-" * (width + 40)]
    for name, ty, n in rows:
        lines.append(f"{name:<{width}}{ty:<28}{n:>12,}")
    lines.append("-" * (width + 40))
    lines.append(f"Total params: {total_params:,}")
    lines.append(f"Trainable params: {trainable_params:,}")
    print("\n".join(lines))
    return {"total_params": total_params, "trainable_params": trainable_params}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The JAX package's lower bound: 2 × the parameter count."""
    return 2 * sum(p.numel() for _, layer, _ in _layers(net)
                   for p, _ in _own_params(layer))
