"""onnx.export-shaped entry — twin of ``paddle_tpu/onnx/export.py``
(reference python/paddle/onnx/export.py:21)."""
from __future__ import annotations

import pickle


def export(layer, path, input_spec=None, opset_version=None, **configs):
    """Export ``layer`` as a ``jit.save`` inference artifact.

    Signature-compatible with the reference ``paddle.onnx.export``:
    ``opset_version`` is accepted and ignored (the program carries
    torch's own versioning); ``configs['output_spec']`` keeps only the
    listed outputs, as the reference does.  A trailing ``.onnx`` is
    dropped from ``path``.  Returns the artifact prefix."""
    from .. import jit
    from ..framework.export_compat import torch_export

    torch_export()  # fail fast with a clear error before writing anything
    if path.endswith(".onnx"):
        path = path[: -len(".onnx")]
    output_spec = configs.pop("output_spec", None)
    jit.save(layer, path, input_spec=input_spec, **configs)
    if output_spec is not None:
        _prune_outputs(path, output_spec)
    return path


def _prune_outputs(path, output_spec):
    """Keep only the requested outputs: entries are integer positions,
    exported output names ('out_2') or objects with a matching ``.name``;
    the Predictor and ``jit.load`` serve exactly the selected positions
    (meta['output_indices'])."""
    with open(path + ".pdmeta", "rb") as f:
        meta = pickle.load(f)
    names = meta["output_names"]
    indices = []
    for spec in output_spec:
        if isinstance(spec, int):
            idx = spec
        else:
            name = spec if isinstance(spec, str) else getattr(spec, "name",
                                                              None)
            if name not in names:
                raise ValueError(
                    f"output_spec entry {spec!r} does not match any exported "
                    f"output {names}")
            idx = names.index(name)
        if not 0 <= idx < len(names):
            raise ValueError(f"output_spec index {idx} out of range "
                             f"(model has {len(names)} outputs)")
        indices.append(idx)
    meta["output_indices"] = indices
    meta["output_names"] = [names[i] for i in indices]
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f, protocol=4)
