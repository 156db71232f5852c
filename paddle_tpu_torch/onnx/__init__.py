"""paddle.onnx analog — twin of ``paddle_tpu/onnx/__init__.py``
(reference: python/paddle/onnx/export.py:21).

The reference exports to ONNX via paddle2onnx for cross-runtime
serving.  The port's portable serving artifact is a ``torch.export``
program: ``export`` traces the layer at the given input_spec and writes
the artifact set of ``jit.save`` (``<path>.pdmodel``, ``.pdiparams``,
``.pdmeta``), so it round-trips through ``jit.load`` and
``inference.create_predictor``."""
from .export import export

__all__ = ["export"]
