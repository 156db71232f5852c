"""paddle_tpu_torch.jit — twin of ``paddle_tpu.jit``: the functional
execution of Layers (``get_state``, ``functional_call``,
``tree_unwrap``/``tree_wrap``), ``to_static`` with the dy2static AST
pass and its control flow, and ``save`` / ``load`` of inference
artifacts over ``torch.export``.  Importing it registers the
``paddle_tpu_torch::attention`` operator exported programs carry."""
from . import control_flow  # noqa: F401
from . import dy2static  # noqa: F401
from .functional import (functional_call, get_state, tree_unwrap,  # noqa: F401
                         tree_wrap)
from .to_static import (InputSpec, StaticFunction, declarative,  # noqa: F401
                        not_to_static, to_static)
from .save_load import TranslatedLayer, load, save  # noqa: F401
from .dy2static import (ProgramTranslator, set_code_level,  # noqa: F401
                        set_verbosity)


class TracedLayer:
    """reference TracedLayer (fluid/dygraph/jit.py:40): a dygraph Layer
    traced into a replayable static form — here its ``to_static``
    StaticFunction; ``save_inference_model`` delegates to
    :func:`save` at the traced inputs' shapes."""

    def __init__(self, layer, static_fn, inputs=None):
        self._layer = layer
        self._fn = static_fn
        self._inputs = inputs

    @staticmethod
    def trace(layer, inputs):
        fn = to_static(layer)
        outs = fn(*inputs)
        return outs, TracedLayer(layer, fn, list(inputs))

    def __call__(self, *args):
        return self._layer(*args)

    def save_inference_model(self, path, feed=None, fetch=None, **kwargs):
        save(self._layer, path, input_spec=self._inputs)
        return path


__all__ = ["functional_call", "get_state", "tree_unwrap", "tree_wrap",
           "InputSpec", "StaticFunction", "declarative", "not_to_static",
           "to_static", "TranslatedLayer", "load", "save",
           "ProgramTranslator", "set_code_level", "set_verbosity",
           "TracedLayer", "control_flow", "dy2static"]
