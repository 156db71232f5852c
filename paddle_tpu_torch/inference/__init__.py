"""paddle_tpu_torch.inference — the twin of ``paddle_tpu.inference``:
``Config`` (the reference framework's AnalysisConfig: the model paths,
the device, the parity no-ops and the serving knobs that
``serving.create_serving_engine`` / ``create_serving_frontend`` read)
and the ``Predictor`` over a ``jit.save`` artifact
(``create_predictor``, named input and output handles, batch buckets).
Importing it registers the attention operator the artifacts carry."""
from .config import Config
from .predictor import Predictor, PredictorTensor, create_predictor

__all__ = ["Config", "Predictor", "PredictorTensor", "create_predictor"]
