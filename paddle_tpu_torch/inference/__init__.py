"""paddle_tpu_torch.inference — the twin of ``paddle_tpu.inference``'s
``Config`` (the reference framework's AnalysisConfig): the model paths,
the device, the parity no-ops and the serving knobs that
``serving.create_serving_engine`` / ``create_serving_frontend`` read.
The ``Predictor`` over an exported artifact is not ported (ROADMAP
queue 1 item 13)."""
from .config import Config

__all__ = ["Config"]
