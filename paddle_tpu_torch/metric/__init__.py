"""paddle_tpu_torch.metric — twin of ``paddle_tpu/metric``."""
from .metrics import Accuracy, Auc, Metric, Precision, Recall, accuracy

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
