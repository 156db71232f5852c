"""paddle_tpu_torch.hapi — the high-level training API, twin of
``paddle_tpu/hapi``."""
from . import callbacks  # noqa: F401
from .anomaly import (AnomalyPolicy, AnomalyRuntime,  # noqa: F401
                      LossSpikeDetector, ParameterAudit)
from .callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau,
                        VisualDL)
from .checkpoint import (TrainCheckpointer, capture_train_state,  # noqa: F401
                         restore_train_state)
from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401

__all__ = ["callbacks", "Callback", "EarlyStopping", "LRScheduler",
           "ModelCheckpoint", "ProgBarLogger", "ReduceLROnPlateau",
           "VisualDL", "AnomalyPolicy", "AnomalyRuntime",
           "LossSpikeDetector", "ParameterAudit", "TrainCheckpointer",
           "capture_train_state", "restore_train_state", "Model", "flops",
           "summary"]
