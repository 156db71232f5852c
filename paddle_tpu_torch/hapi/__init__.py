"""paddle_tpu_torch.hapi — the high-level training API, twin of
``paddle_tpu/hapi`` (``hapi/anomaly.py`` is not ported: ROADMAP queue 1
item 16)."""
from . import callbacks  # noqa: F401
from .callbacks import (Callback, EarlyStopping, LRScheduler,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger, ReduceLROnPlateau,
                        VisualDL)
from .checkpoint import (TrainCheckpointer, capture_train_state,  # noqa: F401
                         restore_train_state)
from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401

__all__ = ["callbacks", "Callback", "EarlyStopping", "LRScheduler",
           "ModelCheckpoint", "ProgBarLogger", "ReduceLROnPlateau",
           "VisualDL", "TrainCheckpointer", "capture_train_state",
           "restore_train_state", "Model", "flops", "summary"]
