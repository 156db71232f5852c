"""Optimizers and LR schedulers — twin of ``paddle_tpu/optimizer``."""
from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam,  # noqa: F401
                        AdamDelta, Adamax, AdamW, Dpsgd, DpsgdOptimizer,
                        Ftrl, FtrlOptimizer, Lamb, Lars, Lookahead,
                        LookaheadOptimizer, ModelAverage, Momentum,
                        Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "AdamDelta", "Adadelta", "RMSProp", "Lamb", "Lars",
           "Ftrl", "FtrlOptimizer", "Dpsgd", "DpsgdOptimizer",
           "ModelAverage", "Lookahead", "LookaheadOptimizer"]
