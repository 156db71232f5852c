"""paddle_tpu_torch.vision — twin of ``paddle_tpu.vision``: the models
(``LeNet``, the ResNets, VGG, MobileNet) and MNIST, with ``LeNet``,
``ResNet``, ``resnet18`` and ``resnet50`` re-exported here as the
reference re-exports them.  ``image``, ``transforms`` and ``ops`` wait
(ROADMAP item 13)."""
from . import datasets, models  # noqa: F401
from .models import LeNet, ResNet, resnet18, resnet50  # noqa: F401

__all__ = ["datasets", "models", "LeNet", "ResNet", "resnet18", "resnet50"]
