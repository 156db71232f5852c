"""paddle_tpu_torch.vision — twins of ``paddle_tpu.vision``'s LeNet and
MNIST."""
from . import datasets, models  # noqa: F401
