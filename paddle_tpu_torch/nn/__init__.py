"""paddle_tpu_torch.nn — the paddle layer API of the dygraph core
(twins of ``paddle_tpu/nn``'s ``Layer``, ``Linear``, ``Sequential``,
``Flatten``, ``Conv2D``, ``MaxPool2D``, ``ReLU`` and the initializers),
plus the decoding loops of the serving slices (``nn.decode``)."""
from .activation_layers import ReLU  # noqa: F401
from .common_layers import Flatten, Linear  # noqa: F401
from .container import Sequential  # noqa: F401
from .conv_layers import Conv2D  # noqa: F401
from .layer import Layer, state_from_numpy  # noqa: F401
from .pool_layers import MaxPool2D  # noqa: F401

__all__ = ["Layer", "Linear", "Flatten", "Sequential", "Conv2D",
           "MaxPool2D", "ReLU", "state_from_numpy"]
