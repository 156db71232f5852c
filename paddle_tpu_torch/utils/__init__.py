"""Host-side helpers shared by the ported modules, and the custom-op API
(``register_op``), the twin of ``paddle_tpu.utils``'s."""
from .custom_op import (CustomOp, get_op, register_op,  # noqa: F401
                        registered_ops, unregister_op)

__all__ = ["CustomOp", "register_op", "get_op", "registered_ops",
           "unregister_op"]
