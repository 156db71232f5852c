"""paddle_tpu_torch.jit — twin of ``paddle_tpu.jit``'s functional
execution (``get_state``, ``functional_call``, ``tree_unwrap``).
``to_static``, ``save`` / ``load`` and the control-flow ops are not
ported (ROADMAP queue 1 item 13)."""
from .functional import functional_call, get_state, tree_unwrap  # noqa: F401

__all__ = ["functional_call", "get_state", "tree_unwrap"]
