"""Process-global defaults — twin of ``paddle_tpu/framework/_globals.py``
(the reference's platform/init.cc globals)."""
import numpy as np

DEFAULT_DTYPE = np.dtype("float32")
DEFAULT_PLACE = None  # resolved lazily by place.default_place()
