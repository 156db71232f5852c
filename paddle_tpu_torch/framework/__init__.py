"""Framework primitives of the port — copies of the ``paddle_tpu.framework``
surface, not imports of it: dtypes, places, flags, typed errors, the
stat registry, named locks and the seeded generators, re-exported here
as the JAX package's ``framework/__init__.py`` re-exports them, with the
process init (``init.py``) and the op version registry
(``op_version.py``).  (``Generator`` and ``rng_scope`` wait for ROADMAP
step E3.)"""
from . import _globals  # noqa: F401
from .dtype import (  # noqa: F401
    bfloat16,
    bool_,
    complex64,
    complex128,
    convert_dtype,
    dtype_name,
    float16,
    float32,
    float64,
    get_default_dtype,
    int8,
    int16,
    int32,
    int64,
    is_floating,
    is_integer,
    set_default_dtype,
    uint8,
)
from .errors import (  # noqa: F401
    EnforceNotMet,
    InvalidArgumentError,
    NotFoundError,
    OutOfRangeError,
    PreconditionNotMetError,
    UnimplementedError,
    enforce,
    enforce_eq,
)
from .flags import define_flag, flag_value, get_flags, set_flags  # noqa: F401
# the module stays reachable as framework.init: its `init` function is
# not re-exported over it
from .init import (init_devices, init_signal_handlers,  # noqa: F401
                   register_shutdown_hook)
from .op_version import op_version_registry  # noqa: F401
from .monitor import (stat_add, stat_get, stat_registry,  # noqa: F401
                      stat_reset)
from .place import (  # noqa: F401
    CPUPlace,
    CUDAPinnedPlace,
    CUDAPlace,
    Place,
    TPUPlace,
    XPUPlace,
    default_place,
    get_device,
    is_compiled_with_cuda,
    is_compiled_with_tpu,
    is_compiled_with_xpu,
    set_device,
)
from .random import get_rng_state, seed, set_rng_state  # noqa: F401
