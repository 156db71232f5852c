"""paddle_tpu_torch.static — declarative (graph) mode, the twin of
``paddle_tpu.static``.

Reference analog: paddle.static — Program / Executor / CompiledProgram
(fluid/framework.py:4174 Program, fluid/executor.py:916 Executor.run,
compiler.py:88).  A Program records layer calls as ops while it is
built (``program_guard``), on placeholders; ``Executor.run`` feeds it,
replays the recorded ops on the card (by default) and fetches, and
updates parameters and optimizer state in place
(``static/program.py``).  ``Program.save`` / ``save_inference_model``
write ``torch.export`` artifacts that reload without the model code.
"""
import contextlib

from . import nn  # noqa: F401
from ._mode import disable_static, enable_static, static_mode_enabled  # noqa: F401
from .program import (  # noqa: F401
    CompiledProgram,
    Executor,
    LoadedProgram,
    LoadedTrainProgram,
    Program,
    Scope,
    data,
    default_main_program,
    default_startup_program,
    global_scope,
    load_inference_program,
    load_train_program,
    program_guard,
    scope_guard,
)
from ..jit.to_static import InputSpec  # noqa: F401
from .debugging import Print  # noqa: F401
from ..framework_io import load, save  # noqa: F401
from .compat import (  # noqa: F401
    BuildStrategy, ExecutionStrategy, ParallelExecutor, Variable,
    WeightNormParamAttr, accuracy, append_backward, auc, cpu_places,
    create_parameter, cuda_places, deserialize_persistables,
    deserialize_program, device_guard, gradients, load_from_file,
    load_inference_model, load_program_state, load_vars,
    normalize_program, py_func, save_inference_model, save_to_file,
    save_vars, serialize_persistables, serialize_program,
    set_program_state, xpu_places)
from ..compat import create_global_var  # noqa: F401
from .. import amp  # noqa: F401  (the reference's static re-exports amp)


def name_scope(name):
    """reference static.name_scope: a naming context (no-op here)."""
    return contextlib.nullcontext()
