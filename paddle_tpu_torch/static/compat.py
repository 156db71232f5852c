"""The rest of ``paddle.static`` — twin of ``paddle_tpu/static/compat.py``
(reference static/__init__.py): executors and strategies, places,
backward, parameters, ``py_func``, program (de)serialization, variable
save/load and the static metrics, over the Program machinery of
``static/program.py``."""
from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

from ..tensor import Parameter, Tensor

# -- legacy types over the modern machinery ---------------------------------

Variable = Tensor  # static Variables ARE placeholder Tensors here


class BuildStrategy:
    """CompiledProgram knobs (reference build_strategy.cc): accepted and
    recorded; a program replays eagerly, so none changes a run."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = self.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            self.GradientScaleStrategy.CoeffNumDevice
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_optimizer_ops = False
        self.fuse_all_reduce_ops = False
        self.fuse_broadcast_ops = False
        self.fuse_elewise_add_act_ops = False
        self.sync_batch_norm = False
        self.debug_graphviz_path = ""


class ExecutionStrategy:
    """Executor knobs (reference execution_strategy): kept for script
    compatibility."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


class WeightNormParamAttr:
    """ParamAttr requesting weight normalization (reference
    WeightNormParamAttr), carried through ``create_parameter``."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


class ParallelExecutor:
    """Legacy ParallelExecutor (reference parallel_executor.py): a front
    over ``CompiledProgram.with_data_parallel`` + ``Executor``."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from .program import CompiledProgram, Executor, default_main_program

        self._program = main_program or default_main_program()
        self._compiled = CompiledProgram(self._program).with_data_parallel(
            loss_name=loss_name, build_strategy=build_strategy,
            exec_strategy=exec_strategy)
        self._exe = Executor()

    def run(self, fetch_list=None, feed=None, feed_dict=None,
            return_numpy=True):
        return self._exe.run(self._compiled, feed=feed or feed_dict,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


# -- places -----------------------------------------------------------------

def cpu_places(device_count=None):
    from ..framework.place import CPUPlace

    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """The CUDA cards (card 0 by default)."""
    from ..framework.place import CUDAPlace

    ids = device_ids if device_ids is not None else [0]
    return [CUDAPlace(i) for i in ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


class device_guard:
    """reference static.device_guard: pins ops to a device in the
    program.  A program replays on its Executor's device, so the guard is
    a documented no-op context."""

    def __init__(self, device=None):
        self.device = device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# -- backward / gradients ---------------------------------------------------

def _grads_op(create_graph):
    """The recorded backward: the gradients of ``vals[:n_out]`` with
    respect to ``vals[n_out:]`` (None where not reached).  An input that
    takes no gradient at build time (a feed placeholder: the replay
    makes its feed differentiable) gets a zero placeholder."""
    def fn(n_out, *vals):
        outs, ins = vals[:n_out], vals[n_out:]
        live = [i for i, v in enumerate(ins) if v.requires_grad]
        got = torch.autograd.grad(
            outs, [ins[i] for i in live], allow_unused=True,
            create_graph=create_graph, retain_graph=True) if live else ()
        res = [torch.zeros_like(v) for v in ins]
        for i, g in zip(live, got):
            res[i] = g
        return tuple(res)

    return fn


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """reference backward.py:append_backward.  While a Program records:
    record the backward as one op, ``torch.autograd.grad`` of ``loss``
    over the parameters (the program's by default), and return
    ``[(param, grad Tensor)]``.  Eagerly: ``loss.backward``, then the
    parameters' gradients."""
    from ..ops.dispatch import _recording_program, apply

    prog = _recording_program()
    params = parameter_list
    if prog is not None:
        if params is None:
            params = [p for p in prog.all_parameters()
                      if not p.stop_gradient]
        fn = _grads_op(False)
        grads = apply("append_backward", lambda lv, *ps: fn(1, lv, *ps),
                      loss, *params)
        grads = grads if isinstance(grads, (tuple, list)) else (grads,)
        return [(p, g) for p, g in zip(params, grads) if g is not None]
    loss.backward(retain_graph=True)
    params = params if params is not None else []
    return [(p, p.grad) for p in params if p.grad is not None]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference static.gradients: the gradients of ``targets`` with
    respect to ``inputs`` (None for an input not reached), recorded as
    one op while a Program records."""
    from ..autograd import grad
    from ..ops.dispatch import _recording_program, apply

    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if _recording_program() is not None:
        if target_gradients is not None:
            raise ValueError("static.gradients: target_gradients is not "
                             "recordable; scale the targets instead")
        prog = _recording_program()
        for t in inputs:
            if any(t is v for v in prog.feed_vars):
                prog._grad_feeds.add(prog._slot(t))
        fn = _grads_op(True)
        out = apply("gradients", lambda *vs: fn(len(targets), *vs),
                    *targets, *inputs)
        return list(out) if isinstance(out, (tuple, list)) else [out]
    return grad(targets, inputs, grad_outputs=target_gradients,
                retain_graph=True, create_graph=True, allow_unused=True)


# -- parameters / global vars ----------------------------------------------

def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """reference static.create_parameter: a trainable Parameter on the
    default place; a recording Program registers it on first use.
    ``default_initializer`` is a port initializer or a function
    ``(shape, dtype) -> value``; without one, a bias is zeros and a
    weight uniform in ``±sqrt(6 / fan_in)``, as in the JAX package."""
    from ..framework import dtype as _dt
    from ..framework.place import default_device
    from ..framework.random import generator
    from ..nn.initializer import Initializer
    from ..nn.layer import make_parameter

    d = _dt.convert_dtype(dtype)
    if isinstance(default_initializer, Initializer) or attr is not None:
        return make_parameter(shape, d, attr, is_bias, default_initializer,
                              name)
    dev = default_device()
    if default_initializer is not None:
        val = default_initializer(list(shape), d)
        val = val._value if isinstance(val, Tensor) else torch.as_tensor(val)
    elif is_bias:
        val = torch.zeros(tuple(shape), dtype=d, device=dev)
    else:
        bound = float(np.sqrt(6.0 / max(shape[0] if shape else 1, 1)))
        val = (torch.rand(tuple(shape), generator=generator(dev),
                          device=dev) * 2.0 - 1.0) * bound
    return Parameter(val.to(device=dev, dtype=d), name=name)


# -- py_func ---------------------------------------------------------------

def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """reference py_func_op.cc: an arbitrary HOST Python function as an
    op, on numpy arrays; ``out`` gives each output's (shape, dtype) —
    a ``((shape), dtype)`` pair or a Tensor — and ``backward_func``
    (inputs, output grads -> input grads) the gradient.  It records into
    a Program and replays; like the reference's, a program holding one
    cannot be exported."""
    from ..framework.export_compat import exporting, is_placeholder
    from ..ops._helpers import to_tensor_like
    from ..ops.dispatch import apply

    xs = [to_tensor_like(v) for v in
          (x if isinstance(x, (list, tuple)) else [x])]

    def _is_spec(o):
        return (isinstance(o, (list, tuple)) and len(o) == 2
                and isinstance(o[0], (list, tuple)))

    single = not isinstance(out, (list, tuple)) or _is_spec(out)
    outs = [out] if single else list(out)

    def _spec(o):
        if _is_spec(o):
            return tuple(o[0]), np.dtype(o[1])
        if isinstance(o, Tensor):
            return tuple(o.shape), np.dtype(o.numpy().dtype)
        return tuple(o.shape), np.dtype(o.dtype)

    specs = [_spec(o) for o in outs]

    def host(fn, arrays, shapes):
        res = fn(*arrays)
        res = res if isinstance(res, (list, tuple)) else [res]
        return [np.asarray(r, dt).reshape(s) for r, (s, dt) in
                zip(res, shapes)]

    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *vals):
            ctx.save_for_backward(*vals)
            res = host(func, [v.detach().cpu().numpy() for v in vals], specs)
            return tuple(torch.from_numpy(r).to(vals[0].device) for r in res)

        @staticmethod
        def backward(ctx, *gs):
            vals = ctx.saved_tensors
            if backward_func is None:
                return tuple(torch.zeros_like(v) for v in vals)
            arrays = [v.detach().cpu().numpy() for v in (*vals, *gs)]
            res = host(backward_func, arrays,
                       [(tuple(v.shape), np.dtype(str(v.dtype).split(".")[-1]))
                        for v in vals])
            return tuple(torch.from_numpy(r).to(v.device)
                         for r, v in zip(res, vals))

    def op(*vals):
        if exporting():
            raise NotImplementedError(
                "py_func runs host Python: a program holding one cannot be "
                "exported (as in the reference)")
        if any(is_placeholder(v) for v in vals):
            return tuple(torch.empty(s, dtype=getattr(torch, str(dt)),
                                     device=vals[0].device)
                         for s, dt in specs)
        return Op.apply(*vals)

    res = apply("py_func", op, *xs)
    return res[0] if single else list(res)


# -- program / var persistence ---------------------------------------------

def serialize_program(feed_vars, fetch_vars, program=None, **kwargs):
    """The program's bytes: the ``Program.save`` artifact, bundled."""
    from .program import default_main_program

    program = program or default_main_program()
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "prog")
        program.save(prefix, list(fetch_vars))
        with open(prefix + ".program", "rb") as f:
            prog = f.read()
        with open(prefix + ".params", "rb") as f:
            params = f.read()
    return pickle.dumps({"program": prog, "params": params})


def deserialize_program(data, device=None):
    from .program import load_inference_program

    blob = pickle.loads(data)
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "prog")
        with open(prefix + ".program", "wb") as f:
            f.write(blob["program"])
        with open(prefix + ".params", "wb") as f:
            f.write(blob["params"])
        return load_inference_program(prefix, device)


def _state_of(params):
    return {p.name: p.numpy() for p in params}


def _assign(params, state):
    for p in params:
        if p.name in state:
            p.set_value(np.asarray(state[p.name]))


def serialize_persistables(feed_vars, fetch_vars, program=None, **kwargs):
    from .program import default_main_program

    program = program or default_main_program()
    return pickle.dumps(_state_of(program.all_parameters()))


def deserialize_persistables(program, data, executor=None):
    _assign(program.all_parameters(), pickle.loads(data))
    return program


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """Prune to the inference slice (reference normalize_program): the
    Program's ``save`` already replays only what the fetches need; this
    records them."""
    program._inference_io = (list(feed_vars), list(fetch_vars))
    return program


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    from .program import default_main_program

    program = program or default_main_program()
    program.save(path_prefix, list(fetch_vars))
    return path_prefix


def load_inference_model(path_prefix, executor=None, **kwargs):
    """``(program, feed names, fetch indices)``; the program runs on the
    executor's device (the default place without one)."""
    from .program import load_inference_program

    device = getattr(executor, "_device", None)
    loaded = load_inference_program(path_prefix, device)
    return loaded, loaded.feed_names, list(range(loaded._n_fetch))


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    from .program import default_main_program

    program = main_program or default_main_program()
    ps = vars or program.all_parameters()
    if predicate is not None:
        ps = [p for p in ps if predicate(p)]
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, filename or "__all__.pdvars"),
              "wb") as f:
        pickle.dump(_state_of(ps), f)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    from .program import default_main_program

    program = main_program or default_main_program()
    with open(os.path.join(dirname, filename or "__all__.pdvars"),
              "rb") as f:
        state = pickle.load(f)
    ps = vars or program.all_parameters()
    if predicate is not None:
        ps = [p for p in ps if predicate(p)]
    _assign(ps, state)


def load_program_state(model_path, var_list=None):
    path = model_path if model_path.endswith(".pdvars") \
        else model_path + ".pdvars"
    with open(path, "rb") as f:
        return pickle.load(f)


def set_program_state(program, state_dict):
    _assign(program.all_parameters(), state_dict)


# -- static metrics ---------------------------------------------------------

def accuracy(input, label, k=1, correct=None, total=None):
    """reference static accuracy op: top-k accuracy as a 0-d Tensor."""
    from ..metric.metrics import accuracy as _accuracy

    return _accuracy(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """reference static auc op (one batch): ROC-AUC of the positive
    class's scores, the trapezoid over ``num_thresholds + 1``
    thresholds.  Returns ``(auc, auc, [auc])``."""
    from ..ops._helpers import to_tensor_like
    from ..ops.dispatch import apply

    def f(probs, y):
        pos = probs[:, 1] if probs.dim() == 2 else probs.reshape(-1)
        y = y.reshape(-1)
        thresh = torch.linspace(0, 1, num_thresholds + 1,
                                device=probs.device, dtype=pos.dtype)
        pred_pos = pos[None, :] >= thresh[:, None]
        tp = (pred_pos & (y[None] == 1)).sum(dim=1)
        fp = (pred_pos & (y[None] == 0)).sum(dim=1)
        n_pos = torch.clamp((y == 1).sum(), min=1)
        n_neg = torch.clamp((y == 0).sum(), min=1)
        tpr = (tp / n_pos).flip(0)
        fpr = (fp / n_neg).flip(0)
        return torch.trapezoid(tpr, fpr).to(torch.float32)

    out = apply("auc", f, to_tensor_like(input), to_tensor_like(label))
    return out, out, [out]
