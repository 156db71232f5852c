"""Control flow over tensor values — twin of
``paddle_tpu/jit/control_flow.py`` (reference: operators/controlflow/
conditional_block_op.cc, while_op.cc).

The JAX package lowers these onto ``lax.cond`` / ``lax.while_loop``.
The port runs each in one of three modes, decided by where it runs:

- eagerly (dygraph, ``jit.to_static``, an ``Executor`` replay): the
  predicate is read to the host once — once per iteration for a loop —
  and the chosen branch runs, as the reference's eager path does;
- while a static Program is built (``program_guard``), ``traced_cond``
  and ``while_loop`` record themselves as ONE op over their explicit
  operands (their bodies run on the placeholders under
  ``suspend_recording``, both branches of a cond, so their outputs are
  checked to agree), and a replay takes the eager path on each run's
  values;
- while ``torch.export`` traces them (``jit.save``, ``Program.save``)
  they lower onto ``torch.cond`` and ``torch._higher_order_ops.
  while_loop``, so the exported program branches when it runs.  The
  bodies run once first with tracing off, on the traced placeholders,
  for their output structure (the operators trace them again, and take
  no side effect); the operators lift tensors a body reads from outside
  its operands.  A torch that has neither operator, or that cannot
  trace a body, refuses with a message that names it; nothing is
  unrolled.

Branch and body functions take and return Tensors; a ``cond``'s output
may be a nested list, tuple or dict of them.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..framework.export_compat import exporting, is_placeholder
from ..tensor import Tensor

__all__ = ["cond", "traced_cond", "while_loop", "scan"]


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


def _unwrap_tree(tree):
    return pytree.tree_map(_unwrap, tree)


def _wrap_tree(tree):
    return pytree.tree_map(
        lambda v: Tensor(v) if isinstance(v, torch.Tensor) else v, tree)


def _recording():
    from ..ops.dispatch import _recording_program

    return _recording_program() is not None


def _read_pred(p) -> bool:
    """The predicate read to the host (one read).  A tensor must hold one
    element: the truth of more is ambiguous (ValueError, as the JAX
    package's ``bool`` raises)."""
    p = _unwrap(p)
    if isinstance(p, torch.Tensor):
        if p.numel() != 1:
            raise ValueError(
                f"the predicate must hold one element, got shape "
                f"{list(p.shape)}: its truth value is ambiguous")
        return bool(p.reshape(()).item())
    return bool(p)


def _higher_order(name, *args):
    """``torch.cond`` or the ``while_loop`` operator called on ``args``,
    or a loud error naming it."""
    op = "torch.cond" if name == "cond" else "while_loop"
    try:
        if name == "cond":
            fn = torch.cond
        else:
            from torch._higher_order_ops.while_loop import while_loop as fn
    except (AttributeError, ImportError) as e:
        raise NotImplementedError(
            f"the installed torch {torch.__version__} has no {op} "
            "operator, so a program with a tensor-dependent branch or loop "
            "cannot be exported") from e
    try:
        return fn(*args)
    except Exception as e:
        raise NotImplementedError(
            f"{op} of torch {torch.__version__} could not trace this "
            f"{'branch' if name == 'cond' else 'loop'} for export: {e}") \
            from e


def _untraced(fn, *args):
    """``fn(*args)`` on the traced placeholders with export tracing off:
    what a body returns, recorded nowhere."""
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing

    with disable_proxy_modes_tracing():
        return fn(*args)


def _flat(tree):
    leaves, spec = pytree.tree_flatten(_unwrap_tree(tree))
    return leaves, spec


def traced_cond(pred, true_fn, false_fn, *operands):
    """``cond`` with EXPLICIT operands: the form that is also recordable
    into a static Program (pred and operands are the op's inputs, so a
    replay re-evaluates the branch on each run's values).  Branch
    functions take the operands and must not capture other tensors
    (those would be read at build time — the reference's
    conditional_block input-list rule)."""
    from ..ops._helpers import to_tensor_like
    from ..ops.dispatch import apply

    flat_ops, op_spec = pytree.tree_flatten(list(operands))
    out_spec = {}

    def leaves_of(fn, vals):
        args = pytree.tree_unflatten(list(_wrap_tree(list(vals))), op_spec)
        return _flat(fn(*args))

    def branch(fn):
        def run(*vals):
            return tuple(leaves_of(fn, vals)[0])

        return run

    def both(op_vals):
        """Both branches on placeholders: their outputs must agree in
        structure, shape and dtype; sets the output structure."""
        t_out, t_spec = leaves_of(true_fn, op_vals)
        f_out, f_spec = leaves_of(false_fn, op_vals)
        if f_spec != t_spec or [(tuple(a.shape), a.dtype) for a in t_out] \
                != [(tuple(b.shape), b.dtype) for b in f_out]:
            raise ValueError(
                "cond: true_fn and false_fn must return the same structure "
                "of tensors with equal shapes and dtypes")
        out_spec["spec"] = t_spec
        return tuple(t_out)

    def f(pred_v, *op_vals):
        from ..static.program import suspend_recording

        with suspend_recording():
            if exporting():
                _untraced(both, op_vals)
                return tuple(_higher_order(
                    "cond", pred_v.reshape(()), branch(true_fn),
                    branch(false_fn), tuple(op_vals)))
            if is_placeholder(pred_v):
                return both(op_vals)        # build time
            leaves, out_spec["spec"] = leaves_of(
                true_fn if _read_pred(pred_v) else false_fn, op_vals)
            return tuple(leaves)

    tensor_ops = [to_tensor_like(x) for x in flat_ops]
    if _recording():
        out = apply("cond", f, to_tensor_like(pred), *tensor_ops)
        leaves = list(out) if isinstance(out, (tuple, list)) else [out]
    else:
        leaves = list(_wrap_tree(list(f(_unwrap(pred), *[
            t._value for t in tensor_ops]))))
    return pytree.tree_unflatten(leaves, out_spec["spec"])


def cond(pred, true_fn, false_fn, name=None):
    """paddle.static.nn.cond parity: no-argument closures.  Eagerly (and
    in ``to_static``) one host read picks the branch; under
    ``torch.export`` it lowers onto ``torch.cond``.  While a static
    Program records, the closures' captured tensors cannot become
    program inputs, so this form raises — use :func:`traced_cond` with
    explicit operands there."""
    if _recording():
        raise TypeError(
            "control_flow.cond(no-arg closures) is not recordable into a "
            "static Program: closure-captured tensors would be read at "
            "build time. Use control_flow.traced_cond(pred, true_fn, "
            "false_fn, *operands) with every tensor dependency passed as "
            "an operand.")
    p = _unwrap(pred)
    if exporting() and isinstance(p, torch.Tensor):
        spec = _untraced(lambda: _flat(true_fn())[1])

        def branch(fn):
            def run():
                return tuple(_flat(fn())[0])

            return run

        out = _higher_order("cond", p.reshape(()), branch(true_fn),
                            branch(false_fn), ())
        return pytree.tree_unflatten(list(_wrap_tree(list(out))), spec)
    return true_fn() if _read_pred(p) else false_fn()


def while_loop(cond_fn, body_fn, loop_vars):
    """paddle.static.nn.while_loop parity: ``loop_vars`` are explicit
    (recordable); ``cond_fn`` / ``body_fn`` take them and must not
    capture other tensors (the reference's while_op input-list rule).
    Returns the final loop variables as a list."""
    from ..ops._helpers import to_tensor_like
    from ..ops.dispatch import apply

    flat_vars, var_spec = pytree.tree_flatten(list(loop_vars))

    def as_args(vals):
        return pytree.tree_unflatten(list(_wrap_tree(list(vals))), var_spec)

    def cond_(*vals):
        return _unwrap(cond_fn(*as_args(vals)))

    def leaves_of(vals):
        r = body_fn(*as_args(vals))
        if not isinstance(r, (tuple, list)):
            r = (r,)
        return _flat(list(r))

    def body_(*vals):
        leaves, spec = leaves_of(vals)
        if spec != var_spec:
            raise ValueError(
                "while_loop body must return loop_vars' structure")
        return tuple(leaves)

    def check(init_vals):
        """The body once on placeholders: it must keep each loop
        variable's structure, shape and dtype."""
        out = body_(*init_vals)
        if [(tuple(a.shape), a.dtype) for a in out] != [
                (tuple(b.shape), b.dtype) for b in init_vals]:
            raise ValueError(
                "while_loop body must keep each loop variable's shape and "
                "dtype")

    def f(*init_vals):
        from ..static.program import suspend_recording

        with suspend_recording():
            if exporting():
                _untraced(check, init_vals)
                return tuple(_higher_order(
                    "while_loop",
                    lambda *v: torch.as_tensor(cond_(*v)).reshape(()),
                    lambda *v: tuple(leaves_of(v)[0]), tuple(init_vals)))
            if any(is_placeholder(v) for v in init_vals):
                check(init_vals)            # build time
                return tuple(v.clone() for v in init_vals)
            vals = tuple(init_vals)
            while _read_pred(cond_(*vals)):
                vals = body_(*vals)
            return vals

    tensor_vars = [to_tensor_like(v) for v in flat_vars]
    if _recording():
        out = apply("while_loop", f, *tensor_vars)
        leaves = list(out) if isinstance(out, (tuple, list)) else [out]
    else:
        leaves = list(_wrap_tree(list(f(*[t._value for t in tensor_vars]))))
    return list(pytree.tree_unflatten(leaves, var_spec))


def scan(f, init, xs, length=None, reverse=False, unroll=1):
    """``lax.scan`` with Tensor carries: ``f(carry, x) -> (carry, y)``
    over the leading axis of ``xs`` (a Tensor or a tree of them), run as
    a Python loop; returns ``(carry, ys)`` with the ``y``s stacked."""
    from ..ops.manipulation import stack

    leaves, spec = pytree.tree_flatten(_wrap_tree(_unwrap_tree(xs)))
    n = length if length is not None else (leaves[0].shape[0] if leaves
                                           else 0)
    order = range(n - 1, -1, -1) if reverse else range(n)
    carry, ys = init, []
    for i in order:
        x = pytree.tree_unflatten([leaf[i] for leaf in leaves], spec)
        carry, y = f(carry, x)
        ys.append(y)
    if reverse:
        ys = ys[::-1]
    if not ys or ys[0] is None:
        return carry, None
    y_leaves = [pytree.tree_flatten(y)[0] for y in ys]
    y_spec = pytree.tree_flatten(ys[0])[1]
    stacked = [stack([yl[j] for yl in y_leaves], axis=0)
               for j in range(len(y_leaves[0]))]
    return carry, pytree.tree_unflatten(stacked, y_spec)
