"""dy2static: AST conversion of Python control flow over tensor values —
twin of ``paddle_tpu/jit/dy2static.py`` (the AST pass is copied from it,
framework-neutral code; only the tensor test and the lowering differ).

Reference analog: fluid/dygraph/dygraph_to_static/program_translator.py:
233,756 (StaticFunction/ProgramTranslator) + dygraph_to_static/
convert_operators.py.  A single-pass rewrite turns ``if`` / ``while`` /
``for _ in range(...)`` statements into *runtime-dispatched* converter
calls: a concrete (non-tensor) condition keeps plain-Python semantics
bit-for-bit, while a tensor condition inside ``jit.to_static``, a static
Program being built or a ``torch.export`` trace goes through
``jit.control_flow`` — one host read of the predicate when it runs
eagerly, one recorded op in a Program, ``torch.cond`` / ``while_loop``
in an exported program — so the same source runs eagerly AND converts
under ``@to_static`` without hand-rewriting.

The supported subset (the reference's common cases):
- ``if``/``elif``/``else`` whose branches assign local names (assignment
  form), or whose branches both end in ``return`` — including the
  ``if: return A``-then-fallthrough-``return B`` pattern, which is
  normalized by absorbing the trailing statements into the else branch.
- ``while`` with tensor-carried locals (no break/continue/return inside).
- ``for <name> in range(...)`` (converted to a counted while).
- ``and`` / ``or`` / ``not`` over tensor conditions (reference
  logical_transformer.py): concrete operands keep Python's exact
  short-circuit and value-returning semantics; tensor operands lower to
  logical_and/or/not.

A loop whose Python variable changes inside a tensor-bound ``while`` is
refused (only tensors can be loop-carried), as in the JAX package.
Anything outside the subset is left untouched, so it keeps the loud
error of ``Tensor.__bool__``/``__int__`` inside ``to_static`` that maps
the fix (``jit/control_flow.py``) — never a silent specialization.
"""
from __future__ import annotations

import ast
import functools
import inspect
import itertools
import sys
import textwrap
import types
from typing import Tuple

import numpy as np

from ..framework.export_compat import capturing, is_placeholder
from ..tensor import Tensor
from . import control_flow


# --------------------------------------------------------------------------
# runtime converters (reference convert_operators.py: convert_ifelse,
# convert_while_loop, convert_len, ...)
# --------------------------------------------------------------------------

class _Undef:
    """Placeholder for a local that is not yet bound at the conversion
    point (reference dy2static UndefinedVar)."""
    __slots__ = ()

    def __repr__(self):
        return "<dy2static undefined local>"


UNDEF = _Undef()


def _needs_trace(x) -> bool:
    """True when `x` is a Tensor whose Python truthiness is not to be
    used: inside ``to_static`` (the JAX package's tracer), while a
    static Program records, or a placeholder (a ``torch.export`` trace
    or a build-time value)."""
    if not isinstance(x, Tensor):
        return False
    if capturing() or is_placeholder(x._value):
        return True
    from ..ops.dispatch import _recording_program

    return _recording_program() is not None


def _split_tensor_slots(args):
    idx = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
    base = list(args)

    def rebuild(tensors):
        full = list(base)
        for i, t in zip(idx, tensors):
            full[i] = t
        return full

    return idx, base, rebuild


def convert_ifelse(pred, true_fn, false_fn, args):
    """Runtime dispatch for a rewritten ``if``.

    Concrete pred -> plain Python branch.  Tensor pred ->
    control_flow.traced_cond with the *tensor* operands passed explicitly
    (recordable into a static Program); non-tensor operands are
    constants and ride the closures.
    """
    if not _needs_trace(pred):
        return true_fn(*args) if pred else false_fn(*args)
    idx, base, rebuild = _split_tensor_slots(args)

    def lift(fn):
        def run(*tensors):
            return fn(*rebuild(tensors))

        return run

    return control_flow.traced_cond(
        pred, lift(true_fn), lift(false_fn), *[base[i] for i in idx])


def convert_while(cond_fn, body_fn, args, names=None):
    """Runtime dispatch for a rewritten ``while``.

    The loop variables are passed and returned positionally; in the
    tensor path only Tensor slots are carried through
    control_flow.while_loop, and a non-tensor slot that the body mutates
    raises (it cannot be loop-carried — make it a tensor)."""
    args = tuple(args)
    r = cond_fn(*args)
    if not _needs_trace(r):
        while r:
            args = tuple(body_fn(*args))
            r = cond_fn(*args)
        return args
    idx, base, rebuild = _split_tensor_slots(args)

    def cond_(*ts):
        return cond_fn(*rebuild(ts))

    def body_(*ts):
        new = tuple(body_fn(*rebuild(ts)))
        for j, (old, nv) in enumerate(zip(base, new)):
            if j in idx:
                continue
            same = nv is old
            if not same:
                try:
                    same = bool(nv == old)
                except Exception:
                    same = False
            if not same:
                nm = names[j] if names and j < len(names) else f"#{j}"
                raise TypeError(
                    f"dy2static: loop variable {nm!r} is a Python value "
                    f"that changes inside a traced while loop; only "
                    f"tensors can be loop-carried — initialize it as a tensor "
                    f"(e.g. paddle.to_tensor(...)) before the loop.")
        return tuple(new[j] for j in idx)

    outs = control_flow.while_loop(cond_, body_, [base[i] for i in idx])
    return tuple(rebuild(outs))


def convert_for_range(range_args, body_fn, args, names=None):
    """Runtime dispatch for a rewritten ``for <name> in range(...)``.

    Concrete bounds -> plain Python loop.  Tensor bounds -> a counted
    while loop with the index carried as an int32 tensor (the body
    receives a Tensor index)."""
    ra = tuple(range_args)
    if len(ra) == 1:
        lo, hi, step = 0, ra[0], 1
    elif len(ra) == 2:
        lo, hi, step = ra[0], ra[1], 1
    else:
        lo, hi, step = ra
    if not any(_needs_trace(v) for v in (lo, hi, step)):
        args = tuple(args)
        for i in range(int(lo), int(hi), int(step)):
            args = tuple(body_fn(i, *args))
        return args
    if _needs_trace(step):
        raise TypeError(
            "dy2static: a traced-tensor range() step is not supported; "
            "use a concrete step or jit.control_flow.while_loop directly.")
    from ..ops._helpers import to_tensor_like

    step_c = int(step)
    if step_c == 0:
        raise ValueError("range() arg 3 must not be zero")
    like = hi if isinstance(hi, Tensor) else None
    i0 = (lo if isinstance(lo, Tensor)
          else to_tensor_like(np.asarray(lo, np.int32), like))

    def wcond(i, *vs):
        return (i < hi) if step_c > 0 else (i > hi)

    def wbody(i, *vs):
        new = tuple(body_fn(i, *vs))
        return (i + step_c,) + new

    outs = convert_while(wcond, wbody, (i0,) + tuple(args),
                         names=("<range index>",) + tuple(names or ()))
    return tuple(outs[1:])


def _convert_logical(fx, fy, short_circuit_on, jop_name):
    """Shared body of the rewritten ``and``/``or`` (reference
    convert_operators.py _run_py_logical_*).  Concrete left operand keeps
    exact Python semantics: short-circuit included, the OPERAND VALUE
    returned (never a bool cast) — so `cfg or x` still yields x itself.
    Only a tensor LEFT operand lowers to the elementwise logical op
    (both sides evaluate, as in the JAX package)."""
    x = fx()
    if not _needs_trace(x):
        if bool(x) == short_circuit_on:
            return x
        return fy()
    from ..ops import logic

    return getattr(logic, jop_name)(x, fy())


def convert_logical_and(fx, fy):
    """Rewritten ``a and b``."""
    return _convert_logical(fx, fy, False, "logical_and")


def convert_logical_or(fx, fy):
    """Rewritten ``a or b``."""
    return _convert_logical(fx, fy, True, "logical_or")


def convert_logical_not(x):
    """Rewritten ``not a`` (reference convert_logical_not)."""
    if not _needs_trace(x):
        return not x
    from ..ops.logic import logical_not

    return logical_not(x)


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


# --------------------------------------------------------------------------
# AST pass
# --------------------------------------------------------------------------

_counter = itertools.count()

_HELPER = "_ptpu_dy2s"
_UNDEF_NAME = "_ptpu_undef"


# nodes that open a new binding scope: names STORED inside them are not
# locals of the enclosing function (reads still resolve outward, so read
# collection walks into them)
_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.Lambda, ast.ListComp, ast.SetComp, ast.DictComp,
                ast.GeneratorExp)


def _walk_pruned(node, prune, descend_root=False):
    """ast.walk that does not descend into `prune`-typed nodes (the nodes
    themselves are still yielded).  `descend_root` exempts the root —
    needed when analyzing a FunctionDef's own body."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, prune) and not (descend_root and n is node):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _collect_locals(fdef: ast.FunctionDef) -> set:
    a = fdef.args
    names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    for n in _walk_pruned(fdef, _SCOPE_NODES, descend_root=True):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            names.add(n.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for al in n.names:
                names.add((al.asname or al.name).split(".")[0])
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)) and n is not fdef:
            names.add(n.name)
    return names


def _reads_writes(nodes) -> Tuple[set, set]:
    reads, writes = set(), set()
    for node in nodes:
        # reads: full walk — code in nested scopes still resolves free
        # names outward, so they must become operands
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                reads.add(n.id)
        # writes: pruned — a store inside a nested scope binds there,
        # not in the enclosing function
        for n in _walk_pruned(node, _SCOPE_NODES):
            if isinstance(n, ast.Name) and not isinstance(n.ctx, ast.Load):
                writes.add(n.id)
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                for al in n.names:
                    writes.add((al.asname or al.name).split(".")[0])
            elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                writes.add(n.name)
    return reads, writes


def _owns_break_continue(stmts) -> bool:
    """Break/Continue at this loop level (not inside a nested loop)."""
    found = False

    def scan(body):
        nonlocal found
        for st in body:
            if isinstance(st, (ast.Break, ast.Continue)):
                found = True
                return
            if isinstance(st, (ast.For, ast.While, ast.FunctionDef,
                               ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # inner loop/scope owns its own break
            for field in ("body", "orelse", "finalbody"):
                scan(getattr(st, field, []) or [])
            for h in getattr(st, "handlers", []) or []:
                scan(h.body)

    scan(stmts)
    return found


def _has_unsupported(stmts, allow_terminal_return=False) -> bool:
    """True if extracting `stmts` into a nested function would change
    semantics: returns (except one terminal), attribute/subscript stores,
    global/nonlocal, yield/await, star-unpack side channels."""
    n_return = 0
    for node in stmts:
        # global/nonlocal anywhere (even nested scopes) reaches outward
        for n in ast.walk(node):
            if isinstance(n, (ast.Global, ast.Nonlocal)):
                return True
        for n in _walk_pruned(node, _SCOPE_NODES):
            if isinstance(n, _SCOPE_NODES):
                continue  # nested scope keeps its own returns/yields
            if isinstance(n, ast.Return):
                n_return += 1
            elif isinstance(n, (ast.Yield, ast.YieldFrom, ast.Await)):
                return True
            elif isinstance(n, (ast.Attribute, ast.Subscript)) and \
                    not isinstance(n.ctx, ast.Load):
                return True
    if allow_terminal_return:
        terminal = stmts and isinstance(stmts[-1], ast.Return)
        return not (terminal and _return_count_matches(stmts, n_return))
    return n_return > 0


def _return_count_matches(stmts, n_return) -> bool:
    # every Return must be the terminal one or terminal inside an
    # already-converted branch (which shows up as a plain trailing
    # Return of a converter call).  Conservative: allow only returns
    # that are the last statement of some statement list.
    ok = 0

    def scan(body):
        nonlocal ok
        for i, st in enumerate(body):
            if isinstance(st, ast.Return):
                if i == len(body) - 1:
                    ok += 1
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                scan(getattr(st, field, []) or [])
            for h in getattr(st, "handlers", []) or []:
                scan(h.body)

    scan(stmts)
    return ok == n_return


def _stmts(template: str, **subs) -> list:
    """Parse a small code template into statements."""
    return ast.parse(textwrap.dedent(template.format(**subs))).body


def _make_branch_fn(name: str, params, body) -> ast.FunctionDef:
    args = ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=p) for p in params],
        vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
        defaults=[])
    return ast.FunctionDef(name=name, args=args, body=list(body),
                           decorator_list=[], returns=None,
                           type_params=[])


def _ret_tuple(names) -> ast.Return:
    return ast.Return(value=ast.Tuple(
        elts=[ast.Name(id=n, ctx=ast.Load()) for n in names],
        ctx=ast.Load()))


def _name_tuple_target(names) -> ast.Tuple:
    return ast.Tuple(elts=[ast.Name(id=n, ctx=ast.Store()) for n in names],
                     ctx=ast.Store())


def _guards(operands, assigned) -> list:
    """`x = x if 'x' in dir() else _ptpu_undef` for possibly-unbound
    operands (reference dy2static UndefinedVar fill)."""
    out = []
    for n in sorted(set(operands) - set(assigned)):
        out.extend(_stmts(
            "{n} = {n} if {n!r} in dir() else {u}", n=n, u=_UNDEF_NAME))
    return out


def _lambda0(body):
    return ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                           kwonlyargs=[], kw_defaults=[], kwarg=None,
                           defaults=[]),
        body=body)


_LAMBDA_UNSAFE = (ast.NamedExpr, ast.Yield, ast.YieldFrom, ast.Await)


def _lambda_safe(node):
    """Wrapping an operand in a zero-arg lambda re-scopes `:=` bindings
    and strands `yield`s — leave such expressions untouched (they keep
    the loud traced-bool error instead of silently misbehaving)."""
    return not any(isinstance(n, _LAMBDA_UNSAFE) for n in ast.walk(node))


class _BoolOpRewriter(ast.NodeTransformer):
    """Expression pass: ``and``/``or``/``not`` over potentially-traced
    values become runtime-dispatched converter calls (reference
    logical_transformer.py).  Operands ride zero-arg lambdas so the
    concrete path keeps Python's exact short-circuit + value semantics."""

    def __init__(self):
        self.count = 0

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        if not all(_lambda_safe(v) for v in node.values):
            return node
        name = ("convert_logical_and" if isinstance(node.op, ast.And)
                else "convert_logical_or")
        expr = node.values[0]
        for v in node.values[1:]:
            expr = ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id=_HELPER, ctx=ast.Load()),
                    attr=name, ctx=ast.Load()),
                args=[_lambda0(expr), _lambda0(v)], keywords=[])
            self.count += 1
        return ast.copy_location(expr, node)

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if not isinstance(node.op, ast.Not):
            return node
        if not _lambda_safe(node.operand):
            return node
        self.count += 1
        return ast.copy_location(ast.Call(
            func=ast.Attribute(
                value=ast.Name(id=_HELPER, ctx=ast.Load()),
                attr="convert_logical_not", ctx=ast.Load()),
            args=[node.operand], keywords=[]), node)


class _Converter:
    """Statement-level rewriter for one function scope."""

    def __init__(self, scope_locals: set):
        self.locals = scope_locals
        self.count = 0

    # -- helpers ----------------------------------------------------------

    def _operands(self, nodes, include_writes=True):
        reads, writes = _reads_writes(nodes)
        ops = reads | (writes if include_writes else set())
        return sorted(ops & self.locals)

    # -- statement lists --------------------------------------------------

    def transform_body(self, stmts, assigned: set) -> list:
        out = []
        i = 0
        while i < len(stmts):
            st = stmts[i]
            if isinstance(st, ast.If):
                rest = stmts[i + 1:]
                new, consumed = self._convert_if(st, rest, assigned)
                out.extend(new)
                if consumed:
                    return out
                _, w = _reads_writes([st])
                assigned |= w
                i += 1
                continue
            if isinstance(st, ast.While):
                out.extend(self._convert_while(st, assigned))
            elif isinstance(st, ast.For):
                out.extend(self._convert_for(st, assigned))
            else:
                self._recurse(st, assigned)
                out.append(st)
            _, w = _reads_writes([st])
            assigned |= w
            i += 1
        return out

    def _recurse(self, st, assigned):
        """Transform compound statements' inner bodies in place."""
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = _Converter(_collect_locals(st))
            st.body = inner.transform_body(st.body, set())
            self.count += inner.count
            return
        for field in ("body", "orelse", "finalbody"):
            body = getattr(st, field, None)
            if body:
                setattr(st, field, self.transform_body(body, set(assigned)))
        for h in getattr(st, "handlers", []) or []:
            h.body = self.transform_body(h.body, set(assigned))

    # -- if ---------------------------------------------------------------

    def _convert_if(self, node: ast.If, rest, assigned):
        node.body = self.transform_body(node.body, set(assigned))
        node.orelse = self.transform_body(node.orelse, set(assigned))

        t_term = bool(node.body) and isinstance(node.body[-1], ast.Return)
        e_term = bool(node.orelse) and isinstance(node.orelse[-1],
                                                  ast.Return)

        # return-form: both branches end in return (after optionally
        # absorbing the trailing statements as the else branch)
        absorb = (t_term and not node.orelse and rest)
        if absorb:
            absorbed = self.transform_body(list(rest), set(assigned))
            e_term = bool(absorbed) and isinstance(absorbed[-1], ast.Return)
        else:
            absorbed = None

        orelse = absorbed if absorb else node.orelse
        if t_term and e_term and \
                not _has_unsupported(node.body, allow_terminal_return=True) \
                and not _has_unsupported(orelse,
                                         allow_terminal_return=True) \
                and not _owns_break_continue(node.body) \
                and not _owns_break_continue(orelse):
            uid = next(_counter)
            ops = self._operands([*node.body, *orelse],
                                 include_writes=False)
            tfn = _make_branch_fn(f"_ptpu_t{uid}", ops, node.body)
            ffn = _make_branch_fn(f"_ptpu_f{uid}", ops, orelse)
            call = _stmts(
                "return {h}.convert_ifelse(_ptpu_pred{u}, _ptpu_t{u}, "
                "_ptpu_f{u}, ({args}))",
                h=_HELPER, u=uid,
                args="".join(f"{o}, " for o in ops))[0]
            pred_assign = ast.Assign(
                targets=[ast.Name(id=f"_ptpu_pred{uid}", ctx=ast.Store())],
                value=node.test)
            self.count += 1
            return ([*_guards(ops, assigned), pred_assign, tfn, ffn, call],
                    True)

        if absorb:
            # couldn't convert in return-form: leave `rest` in place
            return [node], False

        # assignment-form: no returns at all, Name-only stores
        if _has_unsupported(node.body) or _has_unsupported(node.orelse) or \
                _owns_break_continue(node.body) or \
                _owns_break_continue(node.orelse):
            return [node], False
        uid = next(_counter)
        ops = self._operands([*node.body, *node.orelse])
        _, writes = _reads_writes([*node.body, *node.orelse])
        outs = sorted(writes & self.locals)
        body_t = list(node.body) + [_ret_tuple(outs)]
        body_f = (list(node.orelse) or [ast.Pass()]) + [_ret_tuple(outs)]
        tfn = _make_branch_fn(f"_ptpu_t{uid}", ops, body_t)
        ffn = _make_branch_fn(f"_ptpu_f{uid}", ops, body_f)
        call_src = ("{h}.convert_ifelse(_ptpu_pred{u}, _ptpu_t{u}, "
                    "_ptpu_f{u}, ({args}))")
        call = _stmts(call_src, h=_HELPER, u=uid,
                      args="".join(f"{o}, " for o in ops))[0].value
        if outs:
            assign = ast.Assign(targets=[_name_tuple_target(outs)],
                                value=call)
        else:
            assign = ast.Expr(value=call)
        pred_assign = ast.Assign(
            targets=[ast.Name(id=f"_ptpu_pred{uid}", ctx=ast.Store())],
            value=node.test)
        self.count += 1
        return ([*_guards(ops, assigned), pred_assign, tfn, ffn, assign],
                False)

    # -- while ------------------------------------------------------------

    def _convert_while(self, node: ast.While, assigned) -> list:
        node.body = self.transform_body(node.body, set(assigned))
        if node.orelse or _has_unsupported(node.body) or \
                _has_unsupported([ast.Expr(value=node.test)]) or \
                _owns_break_continue(node.body):
            self._recurse(node, assigned)
            return [node]
        uid = next(_counter)
        vs = self._operands([ast.Expr(value=node.test), *node.body])
        if not vs:
            return [node]
        cfn = _make_branch_fn(f"_ptpu_wc{uid}", vs,
                              [ast.Return(value=node.test)])
        bfn = _make_branch_fn(f"_ptpu_wb{uid}", vs,
                              list(node.body) + [_ret_tuple(vs)])
        call = _stmts(
            "({targets}) = {h}.convert_while(_ptpu_wc{u}, _ptpu_wb{u}, "
            "({args}), names=({names}))",
            h=_HELPER, u=uid,
            targets="".join(f"{v}, " for v in vs),
            args="".join(f"{v}, " for v in vs),
            names="".join(f"{v!r}, " for v in vs))[0]
        self.count += 1
        return [*_guards(vs, assigned), cfn, bfn, call]

    # -- for --------------------------------------------------------------

    def _convert_for(self, node: ast.For, assigned) -> list:
        node.body = self.transform_body(node.body, set(assigned))
        it = node.iter
        convertible = (
            not node.orelse
            and isinstance(node.target, ast.Name)
            and isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name) and it.func.id == "range"
            and not it.keywords and 1 <= len(it.args) <= 3
            and not any(isinstance(a, ast.Starred) for a in it.args)
            and not _has_unsupported(node.body)
            and not _owns_break_continue(node.body))
        if not convertible:
            self._recurse(node, assigned)
            return [node]
        uid = next(_counter)
        target = node.target.id
        vs = [v for v in self._operands(node.body) if v != target]
        bfn = _make_branch_fn(f"_ptpu_fb{uid}", [target] + vs,
                              list(node.body) + [_ret_tuple(vs)])
        call = _stmts(
            "{maybe_t}{h}.convert_for_range(_ptpu_r{u}, _ptpu_fb{u}, "
            "({args}), names=({names}))",
            h=_HELPER, u=uid,
            maybe_t=("({}) = ".format("".join(f"{v}, " for v in vs))
                     if vs else ""),
            args="".join(f"{v}, " for v in vs),
            names="".join(f"{v!r}, " for v in vs))[0]
        r_assign = ast.Assign(
            targets=[ast.Name(id=f"_ptpu_r{uid}", ctx=ast.Store())],
            value=ast.Tuple(elts=list(it.args), ctx=ast.Load()))
        self.count += 1
        return [*_guards(vs, assigned), r_assign, bfn, call]


def _transform_fdef(fdef: ast.FunctionDef) -> int:
    """The ONE transform pipeline (convert_function and
    ProgramTranslator.get_code must agree): strip decorators, rewrite
    bool ops, convert statements.  Returns the transform count."""
    fdef.decorator_list = []
    boolops = _BoolOpRewriter()
    boolops.visit(fdef)
    conv = _Converter(_collect_locals(fdef))
    a = fdef.args
    params = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        params.add(a.vararg.arg)
    if a.kwarg:
        params.add(a.kwarg.arg)
    fdef.body = conv.transform_body(fdef.body, set(params))
    return conv.count + boolops.count


def convert_function(fn) -> Tuple[types.FunctionType, bool]:
    """AST-convert `fn` (reference ProgramTranslator.get_func).  Returns
    (converted, True) on success or (fn, False) when the function is out
    of the supported subset (closures, unavailable source, nothing to
    convert, or any transform error) — the caller then keeps the loud
    trace-time behavior."""
    cached = getattr(fn, "_ptt_dy2s_cache", None)
    if cached is not None:
        return cached
    result = (fn, False)
    try:
        if getattr(fn, "__closure__", None):
            raise TypeError("closures not supported")
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
        fdef = tree.body[0]
        if not isinstance(fdef, ast.FunctionDef):
            raise TypeError("not a plain function")
        n_transforms = _transform_fdef(fdef)
        if n_transforms:
            ast.fix_missing_locations(tree)
            code = compile(tree, f"<dy2static:{fn.__qualname__}>", "exec")
            g = dict(fn.__globals__)
            g[_HELPER] = sys.modules[__name__]
            g[_UNDEF_NAME] = UNDEF
            exec(code, g)
            new = g[fdef.name]
            functools.update_wrapper(new, fn)
            new._ptt_dy2s_cache = (new, True)
            result = (new, True)
    except Exception:
        result = (fn, False)
    try:
        fn._ptt_dy2s_cache = result
    except (AttributeError, TypeError):
        pass
    return result


# --------------------------------------------------------------------------
# ProgramTranslator surface (reference program_translator.py:756) + the
# logging knobs (dygraph_to_static/logging_utils.py)
# --------------------------------------------------------------------------

_verbosity = 0
_code_level = 0


def set_verbosity(level=0, also_to_stdout=False):
    """dy2static transform logging verbosity (reference logging_utils)."""
    global _verbosity
    _verbosity = int(level)


def set_code_level(level=100, also_to_stdout=False):
    """How much transformed code to show (reference logging_utils)."""
    global _code_level
    _code_level = int(level)


class ProgramTranslator:
    """Singleton managing dy2static conversion (reference
    program_translator.py:756): enable/disable the AST pass globally,
    fetch converted code for inspection."""

    _instance = None
    _enabled = True

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def get_instance(cls):
        return cls()

    def enable(self, enable_to_static=True):
        type(self)._enabled = bool(enable_to_static)

    @property
    def enable_to_static(self):
        return type(self)._enabled

    def get_code(self, dygraph_func):
        """Transformed source of `dygraph_func` (reference get_code)."""
        import ast as _ast
        import inspect as _inspect
        import textwrap as _textwrap

        fn = getattr(dygraph_func, "__func__", dygraph_func)
        conv, did = convert_function(fn)
        if not did:
            return _textwrap.dedent(_inspect.getsource(fn))
        src = _textwrap.dedent(_inspect.getsource(fn))
        tree = _ast.parse(src)
        fdef = tree.body[0]
        _transform_fdef(fdef)
        _ast.fix_missing_locations(tree)
        return _ast.unparse(tree)

    def get_func(self, dygraph_func):
        fn = getattr(dygraph_func, "__func__", dygraph_func)
        conv, _ = convert_function(fn)
        return conv

    def get_program(self, dygraph_func, *args, **kwargs):
        raise NotImplementedError(
            "get_program: record through static.Program/program_guard — "
            "the trace-based capture replaces ProgramDesc extraction")
