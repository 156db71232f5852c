"""Runtime lock-order witness: named, hierarchy-aware locking primitives
(the twin of ``paddle_tpu/framework/concurrency.py``).

- :class:`OrderedLock` / :class:`OrderedRLock` / :class:`OrderedCondition`
  are drop-in replacements for the ``threading`` primitives that carry a
  NAME (one name per lock *class* — every ResponseHandle condvar is
  ``serving.handle``).
- While the witness is enabled, every acquisition records the per-thread
  held-set into a global **held-before graph** over lock names.  Two
  detectors run on each acquisition:

  * **cycle** — the new ``held -> acquiring`` edge closes a cycle in the
    graph (the classic ABBA inversion: a *potential* deadlock even if
    this particular run never interleaved fatally);
  * **hierarchy** — the acquisition violates a declared lock hierarchy
    (``declare_hierarchy("serving.frontend", "serving.router", ...)``
    declares the outermost-first order; acquiring an earlier lock while
    holding a later one of the same chain is a violation even before
    any reverse edge exists).

  A violation report carries BOTH acquisition stacks: where the
  conflicting edge was first recorded and where the current acquisition
  happened.
- Witness mode is a test-time switch (``with witness(): ...``): when
  off — the production default — an acquisition costs one module-global
  read over the plain primitive.  ``raise_on_violation`` controls
  whether a violation raises :class:`LockOrderViolation` at the
  offending acquisition (unit tests) or is recorded for a later
  ``assert_clean()`` (soak tests, where raising inside a pump thread
  would masquerade as an engine crash).

Declared hierarchy for the serving fleet:
``serving.frontend > serving.router > serving.handle > serving.metrics``
— declared in ``paddle_tpu_torch.serving.__init__``.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .errors import EnforceNotMet

__all__ = ["OrderedLock", "OrderedRLock", "OrderedCondition",
           "LockOrderViolation", "Violation", "declare_hierarchy",
           "enable_witness", "disable_witness", "witness_enabled",
           "witness", "violations", "assert_clean", "reset",
           "held_names", "graph_edges"]

_STACK_LIMIT = 10


class LockOrderViolation(EnforceNotMet):
    """A lock acquisition that could deadlock: it closes a cycle in the
    held-before graph or violates a declared lock hierarchy."""


@dataclass
class Violation:
    """One detected inversion; ``stacks`` holds BOTH acquisition sites:
    the current one and the previously recorded conflicting one."""

    kind: str                     # "cycle" | "hierarchy" | "self"
    acquiring: str                # lock name being acquired
    holding: str                  # held lock name that conflicts
    thread: str
    message: str
    # BOTH acquisition sites, as raw (file, line, fn) frame tuples
    # (formatted lazily — capture must stay cheap on the hot path)
    stacks: Tuple = ((), ())      # (current, recorded-conflict)

    def format(self) -> str:
        cur, prev = (_fmt_stack(s) for s in self.stacks)
        out = [self.message]
        if cur:
            out.append("--- current acquisition "
                       f"(thread {self.thread}):\n{cur}")
        if prev:
            out.append(f"--- conflicting prior acquisition:\n{prev}")
        return "\n".join(out)


class _Edge:
    """First-observation record of one held-before pair (outer, inner)."""

    __slots__ = ("outer", "inner", "count", "outer_stack", "inner_stack",
                 "thread")

    def __init__(self, outer: str, inner: str, outer_stack: str,
                 inner_stack: str, thread: str):
        self.outer = outer
        self.inner = inner
        self.count = 1
        self.outer_stack = outer_stack    # where the OUTER lock was taken
        self.inner_stack = inner_stack    # where inner was taken under it
        self.thread = thread


# --- module state ------------------------------------------------------------
_tls = threading.local()                  # .held: List[_Held]
_graph_lock = threading.Lock()            # guards everything below
_edges: Dict[Tuple[str, str], _Edge] = {}
_adj: Dict[str, Set[str]] = {}
_violations: List[Violation] = []
_ranks: Dict[str, Tuple[int, int]] = {}   # name -> (chain id, position)
_chain_count = 0
_enabled = False
_raise = True


class _Held:
    __slots__ = ("lock", "name", "count", "stack")

    def __init__(self, lock, name: str, stack: str):
        self.lock = lock
        self.name = name
        self.count = 1
        self.stack = stack


def _held_list() -> List[_Held]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def declare_hierarchy(*names: str) -> None:
    """Declare one ordered chain of lock names, OUTERMOST FIRST: a lock
    later in the chain may be acquired while an earlier one is held,
    never the reverse.  Independent subsystems declare independent
    chains — ranks only compare within one chain, so unrelated locks
    never false-positive against each other.  Re-declaring the same
    chain is idempotent; moving a name to a different position raises
    (two live orders for one name would make the check meaningless)."""
    global _chain_count
    with _graph_lock:
        existing = [_ranks.get(n) for n in names]
        if all(r is not None for r in existing):
            chains = {r[0] for r in existing}
            if len(chains) == 1 and [r[1] for r in existing] == sorted(
                    r[1] for r in existing):
                return                    # same chain, same order
        if any(r is not None for r in existing):
            raise ValueError(
                f"hierarchy redeclaration conflicts for {names!r}: "
                f"{[n for n, r in zip(names, existing) if r is not None]} "
                "already ranked")
        cid = _chain_count
        _chain_count += 1
        for i, n in enumerate(names):
            _ranks[n] = (cid, i)


def enable_witness(raise_on_violation: bool = True) -> None:
    global _enabled, _raise
    _raise = bool(raise_on_violation)
    _enabled = True


def disable_witness() -> None:
    global _enabled
    _enabled = False


def witness_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def witness(raise_on_violation: bool = True):
    """Enable the witness for a block (tests).  Resets recorded edges
    and violations on entry; the graph stays inspectable after exit."""
    reset()
    enable_witness(raise_on_violation)
    try:
        yield
    finally:
        disable_witness()


def reset() -> None:
    """Clear the held-before graph and recorded violations (declared
    hierarchies persist — they are program structure, not run state)."""
    with _graph_lock:
        _edges.clear()
        _adj.clear()
        _violations.clear()


def violations() -> List[Violation]:
    with _graph_lock:
        return list(_violations)


def assert_clean() -> None:
    """Raise LockOrderViolation if any violation was recorded since the
    last reset — the teardown assertion of witness-mode soak tests."""
    vs = violations()
    if vs:
        raise LockOrderViolation(
            f"{len(vs)} lock-order violation(s) recorded:\n\n"
            + "\n\n".join(v.format() for v in vs))


def held_names() -> List[str]:
    """Names of locks the CURRENT thread holds (debug aid)."""
    return [h.name for h in _held_list()]


def graph_edges() -> List[Tuple[str, str]]:
    """Observed held-before pairs (outer, inner) since the last reset."""
    with _graph_lock:
        return sorted(_edges)


def _stack() -> Tuple[Tuple[str, int, str], ...]:
    """Lightweight acquisition-site capture: (file, line, function)
    frames walked via f_back — a few microseconds, unlike
    traceback.extract_stack's linecache/format work.  The witness runs
    on EVERY acquire of every adopted lock while enabled, inside pump
    threads whose interleaving the tests' timing depends on, so capture
    must stay cheap; frames format lazily (``_fmt_stack``) only when a
    violation report is built."""
    f = sys._getframe(2)          # skip _stack + the bookkeeping caller
    out = []
    while f is not None and len(out) < _STACK_LIMIT:
        out.append((f.f_code.co_filename, f.f_lineno,
                    f.f_code.co_name))
        f = f.f_back
    return tuple(out)


def _fmt_stack(frames) -> str:
    if isinstance(frames, str):   # already formatted
        return frames
    return "".join(
        f'  File "{fn}", line {ln}, in {name}\n'
        for fn, ln, name in reversed(frames))


def _reachable(src: str, dst: str) -> bool:
    """True when dst is reachable from src in the held-before graph.
    Caller holds _graph_lock."""
    seen = {src}
    stack = [src]
    while stack:
        for nxt in _adj.get(stack.pop(), ()):
            if nxt == dst:
                return True
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def _record(v: Violation) -> None:
    with _graph_lock:
        _violations.append(v)
    if _raise:
        raise LockOrderViolation(v.format())


def _on_acquired(lock, name: str, reentrant: bool) -> None:
    """Post-acquisition bookkeeping (witness enabled).  Runs AFTER the
    real lock is held; takes only the module's own graph lock, and no
    user lock is ever taken under it — the witness cannot itself add a
    cycle."""
    held = _held_list()
    if reentrant:
        for h in held:
            if h.lock is lock:
                h.count += 1
                return
    cur_stack = _stack()
    tname = threading.current_thread().name
    my_rank = _ranks.get(name)
    for h in held:
        if h.lock is lock:
            continue
        if h.name == name:
            _record(Violation(
                "self", name, h.name, tname,
                f"lock-order: acquiring {name!r} while already holding "
                f"another lock named {name!r} — same-class locks must "
                "not nest (an ABBA between two instances of the class "
                "is undetectable by name ordering)",
                (cur_stack, h.stack)))
            continue
        # hierarchy: both ranked in the SAME chain and the new lock
        # sits EARLIER (more outer) than a held one
        h_rank = _ranks.get(h.name)
        if (my_rank is not None and h_rank is not None
                and my_rank[0] == h_rank[0] and my_rank[1] < h_rank[1]):
            _record(Violation(
                "hierarchy", name, h.name, tname,
                f"lock-hierarchy: acquiring {name!r} (rank "
                f"{my_rank[1]}) while holding {h.name!r} (rank "
                f"{h_rank[1]}) — the declared order requires "
                f"{name!r} to be taken first",
                (cur_stack, h.stack)))
        # held-before edge h.name -> name
        key = (h.name, name)
        with _graph_lock:
            edge = _edges.get(key)
            if edge is not None:
                edge.count += 1
                continue
            # NEW edge: a cycle exists iff h.name was already reachable
            # FROM name (some thread held `name` while taking a path
            # back to h.name) — find the first reverse step for the
            # conflicting stack pair
            conflict = None
            if _reachable(name, h.name):
                for nxt in _adj.get(name, ()):
                    if nxt == h.name or _reachable(nxt, h.name):
                        conflict = _edges[(name, nxt)]
                        break
            _edges[key] = _Edge(h.name, name, h.stack, cur_stack, tname)
            _adj.setdefault(h.name, set()).add(name)
        if conflict is not None:
            _record(Violation(
                "cycle", name, h.name, tname,
                f"lock-order cycle: acquiring {name!r} while holding "
                f"{h.name!r}, but {h.name!r} (via "
                f"{conflict.inner!r}) is already acquired under "
                f"{name!r} elsewhere — ABBA deadlock potential",
                (cur_stack, conflict.inner_stack)))
    held.append(_Held(lock, name, cur_stack))


def _on_released(lock) -> None:
    held = getattr(_tls, "held", None)
    if not held:
        return
    for i in range(len(held) - 1, -1, -1):
        if held[i].lock is lock:
            held[i].count -= 1
            if held[i].count <= 0:
                del held[i]
            return


class OrderedLock:
    """``threading.Lock`` drop-in carrying a witness name."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = str(name)
        self._lock = self._make()

    def _make(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok and _enabled:
            try:
                _on_acquired(self, self.name, self._reentrant)
            except LockOrderViolation:
                # raise-mode violation: hand the lock back before
                # propagating, so the offending `with` block doesn't
                # leave the primitive locked forever
                self._lock.release()
                raise
        return ok

    def release(self) -> None:
        _on_released(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class OrderedRLock(OrderedLock):
    """``threading.RLock`` drop-in: re-entrant acquisition by the owning
    thread records nothing (no self-edge, no duplicate held entry)."""

    _reentrant = True

    def _make(self):
        return threading.RLock()

    def locked(self) -> bool:              # RLock has no .locked()
        if self._lock.acquire(blocking=False):
            self._lock.release()
            return False
        return True


class OrderedCondition:
    """``threading.Condition`` drop-in over an :class:`OrderedLock` (or a
    caller-provided Ordered lock).  ``wait``/``wait_for`` drop the lock
    from the witness held-set for the duration of the wait — a waiting
    thread holds nothing, so a waiter can never be the outer half of a
    false inversion — and re-record it on wakeup."""

    def __init__(self, name: str, lock: Optional[OrderedLock] = None):
        self.name = str(name)
        self._olock = lock if lock is not None else OrderedLock(name)
        # the inner Condition runs on the RAW lock; held-set bookkeeping
        # happens in our acquire/release/wait wrappers
        self._cond = threading.Condition(self._olock._lock)

    # --- lock surface -------------------------------------------------------
    def acquire(self, *a, **kw) -> bool:
        ok = self._olock._lock.acquire(*a, **kw)
        if ok and _enabled:
            try:
                _on_acquired(self._olock, self.name,
                             self._olock._reentrant)
            except LockOrderViolation:
                self._olock._lock.release()
                raise
        return ok

    def release(self) -> None:
        _on_released(self._olock)
        self._olock._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    # --- condition surface --------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        _on_released(self._olock)        # wait releases the lock
        try:
            return self._cond.wait(timeout)
        finally:
            if _enabled:                 # re-acquired on wakeup
                _on_acquired(self._olock, self.name,
                             self._olock._reentrant)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # re-implemented over self.wait so the held-set bookkeeping
        # applies to every internal wait slice
        import time as _time

        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = _time.monotonic() + timeout
                waittime = endtime - _time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self):
        return f"<OrderedCondition {self.name!r}>"
