"""Per-program capture accounting and CUDA graphs — the twin of
``paddle_tpu/profiler/jit_cost.py``.

Where the JAX package compiles a named program once per input signature
(``profiled_jit``), the port captures it: ``profiled_graph(name, fun)``
returns a :class:`ProfiledGraph` that, on the card, records ``fun`` into
one ``torch.cuda.CUDAGraph`` per input signature and replays it on later
calls with the same signature — one launch from the host where the eager
function issues hundreds.  On the CPU nothing is captured and ``fun``
runs as written; the accounting is the same on both devices.

Compile ledger: the first call of every signature counts as one compile
of ``name`` in the process-wide ``compile_ledger`` (a capture on the
card; on the CPU the same event, as ``jax.jit`` compiles there too), and
``compile_budget(n)`` turns a code region into an assertion about how
many compiles it may trigger::

    with compile_budget(0, prefix="serving."):   # raise mode
        for _ in range(32):
            engine.step()        # steady-state decode must not re-capture

    with compile_budget(None) as cb:             # record mode
        drive()
    assert cb.compiles() == {"serving.ragged_step": 1}

Raise mode (``limit`` an int) raises :class:`CompileBudgetExceeded` at
exit when the region compiled more than ``limit`` programs; record mode
(``limit=None``) never raises.  ``cost_registry`` keeps per-name
compiles (captures), capture seconds, calls, replays and whether the
program runs as a graph.  FLOPs and bytes are not attributed.

Launch counters: a kernel wrapper counts its launches in a dict of its
own with :func:`count_launch`.  A capture runs the wrappers once
without launching anything, so a count made on a stream that is
capturing goes to that capture's sink instead of the dicts, and every
replay adds it: the counts keep meaning launches run, also while other
threads launch and count at the same time.  The stream decides, not the
thread: a backward inside a capture launches from autograd's device
thread, on the capturing stream.

Randomness: each graph registers the port's generator of its card
(``framework.random``), so dropout masks, flash dropout seeds and
optimizer noise drawn inside a graph are drawn anew at every replay,
and a replay draws what the eager call would from the same state.

Several engines in one process (the serving frontend's replicas, each
driven by its own pump thread) share the card.  A capture runs in
PyTorch's default *global* capture mode, in which a ``cudaMalloc``, a
stream or event sync or a pageable copy made by ANY thread of the
process during the capture fails, in that thread or in the capture.
:data:`capture_gate` keeps them apart: an engine holds the gate shared
around everything it does on the device (a step, a snapshot, a restore,
an abort), and a capture holds it exclusively, so the other engines
pause only while a capture runs — a capture is once per signature.  A
per-engine stream with ``capture_error_mode="thread_local"`` was the
other choice; it would leave every call PyTorch makes on the other
threads during a capture (allocator growth, pinned host copies, event
waits) to be proven safe one by one, where the gate rules them all out.
"""
from __future__ import annotations

import gc
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..framework.errors import InvalidArgumentError
from ..framework.random import generator

__all__ = ["profiled_graph", "ProfiledGraph", "JitCostRegistry",
           "cost_registry", "CompileLedger", "compile_ledger",
           "compile_budget", "CompileBudget", "CompileBudgetExceeded",
           "disable_jit", "count_launch", "CaptureGate", "capture_gate",
           "device_memory_stats"]


def device_memory_stats() -> Dict[str, Any]:
    """Live per-card memory stats (``torch.cuda.memory_stats``: bytes
    allocated, reserved, peaks, ...) of every visible card, keyed by
    device name; empty without a card.  A query of the caching
    allocator's host-side counters: it launches nothing."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}


# --- argument trees ---------------------------------------------------------
def _flatten(tree, leaves: list):
    """Append ``tree``'s leaves (anything but a tuple, list or dict) to
    ``leaves`` in order; return its hashable structure."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple(tree),
                tuple(_flatten(v, leaves) for v in tree.values()))
    leaves.append(tree)
    return None


def _map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaf_sig(x):
    if isinstance(x, torch.Tensor):
        return (x.shape, x.dtype, x.device)
    if isinstance(x, (int, float, bool, str, bytes, type(None))):
        return ("py", type(x).__name__, x)
    return ("py", type(x).__name__, id(x))


def _sig_str(sig) -> str:
    parts = []
    for _struct, leaves in sig:
        for s in leaves:
            if s[0] == "py":
                parts.append(repr(s[2]))
            else:
                dtype = str(s[1]).replace("torch.", "")
                parts.append(f"{tuple(s[0])}:{dtype}")
    return ",".join(parts) or "()"


# --- launch counters ---------------------------------------------------------
_COUNT_LOCK = threading.Lock()
# the sink of each capture in progress, by its stream's handle: a launch
# on that stream is one the capture records, from the capturing thread
# or from autograd's device thread (a backward inside the capture)
_STREAM_SINKS: Dict[int, list] = {}


def _stream_key() -> int:
    """The handle of this thread's current CUDA stream."""
    return torch.cuda.current_stream().cuda_stream


def count_launch(counts: Dict[str, int], key: str, n: int = 1) -> None:
    """Add ``n`` launches under ``key`` — or, when the current stream
    captures a graph, to the capture, whose replays add them.
    Thread-safe."""
    if _STREAM_SINKS:
        sink = _STREAM_SINKS.get(_stream_key())
        if sink is not None:
            sink.append((counts, key, n))
            return
    with _COUNT_LOCK:
        counts[key] += n


def _add_launches(launches) -> None:
    with _COUNT_LOCK:
        for counts, delta in launches:
            for k, v in delta.items():
                counts[k] += v


class CaptureGate:
    """A readers-writer lock over the card: ``shared()`` around device
    work that may run beside other threads' device work, ``exclusive()``
    around a graph capture.  ``shared()`` is re-entrant per thread, and a
    thread that captures inside its own shared region steps out of it
    while it waits, so two threads that each capture from inside a step
    take turns instead of waiting on each other.  Waiting captures are
    served before new shared regions start."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._shared = 0            # threads inside a shared region
        self._writer: Optional[int] = None
        self._waiting = 0           # captures waiting for the gate
        self._tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    @contextmanager
    def shared(self):
        depth = self._depth()
        if depth == 0:
            with self._cond:
                while self._writer is not None or self._waiting:
                    self._cond.wait()
                self._shared += 1
        self._tls.depth = depth + 1
        try:
            yield
        finally:
            self._tls.depth = depth
            if depth == 0:
                with self._cond:
                    self._shared -= 1
                    self._cond.notify_all()

    @contextmanager
    def exclusive(self):
        inside = self._depth() > 0
        with self._cond:
            if inside:
                self._shared -= 1   # step aside while waiting
                self._cond.notify_all()
            self._waiting += 1
            while self._writer is not None or self._shared:
                self._cond.wait()
            self._waiting -= 1
            self._writer = threading.get_ident()
        try:
            yield
        finally:
            with self._cond:
                self._writer = None
                if inside:
                    self._shared += 1
                self._cond.notify_all()


# the one gate of the process: every engine and every capture use it
capture_gate = CaptureGate()


# --- cost registry -----------------------------------------------------------
class _Entry:
    __slots__ = ("calls", "replays", "compile_count", "compile_time_s",
                 "call_time_s", "graphed", "signatures")

    def __init__(self):
        self.calls = 0
        self.replays = 0
        self.compile_count = 0
        self.compile_time_s = 0.0
        self.call_time_s = 0.0
        self.graphed = False
        self.signatures: Dict[str, dict] = {}


class JitCostRegistry:
    """name -> compiles (captures), capture seconds, calls, replays and
    whether the program runs as a graph (thread-safe)."""

    def __init__(self):
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()

    def _entry(self, name: str) -> _Entry:
        e = self._entries.get(name)
        if e is None:
            e = self._entries[name] = _Entry()
        return e

    def record_compile(self, name: str, sig_key: str, capture_s: float,
                       graphed: bool):
        with self._lock:
            e = self._entry(name)
            e.compile_count += 1
            e.compile_time_s += capture_s
            e.graphed = graphed
            e.signatures[sig_key] = {"capture_time_s": capture_s,
                                     "graphed": graphed}

    def record_call(self, name: str, dt: float, replay: bool):
        with self._lock:
            e = self._entry(name)
            e.calls += 1
            e.call_time_s += dt
            e.replays += int(replay)

    def snapshot(self) -> Dict[str, dict]:
        """Per-name counts; ``graphed`` is the last capture's mode."""
        with self._lock:
            return {name: {"calls": e.calls, "replays": e.replays,
                           "compile_count": e.compile_count,
                           "compile_time_s": e.compile_time_s,
                           "call_time_s": e.call_time_s,
                           "graphed": e.graphed,
                           "signatures": {k: dict(v) for k, v in
                                          e.signatures.items()}}
                    for name, e in self._entries.items()}

    def reset(self):
        with self._lock:
            self._entries = {}


cost_registry = JitCostRegistry()


# --- compile ledger ----------------------------------------------------------
class CompileLedger:
    """Process-global per-program compile counter.

    Append-only and monotonic (``reset()`` exists for test isolation):
    every new-signature compile of a :class:`ProfiledGraph` lands here as
    ``(name, sig_key, fallback)``; the port never falls back, so
    ``fallback`` is False for its own programs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._events: List[Tuple[str, str, bool]] = []

    def on_compile(self, name: str, sig_key: str, fallback: bool = False):
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1
            self._events.append((name, sig_key, fallback))

    def counts(self, prefix: Optional[str] = None) -> Dict[str, int]:
        """name -> compiles so far (optionally prefix-filtered)."""
        with self._lock:
            return {k: v for k, v in self._counts.items()
                    if prefix is None or k.startswith(prefix)}

    def total(self, prefix: Optional[str] = None) -> int:
        return sum(self.counts(prefix).values())

    def events(self) -> List[Tuple[str, str, bool]]:
        with self._lock:
            return list(self._events)

    def reset(self):
        with self._lock:
            self._counts = {}
            self._events = []


compile_ledger = CompileLedger()


class CompileBudgetExceeded(AssertionError):
    """A ``compile_budget`` region compiled more programs than allowed."""


class CompileBudget:
    """Context manager diffing the compile ledger across a region.

    ``limit`` is the maximum number of compiles the region may trigger
    (0 pins "no re-capture at all"); ``None`` selects record mode — never
    raises, the caller asserts on :meth:`compiles` / :meth:`total`.
    ``names`` / ``prefix`` scope which programs count."""

    def __init__(self, limit: Optional[int] = None, *,
                 names: Optional[Tuple[str, ...]] = None,
                 prefix: Optional[str] = None,
                 ledger: Optional[CompileLedger] = None):
        self.limit = limit
        self.names = tuple(names) if names else None
        self.prefix = prefix
        self._ledger = ledger if ledger is not None else compile_ledger
        self._start: Dict[str, int] = {}

    def _filtered(self, counts: Dict[str, int]) -> Dict[str, int]:
        return {k: v for k, v in counts.items()
                if (self.prefix is None or k.startswith(self.prefix))
                and (self.names is None or k in self.names)}

    def compiles(self) -> Dict[str, int]:
        """Per-name compiles since entry (zero-delta names omitted)."""
        now = self._filtered(self._ledger.counts())
        return {k: v - self._start.get(k, 0) for k, v in now.items()
                if v - self._start.get(k, 0) > 0}

    def total(self) -> int:
        return sum(self.compiles().values())

    def __enter__(self) -> "CompileBudget":
        self._start = self._filtered(self._ledger.counts())
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None and self.limit is not None:
            delta = self.compiles()
            total = sum(delta.values())
            if total > self.limit:
                detail = ", ".join(f"{k} x{v}"
                                   for k, v in sorted(delta.items()))
                raise CompileBudgetExceeded(
                    f"region compiled {total} program(s), budget is "
                    f"{self.limit}: {detail} — a jitted signature "
                    "drifted (see docs/ANALYSIS.md retrace-hazard)")
        return False


def compile_budget(limit: Optional[int] = None, *,
                   names: Optional[Tuple[str, ...]] = None,
                   prefix: Optional[str] = None,
                   ledger: Optional[CompileLedger] = None) -> CompileBudget:
    """Assert a code region's compile count: ``with compile_budget(0,
    prefix="serving."): ...`` raises :class:`CompileBudgetExceeded` when
    any scoped program is compiled (captured) again; ``compile_budget
    (None)`` records only — assert on ``cb.compiles()``."""
    return CompileBudget(limit, names=names, prefix=prefix, ledger=ledger)


# --- eager switch ------------------------------------------------------------
_EAGER = threading.local()


@contextmanager
def disable_jit():
    """The twin of ``jax.disable_jit``: inside it every
    :class:`ProfiledGraph` runs its function eagerly and records
    nothing (no compile, no call, no capture)."""
    prev = getattr(_EAGER, "on", False)
    _EAGER.on = True
    try:
        yield
    finally:
        _EAGER.on = prev


# --- the runner --------------------------------------------------------------
class _Signature:
    """One captured signature: its graph (None when it runs eagerly),
    static inputs and outputs, the donated leaves' storage and the
    capture's launch increments."""

    __slots__ = ("graph", "inputs", "outputs", "donated", "launches")

    def __init__(self, donated):
        self.graph = None
        self.inputs: List[torch.Tensor] = []
        self.outputs: Any = None
        self.donated = donated
        self.launches: List[Tuple[Dict[str, int], Dict[str, int]]] = []


class ProfiledGraph:
    """``fun`` run as one CUDA graph per input signature.

    A signature is the tree structure of the positional arguments, the
    shape, dtype and device of each tensor leaf and the value of each
    other leaf.  The first call of a signature counts one compile in
    ``compile_ledger`` on any device.  On the CPU (or with ``capture=
    False``) the function then runs as written on every call.  On the
    card the first call runs it eagerly on a side stream — the warm-up,
    which also builds the kernels at first use and whose outputs it
    returns — then captures it into a ``torch.cuda.CUDAGraph`` whose
    memory comes from one pool shared by all of this runner's graphs.
    Later calls of the signature copy each tensor leaf that is not
    donated into the graph's static input (device to device), replay,
    and return the static outputs: **the next replay of the same
    signature overwrites them**, so a caller copies what it keeps before
    calling again (stream order covers copies enqueued before the
    replay).

    ``donate_argnums`` names arguments the function updates in place
    (the engine's KV pools).  They are captured by address: every later
    call checks that each donated tensor leaf is the storage seen at the
    signature's first call (data pointer, shape, dtype), on every device,
    and raises ``InvalidArgumentError`` if it is not.  A capture that
    fails raises; nothing falls back to the eager path."""

    def __init__(self, name: str, fun, *, donate_argnums=(),
                 capture: bool = True):
        self.name = name
        self._fun = fun
        self._donate = frozenset(int(i) for i in donate_argnums)
        self.capture = bool(capture)
        self._sigs: Dict[Any, _Signature] = {}
        self._lock = threading.Lock()
        self._pool = None
        self._side: Dict[torch.device, torch.cuda.Stream] = {}

    def _split(self, args):
        """(signature, leaves of the arguments that are not donated,
        donated tensor leaves)."""
        sig, free, donated = [], [], []
        for i, a in enumerate(args):
            leaves = []
            struct = _flatten(a, leaves)
            sig.append((struct, tuple(map(_leaf_sig, leaves))))
            if i in self._donate:
                donated.extend(x for x in leaves
                               if isinstance(x, torch.Tensor))
            else:
                free.extend(leaves)
        return tuple(sig), free, donated

    @staticmethod
    def _storage(donated):
        return [(t.data_ptr(), t.shape, t.dtype) for t in donated]

    def _check_donated(self, ent: _Signature, donated):
        now = self._storage(donated)
        if now != ent.donated:
            bad = next(j for j, (a, b) in enumerate(zip(now, ent.donated))
                       if a != b)
            raise InvalidArgumentError(
                f"{self.name}: donated tensor leaf {bad} is not the storage "
                f"captured at this signature's first call (data pointer, "
                f"shape, dtype {now[bad]} vs {ent.donated[bad]}) — a "
                "graph binds its donated buffers by address: update them "
                "in place instead of replacing them")

    def _devices(self, free, donated):
        devs = {t.device for t in list(free) + list(donated)
                if isinstance(t, torch.Tensor)}
        cuda = {d for d in devs if d.type == "cuda"}
        if not cuda:
            return None
        if len(devs) > 1:
            raise InvalidArgumentError(
                f"{self.name}: one CUDA graph cannot span the devices "
                f"{sorted(map(str, devs))}; build the runner with "
                "capture=False to run this signature eagerly")
        return cuda.pop()

    def __call__(self, *args):
        if getattr(_EAGER, "on", False):
            return self._fun(*args)
        sig, free, donated = self._split(args)
        ent = self._sigs.get(sig)
        if ent is None:
            with self._lock:
                if sig not in self._sigs:
                    return self._first_call(sig, args, free, donated)
                ent = self._sigs[sig]
        self._check_donated(ent, donated)
        t0 = time.perf_counter()
        if ent.graph is None:
            out = self._fun(*args)
        else:
            for static, x in zip(ent.inputs, free):
                if isinstance(x, torch.Tensor) and x is not static:
                    static.copy_(x)
            ent.graph.replay()
            _add_launches(ent.launches)
            out = ent.outputs
        cost_registry.record_call(self.name, time.perf_counter() - t0,
                                   replay=ent.graph is not None)
        return out

    def _first_call(self, sig, args, free, donated):
        ent = _Signature(self._storage(donated))
        dev = self._devices(free, donated) if self.capture else None
        t0 = time.perf_counter()
        if dev is None:
            out = self._fun(*args)
            capture_s = 0.0
        else:
            out, capture_s = self._capture(ent, dev, args)
        self._sigs[sig] = ent
        key = _sig_str(sig)
        cost_registry.record_compile(self.name, key, capture_s,
                                      graphed=ent.graph is not None)
        compile_ledger.on_compile(self.name, key)
        cost_registry.record_call(self.name, time.perf_counter() - t0,
                                   replay=False)
        return out

    def _capture(self, ent: _Signature, dev, args):
        """Warm up on a side stream (the real call: its outputs are
        returned), then capture into ``ent``; returns (outputs, capture
        seconds)."""
        main = torch.cuda.current_stream(dev)
        side = self._side.get(dev)
        if side is None:
            side = self._side[dev] = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static_args = [a if i in self._donate else _map(_static_copy, a)
                       for i, a in enumerate(args)]
        ent.inputs = _leaves_of(static_args, self._donate)
        side.wait_stream(main)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            out = self._fun(*args)
            graph = torch.cuda.CUDAGraph()
            # the port's generator of the card draws anew at each replay
            # (dropout masks, flash seeds, optimizer noise)
            graph.register_generator_state(generator(dev))
            sink: List[Tuple[Dict[str, int], str, int]] = []
            # no other thread touches the card while the capture runs,
            # and no garbage collection either: collecting a dead
            # engine's graphs destroys them, a call the capture forbids
            with capture_gate.exclusive():
                gc_was_on = gc.isenabled()
                gc.disable()
                t0 = time.perf_counter()
                _STREAM_SINKS[side.cuda_stream] = sink
                try:
                    graph.capture_begin(pool=self._pool)
                    try:
                        static_out = self._fun(*static_args)
                    finally:
                        graph.capture_end()
                finally:
                    del _STREAM_SINKS[side.cuda_stream]
                    if gc_was_on:
                        gc.enable()
                capture_s = time.perf_counter() - t0
            by_dict: Dict[int, Tuple[Dict[str, int], Dict[str, int]]] = {}
            for counts, k, n in sink:
                delta = by_dict.setdefault(id(counts), (counts, {}))[1]
                delta[k] = delta.get(k, 0) + n
            ent.launches = list(by_dict.values())
        main.wait_stream(side)
        ent.graph = graph
        ent.outputs = static_out
        return out, capture_s


def _static_copy(x):
    """A graph's own copy of a non-donated argument leaf."""
    if isinstance(x, torch.Tensor):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _leaves_of(args, donate):
    """The leaves of the arguments not in ``donate``, in order."""
    leaves: list = []
    for i, a in enumerate(args):
        if i not in donate:
            _flatten(a, leaves)
    return leaves


def profiled_graph(name: str, fun, *, donate_argnums=(),
                   capture: bool = True) -> ProfiledGraph:
    """``fun`` as a :class:`ProfiledGraph` named ``name`` (the twin of
    ``profiled_jit``); ``capture=False`` runs every signature eagerly,
    as on the CPU (a program whose tensors span several devices)."""
    return ProfiledGraph(name, fun, donate_argnums=donate_argnums,
                         capture=capture)
