"""Process initialization — twin of ``paddle_tpu/framework/init.py`` (the
reference's platform/init.cc: ``InitDevices`` enumerates the devices
once, ``SignalHandle`` dumps stacks on a crash).

``init_devices`` enumerates the ``torch.cuda`` devices once (the CPU
where there is no card) and records the platform: ``"gpu"`` on the card,
``"cpu"`` otherwise.  The fault handlers are the JAX package's:
``faulthandler`` dumps every thread's Python stack on SIGSEGV, SIGFPE,
SIGABRT and SIGBUS, and a SIGTERM handler runs the registered shutdown
hooks before the process dies as it would have."""
from __future__ import annotations

import atexit
import faulthandler
import os
import signal
import sys
import threading
from typing import Callable, List, Optional

import torch

__all__ = ["init_devices", "init_signal_handlers", "register_shutdown_hook",
           "init", "is_initialized", "get_platform"]

_state = {"initialized": False, "devices": [], "platform": None}
_lock = threading.Lock()
_sigterm_hooks: List[Callable[[], None]] = []
_handlers_installed = [False]


def init_devices(force: bool = False) -> list:
    """The devices (``torch.device``s), enumerated once."""
    with _lock:
        if _state["initialized"] and not force:
            return _state["devices"]
        if torch.cuda.is_available():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            platform = "gpu"
        else:
            devices = [torch.device("cpu")]
            platform = "cpu"
        _state["devices"] = devices
        _state["platform"] = platform
        _state["initialized"] = True
        return devices


def init_signal_handlers(dump_path: Optional[str] = None) -> None:
    """Install the crash handlers once: every thread's stack on a fatal
    signal (to ``dump_path`` when given), and the shutdown hooks on
    SIGTERM."""
    if _handlers_installed[0]:
        return
    _handlers_installed[0] = True
    stream = sys.stderr
    if dump_path:
        stream = open(dump_path, "a")  # noqa: SIM115 — lives past scope
        atexit.register(stream.close)
    if not faulthandler.is_enabled():
        faulthandler.enable(file=stream, all_threads=True)
    if threading.current_thread() is threading.main_thread():
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            for hook in list(_sigterm_hooks):
                try:
                    hook()
                except Exception:  # noqa: BLE001 — dying anyway
                    pass
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)


def register_shutdown_hook(fn: Callable[[], None]) -> None:
    """Run ``fn`` on SIGTERM before the process dies."""
    _sigterm_hooks.append(fn)


def init(dump_path: Optional[str] = None) -> None:
    """The devices and the crash handlers."""
    init_devices()
    init_signal_handlers(dump_path)


def is_initialized() -> bool:
    return _state["initialized"]


def get_platform() -> Optional[str]:
    return _state["platform"]
