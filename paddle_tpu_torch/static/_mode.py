"""Static-mode switch — twin of ``paddle_tpu/static/_mode.py``
(reference: fluid/framework.py:181 in_dygraph_mode).  ``enable_static``
makes hapi's ``Model.prepare`` choose the static-graph adapter; the
dygraph (eager) mode stays the default."""
_STATIC = False


def static_mode_enabled() -> bool:
    return _STATIC


def enable_static():
    global _STATIC
    _STATIC = True


def disable_static():
    global _STATIC
    _STATIC = False
