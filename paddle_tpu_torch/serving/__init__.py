"""GPT serving on a paged KV cache: allocator, prefix cache, scheduler,
metrics, speculative decoding, resilience policy (snapshots, watchdog,
brownout), the continuous-batching engine (ragged and split dispatch),
and the front door over several engine replicas — the router, the
streaming ``ServingFrontend`` and its stdlib HTTP server."""
from ..framework.concurrency import declare_hierarchy as _declare_hierarchy

# The serving fleet's declared lock hierarchy, outermost first: frontend
# RLock > router RLock > handle condvar > metrics locks > SLO tracker
# (the tracker is evaluated from pump ticks and adaptive-brownout reads
# that may hold the frontend lock, and it never takes a serving lock
# itself).  The framework.concurrency witness enforces it (and hunts
# undeclared ABBA cycles) whenever tests run with the witness on.
_declare_hierarchy("serving.frontend", "serving.router",
                   "serving.handle", "serving.metrics", "serving.slo")

from .engine import ServingEngine, create_serving_engine  # noqa: E402
from .frontend import (ResponseHandle, ServingFrontend,  # noqa: E402
                       create_serving_frontend)
from .http import ServingHTTPServer, start_http_server  # noqa: E402
from .kv_cache import PagedKVCache  # noqa: E402
from .metrics import (FleetMetrics, FrontendMetrics,  # noqa: E402
                      ServingMetrics)
from .prefix_cache import PrefixCache  # noqa: E402
from .resilience import (BrownoutController, BrownoutPolicy,  # noqa: E402
                         EngineSnapshot, Watchdog, WatchdogConfig)
from .router import Replica, Router  # noqa: E402
from .scheduler import Request, Scheduler, Sequence  # noqa: E402
from .spec_decode import Drafter, NgramDrafter, SpecDecoder  # noqa: E402

__all__ = ["ServingEngine", "create_serving_engine", "PagedKVCache",
           "PrefixCache", "ServingMetrics", "FrontendMetrics",
           "FleetMetrics", "Request", "Scheduler", "Sequence",
           "ServingFrontend", "ResponseHandle", "create_serving_frontend",
           "Router", "Replica", "ServingHTTPServer", "start_http_server",
           "EngineSnapshot", "Watchdog", "WatchdogConfig",
           "BrownoutPolicy", "BrownoutController", "Drafter",
           "NgramDrafter", "SpecDecoder"]
