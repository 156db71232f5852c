"""GPT serving on a paged KV cache: allocator, prefix cache, scheduler,
metrics, speculative decoding, resilience policy (snapshots, watchdog,
brownout) and the continuous-batching engine (ragged and split
dispatch)."""
from .engine import ServingEngine, create_serving_engine
from .kv_cache import PagedKVCache
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .resilience import (BrownoutController, BrownoutPolicy, EngineSnapshot,
                         Watchdog, WatchdogConfig)
from .scheduler import Request, Scheduler, Sequence
from .spec_decode import Drafter, NgramDrafter, SpecDecoder

__all__ = ["ServingEngine", "create_serving_engine", "PagedKVCache",
           "PrefixCache", "ServingMetrics", "EngineSnapshot", "Watchdog",
           "WatchdogConfig", "BrownoutController", "BrownoutPolicy",
           "Request", "Scheduler", "Sequence", "Drafter", "NgramDrafter",
           "SpecDecoder"]
