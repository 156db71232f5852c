"""GPT serving on a paged KV cache: allocator, scheduler, metrics,
speculative decoding and the continuous-batching engine (ragged and
split dispatch)."""
from .engine import ServingEngine, create_serving_engine
from .kv_cache import PagedKVCache
from .metrics import ServingMetrics
from .scheduler import Request, Scheduler, Sequence
from .spec_decode import Drafter, NgramDrafter, SpecDecoder

__all__ = ["ServingEngine", "create_serving_engine", "PagedKVCache",
           "ServingMetrics", "Request", "Scheduler", "Sequence", "Drafter",
           "NgramDrafter", "SpecDecoder"]
