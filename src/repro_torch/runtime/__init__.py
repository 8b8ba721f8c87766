from repro_torch.runtime.engine import (Engine, EngineConfig, PagedEngine,
                                       PagedEngineConfig)
from repro_torch.runtime.request import Request, RequestSource
from repro_torch.runtime.scheduler import (AdaptiveScheduler, MemoryAwareScheduler,
                                           PolicyScheduler, StaticScheduler)
from repro_torch.runtime.server import latency_stats, serve

__all__ = ["AdaptiveScheduler", "Engine", "EngineConfig", "MemoryAwareScheduler",
           "PagedEngine", "PagedEngineConfig", "PolicyScheduler", "Request",
           "RequestSource", "StaticScheduler", "latency_stats", "serve"]
