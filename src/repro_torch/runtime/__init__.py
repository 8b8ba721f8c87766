from repro_torch.runtime.engine import (Engine, EngineConfig, PagedEngine,
                                       PagedEngineConfig, ReadbackTimeout)
from repro_torch.runtime.fleet import ReplicaFleet
from repro_torch.runtime.request import Request, RequestSource, TenantSpec
from repro_torch.runtime.sampling import RowSampling, SamplingParams, row_tables, sample_rows
from repro_torch.runtime.scheduler import (AdaptiveScheduler, MemoryAwareScheduler,
                                           PolicyScheduler, PrecisionAwareScheduler,
                                           StaticScheduler, TokenAwareScheduler)
from repro_torch.runtime.server import latency_stats, serve

__all__ = ["AdaptiveScheduler", "Engine", "EngineConfig", "MemoryAwareScheduler",
           "PagedEngine", "PagedEngineConfig", "PolicyScheduler", "PrecisionAwareScheduler",
           "ReadbackTimeout", "ReplicaFleet", "Request", "RequestSource", "RowSampling",
           "SamplingParams", "StaticScheduler", "TenantSpec", "TokenAwareScheduler",
           "latency_stats",
           "row_tables", "sample_rows", "serve"]
