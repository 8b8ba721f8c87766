"""Unified observability: metrics registry, lifecycle tracing, decision log.

One ``Observability`` bundle threads through the whole stack — engines,
fleet, scheduler, router, server, launcher. The default everywhere is
``OBS_OFF`` (null recorder + null decision log + no registry): hot paths
pay one ``enabled`` branch per site and emit nothing, and observability
on/off never changes a single generated token, because every collector is
host-side and pull-based: no captured CUDA graph and no kernel knows it
exists, counters are exported from host integers, and nothing here reads
the card back or synchronizes it.

    from repro_torch.obs import observability
    obs = observability()                     # everything on
    eng = PagedEngine(model, ecfg, obs=obs)
    ...
    print(obs.registry.prometheus_text())     # metrics exposition
    obs.trace.save("trace.json")              # open in Perfetto
    print(obs.decisions.explain_rate())       # why the controller chose f*
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.decisions import (
    NULL_DECISIONS,
    DecisionLog,
    NullDecisionLog,
    explain_tables,
    policy_tables,
    replay_rollout,
)
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    GAUGE_KEYS,
    Gauge,
    Histogram,
    Metric,
    MetricsRegistry,
    export_counters,
    parse_prometheus,
)
from repro_torch.obs.trace import EVENT_KINDS, NULL_TRACE, NullRecorder, TraceRecorder

__all__ = [
    "DEFAULT_BUCKETS", "EVENT_KINDS", "GAUGE_KEYS", "NULL_DECISIONS",
    "NULL_TRACE", "OBS_OFF", "DecisionLog", "Gauge", "Histogram", "Metric",
    "MetricsRegistry", "NullDecisionLog", "NullRecorder", "Observability",
    "TraceRecorder", "explain_tables", "export_counters", "observability",
    "parse_prometheus", "policy_tables", "replay_rollout",
]


@dataclasses.dataclass
class Observability:
    """The bundle the runtime passes around: trace + registry + decisions.

    ``enabled`` mirrors ``trace.enabled`` for the common "is anything on"
    hot-path check; components can be mixed (e.g. decisions-only) by
    constructing the bundle by hand.
    """

    trace: TraceRecorder = NULL_TRACE
    registry: Optional[MetricsRegistry] = None
    decisions: DecisionLog = NULL_DECISIONS

    @property
    def enabled(self) -> bool:
        return self.trace.enabled or self.decisions.enabled

    def export(self, counters: dict, labels: Optional[dict] = None) -> None:
        """Publish a counters() dict into the registry (no-op if none)."""
        if self.registry is not None:
            export_counters(self.registry, counters, labels)


# The process-wide "observability disabled" singleton. Engines default to
# it; identity-compare (obs is OBS_OFF) is the cheap "nothing on" test.
OBS_OFF = Observability()


def observability(trace_capacity: int = 65536,
                  decision_capacity: int = 8192) -> Observability:
    """Everything on: live recorder, fresh registry, live decision log."""
    return Observability(
        trace=TraceRecorder(capacity=trace_capacity),
        registry=MetricsRegistry(),
        decisions=DecisionLog(capacity=decision_capacity),
    )
