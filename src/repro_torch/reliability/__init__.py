"""Reliability layer: SLO enforcement, graceful degradation, fault injection.

Two halves, the reference's (``repro.reliability``) on the port:

* ``ConformalSLO`` + ``SLOScheduler`` — per-tenant conformal virtual
  queues price "first token within D slots for q of requests" through the
  repo's single Algorithm-1 argmax, and a fixed degradation ladder
  (expire -> priority-shed -> admission cap) replaces unbounded backlog
  growth under overload, every shed recorded and counted.
* ``ChaosInjector`` + the chaos harness — deterministic seeded faults
  behind the engine/fleet/allocator seams, so the differential
  equivalence contract is asserted under failures, not just clean runs.

Everything here is host-side control: no kernel, no capture, no readback
of its own.
"""
from repro_torch.reliability.chaos import ChaosConfig, ChaosInjector
from repro_torch.reliability.conformal import ConformalQuantile
from repro_torch.reliability.harness import assert_no_leaks, chaos_drive, save_artifacts
from repro_torch.reliability.slo import (ConformalScheduler, ConformalSLO, SLOScheduler,
                                         TenantSLO)

__all__ = [
    "ChaosConfig",
    "ChaosInjector",
    "ConformalQuantile",
    "ConformalScheduler",
    "ConformalSLO",
    "SLOScheduler",
    "TenantSLO",
    "assert_no_leaks",
    "chaos_drive",
    "save_artifacts",
]
