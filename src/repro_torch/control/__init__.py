from repro_torch.control.controller import LyapunovController
from repro_torch.control.policy import (DriftPlusPenalty, LatencyAware, MemoryAware,
                                        Policy, PrecisionAware, Static, TokenBacklogAware,
                                        VirtualQueue, drift_plus_penalty_action)
from repro_torch.control.rollout import closed_loop, rollout
from repro_torch.control.router import ROUTER_KINDS, FleetRouter, ReplicaLoad

__all__ = ["ROUTER_KINDS", "DriftPlusPenalty", "FleetRouter", "LatencyAware",
           "LyapunovController", "MemoryAware", "Policy", "PrecisionAware", "ReplicaLoad",
           "Static", "TokenBacklogAware", "VirtualQueue", "closed_loop",
           "drift_plus_penalty_action", "rollout"]
