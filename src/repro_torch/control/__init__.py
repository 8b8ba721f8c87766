from repro_torch.control.controller import LyapunovController
from repro_torch.control.policy import (DriftPlusPenalty, LatencyAware, MemoryAware,
                                        Policy, PrecisionAware, Static, TokenBacklogAware,
                                        VirtualQueue, drift_plus_penalty_action)
from repro_torch.control.rollout import closed_loop, rollout

__all__ = ["DriftPlusPenalty", "LatencyAware", "LyapunovController", "MemoryAware", "Policy",
           "PrecisionAware", "Static", "TokenBacklogAware", "VirtualQueue", "closed_loop",
           "drift_plus_penalty_action", "rollout"]
