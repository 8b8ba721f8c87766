from repro_torch.control.policy import (DriftPlusPenalty, LatencyAware, MemoryAware,
                                        Policy, PrecisionAware, Static, TokenBacklogAware,
                                        VirtualQueue, drift_plus_penalty_action)

__all__ = ["DriftPlusPenalty", "LatencyAware", "MemoryAware", "Policy", "PrecisionAware",
           "Static", "TokenBacklogAware", "VirtualQueue", "drift_plus_penalty_action"]
