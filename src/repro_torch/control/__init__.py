from repro_torch.control.policy import (DriftPlusPenalty, LatencyAware, Policy,
                                        Static, VirtualQueue,
                                        drift_plus_penalty_action)

__all__ = ["DriftPlusPenalty", "LatencyAware", "Policy", "Static",
           "VirtualQueue", "drift_plus_penalty_action"]
