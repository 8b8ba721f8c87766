"""Core: the paper's queue model, utility and trace-based evaluation.

``queueing`` and ``utility`` are leaf modules and import eagerly. The
controller and the Fig. 2 simulation sit on top of the control plane
(``repro_torch.control``, whose policies import ``core.utility``), so their
names are resolved lazily (PEP 562) to keep the leaves importable from
inside ``repro_torch.control`` without a cycle.
"""
import importlib

from repro_torch.core.queueing import (QueueState, ServiceProcess, bounded_queue_step,
                                       queue_update, simulate_queue, time_average_backlog)
from repro_torch.core.utility import Utility, paper_utility

_LAZY = {
    "LyapunovController": "repro_torch.control.controller",
    "VirtualQueue": "repro_torch.control.policy",
    "drift_plus_penalty_action": "repro_torch.control.policy",
    "Fig2Config": "repro_torch.core.trace",
    "fig2_experiment": "repro_torch.core.trace",
    "make_service_trace": "repro_torch.core.trace",
    "summarize": "repro_torch.core.trace",
}

__all__ = ["Fig2Config", "LyapunovController", "QueueState", "ServiceProcess", "Utility",
           "VirtualQueue", "bounded_queue_step", "drift_plus_penalty_action",
           "fig2_experiment", "make_service_trace", "paper_utility", "queue_update",
           "simulate_queue", "summarize", "time_average_backlog"]


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
