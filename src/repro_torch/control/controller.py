"""The bundled one-object controller API over the control plane.

``LyapunovController`` packages (policy construction, one-slot decision,
closed-loop rollout) for callers that want a single-object interface; the
decision itself is still the one ``drift_plus_penalty_action`` behind the
``Policy`` protocol.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.control.policy import DriftPlusPenalty, LatencyAware, Policy, VirtualQueue
from repro_torch.control.rollout import closed_loop
from repro_torch.core.queueing import ServiceProcess
from repro_torch.core.utility import Utility


@dataclasses.dataclass(frozen=True)
class LyapunovController:
    """Bundled Algorithm-1 controller over a discrete rate set.

    ``policy()`` yields the underlying Policy (``DriftPlusPenalty``, or
    ``LatencyAware`` when a cost budget is set), ``act`` evaluates one
    slot, ``run`` is the shared closed-loop rollout of
    ``repro_torch.control.rollout``. lambda(f) = arrival_gain * f: the
    paper's setting has lambda(f) = f (each sampled frame enters the queue).
    """

    rates: tuple[float, ...]
    V: float
    utility: Utility
    arrival_gain: float = 1.0  # lambda(f) = arrival_gain * f
    # optional constraint: per-slot cost y(f) = cost_gain * f with budget
    cost_gain: float = 0.0
    cost_budget: float = 0.0

    def policy(self) -> Policy:
        if self.cost_gain > 0.0:
            return LatencyAware(rates=self.rates, V=self.V, utility=self.utility,
                                arrival_gain=self.arrival_gain, cost_gain=self.cost_gain,
                                cost_budget=self.cost_budget)
        return DriftPlusPenalty(rates=self.rates, V=self.V, utility=self.utility,
                                arrival_gain=self.arrival_gain)

    def tables(self):
        return self.policy().tables()

    def act(self, backlog, vq: Optional[VirtualQueue] = None) -> torch.Tensor:
        """f* for the observed backlog, on the backlog's device."""
        backlog = torch.as_tensor(backlog, dtype=torch.float32)
        policy = self.policy().to(backlog.device)
        carry = vq if vq is not None else policy.init()
        if hasattr(carry, "to"):
            carry = carry.to(backlog.device)
        f_star, _ = policy.act(carry, backlog)
        return f_star

    def run(self, service: ServiceProcess, horizon: int,
            generator: Optional[torch.Generator] = None, capacity: float = math.inf,
            stochastic_arrivals: bool = False, device=None) -> dict:
        """Closed-loop rollout: observe Q -> Algorithm 1 -> arrivals -> queue
        step. Returns per-slot {backlog, rate, utility, service[, vq]}."""
        return closed_loop(self.policy(), service, horizon, generator, capacity=capacity,
                           stochastic_arrivals=stochastic_arrivals, utility=self.utility,
                           device=device)
