"""Policy-driven admission scheduler — the control plane meeting the engine.

``PolicyScheduler`` consumes any ``repro_torch.control.Policy``: each control
slot it observes the engine's backlog Q(t) (pending requests), evaluates the
policy (for ``DriftPlusPenalty`` that is the paper's Algorithm 1,
f* = argmax_f { V*S(f) - Q(t)*lambda(f) }), and tells the request source to
sample at f*. The queue is bounded (capacity) so sustained mis-control shows
up as drops — exactly the paper's reliability failure.

The policy runs with torch ops on the scheduler's ``device``: its tables
(F, S(F), lambda(F)) and carry are moved there once, and reading the
decision back is one small device-to-host copy per slot. ``serve`` sets the device to the
engine's when the caller left it unset; otherwise it resolves like every
entry point (``cuda`` unless the CPU is asked for).

A policy with an ``observe`` method (``MemoryAware``) advances its virtual
queue on the engine signal it names (``observation``) before it acts.

``AdaptiveScheduler`` / ``StaticScheduler`` / ``MemoryAwareScheduler`` are
thin constructors over ``PolicyScheduler``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.control import DriftPlusPenalty, MemoryAware, Policy, Static
from repro_torch.core.utility import Utility, paper_utility
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PolicyScheduler:
    """Admission control for the engine, driven by any Policy."""

    policy: Policy = None  # type: ignore[assignment]
    capacity: int = 256
    device: Optional[str] = None

    def __post_init__(self):
        if self.policy is None:
            self.policy = DriftPlusPenalty(
                rates=tuple(float(f) for f in range(1, 11)), V=50.0
            )
        self._dev = None          # policy tables and carry live here once resolved
        self._carry = self.policy.init()
        self.dropped = 0
        self.rate_history: list = []

    def _on_device(self) -> torch.device:
        """Move the policy's tables and the carry on first use."""
        if self._dev is None:
            self._dev = resolve_device(self.device)
            self.policy = self.policy.to(self._dev)
            if hasattr(self._carry, "to"):
                self._carry = self._carry.to(self._dev)
        return self._dev

    def _observe(self, occupancy: Optional[float]) -> None:
        """Feed an observation-driven virtual queue: a policy exposing
        ``observe`` names the engine signal it consumes in ``observation``
        ("occupancy" is the one the port's engines report) and advances on
        it before acting; other policies ignore it."""
        if occupancy is not None and getattr(self.policy, "observation", None) == "occupancy":
            self._carry = self.policy.observe(self._carry, occupancy)

    def control(self, backlog: int, occupancy: Optional[float] = None) -> float:
        """One control-slot decision: the rate to sample at. ``occupancy``
        (the paged engine's page-pool fill) feeds ``MemoryAware``'s virtual
        queue, observed before the policy acts."""
        self._on_device()
        self._observe(occupancy)
        q = torch.tensor(backlog, dtype=torch.float32, device=self._dev)
        f_star, self._carry = self.policy.act(self._carry, q)
        f = float(f_star)
        self.rate_history.append(f)
        return f

    def admit(self, engine, reqs: list, now: int) -> list:
        room = max(self.capacity - engine.queue_len(), 0)
        admitted = reqs[:room]
        self.dropped += len(reqs) - len(admitted)
        for r in admitted:
            r.admit_slot = now
        engine.submit(admitted)
        return admitted


def AdaptiveScheduler(
    rates: tuple = tuple(float(f) for f in range(1, 11)),
    V: float = 50.0,
    utility: Optional[Utility] = None,
    capacity: int = 256,
    device: Optional[str] = None,
) -> PolicyScheduler:
    """Algorithm-1 scheduler (historical constructor)."""
    policy = DriftPlusPenalty(
        rates=tuple(float(f) for f in rates), V=V,
        utility=utility or paper_utility(max(rates)),
    )
    return PolicyScheduler(policy=policy, capacity=capacity, device=device)


def StaticScheduler(rate: float = 10.0, capacity: int = 256,
                    device: Optional[str] = None) -> PolicyScheduler:
    """Paper baseline: fixed sampling rate, no queue awareness."""
    return PolicyScheduler(policy=Static(rate=float(rate)), capacity=capacity,
                           device=device)


def MemoryAwareScheduler(
    rates: tuple = tuple(float(f) for f in range(1, 11)),
    V: float = 50.0,
    pages_per_request: float = 2.0,
    occupancy_budget: float = 0.6,
    mem_gain: float = 1.0,
    capacity: int = 256,
    device: Optional[str] = None,
) -> PolicyScheduler:
    """Algorithm-1 scheduler that also prices page-pool occupancy."""
    policy = MemoryAware(
        rates=tuple(float(f) for f in rates), V=V,
        pages_per_request=pages_per_request,
        occupancy_budget=occupancy_budget, mem_gain=mem_gain,
    )
    return PolicyScheduler(policy=policy, capacity=capacity, device=device)
