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

A policy with an ``observe`` method (``MemoryAware``, ``TokenBacklogAware``,
``PrecisionAware``) advances its virtual queue on the engine signal it
names (``observation``) before it acts. ``admit_precision`` asks a policy
with that lever (``PrecisionAware``) for the page region of the next
admissions; its latch lives on the host, so asking costs no readback.

``control_async`` is the sync-free loop's control: it dispatches this
slot's decision on the device, copies it into pinned host memory behind a
CUDA event, and returns the previous slot's decision (one-slot-lagged
control), so reading the controller never drains the card's stream.

``AdaptiveScheduler`` / ``StaticScheduler`` / ``MemoryAwareScheduler`` /
``TokenAwareScheduler`` / ``PrecisionAwareScheduler`` are thin
constructors over ``PolicyScheduler``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.control import (DriftPlusPenalty, MemoryAware, Policy, PrecisionAware,
                                 Static, TokenBacklogAware)
from repro_torch.control.policy import as_f32
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
        self._pending_rate = None  # control_async: (host copy, event) of the last decision

    def _on_device(self) -> torch.device:
        """Move the policy's tables and the carry on first use."""
        if self._dev is None:
            self._dev = resolve_device(self.device)
            self.policy = self.policy.to(self._dev)
            if hasattr(self._carry, "to"):
                self._carry = self._carry.to(self._dev)
        return self._dev

    def _observe(self, occupancy: Optional[float], token_backlog: Optional[float],
                 quant_occupancy: Optional[float] = None) -> None:
        """Feed an observation-driven virtual queue: a policy exposing
        ``observe`` names the engine signal it consumes in ``observation``
        ("occupancy" for MemoryAware, "token_backlog" for
        TokenBacklogAware, "quant_occupancy" for PrecisionAware) and
        advances on it before acting; other policies ignore all three."""
        if not hasattr(self.policy, "observe"):
            return
        sig = {"occupancy": occupancy, "token_backlog": token_backlog,
               "quant_occupancy": quant_occupancy}.get(
            getattr(self.policy, "observation", "occupancy"))
        if sig is not None:
            self._carry = self.policy.observe(self._carry, sig)

    def admit_precision(self, occupancy: Optional[float]) -> Optional[str]:
        """The policy's page region for the next admissions ("native" or
        a quantized tag), or None if the policy has no such lever. The serve
        loop assigns it to ``engine.admit_precision``."""
        if occupancy is None or not hasattr(self.policy, "admit_precision"):
            return None
        chosen, self._carry = self.policy.admit_precision(self._carry, occupancy)
        return chosen

    def _act(self, backlog: int) -> torch.Tensor:
        """Evaluate the policy on the device; the (unread) decision."""
        f_star, self._carry = self.policy.act(self._carry, as_f32(backlog, self._dev))
        return f_star

    def control(self, backlog: int, occupancy: Optional[float] = None,
                token_backlog: Optional[float] = None,
                quant_occupancy: Optional[float] = None) -> float:
        """One control-slot decision: the rate to sample at. ``occupancy``
        (the paged engine's page-pool fill), ``token_backlog`` (pending
        prompt tokens) and ``quant_occupancy`` (the quantized region's
        fill) feed the virtual queue of a policy that observes them, before
        the policy acts."""
        self._on_device()
        self._observe(occupancy, token_backlog, quant_occupancy)
        f = float(self._act(backlog))
        self.rate_history.append(f)
        return f

    def control_async(self, backlog: int, occupancy: Optional[float] = None,
                      token_backlog: Optional[float] = None,
                      quant_occupancy: Optional[float] = None) -> float:
        """Sync-free control: dispatch this slot's decision and return the
        PREVIOUS one. The decision is copied into pinned host memory with
        ``non_blocking=True`` behind a recorded CUDA event and read one slot
        later, when the card has long passed it, so the serve loop never
        drains the stream for the controller. One-slot-lagged control: the
        drift-plus-penalty argument tolerates a bounded observation delay.
        The first call waits for its own decision to seed the pipeline;
        ``Static`` returns its rate with no device work."""
        self._on_device()
        self._observe(occupancy, token_backlog, quant_occupancy)
        if isinstance(self.policy, Static):
            f = float(self.policy.rate)
            self.rate_history.append(f)
            return f
        f_star = self._act(backlog)
        if self._dev.type == "cuda":
            host = torch.empty(f_star.shape, dtype=f_star.dtype, pin_memory=True)
            host.copy_(f_star, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = f_star, None
        prev, self._pending_rate = self._pending_rate, (host, event)
        host, event = prev if prev is not None else self._pending_rate
        if event is not None:
            event.synchronize()   # recorded a slot ago: the card is past it
        f = float(host)
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


def TokenAwareScheduler(
    rates: tuple = tuple(float(f) for f in range(1, 11)),
    V: float = 50.0,
    tokens_per_request: float = 16.0,
    token_budget: float = 64.0,
    tok_gain: float = 1.0,
    capacity: int = 256,
    device: Optional[str] = None,
) -> PolicyScheduler:
    """Algorithm-1 scheduler that also prices pending prompt tokens (pairs
    with the engine's ``token_backlog()`` observation)."""
    policy = TokenBacklogAware(
        rates=tuple(float(f) for f in rates), V=V,
        tokens_per_request=tokens_per_request,
        token_budget=token_budget, tok_gain=tok_gain,
    )
    return PolicyScheduler(policy=policy, capacity=capacity, device=device)


def PrecisionAwareScheduler(
    rates: tuple = tuple(float(f) for f in range(1, 11)),
    V: float = 50.0,
    pages_per_request: float = 2.0,
    quant_budget: float = 0.6,
    quant_gain: float = 1.0,
    downgrade_at: float = 0.75,
    upgrade_at: float = 0.5,
    quant_precision: str = "int8",
    capacity: int = 256,
    device: Optional[str] = None,
) -> PolicyScheduler:
    """Algorithm-1 scheduler with the quantized-page admission lever: the
    serve loop asks ``admit_precision(engine occupancy)`` each slot for the
    page region, and the quantized region's fill
    (``engine.quant_occupancy()``) is priced as a virtual queue.
    ``quant_precision`` is the region's tag in the engine's allocator
    (``"int8"`` or ``"float8_e4m3fn"``)."""
    policy = PrecisionAware(
        rates=tuple(float(f) for f in rates), V=V,
        pages_per_request=pages_per_request,
        quant_budget=quant_budget, quant_gain=quant_gain,
        downgrade_at=downgrade_at, upgrade_at=upgrade_at,
        quant_precision=quant_precision,
    )
    return PolicyScheduler(policy=policy, capacity=capacity, device=device)
