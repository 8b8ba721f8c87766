"""Queue dynamics from the paper (Sec. II-C).

The paper models the arrival queue of the FID pipeline as

    Q(t+1) = max{Q(t) - mu(t), 0} + lambda(f(t))

where Q(t) is the backlog, mu(t) the number of items the service drains in
slot t, and lambda(f(t)) the arrivals induced by the controllable rate f(t).

  * ``queue_update`` — the exact one-step recursion (elementwise).
  * ``QueueState`` — backlog plus overflow accounting for a *bounded* queue
    (the paper's reliability failure mode is the overflow of a finite queue).
  * ``simulate_queue`` — a slot loop over an arrival/service process.

A vector of queues (multi-tenant, per pod) is a leading axis: every op is
elementwise. The queue is float32, as the reference's is (JAX runs with
x64 off): ``bounded_queue_step`` casts arrivals and service to float32
first, so a float64 rate (``Static``'s) never promotes the backlog.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.device import resolve_device


class QueueState(NamedTuple):
    """Backlog state of one (or a vector of) bounded FIFO queue(s).

    backlog:    current queue length Q(t) (float32, the paper's fluid model).
    dropped:    cumulative arrivals dropped because the queue was full.
    served:     cumulative departures.
    overflowed: sticky flag: did backlog ever exceed ``capacity``?
    """

    backlog: torch.Tensor
    dropped: torch.Tensor
    served: torch.Tensor
    overflowed: torch.Tensor

    @staticmethod
    def zeros(shape=(), device=None) -> "QueueState":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return QueueState(z, z.clone(), z.clone(),
                          torch.zeros(shape, dtype=torch.bool, device=device))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def queue_update(backlog, service, arrivals) -> torch.Tensor:
    """The paper's recursion: Q(t+1) = max(Q(t) - mu(t), 0) + lambda(f(t))."""
    return torch.clamp(backlog - service, min=0.0) + arrivals


def bounded_queue_step(state: QueueState, service, arrivals,
                       capacity=math.inf) -> QueueState:
    """One slot of a *bounded* queue: serve first, then admit up to capacity.

    The unbounded recursion above is what the Lyapunov analysis stabilizes;
    the bounded step is what a real system executes: arrivals beyond
    ``capacity`` are dropped and counted, and ``overflowed`` latches whether
    the bound was ever hit (the paper's reliability criterion). Service,
    arrivals and capacity enter as float32.
    """
    dev = state.backlog.device
    service, arrivals = _f32(service, dev), _f32(arrivals, dev)
    capacity = _f32(capacity, dev)
    after_service = torch.clamp(state.backlog - service, min=0.0)
    served_now = state.backlog - after_service
    room = torch.clamp(capacity - after_service, min=0.0)
    admitted = torch.minimum(arrivals, room)
    dropped_now = arrivals - admitted
    return QueueState(
        backlog=after_service + admitted,
        dropped=state.dropped + dropped_now,
        served=state.served + served_now,
        overflowed=state.overflowed | (dropped_now > 0),
    )


@dataclasses.dataclass(frozen=True)
class ServiceProcess:
    """Stochastic service process mu(t).

    kind:
      "deterministic": mu(t) = rate.
      "poisson":       mu(t) ~ Poisson(rate).
      "markov":        two-state (fast/slow) Markov-modulated deterministic
                       service: the FID pipeline alternating between cheap
                       (no face) and expensive (faces present) frames.

    The draws come from the ``torch.Generator`` the caller passes, not from
    the reference's jax.random streams: the same seed gives the same trace
    here on every device, and a trace the reference's.
    """

    kind: str = "deterministic"
    rate: float = 10.0
    slow_rate: float = 4.0
    p_stay: float = 0.9

    def init_state(self, device=None) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int32, device=device)  # markov mode index

    def sample(self, generator: Optional[torch.Generator],
               state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (mu_t, next_state), mu_t float32 on ``state``'s device.
        The poisson and markov kinds draw from ``generator``, which lives
        on that device."""
        dev = state.device
        if self.kind == "deterministic":
            return torch.full((), self.rate, dtype=torch.float32, device=dev), state
        if self.kind == "poisson":
            lam = torch.full((), self.rate, dtype=torch.float32, device=dev)
            return torch.poisson(lam, generator=generator), state
        if self.kind == "markov":
            u = torch.rand((), generator=generator, device=dev)
            flip = u < (1.0 - self.p_stay)
            nxt = torch.where(flip, 1 - state, state)
            mu = torch.where(nxt == 0, torch.tensor(self.rate, dtype=torch.float32, device=dev),
                             torch.tensor(self.slow_rate, dtype=torch.float32, device=dev))
            return mu, nxt
        raise ValueError(f"unknown service kind: {self.kind}")


def simulate_queue(arrivals_fn: Callable[[torch.Generator, int], torch.Tensor],
                   service: ServiceProcess, horizon: int,
                   generator: Optional[torch.Generator] = None, capacity=math.inf,
                   device=None) -> tuple[QueueState, dict]:
    """Run the bounded queue for ``horizon`` slots under a fixed arrival
    process, on ``device`` (None: the card; ``generator`` lives there).
    ``arrivals_fn(generator, t)`` gives slot t's arrivals. Returns the final
    state and the per-slot trace {backlog, service, arrivals}, each a
    (horizon,) float32 tensor."""
    dev = resolve_device(device)
    state, svc = QueueState.zeros(device=dev), service.init_state(dev)
    trace = {"backlog": [], "service": [], "arrivals": []}
    for t in range(horizon):
        mu, svc = service.sample(generator, svc)
        lam = _f32(arrivals_fn(generator, t), dev)
        state = bounded_queue_step(state, mu, lam, capacity)
        trace["backlog"].append(state.backlog)
        trace["service"].append(mu)
        trace["arrivals"].append(lam)
    return state, {k: torch.stack(v) for k, v in trace.items()}


def time_average_backlog(backlogs: torch.Tensor, horizon: int) -> torch.Tensor:
    """(1/t) * sum Q(tau): the stability functional the paper bounds."""
    return torch.sum(backlogs[:horizon]) / horizon
