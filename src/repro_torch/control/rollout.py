"""Closed-loop rollouts of any Policy: trace-based and stochastic.

Two entry points, both loops over slots of the bounded queue recursion:

  * ``rollout(policy, mus)``: trace-based (the paper's evaluation style).
    The service trace mu(t) is given, so different policies run against
    *identical* service realizations and curves differ only by policy.
  * ``closed_loop(policy, service, horizon, generator)``: the service
    process is sampled inside the loop (optionally Poisson-thinned
    arrivals), the fully stochastic setting the Lyapunov bounds cover.

Both return the same per-slot trace dict {backlog, rate, utility?,
service?, vq?}, each a (horizon,) tensor (``rate`` float32), plus "final"
(the QueueState). A rollout runs on ``device`` (None: the card), eagerly,
slot by slot.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.control.policy import Policy, VirtualQueue
from repro_torch.core.queueing import QueueState, ServiceProcess, bounded_queue_step
from repro_torch.device import resolve_device


def _init(policy: Policy, device: torch.device):
    """The policy with its tables on ``device`` and its carry there."""
    policy = policy.to(device)
    carry = policy.init()
    return policy, (carry.to(device) if hasattr(carry, "to") else carry)


def _finish(out: dict, final: QueueState) -> dict:
    trace = {k: torch.stack(v) for k, v in out.items() if v}
    trace["final"] = final
    return trace


def rollout(policy: Policy, mus, capacity=math.inf, device=None) -> dict:
    """Run ``policy`` against a pre-generated service trace mu(t) (T,) on
    ``device`` (None: the card), where the trace is moved first.

    Per slot: observe Q -> act -> arrivals lambda(f*) -> bounded queue step.
    """
    dev = resolve_device(device)
    mus = torch.as_tensor(mus).to(device=dev, dtype=torch.float32)
    policy, carry = _init(policy, dev)
    q = QueueState.zeros(device=dev)
    out = {"backlog": [], "rate": [], "vq": []}
    for mu in mus:
        f_star, carry = policy.act(carry, q.backlog)
        q = bounded_queue_step(q, mu, policy.arrivals(f_star), capacity)
        out["backlog"].append(q.backlog)
        out["rate"].append(f_star.to(torch.float32))
        if isinstance(carry, VirtualQueue):
            out["vq"].append(carry.value)
    return _finish(out, q)


def closed_loop(policy: Policy, service: ServiceProcess, horizon: int,
                generator: Optional[torch.Generator] = None, capacity=math.inf,
                stochastic_arrivals: bool = False, utility=None, device=None) -> dict:
    """Fully stochastic rollout: the service process is sampled in the loop
    from ``generator`` (and, with ``stochastic_arrivals``, Poisson
    arrivals of mean lambda(f*)). Returns per-slot {backlog, rate, service,
    utility (with a ``utility`` fn), vq (with a virtual queue)}. ``device``
    None means the card."""
    dev = resolve_device(device)
    policy, carry = _init(policy, dev)
    q, svc = QueueState.zeros(device=dev), service.init_state(dev)
    out = {"backlog": [], "rate": [], "service": [], "utility": [], "vq": []}
    for _ in range(horizon):
        f_star, carry = policy.act(carry, q.backlog)
        lam = policy.arrivals(f_star)
        if stochastic_arrivals:
            g_dev = generator.device if generator is not None else dev
            lam = torch.poisson(lam.to(device=g_dev, dtype=torch.float32),
                                generator=generator).to(dev)
        mu, svc = service.sample(generator, svc)
        q = bounded_queue_step(q, mu, lam, capacity)
        out["backlog"].append(q.backlog)
        out["rate"].append(f_star.to(torch.float32))
        out["service"].append(mu)
        if utility is not None:
            out["utility"].append(utility(f_star))
        if isinstance(carry, VirtualQueue):
            out["vq"].append(carry.value)
    return _finish(out, q)
