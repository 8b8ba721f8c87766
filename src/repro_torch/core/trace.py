"""Trace-based simulation reproducing the paper's evaluation (Fig. 2).

The paper: "We designed the simulation to mimic an FID system with a
threshold of 10 frames/sec at which a queue-divergence would occur. We then
varied the frame rate from 1 to 10, with and without our framework." Four
curves result: (1) fixed f=10: the queue (eventually) overflows; (2, 3) the
controller with two values of V stabilizes at V-dependent backlogs; (4)
fixed f=1 is stable but lowest-utility.

The setting: action set F = {1..10}, lambda(f) = f, and a stochastic
service trace whose *mean is just below the 10 fps threshold* (a
Markov-modulated FID pipeline: fast slots when frames have no faces, slow
slots when the detector and DNN run), so f=10 has strictly positive drift
and diverges, while every f <= 9 is stabilizable. The service trace is
drawn once per seed and *shared* by all four policies (trace-based, like
the paper), so curves differ only by policy.

The trace is drawn from a CPU ``torch.Generator`` seeded with
``cfg.seed`` and moved to the device once, so a seed gives the same trace
on every device. It is not the reference's jax.random draw; its curves
agree with the reference's in kind, not in number.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.control import DriftPlusPenalty, Policy, Static, rollout
from repro_torch.core.queueing import ServiceProcess
from repro_torch.core.utility import Utility, paper_utility
from repro_torch.device import resolve_device

CURVES = ("fixed_10", "V_high", "V_low", "fixed_1")


@dataclasses.dataclass(frozen=True)
class Fig2Config:
    horizon: int = 3000
    f_max: float = 10.0
    n_rates: int = 10              # F = {1, 2, ..., 10}
    # Markov-modulated service: fast 10.8 fps / slow 8.4 fps, symmetric 0.9
    # stay probability -> stationary mean 9.6 fps < 10 (the divergence
    # threshold), so fixed f=10 has +0.4/slot drift and diverges while every
    # f <= 9 is stabilizable.
    service: ServiceProcess = ServiceProcess(kind="markov", rate=10.8, slow_rate=8.4,
                                             p_stay=0.9)
    capacity: float = math.inf     # Fig. 2 plots raw backlog growth
    V_high: float = 200.0
    V_low: float = 50.0
    seed: int = 0


def make_service_trace(cfg: Fig2Config, device=None) -> torch.Tensor:
    """The shared mu(t) trace (horizon,) float32, drawn on the CPU from
    ``cfg.seed`` and moved to ``device`` (None: the card) once."""
    g = torch.Generator().manual_seed(cfg.seed)
    state, mus = cfg.service.init_state(), []
    for _ in range(cfg.horizon):
        mu, state = cfg.service.sample(g, state)
        mus.append(mu)
    return torch.stack(mus).to(resolve_device(device))


def rollout_policy(policy: Policy, mus, capacity: float = math.inf, device=None) -> dict:
    """Any Policy against a shared service trace (the unified entry point),
    on ``device`` (None: the card)."""
    return rollout(policy, mus, capacity=capacity, device=device)


def rollout_fixed(mus, f: float, capacity: float = math.inf, device=None) -> dict:
    """Fixed-rate policy against a service trace, on ``device`` (None: the
    card)."""
    return rollout(Static(rate=float(f)), mus, capacity=capacity, device=device)


def rollout_controller(mus, V: float, cfg: Fig2Config, utility: Utility | None = None,
                       capacity: float = math.inf, device=None) -> dict:
    """Algorithm 1 in closed loop against the same service trace, on
    ``device`` (None: the card); lambda(f) = f (arrival_gain 1): every
    sampled frame enters the queue."""
    utility = utility or paper_utility(cfg.f_max)
    policy = DriftPlusPenalty(rates=tuple(float(x) for x in range(1, cfg.n_rates + 1)),
                              V=float(V), utility=utility)
    return rollout(policy, mus, capacity=capacity, device=device)


def fig2_experiment(cfg: Fig2Config = Fig2Config(), device=None) -> dict:
    """All four Fig. 2 curves against one shared service trace, on
    ``device`` (None: the card).

    Returns {"service": mu trace, "fixed_10": ..., "V_high": ...,
    "V_low": ..., "fixed_1": ...}, each curve with per-slot backlog and
    rate and its final QueueState. ``cfg.capacity`` bounds the fixed-rate
    curves' queue; the controllers run unbounded, as in the reference.
    """
    dev = resolve_device(device)
    mus = make_service_trace(cfg, dev)
    return {
        "service": mus,
        "fixed_10": rollout_fixed(mus, cfg.f_max, cfg.capacity, dev),           # (1) red
        "V_high": rollout_controller(mus, cfg.V_high, cfg, device=dev),        # (2) black
        "V_low": rollout_controller(mus, cfg.V_low, cfg, device=dev),          # (3) blue
        "fixed_1": rollout_fixed(mus, 1.0, cfg.capacity, dev),                 # (4) green
    }


def summarize(result: dict, tail: int = 500) -> dict:
    """Scalar summary of each curve: final and tail-mean backlog, mean rate."""
    out = {}
    for name in CURVES:
        tr = result[name]
        out[name] = {
            "final_backlog": float(tr["backlog"][-1]),
            "tail_mean_backlog": float(tr["backlog"][-tail:].mean()),
            "mean_rate": float(tr["rate"].mean()),
        }
    return out
