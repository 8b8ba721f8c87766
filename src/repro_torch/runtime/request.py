"""Requests and workload sources for the serving engine.

The paper's video source maps to a RequestSource producing work at a fixed
raw rate (frames/slot); the framework *samples* that stream at the
controller-chosen rate f(t) — sampled items enter the engine's bounded
queue, unsampled ones are the utility loss S(f) measures.

The draws are the reference package's, from ``np.random.default_rng(seed)``
in the same order, so both packages see the same workload.

Multi-tenant SLO workloads tag each request with a tenant name, a priority
tier and an optional TTFT deadline: the reliability layer's degradation
ladder sheds by priority and expires by deadline, and ``ConformalSLO``
calibrates per-tenant deadline quantiles from the TTFT samples the tagged
requests produce.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.runtime.sampling import SamplingParams


@dataclasses.dataclass
class Request:
    rid: int
    arrival_slot: int
    tokens: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    # multi-tenant SLO tagging (defaults = the single-tenant workload)
    tenant: str = "default"
    priority: int = 0             # higher = shed later under overload
    deadline_slots: Optional[int] = None  # TTFT deadline (slots after arrival)
    # per-request sampling knobs (runtime/sampling.py); None = the engine's
    # default (greedy unless its config says otherwise)
    sampling: Optional[SamplingParams] = None
    # filled by the engine:
    admit_slot: Optional[int] = None
    start_slot: Optional[int] = None
    first_token_slot: Optional[int] = None  # first generated token emitted
    finish_slot: Optional[int] = None
    generated: Optional[list] = None
    truncated: bool = False       # prompt exceeded the engine's bucket


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's share of a multi-tenant workload mix."""

    name: str
    frac: float = 1.0             # fraction of arrivals carrying this tag
    priority: int = 0
    deadline_slots: Optional[int] = None


@dataclasses.dataclass
class RequestSource:
    """Produces ``raw_rate`` requests per slot (the camera's native fps).

    ``min_prompt_len`` < prompt_len yields ragged prompts (lengths uniform
    in [min_prompt_len, prompt_len]) — the workload the engine's
    length-aware bucketed prefill exists for. ``long_frac`` of arrivals
    carry a ``long_prompt_len`` prompt instead.

    ``tenants`` (a tuple of TenantSpec) tags each arrival by a draw from
    the mix, after its tokens; omitted, every request is the untagged
    single-tenant default and the random stream is unchanged.
    """

    vocab_size: int
    prompt_len: int
    raw_rate: int = 10
    max_new_tokens: int = 16
    seed: int = 0
    min_prompt_len: Optional[int] = None   # None => fixed prompt_len
    long_frac: float = 0.0
    long_prompt_len: Optional[int] = None
    tenants: Optional[tuple] = None        # tuple[TenantSpec, ...] mix

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._next_id = 0
        self.produced = 0
        if self.tenants:
            total = sum(t.frac for t in self.tenants)
            if total <= 0:
                raise ValueError("tenant fracs must sum to a positive value")
            self._tenant_cdf = np.cumsum([t.frac / total for t in self.tenants])

    def _draw_tenant(self) -> TenantSpec:
        u = self._rng.random()
        idx = int(np.searchsorted(self._tenant_cdf, u, side="right"))
        return self.tenants[min(idx, len(self.tenants) - 1)]

    def poll(self, slot: int, sample_rate: float) -> list:
        """One slot's arrivals, subsampled at sample_rate/raw_rate."""
        n_raw = self.raw_rate
        self.produced += n_raw
        p = min(sample_rate / self.raw_rate, 1.0)
        n_admit = int(self._rng.binomial(n_raw, p))
        out = []
        for _ in range(n_admit):
            plen = self.prompt_len
            if self.min_prompt_len is not None:
                plen = int(self._rng.integers(self.min_prompt_len,
                                              self.prompt_len + 1))
            if self.long_frac and self._rng.random() < self.long_frac:
                plen = self.long_prompt_len or self.prompt_len
            toks = self._rng.integers(0, self.vocab_size, plen, dtype=np.int32)
            req = Request(rid=self._next_id, arrival_slot=slot, tokens=toks,
                          max_new_tokens=self.max_new_tokens)
            if self.tenants:
                spec = self._draw_tenant()
                req.tenant = spec.name
                req.priority = spec.priority
                req.deadline_slots = spec.deadline_slots
            out.append(req)
            self._next_id += 1
        return out
