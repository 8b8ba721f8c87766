"""Requests and workload sources for the serving engine.

The paper's video source maps to a RequestSource producing work at a fixed
raw rate (frames/slot); the framework *samples* that stream at the
controller-chosen rate f(t) — sampled items enter the engine's bounded
queue, unsampled ones are the utility loss S(f) measures.

The draws are the reference package's, from ``np.random.default_rng(seed)``
in the same order, so both packages see the same workload.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    arrival_slot: int
    tokens: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    # per-request sampling knobs: the port serves greedy only, so this stays
    # None (the engine refuses anything else)
    sampling: Optional[object] = None
    # filled by the engine:
    admit_slot: Optional[int] = None
    start_slot: Optional[int] = None
    first_token_slot: Optional[int] = None  # first generated token emitted
    finish_slot: Optional[int] = None
    generated: Optional[list] = None
    truncated: bool = False       # prompt exceeded the engine's bucket


@dataclasses.dataclass
class RequestSource:
    """Produces ``raw_rate`` requests per slot (the camera's native fps).

    ``min_prompt_len`` < prompt_len yields ragged prompts (lengths uniform
    in [min_prompt_len, prompt_len]) — the workload the engine's
    length-aware bucketed prefill exists for. ``long_frac`` of arrivals
    carry a ``long_prompt_len`` prompt instead. The reference's multi-tenant
    mix (``tenants``) is not ported yet (ROADMAP.md queue 1 item 10).
    """

    vocab_size: int
    prompt_len: int
    raw_rate: int = 10
    max_new_tokens: int = 16
    seed: int = 0
    min_prompt_len: Optional[int] = None   # None => fixed prompt_len
    long_frac: float = 0.0
    long_prompt_len: Optional[int] = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._next_id = 0
        self.produced = 0

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
            out.append(Request(
                rid=self._next_id,
                arrival_slot=slot,
                tokens=toks,
                max_new_tokens=self.max_new_tokens,
            ))
            self._next_id += 1
        return out
