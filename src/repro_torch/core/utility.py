"""Utility models S(f) for the controller's penalty term.

The paper defines FID performance S(f(t)) = alpha(f(t)) / beta(t): the
fraction of faces appearing in the raw feed that the system identifies at
sampling rate f. Its own evaluation then assumes S is maximized by maximizing
the processed-frame rate, i.e. S proportional to f. The paper-faithful
utility plus the concave alternatives of the reference package:

  * linear:     S(f) = f / f_max
  * detection:  S(f) = 1 - (1 - p)**f, normalized
  * log:        S(f) = log(1 + a f) / log(1 + a f_max)

All are normalized to S(f_max) = 1 and vectorized over f (float32).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Utility:
    kind: str = "linear"
    f_max: float = 10.0
    p_detect: float = 0.35   # per-sample detection probability ("detection")
    a: float = 1.0           # curvature ("log")

    def __call__(self, f) -> torch.Tensor:
        f = torch.as_tensor(f, dtype=torch.float32)
        if self.kind == "linear":
            return f / self.f_max
        if self.kind == "detection":
            top = 1.0 - (1.0 - self.p_detect) ** f
            bot = 1.0 - (1.0 - self.p_detect) ** self.f_max
            return top / bot
        if self.kind == "log":
            return torch.log1p(self.a * f) / torch.log1p(
                torch.tensor(self.a * self.f_max, dtype=torch.float32))
        raise ValueError(f"unknown utility kind: {self.kind}")


def paper_utility(f_max: float = 10.0) -> Utility:
    """The utility the paper's own simulation optimizes (S ∝ processed rate)."""
    return Utility(kind="linear", f_max=f_max)
