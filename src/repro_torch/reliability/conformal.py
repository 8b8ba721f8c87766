"""Split-conformal quantile calibration over sliding sample windows.

The SLO the reliability layer enforces is distributional — "tenant A's
first token arrives within D slots for 99% of requests" — but Lyapunov
drift arguments want a *deterministic* per-slot quantity to queue on.
Conformal prediction bridges the two (Binucci et al., 2025): from the last
``window`` observed TTFT samples, the split-conformal quantile

    qhat_q = x_(k),   k = ceil((n + 1) * q)

(the k-th order statistic with the finite-sample +1 correction) upper
bounds the next sample's TTFT with probability >= q, distribution-free.
The constraint "P(TTFT <= D) >= q" then becomes the deterministic
"qhat_q <= D", which ``ConformalSLO`` prices through the standard virtual
queue  Z <- max(Z + (qhat_q - D), 0)  (see repro_torch.reliability.slo).

Everything here is plain numpy on the host — calibration sits on the
control path (one sort of a <=window buffer per slot), never the data path.
"""
from __future__ import annotations

import math

import numpy as np


class ConformalQuantile:
    """Sliding-window split-conformal quantile estimator.

    Keeps the most recent ``window`` samples in a ring buffer.
    ``quantile(q)`` returns the conformal upper bound x_(ceil((n+1)q)); when
    ceil((n+1)q) > n the exact bound is +inf — we clamp to the window max
    (callers get under-coverage until n >= q/(1-q) samples; ``ready(q)``
    reports when the correction is exact).
    """

    def __init__(self, window: int = 256):
        if window <= 0:
            raise ValueError("window must be positive")
        self.window = window
        self._buf = np.zeros(window, np.float64)
        self._n = 0          # live samples (<= window)
        self._i = 0          # next write index
        self.total = 0       # samples ever pushed

    def push(self, x: float) -> None:
        self._buf[self._i] = float(x)
        self._i = (self._i + 1) % self.window
        self._n = min(self._n + 1, self.window)
        self.total += 1

    def __len__(self) -> int:
        return self._n

    def ready(self, q: float) -> bool:
        """True when the window holds enough samples for the finite-sample
        correction to be exact (ceil((n+1)q) <= n)."""
        return math.ceil((self._n + 1) * q) <= self._n

    def quantile(self, q: float) -> float:
        """Split-conformal q-quantile of the window (0.0 when empty)."""
        if not 0.0 < q < 1.0:
            raise ValueError("q must be in (0, 1)")
        n = self._n
        if n == 0:
            return 0.0
        vals = np.sort(self._buf[:n])
        k = math.ceil((n + 1) * q)
        return float(vals[min(k, n) - 1])

    def samples(self) -> np.ndarray:
        return np.array(self._buf[:self._n])
