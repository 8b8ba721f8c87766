"""Control-plane introspection: per-decision Lyapunov explanations.

Every Algorithm-1 argmax the system takes (the scheduler's per-slot rate
decision over the policy tables, and the fleet router's per-request
replica pick) can be recorded here with its inputs: backlog Q(t),
virtual-queue value Z(t), V, and the per-action drift / V*penalty
decomposition

    T(f) = V * S(f)  -  Q(t) * lambda(f)  -  Z(t) * cost(f)
           `--penalty--'  `------------drift------------'

so a recorded run answers "why did the controller pick f=3 at slot 117"
without rerunning anything, and the (t, backlog, rate) series regenerates
Fig.-2-style backlog/rate plots from real serving runs.

The port's arithmetic, not the reference's. The port's dispatch
(``control/policy.py::drift_plus_penalty_action``) keeps every product
exact in float64 and rounds once per subtraction to float32, as the
reference's jitted dispatch does through XLA's fused multiply-adds
(ROADMAP R4); the reference's host recompute rounds V*S to float32 before
it subtracts, so at an R4 near-tie its argmax would part from the rate the
port dispatched. ``explain_tables`` here evaluates the port's rule: its
``T`` and ``argmax`` are the dispatch's, bit for bit, while the recorded
``penalty`` and ``drift`` are the exact float64 terms of the decomposition.

``replay_rollout`` closes the loop with the trace simulator: it re-executes
``repro_torch.control.rollout.rollout`` slot by slot in numpy on the host
(the same float32 queue arithmetic, the same first-maximizer tie-break),
recording every decision; its backlog/rate series equal the rollout's bit
for bit.

The module is host-side numpy: recording never touches the card.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Optional

import numpy as np


class DecisionLog:
    """Bounded log of rate (scheduler) and route (router) decisions."""

    enabled = True

    def __init__(self, capacity: int = 8192):
        self.rates: deque = deque(maxlen=capacity)
        self.routes: deque = deque(maxlen=capacity)
        self.sheds: deque = deque(maxlen=capacity)
        self.precisions: deque = deque(maxlen=capacity)

    # ---------------------------------------------------------- recording
    def record_rate(self, *, t: int, backlog: float, vq: float, V: float,
                    chosen: float, rates=(), drift=(), penalty=(),
                    argmax: Optional[float] = None,
                    lagged: bool = False) -> None:
        """One scheduler decision. ``rates``/``drift``/``penalty`` are the
        per-action decomposition (empty for non-table policies); ``lagged``
        marks the sync-free pipeline where the applied rate is the previous
        slot's decision (``chosen`` may then differ from ``argmax``)."""
        self.rates.append({
            "t": int(t), "backlog": float(backlog), "vq": float(vq),
            "V": float(V), "chosen": float(chosen),
            "rates": tuple(float(x) for x in rates),
            "drift": tuple(float(x) for x in drift),
            "penalty": tuple(float(x) for x in penalty),
            "argmax": None if argmax is None else float(argmax),
            "lagged": bool(lagged),
        })

    def record_route(self, *, rid, chosen: int, scores=None, loads=None,
                     prefs=None, affinity=None, V: float = 0.0,
                     kind: str = "drift",
                     tenant: Optional[str] = None) -> None:
        """One router decision with its per-replica score vector
        (V*S_i - D_i; None for round-robin, which never scores);
        ``tenant`` tags multi-tenant workloads so routes join to sheds."""
        as_tuple = (lambda x: None if x is None
                    else tuple(float(v) for v in np.asarray(x).ravel()))
        self.routes.append({
            "rid": rid, "chosen": int(chosen), "kind": kind, "V": float(V),
            "scores": as_tuple(scores), "loads": as_tuple(loads),
            "prefs": as_tuple(prefs), "affinity": as_tuple(affinity),
            "tenant": tenant,
        })

    def record_shed(self, *, t: int, rid, tenant: str = "default",
                    priority: int = 0, reason: str = "", level: int = 0,
                    waited: Optional[int] = None) -> None:
        """One degradation-ladder shed/drop: ``reason`` is
        the ladder rung ("expired" / "priority" / "capped"), ``level`` the
        overload level that armed it, ``waited`` the slots the request had
        already queued. Every shed the scheduler takes is recorded here —
        degradation is never silent."""
        self.sheds.append({
            "t": int(t), "rid": rid, "tenant": str(tenant),
            "priority": int(priority), "reason": str(reason),
            "level": int(level),
            "waited": None if waited is None else int(waited),
        })

    def record_precision(self, *, t: int, occupancy: float, vq: float,
                         prev: str, chosen: str) -> None:
        """One admission-precision latch flip: the
        PrecisionAware hysteresis moved new admissions between page regions
        (``prev`` -> ``chosen``, e.g. "native" -> "int8") at the recorded
        occupancy. Every downgrade onto lossy pages lands here before the
        engine applies it — quantizing a request's KV is never silent."""
        self.precisions.append({
            "t": int(t), "occupancy": float(occupancy), "vq": float(vq),
            "prev": str(prev), "chosen": str(chosen),
            "downgrade": chosen != "native",
        })

    # ------------------------------------------------------------- views
    def rate_series(self) -> dict:
        """{'t', 'backlog', 'rate', 'vq'} arrays — the Fig.-2 axes."""
        recs = list(self.rates)
        return {
            "t": np.asarray([r["t"] for r in recs], np.int64),
            "backlog": np.asarray([r["backlog"] for r in recs], np.float32),
            "rate": np.asarray([r["chosen"] for r in recs], np.float32),
            "vq": np.asarray([r["vq"] for r in recs], np.float32),
        }

    def route_counts(self, n_replicas: Optional[int] = None) -> np.ndarray:
        """Per-replica routed-request tally (the fleet balance picture)."""
        chosen = [r["chosen"] for r in self.routes]
        n = n_replicas if n_replicas is not None else (max(chosen) + 1
                                                       if chosen else 0)
        out = np.zeros(n, np.int64)
        for c in chosen:
            if c < n:
                out[c] += 1
        return out

    def explain_rate(self, i: int = -1) -> str:
        """Human-readable decomposition of one recorded rate decision."""
        r = list(self.rates)[i]
        lines = [f"slot {r['t']}: Q={r['backlog']:g} Z={r['vq']:g} "
                 f"V={r['V']:g} -> f*={r['chosen']:g}"
                 + (" (lagged)" if r["lagged"] else "")]
        for f, d, p in zip(r["rates"], r["drift"], r["penalty"], strict=True):
            star = " <-- chosen" if (r["argmax"] is not None
                                     and f == r["argmax"]) else ""
            lines.append(f"  f={f:6g}  V*S={p:10.3f}  drift={d:10.3f}  "
                         f"T={p + d:10.3f}{star}")
        return "\n".join(lines)

    # ----------------------------------------------------------- exports
    def to_json(self) -> dict:
        return {"rates": list(self.rates), "routes": list(self.routes),
                "sheds": list(self.sheds),
                "precisions": list(self.precisions)}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path

    @classmethod
    def load(cls, path: str) -> "DecisionLog":
        with open(path) as f:
            data = json.load(f)
        log = cls()
        log.rates.extend(data.get("rates", []))
        log.routes.extend(data.get("routes", []))
        log.sheds.extend(data.get("sheds", []))
        log.precisions.extend(data.get("precisions", []))
        return log


class NullDecisionLog(DecisionLog):
    """Disabled log: recording is a no-op behind one ``enabled`` branch."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def record_rate(self, **kw) -> None:  # noqa: ARG002
        return None

    def record_route(self, **kw) -> None:  # noqa: ARG002
        return None

    def record_shed(self, **kw) -> None:  # noqa: ARG002
        return None

    def record_precision(self, **kw) -> None:  # noqa: ARG002
        return None


NULL_DECISIONS = NullDecisionLog()


def explain_tables(backlog: float, f_tab, s_tab, lam_tab, V: float,
                   vq: float = 0.0, cost_tab=None) -> dict:
    """Host recompute of one table-policy decision under the port's rule
    (``drift_plus_penalty_action``): Q, V and Z enter as float32, every
    product is exact in float64, and T rounds to float32 once per
    subtraction, first V*S - Q*lambda, then minus Z*cost. ``T`` and
    ``argmax`` (the first maximizer, the lowest rate on ties) are the
    dispatch's; ``penalty`` (V*S) and ``drift`` (-Q*lambda - Z*cost) are the
    exact float64 terms."""
    f = np.asarray(f_tab, np.float32)
    s = np.asarray(s_tab, np.float32).astype(np.float64)
    lam = np.asarray(lam_tab, np.float32).astype(np.float64)
    penalty = np.float64(np.float32(V)) * s
    qterm = np.float64(np.float32(backlog)) * lam
    T = (penalty - qterm).astype(np.float32)
    drift = -qterm
    if cost_tab is not None:
        extra = np.float64(np.float32(vq)) * np.asarray(cost_tab, np.float32).astype(np.float64)
        T = (T.astype(np.float64) - extra).astype(np.float32)
        drift = drift - extra
    idx = int(np.argmax(T))   # first maximizer, as torch.argmax
    return {"rates": f, "penalty": penalty, "drift": drift, "T": T,
            "argmax": float(f[idx]), "T_star": float(T[idx])}


def policy_tables(policy) -> tuple:
    """A policy's (F, S(F), lambda(F)) as float32 numpy arrays (on the host,
    wherever the policy's tables live)."""
    return tuple(np.asarray(t.cpu() if hasattr(t, "cpu") else t, np.float32)
                 for t in policy.tables())


def replay_rollout(policy, mus, capacity: float = np.inf,
                   log: Optional[DecisionLog] = None) -> dict:
    """Host replay of ``repro_torch.control.rollout.rollout`` that records
    every decision; the returned backlog/rate(/vq) series equal the
    rollout's bit for bit (float32 queue arithmetic, the port's
    decision rule, the same tie-break).

    Supports the table-policy family (Static / DriftPlusPenalty /
    LatencyAware / MemoryAware / TokenBacklogAware). Observation-driven
    policies (MemoryAware/TokenBacklogAware) keep Z at its init value here,
    as ``rollout`` does: their virtual queues advance only on engine
    observations, which a trace replay has none of.
    """
    if log is None:
        log = DecisionLog(capacity=len(np.asarray(mus)) + 1)
    mus = np.asarray(mus, np.float32)
    f_tab, s_tab, lam_tab = policy_tables(policy)
    V = np.float32(getattr(policy, "V", 0.0))
    # the per-action virtual-queue price, the policy's own attribute (the
    # scheduler reads the same one)
    cost = np.float32(getattr(policy, "vq_cost_per_rate", 0.0))
    cost_tab = cost * f_tab
    gain = np.float32(getattr(policy, "arrival_gain", 1.0))
    static_rate = getattr(policy, "rate", None)

    carry = policy.init()
    z = np.float32(float(getattr(carry, "value", 0.0)))
    budget = np.float32(float(getattr(carry, "budget", 0.0)))
    Q = np.float32(0.0)
    backlog, rate, vqs = [], [], []
    for t, mu in enumerate(mus):
        if static_rate is not None:
            f_star = np.float32(static_rate)
            ex = {"rates": f_tab, "penalty": np.float64(V) * s_tab,
                  "drift": -(np.float64(Q) * lam_tab), "argmax": float(f_star)}
        else:
            ex = explain_tables(Q, f_tab, s_tab, lam_tab, float(V),
                                vq=float(z), cost_tab=cost_tab)
            f_star = np.float32(ex["argmax"])
        # a self-driven virtual queue (LatencyAware) advances on the chosen
        # action's cost inside the rollout; an observation-driven one moves
        # only on engine signals, absent here
        if cost and getattr(policy, "observation", None) is None:
            z = np.maximum(z + cost * f_star - budget, np.float32(0.0))
        lam = gain * f_star
        after = np.maximum(Q - np.float32(mu), np.float32(0.0))
        room = np.maximum(np.float32(capacity) - after, np.float32(0.0))
        Q = after + np.minimum(lam, room)
        backlog.append(Q)
        rate.append(f_star)
        vqs.append(z)
        log.record_rate(t=t, backlog=float(Q), vq=float(z), V=float(V),
                        chosen=float(f_star), rates=ex["rates"],
                        drift=ex["drift"], penalty=ex["penalty"],
                        argmax=float(ex["argmax"]))
    return {"backlog": np.asarray(backlog, np.float32),
            "rate": np.asarray(rate, np.float32),
            "vq": np.asarray(vqs, np.float32), "log": log}
