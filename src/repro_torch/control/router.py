"""Join-the-shortest-drift routing over a fleet of engine replicas.

One control plane, many queues. The paper's Algorithm 1 stabilizes a single
queue by choosing a sampling rate; a replica fleet adds a second per-request
decision: *which* queue the admitted request joins. Both decisions are
priced through the one ``drift_plus_penalty_action`` in
``repro_torch.control.policy``:

  * the per-slot sampling rate stays with ``PolicyScheduler`` (the fleet
    aggregates its observations: total backlog, total token backlog,
    worst-replica occupancy),
  * the route target is the argmax of the same functional over the replica
    set:  i* = argmax_i { V * S_i - 1 * D_i(t) },
    where S_i is a static per-replica preference (capacity share, so bigger
    replicas win when the fleet is idle) and D_i(t) is the replica's
    *drift load*, the composite virtual queue the router keeps from the
    engine signals:

        D_i = (queued + active requests)
            + token_price * token_backlog_i        (pending prompt tokens)
            + occupancy_price * occupancy_hwm_i    (paged page-pool pressure)

    Joining the queue whose composite backlog is smallest is the
    drift-greedy choice: each admission adds its load where the quadratic
    Lyapunov drift sum_i D_i^2 grows least (join-the-shortest-queue is the
    V=0 special case).

Routing is deterministic: ``drift_plus_penalty_action`` breaks ties toward
the lowest replica index, so a fleet driven by a fixed trace is exactly
reproducible. The decision runs on the host's CPU tensors: it is host
bookkeeping between dispatches, and an argmax on the card would read its
answer back once per request.

``round-robin`` and ``least-loaded`` are the classical baselines;
``least-loaded`` is routed through the same argmax with V=0 and the raw
request count as the load, ``round-robin`` never looks at load at all.

With a decision log (``decisions``, a ``repro_torch.obs.DecisionLog``)
every route is recorded with the per-replica scores the argmax saw,
T_i = V * S_i - D_i (none for round-robin, which never scores), and the
request's tenant, so a post-mortem joins routes to sheds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.control.policy import drift_plus_penalty_action

ROUTER_KINDS = ("drift", "round-robin", "least-loaded")


def _route_action(loads: np.ndarray, prefs: np.ndarray, V: float) -> int:
    """One route decision, Algorithm 1 over the replicas: the action set is
    the replica indices, S(i) = prefs[i], lambda(i) = loads[i] (float32),
    Q = 1; the first maximizer wins ties."""
    rates = torch.arange(len(loads), dtype=torch.float32)
    idx, _ = drift_plus_penalty_action(1.0, rates, torch.from_numpy(prefs),
                                       torch.from_numpy(loads), np.float32(V))
    return int(idx)


@dataclasses.dataclass
class ReplicaLoad:
    """One replica's routing observation (host-side snapshot)."""

    backlog: float = 0.0         # queued + active requests
    token_backlog: float = 0.0   # pending prompt tokens (chunked tails incl.)
    occupancy: float = 0.0       # paged pool high-water fill (0 for dense)


@dataclasses.dataclass
class FleetRouter:
    """Deterministic replica selection for ``ReplicaFleet.submit``.

    ``route`` picks one replica for one request given per-replica loads; the
    fleet calls it request by request, charging each routed request onto its
    target's load snapshot (``charge``) so a burst spreads instead of
    piling onto the momentarily-shortest queue.
    """

    kind: str = "drift"
    V: float = 1.0                 # preference weight (drift routing only)
    token_price: float = 1.0 / 32.0  # drift load per pending prompt token
    occupancy_price: float = 8.0   # drift load per unit of pool occupancy
    request_cost: float = 1.0      # drift load one routed request adds
    # prefix affinity (drift routing only): a replica already holding m of
    # the request's prompt tokens in its prefix cache serves it m tokens
    # cheaper; the discount enters the same argmax as a load reduction
    affinity_price: float = 1.0 / 32.0
    # an optional DecisionLog: records every route with its score vector
    decisions: Optional[object] = None

    def __post_init__(self):
        if self.kind not in ROUTER_KINDS:
            raise ValueError(f"router kind {self.kind!r} not in {ROUTER_KINDS}")
        self._rr = 0
        self.routed: list[int] = []  # every route, in order

    # ------------------------------------------------------------- loads
    def drift_load(self, load: ReplicaLoad) -> float:
        """Collapse a replica's virtual queues into one drift price.

        ``least-loaded`` reads the raw request count only (the classical
        baseline); ``drift`` adds the token and occupancy virtual queues.
        """
        if self.kind == "least-loaded":
            return load.backlog
        return (load.backlog
                + self.token_price * load.token_backlog
                + self.occupancy_price * load.occupancy)

    def charge(self, loads: np.ndarray, i: int, prompt_tokens: int,
               hit_tokens: int = 0) -> None:
        """Account a just-routed request on its target's load snapshot.

        ``hit_tokens`` (the routed replica's prefix-cache coverage of this
        prompt) discounts the token charge: cached tokens are never
        re-prefilled, so they add no real load to the queue."""
        loads[i] += self.request_cost
        if self.kind == "drift":
            loads[i] += self.token_price * max(prompt_tokens - hit_tokens, 0)

    # ------------------------------------------------------------- route
    def route(self, loads: np.ndarray, routable: Sequence[bool], prefs: np.ndarray,
              affinity: Optional[np.ndarray] = None, rid=None, tenant=None) -> int:
        """Pick the target replica for one request.

        ``loads`` are drift loads (``drift_load`` per replica, updated by
        ``charge`` as a batch routes), ``routable`` masks failed/draining
        replicas, ``prefs`` are static capacity shares in [0, 1].
        ``affinity`` (optional, drift routing only) is the per-replica
        prefix-cache hit in prompt tokens; it enters the argmax as a load
        discount: i* = argmax_i { V*S_i - (D_i - affinity_price*hit_i) }.
        ``rid``/``tenant`` name the request in the decision log; they
        never affect the decision.
        """
        routable = np.asarray(routable, bool)
        if not routable.any():
            raise RuntimeError("no routable replica in the fleet")
        if self.kind == "round-robin":
            n = len(routable)
            for _ in range(n):
                i = self._rr % n
                self._rr += 1
                if routable[i]:
                    self.routed.append(i)
                    if self.decisions is not None and self.decisions.enabled:
                        self.decisions.record_route(rid=rid, chosen=i, kind=self.kind,
                                                    tenant=tenant)
                    return i
        # drift / least-loaded: the route target is an Algorithm-1 argmax
        # over the replica set with unroutable replicas priced out
        loads = np.asarray(loads, np.float32)
        if affinity is not None and self.kind == "drift":
            loads = loads - self.affinity_price * np.asarray(affinity, np.float32)
        q = np.where(routable, loads, np.float32(1e30)).astype(np.float32)
        if self.kind == "least-loaded":
            v, s = 0.0, np.zeros(len(q), np.float32)
        else:
            v, s = self.V, np.asarray(prefs, np.float32)
        i = _route_action(q, s, v)
        self.routed.append(i)
        if self.decisions is not None and self.decisions.enabled:
            # the per-replica scores the argmax saw: T_i = V * S_i - D_i
            self.decisions.record_route(rid=rid, chosen=i, kind=self.kind, V=float(v),
                                        scores=np.float32(v) * s - q, loads=loads, prefs=s,
                                        affinity=affinity, tenant=tenant)
        return i
