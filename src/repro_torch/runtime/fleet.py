"""Replica-fleet serving: N engines behind one Lyapunov control plane.

``ReplicaFleet`` owns a set of engine replicas (any mix of dense/paged,
each steppable through the fused, sync-free, or chunked protocol) and
presents the *single-engine surface* the rest of the port speaks:
``submit`` / ``queue_len`` / ``token_backlog`` / ``step_slot*`` / ``drain``
/ ``finished`` / dispatch counters / ``warm_decode``. ``serve``
(repro_torch.runtime.server), the ``PolicyScheduler`` and
``latency_stats`` drive a fleet exactly as they drive one engine: the
fleet is a drop-in engine whose capacity happens to be sharded.

Routing
-------
``submit`` routes each request through a ``FleetRouter``
(repro_torch.control.router): per-replica *drift loads* (request backlog,
``token_backlog()``, paged ``occupancy_hwm``) are collapsed into one
virtual queue per replica and the target is the Algorithm-1 argmax over the
replica set (join-the-shortest-drift). Routing is deterministic (ties break
to the lowest replica index) and each routed request is charged onto its
target's load snapshot before the next decision, so one burst spreads
across the fleet instead of dog-piling the momentarily-shortest queue.

Because greedy generation is a pure function of the prompt, a deterministic
router makes the fleet's *merged* streams those of a single engine serving
the same trace, whatever the replica count, up to the batch shape's
float noise (a replica admits other batches, so it may pick other prompt
buckets).

One card
--------
Replicas built by ``build`` from one factory share its ``Model``: the
weights sit on the card once, and each replica holds its own KV ring or
page pool. Each replica is its own engine with its own CUDA graphs (its
decodes and its admissions, one per prompt bucket: ``runtime/graph.py``);
``warm_decode`` warms and captures every live replica's, in the mode it
serves, before the first slot, as ``serve`` does for one engine. The
reference's compile sharing (equal-geometry replicas sharing one jitted
executable) has no counterpart: a CUDA graph holds its engine's own cache
addresses.

Failure and drain
-----------------
``fail_replica(i)`` marks a replica dead: its pending device readback is
dropped (its completions can never land, so nothing is double-served), its
graphs are never replayed again, its paged pages are freed back to that
replica's pool, and every request it had not finished (queued,
mid-chunked-prefill, or mid-decode) is reset (``generated``/``start_slot``
cleared, the engine's preemption protocol) and re-routed to the survivors,
where decoding reproduces the same tokens: greedy trivially, and sampled
requests because the sampling keys are request-keyed (seed, rid, token
index; ``runtime/sampling.py``), so a requeued request re-derives the same
draws on any replica, at any row. ``drain_replica(i)`` is the graceful
version: stop routing to the replica and move its *queued* work away while
its in-flight rows finish normally; ``resume_replica`` undoes it.
``drain()`` flushes every live replica's readback tail and is idempotent.

The reference's observability bundle (``obs``), its fault injector
(``chaos``) and ``export_metrics`` are not ported yet (ROADMAP.md queue 1
item 10): passing them raises.
"""
from __future__ import annotations

import numpy as np

from repro_torch.control.router import FleetRouter, ReplicaLoad
from repro_torch.runtime.engine import Engine

_ITEM10 = "ROADMAP.md queue 1 item 10 (observability and reliability)"

# counters() keys that are levels, not totals: fleet aggregation takes the
# max over live replicas (worst replica) instead of summing
_MAX_KEYS = frozenset({
    "occupancy", "occupancy_hwm", "committed_occupancy",
    "peak_active", "peak_pages",
})


class ReplicaFleet:
    """N engine replicas behind one router, presenting one engine surface.

    ``modes`` optionally fixes a per-replica serving protocol ("fused",
    "sync", "chunked"); when None, every replica steps with the protocol of
    the ``step_slot*`` method the caller invokes (what ``serve``'s
    ``sync_free``/``chunked`` flags select).
    """

    _STEP = {
        "fused": lambda eng, now, n: eng.step_slot(now, n_steps=n),
        "sync": lambda eng, now, n: eng.step_slot_sync(now, n_steps=n),
        "chunked": lambda eng, now, n: eng.step_slot_chunked(now, n_steps=n),
    }

    def __init__(self, replicas: list, router: FleetRouter | None = None,
                 modes: list | None = None, obs=None, chaos=None):
        if obs is not None or chaos is not None:
            raise NotImplementedError(f"the fleet's observability and fault injection are "
                                      f"not ported yet; see {_ITEM10}")
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if modes is not None and len(modes) != len(replicas):
            raise ValueError("modes must match the replica count")
        if modes is not None:
            for m in modes:
                if m not in self._STEP:
                    raise ValueError(f"unknown serving mode {m!r}")
        self.replicas = list(replicas)
        self.router = router or FleetRouter()
        self.modes = list(modes) if modes is not None else None
        self.device = self.replicas[0].device   # where the scheduler runs Algorithm 1
        n = len(self.replicas)
        self.alive = [True] * n       # failed replicas are never stepped again
        self.routable = [True] * n    # draining replicas step but get no work
        # static routing preference: capacity share (row count), so bigger
        # replicas win ties when the fleet is idle
        rows = np.asarray([len(e.active) for e in self.replicas], np.float32)
        self._prefs = rows / rows.max()
        self.served_history: list = []
        self.steps = 0
        self.requeues = 0             # requests re-routed by failure/drain
        self.failures = 0
        # the paged control signals exist only when every replica reports
        # them (serve() duck-types on hasattr(engine, "occupancy"))
        if all(hasattr(e, "occupancy") for e in self.replicas):
            self.occupancy = self._occupancy

    # ------------------------------------------------------------ builders
    @classmethod
    def build(cls, make_engine, n: int, router: FleetRouter | None = None,
              modes: list | None = None, obs=None, chaos=None) -> "ReplicaFleet":
        """Fleet of ``n`` replicas from a zero-arg engine factory (one
        ``Model`` closed over by the factory: the weights are shared)."""
        if obs is not None or chaos is not None:
            raise NotImplementedError(f"the fleet's observability and fault injection are "
                                      f"not ported yet; see {_ITEM10}")
        return cls([make_engine() for _ in range(n)], router=router, modes=modes)

    # ------------------------------------------------------- observations
    def queue_len(self) -> int:
        return sum(e.queue_len() for e in self.replicas)

    def token_backlog(self) -> int:
        return sum(e.token_backlog() for e in self.replicas)

    def _occupancy(self) -> float:
        """Worst replica's pool fill: the constraint the MemoryAware policy
        must price is the replica closest to allocation failure."""
        return max(e.occupancy() for i, e in enumerate(self.replicas) if self.alive[i])

    @property
    def occupancy_hwm(self) -> float:
        return max((getattr(e, "occupancy_hwm", 0.0)
                    for i, e in enumerate(self.replicas) if self.alive[i]), default=0.0)

    def _total(self, name: str) -> int:
        return sum(getattr(e, name) for e in self.replicas)

    @property
    def prefill_dispatches(self) -> int:
        return self._total("prefill_dispatches")

    @property
    def decode_dispatches(self) -> int:
        return self._total("decode_dispatches")

    @property
    def blocking_syncs(self) -> int:
        return self._total("blocking_syncs")

    @property
    def readback_waits(self) -> int:
        return self._total("readback_waits")

    @property
    def warmup_dispatches(self) -> int:
        return self._total("warmup_dispatches")

    @property
    def prefill_warmups(self) -> int:
        return self._total("prefill_warmups")

    @property
    def graph_replays(self) -> int:
        return self._total("graph_replays")

    @property
    def prefill_replays(self) -> int:
        return self._total("prefill_replays")

    @property
    def finished(self) -> list:
        return [r for e in self.replicas for r in e.finished]

    @property
    def active(self) -> list:
        return [r for e in self.replicas for r in e.active]

    @property
    def pending(self) -> list:
        return [r for e in self.replicas for r in e.pending]

    def n_healthy(self) -> int:
        return sum(self.alive)

    def served_total(self) -> int:
        """Fleet-wide served count (the aggregate mu the control plane
        observes): every retired request across all replicas."""
        return sum(len(e.finished) for e in self.replicas)

    def latency_stats(self) -> dict:
        """Fleet-wide wait/total latency percentiles (merged finishers)."""
        from repro_torch.runtime.server import latency_stats

        return latency_stats(self)

    # ------------------------------------------------------------- metrics
    def counters(self) -> dict:
        """Label-wise aggregation of every replica's ``counters()``: levels
        (``_MAX_KEYS``) fold by max over live replicas, totals sum over all
        (a dead replica's work still happened), plus fleet-only keys."""
        per = [e.counters() for e in self.replicas]
        out: dict = {}
        for key in per[0]:
            if key in _MAX_KEYS:
                vals = [c[key] for c, a in zip(per, self.alive, strict=True) if a]
                out[key] = max(vals) if vals else 0
            else:
                out[key] = sum(c[key] for c in per)
        out["replicas"] = len(self.replicas)
        out["replicas_alive"] = self.n_healthy()
        out["requeues"] = self.requeues
        out["failures"] = self.failures
        out["routed_total"] = len(self.router.routed)
        return out

    def export_metrics(self, labels: dict | None = None) -> None:
        raise NotImplementedError(f"metrics export is not ported yet; see {_ITEM10}")

    # ------------------------------------------------------------ routing
    def _load_of(self, eng: Engine) -> ReplicaLoad:
        return ReplicaLoad(
            backlog=float(eng.queue_len() + sum(r is not None for r in eng.active)),
            token_backlog=float(eng.token_backlog()),
            occupancy=float(getattr(eng, "occupancy_hwm", 0.0)),
        )

    def submit(self, reqs: list) -> None:
        """Route each request to a replica (join-the-shortest-drift).

        When every live replica is draining, routing falls back to the
        full live set: a draining replica absorbing new work beats losing
        requests; submitted work is never dropped (failure re-routing
        depends on it).
        """
        if not reqs:
            return
        mask = [a and r for a, r in zip(self.alive, self.routable, strict=True)]
        if not any(mask):
            mask = list(self.alive)
        loads = np.asarray([self.router.drift_load(self._load_of(e)) for e in self.replicas],
                           np.float32)
        # prefix affinity: per-replica resident-prefix coverage of each
        # prompt (0 everywhere when no replica runs a prefix cache: the
        # router then reduces to plain join-the-shortest-drift)
        probes = [getattr(e, "prefix_hit_tokens", None) for e in self.replicas]
        for req in reqs:
            aff = None
            if any(p is not None for p in probes):
                aff = np.asarray([p(req.tokens) if p is not None else 0 for p in probes],
                                 np.float32)
            i = self.router.route(loads, mask, self._prefs, affinity=aff, rid=req.rid)
            hit = int(aff[i]) if aff is not None else 0
            self.router.charge(loads, i, len(req.tokens), hit_tokens=hit)
            self.replicas[i].submit([req])

    # ------------------------------------------------------------ serving
    def _mode(self, i: int, default_mode: str) -> str:
        return self.modes[i] if self.modes is not None else default_mode

    def warm_decode(self, n_steps: int, sync: bool = False, chunked: bool = False) -> None:
        """Warm up and capture every live replica's dispatches before the
        first slot (``Engine.warm_decode``), each in the mode it serves:
        its own, or the one ``sync``/``chunked`` select."""
        default = "chunked" if chunked else "sync" if sync else "fused"
        for i, eng in enumerate(self.replicas):
            if self.alive[i]:
                mode = self._mode(i, default)
                eng.warm_decode(n_steps, sync=mode == "sync", chunked=mode == "chunked")

    def _step(self, default_mode: str, now: int, n_steps: int) -> dict:
        served = active = admitted = 0
        per_step = [0] * n_steps
        for i, eng in enumerate(self.replicas):
            if not self.alive[i]:
                continue
            m = self._STEP[self._mode(i, default_mode)](eng, now, n_steps)
            served += m["served"]
            active += m["active"]
            admitted += m.get("admitted", 0)
            for j, s in enumerate(m.get("served_per_step", [])):
                per_step[min(j, n_steps - 1)] += s
        self.served_history.append(served)
        self.steps += n_steps
        return {
            "active": active,
            "queue": self.queue_len(),
            "served": served,
            "served_per_step": per_step,
            "admitted": admitted,
            "finished_total": self.served_total(),
            "replicas": self.n_healthy(),
            "blocking_syncs": self.blocking_syncs,
        }

    def step_slot(self, now: int, n_steps: int = 1) -> dict:
        return self._step("fused", now, n_steps)

    def step_slot_sync(self, now: int, n_steps: int = 1) -> dict:
        return self._step("sync", now, n_steps)

    def step_slot_chunked(self, now: int, n_steps: int = 1) -> dict:
        return self._step("chunked", now, n_steps)

    def drain(self) -> dict:
        """Flush every live replica's readback tail (idempotent)."""
        served = 0
        for i, eng in enumerate(self.replicas):
            if self.alive[i]:
                served += eng.drain()["served"]
        return {"served": served}

    # ---------------------------------------------------- failure / drain
    def _strip_unfinished(self, i: int) -> list:
        """Pull every unfinished request off replica ``i``, resetting each
        to its pre-admission state (the engine's preemption protocol), and
        release the rows they held. Returns them in admission order."""
        eng = self.replicas[i]
        requeued = []
        # in-flight readbacks reference rows about to be recycled; the
        # packet is dropped, so those completions can never double-land
        eng._pending_read = None
        eng._cursors.clear()
        for row, req in enumerate(eng.active):
            if req is None:
                continue
            eng.active[row] = None
            eng.slot_age[row] = 0
            eng._release_row(row)     # paged: pages back to the pool
            req.generated = None
            req.admit_slot = None
            req.start_slot = None
            req.first_token_slot = None
            requeued.append(req)
        requeued.extend(eng.pending)
        eng.pending.clear()
        return requeued

    def fail_replica(self, i: int) -> list:
        """Replica death: drop its device state, free its resources, and
        re-route all its unfinished work to the survivors. Returns the
        requeued requests. Requests it already finished stay finished:
        nothing is ever served twice."""
        if not self.alive[i]:
            return []
        if self.n_healthy() <= 1:
            raise RuntimeError("cannot fail the last healthy replica")
        self.alive[i] = False
        self.routable[i] = False
        self.failures += 1
        requeued = self._strip_unfinished(i)
        self.requeues += len(requeued)
        self.submit(requeued)
        return requeued

    def drain_replica(self, i: int) -> dict:
        """Graceful drain: stop routing to replica ``i``, move its queued
        (not-yet-admitted) work to the rest of the fleet, and flush its
        readback tail. In-flight rows keep decoding in subsequent slots."""
        if not self.alive[i]:
            raise RuntimeError(f"replica {i} is dead")
        self.routable[i] = False
        eng = self.replicas[i]
        moved = list(eng.pending)
        eng.pending.clear()
        self.requeues += len(moved)
        self.submit(moved)
        served = eng.drain()["served"]
        if served:
            self.served_history.append(served)
        return {"moved": len(moved), "served": served}

    def resume_replica(self, i: int) -> None:
        """Put a drained (not failed) replica back in the routing set."""
        if not self.alive[i]:
            raise RuntimeError(f"replica {i} is dead; build a new fleet")
        self.routable[i] = True
