"""Deterministic, seedable fault injection behind the serving seams.

The engines' reliability claims (preempt-and-recompute purity, alloc
rollback atomicity, failure re-routing that never drops or double-serves)
become standing invariants: ``ChaosInjector`` threads faults behind the
existing seams and the differential harness then asserts equal surviving
streams, zero page leaks, and served-count conservation *under* injected
faults.

Seam catalog:

  replica failure    fleet.fail_replica at a seeded slot — mid-decode, and
                     mid-prefill when the victim has live chunk cursors
  alloc shortfall    a forwarding proxy around PageAllocator whose
                     alloc/extend return None at seeded (or chosen) calls
                     WITHOUT touching allocator state — the engine sees a
                     full pool and must defer/preempt cleanly
  readback delay     a readback packet's readiness held back: the engine's
  / hang             ``_readback_ready`` reads it not ready for the next k
                     polls (delay) or forever (hang: what the engine's
                     bounded-wait watchdog must catch as ``ReadbackTimeout``)
  eviction race      forced PrefixIndex eviction between slots, invalidating
                     prefix hits that routing/admission already probed

The port's readback packet is a set of pinned host tensors fenced by one
CUDA event (``Engine._post_readback``; on the CPU the event is None and the
copy is ready at once), not one array per counter as the reference's. So
a delay or hang wraps the packet's readiness, not its arrays: the injector
writes a poll budget into the packet (``polls``: k, or -1 for a hang) and
the engine's readiness check (``Engine._readback_ready``) spends it before
it asks the event. The
tokens a delayed packet carries are the ones it would have carried.

Every injected fault lands in ``log`` (slot-stamped) and ``counters()``;
injection draws from one ``np.random.default_rng(seed)`` in the
reference's order (one draw per readback packet and per allocator call
once armed, a failure draw and a victim draw per slot, one eviction draw
per engine per slot), and the per-slot draw counts are independent of the
wall clock. The port consumes every readback packet at a fixed point (after
the next slot's dispatch, ROADMAP R5), so a chaos run replays exactly from
its seed on every protocol, and for the same config and workload its log
is the reference's with that engine's early consume off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ChaosConfig:
    """Fault mix; all probabilities default 0 (armed-but-quiet injector)."""

    seed: int = 0
    start_slot: int = 0              # no faults before this slot
    # replica failure (fleets only; respects min_survivors)
    p_replica_fail: float = 0.0
    max_failures: int = 1
    min_survivors: int = 1
    # allocator shortfall (paged engines only)
    p_alloc_shortfall: float = 0.0
    shortfall_at: tuple = ()         # exact alloc-call indices to force, too
    # readback
    p_readback_delay: float = 0.0
    delay_polls: int = 3             # readiness stays False this many polls
    p_readback_hang: float = 0.0     # never ready => watchdog territory
    # prefix-cache eviction race
    p_evict_prefix: float = 0.0
    evict_pages: int = 2


class _ChaosAllocator:
    """Forwarding proxy over a PageAllocator: seeded alloc/extend calls
    return None before touching allocator state (the engine's shortfall
    path must behave exactly as if the pool were full)."""

    def __init__(self, inner, injector: "ChaosInjector"):
        self._inner = inner
        self._injector = injector

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def alloc(self, rid, tokens, shared=(), precision="native"):
        if self._injector._alloc_fault("alloc", rid):
            return None
        return self._inner.alloc(rid, tokens, shared=shared,
                                 precision=precision)

    def extend(self, rid, tokens):
        if self._injector._alloc_fault("extend", rid):
            return None
        return self._inner.extend(rid, tokens)


class ChaosInjector:
    """Arms engines/fleets with the ChaosConfig fault mix.

    ``arm(target)`` hooks an Engine/PagedEngine (readback + allocator
    seams) or a ReplicaFleet (every replica, plus the failure seam —
    ``before_slot`` then fires automatically from the fleet's step loop).
    Driving a bare engine requires calling ``before_slot(now)`` from the
    serve loop for slot-scoped faults.
    """

    def __init__(self, cfg: Optional[ChaosConfig] = None, **kw):
        self.cfg = cfg or ChaosConfig(**kw)
        self._rng = np.random.default_rng(self.cfg.seed)
        self.fleet = None
        self.engines: list = []
        self.log: list = []          # dicts: {slot, kind, ...}
        self._alloc_calls = 0
        self._now = 0
        self.failures_injected = 0
        self.shortfalls_injected = 0
        self.delays_injected = 0
        self.hangs_injected = 0
        self.evictions_injected = 0

    # -------------------------------------------------------------- arming
    def arm(self, target) -> "ChaosInjector":
        if hasattr(target, "replicas"):
            self.fleet = target
            target.chaos = self
            for eng in target.replicas:
                self._arm_engine(eng)
        else:
            self._arm_engine(target)
        return self

    def _arm_engine(self, eng) -> None:
        eng._chaos = self
        self.engines.append(eng)
        if hasattr(eng, "allocator") and not isinstance(
                eng.allocator, _ChaosAllocator):
            eng.allocator = _ChaosAllocator(eng.allocator, self)

    # --------------------------------------------------------------- seams
    def _active(self) -> bool:
        return self._now >= self.cfg.start_slot

    def _alloc_fault(self, op: str, rid) -> bool:
        idx = self._alloc_calls
        self._alloc_calls += 1
        forced = idx in self.cfg.shortfall_at
        if not forced:
            if not self._active() or self.cfg.p_alloc_shortfall <= 0:
                return False
            forced = self._rng.random() < self.cfg.p_alloc_shortfall
        if forced:
            self.shortfalls_injected += 1
            self.log.append({"slot": self._now, "kind": "alloc_shortfall",
                             "op": op, "rid": rid, "call": idx})
        return forced

    def wrap_readback(self, packet: dict) -> dict:
        """Called by the engine right after starting a readback copy: a
        drawn delay or hang sets the packet's poll budget (``polls``)."""
        if not self._active():
            return packet
        u = self._rng.random()
        if self.cfg.p_readback_hang > 0 and u < self.cfg.p_readback_hang:
            polls, kind = -1, "readback_hang"
            self.hangs_injected += 1
        elif (self.cfg.p_readback_delay > 0
                and u < self.cfg.p_readback_hang + self.cfg.p_readback_delay):
            polls, kind = self.cfg.delay_polls, "readback_delay"
            self.delays_injected += 1
        else:
            return packet
        packet["polls"] = polls
        self.log.append({"slot": packet.get("slot", self._now), "kind": kind})
        return packet

    def before_slot(self, now: int) -> None:
        """Slot-scoped faults: replica failure, forced prefix eviction."""
        self._now = now
        if not self._active():
            return
        cfg = self.cfg
        if (self.fleet is not None and cfg.p_replica_fail > 0
                and self.failures_injected < cfg.max_failures
                and self.fleet.n_healthy() > max(cfg.min_survivors, 1)
                and self._rng.random() < cfg.p_replica_fail):
            live = [i for i, a in enumerate(self.fleet.alive) if a]
            victim = int(self._rng.choice(live))
            mid_prefill = bool(getattr(
                self.fleet.replicas[victim], "_cursors", None))
            requeued = self.fleet.fail_replica(victim)
            self.failures_injected += 1
            self.log.append({"slot": now, "kind": "replica_fail",
                             "replica": victim, "requeued": len(requeued),
                             "mid_prefill": mid_prefill})
        if cfg.p_evict_prefix > 0:
            for i, eng in enumerate(self.engines):
                # draw once per engine per slot UNCONDITIONALLY — gating the
                # draw on index emptiness would let sync-free retirement
                # timing (opportunistic early consume, wall-clock dependent)
                # shift the whole downstream rng stream
                fire = self._rng.random() < cfg.p_evict_prefix
                prefix = getattr(eng, "_prefix", None)
                if not fire or prefix is None or not len(prefix):
                    continue
                evicted = prefix.evict(cfg.evict_pages)
                if evicted:
                    self.evictions_injected += 1
                    self.log.append({"slot": now, "kind": "evict_prefix",
                                     "engine": i, "pages": evicted})

    # ------------------------------------------------------------- exports
    def counters(self) -> dict:
        return {
            "chaos_replica_failures": self.failures_injected,
            "chaos_alloc_shortfalls": self.shortfalls_injected,
            "chaos_readback_delays": self.delays_injected,
            "chaos_readback_hangs": self.hangs_injected,
            "chaos_prefix_evictions": self.evictions_injected,
        }
