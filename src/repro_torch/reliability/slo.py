"""Per-tenant SLO enforcement: conformal virtual queues + graceful degradation.

Two pieces:

``ConformalSLO`` — a policy in the Algorithm-1 table family that prices the
distributional constraint "tenant a: first token within D_a slots for q_a of
requests" through the single ``drift_plus_penalty_action``. Each control
slot it recalibrates a split-conformal TTFT quantile qhat_a from the
observed samples (repro_torch.reliability.conformal) and advances one virtual
queue per tenant on the *deterministic* margin the calibration produces:

    Z_a(t+1) = max(Z_a(t) + (qhat_a(t) - D_a) / D_a, 0)

Z_a grows while the calibrated q_a-quantile sits above the deadline and
drains once it is back under; the aggregate price sum_a w_a * Z_a enters
the argmax as  Z * slo_gain * f  through ``vq_cost_per_rate``, exactly how
MemoryAware prices pool occupancy: ``act`` is MemoryAware's, one call of
``drift_plus_penalty_action`` on the scheduler's device. The calibration
itself is host numpy on the control path; only the aggregate price, made
on the device with ``torch.full`` (no host copy), reaches the argmax, and
it enters as float32, as the reference's jitted dispatch receives it.

The TTFT samples come from ``engine.finished``. The port's sync-free and
chunked loops consume every readback a slot after its dispatch (ROADMAP
R5), so a request finishing in slot t feeds the calibration at slot t+2's
decision; the reference's early consume can feed it a slot sooner, and
tests that compare the two turn that consume off.

``SLOScheduler`` — a ``PolicyScheduler`` that feeds the policy its TTFT
samples and, under overload, degrades in a FIXED ladder instead of letting
backlog grow unboundedly:

    level >= 1:  drop deadline-expired queued requests (they can no longer
                 meet their TTFT deadline — serving them is pure waste),
                 then shed arrivals from the lowest priority tier present
    level >= 2:  additionally cap per-slot admissions to a fraction of the
                 decode batch, bounding the refill rate of active rows

Every shed/drop is recorded in the DecisionLog (``record_shed``) and
counted (``counters()`` -> repro_* families): degradation is never silent.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.control.policy import _TablePolicy, as_f32, drift_plus_penalty_action
from repro_torch.core.utility import Utility
from repro_torch.reliability.conformal import ConformalQuantile
from repro_torch.runtime.scheduler import PolicyScheduler


class TenantSLO(NamedTuple):
    """One tenant's deadline contract: TTFT <= deadline_slots for at least
    ``quantile`` of its requests; ``weight`` scales its virtual queue's
    share of the admission price, ``priority`` its shed order (higher =
    shed later)."""

    name: str
    deadline_slots: int
    quantile: float = 0.99
    weight: float = 1.0
    priority: int = 0


class SLOCarry:
    """Host-side policy state: one conformal calibrator + virtual queue per
    tenant. Only the scalar ``value`` (the aggregate price) reaches the
    device, in ``ConformalSLO.act``."""

    def __init__(self, tenants: tuple, window: int):
        self.calib = {t.name: ConformalQuantile(window) for t in tenants}
        self.z = {t.name: 0.0 for t in tenants}
        self.qhat = {t.name: 0.0 for t in tenants}
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value


@dataclasses.dataclass(frozen=True)
class ConformalSLO(_TablePolicy):
    """Algorithm 1 plus per-tenant conformal virtual queues.

    ``observe`` consumes (tenant, ttft_slots) samples the scheduler collects
    from finished requests; unknown tenants (no TenantSLO entry) are
    ignored. Calibration sorts a small window per slot on the host's
    control path, and only the aggregate price reaches the device.
    """

    rates: tuple[float, ...]
    V: float
    tenants: tuple[TenantSLO, ...] = ()
    utility: Utility = None  # type: ignore[assignment]
    arrival_gain: float = 1.0
    window: int = 128        # conformal calibration window per tenant
    slo_gain: float = 1.0    # price scale on the aggregate SLO queue

    observation = "slo"      # the scheduler feeds TTFT samples, not a scalar

    @property
    def vq_cost_per_rate(self) -> float:
        return self.slo_gain

    def init(self) -> SLOCarry:
        return SLOCarry(self.tenants, self.window)

    def observe(self, carry: SLOCarry, samples: list) -> SLOCarry:
        """Push this slot's (tenant, ttft) samples, recalibrate each
        tenant's conformal quantile, and advance its virtual queue on the
        normalized margin (qhat - D) / D."""
        for tenant, ttft in samples:
            c = carry.calib.get(tenant)
            if c is not None:
                c.push(float(ttft))
        value = 0.0
        for t in self.tenants:
            c = carry.calib[t.name]
            qhat = c.quantile(t.quantile) if len(c) else 0.0
            carry.qhat[t.name] = qhat
            margin = (qhat - t.deadline_slots) / max(t.deadline_slots, 1)
            carry.z[t.name] = max(carry.z[t.name] + margin, 0.0)
            value += t.weight * carry.z[t.name]
        carry._value = value
        return carry

    def act(self, carry: SLOCarry, backlog) -> tuple[Any, SLOCarry]:
        """One decision: MemoryAware's pricing with Z the aggregate price,
        rounded to float32 and made on the tables' device (``torch.full``:
        no host copy)."""
        f, s, lam = self.tables()
        z = as_f32(carry.value, f.device)
        extra = z.double()[..., None] * (self.vq_cost_per_rate * f).double()
        f_star, _ = drift_plus_penalty_action(backlog, f, s, lam, self.V, extra)
        return f_star, carry


@dataclasses.dataclass
class SLOScheduler(PolicyScheduler):
    """PolicyScheduler with the degradation ladder.

    Overload levels arm on the policy's SLO pressure (the aggregate virtual
    queue value) or on queue fill, whichever trips first; ladder rungs are
    strictly ordered and each recorded shed carries its rung as the reason.
    """

    overload_backlog_frac: float = 0.75  # level-1 arm: queue fill fraction
    shed_pressure: float = 0.5           # level-1 arm: SLO pressure
    cap_backlog_frac: float = 0.95       # level-2 arm: queue fill fraction
    cap_pressure: float = 2.0            # level-2 arm: SLO pressure
    cap_frac: float = 0.5                # level-2 admission cap (of batch rows)

    def __post_init__(self):
        super().__post_init__()
        self._engine = None
        self._seen_rids: set = set()
        self._tenant_stats: dict = {}    # name -> [finished, ontime]
        self.degrade_level = 0
        self.shed_expired = 0
        self.shed_priority = 0
        self.shed_capped = 0
        self.shed_log: list = []         # (slot, rid, tenant, reason)

    # ------------------------------------------------------- observations
    def _collect_samples(self) -> list:
        """New (tenant, ttft) samples since the last control slot, from the
        engine/fleet finished list; also folds per-tenant attainment."""
        eng = self._engine
        if eng is None:
            return []
        out = []
        for r in eng.finished:
            if r.rid in self._seen_rids or r.first_token_slot is None:
                continue
            self._seen_rids.add(r.rid)
            ttft = r.first_token_slot - r.arrival_slot
            out.append((r.tenant, ttft))
            st = self._tenant_stats.setdefault(r.tenant, [0, 0])
            st[0] += 1
            if r.deadline_slots is None or ttft <= r.deadline_slots:
                st[1] += 1
        return out

    def _observe(self, occupancy, token_backlog,
                 quant_occupancy=None) -> None:
        super()._observe(occupancy, token_backlog, quant_occupancy)
        if (getattr(self.policy, "observation", None) == "slo"
                and hasattr(self.policy, "observe")):
            self._carry = self.policy.observe(self._carry,
                                              self._collect_samples())

    def attainment(self) -> dict:
        """Per-tenant served-on-time fraction over everything finished."""
        return {name: (st[1] / st[0] if st[0] else 1.0)
                for name, st in self._tenant_stats.items()}

    # -------------------------------------------------- degradation ladder
    def _pressure(self) -> float:
        """The aggregate SLO price (a host float: SLOCarry's value)."""
        v = getattr(self._carry, "value", 0.0)
        return float(v.cpu() if isinstance(v, torch.Tensor) else v)

    def _overload_level(self, engine) -> int:
        pressure = self._pressure()
        qfrac = engine.queue_len() / max(self.capacity, 1)
        if pressure >= self.cap_pressure or qfrac >= self.cap_backlog_frac:
            return 2
        if pressure >= self.shed_pressure or qfrac >= self.overload_backlog_frac:
            return 1
        return 0

    def _record_shed(self, req, now: int, reason: str, level: int) -> None:
        self.shed_log.append((now, req.rid, req.tenant, reason))
        if self._decisions is not None and self._decisions.enabled:
            self._decisions.record_shed(
                t=now, rid=req.rid, tenant=req.tenant, priority=req.priority,
                reason=reason, level=level,
                waited=now - req.arrival_slot)

    def _drop_expired(self, engine, now: int, level: int) -> int:
        """Rung 1: a queued request past its TTFT deadline can no longer
        meet it — drop it before it wastes a decode row."""
        pendings = ([e.pending for e in engine.replicas]
                    if hasattr(engine, "replicas") else [engine.pending])
        dropped = 0
        for pending in pendings:
            keep = []
            for r in pending:
                if (r.deadline_slots is not None
                        and now - r.arrival_slot > r.deadline_slots):
                    self._record_shed(r, now, "expired", level)
                    dropped += 1
                else:
                    keep.append(r)
            if dropped:
                pending[:] = keep
        self.shed_expired += dropped
        return dropped

    def _shed_lowest_tier(self, reqs: list, now: int, level: int) -> list:
        """Rung 2: shed this slot's arrivals from the lowest priority tier
        present — only when more than one tier is present (a uniform batch
        is the cap rung's job, not starvation's)."""
        tiers = {r.priority for r in reqs}
        if len(tiers) < 2:
            return reqs
        low = min(tiers)
        keep = []
        for r in reqs:
            if r.priority == low:
                self._record_shed(r, now, "priority", level)
                self.shed_priority += 1
            else:
                keep.append(r)
        return keep

    def _cap_admissions(self, engine, reqs: list, now: int,
                        level: int) -> list:
        """Rung 3: bound the per-slot admission count to ``cap_frac`` of
        the decode batch, throttling the refill rate of active rows."""
        rows = max(len(engine.active), 1)
        cap = max(1, int(self.cap_frac * rows))
        if len(reqs) <= cap:
            return reqs
        # highest tier first (stable: arrival order within a tier), so the
        # cap falls on the lowest-priority arrivals
        reqs = sorted(reqs, key=lambda r: -r.priority)
        keep, over = reqs[:cap], reqs[cap:]
        for r in over:
            self._record_shed(r, now, "capped", level)
            self.shed_capped += 1
        return keep

    def admit(self, engine, reqs: list, now: int) -> list:
        self._engine = engine
        # priority admission order: within a slot's offer, higher tiers
        # claim rows/queue positions first (stable within a tier)
        reqs = sorted(reqs, key=lambda r: -r.priority)
        level = self._overload_level(engine)
        self.degrade_level = level
        if level >= 1:
            self._drop_expired(engine, now, level)
            reqs = self._shed_lowest_tier(reqs, now, level)
        if level >= 2:
            reqs = self._cap_admissions(engine, reqs, now, level)
        return super().admit(engine, reqs, now)

    # ------------------------------------------------------------ exports
    def counters(self) -> dict:
        """repro_* families for the export pipeline (``obs.export_counters``):
        shed counts are monotone counters, pressure/level are gauges."""
        return {
            "requests_shed_expired": self.shed_expired,
            "requests_shed_priority": self.shed_priority,
            "requests_shed_capped": self.shed_capped,
            "requests_dropped_capacity": self.dropped,
            "slo_pressure": self._pressure(),
            "degrade_level": self.degrade_level,
        }


def ConformalScheduler(
    rates: tuple = tuple(float(f) for f in range(1, 11)),
    V: float = 50.0,
    tenants: tuple = (),
    window: int = 128,
    slo_gain: float = 1.0,
    capacity: int = 256,
    device: Optional[str] = None,
    obs=None,
    **ladder,
) -> SLOScheduler:
    """SLOScheduler over a ConformalSLO policy (the default SLO stack)."""
    policy = ConformalSLO(
        rates=tuple(float(f) for f in rates), V=V,
        tenants=tuple(tenants), window=window, slo_gain=slo_gain,
    )
    return SLOScheduler(policy=policy, capacity=capacity, device=device, obs=obs, **ladder)
