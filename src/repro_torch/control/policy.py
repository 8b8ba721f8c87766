"""The Policy protocol and the one implementation of Algorithm 1.

``drift_plus_penalty_action`` implements the paper's per-slot decision

    f*(t) = argmax_{f in F} { V * S(f) - Q(t) * lambda(f) }

over the finite action set F, with torch ops on whatever device its
tensors live on. Ties go to the *lowest* rate: ``torch.argmax`` returns the
first maximal index, as ``jnp.argmax`` does in the reference, and F is
listed in increasing order.

The functional is evaluated from the float32 tables with every product
exact (in float64) and one rounding to float32 per subtraction: first
V * S(f) - Q * lambda(f), then, with a virtual queue, that value minus
its price Z * cost(f). That is how the reference's jitted dispatch
evaluates it — XLA contracts the products into fused multiply-adds — and
it decides the near-ties that integer backlogs produce: evaluated op by op
in float32, V * S(f) would round first; evaluated with a single rounding,
the ties V * S(f) = (Q + Z * cost / f) * f would not be ties. Either way
those decisions (and with them the whole serve trace) would differ.

A policy is a frozen dataclass with four methods:

    init()            -> carry            policy state (() if none)
    act(carry, Q)     -> (f*, carry')     one slot's decision
    arrivals(f*)      -> lambda(f*)       arrivals the decision induces
    to(device)        -> policy           the same policy, tables on device

A policy that prices an engine signal (``MemoryAware``: page-pool
occupancy; ``TokenBacklogAware``: pending prompt tokens;
``PrecisionAware``: the quantized page region's occupancy) also has
``observe(carry, signal) -> carry'`` and names the signal in
``observation``; the scheduler observes before it acts. ``PrecisionAware``
also has ``admit_precision(carry, occupancy) -> (region, carry')``, the
page region for the next admissions.
"""
from __future__ import annotations

import copy
import dataclasses
import numbers
from typing import Any, NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch.core.utility import Utility, paper_utility


def as_f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``. A Python number becomes a
    ``full`` there, which copies nothing from the host: a tensor made from
    host memory would block the card's stream (the sync-free loop feeds the
    policy its observations this way every slot)."""
    if isinstance(x, numbers.Real):
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def drift_plus_penalty_action(
    backlog,
    rates: torch.Tensor,
    utilities: torch.Tensor,
    arrivals: torch.Tensor,
    V,
    extra_penalty: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's Algorithm 1, lines 3-7, for one observation of Q(t).

    backlog: Q(t), scalar or batched (leading axes broadcast against F);
    rates/utilities/arrivals: F, S(F), lambda(F), shape (A,); V: the
    utility/stability trade-off; extra_penalty: an optional per-action
    penalty broadcastable to backlog[..., None] * arrivals (virtual
    queues). Returns (f_star, T_star), each of backlog's shape.
    """
    dev = rates.device
    q = as_f32(backlog, dev).double()
    V = as_f32(V, dev).double()
    T = (V * utilities.double() - q[..., None] * arrivals.double()).float()
    if extra_penalty is not None:
        T = (T.double() - extra_penalty.double()).float()
    idx = torch.argmax(T, dim=-1, keepdim=True)  # first maximizer = lowest rate on ties
    # gather, not rates[idx]: indexing with a 0-d device tensor reads it back
    f_star = torch.gather(rates.expand(*idx.shape[:-1], -1), -1, idx)[..., 0]
    T_star = torch.gather(T, -1, idx)[..., 0]
    return f_star, T_star


class VirtualQueue(NamedTuple):
    """Neely virtual queue for a time-average constraint E[y] <= budget."""

    value: torch.Tensor
    budget: torch.Tensor

    @staticmethod
    def make(budget: float, shape=(), device=None) -> "VirtualQueue":
        return VirtualQueue(torch.zeros(shape, dtype=torch.float32, device=device),
                            torch.tensor(budget, dtype=torch.float32, device=device))

    def step(self, y: torch.Tensor) -> "VirtualQueue":
        return VirtualQueue(torch.clamp(self.value + y - self.budget, min=0.0),
                            self.budget)

    def to(self, device) -> "VirtualQueue":
        return VirtualQueue(self.value.to(device), self.budget.to(device))


@runtime_checkable
class Policy(Protocol):
    """Backlog in, rate out — the one interface every control plane speaks."""

    def init(self) -> Any: ...

    def act(self, carry: Any, backlog) -> tuple[torch.Tensor, Any]: ...

    def arrivals(self, f_star: torch.Tensor) -> torch.Tensor: ...

    def to(self, device) -> "Policy": ...


@dataclasses.dataclass(frozen=True)
class Static:
    """Fixed-rate baseline (the paper's comparison curves)."""

    rate: float

    def init(self) -> Any:
        return ()

    def act(self, carry: Any, backlog) -> tuple[torch.Tensor, Any]:
        backlog = torch.as_tensor(backlog, dtype=torch.float32)
        # float64 so that reading it back gives ``rate`` exactly
        return torch.full_like(backlog, self.rate, dtype=torch.float64), carry

    def arrivals(self, f_star: torch.Tensor) -> torch.Tensor:
        return f_star

    def to(self, device) -> "Static":
        return self


class _TablePolicy:
    """Shared table construction for the Algorithm-1 policy family.

    Subclasses are frozen dataclasses with ``rates``/``utility``/
    ``arrival_gain`` fields; the (F, S(F), lambda(F)) tables are built once
    on the host at construction (a non-field attr: hash/eq stay
    field-based); ``to(device)`` returns a copy whose tables live there.
    """

    def __post_init__(self):
        if self.utility is None:
            object.__setattr__(self, "utility", paper_utility(max(self.rates)))
        f = torch.tensor(self.rates, dtype=torch.float32)
        object.__setattr__(self, "_tables", (f, self.utility(f), self.arrival_gain * f))

    def tables(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self._tables

    def to(self, device):
        moved = copy.copy(self)
        object.__setattr__(moved, "_tables", tuple(t.to(device) for t in self._tables))
        return moved

    def arrivals(self, f_star: torch.Tensor) -> torch.Tensor:
        return self.arrival_gain * f_star


@dataclasses.dataclass(frozen=True)
class DriftPlusPenalty(_TablePolicy):
    """Algorithm 1 over a discrete rate set F — the paper's controller.

    lambda(f) = arrival_gain * f: the paper's setting has lambda(f) = f
    (every sampled frame enters the queue).
    """

    rates: tuple[float, ...]
    V: float
    utility: Utility = None  # type: ignore[assignment]
    arrival_gain: float = 1.0

    def init(self) -> Any:
        return ()

    def act(self, carry: Any, backlog) -> tuple[torch.Tensor, Any]:
        f, s, lam = self.tables()
        f_star, _ = drift_plus_penalty_action(backlog, f, s, lam, self.V)
        return f_star, carry


@dataclasses.dataclass(frozen=True)
class LatencyAware(_TablePolicy):
    """Algorithm 1 plus a virtual queue pricing a time-average cost budget.

    The per-slot cost is y(f) = cost_gain * f; the Neely construction keeps
    avg y <= cost_budget by adding Z(t) * y(f) to the penalty term. The
    virtual queue Z lives in the policy carry and advances inside ``act``.
    """

    rates: tuple[float, ...]
    V: float
    utility: Utility = None  # type: ignore[assignment]
    arrival_gain: float = 1.0
    cost_gain: float = 1.0
    cost_budget: float = 4.0

    def init(self) -> VirtualQueue:
        return VirtualQueue.make(self.cost_budget)

    def act(self, carry: VirtualQueue, backlog) -> tuple[torch.Tensor, VirtualQueue]:
        f, s, lam = self.tables()
        extra = carry.value.double()[..., None] * (self.cost_gain * f).double()
        f_star, _ = drift_plus_penalty_action(backlog, f, s, lam, self.V, extra)
        return f_star, carry.step(self.cost_gain * f_star)


@dataclasses.dataclass(frozen=True)
class MemoryAware(_TablePolicy):
    """Algorithm 1 plus a virtual queue over KV page-pool occupancy.

    The paged engine's finite resource is its page pool; this policy
    extends the paper's queue-overflow argument to that pool the way
    ``LatencyAware`` extends it to a cost budget — a second (virtual) queue
    in the drift, no change to the argmax. The constrained quantity (pool
    occupancy in [0, 1]) is observed from the engine each slot rather than
    implied by the chosen action, so the virtual queue advances in
    ``observe`` (the scheduler feeds it the engine's occupancy); ``act``
    prices candidate rates by the pages they commit:
    Z(t) * mem_gain * pages_per_request * f.

        Z(t+1) = max(Z(t) + occ(t) - occupancy_budget, 0)

    keeps time-average occupancy <= occupancy_budget (Neely), which holds
    the pool below hard capacity where ``Static`` overflows into
    allocation failures.
    """

    rates: tuple[float, ...]
    V: float
    utility: Utility = None  # type: ignore[assignment]
    arrival_gain: float = 1.0
    pages_per_request: float = 2.0   # expected pages one admission commits
    occupancy_budget: float = 0.6    # target time-average pool fill
    mem_gain: float = 1.0            # price scale on the occupancy queue

    observation = "occupancy"        # the engine signal ``observe`` consumes

    @property
    def vq_cost_per_rate(self) -> float:
        return self.mem_gain * self.pages_per_request

    def init(self) -> VirtualQueue:
        return VirtualQueue.make(self.occupancy_budget)

    def observe(self, carry: VirtualQueue, occupancy) -> VirtualQueue:
        return carry.step(as_f32(occupancy, carry.value.device))

    def act(self, carry: VirtualQueue, backlog) -> tuple[torch.Tensor, VirtualQueue]:
        f, s, lam = self.tables()
        # the price table in float32 (the reference's cost table); each
        # product with Z stays exact until the functional rounds
        extra = carry.value.double()[..., None] * (self.vq_cost_per_rate * f).double()
        f_star, _ = drift_plus_penalty_action(backlog, f, s, lam, self.V, extra)
        return f_star, carry


@dataclasses.dataclass(frozen=True)
class TokenBacklogAware(_TablePolicy):
    """Algorithm 1 plus a virtual queue over pending prompt *tokens*.

    The request-count backlog Q(t) under-prices ragged workloads: one long
    prompt enqueues the prefill work of many short ones, so a controller
    that only counts requests keeps admitting while the chunked prefill
    pipeline falls behind. This policy extends the queue-overflow argument
    to the token dimension the way ``MemoryAware`` extends it to page
    occupancy, a second (virtual) queue in the drift:

        Z(t+1) = max(Z(t) + tok(t) - token_budget, 0)

    where tok(t) is the observed token backlog (the engine's
    ``token_backlog()``: queued prompt tokens plus the unwritten tails of
    chunked prefills), fed through ``observe`` each slot. ``act`` prices
    candidate rates by the prompt tokens they commit:
    Z(t) * tok_gain * tokens_per_request * f, with ``MemoryAware``'s two
    roundings (ROADMAP R4).
    """

    rates: tuple[float, ...]
    V: float
    utility: Utility = None  # type: ignore[assignment]
    arrival_gain: float = 1.0
    tokens_per_request: float = 16.0  # expected prompt tokens one admission commits
    token_budget: float = 64.0        # target time-average pending prompt tokens
    tok_gain: float = 1.0             # price scale on the token queue

    observation = "token_backlog"

    @property
    def vq_cost_per_rate(self) -> float:
        return self.tok_gain * self.tokens_per_request

    def init(self) -> VirtualQueue:
        return VirtualQueue.make(self.token_budget)

    def observe(self, carry: VirtualQueue, token_backlog) -> VirtualQueue:
        return carry.step(as_f32(token_backlog, carry.value.device))

    def act(self, carry: VirtualQueue, backlog) -> tuple[torch.Tensor, VirtualQueue]:
        f, s, lam = self.tables()
        extra = carry.value.double()[..., None] * (self.vq_cost_per_rate * f).double()
        f_star, _ = drift_plus_penalty_action(backlog, f, s, lam, self.V, extra)
        return f_star, carry


class PrecisionCarry(NamedTuple):
    """``PrecisionAware`` state: the quantized-occupancy virtual queue
    (``value``/``budget``, on the policy's device) and the admission
    precision latch ``lossy`` (True while new admissions land on quantized
    pages). The latch is a Python bool: the serve loop reads it every slot,
    and a device flag would cost a blocking readback there."""

    value: torch.Tensor
    budget: torch.Tensor
    lossy: bool = False

    def step(self, y: torch.Tensor) -> "PrecisionCarry":
        return self._replace(value=torch.clamp(self.value + y - self.budget, min=0.0))

    def to(self, device) -> "PrecisionCarry":
        return self._replace(value=self.value.to(device), budget=self.budget.to(device))


@dataclasses.dataclass(frozen=True)
class PrecisionAware(_TablePolicy):
    """Algorithm 1 plus a virtual queue over *quantized* page occupancy,
    and a precision choice for new admissions.

    A mixed page pool (native and int8/fp8 regions, ``PagedEngineConfig.
    quant_pages``) gives the controller a second lever besides the rate:
    when the native pages fill, new requests can be admitted onto quantized
    pages instead of being throttled. Two mechanisms:

    * ``admit_precision(carry, occupancy)``: a hysteresis latch on the
      host, over the engine's occupancy. Admissions go to
      ``quant_precision`` when occupancy reaches ``downgrade_at`` and
      return to native only once it falls to ``upgrade_at`` or below; the
      dead band keeps the latch from flipping on every slot's noise.
    * the virtual queue: once the quantized region fills too, the rate has
      to yield. Z advances on the quantized region's occupancy
      (``engine.quant_occupancy()``, fed through ``observe``),

          Z(t+1) = max(Z(t) + qocc(t) - quant_budget, 0)

      and ``act`` prices candidate rates by the pages they commit,
      Z(t) * quant_gain * pages_per_request * f: ``MemoryAware``'s
      construction (and its two roundings, ROADMAP R4), pointed at the
      quantized region.
    """

    rates: tuple[float, ...]
    V: float
    utility: Utility = None  # type: ignore[assignment]
    arrival_gain: float = 1.0
    pages_per_request: float = 2.0   # expected pages one admission commits
    quant_budget: float = 0.6        # target time-average quantized fill
    quant_gain: float = 1.0          # price scale on the quantized queue
    downgrade_at: float = 0.75       # occupancy that flips admissions lossy
    upgrade_at: float = 0.5          # occupancy that flips them back native
    quant_precision: str = "int8"    # region tag admissions downgrade onto

    observation = "quant_occupancy"  # the engine signal ``observe`` consumes

    def __post_init__(self):
        super().__post_init__()
        if not 0.0 <= self.upgrade_at <= self.downgrade_at:
            raise ValueError("hysteresis needs 0 <= upgrade_at <= downgrade_at, got "
                             f"{self.upgrade_at} / {self.downgrade_at}")

    @property
    def vq_cost_per_rate(self) -> float:
        return self.quant_gain * self.pages_per_request

    def init(self) -> PrecisionCarry:
        return PrecisionCarry(torch.zeros((), dtype=torch.float32),
                              torch.tensor(self.quant_budget, dtype=torch.float32))

    def observe(self, carry: PrecisionCarry, quant_occupancy) -> PrecisionCarry:
        return carry.step(as_f32(quant_occupancy, carry.value.device))

    def act(self, carry: PrecisionCarry, backlog) -> tuple[torch.Tensor, PrecisionCarry]:
        f, s, lam = self.tables()
        extra = carry.value.double()[..., None] * (self.vq_cost_per_rate * f).double()
        f_star, _ = drift_plus_penalty_action(backlog, f, s, lam, self.V, extra)
        return f_star, carry

    def admit_precision(self, carry: PrecisionCarry,
                        occupancy: float) -> tuple[str, PrecisionCarry]:
        """The latch's choice of page region for the next admissions, on the
        host: (tag, carry)."""
        occ = float(occupancy)
        lossy = (occ > self.upgrade_at) if carry.lossy else (occ >= self.downgrade_at)
        return (self.quant_precision if lossy else "native"), carry._replace(lossy=lossy)
