"""The multi-tenant axis of the Policy layer.

A composition over the one Algorithm-1 implementation in
``repro_torch.control.policy``: N tenants are a leading axis on Q, and
``drift_plus_penalty_action`` broadcasts leading axes, so N decisions are
one batched call (the reference's ``jax.vmap`` over the same function).
Nothing here re-derives the decision rule. The pod-mapped
``distributed_action`` is not ported (ROADMAP.md queue 1 item 13).
"""
from __future__ import annotations

import torch

from repro_torch.control.policy import as_f32, drift_plus_penalty_action


def multi_tenant_action(backlogs, rates: torch.Tensor, utility_tables: torch.Tensor,
                        arrival_tables: torch.Tensor, V) -> torch.Tensor:
    """N tenants, one decision each, heterogeneous utilities and V.

    backlogs (N,): per-tenant Q(t); rates (A,): the shared action set F;
    utility_tables (N, A): per-tenant S(f); arrival_tables (N, A) or (A,):
    per-tenant lambda(f); V: (N,) or a scalar. Returns the (N,) chosen
    rates, each the single-tenant call's on that tenant's row (V gains a
    trailing axis against the actions)."""
    dev = rates.device
    q = as_f32(backlogs, dev)
    V = torch.broadcast_to(as_f32(V, dev), q.shape)[..., None]
    arrival_tables = torch.broadcast_to(arrival_tables, utility_tables.shape)
    f_star, _ = drift_plus_penalty_action(q, rates, utility_tables, arrival_tables, V)
    return f_star
