"""Slot-time serve loop: source -> scheduler (Policy) -> engine.

``serve`` runs T control slots. Each slot: the scheduler evaluates its
Policy on the current backlog, the source yields that many requests, the
engine runs ``steps_per_slot`` decode steps (its service capacity). With the
default fused path each slot costs at most one prefill dispatch (batched
admission of every free slot) plus one decode dispatch (``steps_per_slot``
steps in one call); ``fused=False`` keeps the legacy per-step loop (k
batch-1 prefills + steps_per_slot decode dispatches). Returns a trace: the
serving-system analogue of the paper's Fig. 2, with a real model in the
loop. The per-slot ``syncs`` column counts dispatch-gating synchronous
readbacks. With a ``PagedEngine`` the scheduler also observes the page
pool's occupancy each slot, and the ``occupancy`` column records its
high-water mark (0.0 for the dense engine).

``sync_free=True`` selects the zero-blocking-sync protocol: the
scheduler's decision pipelines through ``control_async`` (one-slot-lagged
control) and the engine's ``step_slot_sync`` dispatches every slot from
device-resident state, consuming the previous slot's counter copy after
it. ``chunked=True`` runs continuous batching (``step_slot_chunked``)
under the same protocol. The trace's ``served`` counts then lag the device
by one slot; ``serve`` flushes the tail with ``engine.drain()`` and folds
it into the last slot. Every slot the scheduler also observes the engine's
token backlog (pending prompt tokens), which ``TokenBacklogAware`` prices,
and a paged engine's quantized-region occupancy, which ``PrecisionAware``
prices; after the rate, the scheduler's ``admit_precision`` picks the page
region of the slot's admissions and the loop sets it on the engine.
"""
from __future__ import annotations

import numpy as np

from repro_torch.runtime.engine import Engine
from repro_torch.runtime.request import RequestSource


def serve(engine: Engine, scheduler, source: RequestSource, *,
          horizon: int, steps_per_slot: int = 2, fused: bool = True,
          sync_free: bool = False, chunked: bool = False) -> dict:
    if getattr(scheduler, "device", "") is None:
        scheduler.device = engine.device   # Algorithm 1 runs beside the engine
    trace = {"backlog": [], "rate": [], "served": [], "active": [],
             "dropped": [], "dispatches": [], "occupancy": [], "syncs": []}
    paged = hasattr(engine, "occupancy")
    for t in range(horizon):
        d0 = engine.prefill_dispatches + engine.decode_dispatches
        s0 = engine.blocking_syncs
        # the observation is the previous slot's commitment peak: end-of-slot
        # occupancy dips as retirements free pages, hiding the pressure the
        # controller must price
        occ = max(engine.occupancy(), engine.occupancy_hwm) if paged else None
        tok = engine.token_backlog()
        qocc = engine.quant_occupancy() if paged else None
        if sync_free or chunked:
            rate = scheduler.control_async(engine.queue_len(), occupancy=occ,
                                           token_backlog=tok, quant_occupancy=qocc)
        else:
            rate = scheduler.control(engine.queue_len(), occupancy=occ,
                                     token_backlog=tok, quant_occupancy=qocc)
        # the precision lever: a policy with admit_precision picks the page
        # region of this slot's admissions
        if occ is not None and hasattr(scheduler, "admit_precision"):
            chosen = scheduler.admit_precision(occ)
            if chosen is not None:
                engine.admit_precision = chosen
        reqs = source.poll(t, rate)
        scheduler.admit(engine, reqs, t)
        if chunked:
            m = engine.step_slot_chunked(t, n_steps=steps_per_slot)
            served = m["served"]
        elif sync_free:
            m = engine.step_slot_sync(t, n_steps=steps_per_slot)
            served = m["served"]
        elif fused:
            m = engine.step_slot(t, n_steps=steps_per_slot)
            served = m["served"]
        else:
            served = 0
            for _ in range(steps_per_slot):
                m = engine.step(t)
                served += m["served"]
        trace["backlog"].append(engine.queue_len())
        trace["rate"].append(rate)
        trace["served"].append(served)
        trace["active"].append(m["active"])
        trace["dropped"].append(scheduler.dropped)
        trace["dispatches"].append(
            engine.prefill_dispatches + engine.decode_dispatches - d0
        )
        trace["occupancy"].append(engine.occupancy_hwm if paged else 0.0)
        trace["syncs"].append(engine.blocking_syncs - s0)
    if (sync_free or chunked) and trace["served"]:
        # flush the in-flight slot's readback so the totals match the
        # synchronous paths; its completions belong to the last slot
        trace["served"][-1] += engine.drain()["served"]
    return {k: np.asarray(v) for k, v in trace.items()}


def latency_stats(engine: Engine) -> dict:
    """Wait/total latency percentiles over finished requests.

    ``waits`` and ``totals`` filter on different fields (start_slot vs
    finish_slot), each guarded on its own list. ``ttft`` is arrival to the
    slot whose dispatch emitted the first generated token; ``queue_wait``
    is arrival to engine claim. ``admitted_but_unfinished`` counts requests
    holding an engine row or queue slot at shutdown.
    """
    waits = [r.start_slot - r.arrival_slot for r in engine.finished
             if r.start_slot is not None]
    qwaits = [r.admit_slot - r.arrival_slot for r in engine.finished
              if r.admit_slot is not None]
    totals = [r.finish_slot - r.arrival_slot for r in engine.finished
              if r.finish_slot is not None]
    ttfts = [r.first_token_slot - r.arrival_slot for r in engine.finished
             if r.first_token_slot is not None]
    unfinished = (sum(1 for r in engine.active if r is not None)
                  + len(engine.pending))
    out = {"n": len(totals), "admitted_but_unfinished": unfinished}
    if totals:
        out["total_p50"] = float(np.percentile(totals, 50))
        out["total_p99"] = float(np.percentile(totals, 99))
    if waits:
        out["wait_p50"] = float(np.percentile(waits, 50))
        out["wait_p99"] = float(np.percentile(waits, 99))
    if qwaits:
        out["queue_wait_p50"] = float(np.percentile(qwaits, 50))
        out["queue_wait_p99"] = float(np.percentile(qwaits, 99))
    if ttfts:
        out["ttft_p50"] = float(np.percentile(ttfts, 50))
        out["ttft_p99"] = float(np.percentile(ttfts, 99))
    return out
