"""Chaos differential harness: drive engines/fleets under injected faults.

``chaos_drive`` mirrors the clean differential harness's drive loop
(``tests/test_differential.py::drive``) with a ChaosInjector in the loop, so the same
equivalence contract — bit-identical greedy streams, identical retirement
sets, served-count conservation — can be asserted *under* replica
failures, forced alloc shortfalls, delayed readbacks, and prefix-eviction
races. ``assert_no_leaks`` closes the loop on the memory invariant: after
a run retires everything, every page pool must hold exactly its
prefix-pinned pages (zero leaked references), chaos or not.

``save_artifacts`` dumps the run's trace/decision/chaos logs for a failing
run's post-mortem.
"""
from __future__ import annotations

import copy
import json
import os


def chaos_drive(target, mode: str, reqs: list, schedule: list,
                chaos=None, n_steps: int = 2, max_slots: int = 400):
    """Run one engine or fleet over the arrival schedule to completion,
    firing the injector's slot-scoped faults each slot.

    A fleet the injector is armed on fires ``before_slot`` from its own
    step loop; for bare engines (or an unarmed fleet) the harness fires it.
    Returns (streams, retired rids, (served+drained, finished)).
    """
    step = {"step": getattr(target, "step", None),
            "fused": target.step_slot,
            "sync": target.step_slot_sync,
            "chunked": target.step_slot_chunked}[mode]
    sched = {t: [copy.deepcopy(r) for r in batch] for t, batch in schedule}
    self_firing = (chaos is not None
                   and getattr(target, "chaos", None) is chaos)
    t = 0
    while ((len(target.finished) < len(reqs) or t <= max(sched))
           and t < max_slots):
        if chaos is not None and not self_firing:
            chaos.before_slot(t)
        if t in sched:
            target.submit(sched[t])
        if mode == "step":
            for _ in range(n_steps):
                step(t)
        else:
            step(t, n_steps=n_steps)
        t += 1
    drained = target.drain()["served"] if mode in ("sync", "chunked") else 0
    assert len(target.finished) == len(reqs), (
        f"{mode}: {len(target.finished)}/{len(reqs)} finished "
        f"after {t} slots (chaos log: {getattr(chaos, 'log', None)})")
    streams = {r.rid: tuple(r.generated) for r in target.finished}
    retired = frozenset(r.rid for r in target.finished)
    conservation = (sum(target.served_history) + drained,
                    len(target.finished))
    return streams, retired, conservation


def assert_no_leaks(target) -> None:
    """Zero-page-leak invariant over an engine or every fleet replica:
    allocator ownership is consistent (``check``) and, with everything
    retired, the pool holds exactly the prefix-pinned pages."""
    engines = target.replicas if hasattr(target, "replicas") else [target]
    for i, eng in enumerate(engines):
        alloc = getattr(eng, "allocator", None)
        if alloc is None:
            continue
        alloc.check()
        prefix = getattr(eng, "_prefix", None)
        pinned = len(prefix) if prefix is not None else 0
        assert alloc.used_pages == pinned, (
            f"replica {i}: {alloc.used_pages} pages in use, "
            f"{pinned} prefix-pinned — leak")


def save_artifacts(outdir: str, tag: str, obs=None, chaos=None) -> list:
    """Write the run's diagnostics (Chrome trace, decision log, chaos log)
    under ``outdir``; returns the written paths."""
    os.makedirs(outdir, exist_ok=True)
    paths = []
    if obs is not None and getattr(obs.trace, "enabled", False):
        p = os.path.join(outdir, f"{tag}_trace.json")
        with open(p, "w") as f:
            json.dump(obs.trace.chrome_trace(), f)
        paths.append(p)
    if obs is not None and getattr(obs.decisions, "enabled", False):
        paths.append(obs.decisions.save(
            os.path.join(outdir, f"{tag}_decisions.json")))
    if chaos is not None:
        p = os.path.join(outdir, f"{tag}_chaos.json")
        with open(p, "w") as f:
            json.dump({"log": chaos.log, "counters": chaos.counters()}, f)
        paths.append(p)
    return paths
