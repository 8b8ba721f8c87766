"""Serving launcher: model + engine + Policy-driven admission control.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --horizon 40 --policy adaptive [--device cpu]

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; with no card it fails rather than falling back. Weights are drawn
from a seeded ``torch.Generator``. ``--policy static --rate 5`` runs the
paper's fixed-rate baseline; ``--policy latency-aware`` adds a
virtual-queue cost budget on the sampling rate; ``--policy memory-aware``
prices KV page-pool occupancy (pairs with ``--paged``). ``--paged`` serves
from the paged KV cache (shared page pool, block tables,
``--page-size``/``--num-pages``/``--max-active`` geometry) instead of dense
per-slot cache rows:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --paged --policy memory-aware --horizon 12 [--device cpu]

``--legacy-loop`` switches the dense engine off the fused (1 prefill + 1
decode dispatch per slot) path. Flags of paths the port does not have yet
raise NotImplementedError naming the ROADMAP.md queue item that brings them.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.control import LatencyAware
from repro_torch.models import init_params
from repro_torch.runtime import (AdaptiveScheduler, Engine, EngineConfig,
                                 MemoryAwareScheduler, PagedEngine,
                                 PagedEngineConfig, PolicyScheduler,
                                 RequestSource, StaticScheduler, latency_stats,
                                 serve)

# flag -> the ROADMAP.md queue-1 item that will bring its path
_UNPORTED = {
    "prefix_sharing": "item 8 (prefix sharing)",
    "quant_pages": "item 9 (quantized KV pages)",
    "sync_free": "item 6 (sync-free loop)",
    "chunked": "item 6 (chunked continuous batching)",
    "replicas": "item 8 (the fleet)",
    "kv_precision": "item 9 (quantized KV pages)",
    "temperature": "item 7 (per-request sampling)",
    "top_k": "item 7 (per-request sampling)",
    "top_p": "item 7 (per-request sampling)",
    "rep_penalty": "item 7 (per-request sampling)",
    "sampling_seed": "item 7 (per-request sampling)",
    "tenants": "item 10 (observability and reliability)",
    "metrics": "item 10 (observability and reliability)",
    "trace_out": "item 10 (observability and reliability)",
    "decisions_out": "item 10 (observability and reliability)",
}
_UNPORTED_POLICIES = {
    "token-aware": "item 2 (TokenBacklogAware) with item 6 (chunked batching)",
    "precision-aware": "item 2 (PrecisionAware) with item 9 (quantized KV pages)",
    "conformal-slo": "item 10 (observability and reliability)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no card and no --device cpu fails")
    ap.add_argument("--policy", default="adaptive",
                    choices=["adaptive", "static", "latency-aware", "memory-aware",
                             *_UNPORTED_POLICIES])
    ap.add_argument("--cost-budget", type=float, default=4.0,
                    help="latency-aware: time-average rate budget")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV cache (page pool + block tables)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=64)
    ap.add_argument("--max-active", type=int, default=16,
                    help="paged: decode batch rows (concurrency bound)")
    ap.add_argument("--occupancy-budget", type=float, default=0.6,
                    help="memory-aware: target time-average pool occupancy")
    ap.add_argument("--legacy-loop", action="store_true",
                    help="per-step loop (k prefills + n decode dispatches)")
    ap.add_argument("--min-prompt-len", type=int, default=None,
                    help="ragged workload: prompt lengths uniform in "
                         "[min, prompt-len] (exercises bucketed prefill)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token")
    ap.add_argument("--rate", type=float, default=5.0, help="static policy rate")
    ap.add_argument("--V", type=float, default=20.0)
    ap.add_argument("--raw-rate", type=int, default=5)
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--capacity", type=int, default=32)
    for flag in ("prefix_sharing", "sync_free", "chunked", "metrics"):
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help=f"not ported yet: ROADMAP.md queue 1 {_UNPORTED[flag]}")
    for flag in ("quant_pages", "replicas", "kv_precision", "temperature", "top_k",
                 "top_p", "rep_penalty", "sampling_seed", "tenants", "trace_out",
                 "decisions_out"):
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help=f"not ported yet: ROADMAP.md queue 1 {_UNPORTED[flag]}")
    return ap


def build(args):
    """The model, engine, scheduler and request source ``args`` ask for.
    Raises ValueError for argument combinations the reference's launcher
    refuses, and NotImplementedError for paths the port does not have yet."""
    if args.paged and args.legacy_loop:
        raise ValueError("--legacy-loop is a dense-engine comparison path; "
                         "the paged engine has no per-step loop")
    if args.prefix_sharing and not args.paged:
        raise ValueError("--prefix-sharing shares pages of the paged KV pool; "
                         "it requires --paged")
    if args.policy == "memory-aware" and not args.paged:
        raise ValueError("--policy memory-aware prices page-pool occupancy; "
                         "it requires --paged (the dense engine reports none)")
    if args.quant_pages is not None and not args.paged:
        raise ValueError("--quant-pages is paged-pool geometry; it requires --paged")
    for flag, item in _UNPORTED.items():
        val = getattr(args, flag)
        if val not in (None, False) and not (flag == "replicas" and val == "1"):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet; see ROADMAP.md "
                f"queue 1 {item}")
    if args.policy in _UNPORTED_POLICIES:
        raise NotImplementedError(
            f"--policy {args.policy} is not ported yet; see ROADMAP.md queue 1 "
            f"{_UNPORTED_POLICIES[args.policy]}")
    for name in ("slots", "prompt_len", "cache_len", "page_size", "num_pages",
                 "max_active", "capacity", "horizon", "raw_rate"):
        if getattr(args, name) < 1:
            raise ValueError(f"--{name.replace('_', '-')} must be >= 1, "
                             f"got {getattr(args, name)}")

    cfg = get_config(args.arch, smoke=args.smoke)
    model = init_params(cfg, seed=0, device=args.device)
    if args.paged:
        engine = PagedEngine(model, PagedEngineConfig(
            prompt_len=args.prompt_len, cache_len=args.cache_len,
            page_size=args.page_size, num_pages=args.num_pages,
            max_active=args.max_active, eos_id=args.eos_id))
    else:
        engine = Engine(model, EngineConfig(
            batch_slots=args.slots, prompt_len=args.prompt_len,
            cache_len=args.cache_len, eos_id=args.eos_id))
    rates = tuple(float(f) for f in range(1, args.raw_rate + 1))
    if args.policy == "adaptive":
        sched = AdaptiveScheduler(rates=rates, V=args.V, capacity=args.capacity)
    elif args.policy == "latency-aware":
        sched = PolicyScheduler(
            policy=LatencyAware(rates=rates, V=args.V, cost_gain=1.0,
                                cost_budget=args.cost_budget),
            capacity=args.capacity)
    elif args.policy == "memory-aware":
        sched = MemoryAwareScheduler(rates=rates, V=args.V,
                                     occupancy_budget=args.occupancy_budget,
                                     capacity=args.capacity)
    else:
        sched = StaticScheduler(rate=args.rate, capacity=args.capacity)
    src = RequestSource(vocab_size=cfg.vocab_size, prompt_len=args.prompt_len,
                        raw_rate=args.raw_rate, max_new_tokens=4,
                        min_prompt_len=args.min_prompt_len)
    return engine, sched, src


def run(args, engine, sched, src) -> dict:
    """Serve ``args.horizon`` control slots, two decode steps each."""
    return serve(engine, sched, src, horizon=args.horizon, steps_per_slot=2,
                 fused=not args.legacy_loop)


def summary(args, tr: dict, sched) -> str:
    return (f"policy={args.policy} served={int(tr['served'].sum())} "
            f"dropped={sched.dropped} "
            f"tail_backlog={float(tr['backlog'][-5:].mean()):.1f} "
            f"mean_rate={float(np.mean(sched.rate_history)):.2f} "
            f"dispatches_per_slot={float(tr['dispatches'].mean()):.2f} "
            f"blocking_syncs_per_slot={float(tr['syncs'].mean()):.2f}")


def paged_summary(tr: dict, engine: PagedEngine) -> str:
    st = engine.allocator.stats()
    return (f"paged: peak_occupancy={float(tr['occupancy'].max()):.2f} "
            f"peak_pages={st.peak_used_pages}/{st.num_pages} "
            f"peak_active={engine.peak_active} "
            f"alloc_failures={engine.alloc_failures} "
            f"preemptions={engine.preemptions}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    engine, sched, src = build(args)
    tr = run(args, engine, sched, src)
    print(summary(args, tr, sched))
    if args.paged:
        print(paged_summary(tr, engine))
    print("latency:", latency_stats(engine))


if __name__ == "__main__":
    main()
