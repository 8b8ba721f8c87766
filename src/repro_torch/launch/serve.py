"""Serving launcher: model + engine + Policy-driven admission control.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --horizon 40 --policy adaptive [--device cpu]

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; with no card it fails rather than falling back. Weights are drawn
from a seeded ``torch.Generator``. ``--policy static --rate 5`` runs the
paper's fixed-rate baseline; ``--policy latency-aware`` adds a
virtual-queue cost budget on the sampling rate. ``--legacy-loop`` switches
the engine off the fused (1 prefill + 1 decode dispatch per slot) path.
Flags of paths the port does not have yet raise NotImplementedError naming
the ROADMAP.md queue item that brings them.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.control import LatencyAware
from repro_torch.models import init_params
from repro_torch.runtime import (AdaptiveScheduler, Engine, EngineConfig,
                                 PolicyScheduler, RequestSource,
                                 StaticScheduler, latency_stats, serve)

# flag -> the ROADMAP.md queue-1 item that will bring its path
_UNPORTED = {
    "paged": "item 5 (paged engine)",
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
    "memory-aware": "item 2 (MemoryAware) with item 5 (paged engine)",
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
                    choices=["adaptive", "static", "latency-aware",
                             *_UNPORTED_POLICIES])
    ap.add_argument("--cost-budget", type=float, default=4.0,
                    help="latency-aware: time-average rate budget")
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
    for flag in ("paged", "sync_free", "chunked", "metrics"):
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help=f"not ported yet: ROADMAP.md queue 1 {_UNPORTED[flag]}")
    for flag in ("replicas", "kv_precision", "temperature", "top_k", "top_p",
                 "rep_penalty", "sampling_seed", "tenants", "trace_out",
                 "decisions_out"):
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help=f"not ported yet: ROADMAP.md queue 1 {_UNPORTED[flag]}")
    return ap


def build(args):
    """The model, engine, scheduler and request source ``args`` ask for.
    Raises NotImplementedError for paths the port does not have yet."""
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
    for name in ("slots", "prompt_len", "cache_len", "capacity", "horizon",
                 "raw_rate"):
        if getattr(args, name) < 1:
            raise ValueError(f"--{name.replace('_', '-')} must be >= 1, "
                             f"got {getattr(args, name)}")

    cfg = get_config(args.arch, smoke=args.smoke)
    model = init_params(cfg, seed=0, device=args.device)
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


def main(argv=None):
    args = build_parser().parse_args(argv)
    engine, sched, src = build(args)
    tr = run(args, engine, sched, src)
    print(summary(args, tr, sched))
    print("latency:", latency_stats(engine))


if __name__ == "__main__":
    main()
