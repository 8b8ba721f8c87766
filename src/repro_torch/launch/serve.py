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
decode dispatch per slot) path. ``--sync-free`` serves the dense engine
with no blocking readback per slot (device-resident stop masks and token
ring, counters copied back a slot late, one-slot-lagged control);
``--chunked`` adds continuous batching, prompts entering the cache a chunk
per slot inside one mixed dispatch, and pairs with ``--policy token-aware``,
which prices pending prompt tokens against ``--token-budget``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --chunked --policy token-aware --horizon 12 [--device cpu]

``--kv-precision int8|fp8`` stores K/V as int8 or fp8 codes with
per-token-per-head scales: in the dense engine's ring cache on every
dense loop (fused, ``--legacy-loop``, ``--sync-free``, ``--chunked``), or
with ``--paged`` in the pages:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --kv-precision int8 --horizon 12 [--device cpu]

With ``--paged``, ``--quant-pages n`` in (0,
``--num-pages``) makes only the top n ids quantized, a mixed pool, and
``--policy precision-aware`` then moves new admissions onto the quantized
pages while occupancy is high (``--downgrade-at``/``--upgrade-at``) and
prices the quantized region's fill against ``--quant-budget``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --paged --num-pages 192 --max-active 16 --prompt-len 512 \
      --min-prompt-len 128 --cache-len 1024 --kv-precision int8 \
      --quant-pages 64 --policy precision-aware --downgrade-at 0.5 \
      --upgrade-at 0.3 --horizon 12 [--device cpu]

``--sync-free`` and ``--chunked`` serve the paged engine too, over any
pool; ``--prefix-sharing`` (with ``--paged``) shares resident prompt-prefix
pages between requests, page by page on the fused and sync-free loops and
token by token with copy-on-write forks on the chunked one, and prints a
``prefix:`` line:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --paged --chunked --prefix-sharing --kv-precision int8 \
      --policy token-aware --horizon 12 [--device cpu]

``--temperature``/``--top-k``/``--top-p``/``--rep-penalty``/
``--sampling-seed`` switch generation from greedy to per-request sampling
on every loop of both engines (the engine-default ``SamplingParams``),
drawn with the reference's request-keyed threefry keys, and print a
``sampling:`` line:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --temperature 0.8 --top-k 20 --sampling-seed 7 --horizon 12 \
      [--chunked --policy token-aware] [--device cpu]

``--arch mamba2-130m`` serves the Mamba-2 stack on the dense engine (the
fused loop, ``--legacy-loop`` or ``--sync-free``); ``--chunked`` and
``--paged`` refuse it with ValueError, as the reference does.

Flags of paths the port does not have yet raise NotImplementedError naming
the ROADMAP.md queue item that brings them.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.cache import parse_kv_precision
from repro_torch.configs import get_config
from repro_torch.control import LatencyAware
from repro_torch.models import init_params
from repro_torch.runtime import (AdaptiveScheduler, Engine, EngineConfig,
                                 MemoryAwareScheduler, PagedEngine,
                                 PagedEngineConfig, PolicyScheduler,
                                 PrecisionAwareScheduler, RequestSource,
                                 SamplingParams, StaticScheduler, TokenAwareScheduler,
                                 latency_stats, serve)

# flag -> the ROADMAP.md queue-1 item that will bring its path
_UNPORTED = {
    "replicas": "item 8 (the fleet)",
    "tenants": "item 10 (observability and reliability)",
    "metrics": "item 10 (observability and reliability)",
    "trace_out": "item 10 (observability and reliability)",
    "decisions_out": "item 10 (observability and reliability)",
}
_UNPORTED_POLICIES = {
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
                             "token-aware", "precision-aware", *_UNPORTED_POLICIES])
    ap.add_argument("--kv-precision", choices=["native", "int8", "fp8"], default="",
                    help="KV storage: int8/fp8 store the dense ring (or, with "
                         "--paged, the pages) as codes with per-token-per-head scales")
    ap.add_argument("--quant-pages", type=int, default=-1,
                    help="paged + quantized: size of the quantized page region (-1 = "
                         "every page; 0 < n < num-pages builds a mixed pool for "
                         "--policy precision-aware)")
    ap.add_argument("--quant-budget", type=float, default=0.6,
                    help="precision-aware: target time-average quantized-region "
                         "occupancy")
    ap.add_argument("--downgrade-at", type=float, default=0.75,
                    help="precision-aware: pool occupancy at which new admissions "
                         "flip onto quantized pages")
    ap.add_argument("--upgrade-at", type=float, default=0.5,
                    help="precision-aware: occupancy at or below which admissions "
                         "return to native pages")
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
    ap.add_argument("--sync-free", action="store_true",
                    help="zero-blocking-sync loop (device-resident stop masks, "
                         "async counter readback)")
    ap.add_argument("--chunked", action="store_true",
                    help="continuous batching: chunked prefill interleaved with "
                         "decode in one dispatch per slot (implies the "
                         "sync-free protocol)")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="chunked: prompt tokens per row per slot "
                         "(0 = prompt_len // 4)")
    ap.add_argument("--chunk-budget", type=int, default=0,
                    help="chunked: max prefill tokens per slot across rows "
                         "(0 = unlimited)")
    ap.add_argument("--token-budget", type=float, default=64.0,
                    help="token-aware: target time-average pending prompt tokens")
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
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="paged: share resident prompt-prefix pages between requests "
                         "(copy-on-write forks on the chunked path)")
    ap.add_argument("--metrics", action="store_true",
                    help=f"not ported yet: ROADMAP.md queue 1 {_UNPORTED['metrics']}")
    ap.add_argument("--temperature", type=float, default=None,
                    help="softmax temperature, >= 0 (0 = greedy argmax; default: pure "
                         "greedy engine, no sampling layer)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="sample from the k highest logits, >= 0 (0 = full vocabulary)")
    ap.add_argument("--top-p", type=float, default=None,
                    help="nucleus sampling mass in (0, 1] (1.0 = off)")
    ap.add_argument("--rep-penalty", type=float, default=None,
                    help="CTRL-style repetition penalty over generated tokens, > 0 "
                         "(1.0 = off)")
    ap.add_argument("--sampling-seed", type=int, default=None,
                    help="base RNG seed; the per-token key is "
                         "fold_in(fold_in(PRNGKey(seed), rid), token_index)")
    for flag in ("replicas", "tenants", "trace_out", "decisions_out"):
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help=f"not ported yet: ROADMAP.md queue 1 {_UNPORTED[flag]}")
    return ap


def sampling_params(args) -> Optional[SamplingParams]:
    """The engine-default SamplingParams the sampling flags ask for (None:
    the pure greedy engine), each flag checked as the reference's launcher
    checks it (ValueError naming the valid range)."""
    if args.temperature is not None and not args.temperature >= 0.0:
        raise ValueError(f"--temperature must be >= 0 (0 = greedy), got {args.temperature}")
    if args.top_k is not None and args.top_k < 0:
        raise ValueError(f"--top-k must be >= 0 (0 = full vocabulary), got {args.top_k}")
    if args.top_p is not None and not 0.0 < args.top_p <= 1.0:
        raise ValueError(f"--top-p must be in (0, 1], got {args.top_p}")
    if args.rep_penalty is not None and not args.rep_penalty > 0.0:
        raise ValueError(f"--rep-penalty must be > 0 (1.0 = off), got {args.rep_penalty}")
    if all(v is None for v in (args.temperature, args.top_k, args.top_p, args.rep_penalty,
                               args.sampling_seed)):
        return None
    return SamplingParams(
        temperature=args.temperature if args.temperature is not None else 1.0,
        top_k=args.top_k or 0,
        top_p=args.top_p if args.top_p is not None else 1.0,
        repetition_penalty=args.rep_penalty if args.rep_penalty is not None else 1.0,
        seed=args.sampling_seed)


def sampling_summary(engine: Engine) -> str:
    """The reference launcher's ``sampling:`` line."""
    p = engine.ecfg.sampling
    return (f"sampling: temperature={p.temperature} top_k={p.top_k} top_p={p.top_p} "
            f"rep_penalty={p.repetition_penalty} "
            f"seed={p.seed if p.seed is not None else 0} "
            f"requests_sampled={engine.requests_sampled}")


def build(args):
    """The model, engine, scheduler and request source ``args`` ask for.
    Raises ValueError for argument combinations the reference's launcher
    refuses, and NotImplementedError for paths the port does not have yet."""
    if args.paged and args.legacy_loop:
        raise ValueError("--legacy-loop is a dense-engine comparison path; "
                         "the paged engine has no per-step loop")
    if args.sync_free and args.legacy_loop:
        raise ValueError("--sync-free and --legacy-loop are mutually exclusive")
    if args.chunked and args.legacy_loop:
        raise ValueError("--chunked and --legacy-loop are mutually exclusive")
    if args.prefix_sharing and not args.paged:
        raise ValueError("--prefix-sharing shares pages of the paged KV pool; "
                         "it requires --paged")
    if args.policy == "memory-aware" and not args.paged:
        raise ValueError("--policy memory-aware prices page-pool occupancy; "
                         "it requires --paged (the dense engine reports none)")
    quantized = args.kv_precision in ("int8", "fp8")
    if args.policy == "precision-aware":
        if not args.paged:
            raise ValueError("--policy precision-aware picks the page region per "
                             "admission; it requires --paged")
        if not quantized:
            raise ValueError("--policy precision-aware needs a quantized page region: "
                             "pass --kv-precision int8 (or fp8)")
        if not 0 < args.quant_pages < args.num_pages:
            raise ValueError("--policy precision-aware admits between regions of a mixed "
                             "pool: pass --quant-pages in (0, num-pages), got "
                             f"{args.quant_pages}/{args.num_pages}")
    if args.quant_pages != -1 and not quantized:
        raise ValueError("--quant-pages sizes the quantized page region; it needs "
                         "--kv-precision int8 (or fp8)")
    if args.quant_pages != -1 and not args.paged:
        raise ValueError("--quant-pages is paged-pool geometry; it requires --paged")
    if not 0.0 <= args.upgrade_at <= args.downgrade_at:
        raise ValueError("hysteresis needs 0 <= --upgrade-at <= --downgrade-at, got "
                         f"{args.upgrade_at} / {args.downgrade_at}")
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
    sampling = sampling_params(args)
    for name in ("chunk_size", "chunk_budget"):
        if getattr(args, name) < 0:
            raise ValueError(f"--{name.replace('_', '-')} must be >= 0, "
                             f"got {getattr(args, name)}")
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
            max_active=args.max_active, eos_id=args.eos_id,
            prefix_sharing=args.prefix_sharing, chunk_size=args.chunk_size,
            chunk_budget=args.chunk_budget, kv_precision=args.kv_precision,
            quant_pages=args.quant_pages, sampling=sampling))
    else:
        engine = Engine(model, EngineConfig(
            batch_slots=args.slots, prompt_len=args.prompt_len,
            cache_len=args.cache_len, eos_id=args.eos_id,
            chunk_size=args.chunk_size, chunk_budget=args.chunk_budget,
            kv_precision=args.kv_precision, sampling=sampling))
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
    elif args.policy == "token-aware":
        sched = TokenAwareScheduler(rates=rates, V=args.V, token_budget=args.token_budget,
                                    tokens_per_request=float(args.prompt_len),
                                    capacity=args.capacity)
    elif args.policy == "precision-aware":
        # the allocator's region tag ("float8_e4m3fn" for fp8): the reference
        # passes the flag's spelling, which names no region for fp8 (ROADMAP R6)
        sched = PrecisionAwareScheduler(
            rates=rates, V=args.V, quant_budget=args.quant_budget,
            downgrade_at=args.downgrade_at, upgrade_at=args.upgrade_at,
            quant_precision=parse_kv_precision(args.kv_precision).tag,
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
                 fused=not args.legacy_loop, sync_free=args.sync_free,
                 chunked=args.chunked)


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


def quant_summary(args, engine: PagedEngine) -> str:
    """The quantized pool's line. ``precision_flips`` counts the flips the
    reference's decision log records; the port has no decision log yet
    (ROADMAP.md queue 1 item 10), so it prints 0, as the reference does
    with telemetry off."""
    c = engine.counters()
    line = (f"quant: precision={args.kv_precision} pages_quant={c['pages_quant']}"
            f"/{engine.allocator.num_pages} quant_occupancy={c['quant_occupancy']:.2f}")
    if args.policy == "precision-aware":
        line += f" admit={engine.admit_precision} precision_flips=0"
    return line


def prefix_summary(engine: PagedEngine) -> str:
    return (f"prefix: hit_tokens={engine.prefix_hits} forks={engine.prefix_forks} "
            f"indexed_pages={len(engine._prefix)} evicted={engine._prefix.evicted_pages}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    engine, sched, src = build(args)
    tr = run(args, engine, sched, src)
    print(summary(args, tr, sched))
    if engine.ecfg.sampling is not None:
        print(sampling_summary(engine))
    if args.paged:
        print(paged_summary(tr, engine))
        if args.kv_precision in ("int8", "fp8"):
            print(quant_summary(args, engine))
        if args.prefix_sharing:
            print(prefix_summary(engine))
    print("latency:", latency_stats(engine))


if __name__ == "__main__":
    main()
