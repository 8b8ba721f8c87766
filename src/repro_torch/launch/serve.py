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

The unscaled storage casts (``kv_precision="float16"``, ``"bfloat16"``,
``"float32"``, ``"float8_e4m3fn"``, or the deprecated
``ModelConfig.cache_dtype``) have no flag here, as the reference's
launcher has none: the engines' configs reach them.

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
``--paged`` refuse it with ValueError, as the reference does. So does
``--arch recurrentgemma-2b``, the hybrid Griffin stack (RG-LRU blocks and
local attention with a window of 2048, head dim 256; its admissions prefill
the whole padded bucket, R7): the dense engine's fused, ``--legacy-loop``
and ``--sync-free`` loops, per-request sampling included, at native KV
precision or with ``--kv-precision int8|fp8`` (its local-attention ring
quantized, read through K2q at head dim 256); ``--chunked`` and
``--paged`` raise the reference's ValueErrors:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --smoke --horizon 12 [--sync-free | --legacy-loop] [--device cpu]

``--replicas N`` serves from a ``ReplicaFleet`` of N equal engines on the
one card (one model, its weights shared; each replica its own cache and
CUDA graphs), requests routed by ``--router``: ``drift`` joins the shortest
drift-plus-penalty queue (request backlog + pending prompt tokens + paged
occupancy, through the one Algorithm-1 argmax), ``round-robin`` and
``least-loaded`` are the classical baselines. It prints a ``fleet:`` line:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --sync-free --replicas 2 --router drift --horizon 12 [--device cpu]

``--tenants name:frac:priority:deadline,...`` tags the workload with a
multi-tenant mix (deadline in slots, ``-`` for none) and prints per-tenant
TTFT and attainment in the latency line; ``--policy conformal-slo`` prices
each tenant's conformal TTFT quantile (``--slo-quantile``, ``--slo-gain``)
and sheds under overload in a fixed ladder, and prints an ``slo:`` line:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --smoke --tenants gold:0.3:1:6,bulk:0.7:0:24 --policy conformal-slo \
      --horizon 12 [--device cpu]

``--metrics`` prints the Prometheus text of every engine counter at
shutdown, ``--trace-out PATH`` writes the request lifecycle as a Chrome
trace (open it in Perfetto) and ``--decisions-out PATH`` saves the
control plane's per-slot Algorithm-1 decompositions. The three share one
``repro_torch.obs.Observability`` bundle through engine, fleet, scheduler
and router, all of it on the host: no token, trace column or graph replay
changes, and nothing synchronizes the card.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.cache import parse_kv_precision
from repro_torch.configs import get_config
from repro_torch.control import ROUTER_KINDS, FleetRouter, LatencyAware
from repro_torch.models import init_params
from repro_torch.models.transformer import check_servable
from repro_torch.obs import OBS_OFF, observability
from repro_torch.reliability import ConformalScheduler, TenantSLO
from repro_torch.runtime import (AdaptiveScheduler, Engine, EngineConfig,
                                 MemoryAwareScheduler, PagedEngine,
                                 PagedEngineConfig, PolicyScheduler,
                                 PrecisionAwareScheduler, ReplicaFleet, RequestSource,
                                 SamplingParams, StaticScheduler, TenantSpec,
                                 TokenAwareScheduler, latency_stats, serve)


def parse_tenants(spec: str, quantile: float) -> tuple:
    """``name:frac:priority:deadline,...`` -> (TenantSpec..., TenantSLO...),
    as the reference's launcher parses it (ValueError for its refusals).
    Tenants with no deadline (empty or ``-``) join the traffic mix but carry
    no SLO virtual queue."""
    sources, slos = [], []
    for part in spec.split(","):
        fields = part.strip().split(":")
        if not (1 <= len(fields) <= 4) or not fields[0]:
            raise ValueError(f"--tenants: bad entry {part!r} "
                             "(want name[:frac[:priority[:deadline]]])")
        name = fields[0]
        try:
            frac = float(fields[1]) if len(fields) > 1 and fields[1] else 1.0
            prio = int(fields[2]) if len(fields) > 2 and fields[2] else 0
            dl = int(fields[3]) if len(fields) > 3 and fields[3] not in ("", "-") else None
        except ValueError as e:
            raise ValueError(f"--tenants: bad entry {part!r} "
                             "(frac float, priority int, deadline int slots)") from e
        if frac <= 0:
            raise ValueError(f"--tenants: {name}: frac must be > 0, got {frac}")
        if dl is not None and dl <= 0:
            raise ValueError(f"--tenants: {name}: deadline must be > 0 slots, got {dl}")
        sources.append(TenantSpec(name=name, frac=frac, priority=prio, deadline_slots=dl))
        if dl is not None:
            slos.append(TenantSLO(name=name, deadline_slots=dl, quantile=quantile,
                                  priority=prio))
    return tuple(sources), tuple(slos)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no card and no --device cpu fails")
    ap.add_argument("--policy", default="adaptive",
                    choices=["adaptive", "static", "latency-aware", "memory-aware",
                             "token-aware", "conformal-slo", "precision-aware"])
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
    ap.add_argument("--tenants", type=str, default=None,
                    help="multi-tenant mix: name:frac:priority:deadline,... (e.g. "
                         "gold:0.3:1:6,bulk:0.7:0:24; deadline in slots, '-' = no SLO). "
                         "Pairs with --policy conformal-slo")
    ap.add_argument("--slo-quantile", type=float, default=0.9,
                    help="conformal-slo: per-tenant attainment target q")
    ap.add_argument("--slo-gain", type=float, default=1.0,
                    help="conformal-slo: price scale on the SLO queues")
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus text of every engine counter at shutdown")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write a Chrome-trace JSON of the request lifecycle (Perfetto)")
    ap.add_argument("--decisions-out", type=str, default=None,
                    help="save the control plane's recorded Algorithm-1 decisions (JSON)")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve from a ReplicaFleet of N equal engines on one card "
                         "(1 = plain single engine)")
    ap.add_argument("--router", choices=list(ROUTER_KINDS), default="drift",
                    help="fleet request routing: drift = join the shortest "
                         "drift-plus-penalty queue")
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


def replicas_of(engine) -> list:
    """The engines behind ``engine``: a fleet's replicas, or itself."""
    return engine.replicas if isinstance(engine, ReplicaFleet) else [engine]


def sampling_summary(engine) -> str:
    """The reference launcher's ``sampling:`` line (summed over replicas)."""
    engines = replicas_of(engine)
    p = engines[0].ecfg.sampling
    return (f"sampling: temperature={p.temperature} top_k={p.top_k} top_p={p.top_p} "
            f"rep_penalty={p.repetition_penalty} "
            f"seed={p.seed if p.seed is not None else 0} "
            f"requests_sampled={sum(e.requests_sampled for e in engines)}")


def fleet_summary(args, fleet: ReplicaFleet) -> str:
    """The reference launcher's ``fleet:`` line."""
    per = [len(e.finished) for e in fleet.replicas]
    return (f"fleet: replicas={args.replicas} router={args.router} "
            f"served_per_replica={per} requeues={fleet.requeues}")


def build(args):
    """The model, engine, scheduler and request source ``args`` ask for
    (with ``--metrics``, ``--trace-out`` or ``--decisions-out`` one
    Observability bundle on all of them, ``engine.obs``). Raises ValueError
    for argument combinations the reference's launcher refuses."""
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
    if args.replicas < 1:
        raise ValueError("--replicas must be >= 1")
    if args.replicas > 1 and args.legacy_loop:
        raise ValueError("--legacy-loop is a single-engine comparison path; "
                         "the fleet steps replicas through the fused protocols")
    for name in ("chunk_size", "chunk_budget"):
        if getattr(args, name) < 0:
            raise ValueError(f"--{name.replace('_', '-')} must be >= 0, "
                             f"got {getattr(args, name)}")
    for name in ("slots", "prompt_len", "cache_len", "page_size", "num_pages",
                 "max_active", "capacity", "horizon", "raw_rate"):
        if getattr(args, name) < 1:
            raise ValueError(f"--{name.replace('_', '-')} must be >= 1, "
                             f"got {getattr(args, name)}")
    if not 0.0 < args.slo_quantile < 1.0:
        raise ValueError(f"--slo-quantile must be in (0, 1), got {args.slo_quantile}")
    sampling = sampling_params(args)
    tenant_specs, tenant_slos = (), ()
    if args.tenants:
        tenant_specs, tenant_slos = parse_tenants(args.tenants, args.slo_quantile)
    if args.policy == "conformal-slo" and not tenant_slos:
        raise ValueError("--policy conformal-slo needs at least one tenant with a deadline "
                         "via --tenants (e.g. gold:0.3:1:6,bulk:0.7:0:24)")

    cfg = get_config(args.arch, smoke=args.smoke)
    check_servable(cfg)   # before the weights: the encoder-decoder is not served (R12)
    model = init_params(cfg, seed=0, device=args.device)
    obs = observability() if telemetry(args) else OBS_OFF
    sched_obs = obs if telemetry(args) else None
    if args.paged:
        mk_engine = lambda: PagedEngine(model, PagedEngineConfig(
            prompt_len=args.prompt_len, cache_len=args.cache_len,
            page_size=args.page_size, num_pages=args.num_pages,
            max_active=args.max_active, eos_id=args.eos_id,
            prefix_sharing=args.prefix_sharing, chunk_size=args.chunk_size,
            chunk_budget=args.chunk_budget, kv_precision=args.kv_precision,
            quant_pages=args.quant_pages, sampling=sampling), obs=obs)
    else:
        mk_engine = lambda: Engine(model, EngineConfig(
            batch_slots=args.slots, prompt_len=args.prompt_len,
            cache_len=args.cache_len, eos_id=args.eos_id,
            chunk_size=args.chunk_size, chunk_budget=args.chunk_budget,
            kv_precision=args.kv_precision, sampling=sampling), obs=obs)
    if args.replicas > 1:   # the replicas share the one model's weights
        router = FleetRouter(kind=args.router,
                             decisions=obs.decisions if telemetry(args) else None)
        engine = ReplicaFleet.build(mk_engine, args.replicas, router=router, obs=sched_obs)
    else:
        engine = mk_engine()
    rates = tuple(float(f) for f in range(1, args.raw_rate + 1))
    if args.policy == "adaptive":
        sched = AdaptiveScheduler(rates=rates, V=args.V, capacity=args.capacity, obs=sched_obs)
    elif args.policy == "latency-aware":
        sched = PolicyScheduler(
            policy=LatencyAware(rates=rates, V=args.V, cost_gain=1.0,
                                cost_budget=args.cost_budget),
            capacity=args.capacity, obs=sched_obs)
    elif args.policy == "memory-aware":
        sched = MemoryAwareScheduler(rates=rates, V=args.V,
                                     occupancy_budget=args.occupancy_budget,
                                     capacity=args.capacity, obs=sched_obs)
    elif args.policy == "token-aware":
        sched = TokenAwareScheduler(rates=rates, V=args.V, token_budget=args.token_budget,
                                    tokens_per_request=float(args.prompt_len),
                                    capacity=args.capacity, obs=sched_obs)
    elif args.policy == "conformal-slo":
        sched = ConformalScheduler(rates=rates, V=args.V, tenants=tenant_slos,
                                   slo_gain=args.slo_gain, capacity=args.capacity,
                                   obs=sched_obs)
    elif args.policy == "precision-aware":
        # the allocator's region tag ("float8_e4m3fn" for fp8): the reference
        # passes the flag's spelling, which names no region for fp8 (ROADMAP R6)
        sched = PrecisionAwareScheduler(
            rates=rates, V=args.V, quant_budget=args.quant_budget,
            downgrade_at=args.downgrade_at, upgrade_at=args.upgrade_at,
            quant_precision=parse_kv_precision(args.kv_precision).tag,
            capacity=args.capacity, obs=sched_obs)
    else:
        sched = StaticScheduler(rate=args.rate, capacity=args.capacity, obs=sched_obs)
    src = RequestSource(vocab_size=cfg.vocab_size, prompt_len=args.prompt_len,
                        raw_rate=args.raw_rate, max_new_tokens=4,
                        min_prompt_len=args.min_prompt_len, tenants=tenant_specs or None)
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


def paged_summary(tr: dict, engine) -> str:
    """The reference launcher's ``paged:`` line: peaks by the worst
    replica, failures and preemptions summed over replicas."""
    engines = replicas_of(engine)
    st = [e.allocator.stats() for e in engines]
    return (f"paged: peak_occupancy={float(tr['occupancy'].max()):.2f} "
            f"peak_pages={max(s.peak_used_pages for s in st)}/{st[0].num_pages} "
            f"peak_active={max(e.peak_active for e in engines)} "
            f"alloc_failures={sum(e.alloc_failures for e in engines)} "
            f"preemptions={sum(e.preemptions for e in engines)}")


def telemetry(args) -> bool:
    return bool(args.metrics or args.trace_out or args.decisions_out)


def quant_summary(args, engine) -> str:
    """The quantized pool's line, each replica's quantized occupancy
    joined by commas. ``precision_flips`` counts the latch flips the
    decision log recorded (0 with telemetry off, as the reference prints)."""
    engines = replicas_of(engine)
    c = [e.counters() for e in engines]
    line = (f"quant: precision={args.kv_precision} pages_quant={c[0]['pages_quant']}"
            f"/{engines[0].allocator.num_pages} quant_occupancy="
            + ",".join(f"{x['quant_occupancy']:.2f}" for x in c))
    if args.policy == "precision-aware":
        flips = len(engine.obs.decisions.precisions) if telemetry(args) else 0
        line += f" admit={engines[0].admit_precision} precision_flips={flips}"
    return line


def slo_summary(sched) -> str:
    """The reference launcher's ``slo:`` line."""
    c = sched.counters()
    att = sched.attainment()
    return (f"slo: degrade_level={c['degrade_level']} pressure={c['slo_pressure']:.2f} "
            f"shed_expired={c['requests_shed_expired']} "
            f"shed_priority={c['requests_shed_priority']} "
            f"shed_capped={c['requests_shed_capped']} attainment="
            + ",".join(f"{k}:{v:.3f}" for k, v in sorted(att.items())))


def telemetry_lines(args, engine, sched) -> list:
    """Export the counters into the registry (the SLO scheduler's too) and
    return the reference launcher's telemetry output: the Prometheus text
    (``--metrics``), the ``trace:`` line (``--trace-out``, the file
    written) and the ``decisions:`` line (``--decisions-out``)."""
    obs = engine.obs
    engine.export_metrics()
    if args.policy == "conformal-slo":
        obs.export(sched.counters())
    out = []
    if args.metrics:
        out.append(obs.registry.prometheus_text().removesuffix("\n"))
    if args.trace_out:
        out.append(f"trace: {obs.trace.save(args.trace_out)} "
                   f"({len(obs.trace)} events, {obs.trace.dropped} dropped)")
    if args.decisions_out:
        out.append(f"decisions: {obs.decisions.save(args.decisions_out)} "
                   f"({len(obs.decisions.rates)} rate, {len(obs.decisions.routes)} route)")
    return out


def prefix_summary(engine) -> str:
    engines = replicas_of(engine)
    return (f"prefix: hit_tokens={sum(e.prefix_hits for e in engines)} "
            f"forks={sum(e.prefix_forks for e in engines)} "
            f"indexed_pages={sum(len(e._prefix) for e in engines)} "
            f"evicted={sum(e._prefix.evicted_pages for e in engines)}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    engine, sched, src = build(args)
    tr = run(args, engine, sched, src)
    print(summary(args, tr, sched))
    if replicas_of(engine)[0].ecfg.sampling is not None:
        print(sampling_summary(engine))
    if args.replicas > 1:
        print(fleet_summary(args, engine))
    if args.paged:
        print(paged_summary(tr, engine))
        if args.kv_precision in ("int8", "fp8"):
            print(quant_summary(args, engine))
        if args.prefix_sharing:
            print(prefix_summary(engine))
    if args.policy == "conformal-slo":
        print(slo_summary(sched))
    print("latency:", latency_stats(engine))
    if telemetry(args):
        for line in telemetry_lines(args, engine, sched):
            print(line)


if __name__ == "__main__":
    main()
