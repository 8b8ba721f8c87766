"""The port's observability (``repro_torch.obs`` and its hooks in the
engines, scheduler, fleet, router and launcher) held against the
reference's (``repro.obs``) on the same seeded inputs.

- Metrics: the Prometheus text is byte for byte the reference's for the
  same counter dicts, labels and histograms, and round-trips through
  ``parse_prometheus``; the registry refuses what the reference refuses.
- Trace: the Chrome-trace export of the same emits is the reference's,
  timestamps excluded (every ``ts`` and ``dur``: the host clock).
- Lifecycle: both engines in the fused, sync-free and chunked loops record
  the reference engine's events (kind, rid, slot, pid, in order; the
  reference with its early consume off, ROADMAP R5) and the same dispatch
  and readback events per slot; the fleet adds the reference's routes and
  requeues. Tokens and trace columns are equal with telemetry on and off.
- Decisions: every record's argmax is the port's dispatch on
  ``tests/test_torch_control.py``'s grid (its 3 rate sets x 5 values of V
  x 301 backlogs), where the reference's own log parts from its dispatch
  at the R4 near-ties (its host recompute rounds V*S before it subtracts);
  ``replay_rollout`` equals ``control/rollout.py::rollout`` bit for bit
  for every table policy and both capacities; the scheduler records every
  decision, the sync-free loop's one slot lagged.
- The launcher's ``--metrics``, ``--trace-out`` and ``--decisions-out``
  lines equal ``python -m repro.launch.serve``'s (the file paths aside).
"""
import copy
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import PagedEngine as RefPagedEngine
from repro.runtime import PagedEngineConfig as RefPagedEngineConfig
from repro.runtime import ReplicaFleet as RefFleet
from repro_torch import obs
from repro_torch.control import (DriftPlusPenalty, FleetRouter, LatencyAware, MemoryAware,
                                 Static, TokenBacklogAware, drift_plus_penalty_action, rollout)
from repro_torch.runtime import (AdaptiveScheduler, Engine, EngineConfig, MemoryAwareScheduler,
                                 PagedEngine, PagedEngineConfig, ReplicaFleet, RequestSource,
                                 StaticScheduler, serve)
from test_differential import make_shared_workload, make_workload
from test_torch_chunked import late_consume
from test_torch_control import _tables
from test_torch_engine import COLUMNS, _launch, _weights, one_torch_thread  # noqa: F401

LIFECYCLE = ("arrival", "admission", "chunk", "activation", "preemption", "raced_hit",
             "retirement", "route", "requeue")


# ------------------------------------------------------------------ metrics
def _counters(seed: int) -> dict:
    """A seeded ``Engine.counters()``-shaped dict: integer totals, float
    levels, a bool and a string (both skipped by the export)."""
    rng = np.random.default_rng(seed)
    c = {k: int(rng.integers(0, 10**6)) for k in
         ("steps", "requests_finished", "prefill_dispatches", "decode_dispatches",
          "blocking_syncs", "requests_active", "pages_used", "peak_pages")}
    c.update({k: float(rng.random()) for k in ("occupancy", "occupancy_hwm", "slo_pressure",
                                               "quant_occupancy")})
    c.update(degrade_level=int(rng.integers(0, 3)), flag=True, name="granite")
    return c


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("labels", [None, {"replica": "1"}, {"replica": "0", "zone": "a"}])
def test_prometheus_text_is_the_references(seed, labels):
    ours, ref = obs.MetricsRegistry(), ref_obs.MetricsRegistry()
    for k in range(2):   # a repeated export overwrites, never double-counts
        c = _counters(seed + 10 * k)
        obs.export_counters(ours, c, labels)
        ref_obs.export_counters(ref, c, labels)
    h, rh = (r.histogram("repro_ttft_slots", "ttft", buckets=(1.0, 2.5, 8.0)) for r in (ours, ref))
    for x in np.random.default_rng(seed).exponential(3.0, 20):
        h.observe(float(x))
        rh.observe(float(x))
    text = ours.prometheus_text()
    assert text == ref.prometheus_text()
    # the text carries %g's six digits: the round trip is exact to those
    assert ours.snapshot() == ref.snapshot()
    assert obs.parse_prometheus(text) == ref_obs.parse_prometheus(text) == \
        {k: float(format(float(v), "g")) for k, v in ours.snapshot().items()}
    tag = ",".join(f'{k}="{v}"' for k, v in sorted((labels or {}).items()))
    assert ours.snapshot()["repro_steps" + (f"{{{tag}}}" if tag else "")] == c["steps"]
    assert ours._metrics["repro_occupancy"].kind == "gauge"
    assert "repro_name" not in text and "repro_flag" not in text


def test_registry_refusals_are_the_references():
    for mod in (obs, ref_obs):
        reg = mod.MetricsRegistry()
        c = reg.counter("repro_widgets_total", "widgets", labels=("replica",))
        c.inc(replica="0")
        assert reg.counter("repro_widgets_total", labels=("replica",)) is c
        with pytest.raises(ValueError):
            reg.gauge("repro_widgets_total", labels=("replica",))
        with pytest.raises(ValueError):
            reg.counter("repro_widgets_total", labels=("zone",))
        with pytest.raises(ValueError):
            c.inc(zone="us")
        with pytest.raises(ValueError):
            mod.MetricsRegistry().counter("bad name")
        assert mod.parse_prometheus("# just a comment\n\n") == {}
        for bad in ("no_value_here", "name{unclosed 3", 'm{k="v"} notafloat', "m{k=unquoted} 3"):
            with pytest.raises(ValueError):
                mod.parse_prometheus(bad)
    assert obs.GAUGE_KEYS == ref_obs.GAUGE_KEYS and obs.DEFAULT_BUCKETS == ref_obs.DEFAULT_BUCKETS


# -------------------------------------------------------------------- trace
def _no_clock(doc: dict) -> dict:
    """A Chrome trace with its host-clock fields (ts, dur) taken out."""
    return {**doc, "traceEvents": [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                                   for e in doc["traceEvents"]]}


def test_chrome_trace_structure_is_the_references():
    rng = np.random.default_rng(5)
    ours, ref = obs.TraceRecorder(capacity=24), ref_obs.TraceRecorder(capacity=24)
    for i in range(40):   # overflows: 16 dropped, oldest first
        kind = obs.EVENT_KINDS[int(rng.integers(len(obs.EVENT_KINDS)))]
        kw = dict(slot=int(rng.integers(0, 9)), rid=int(rng.integers(0, 50)),
                  row=int(rng.integers(0, 4)) if rng.random() < 0.7 else None,
                  pid=int(rng.integers(0, 3)))
        if kind in ("dispatch", "readback"):
            kw.update(ts=float(i), dur=float(rng.random()), what="decode", n=2)
        for r in (ours, ref):
            r.emit(kind, **kw)
    assert len(ours) == len(ref) == 24 and ours.dropped == ref.dropped == 16
    assert _no_clock(ours.chrome_trace()) == _no_clock(ref.chrome_trace())
    json.dumps(ours.chrome_trace())
    assert obs.EVENT_KINDS == ref_obs.EVENT_KINDS
    with pytest.raises(ValueError):
        obs.TraceRecorder(capacity=0)
    assert obs.NULL_TRACE.enabled is False and obs.OBS_OFF.enabled is False
    obs.NULL_TRACE.emit("arrival", rid=1)
    assert len(obs.NULL_TRACE) == 0 and obs.observability().enabled


# --------------------------------------------------------------- lifecycle
def _port_engine(kind: str, obs_=None, chunked: bool = False):
    port = _weights()["port"]
    cs = 4 if chunked else 0
    if kind == "dense":
        return Engine(port, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64,
                                         chunk_size=cs), obs=obs_)
    return PagedEngine(port, PagedEngineConfig(
        prompt_len=16, cache_len=64, page_size=8, num_pages=10 if kind == "tight" else 32,
        max_active=6, prefix_sharing=kind == "shared", chunk_size=cs), obs=obs_)


def _ref_engine(kind: str, obs_=None, chunked: bool = False):
    w = _weights()
    cs = 4 if chunked else 0
    if kind == "dense":
        eng = RefEngine(w["cfg"], w["params"], RefEngineConfig(
            batch_slots=4, prompt_len=16, cache_len=64, chunk_size=cs), obs=obs_)
    else:
        eng = RefPagedEngine(w["cfg"], w["params"], RefPagedEngineConfig(
            prompt_len=16, cache_len=64, page_size=8, num_pages=10 if kind == "tight" else 32,
            max_active=6, prefix_sharing=kind == "shared", chunk_size=cs), obs=obs_)
    return late_consume(eng)


def _drive(eng, mode: str, reqs, schedule, n_steps: int = 2, max_slots: int = 300):
    """``test_differential.drive`` that also returns each slot's stats."""
    step = {"fused": eng.step_slot, "sync": eng.step_slot_sync,
            "chunked": eng.step_slot_chunked}[mode]
    sched = {t: [copy.deepcopy(r) for r in batch] for t, batch in schedule}
    t, stats = 0, []
    while (len(eng.finished) < len(reqs) or t <= max(sched)) and t < max_slots:
        if t in sched:
            eng.submit(sched[t])
        m = step(t, n_steps=n_steps)
        stats.append((m["served"], m["active"], m.get("admitted", 0)))
        t += 1
    if mode != "fused":
        eng.drain()
    assert len(eng.finished) == len(reqs)
    return {r.rid: tuple(r.generated) for r in eng.finished}, stats


def _lifecycle(rec) -> list:
    return [(e["kind"], e["rid"], e["slot"], e["pid"]) for e in rec.events()
            if e["kind"] in LIFECYCLE]


def _per_slot(rec, kind: str) -> dict:
    """Events of ``kind`` per (slot, what)."""
    out: dict = {}
    for e in rec.events():
        if e["kind"] == kind:
            key = (e["slot"], e.get("what"))
            out[key] = out.get(key, 0) + 1
    return out


CELLS = [(k, m) for k in ("dense", "paged", "shared") for m in ("fused", "sync", "chunked")]


@pytest.mark.parametrize("kind,mode", CELLS, ids=[f"{k}-{m}" for k, m in CELLS])
def test_lifecycle_events_are_the_references(kind, mode):
    """One seeded workload through the reference engine and the port's,
    both recording: the lifecycle events and the dispatch and readback
    events per slot are equal; with telemetry off the port's tokens and
    per-slot stats are the ones it served with it on."""
    reqs, schedule = (make_shared_workload(seed=31, n_reqs=10) if kind == "shared"
                      else make_workload(seed=31, n_reqs=10))
    chunked = mode == "chunked"
    ours, ref = obs.observability(), ref_obs.observability()
    got, stats = _drive(_port_engine(kind, ours, chunked), mode, reqs, schedule)
    _drive(_ref_engine(kind, ref, chunked), mode, reqs, schedule)
    assert _lifecycle(ours.trace) == _lifecycle(ref.trace)
    for k in ("dispatch", "readback"):
        assert _per_slot(ours.trace, k) == _per_slot(ref.trace, k), k
    kinds = {e["kind"] for e in ours.trace.events()}
    assert kinds <= set(obs.EVENT_KINDS) and {"arrival", "admission", "retirement"} <= kinds
    assert ("chunk" in kinds) == chunked
    assert _drive(_port_engine(kind, None, chunked), mode, reqs, schedule) == (got, stats)


@pytest.mark.parametrize("kind,mode,seed", [("tight", "chunked", 9), ("tight", "fused", 7),
                                            ("shared", "chunked", 21)])
def test_preemption_and_fork_events_are_the_references(kind, mode, seed):
    """A tight paged pool's decode preemptions and a shared pool's
    copy-on-write forks: the events and dispatches the reference records."""
    reqs, schedule = (make_shared_workload if kind == "shared" else make_workload)(
        seed=seed, n_reqs=12)
    ours, ref = obs.observability(), ref_obs.observability()
    chunked = mode == "chunked"
    _drive(_port_engine(kind, ours, chunked), mode, reqs, schedule)
    _drive(_ref_engine(kind, ref, chunked), mode, reqs, schedule)
    assert _lifecycle(ours.trace) == _lifecycle(ref.trace)
    assert _per_slot(ours.trace, "dispatch") == _per_slot(ref.trace, "dispatch")
    if kind == "tight":
        assert any(e["kind"] == "preemption" for e in ours.trace.events())
    else:
        assert any(w == "fork" for _, w in _per_slot(ours.trace, "dispatch"))


def _serve(kind: str, obs_, sync_free=False, chunked=False, policy="adaptive"):
    eng = _port_engine(kind, obs_, chunked)
    rates = tuple(float(f) for f in range(1, 6))
    sched = (MemoryAwareScheduler(rates=rates, V=20.0, device="cpu", obs=obs_)
             if policy == "memory-aware" else
             AdaptiveScheduler(rates=rates, V=20.0, capacity=32, device="cpu", obs=obs_))
    src = RequestSource(vocab_size=_weights()["cfg"].vocab_size, prompt_len=16, raw_rate=5,
                        max_new_tokens=4, min_prompt_len=5)
    tr = serve(eng, sched, src, horizon=10, steps_per_slot=2, sync_free=sync_free,
               chunked=chunked)
    reqs = eng.finished + [r for r in eng.active if r is not None]
    return tr, {r.rid: r.generated for r in reqs}, sched, eng


@pytest.mark.parametrize("kind,loop", [("dense", "fused"), ("paged", "sync"),
                                       ("dense", "chunked")])
def test_serve_is_the_same_with_telemetry_on(kind, loop):
    """The serve loop with every collector on: the trace columns and the
    tokens are those of the run with telemetry off, every control slot has
    one rate record, and the metrics export parses."""
    kw = dict(sync_free=loop == "sync", chunked=loop == "chunked")
    bundle = obs.observability()
    on, toks_on, sched, eng = _serve(kind, bundle, **kw)
    off, toks_off, _, eng_off = _serve(kind, None, **kw)
    for col in COLUMNS:
        np.testing.assert_array_equal(on[col], off[col], err_msg=col)
    assert toks_on == toks_off and eng.counters() == eng_off.counters()
    recs = list(bundle.decisions.rates)
    assert [r["chosen"] for r in recs] == sched.rate_history
    assert [r["t"] for r in recs] == list(range(10))
    ev = bundle.trace.events()
    assert sum(e["kind"] == "retirement" for e in ev) == len(eng.finished)
    assert sum(e["kind"] == "arrival" for e in ev) == len(eng.finished) + len(eng.pending) + \
        sum(r is not None for r in eng.active)
    eng.export_metrics()
    snap = obs.parse_prometheus(bundle.registry.prometheus_text())
    assert snap["repro_requests_finished"] == len(eng.finished)


def test_fleet_routes_requeues_and_labelled_export():
    """A 2-replica paged fleet with the bundle: routes recorded with their
    score vectors and traced per replica, a failure's requeues traced, and
    the labelled export's per-replica families beside the fleet's own, as
    the reference fleet records and exports them."""
    reqs = make_workload(seed=12, n_reqs=8)[0]
    out = {}
    for name, Fleet, mk in (("port", ReplicaFleet, _port_engine),
                            ("ref", RefFleet, _ref_engine)):
        bundle = obs.observability() if name == "port" else ref_obs.observability()
        router = FleetRouter() if name == "port" else __import__(
            "repro.control", fromlist=["FleetRouter"]).FleetRouter()
        fleet = Fleet.build(lambda: mk("paged"), 2, router=router, obs=bundle)
        fleet.submit([copy.deepcopy(r) for r in reqs])
        fleet.step_slot_sync(0, n_steps=1)
        moved = fleet.fail_replica(next(i for i, e in enumerate(fleet.replicas)
                                        if any(r is not None for r in e.active)))
        t = 1
        while len(fleet.finished) < len(reqs) and t < 60:
            fleet.step_slot_sync(t, n_steps=2)
            t += 1
        fleet.drain()
        fleet.export_metrics()
        snap = bundle.registry.snapshot()
        out[name] = {"events": [(e["kind"], e["rid"], e.get("row"), e["pid"])
                                for e in bundle.trace.events() if e["kind"] in LIFECYCLE],
                     "routes": [(r["rid"], r["chosen"], r["scores"]) for r in
                                bundle.decisions.routes],
                     "moved": len(moved),
                     # readback_waits aside: the reference counts one when
                     # JAX's asynchronous copy has not landed (wall clock, R5)
                     "snap": {k: v for k, v in snap.items()
                              if not k.startswith("repro_readback_waits") and (
                                  "replica=" in k or k.split("{")[0] in (
                                      "repro_replicas", "repro_requeues",
                                      "repro_routed_total"))}}
    assert out["port"] == out["ref"]
    snap = out["port"]["snap"]
    assert out["port"]["moved"] > 0 and len(out["port"]["routes"]) > len(reqs)
    assert snap["repro_replicas"] == 2 and snap["repro_requeues"] == out["port"]["moved"]
    assert snap['repro_requests_finished{replica="0"}'] + \
        snap['repro_requests_finished{replica="1"}'] == len(reqs)


def test_counters_key_sets_and_export():
    dense, paged = _port_engine("dense"), _port_engine("paged")
    assert set(dense.counters()) == set(paged.counters())
    bundle = obs.observability()
    eng = _port_engine("dense", bundle)
    _drive(eng, "sync", *make_workload(seed=3, n_reqs=5))
    eng.export_metrics()
    snap = obs.parse_prometheus(bundle.registry.prometheus_text())
    assert snap["repro_requests_finished"] == 5 == len(eng.finished)
    assert snap["repro_steps"] == eng.counters()["steps"]
    assert bundle.registry._metrics["repro_requests_active"].kind == "gauge"
    dense.export_metrics()   # OBS_OFF: no registry, a no-op


# --------------------------------------------------------------- decisions
@pytest.mark.parametrize("V", [1.0, 7.5, 20.0, 50.0, 123.4])
@pytest.mark.parametrize("rates", [tuple(range(1, 6)), tuple(range(1, 11)),
                                   (1.0, 2.0, 4.0, 8.0)])
def test_record_argmax_is_the_dispatch_on_the_grid(rates, V):
    """``explain_tables``' argmax and T* are the port's dispatch on every
    backlog of the grid; the reference's host recompute parts from its own
    jitted dispatch at the R4 near-ties, which the port's log does not."""
    f, s, lam = _tables(rates)
    backlog = np.arange(0, 301, dtype=np.float32)
    want, want_T = drift_plus_penalty_action(torch.from_numpy(backlog), torch.from_numpy(f),
                                             torch.from_numpy(s), torch.from_numpy(lam), V)
    got = [obs.explain_tables(float(q), f, s, lam, V) for q in backlog]
    np.testing.assert_array_equal([g["argmax"] for g in got], want.numpy())
    np.testing.assert_array_equal([g["T_star"] for g in got], want_T.numpy())
    for g in got:   # the record's own decomposition explains its argmax
        assert g["T"][list(g["rates"]).index(g["argmax"])] == g["T"].max()


def test_reference_log_parts_from_its_dispatch_at_r4_ties():
    """Q = 4, V = 20, F = 1..5 (ROADMAP R4): both dispatches pick f = 3;
    the reference's log explains f = 1, the port's f = 3."""
    from repro.runtime import scheduler as ref_sched

    f, s, lam = _tables(tuple(range(1, 6)))
    ref_rate = float(ref_sched._act_on_tables(np.float32(4.0), f, s, lam, np.float32(20.0),
                                              np.float32(0.0), np.zeros_like(f)))
    assert ref_rate == obs.explain_tables(4.0, f, s, lam, 20.0)["argmax"] == 3.0
    assert ref_obs.explain_tables(4.0, f, s, lam, 20.0)["argmax"] == 1.0


def test_record_argmax_with_a_virtual_queue():
    """With a price Z * cost(f), the record's argmax is the dispatch's over
    seeded (Q, Z), exact ties included (integer Z on integer tables)."""
    f, s, lam = _tables(tuple(range(1, 11)))
    rng = np.random.default_rng(0)
    backlog = rng.integers(0, 60, 400).astype(np.float32)
    vq = np.where(rng.random(400) < 0.5, rng.integers(0, 6, 400),
                  rng.uniform(0, 5, 400)).astype(np.float32)
    cost = np.float32(2.0) * f
    want, _ = drift_plus_penalty_action(
        torch.from_numpy(backlog), torch.from_numpy(f), torch.from_numpy(s),
        torch.from_numpy(lam), 20.0,
        torch.from_numpy(vq).double()[:, None] * torch.from_numpy(cost).double())
    got = [obs.explain_tables(float(q), f, s, lam, 20.0, vq=float(z), cost_tab=cost)["argmax"]
           for q, z in zip(backlog, vq)]
    np.testing.assert_array_equal(got, want.numpy())


_POLICIES = [
    Static(rate=4.0),
    DriftPlusPenalty(rates=(1.0, 2.0, 4.0, 8.0), V=20.0),
    DriftPlusPenalty(rates=(1.0, 2.0, 4.0, 8.0), V=0.5),
    LatencyAware(rates=(1.0, 2.0, 4.0, 8.0), V=20.0, cost_gain=1.0, cost_budget=3.0),
    MemoryAware(rates=(1.0, 2.0, 4.0, 8.0), V=20.0),
    TokenBacklogAware(rates=(1.0, 2.0, 4.0, 8.0), V=20.0),
]


@pytest.mark.parametrize("policy", _POLICIES, ids=lambda p: type(p).__name__)
@pytest.mark.parametrize("capacity", [np.inf, 40.0])
def test_replay_rollout_bit_identical(policy, capacity):
    """The recording host replay is the port's rollout, bit for bit: its
    backlog, rate and virtual-queue series and the log's Fig.-2 series."""
    mus = np.random.default_rng(42).uniform(0.0, 6.0, 48).astype(np.float32)
    ref = rollout(policy, mus, capacity=capacity, device="cpu")
    got = obs.replay_rollout(policy, mus, capacity=capacity)
    np.testing.assert_array_equal(ref["backlog"].numpy(), got["backlog"])
    np.testing.assert_array_equal(ref["rate"].numpy(), got["rate"])
    if "vq" in ref:
        np.testing.assert_array_equal(ref["vq"].numpy(), got["vq"])
    s = got["log"].rate_series()
    assert len(got["log"].rates) == len(mus)
    np.testing.assert_array_equal(s["backlog"], got["backlog"])
    np.testing.assert_array_equal(s["rate"], got["rate"])


def test_scheduler_records_every_decision():
    """Synchronous control: each record's chosen is the applied rate and its
    argmax; sync-free control applies the previous slot's decision, so
    each record's argmax is the next slot's applied rate; Static records
    no decomposition and is never lagged. A virtual queue's Z is recorded
    as it priced the decision."""
    for fn in ("control", "control_async"):
        bundle = obs.observability()
        sched = AdaptiveScheduler(rates=(1.0, 2.0, 4.0, 8.0), V=10.0, device="cpu", obs=bundle)
        applied = [getattr(sched, fn)(q) for q in (0, 3, 50, 50, 9, 30, 0, 100)]
        recs = list(bundle.decisions.rates)
        assert applied == sched.rate_history == [r["chosen"] for r in recs]
        if fn == "control":
            assert all(r["chosen"] == r["argmax"] and not r["lagged"] for r in recs)
        else:
            assert all(r["lagged"] for r in recs)
            assert [r["argmax"] for r in recs[:-1]] == applied[1:]
            assert any(r["chosen"] != r["argmax"] for r in recs)
    bundle = obs.observability()
    st = StaticScheduler(rate=5.0, device="cpu", obs=bundle)
    st.control_async(10)
    assert not bundle.decisions.rates[0]["lagged"] and bundle.decisions.rates[0]["rates"] == ()
    bundle = obs.observability()
    mem = MemoryAwareScheduler(rates=(1.0, 2.0, 4.0), V=10.0, device="cpu", obs=bundle)
    for q, occ in ((0, 0.9), (3, 0.95), (7, 0.2), (2, 0.99)):
        z = float(mem._carry.value) if hasattr(mem._carry, "value") else 0.0
        mem.control(q, occupancy=occ)
        z_after_observe = max(np.float32(z) + np.float32(occ) - np.float32(0.6), np.float32(0.0))
        assert bundle.decisions.rates[-1]["vq"] == float(z_after_observe)
        assert bundle.decisions.rates[-1]["argmax"] == bundle.decisions.rates[-1]["chosen"]


@pytest.mark.parametrize("fn", ["control", "control_async"])
def test_virtual_queue_records_are_the_references(fn):
    """PrecisionAware over seeded backlogs and occupancies, on the port's
    scheduler and the reference's: the same rate records (t, backlog, Z as
    priced, chosen, lagged; the argmax the port's dispatch, which is the
    reference's but at R4 near-ties) and the same latch-flip records. On
    the sync-free loop a tensor Z rides the decision's readback, so a
    record lands a slot late and ``flush_decisions`` writes the last."""
    from repro.runtime import scheduler as ref_sched
    from repro_torch.runtime import PrecisionAwareScheduler

    kw = dict(rates=(1.0, 2.0, 3.0, 4.0, 5.0), V=20.0, quant_budget=0.3, downgrade_at=0.5,
              upgrade_at=0.3)
    ours, ref = obs.observability(), ref_obs.observability()
    a = PrecisionAwareScheduler(device="cpu", obs=ours, **kw)
    b = ref_sched.PrecisionAwareScheduler(obs=ref, **kw)
    rng = np.random.default_rng(2)
    for _ in range(40):
        q, occ, qocc = int(rng.integers(0, 30)), float(rng.random()), float(rng.random())
        assert getattr(a, fn)(q, occupancy=occ, quant_occupancy=qocc) == \
            getattr(b, fn)(q, occupancy=occ, quant_occupancy=qocc)
        assert a.admit_precision(occ) == b.admit_precision(occ)
    assert len(ours.decisions.rates) == 40 - (fn == "control_async")
    a.flush_decisions()
    key = ("t", "backlog", "vq", "V", "chosen", "lagged", "rates")
    got, want = list(ours.decisions.rates), list(ref.decisions.rates)
    assert [tuple(r[k] for k in key) for r in got] == [tuple(r[k] for k in key) for r in want]
    assert sum(r["vq"] > 0 for r in got) > 10
    f, s, lam = (t.numpy() for t in a.policy.tables())
    cost = np.float32(a.policy.vq_cost_per_rate) * f
    for r in got:
        want_f, _ = drift_plus_penalty_action(
            torch.tensor(r["backlog"]), *(torch.from_numpy(x) for x in (f, s, lam)), 20.0,
            torch.tensor(np.float32(r["vq"])).double() * torch.from_numpy(cost).double())
        assert r["argmax"] == float(want_f)
    assert list(ours.decisions.precisions) == list(ref.decisions.precisions)
    assert len(ours.decisions.precisions) >= 2


def test_decision_log_json_round_trip(tmp_path):
    log = obs.DecisionLog(capacity=4)
    for t in range(6):
        log.record_rate(t=t, backlog=float(t), vq=0.0, V=20.0, chosen=float(t % 3),
                        rates=(1.0, 2.0), drift=(-1.0, -2.0), penalty=(3.0, 4.0), argmax=2.0)
    assert len(log.rates) == 4 and log.rates[0]["t"] == 2
    log.record_route(rid=9, chosen=1, scores=np.asarray([0.5, 1.5]), loads=[2.0, 1.0],
                     kind="drift", V=20.0)
    log.record_shed(t=3, rid=4, tenant="gold", priority=1, reason="expired", level=1, waited=7)
    back = obs.DecisionLog.load(log.save(str(tmp_path / "d.json")))
    assert back.to_json() == json.loads(json.dumps(log.to_json()))
    assert back.route_counts(2).tolist() == [0, 1]
    assert "<-- chosen" in log.explain_rate(-1)


# ---------------------------------------------------------------- launcher
def test_launcher_telemetry_lines_match_reference(tmp_path):
    """``--metrics --trace-out --decisions-out`` on the main path: the
    summary, the latency dict, the Prometheus text and the trace: and
    decisions: lines (event and record counts) equal the reference
    launcher's, the file paths aside; the two Chrome traces are equal but
    for their clocks."""
    paths = {n: (str(tmp_path / f"{n}_trace.json"), str(tmp_path / f"{n}_dec.json"))
             for n in ("port", "ref")}
    with ThreadPoolExecutor(2) as pool:
        ours = pool.submit(_launch, "repro_torch.launch.serve", "--device", "cpu", "--metrics",
                           "--trace-out", paths["port"][0], "--decisions-out", paths["port"][1])
        ref = pool.submit(_launch, "repro.launch.serve", "--metrics",
                          "--trace-out", paths["ref"][0], "--decisions-out", paths["ref"][1])
        ours, ref = ours.result(), ref.result()
    norm = lambda lines, n: [ln.replace(paths[n][0], "T").replace(paths[n][1], "D")
                             for ln in lines]
    assert norm(ours, "port") == norm(ref, "ref")
    assert any(ln.startswith("# TYPE repro_requests_finished counter") for ln in ours)
    assert ours[-2].startswith("trace: ") and ours[-1].startswith("decisions: ")
    docs = [json.load(open(paths[n][0])) for n in ("port", "ref")]
    assert _no_clock(docs[0]) == _no_clock(docs[1])
    dec = json.load(open(paths["port"][1]))
    assert [r["argmax"] for r in dec["rates"]] == [r["chosen"] for r in dec["rates"]]
