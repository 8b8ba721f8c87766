"""The port's replica fleet (``repro_torch.runtime.fleet``) and router
(``repro_torch.control.router``) held against the reference's
(``repro.runtime.fleet``, ``repro.control.router``) on the same seeded
workloads and the same weights.

- The {dense, paged, shared} x {1, 2, 4} matrix of
  ``tests/test_differential.py::test_differential_fleet``: merged streams,
  retirement sets, served-count conservation and every route equal to the
  reference fleet's, and the streams to one port engine's.
- The sampled fast cell (a 2-replica paged fleet, heterogeneous sampling).
- Router decisions against the reference's jitted ``_route_action`` over
  seeded loads with exact ties, affinity discounts and 1e30-masked
  replicas, for every router kind.
- The cases of ``tests/test_fleet.py``, each run on both fleets and
  compared: requeue mid-decode, no page leak mid-prefill, all survivors
  draining, the last routable replica, the last replica cannot fail,
  double drain, drain-then-decode, no starvation per router kind,
  shorter-queue preference, an unroutable fleet, a mixed-mode fleet.
  ``test_fleet_shares_compiles_across_replicas`` has no counterpart: the
  reference's replicas share one jitted executable, while each of the
  port's replicas captures its own CUDA graphs over its own caches.
- The launcher's ``--replicas 2`` lines equal ``python -m
  repro.launch.serve``'s (its early consume off, R5).

The reference's replicas run with their early readback consume off
(``late_consume``, ROADMAP R5), so both fleets retire on the same slots and
route on the same loads.
"""
import copy
import types
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from repro.control import FleetRouter as RefRouter
from repro.control import router as ref_router
from repro.runtime import ReplicaFleet as RefFleet
from repro.runtime.request import Request as RefRequest
from repro_torch.control import ROUTER_KINDS, FleetRouter
from repro_torch.control import router as port_router
from repro_torch.runtime import (Engine, EngineConfig, PagedEngine, PagedEngineConfig,
                                 ReplicaFleet, Request)
from test_differential import _mk_engine as _ref_mk_engine
from test_differential import drive, make_shared_workload, make_workload
from test_torch_chunked import _launch_late, late_consume
from test_torch_engine import _launch, _weights, one_torch_thread  # noqa: F401  (autouse)
from test_torch_sampling import STREAM_TIE, SampledComparator, _port_request


def _port_mk_engine(kind, tight=False, **kw):
    """``test_differential._mk_engine``'s geometry on the port."""
    port = _weights()["port"]
    if kind == "dense":
        return Engine(port, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64, **kw))
    return PagedEngine(port, PagedEngineConfig(
        prompt_len=16, cache_len=64, page_size=8, num_pages=10 if tight else 32, max_active=6,
        prefix_sharing=kind == "shared", **kw))


def _port_side():
    return types.SimpleNamespace(name="port", Fleet=ReplicaFleet, Router=FleetRouter,
                                 Request=Request, engine=_port_mk_engine)


def _ref_side():
    w = _weights()

    def engine(kind, tight=False, **kw):
        return late_consume(_ref_mk_engine(kind, w["cfg"], w["params"], tight=tight, **kw))
    return types.SimpleNamespace(name="ref", Fleet=RefFleet, Router=RefRouter,
                                 Request=RefRequest, engine=engine)


SIDES = {"port": _port_side, "ref": _ref_side}


def _both(scenario, *args):
    """Run ``scenario(side, *args)`` on both fleets; their results must be
    equal. Returns the port's."""
    got, want = scenario(_port_side(), *args), scenario(_ref_side(), *args)
    assert got == want
    return got


def _summary(fleet, drained=0) -> dict:
    """What two fleets must agree on: streams, retirement, conservation,
    the routes and each replica's served count."""
    return {"streams": {r.rid: tuple(r.generated) for r in fleet.finished},
            "served": sum(fleet.served_history) + drained,
            "routed": list(fleet.router.routed),
            "per_replica": [len(e.finished) for e in fleet.replicas],
            "requeues": fleet.requeues}


def _one_engine_streams(reqs) -> dict:
    """One port dense engine on the fused loop: the streams every fleet
    must merge."""
    eng = _port_mk_engine("dense")
    eng.submit([copy.deepcopy(r) for r in reqs])
    t = 0
    while len(eng.finished) < len(reqs) and t < 200:
        eng.step_slot(t, n_steps=2)
        t += 1
    assert len(eng.finished) == len(reqs)
    return {r.rid: tuple(r.generated) for r in eng.finished}


# ------------------------------------------------------------------ matrix
@pytest.mark.parametrize("kind", ["dense", "paged", "shared"])
@pytest.mark.parametrize("n_replicas", [1, 2, 4])
def test_fleet_matches_reference_fleet(kind, n_replicas):
    """A drift-routed fleet of each kind and size against the reference
    fleet on the same trace: every route, the merged streams, the
    retirement set and the served counts are equal, and the streams are
    one engine's. The "shared" kind runs prefix sharing on every replica
    with a common-prefix workload, so affinity routing is in the loop."""
    if kind == "shared":
        reqs, schedule = make_shared_workload(seed=17, n_reqs=12)
    else:
        reqs, schedule = make_workload(seed=17, n_reqs=12)
    out = {}
    for name, side in SIDES.items():
        s = side()
        fleet = s.Fleet.build(lambda s=s: s.engine(kind), n_replicas,
                              router=s.Router(kind="drift"))
        streams, retired, (served, finished) = drive(fleet, "sync", reqs, schedule)
        assert served == finished == len(reqs), name
        out[name] = (streams, retired, list(fleet.router.routed), list(fleet.served_history),
                     [len(e.finished) for e in fleet.replicas])
    assert out["port"] == out["ref"]
    assert out["port"][0] == _one_engine_streams(reqs)
    if n_replicas > 1:
        assert len(set(out["port"][2])) > 1   # the work spread over replicas


def test_sampled_fleet_matches_reference_fleet():
    """The seeded-sampling fast cell: a 2-replica paged fleet routing a
    heterogeneous sampled workload. The routes, retirement and served
    counts equal the reference fleet's; the streams equal its streams but
    at the reference's own near-ties (the request-keyed draws never see
    which replica or row a request landed in)."""
    w = _weights()
    reqs, schedule = make_workload(seed=47, n_reqs=12, sampling=True)
    ref = _ref_side()
    ref_fleet = RefFleet.build(lambda: ref.engine("paged"), 2, router=RefRouter(kind="drift"))
    want, want_retired, _ = drive(ref_fleet, "sync", reqs, schedule)
    fleet = ReplicaFleet.build(lambda: _port_mk_engine("paged"), 2,
                               router=FleetRouter(kind="drift"))
    port_schedule = [(t, [_port_request(r) for r in batch]) for t, batch in schedule]
    got, retired, (served, finished) = drive(fleet, "sync", [_port_request(r) for r in reqs],
                                             port_schedule)
    assert served == finished == len(reqs)
    assert retired == want_retired
    assert fleet.router.routed == ref_fleet.router.routed
    assert fleet.served_history == ref_fleet.served_history
    assert fleet.counters()["requests_sampled"] == ref_fleet.counters()["requests_sampled"] > 0
    SampledComparator(w["params"], w["cfg"], 64, STREAM_TIE).check(
        got, want, {r.rid: r for r in reqs})


# ------------------------------------------------------------------ router
def _ref_route_action(q, s, v) -> int:
    return int(ref_router._route_action(jnp.asarray(q), jnp.asarray(s), jnp.float32(v)))


def test_route_action_matches_the_jitted_reference():
    """The argmax over replicas on seeded loads: integer and 1/32-step
    loads (exact ties, broken to the lowest index), loads that put
    V * S_i - D_i within an ulp of each other, and 1e30 for unroutable
    replicas."""
    rng = np.random.default_rng(0)
    n_ties = 0
    for case in range(300):
        n = int(rng.integers(1, 7))
        if case % 3 == 0:
            loads = rng.integers(0, 6, n) + rng.integers(0, 4, n) / 32.0
        elif case % 3 == 1:
            loads = rng.standard_normal(n) * 4.0
        else:   # V * S_i - D_i equal up to rounding: D_i = V * S_i + c
            loads = None
        rows = rng.choice([4, 6, 8, 16], n).astype(np.float32)
        prefs = (rows / rows.max()).astype(np.float32)
        V = float(rng.choice([0.0, 1.0, 0.3, 20.0]))
        if loads is None:
            loads = np.float32(V) * prefs + np.float32(rng.standard_normal())
        q = np.asarray(loads, np.float32)
        q = np.where(rng.random(n) < 0.2, np.float32(1e30), q).astype(np.float32)
        got = port_router._route_action(q, prefs, V)
        assert got == _ref_route_action(q, prefs, V), (q, prefs, V)
        score = np.float32(V) * prefs - q
        n_ties += int((score == score.max()).sum() > 1)
    assert n_ties > 20


@pytest.mark.parametrize("kind", ROUTER_KINDS)
def test_router_routes_match_reference(kind):
    """Both routers fed the same seeded loads, masks, preferences and
    prefix-affinity probes, request after request: every decision and
    every charged load snapshot are equal."""
    rng = np.random.default_rng(ROUTER_KINDS.index(kind))
    ours, ref = FleetRouter(kind=kind), RefRouter(kind=kind)
    for _ in range(60):
        n = int(rng.integers(1, 6))
        loads = [np.asarray([ours.drift_load(port_router.ReplicaLoad(
            float(rng.integers(0, 6)), float(rng.integers(0, 64)), float(rng.random())))
            for _ in range(n)], np.float32)]
        loads.append(loads[0].copy())
        mask = rng.random(n) < 0.75
        if not mask.any():
            mask[int(rng.integers(n))] = True
        rows = rng.choice([4, 6, 8], n).astype(np.float32)
        prefs = (rows / rows.max()).astype(np.float32)
        for _ in range(int(rng.integers(1, 5))):
            aff = (rng.integers(0, 3, n) * 8).astype(np.float32) if rng.random() < 0.5 else None
            a = ours.route(loads[0], mask, prefs, affinity=aff)
            b = ref.route(loads[1], mask, prefs, affinity=aff)
            assert a == b
            hit = int(aff[a]) if aff is not None else 0
            ours.charge(loads[0], a, 12, hit_tokens=hit)
            ref.charge(loads[1], b, 12, hit_tokens=hit)
            np.testing.assert_array_equal(loads[0], loads[1])
    assert ours.routed == ref.routed and len(set(ours.routed)) > 1


def test_router_rejects_unroutable_fleet():
    r = FleetRouter()
    with pytest.raises(RuntimeError, match="no routable replica"):
        r.route(np.zeros(2, np.float32), [False, False], np.ones(2, np.float32))
    with pytest.raises(ValueError, match="not in"):
        FleetRouter(kind="random")
    # a decision log records the refused route no more than any other: the
    # refusal comes first
    from repro_torch.obs import DecisionLog
    log = DecisionLog()
    with pytest.raises(RuntimeError, match="no routable replica"):
        FleetRouter(decisions=log).route(np.zeros(2, np.float32), [False, False],
                                         np.ones(2, np.float32))
    assert not log.routes


# ------------------------------------------------------ failure and drain
def _workload(seed, n_reqs=10, prompt_hi=16, max_new_hi=8, cls=Request):
    """``tests/test_fleet.py``'s workload, of ``cls`` requests (each
    fleet's own)."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, arrival_slot=0,
                    tokens=rng.integers(0, 256, int(rng.integers(1, prompt_hi + 1)),
                                        dtype=np.int32),
                    max_new_tokens=int(rng.integers(1, max_new_hi + 1)))
            for i in range(n_reqs)]


def _run_to_completion(fleet, reqs, mode="sync", start=0, max_slots=300):
    step = {"sync": fleet.step_slot_sync, "chunked": fleet.step_slot_chunked}[mode]
    t = start
    while len(fleet.finished) < len(reqs) and t < max_slots:
        step(t, n_steps=2)
        t += 1
    return fleet.drain()["served"]


def _mid_decode(s):
    reqs = _workload(seed=1, n_reqs=12, max_new_hi=10, cls=s.Request)
    fleet = s.Fleet.build(lambda: s.engine("dense"), 3, router=s.Router())
    fleet.submit([copy.deepcopy(r) for r in reqs])
    for t in range(2):
        fleet.step_slot_sync(t, n_steps=2)
    victim = fleet.replicas[0]
    held = sorted([r.rid for r in victim.active if r is not None] +
                  [r.rid for r in victim.pending])
    assert held, "the victim must hold in-flight work for the test to bite"
    requeued = fleet.fail_replica(0)
    assert sorted(r.rid for r in requeued) == held
    assert not fleet.alive[0] and not fleet.routable[0]
    drained = _run_to_completion(fleet, reqs, start=2)
    assert len(fleet.finished) == len(reqs)            # nothing double-served
    assert not victim.pending and all(r is None for r in victim.active)
    return {**_summary(fleet, drained), "held": held}


def test_failure_mid_decode_requeues_to_survivors():
    """Kill a replica while its rows decode: every request it held
    finishes on the survivors with the one engine's tokens, exactly once,
    as on the reference fleet."""
    got = _both(_mid_decode)
    reqs = _workload(seed=1, n_reqs=12, max_new_hi=10)
    assert got["streams"] == _one_engine_streams(reqs) and got["served"] == len(reqs)


def _mid_prefill(s):
    reqs = _workload(seed=2, n_reqs=8, prompt_hi=16, max_new_hi=6, cls=s.Request)
    fleet = s.Fleet.build(lambda: s.engine("paged", chunk_size=8), 2, router=s.Router())
    fleet.submit([copy.deepcopy(r) for r in reqs])
    fleet.step_slot_chunked(0, n_steps=1)   # admissions stage cursors
    victim = next((i for i, e in enumerate(fleet.replicas) if e._cursors), None)
    assert victim is not None, "a replica must be mid-prefill"
    fleet.fail_replica(victim)
    dead = fleet.replicas[victim]
    assert dead.allocator.used_pages == 0   # no page leak
    dead.allocator.check()
    assert not dead._cursors and dead._pending_read is None
    drained = _run_to_completion(fleet, reqs, mode="chunked", start=1)
    return {**_summary(fleet, drained), "victim": victim}


def test_failure_mid_prefill_no_page_leak():
    got = _both(_mid_prefill)
    reqs = _workload(seed=2, n_reqs=8, prompt_hi=16, max_new_hi=6)
    assert got["streams"] == _one_engine_streams(reqs) and got["served"] == len(reqs)


def _survivors_draining(s):
    reqs = _workload(seed=10, n_reqs=10, max_new_hi=8, cls=s.Request)
    fleet = s.Fleet.build(lambda: s.engine("dense"), 2, router=s.Router())
    fleet.submit([copy.deepcopy(r) for r in reqs])
    fleet.step_slot_sync(0, n_steps=2)
    fleet.drain_replica(1)            # the only survivor is now draining
    fleet.fail_replica(0)             # must still requeue, not raise or drop
    assert len(fleet.pending) + sum(r is not None for r in fleet.active) \
        + len(fleet.finished) == len(reqs)
    return _summary(fleet, _run_to_completion(fleet, reqs, start=1))


def test_failure_with_all_survivors_draining_loses_nothing():
    got = _both(_survivors_draining)
    reqs = _workload(seed=10, n_reqs=10, max_new_hi=8)
    assert got["streams"] == _one_engine_streams(reqs) and got["served"] == len(reqs)


def _last_routable(s):
    reqs = _workload(seed=11, n_reqs=12, max_new_hi=6, cls=s.Request)
    fleet = s.Fleet.build(lambda: s.engine("dense"), 2, router=s.Router())
    fleet.fail_replica(0)
    fleet.submit([copy.deepcopy(r) for r in reqs])
    fleet.drain_replica(1)
    assert len(fleet.pending) + sum(r is not None for r in fleet.active) \
        + len(fleet.finished) == len(reqs)
    drained = _run_to_completion(fleet, reqs, start=0)
    assert len(fleet.finished) == len(reqs)
    return _summary(fleet, drained)


def test_drain_last_routable_replica_keeps_queue():
    assert _both(_last_routable)["served"] == 12


def test_cannot_fail_last_replica():
    fleet = ReplicaFleet.build(lambda: _port_mk_engine("dense"), 2)
    fleet.fail_replica(1)
    assert fleet.fail_replica(1) == []      # idempotent on a dead replica
    with pytest.raises(RuntimeError, match="last healthy replica"):
        fleet.fail_replica(0)
    with pytest.raises(RuntimeError, match="dead"):
        fleet.drain_replica(1)
    with pytest.raises(RuntimeError, match="dead"):
        fleet.resume_replica(1)


def _double_drain(s):
    reqs = _workload(seed=3, n_reqs=6, cls=s.Request)
    fleet = s.Fleet.build(lambda: s.engine("dense"), 2)
    fleet.submit([copy.deepcopy(r) for r in reqs])
    drained = _run_to_completion(fleet, reqs)
    assert sum(fleet.served_history) + drained == len(reqs)
    assert fleet.drain() == {"served": 0}
    assert fleet.drain() == {"served": 0}
    assert len(fleet.finished) == len(reqs)
    return _summary(fleet, drained)


def test_double_drain_is_noop():
    _both(_double_drain)


def _drain_then_decode(s):
    reqs = _workload(seed=4, n_reqs=16, max_new_hi=10, cls=s.Request)
    fleet = s.Fleet.build(lambda: s.engine("dense"), 2, router=s.Router())
    fleet.submit([copy.deepcopy(r) for r in reqs])
    fleet.step_slot_sync(0, n_steps=2)
    out = fleet.drain_replica(0)
    victim = fleet.replicas[0]
    in_flight = [r.rid for r in victim.active if r is not None]
    assert not victim.pending and out["moved"] >= 0
    extra = _workload(seed=5, n_reqs=4, cls=s.Request)
    for r in extra:
        r.rid += 100
    fleet.submit([copy.deepcopy(r) for r in extra])
    assert victim.queue_len() == 0   # nothing routes to a draining replica
    drained = _run_to_completion(fleet, reqs + extra, start=1)
    assert sum(fleet.served_history) + drained == len(reqs) + len(extra)
    assert {r.rid for r in victim.finished} >= set(in_flight)
    fleet.resume_replica(0)
    assert fleet.routable[0]
    return {**_summary(fleet, drained), "moved": out["moved"], "in_flight": in_flight}


def test_drain_replica_moves_queue_and_keeps_decoding():
    got = _both(_drain_then_decode)
    reqs = _workload(seed=4, n_reqs=16, max_new_hi=10)
    want = _one_engine_streams(reqs)
    assert {rid: s for rid, s in got["streams"].items() if rid < 100} == want


def _burst(s, kind):
    fleet = s.Fleet.build(lambda: s.engine("dense"), 4, router=s.Router(kind=kind))
    rng = np.random.default_rng(6)
    rid = 0
    for t in range(8):
        burst = []
        for _ in range(6):
            burst.append(s.Request(rid=rid, arrival_slot=t,
                                   tokens=rng.integers(0, 256, 8, dtype=np.int32),
                                   max_new_tokens=4))
            rid += 1
        fleet.submit(burst)
        fleet.step_slot_sync(t, n_steps=2)
    t = 8
    while len(fleet.finished) < rid and t < 200:
        fleet.step_slot_sync(t, n_steps=2)
        t += 1
    fleet.drain()
    assert len(fleet.finished) == rid
    per_replica = [len(e.finished) for e in fleet.replicas]
    assert all(n > 0 for n in per_replica), (kind, per_replica)
    return _summary(fleet)


@pytest.mark.parametrize("kind", ROUTER_KINDS)
def test_no_replica_starves_under_sustained_burst(kind):
    _both(_burst, kind)


def _shorter_queue(s):
    fleet = s.Fleet.build(lambda: s.engine("dense"), 2, router=s.Router())
    first = _workload(seed=7, n_reqs=6, cls=s.Request)
    fleet.submit([copy.deepcopy(r) for r in first])   # spreads 3/3
    loaded = max(range(2), key=lambda i: fleet.replicas[i].queue_len()
                 + sum(r is not None for r in fleet.replicas[i].active))
    nxt = copy.deepcopy(first[0])
    nxt.rid = 99
    fleet.submit([nxt])
    assert fleet.router.routed[-1] == 1 - loaded or \
        fleet.replicas[0].queue_len() == fleet.replicas[1].queue_len()
    return list(fleet.router.routed)


def test_drift_router_prefers_shorter_queue():
    _both(_shorter_queue)


def _mixed_modes(s):
    reqs = _workload(seed=9, n_reqs=8, cls=s.Request)
    fleet = s.Fleet([s.engine("dense", chunk_size=4), s.engine("dense")], router=s.Router(),
                    modes=["chunked", "sync"])
    fleet.submit([copy.deepcopy(r) for r in reqs])
    drained = _run_to_completion(fleet, reqs)
    assert sum(fleet.served_history) + drained == len(reqs)
    return _summary(fleet, drained)


def test_mixed_mode_fleet():
    """modes= pins a protocol per replica: a chunked replica and a sync-free
    one serve one workload with the one engine's merged streams."""
    got = _both(_mixed_modes)
    assert got["streams"] == _one_engine_streams(_workload(seed=9, n_reqs=8))
    with pytest.raises(ValueError, match="unknown serving mode"):
        ReplicaFleet([_port_mk_engine("dense")], modes=["warp"])
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicaFleet([], router=FleetRouter())


def test_fleet_surface_and_unported_hooks():
    """The single-engine surface the serve loop and the launcher read, and
    the reference's observability and fault-injection hooks: ``obs=``
    reaches every replica under its index as the trace pid and the
    router's decision log, ``chaos=`` arms every replica and the fleet,
    and ``export_metrics`` publishes per-replica labelled families."""
    fleet = ReplicaFleet.build(lambda: _port_mk_engine("paged"), 2)
    assert fleet.device.type == "cpu" and hasattr(fleet, "occupancy")
    assert fleet.replicas[0].model is fleet.replicas[1].model   # one set of weights
    fleet.warm_decode(2, sync=True)   # nothing to warm on the CPU
    assert fleet.warmup_dispatches == fleet.prefill_warmups == fleet.graph_replays == 0
    c = fleet.counters()
    assert c["replicas"] == c["replicas_alive"] == 2 and c["routed_total"] == 0
    assert not hasattr(ReplicaFleet.build(lambda: _port_mk_engine("dense"), 2), "occupancy")
    from repro_torch.obs import OBS_OFF, observability
    from repro_torch.reliability import ChaosInjector
    bundle, chaos = observability(), ChaosInjector(seed=0)
    watched = ReplicaFleet.build(lambda: _port_mk_engine("paged"), 2, obs=bundle, chaos=chaos)
    assert [e.obs_pid for e in watched.replicas] == [0, 1]
    assert all(e.obs is bundle for e in watched.replicas)
    assert watched.router.decisions is bundle.decisions and watched.chaos is chaos
    assert chaos.engines == watched.replicas and all(e._chaos is chaos for e in watched.replicas)
    watched.export_metrics()
    snap = bundle.registry.snapshot()
    assert snap['repro_steps{replica="1"}'] == 0 and snap["repro_replicas_alive"] == 2
    assert fleet.obs is OBS_OFF and fleet.chaos is None
    fleet.export_metrics()   # no registry: a no-op


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv", [["--replicas", "2"],
                                  ["--paged", "--prefix-sharing", "--replicas", "2"]])
def test_launcher_fleet_lines_match_reference(argv):
    with ThreadPoolExecutor(2) as pool:   # the two launchers side by side
        ours = pool.submit(_launch, "repro_torch.launch.serve", "--device", "cpu", *argv)
        ref = pool.submit(_launch_late, "repro.launch.serve", *argv)
        ours, ref = ours.result(), ref.result()
    assert ours == ref
    assert any(line.startswith("fleet: replicas=2 ") for line in ours)


def test_launcher_refuses_a_fleet_on_the_legacy_loop():
    from repro_torch.launch import serve as launcher
    for argv, match in ((["--replicas", "2", "--legacy-loop"], "single-engine comparison"),
                        (["--replicas", "0"], "--replicas must be >= 1")):
        with pytest.raises(ValueError, match=match):
            launcher.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu", *argv])
