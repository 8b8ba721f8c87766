"""The port's reliability layer (``repro_torch.reliability``, the tenant
workload, ``control/distributed.py::multi_tenant_action`` and the readback
seam) held against the reference's (``repro.reliability``) on the same
seeded inputs.

- Conformal quantiles, ``ConformalSLO``'s Z and q-hat series, the
  degradation ladder's cases (``tests/test_reliability.py``'s) and the
  tenant draws equal the reference's exactly (host float64 and numpy draws
  on both sides).
- ``multi_tenant_action`` equals the reference's jitted vmap on a seeded
  grid (the port's rule is the jitted dispatch's, ROADMAP R4).
- The readback seam: an injected delay leaves tokens, retirement and the
  served count unchanged and counts its waits; a hang raises
  ``ReadbackTimeout`` naming the slot and the rows it held.
- Chaos: for the same config and workload the injector's log is the
  reference's (the reference with its early consume off, R5); forced
  allocator shortfalls defer cleanly; the {dense, paged, shared} x {1, 2}
  matrix under the full fault mix keeps the clean engine's streams,
  retirement and served counts with no page leaked.
- The serve loop and the launcher under ``--tenants ... --policy
  conformal-slo``: trace columns, sheds, the slo: line and the latency
  line equal the reference's, at rest and in overload.
"""
import copy
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro import reliability as ref_rel
from repro.control import FleetRouter as RefRouter
from repro.control.distributed import multi_tenant_action as ref_multi_tenant
from repro.runtime import ReplicaFleet as RefFleet
from repro.runtime import Request as RefRequest
from repro.runtime import RequestSource as RefSource
from repro.runtime import TenantSpec as RefTenantSpec
from repro_torch import obs
from repro_torch import reliability as rel
from repro_torch.control import FleetRouter
from repro_torch.control.distributed import multi_tenant_action
from repro_torch.runtime import ReadbackTimeout, ReplicaFleet, Request, RequestSource, TenantSpec
from test_differential import drive, make_shared_workload, make_workload
from test_torch_chunked import _launch_late
from test_torch_control import _tables
from test_torch_engine import _launch, one_torch_thread  # noqa: F401  (autouse)
from test_torch_obs import _port_engine, _ref_engine

TENANTS = "gold:0.3:1:6,bulk:0.7:0:24"


# ------------------------------------------------------------- conformal
@pytest.mark.parametrize("window", [1, 8, 32, 256])
def test_conformal_quantile_is_the_references(window):
    rng = np.random.default_rng(window)
    ours, ref = rel.ConformalQuantile(window), ref_rel.ConformalQuantile(window)
    for x in np.concatenate([rng.exponential(4.0, 300), rng.integers(0, 9, 100)]):
        ours.push(float(x))
        ref.push(float(x))
        for q in (0.5, 0.9, 0.99):
            assert ours.quantile(q) == ref.quantile(q)
            assert ours.ready(q) == ref.ready(q)
    assert len(ours) == len(ref) and ours.total == ref.total
    np.testing.assert_array_equal(ours.samples(), ref.samples())
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError):
            ours.quantile(bad)
    with pytest.raises(ValueError):
        rel.ConformalQuantile(0)


def _slo_policy(mod):
    tenants = (mod.TenantSLO("gold", deadline_slots=4, quantile=0.9, weight=2.0, priority=1),
               mod.TenantSLO("bulk", deadline_slots=12, quantile=0.5),
               mod.TenantSLO("edge", deadline_slots=1, quantile=0.99, weight=0.5))
    return mod.ConformalSLO(rates=(1.0, 2.0, 4.0, 8.0), V=10.0, tenants=tenants, window=16,
                            slo_gain=1.5)


def test_conformal_slo_series_are_the_references():
    """Seeded (tenant, ttft) batches, unknown tenants and empty slots
    among them: each slot's per-tenant q-hat and Z and the aggregate price
    are the reference's, float for float."""
    ours, ref = _slo_policy(rel), _slo_policy(ref_rel)
    assert ours.vq_cost_per_rate == ref.vq_cost_per_rate == 1.5
    co, cr = ours.init(), ref.init()
    rng = np.random.default_rng(0)
    names = ("gold", "bulk", "edge", "nobody")
    hot = 0
    for t in range(120):
        scale = 10.0 if 30 <= t < 60 else 1.5   # a burst of misses, then recovery
        batch = [(names[int(rng.integers(4))], float(rng.exponential(scale)))
                 for _ in range(int(rng.integers(0, 6)))]
        co, cr = ours.observe(co, list(batch)), ref.observe(cr, list(batch))
        assert co.qhat == cr.qhat and co.z == cr.z and co.value == cr.value
        hot += co.value > 0
    assert hot > 20 and "nobody" not in co.z


def test_conformal_slo_prices_through_the_table_path():
    """The aggregate price enters the argmax as Z * slo_gain * f, Z rounded
    to float32: the port's act is the reference's jitted table dispatch
    over seeded (Q, Z)."""
    from repro.runtime import scheduler as ref_sched

    pol = _slo_policy(rel)
    f, s, lam = (t.numpy() for t in pol.tables())
    rng = np.random.default_rng(1)
    carry = pol.init()
    for _ in range(300):
        carry._value = float(rng.uniform(0, 4)) if rng.random() < 0.7 else float(
            rng.integers(0, 4))
        q = float(rng.integers(0, 40))
        got, _ = pol.act(carry, torch.tensor(q))
        want = ref_sched._act_on_tables(jnp.float32(q), f, s, lam, jnp.float32(pol.V),
                                        jnp.float32(carry.value), jnp.float32(1.5) * f)
        assert float(got) == float(want), (q, carry.value)
    sched = rel.ConformalScheduler(rates=(1.0, 2.0, 4.0), V=10.0,
                                   tenants=(rel.TenantSLO("a", 4),), capacity=16, device="cpu")
    assert sched.control(0) in (1.0, 2.0, 4.0)


# ------------------------------------------------------------- tenant mix
@pytest.mark.parametrize("kw", [dict(), dict(min_prompt_len=3),
                                dict(min_prompt_len=3, long_frac=0.3, long_prompt_len=40)])
def test_tenant_draws_are_the_references(kw):
    """The tagged mix draws after each request's tokens: the same rids,
    prompts, tenants, priorities and deadlines as the reference's source;
    with no tenants the stream is the untagged one."""
    specs = [("gold", 0.25, 1, 6), ("bulk", 0.75, 0, None), ("edge", 0.1, 2, 3)]
    ours = RequestSource(vocab_size=256, prompt_len=16, raw_rate=6, seed=3,
                         tenants=tuple(TenantSpec(*t) for t in specs), **kw)
    ref = RefSource(vocab_size=256, prompt_len=16, raw_rate=6, seed=3,
                    tenants=tuple(RefTenantSpec(*t) for t in specs), **kw)
    key = lambda r: (r.rid, r.arrival_slot, r.tokens.tolist(), r.tenant, r.priority,
                     r.deadline_slots)
    seen = set()
    for t, rate in enumerate(np.random.default_rng(0).uniform(0, 8, 40)):
        a, b = ours.poll(t, float(rate)), ref.poll(t, float(rate))
        assert [key(r) for r in a] == [key(r) for r in b]
        seen |= {r.tenant for r in a}
    assert seen == {"gold", "bulk", "edge"}
    plain = RequestSource(vocab_size=256, prompt_len=16, raw_rate=6, seed=3, **kw)
    assert all(r.tenant == "default" and r.deadline_slots is None for r in plain.poll(0, 6.0))
    with pytest.raises(ValueError):
        RequestSource(vocab_size=64, prompt_len=8, tenants=(TenantSpec("a", frac=0.0),))


# ------------------------------------------------------ degradation ladder
class _FakeEngine:
    """The surface SLOScheduler.admit reads: a queue, rows, finished."""

    def __init__(self, rows=4):
        self.pending, self.active, self.finished = [], [None] * rows, []

    def queue_len(self):
        return len(self.pending)

    def submit(self, reqs):
        self.pending.extend(reqs)


def _req(cls, rid, t, tenant="default", priority=0, deadline=None):
    return cls(rid=rid, arrival_slot=t, tokens=np.zeros(4, np.int32), max_new_tokens=2,
               tenant=tenant, priority=priority, deadline_slots=deadline)


def _ladder(mod, cls, case: str, **kw):
    """One of tests/test_reliability.py's ladder cases on ``mod``'s
    scheduler: what it admitted, shed and recorded."""
    bundle = (obs if mod is rel else ref_obs).observability()
    dev = {"device": "cpu"} if mod is rel else {}
    sched = mod.ConformalScheduler(rates=(1.0, 2.0), V=10.0,
                                   tenants=(mod.TenantSLO("gold", 4, priority=1),),
                                   capacity=8, obs=bundle, **dev, **kw)
    eng = _FakeEngine()
    if case == "level0":
        sched.admit(eng, [_req(cls, 0, 0, "bulk"), _req(cls, 1, 0, "gold", priority=1)], 0)
    elif case == "expire_and_shed":
        eng.pending = [_req(cls, i, 0, "bulk", deadline=3) for i in range(7)]
        sched.admit(eng, [_req(cls, 10, 9, "bulk"), _req(cls, 11, 9, "gold", priority=1)], 9)
    elif case == "uniform":
        eng.pending = [_req(cls, i, 8) for i in range(6)]
        sched.admit(eng, [_req(cls, 10, 9, "bulk"), _req(cls, 11, 9, "bulk")], 9)
    elif case == "cap":
        eng.active = [object()] * 4
        eng.pending = [_req(cls, i, 9) for i in range(8)]
        offer = ([_req(cls, 20 + j, 9, "free", 0) for j in range(2)]
                 + [_req(cls, 25 + j, 9, "bulk", 1) for j in range(2)]
                 + [_req(cls, 30 + j, 9, "gold", 2) for j in range(2)])
        sched.admit(eng, offer, 9)
    elif case == "samples":
        sched.admit(eng, [], 0)
        hit, miss = _req(cls, 0, 0, "gold", 1, 4), _req(cls, 1, 0, "gold", 1, 4)
        hit.first_token_slot, miss.first_token_slot = 2, 9
        eng.finished = [hit, miss]
        sched.control(0)
        sched.control(0)   # samples are not consumed twice
    return {"pending": [r.rid for r in eng.pending], "level": sched.degrade_level,
            "log": sched.shed_log, "counters": sched.counters(), "dropped": sched.dropped,
            "sheds": list(bundle.decisions.sheds), "attainment": sched.attainment(),
            "calib": {k: len(c) for k, c in sched._carry.calib.items()},
            "z": dict(sched._carry.z)}


@pytest.mark.parametrize("case,kw", [("level0", {}), ("expire_and_shed", {}), ("uniform", {}),
                                     ("cap", {"cap_frac": 0.5}), ("samples", {})])
def test_ladder_cases_are_the_references(case, kw):
    got = _ladder(rel, Request, case, **kw)
    assert got == _ladder(ref_rel, RefRequest, case, **kw)
    if case == "expire_and_shed":
        assert got["counters"]["requests_shed_expired"] == 7 and got["level"] >= 1
    if case == "cap":
        assert got["level"] == 2 and got["counters"]["requests_shed_capped"] == 2
    if case == "samples":
        assert got["attainment"] == {"gold": 0.5} and got["calib"]["gold"] == 2


# --------------------------------------------------------- multi-tenant
@pytest.mark.parametrize("seed", range(6))
def test_multi_tenant_action_is_the_references(seed):
    """N tenants' decisions in one batched call against the reference's
    jitted vmap: seeded backlogs (integers, so R4's near-ties occur), per
    tenant utilities and V, shared or per-tenant arrival tables."""
    rng = np.random.default_rng(seed)
    n, a = int(rng.integers(1, 9)), int(rng.integers(2, 11))
    rates = np.arange(1, a + 1, dtype=np.float32)
    kinds = ("linear", "detection", "log")
    util = np.stack([_tables(tuple(range(1, a + 1)), kinds[int(rng.integers(3))])[1]
                     for _ in range(n)]).astype(np.float32)
    lam = (rates * rng.choice([0.5, 1.0, 2.0])).astype(np.float32)
    if seed % 2:
        lam = np.stack([lam * np.float32(rng.choice([1.0, 2.0])) for _ in range(n)])
    V = (rng.choice([1.0, 7.5, 20.0, 50.0], n) if seed % 3 else 20.0)
    for _ in range(40):
        q = rng.integers(0, 80, n).astype(np.float32)
        want = jax.jit(ref_multi_tenant)(jnp.asarray(q), jnp.asarray(rates), jnp.asarray(util),
                                         jnp.asarray(lam), jnp.asarray(V, jnp.float32))
        got = multi_tenant_action(torch.from_numpy(q), torch.from_numpy(rates),
                                  torch.from_numpy(util), torch.as_tensor(lam), V)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------- readback seam
def test_readback_delay_is_invisible_to_tokens():
    reqs, schedule = make_workload(seed=4, n_reqs=6)
    want = drive(_port_engine("dense"), "fused", reqs, schedule)
    for kind in ("dense", "paged"):
        eng = _port_engine(kind)
        chaos = rel.ChaosInjector(seed=1, p_readback_delay=1.0, delay_polls=2).arm(eng)
        streams, retired, (served, finished) = rel.chaos_drive(eng, "sync", reqs, schedule,
                                                               chaos=chaos)
        assert (streams, retired) == want[:2] and served == finished == len(reqs)
        assert chaos.delays_injected > 0 and eng.readback_waits > 0
        assert len(chaos.log) == chaos.delays_injected


def test_readback_hang_raises_readback_timeout():
    eng = _port_engine("dense")
    eng.ecfg.readback_timeout_s = 0.2
    chaos = rel.ChaosInjector(seed=0, p_readback_hang=1.0).arm(eng)
    reqs, schedule = make_workload(seed=3, n_reqs=2)
    with pytest.raises(ReadbackTimeout) as ei:
        rel.chaos_drive(eng, "sync", reqs, schedule, chaos=chaos, max_slots=30)
    err = ei.value
    assert chaos.hangs_injected >= 1 and err.array == "done" and err.timeout_s == 0.2
    assert err.rows and f"slot {err.slot}" in str(err)
    # a bound <= 0 waits for the copy itself: the hang is ignored
    eng = _port_engine("dense")
    eng.ecfg.readback_timeout_s = 0.0
    chaos = rel.ChaosInjector(seed=0, p_readback_hang=1.0).arm(eng)
    assert rel.chaos_drive(eng, "sync", reqs, schedule, chaos=chaos)[2] == (2, 2)


def test_forced_alloc_shortfall_defers_cleanly():
    reqs, schedule = make_workload(seed=5, n_reqs=6)
    want = drive(_port_engine("paged"), "fused", reqs, schedule)
    eng = _port_engine("paged")
    chaos = rel.ChaosInjector(seed=0, shortfall_at=(0, 2)).arm(eng)
    streams, retired, (served, finished) = rel.chaos_drive(eng, "sync", reqs, schedule,
                                                           chaos=chaos)
    assert (streams, retired) == want[:2] and served == finished == len(reqs)
    assert chaos.shortfalls_injected == 2 and eng.alloc_failures >= 1
    rel.assert_no_leaks(eng)


def test_faults_leave_no_half_written_state():
    """A forced shortfall at a slot's first allocation admits nothing: the
    requests stay pending in order, no row or page is taken, and the next
    slot admits them. A forced eviction between slots takes only pages
    the prefix index alone pins: every page a live block table holds keeps
    its reference."""
    reqs = make_shared_workload(seed=8, n_reqs=6)[0]
    eng = _port_engine("paged")
    rel.ChaosInjector(seed=0, shortfall_at=(0,)).arm(eng)
    eng.submit([copy.deepcopy(r) for r in reqs[:3]])
    eng.step_slot_sync(0, n_steps=1)
    assert [r.rid for r in eng.pending] == [0, 1, 2] and eng.alloc_failures == 1
    assert all(r is None for r in eng.active) and eng.allocator.used_pages == 0
    eng.step_slot_sync(1, n_steps=1)
    assert not eng.pending and sum(r is not None for r in eng.active) == 3
    eng = _port_engine("shared")
    chaos = rel.ChaosInjector(seed=0, p_evict_prefix=1.0, evict_pages=64).arm(eng)
    eng.submit([copy.deepcopy(r) for r in reqs])
    for t in range(40):
        chaos.before_slot(t)
        live = [p for row, r in enumerate(eng.active) if r is not None
                for p in eng.allocator.block_table(row)]
        assert all(eng.allocator.refcount(p) >= 1 for p in live)
        eng.allocator.check()
        eng.step_slot_sync(t, n_steps=2)
        if len(eng.finished) == len(reqs):
            break
    eng.drain()
    assert len(eng.finished) == len(reqs) and chaos.evictions_injected > 0
    rel.assert_no_leaks(eng)


# ------------------------------------------------------------------ chaos
def _chaos_cfg(mod, n: int, mode: str):
    """tests/test_reliability.py's matrix config for a cell."""
    return mod.ChaosConfig(
        seed=40 + 3 * n, start_slot=2, p_replica_fail=0.25 if n > 1 else 0.0,
        max_failures=max(n - 1, 1), p_alloc_shortfall=0.1, p_readback_delay=0.25,
        delay_polls=2, p_evict_prefix=0.25 if mode == "shared" else 0.0, evict_pages=2)


def _chaos_run(side: str, cfg, kind: str, n: int, mode: str, reqs, schedule):
    mod, Fleet, Router, mk = ((rel, ReplicaFleet, FleetRouter, _port_engine) if side == "port"
                              else (ref_rel, RefFleet, RefRouter, _ref_engine))
    chaos = mod.ChaosInjector(cfg)
    fleet = Fleet.build(lambda: mk(kind), n, router=Router(kind="drift"), chaos=chaos)
    out = mod.chaos_drive(fleet, mode, reqs, schedule, chaos=chaos)
    mod.assert_no_leaks(fleet)
    return out, chaos


@pytest.mark.parametrize("mode", ["fused", "sync"])
def test_chaos_log_is_the_references(mode):
    """The same fault mix over the same shared-prefix workload on a
    2-replica fleet: the injector's log (every fault, slot-stamped) and
    counters are the reference's, and so are the streams, retirement and
    served counts."""
    reqs, schedule = make_shared_workload(seed=9, n_reqs=8)
    cfg = dict(seed=11, start_slot=1, p_replica_fail=0.3, max_failures=1,
               p_alloc_shortfall=0.1, p_evict_prefix=0.2,
               p_readback_delay=0.3 if mode == "sync" else 0.0, delay_polls=2)
    got, chaos = _chaos_run("port", rel.ChaosConfig(**cfg), "shared", 2, mode, reqs, schedule)
    want, ref = _chaos_run("ref", ref_rel.ChaosConfig(**cfg), "shared", 2, mode, reqs, schedule)
    assert chaos.log == ref.log and chaos.counters() == ref.counters()
    assert got == want
    assert {e["kind"] for e in chaos.log} >= {"alloc_shortfall", "replica_fail"}


_MATRIX = [(kind, n) for kind in ("dense", "paged", "shared") for n in (1, 2)]


@pytest.mark.chaos
@pytest.mark.slow
@pytest.mark.parametrize("kind,n", _MATRIX, ids=[f"{k}-x{n}" for k, n in _MATRIX])
def test_chaos_differential_matrix(kind, n):
    """tests/test_reliability.py's matrix cell on the port: under the full
    fault mix the surviving streams are the clean dense fused engine's bit
    for bit, the same set retires, every request is served once and no page
    leaks; the fault log is the reference fleet's."""
    reqs, schedule = make_shared_workload(seed=100 + n, n_reqs=12)
    clean = drive(_port_engine("dense"), "fused", reqs, schedule)
    (streams, retired, (served, finished)), chaos = _chaos_run(
        "port", _chaos_cfg(rel, n, kind), kind, n, "sync", reqs, schedule)
    assert streams == clean[0], f"stream divergence (chaos: {chaos.log})"
    assert retired == clean[1] and served == finished == len(reqs)
    _, ref = _chaos_run("ref", _chaos_cfg(ref_rel, n, kind), kind, n, "sync", reqs, schedule)
    assert chaos.log == ref.log
    assert chaos.delays_injected > 0 and (chaos.failures_injected > 0 or n == 1)


def test_save_artifacts(tmp_path):
    bundle = obs.observability()
    eng = _port_engine("dense", bundle)
    chaos = rel.ChaosInjector(seed=1, p_readback_delay=1.0).arm(eng)
    rel.chaos_drive(eng, "sync", *make_workload(seed=4, n_reqs=3), chaos=chaos)
    paths = rel.save_artifacts(str(tmp_path), "cell", obs=bundle, chaos=chaos)
    assert [p.rsplit("_", 1)[1] for p in paths] == ["trace.json", "decisions.json", "chaos.json"]


# ------------------------------------------------------------ SLO serving
@pytest.mark.parametrize("argv", [[], ["--raw-rate", "32", "--sync-free"]],
                         ids=["at-rest", "overload-sync-free"])
def test_launcher_slo_lines_match_reference(argv):
    """``--tenants ... --policy conformal-slo``: the summary, slo: and
    latency lines (per-tenant TTFT and attainment) equal the reference
    launcher's, at rest and in overload on the sync-free loop, where the
    ladder expires and sheds (the reference's early consume off, R5)."""
    args = ["--tenants", TENANTS, "--policy", "conformal-slo", *argv]
    with ThreadPoolExecutor(2) as pool:
        ours = pool.submit(_launch, "repro_torch.launch.serve", "--device", "cpu", *args)
        ref = pool.submit(_launch_late, "repro.launch.serve", *args)
        ours, ref = ours.result(), ref.result()
    assert ours == ref
    slo = next(ln for ln in ours if ln.startswith("slo: "))
    if argv:
        assert "shed_expired=0 " not in slo and "shed_priority=0 " not in slo
    assert "'tenants': {'bulk'" in ours[-1]


@pytest.mark.parametrize("argv,match", [
    (["--policy", "conformal-slo"], "needs at least one tenant with a deadline"),
    (["--policy", "conformal-slo", "--tenants", "bulk:1:0:-"], "needs at least one tenant"),
    (["--tenants", "gold:x"], "bad entry"),
    (["--tenants", "gold:0.5:1:0"], "deadline must be > 0"),
    (["--tenants", "gold:-1"], "frac must be > 0"),
    (["--tenants", ":1"], "bad entry"),
    (["--tenants", "gold:0.3:1:6", "--slo-quantile", "1.0"], "--slo-quantile must be in"),
])
def test_launcher_refuses_bad_tenants(argv, match):
    from repro_torch.launch import serve as launcher
    with pytest.raises(ValueError, match=match):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu", *argv])


def test_tenant_parse_is_the_references():
    from repro.launch import serve as ref_launcher
    from repro_torch.launch import serve as launcher

    spec = "gold:0.3:1:6,bulk:0.7:0:24,free::2:-,edge"
    ours = launcher.parse_tenants(spec, 0.95)
    ref = ref_launcher._parse_tenants(spec, 0.95, lambda m: pytest.fail(m))
    assert [tuple(t) if isinstance(t, tuple) else t for t in ours[1]] == list(map(tuple, ref[1]))
    assert [(t.name, t.frac, t.priority, t.deadline_slots) for t in ours[0]] == \
        [(t.name, t.frac, t.priority, t.deadline_slots) for t in ref[0]]
    assert math.isclose(sum(t.frac for t in ours[0]), 3.0)
