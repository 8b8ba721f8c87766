"""The port's sync-free loop against the reference's: ``control_async``'s
one-slot lag, ``step_slot_sync``'s streams, serve trace and ``drain``, the
cases of tests/test_sync_free.py (consume timing, admission-time
finishers, the ring capacity guard, EOS, zero blocking syncs within the
dispatch budget), the readback watchdog, and the launcher's --sync-free
summary line."""
import copy

import jax  # noqa: F401  (JAX stays on the CPU)
import numpy as np
import pytest

from repro.control import DriftPlusPenalty as RefDriftPlusPenalty
from repro.runtime import AdaptiveScheduler as RefAdaptive
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import PolicyScheduler as RefPolicyScheduler
from repro.runtime import RequestSource as RefSource
from repro.runtime import StaticScheduler as RefStatic
from repro.runtime import serve as ref_serve
from repro_torch.control import DriftPlusPenalty
from repro_torch.runtime import (AdaptiveScheduler, Engine, EngineConfig, PolicyScheduler,
                                 ReadbackTimeout, RequestSource, StaticScheduler, serve)
from test_torch_chunked import _launch_late, late_consume
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    MARGIN, MarginComparator, _launch, _weights, one_torch_thread)

RATES = tuple(float(f) for f in range(1, 9))
COLUMNS = ("rate", "backlog", "served", "active", "dropped", "dispatches", "syncs")


def _reqs(w, n, max_new=6, seed=3, ragged=False):
    src = RequestSource(vocab_size=w["cfg"].vocab_size, prompt_len=16,
                        min_prompt_len=2 if ragged else None, raw_rate=n,
                        max_new_tokens=max_new, seed=seed)
    return src.poll(0, float(n))


def _dense(w, **kw):
    return Engine(w["port"], EngineConfig(batch_slots=4, prompt_len=16, cache_len=64, **kw))


def _drive(eng, reqs, mode, n_steps=2, max_slots=80):
    """Serve ``reqs`` to completion with one step mode; the streams."""
    eng.submit([copy.deepcopy(r) for r in reqs])
    step = {"step": eng.step, "fused": eng.step_slot, "sync": eng.step_slot_sync}[mode]
    t = 0
    while len(eng.finished) < len(reqs) and t < max_slots:
        if mode == "step":
            step(t)
        else:
            step(t, n_steps=n_steps)
        t += 1
    if mode == "sync":
        eng.drain()
    assert len(eng.finished) == len(reqs)
    return {r.rid: r.generated for r in eng.finished}


# ----------------------------------------------------------------- control
def test_control_async_is_lagged_control():
    """control_async(t) returns control's decision of slot t-1 (seeded with
    slot 0's own), as the reference's does; Static stays constant."""
    backlogs = [0, 3, 9, 40, 2, 0, 17]
    sync = PolicyScheduler(policy=DriftPlusPenalty(rates=RATES, V=50.0), device="cpu")
    want = [sync.control(q) for q in backlogs]
    sch = PolicyScheduler(policy=DriftPlusPenalty(rates=RATES, V=50.0), device="cpu")
    got = [sch.control_async(q) for q in backlogs]
    assert got[0] == want[0]
    assert got[1:] == want[:-1]
    assert len(set(want)) > 1
    ref_sch = RefPolicyScheduler(policy=RefDriftPlusPenalty(rates=RATES, V=50.0))
    assert got == [ref_sch.control_async(q) for q in backlogs]
    st = StaticScheduler(rate=4.0, device="cpu")
    assert [st.control_async(q) for q in backlogs] == [4.0] * len(backlogs)
    assert [RefStatic(rate=4.0).control_async(q) for q in backlogs] == [4.0] * len(backlogs)


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("ragged", [False, True])
def test_sync_free_matches_fused_and_reference(ragged):
    """step_slot_sync's streams equal the port's fused loop's and the
    reference's step_slot_sync (margin comparator)."""
    w = _weights()
    reqs = _reqs(w, 8, ragged=ragged)
    fused = _drive(_dense(w), reqs, "fused")
    sync = _drive(_dense(w), reqs, "sync")
    assert sync == fused
    ref = late_consume(RefEngine(w["cfg"], w["params"], RefEngineConfig(
        batch_slots=4, prompt_len=16, cache_len=64)))
    ref.submit([copy.deepcopy(r) for r in reqs])
    for t in range(80):
        if len(ref.finished) == len(reqs):
            break
        ref.step_slot_sync(t, n_steps=2)
    ref.drain()
    MarginComparator(w["params"], w["cfg"], 64, MARGIN).check(
        sync, {r.rid: r.generated for r in ref.finished}, {r.rid: r.tokens for r in reqs})


@pytest.mark.parametrize("min_prompt_len", [None, 5])
def test_sync_free_serve_trace_matches_reference(min_prompt_len):
    """The serve trace (lagged served counts, drain folded into the last
    slot), the counters and the streams equal the reference's."""
    w = _weights()
    kw = dict(batch_slots=4, prompt_len=16, cache_len=64)
    src_kw = dict(vocab_size=w["cfg"].vocab_size, prompt_len=16, raw_rate=5,
                  max_new_tokens=4, min_prompt_len=min_prompt_len)
    rates = tuple(float(f) for f in range(1, 6))
    ref = late_consume(RefEngine(w["cfg"], w["params"], RefEngineConfig(**kw)))
    ref_tr = ref_serve(ref, RefAdaptive(rates=rates, V=20.0, capacity=32), RefSource(**src_kw),
                       horizon=12, steps_per_slot=2, sync_free=True)
    ours = Engine(w["port"], EngineConfig(**kw))
    tr = serve(ours, AdaptiveScheduler(rates=rates, V=20.0, capacity=32, device="cpu"),
               RequestSource(**src_kw), horizon=12, steps_per_slot=2, sync_free=True)
    for col in COLUMNS:
        np.testing.assert_array_equal(tr[col], ref_tr[col], err_msg=col)
    assert int(tr["served"].sum()) == len(ours.finished) > 0     # drain folded in
    ref_c = ref.counters()
    ref_c["readback_waits"] = 0        # the reference's counts its wall-clock misses
    assert ours.counters() == ref_c
    MarginComparator(w["params"], w["cfg"], 64, MARGIN).check(
        {r.rid: r.generated for r in ours.finished},
        {r.rid: r.generated for r in ref.finished}, {r.rid: r.tokens for r in ours.finished})


class _LateEvent:
    """A packet's event that reports its copy in flight for ``polls``
    queries (``None``: forever)."""

    def __init__(self, polls):
        self.polls = polls

    def query(self):
        if self.polls is None:
            return False
        self.polls -= 1
        return self.polls < 0

    def synchronize(self):
        self.polls = 0


def _late_packets(eng, pattern):
    """Give each posted packet an event that stays in flight for the next
    entry of ``pattern`` polls."""
    import itertools
    pat = itertools.cycle(pattern)
    post = eng._post_readback

    def late(now, served_steps):
        post(now, served_steps)
        eng._pending_read["event"] = _LateEvent(next(pat))
    eng._post_readback = late
    return eng


@pytest.mark.parametrize("pattern", [(0,), (3,), (0, 2), (1, 0, 0)])
def test_sync_free_consume_timing_never_changes_tokens(pattern):
    """Copies that land late (the consumer polls their event, counting an
    overlap miss) or at once give identical tokens: the consume point, not
    the copy's timing, decides retirement (the reference's interleavings
    test, with its forced early/late consume replaced by forced copy
    delays; ROADMAP R5). The admission epochs keep a stale done flag from
    retiring a freshly admitted request."""
    w = _weights()
    reqs = _reqs(w, 12, ragged=True, seed=7)
    want = _drive(_dense(w), reqs, "fused")
    eng = _late_packets(_dense(w), pattern)
    assert _drive(eng, reqs, "sync") == want
    assert (eng.readback_waits > 0) == any(pattern)


def test_sync_free_zero_blocking_syncs_and_dispatch_budget():
    """0 dispatch-gating syncs per slot (the fused loop pays >= 1) within
    <= 1 prefill + 1 decode dispatch per slot."""
    w = _weights()

    def serve_with(sync_free):
        eng = _dense(w)
        src = RequestSource(vocab_size=w["cfg"].vocab_size, prompt_len=16, raw_rate=5,
                            max_new_tokens=4)
        tr = serve(eng, AdaptiveScheduler(rates=RATES, V=20.0, capacity=32, device="cpu"),
                   src, horizon=15, steps_per_slot=3, sync_free=sync_free)
        return eng, tr

    eng_s, tr_s = serve_with(True)
    assert eng_s.blocking_syncs == 0 and int(tr_s["syncs"].max()) == 0
    assert int(tr_s["dispatches"].max()) <= 2
    assert int(tr_s["served"].sum()) == len(eng_s.finished) > 0
    eng_f, tr_f = serve_with(False)
    assert eng_f.blocking_syncs >= 15 and int(tr_f["syncs"].min()) >= 1


def test_eos_stops_generation_identically():
    """Device-side EOS == host EOS: learn a token the model emits, declare
    it EOS, and require step / step_slot / step_slot_sync to agree and to
    stop at its first occurrence."""
    w = _weights()
    reqs = _reqs(w, 4, max_new=10, seed=5)
    eos = _drive(_dense(w), reqs, "fused")[reqs[0].rid][2]
    legacy1 = _drive(_dense(w, eos_id=eos), reqs, "step")
    legacy2 = _drive(_dense(w, eos_id=eos), reqs, "fused", n_steps=3)
    sync = _drive(_dense(w, eos_id=eos), reqs, "sync", n_steps=3)
    assert legacy1 == legacy2 == sync
    g0 = sync[reqs[0].rid]
    assert g0[-1] == eos and eos not in g0[:-1] and len(g0) < 10


@pytest.mark.parametrize("max_new", [1, 2])
def test_sync_admission_instant_finish(max_new):
    """The prefill's token alone (or one decode step) completes the
    request; the admission-time finishers fold into step 0's count."""
    w = _weights()
    reqs = _reqs(w, 4, max_new=max_new)
    fused = _drive(_dense(w), reqs, "fused")
    eng = _dense(w)
    eng.submit([copy.deepcopy(r) for r in reqs])
    per_step = []
    for t in range(6):
        per_step.append(eng.step_slot_sync(t, n_steps=2)["served_per_step"])
    assert not eng.drain()["served"]
    assert {r.rid: r.generated for r in eng.finished} == fused
    assert all(len(g) == max_new for g in fused.values())
    # all four finish in slot 0's dispatch (at admission for max_new 1) and
    # are retired at slot 1: step 0's count carries them
    assert per_step[1] == [4, 0] and sum(eng.served_history) == len(reqs)


def test_gen_buf_capacity_guard():
    w = _weights()
    eng = _dense(w, gen_buf_len=4)
    eng.submit(_reqs(w, 1, max_new=9))
    with pytest.raises(ValueError, match="gen_buf_len"):
        eng.step_slot_sync(0)
    assert len(eng.pending) == 1          # the raise popped nothing
    with pytest.raises(ValueError, match="gen_buf_len"):
        eng.step_slot_chunked(0)
    assert len(eng.pending) == 1


def test_readback_timeout_names_the_wedged_packet():
    """A packet whose copy never lands raises ReadbackTimeout after
    ``readback_timeout_s`` instead of hanging, naming the slot and the
    rows whose retirement it carried."""
    w = _weights()
    eng = _dense(w, readback_timeout_s=0.05)
    eng.submit(_reqs(w, 2, max_new=4))
    eng.step_slot_sync(0, n_steps=2)
    eng._pending_read["event"] = _LateEvent(None)
    with pytest.raises(ReadbackTimeout) as err:
        eng.drain()
    assert err.value.slot == 0 and err.value.rows == [0, 1]
    assert err.value.timeout_s == 0.05 and "not ready after 0.05s" in str(err.value)


# ---------------------------------------------------------------- launcher
def test_launcher_sync_free_line_matches_reference():
    ours = _launch("repro_torch.launch.serve", "--device", "cpu", "--sync-free")
    ref = _launch_late("repro.launch.serve", "--sync-free")
    assert ours[0] == ref[0]
    assert ours[0].endswith("blocking_syncs_per_slot=0.00")
    assert ours[1] == ref[1]  # the latency dict too
