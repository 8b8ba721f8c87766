"""The port's chunked continuous batching against the reference's: the plain
chunk attention (K4's plain version) against the reference's Pallas kernel
in interpret mode and its oracle, ``chunk_step`` with the reference's
weights carried across, ``TokenBacklogAware`` against the reference
scheduler's dispatch, ``step_slot_chunked`` over the schedules of
tests/test_differential.py, {fused, sync-free, chunked} inside the port,
and the launcher's chunked summary lines."""
import os
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.models import model as RM
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import TokenAwareScheduler as RefTokenAwareScheduler
from repro_torch.control import TokenBacklogAware
from repro_torch.kernels import chunk_attention as k_chunk
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.runtime import Engine, EngineConfig, TokenAwareScheduler
from test_differential import drive, make_workload
from test_torch_engine import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    MARGIN, SRC, MarginComparator, _launch, _weights, one_torch_thread)
from test_torch_paged import _ref_dispatch

# float32 on both sides; the softmaxes differ only in summation order
ATOL = 2e-5
# the model tolerance of tests/test_torch_model.py: summation order and the
# transcendental functions leave ~1e-6 on the logits and caches after two
# layers (measured 1.0e-6 and 2.9e-6 here)
TOL = dict(atol=1e-4, rtol=1e-4)


def late_consume(engine):
    """The reference engine with its opportunistic early consume off: the
    reference consumes a readback packet before the next slot's admission
    when ``is_ready()`` says its copy has landed, which on this CPU happens
    only when the host outruns JAX's asynchronous dispatch, so its schedule
    depends on the wall clock (ROADMAP R5). The port always consumes after
    the next dispatch, the reference's usual path here."""
    engine._readback_ready = lambda p: False
    return engine


# ---------------------------------------------------------------- K4 plain
def chunk_case(rng, B, C, L, H, KVH, hd):
    """Rows: a first chunk (pos0 0), a mid-prompt chunk with a hole in its
    prefix, a partial final chunk (valid < C) and an inactive row (valid
    0). Each row's cache holds positions 0..pos0+valid-1 in order; slots
    beyond the written prefix, and the hole, are empty (slot_pos -1) and
    hold +-1e30 garbage, so a version that reads them fails. Numpy arrays."""
    pos0 = np.asarray([0, C, 2 * C + 3, C][:B], np.int32)
    valid = np.asarray([C, C, C - 3, 0][:B], np.int32)
    sp = np.full((B, L), -1, np.int32)
    for b in range(B):
        n = int(pos0[b] + valid[b]) if valid[b] else int(pos0[b])
        sp[b, :n] = np.arange(n)
    sp[1, 2] = -1
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    junk = np.where(rng.random((B, L, KVH, hd)) < 0.5, -1e30, 1e30).astype(np.float32)
    empty = (sp < 0)[..., None, None]
    return q, np.where(empty, junk, k), np.where(empty, -junk, v), sp, pos0, valid


@pytest.mark.parametrize("B,C,L,H,KVH,hd", [(4, 8, 32, 4, 2, 32), (4, 4, 24, 8, 2, 32),
                                            (3, 16, 64, 4, 4, 64), (4, 8, 40, 4, 1, 32)])
def test_plain_chunk_attention_matches_pallas_and_oracle(B, C, L, H, KVH, hd):
    q, k, v, sp, pos0, valid = chunk_case(np.random.default_rng(L + C), B, C, L, H, KVH, hd)
    got = ops.chunk_attention(*(torch.from_numpy(a) for a in (q, k, v, sp, pos0, valid)))
    got = got.numpy()
    pal = ref_ops.chunk_attention(q, k, v, sp, pos0, valid, impl="interpret", block_l=8)
    ora = ref_oracles.chunk_attention_ref(q, k, v, sp, pos0, valid)
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ora), atol=ATOL, rtol=0)
    for b, n in enumerate(valid):
        assert not got[b, n:].any()    # rows at or beyond valid are zeros (all of row 3)


def test_chunk_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, sp, pos0, valid = (torch.from_numpy(a) for a in chunk_case(
        np.random.default_rng(0), 2, 4, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        k_chunk.chunk_attention(q, k, v, sp, pos0, valid)


def test_chunk_write_targets_list_the_valid_pairs():
    pos0 = torch.tensor([0, 5, 30, 2], dtype=torch.int32)
    w = A.chunk_write_targets(pos0, torch.tensor([3, 0, 4, 1], dtype=torch.int32), 4, 32)
    assert w.keep.nonzero().tolist() == [[0, 0], [0, 1], [0, 2], [2, 0], [2, 1], [2, 2],
                                         [2, 3], [3, 0]]
    assert w.pos[w.keep].tolist() == [0, 1, 2, 30, 31, 32, 33, 2]
    assert w.slots[w.keep].tolist() == [0, 1, 2, 30, 31, 0, 1, 2]   # the ring wraps
    assert w.pos.dtype == torch.int32 and w.pos.shape == w.slots.shape == (4, 4)
    for row in w.slots:   # every row's C targets distinct: no scatter index repeats
        assert len(set(row.tolist())) == 4
    assert w.cols is None


def test_a_chunk_wider_than_the_ring_keeps_each_slots_last_column():
    """C > cache_len: one target per ring slot (no scatter index repeats),
    each taking the last valid column that lands there, what writing the
    chunk's columns one by one into the ring leaves."""
    C, L = 11, 4
    pos0 = torch.tensor([0, 6, 3, 2, 9], dtype=torch.int32)
    valid = torch.tensor([11, 6, 0, 3, 4], dtype=torch.int32)
    w = A.chunk_write_targets(pos0, valid, C, L)
    assert w.slots.shape == w.pos.shape == w.keep.shape == w.cols.shape == (5, L)
    for b in range(5):
        ring = {}
        for c in range(int(valid[b])):
            ring[(int(pos0[b]) + c) % L] = (c, int(pos0[b]) + c)
        assert len(set(w.slots[b].tolist())) == L
        got = {int(s): (int(c), int(p)) for s, c, p, k
               in zip(w.slots[b], w.cols[b], w.pos[b], w.keep[b]) if k}
        assert got == ring, b


# ------------------------------------------------------------- chunk_step
# (pos0, valid, reset) per chunk over three rows: row 0 a prompt in three
# chunks; row 1 a short prompt in one partial chunk, then idle; row 2 idle,
# then a new tenant over the boot prefill's cache (reset) in two chunks
CHUNKS = [([0, 0, 0], [8, 5, 0], [1, 1, 0]),
          ([8, 5, 0], [8, 0, 8], [0, 0, 1]),
          ([16, 5, 8], [3, 0, 6], [0, 0, 0])]


def test_chunk_step_matches_reference():
    w = _weights()
    cfg, params, port = w["cfg"], w["params"], w["port"]
    B, P, L, C = 3, 16, 32, 8
    rng = np.random.default_rng(0)
    _, rstate = RM.prefill(params, {"tokens": jnp.zeros((B, P), jnp.int32)}, cfg, L)
    _, state = M.prefill(port, torch.zeros((B, P), dtype=torch.int32), L)
    for pos0, valid, reset in CHUNKS:
        toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        pos0, valid = np.asarray(pos0, np.int32), np.asarray(valid, np.int32)
        reset = np.asarray(reset, bool)
        rlogits, rstate = RM.chunk_step(params, rstate, jnp.asarray(toks), jnp.asarray(pos0),
                                        jnp.asarray(valid), jnp.asarray(reset), cfg)
        logits, state = M.chunk_step(port, state, torch.from_numpy(toks),
                                     torch.from_numpy(pos0), torch.from_numpy(valid),
                                     torch.from_numpy(reset))
        live = valid > 0
        np.testing.assert_allclose(logits.numpy()[live], np.asarray(rlogits)[live], **TOL)
        np.testing.assert_array_equal(state.pos.numpy(), np.asarray(rstate.pos))
        np.testing.assert_array_equal(state.last_tok.numpy(), np.asarray(rstate.last_tok))
        for name in ("k", "v", "slot_pos"):
            np.testing.assert_allclose(getattr(state.caches[0], name).numpy(),
                                       np.asarray(getattr(rstate.caches[0], name)),
                                       err_msg=name, **TOL)


# ----------------------------------------------------------------- policy
@pytest.mark.parametrize("V,n_rates,tpr", [(20.0, 5, 2.0), (50.0, 10, 16.0), (7.5, 5, 3.0)])
def test_token_aware_matches_reference_dispatch(V, n_rates, tpr):
    """TokenBacklogAware's decision against the reference scheduler's
    jitted dispatch over backlog x Z, including exact ties (V = 20, F =
    1..5, price 2f: Q + 2Z = 4; V = 7.5, price 3f, Q = 0, Z = 0.5, which
    needs the reference's two roundings, ROADMAP R4)."""
    rates = tuple(float(x) for x in range(1, n_rates + 1))
    pol = TokenBacklogAware(rates=rates, V=V, tokens_per_request=tpr)
    f, s, lam = (t.numpy() for t in pol.tables())
    zs = np.concatenate([np.arange(0, 6, 0.25), np.random.default_rng(1).uniform(0, 3, 12)])
    carry = pol.init()
    for z in zs.astype(np.float32):
        carry = carry._replace(value=torch.tensor(z))
        for q in range(0, 41):
            got = float(pol.act(carry, torch.tensor(float(q)))[0])
            assert got == _ref_dispatch(q, z, f, s, lam, V, pol.vq_cost_per_rate), (q, z)


@pytest.mark.parametrize("asynchronous", [False, True])
def test_token_aware_scheduler_matches_reference(asynchronous):
    """The scheduler observes the token backlog before it acts; the
    virtual queue and the (lagged, with control_async) rates follow the
    reference's."""
    rng = np.random.default_rng(4)
    backlog = rng.integers(0, 30, 120)
    tokens = rng.integers(0, 130, 120)     # around the budget: Z rises and drains
    rates = tuple(float(x) for x in range(1, 6))
    kw = dict(rates=rates, V=20.0, token_budget=64.0, tokens_per_request=2.0)
    ours, ref = TokenAwareScheduler(**kw, device="cpu"), RefTokenAwareScheduler(**kw)
    call = "control_async" if asynchronous else "control"
    got = [getattr(ours, call)(int(q), token_backlog=int(t)) for q, t in zip(backlog, tokens)]
    want = [getattr(ref, call)(int(q), token_backlog=int(t)) for q, t in zip(backlog, tokens)]
    assert got == want and got == ours.rate_history
    assert float(ours._carry.value) == float(ref._carry.value)
    assert len(set(got)) > 1   # the virtual queue moved the decision


# ----------------------------------------------------------------- engine
def _engines(w, **kw):
    ecfg = dict(batch_slots=4, prompt_len=16, cache_len=64, **kw)
    return (Engine(w["port"], EngineConfig(**ecfg)),
            late_consume(RefEngine(w["cfg"], w["params"], RefEngineConfig(**ecfg))))


def _check_against_reference(w, ours, ref, reqs, schedule, n_steps=2):
    got = drive(ours, "chunked", reqs, schedule, n_steps=n_steps)
    want = drive(ref, "chunked", reqs, schedule, n_steps=n_steps)
    streams, retired, (served, finished) = got
    assert served == finished == len(reqs)
    assert retired == want[1]
    assert ours.served_history == ref.served_history       # per-slot conservation
    assert ours.decode_dispatches == ref.decode_dispatches
    assert ours.prefill_dispatches == ref.prefill_dispatches == 0
    assert not ours._cursors and ours.blocking_syncs == 0
    MarginComparator(w["params"], w["cfg"], 64, MARGIN).check(
        {k: list(v) for k, v in streams.items()}, {k: list(v) for k, v in want[0].items()},
        {r.rid: r.tokens for r in reqs})
    return streams


@pytest.mark.parametrize("case", ["fixed_seed", "eos_mix", "instant_finish"])
def test_chunked_engine_matches_reference(case):
    """The schedules of tests/test_differential.py (same names) through
    ``step_slot_chunked`` with chunks of 4: streams, retirement, per-slot
    served counts and dispatches equal the reference's."""
    w = _weights()
    eos = None
    if case == "fixed_seed":
        reqs, schedule = make_workload(seed=0)
    elif case == "eos_mix":
        reqs, schedule = make_workload(seed=3, n_reqs=6, max_new_lo=6, max_new_hi=10)
        _, probe = _engines(w)
        eos = drive(probe, "fused", reqs, schedule)[0][reqs[0].rid][2]
    else:
        reqs, schedule = make_workload(seed=11, n_reqs=6, max_new_lo=1, max_new_hi=2)
    ours, ref = _engines(w, eos_id=eos, chunk_size=4)
    streams = _check_against_reference(w, ours, ref, reqs, schedule)
    if case == "eos_mix":
        g0 = streams[reqs[0].rid]
        assert g0[-1] == eos and eos not in g0[:-1]
    if case == "instant_finish":
        assert all(len(g) == r.max_new_tokens for r in reqs for g in [streams[r.rid]])


@pytest.mark.parametrize("seed,chunk_size,chunk_budget,n_steps",
                         [(5, 3, 0, 1), (17, 4, 5, 2), (29, 8, 12, 3), (41, 16, 5, 2),
                          (53, 80, 0, 2)])
def test_chunked_engine_fuzz(seed, chunk_size, chunk_budget, n_steps):
    """A small sweep over chunk geometry and decode depth (the reference's
    ``test_differential_fuzz``): the chunk schedule never leaks into the
    tokens, retirement or conservation. Chunks of 80 are wider than the
    64-slot ring, which the reference serves too."""
    w = _weights()
    reqs, schedule = make_workload(seed=seed, n_reqs=8)
    ours, ref = _engines(w, chunk_size=chunk_size, chunk_budget=chunk_budget)
    _check_against_reference(w, ours, ref, reqs, schedule, n_steps=n_steps)


def test_port_modes_agree():
    """Inside the port the dense {fused, sync-free, chunked} streams are
    equal bit for bit on this workload (``Exact``): the chunked prompt
    phase gives the prefill's logits to ~1e-6 on the CPU, and no greedy
    choice here sits that close to a tie. Retirement sets and conservation
    hold exactly."""
    w = _weights()
    reqs, schedule = make_workload(seed=0)
    runs = {}
    for mode in ("fused", "sync", "chunked"):
        eng = Engine(w["port"], EngineConfig(batch_slots=4, prompt_len=16, cache_len=64,
                                             chunk_size=4))
        streams, retired, (served, finished) = drive(eng, mode, reqs, schedule)
        assert served == finished == len(reqs), mode
        runs[mode] = (streams, retired)
    assert runs["fused"] == runs["sync"] == runs["chunked"]


def test_chunked_engine_refuses_a_window():
    w = _weights()
    eng = Engine(w["port"], EngineConfig(batch_slots=2, prompt_len=16, cache_len=64,
                                         shape_window=8))
    with pytest.raises(ValueError, match="chunked prefill"):
        eng.step_slot_chunked(0)


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("extra", [(), ("--chunk-size", "4", "--chunk-budget", "6"),
                                   ("--chunk-size", "80")])   # wider than the 64-slot ring
def test_launcher_chunked_line_matches_reference(extra):
    args = ("--chunked", "--policy", "token-aware", *extra)
    ours = _launch("repro_torch.launch.serve", "--device", "cpu", *args)
    ref = _launch_late("repro.launch.serve", *args)
    assert ours[0] == ref[0]
    assert ours[0].endswith("dispatches_per_slot=1.00 blocking_syncs_per_slot=0.00")
    assert ours[1] == ref[1]  # the latency dict too


def _launch_late(module, *extra):
    """``_launch`` with the reference engine's early consume off (see
    ``late_consume``), so its line does not depend on the wall clock."""
    code = ("import runpy, repro.runtime.engine as E; "
            "E.Engine._readback_ready = lambda self, p: False; "
            f"runpy.run_module({module!r}, run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code, "--arch", "granite-3-2b", "--smoke",
                          "--horizon", "12", *extra], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


@pytest.mark.parametrize("argv,err,match", [
    (["--sync-free", "--legacy-loop"], ValueError, "mutually exclusive"),
    (["--chunked", "--legacy-loop"], ValueError, "mutually exclusive"),
    (["--chunked", "--chunk-size", "-1"], ValueError, "--chunk-size must be >= 0"),
    (["--chunked", "--chunk-budget", "-2"], ValueError, "--chunk-budget must be >= 0"),
    (["--paged", "--chunked", "--chunk-budget", "-2"], ValueError, "--chunk-budget must be >= 0"),
])
def test_launcher_checks_chunked_arguments(argv, err, match):
    from repro_torch.launch import serve as launcher
    with pytest.raises(err, match=match):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu", *argv])


@pytest.mark.parametrize("argv", [["--sync-free"], ["--chunked", "--policy", "token-aware"]])
def test_launcher_paths_default_to_the_card(argv):
    """Without --device cpu the launcher asks for the card, and with no
    card it fails: there is no fallback to the CPU."""
    from repro_torch.launch import serve as launcher
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--horizon", "2", *argv])
