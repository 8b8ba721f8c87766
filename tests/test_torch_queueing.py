"""The port's queue model (``repro_torch.core.queueing``) against the
reference's, bit for bit, and the reference's queue claims on the port's
own draws."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypcompat import given, settings, strategies as st

from repro.core import queueing as ref_q
from repro_torch.control import Static
from repro_torch.core.queueing import (QueueState, ServiceProcess, bounded_queue_step,
                                       queue_update, simulate_queue, time_average_backlog)
from test_torch_engine import one_torch_thread  # noqa: F401  (autouse fixture)

floats = st.floats(0.0, 1e4, allow_nan=False, allow_infinity=False)
# XLA's CPU backend flushes subnormal floats to zero and torch does not:
# the bit-for-bit comparisons draw normal floats only
normal = st.floats(0.0, 1e4, allow_nan=False, allow_infinity=False, width=32,
                   allow_subnormal=False)
caps = st.sampled_from([1.0, 7.5, 150.0, 1e4, math.inf])


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@given(q=normal, mu=normal, lam=normal)
@settings(max_examples=200, deadline=None)
def test_queue_update_equals_reference(q, mu, lam):
    got = queue_update(_f32(q), _f32(mu), _f32(lam))
    _same(got, ref_q.queue_update(jnp.float32(q), jnp.float32(mu), jnp.float32(lam)))


@given(q=normal, mu=normal, lam=normal, cap=caps, dropped=normal, served=normal)
@settings(max_examples=200, deadline=None)
def test_bounded_queue_step_equals_reference(q, mu, lam, cap, dropped, served):
    q = min(q, cap)
    got = bounded_queue_step(QueueState(_f32(q), _f32(dropped), _f32(served),
                                        torch.tensor(False)), _f32(mu), _f32(lam), cap)
    want = ref_q.bounded_queue_step(
        ref_q.QueueState(jnp.float32(q), jnp.float32(dropped), jnp.float32(served),
                         jnp.bool_(False)), jnp.float32(mu), jnp.float32(lam), cap)
    for g, w in zip(got, want, strict=True):
        _same(g, w)


def test_vectorized_bounded_step_equals_reference():
    rng = np.random.default_rng(0)
    q = rng.uniform(0, 50, 64).astype(np.float32)
    mu = rng.uniform(0, 20, 64).astype(np.float32)
    lam = rng.uniform(0, 30, 64).astype(np.float32)
    cap = np.float32(40.0)
    got = bounded_queue_step(QueueState(torch.from_numpy(q), torch.zeros(64), torch.zeros(64),
                                        torch.zeros(64, dtype=torch.bool)),
                             torch.from_numpy(mu), torch.from_numpy(lam), float(cap))
    want = ref_q.bounded_queue_step(ref_q.QueueState(q, jnp.zeros(64), jnp.zeros(64),
                                                     jnp.zeros(64, bool)), mu, lam, cap)
    for g, w in zip(got, want, strict=True):
        _same(g, w)


def test_float64_static_rate_leaves_the_queue_float32():
    """``Static`` returns its rate in float64 (so reading it back gives the
    rate exactly); as arrivals it enters the queue as float32, as in the
    reference, whose x64 is off. Promoted, the backlog of f = 10 against a
    service of 9.3 would depart from the reference's in the last bits."""
    policy, q = Static(rate=10.0), QueueState.zeros()
    ref = ref_q.QueueState.zeros()
    for _ in range(50):
        f, _ = policy.act((), q.backlog)
        assert f.dtype == torch.float64
        q = bounded_queue_step(q, _f32(9.3), policy.arrivals(f))
        ref = ref_q.bounded_queue_step(ref, jnp.float32(9.3), jnp.float32(10.0))
        for g, w in zip(q, ref, strict=True):
            _same(g, w)
    promoted = torch.zeros((), dtype=torch.float64)
    for _ in range(50):
        promoted = torch.clamp(promoted - _f32(9.3), min=0.0) + torch.tensor(10.0,
                                                                          dtype=torch.float64)
    assert promoted.item() != q.backlog.item()


# the reference's claims (tests/test_queueing.py) on the port's own draws
@given(q=floats, mu=floats, lam=floats)
@settings(max_examples=200, deadline=None)
def test_queue_update_matches_paper_recursion(q, mu, lam):
    out = float(queue_update(_f32(q), _f32(mu), _f32(lam)))
    assert out == pytest.approx(max(q - mu, 0.0) + lam, rel=1e-5, abs=1e-3)


@given(q=floats, mu=floats, lam=floats, cap=st.floats(1.0, 1e4))
@settings(max_examples=200, deadline=None)
def test_bounded_queue_never_exceeds_capacity(q, mu, lam, cap):
    q = min(q, cap)
    s2 = bounded_queue_step(QueueState(_f32(q), _f32(0), _f32(0), torch.tensor(False)),
                            _f32(mu), _f32(lam), cap)
    assert float(s2.backlog) <= cap + 1e-3
    assert float(s2.dropped) >= 0
    # conservation: what was admitted is the backlog's growth past the service
    admitted = lam - float(s2.dropped)
    assert admitted == pytest.approx(float(s2.backlog) - float(max(np.float32(q) -
                                                                   np.float32(mu), 0.0)),
                                     abs=1e-2)
    assert float(s2.served) >= 0


@given(q=floats, mu=floats)
@settings(max_examples=100, deadline=None)
def test_queue_monotone_in_arrivals(q, mu):
    s = QueueState(_f32(q), _f32(0), _f32(0), torch.tensor(False))
    lo = bounded_queue_step(s, _f32(mu), _f32(1.0))
    hi = bounded_queue_step(s, _f32(mu), _f32(5.0))
    assert float(hi.backlog) >= float(lo.backlog)


def test_vectorized_queues():
    s2 = bounded_queue_step(QueueState.zeros((4,)), torch.ones(4) * 2.0,
                            torch.arange(4.0), capacity=2.0)
    np.testing.assert_allclose(s2.backlog.numpy(), [0, 1, 2, 2])
    np.testing.assert_allclose(s2.dropped.numpy(), [0, 0, 0, 1])
    assert bool(s2.overflowed[3]) and not bool(s2.overflowed[0])


def test_simulate_queue_stable_when_undersubscribed():
    _, trace = simulate_queue(lambda g, t: 3.0, ServiceProcess(kind="deterministic", rate=5.0),
                              horizon=500, device="cpu")
    assert float(trace["backlog"][-1]) <= 3.0
    assert float(time_average_backlog(trace["backlog"], 500)) <= 3.0


def test_simulate_queue_diverges_when_oversubscribed():
    final, trace = simulate_queue(lambda g, t: 7.0,
                                  ServiceProcess(kind="deterministic", rate=5.0),
                                  horizon=500, device="cpu")
    assert float(trace["backlog"][-1]) >= 900.0   # +2/slot drift
    assert trace["backlog"].dtype == torch.float32 and float(final.served) == 499 * 5.0


def test_markov_service_mean_between_rates():
    sp = ServiceProcess(kind="markov", rate=10.0, slow_rate=4.0, p_stay=0.9)
    g = torch.Generator().manual_seed(1)
    state, mus = sp.init_state(), []
    for _ in range(2000):
        mu, state = sp.sample(g, state)
        mus.append(float(mu))
    assert 4.0 < float(np.mean(mus)) < 10.0
    assert set(mus) == {10.0, 4.0}


def test_poisson_service_mean_and_generator():
    """Poisson service draws from the caller's generator: the same seed
    gives the same draws."""
    sp = ServiceProcess(kind="poisson", rate=6.0)
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        state = sp.init_state()
        draws.append([float(sp.sample(g, state)[0]) for _ in range(2000)])
    assert draws[0] == draws[1]
    assert 5.7 < float(np.mean(draws[0])) < 6.3
    _, trace = simulate_queue(lambda g, t: 5.0, sp, horizon=200,
                              generator=torch.Generator().manual_seed(0), device="cpu")
    assert trace["service"].dtype == torch.float32 and jax is not None


@pytest.mark.parametrize("entry", ["simulate_queue", "rollout", "rollout_fixed",
                                   "rollout_controller", "closed_loop", "fig2_experiment"])
def test_entry_points_without_a_device_run_on_the_card(monkeypatch, entry):
    """``device=None`` means the card, whatever the inputs lie on: with no
    card, each entry point raises rather than running on the CPU."""
    from repro_torch.control import DriftPlusPenalty, closed_loop, rollout
    from repro_torch.core.trace import (Fig2Config, fig2_experiment, rollout_controller,
                                        rollout_fixed)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mus = torch.full((5,), 4.0)
    svc = ServiceProcess(kind="deterministic", rate=5.0)
    cfg = Fig2Config(horizon=5)
    call = {"simulate_queue": lambda: simulate_queue(lambda g, t: 3.0, svc, horizon=5),
            "rollout": lambda: rollout(Static(rate=2.0), mus),
            "rollout_fixed": lambda: rollout_fixed(mus, 2.0),
            "rollout_controller": lambda: rollout_controller(mus, 50.0, cfg),
            "closed_loop": lambda: closed_loop(DriftPlusPenalty(rates=(1.0, 2.0), V=5.0), svc, 5),
            "fig2_experiment": lambda: fig2_experiment(cfg)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
