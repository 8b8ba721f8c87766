"""Algorithm 1, the closed-loop rollout and the bundled controller in the
port (``repro_torch.control``): the reference's claims
(tests/test_lyapunov.py) on the port's own draws, and, where no draw
enters, the reference's ``closed_loop`` slot for slot."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypcompat import given, settings, strategies as st

from repro.control.rollout import closed_loop as ref_closed_loop
from repro.control.policy import DriftPlusPenalty as RefDPP
from repro.control.policy import LatencyAware as RefLatencyAware
from repro.control.policy import Static as RefStatic
from repro.core.queueing import ServiceProcess as RefService
from repro.core.utility import paper_utility as ref_paper_utility
from repro_torch.control import (DriftPlusPenalty, LatencyAware, LyapunovController, Static,
                                 closed_loop, drift_plus_penalty_action)
from repro_torch.core import LyapunovController as CoreLyapunovController
from repro_torch.core.queueing import ServiceProcess
from repro_torch.core.utility import paper_utility
from test_torch_engine import one_torch_thread  # noqa: F401  (autouse fixture)

RATES = tuple(float(x) for x in range(1, 11))


def _tables(n=10):
    f = torch.arange(1, n + 1, dtype=torch.float32)
    return f, paper_utility(float(n))(f), f


def test_algorithm1_bruteforce_equivalence():
    """f* must equal the literal argmax of the paper's functional."""
    f, s, lam = _tables()
    for q in (0.0, 0.5, 3.0, 7.0, 100.0):
        for V in (1.0, 10.0, 50.0):
            fstar, tstar = drift_plus_penalty_action(torch.tensor(q), f, s, lam, V)
            T = (V * s.double() - q * lam.double()).numpy()
            assert float(tstar) == pytest.approx(T.max(), rel=1e-6)
            assert float(fstar) == float(f[np.argmax(T)])


@given(q=st.floats(0, 1e5, allow_nan=False), V=st.floats(0.1, 1e4))
@settings(max_examples=200, deadline=None)
def test_action_in_feasible_set(q, V):
    f, s, lam = _tables()
    fstar, _ = drift_plus_penalty_action(torch.tensor(q, dtype=torch.float32), f, s, lam, V)
    assert float(fstar) in set(f.tolist())


@given(V=st.floats(1.0, 500.0))
@settings(max_examples=50, deadline=None)
def test_rate_nonincreasing_in_backlog(V):
    """Higher backlog must never pick a higher rate (drift term dominates)."""
    f, s, lam = _tables()
    rates = drift_plus_penalty_action(torch.linspace(0, 200, 64), f, s, lam, V)[0]
    assert bool(torch.all(torch.diff(rates) <= 1e-6))


def test_rate_nondecreasing_in_V():
    f, s, lam = _tables()
    rates = [float(drift_plus_penalty_action(torch.tensor(10.0), f, s, lam, V)[0])
             for V in (1, 10, 100, 1000)]
    assert rates == sorted(rates)


def test_batched_multitenant():
    f, s, lam = _tables()
    rates, _ = drift_plus_penalty_action(torch.tensor([0.0, 5.0, 50.0]), f, s, lam, 50.0)
    assert rates.shape == (3,)
    assert float(rates[0]) >= float(rates[2])


def test_controller_rollout_stabilizes_and_tracks_V():
    """O(V) backlog / O(1/V) utility gap: tail backlog grows with V and tail
    utility improves with V (the paper's core trade-off)."""
    svc = ServiceProcess(kind="markov", rate=10.8, slow_rate=6.0, p_stay=0.9)
    results = {}
    for V in (20.0, 200.0):
        c = LyapunovController(rates=RATES, V=V, utility=paper_utility(10.0))
        tr = c.run(svc, horizon=3000, generator=torch.Generator().manual_seed(0),
                   device="cpu")
        results[V] = {"tail_q": float(tr["backlog"][-500:].mean()),
                      "tail_u": float(tr["utility"][-500:].mean())}
    assert results[200.0]["tail_q"] > results[20.0]["tail_q"]     # O(V) backlog
    assert results[200.0]["tail_u"] > results[20.0]["tail_u"]     # O(1/V) gap
    assert results[200.0]["tail_q"] < 100.0                       # still stable


def test_virtual_queue_enforces_budget():
    """Average cost y(f) = f must converge to <= budget when constrained."""
    svc = ServiceProcess(kind="deterministic", rate=20.0)  # service never binds
    c = LyapunovController(rates=RATES, V=100.0, utility=paper_utility(10.0), cost_gain=1.0,
                           cost_budget=4.0)
    assert isinstance(c.policy(), LatencyAware)
    tr = c.run(svc, horizon=4000, device="cpu")
    assert float(tr["rate"][-2000:].mean()) <= 4.0 + 0.3
    assert tr["vq"].shape == (4000,) and float(tr["vq"].max()) > 0.0


def test_controller_act_and_tables():
    c = LyapunovController(rates=RATES, V=50.0, utility=paper_utility(10.0))
    assert CoreLyapunovController is LyapunovController
    f, s, lam = c.tables()
    assert torch.equal(f, torch.tensor(RATES)) and torch.equal(lam, f)
    assert float(c.act(torch.tensor(0.0))) == 10.0
    assert float(c.act(torch.tensor(1e4))) == 1.0


# closed_loop where no draw enters: a deterministic service and expected
# arrivals, held to the reference's jitted scan slot for slot
def _ref_closed_loop(policy, rate, horizon, capacity, utility):
    tr = ref_closed_loop(policy, RefService(kind="deterministic", rate=rate), horizon,
                                 jax.random.PRNGKey(0), capacity=capacity, utility=utility)
    return {k: np.asarray(v) for k, v in tr.items() if k != "final"}, tr["final"]


@pytest.mark.parametrize("name", ["dpp_V50", "dpp_V200", "static_10", "latency_aware"])
@pytest.mark.parametrize("rate,capacity", [(9.5, float("inf")), (4.0, 30.0)])
def test_closed_loop_equals_reference_without_draws(name, rate, capacity):
    horizon = 600
    if name.startswith("dpp"):
        V = float(name.removeprefix("dpp_V"))
        port, ref = DriftPlusPenalty(rates=RATES, V=V), RefDPP(rates=RATES, V=V)
    elif name == "static_10":
        port, ref = Static(rate=10.0), RefStatic(rate=10.0)
    else:
        port = LatencyAware(rates=RATES, V=100.0, cost_gain=1.0, cost_budget=4.0)
        ref = RefLatencyAware(rates=RATES, V=100.0, cost_gain=1.0, cost_budget=4.0)
    got = closed_loop(port, ServiceProcess(kind="deterministic", rate=rate), horizon,
                      capacity=capacity, utility=paper_utility(10.0), device="cpu")
    want, final = _ref_closed_loop(ref, rate, horizon, capacity, ref_paper_utility(10.0))
    assert set(got) - {"final"} == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for g, w in zip(got["final"], final, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert jnp is not None
