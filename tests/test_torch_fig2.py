"""The paper's Fig. 2 in the port (``repro_torch.core.trace``).

The fixture's shared service trace (tests/fixtures/fig2_golden.npz, the
reference's draw) replayed through the port's rollouts gives the
fixture's backlog and rate for all four curves, bit for bit on all 3,000
slots. The port's own trace is drawn from a torch.Generator and never
compared with a fresh jax.random draw (ROADMAP R1); on it the port's
``fig2_experiment`` must meet the reference's claims (tests/test_fig2.py).
"""
import os

import numpy as np
import pytest
import torch

from repro.core.trace import Fig2Config as RefFig2Config
from repro_torch.control import DriftPlusPenalty, Static
from repro_torch.core import Fig2Config, fig2_experiment, make_service_trace, summarize
from repro_torch.core.trace import CURVES, rollout_controller, rollout_fixed, rollout_policy
from test_torch_engine import one_torch_thread  # noqa: F401  (autouse fixture)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "fig2_golden.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(FIXTURE))


def _replay(mus: torch.Tensor, cfg: Fig2Config) -> dict:
    return {"fixed_10": rollout_fixed(mus, cfg.f_max, cfg.capacity, device="cpu"),
            "V_high": rollout_controller(mus, cfg.V_high, cfg, device="cpu"),
            "V_low": rollout_controller(mus, cfg.V_low, cfg, device="cpu"),
            "fixed_1": rollout_fixed(mus, 1.0, cfg.capacity, device="cpu")}


@pytest.fixture(scope="module")
def replay(golden):
    return _replay(torch.from_numpy(golden["service"]), Fig2Config())


@pytest.mark.parametrize("curve", CURVES)
def test_fixture_replay_is_bit_identical(golden, replay, curve):
    """No slot departs: the R4 ties (XLA's fused multiply-adds inside the
    jitted scan) do not bite on this trace, since the port evaluates
    Algorithm 1 with exact products and one rounding per subtraction."""
    for col in ("backlog", "rate"):
        got = replay[curve][col].numpy()
        assert got.dtype == np.float32 and got.shape == (3000,)
        np.testing.assert_array_equal(got, golden[f"{curve}.{col}"], err_msg=f"{curve}.{col}")


def test_fixture_replay_through_rollout_policy(golden, replay):
    mus = torch.from_numpy(golden["service"])
    cfg = Fig2Config()
    for policy, curve in ((Static(rate=10.0), "fixed_10"),
                          (DriftPlusPenalty(rates=tuple(float(x) for x in range(1, 11)),
                                            V=cfg.V_low), "V_low")):
        tr = rollout_policy(policy, mus, device="cpu")
        assert torch.equal(tr["backlog"], replay[curve]["backlog"])
        assert torch.equal(tr["rate"], replay[curve]["rate"])


def test_replayed_curves_conserve(golden, replay):
    """Serve-then-admit, slot by slot: backlog(t) = backlog(t-1) - served(t)
    + rate(t), served(t) = min(backlog(t-1), mu(t)); and the final state's
    served total is the sum of the slots'."""
    mus = golden["service"]
    for name in CURVES:
        q = replay[name]["backlog"].numpy()
        f = replay[name]["rate"].numpy()
        q_prev = np.concatenate([[0.0], q[:-1]]).astype(np.float32)
        served = np.minimum(q_prev, mus)
        np.testing.assert_allclose(q, q_prev - served + f, atol=1e-3)
        final = replay[name]["final"]
        assert float(final.served) == pytest.approx(float(served.sum()), rel=1e-4)
        assert float(final.dropped) == 0.0 and not bool(final.overflowed)


def test_config_matches_reference():
    """The port's Fig. 2 setting is the reference's, field by field."""
    port, ref = Fig2Config(), RefFig2Config()
    for field in ("horizon", "f_max", "n_rates", "V_high", "V_low", "seed"):
        assert getattr(port, field) == getattr(ref, field)
    for field in ("kind", "rate", "slow_rate", "p_stay"):
        assert getattr(port.service, field) == getattr(ref.service, field)
    assert port.capacity == float(ref.capacity) == float("inf")


# the reference's claims (tests/test_fig2.py) on the port's own draw
@pytest.fixture(scope="module")
def result():
    return fig2_experiment(Fig2Config(), device="cpu")


def test_service_trace_is_seeded(result):
    mus = result["service"]
    assert mus.dtype == torch.float32 and mus.shape == (3000,)
    assert torch.equal(mus, make_service_trace(Fig2Config(), device="cpu"))
    assert not torch.equal(mus, make_service_trace(Fig2Config(seed=1), device="cpu"))
    assert set(mus.tolist()) == {np.float32(10.8).item(), np.float32(8.4).item()}


def test_service_trace_mean_below_threshold(result):
    """The sim mimics a system that diverges at 10 fps: mean service < 10."""
    assert 9.0 < float(result["service"].mean()) < 10.0


def test_fixed_10_overflows(result):
    """(1, red): fixed max rate -> the queue diverges (grows about linearly)."""
    b = result["fixed_10"]["backlog"]
    third = len(b) // 3
    assert float(b[-1]) > 500.0
    assert float(b[-third:].mean()) > 1.3 * float(b[third:2 * third].mean())


def test_controller_stabilizes_both_V(result):
    """(2 black, 3 blue): backlog bounded, not growing."""
    for k in ("V_high", "V_low"):
        b = result[k]["backlog"]
        half = len(b) // 2
        assert float(b.max()) < 200.0
        assert float(b[-500:].mean()) < 3.0 * float(b[half:half + 500].mean()) + 5.0


def test_backlog_ordering_O_of_V(result):
    """Larger V -> larger stationary backlog (O(V) bound)."""
    s = summarize(result)
    assert s["V_high"]["tail_mean_backlog"] > s["V_low"]["tail_mean_backlog"]


def test_utility_ordering_O_of_1_over_V(result):
    """Larger V -> mean rate (utility) closer to optimal."""
    s = summarize(result)
    assert s["V_high"]["mean_rate"] > s["V_low"]["mean_rate"]
    assert s["V_high"]["mean_rate"] > s["fixed_1"]["mean_rate"]


def test_fixed_1_stable_lowest_utility(result):
    """(4, green): stable but the worst utility."""
    s = summarize(result)
    assert s["fixed_1"]["tail_mean_backlog"] <= 1.5
    for k in ("V_high", "V_low", "fixed_10"):
        assert s[k]["mean_rate"] > s["fixed_1"]["mean_rate"]


def test_no_overflow_with_bounded_queue():
    """With a finite queue the controller never drops; fixed-10 does. (As
    in the reference, ``fig2_experiment`` bounds the fixed-rate curves;
    the controllers are also run against the same bound here.)"""
    cfg = Fig2Config(capacity=150.0)
    res = fig2_experiment(cfg, device="cpu")
    assert float(res["fixed_10"]["final"].dropped) > 0.0
    assert bool(res["fixed_10"]["final"].overflowed)
    assert float(res["fixed_10"]["backlog"].max()) <= 150.0
    for k, V in (("V_high", cfg.V_high), ("V_low", cfg.V_low)):
        assert float(res[k]["final"].dropped) == 0.0
        bounded = rollout_controller(res["service"], V, cfg, capacity=cfg.capacity,
                                     device="cpu")
        assert float(bounded["final"].dropped) == 0.0
        assert torch.equal(bounded["backlog"], res[k]["backlog"])
