"""Algorithm 1 and the schedulers in the port against the reference."""
import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.control.policy import drift_plus_penalty_action as ref_dpp
from repro.runtime import scheduler as ref_sched
from repro_torch.control.policy import drift_plus_penalty_action
from repro_torch.core.utility import Utility
from repro_torch.runtime import scheduler as port_sched

# The reference's scheduler evaluates Algorithm 1 one backlog at a time in
# its jitted table dispatch, where XLA fuses the products into
# multiply-adds; the port reproduces that arithmetic, so it is held against
# that dispatch (the eager function rounds each product first, and a
# batched jit may fuse differently).


def _ref_actions(backlog, f, s, lam, V, vq=None, cost=None):
    vq = np.zeros(len(backlog), np.float32) if vq is None else vq
    cost = np.zeros_like(f) if cost is None else cost
    return np.asarray([float(ref_sched._act_on_tables(
        jnp.float32(b), f, s, lam, jnp.float32(V), jnp.float32(z), cost))
        for b, z in zip(backlog, vq)], np.float32)


def _tables(rates, kind="linear"):
    f = np.array(rates, np.float32)
    from repro.core.utility import Utility as RefUtility
    s = np.asarray(RefUtility(kind=kind, f_max=max(rates))(f), np.float32)
    return f, s.copy(), f.copy()


@pytest.mark.parametrize("V", [1.0, 7.5, 20.0, 50.0, 123.4])
@pytest.mark.parametrize("rates", [tuple(range(1, 6)), tuple(range(1, 11)),
                                   (1.0, 2.0, 4.0, 8.0)])
def test_action_matches_reference_over_backlog_sweep(rates, V):
    f, s, lam = _tables(rates)
    backlog = np.arange(0, 301, dtype=np.float32)
    got_f, got_T = drift_plus_penalty_action(torch.from_numpy(backlog), torch.from_numpy(f),
                                             torch.from_numpy(s), torch.from_numpy(lam), V)
    np.testing.assert_array_equal(got_f.numpy(), _ref_actions(backlog, f, s, lam, V))
    # T* agrees with the eager reference up to its one extra rounding
    _, ref_T = ref_dpp(jnp.asarray(backlog), f, s, lam, V)
    np.testing.assert_allclose(got_T.numpy(), np.asarray(ref_T), rtol=1e-6, atol=1e-5)


def test_forced_ties_go_to_the_lowest_rate():
    # exactly representable tables: T is 0 for every rate at Q = V / f_max,
    # and for the first two rates wherever the utility is flat there
    f = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    s = f / np.float32(4.0)
    for V, q in ((16.0, 4.0), (8.0, 2.0), (4.0, 1.0)):
        got, _ = drift_plus_penalty_action(torch.tensor(q), torch.from_numpy(f),
                                           torch.from_numpy(s), torch.from_numpy(f), V)
        ref, _ = ref_dpp(jnp.float32(q), f, s, f, V)
        assert float(got) == float(ref) == 1.0
    flat = np.asarray([0.5, 0.5, 1.0, 1.0], np.float32)
    lam = np.zeros(4, np.float32)
    got, _ = drift_plus_penalty_action(torch.tensor(3.0), torch.from_numpy(f),
                                       torch.from_numpy(flat), torch.from_numpy(lam), 2.0)
    assert float(got) == float(ref_dpp(jnp.float32(3.0), f, flat, lam, 2.0)[0]) == 3.0


def test_extra_penalty_matches_reference():
    f, s, lam = _tables(tuple(range(1, 11)))
    rng = np.random.default_rng(0)
    backlog = rng.integers(0, 60, 200).astype(np.float32)
    vq = rng.uniform(0, 5, 200).astype(np.float32)
    cost = f.copy()
    got_f, _ = drift_plus_penalty_action(
        torch.from_numpy(backlog), torch.from_numpy(f), torch.from_numpy(s),
        torch.from_numpy(lam), 20.0,
        torch.from_numpy(vq).double()[:, None] * torch.from_numpy(cost).double())
    np.testing.assert_array_equal(got_f.numpy(),
                                  _ref_actions(backlog, f, s, lam, 20.0, vq, cost))


@pytest.mark.parametrize("kind", ["linear", "detection", "log"])
def test_utility_tables_match_reference(kind):
    from repro.core.utility import Utility as RefUtility
    f = np.arange(1, 11, dtype=np.float32)
    np.testing.assert_allclose(Utility(kind=kind)(torch.from_numpy(f)).numpy(),
                               np.asarray(RefUtility(kind=kind)(f)), rtol=1e-6)


def _make(pkg, name):
    rates = tuple(float(x) for x in range(1, 6))
    dev = {} if pkg is ref_sched else {"device": "cpu"}
    if name == "adaptive":
        return pkg.AdaptiveScheduler(rates=rates, V=20.0, **dev)
    if name == "static":
        return pkg.StaticScheduler(rate=3.0, **dev)
    if pkg is ref_sched:
        from repro.control import LatencyAware as LA
    else:
        from repro_torch.control import LatencyAware as LA
    return pkg.PolicyScheduler(policy=LA(rates=rates, V=20.0, cost_budget=2.5), **dev)


@pytest.mark.parametrize("name", ["adaptive", "static", "latency-aware"])
def test_scheduler_rate_sequence_matches_reference(name):
    backlog = np.random.default_rng(1).integers(0, 40, 120)
    ref, port = _make(ref_sched, name), _make(port_sched, name)
    got = [port.control(int(q)) for q in backlog]
    want = [ref.control(int(q)) for q in backlog]
    assert got == want
    assert port.rate_history == ref.rate_history


def test_static_rate_reads_back_exactly():
    # 0.3 has no float32 representation; the reference returns it as given
    ref, port = ref_sched.StaticScheduler(rate=0.3), port_sched.StaticScheduler(rate=0.3,
                                                                                device="cpu")
    assert [port.control(q) for q in (0, 7, 40)] == [ref.control(q) for q in (0, 7, 40)] \
        == [0.3] * 3


def test_scheduler_without_device_refuses_to_fall_back():
    sched = port_sched.AdaptiveScheduler()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sched.control(3)
