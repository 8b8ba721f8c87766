"""The port's serve loop against the reference's on the same seeded
workload and the same weights: the per-slot trace columns, the greedy token
streams (under a margin comparator), and the launcher's summary line."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models import model as RM
from repro.runtime import Engine as RefEngine
from repro.runtime import EngineConfig as RefEngineConfig
from repro.runtime import AdaptiveScheduler as RefAdaptive
from repro.runtime import RequestSource as RefSource
from repro.runtime import serve as ref_serve
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import (AdaptiveScheduler, Engine, EngineConfig,
                                 RequestSource, serve)

SRC = Path(__file__).resolve().parents[1] / "src"
COLUMNS = ("rate", "backlog", "served", "active", "dropped", "dispatches", "syncs")
# a stream may leave the reference's only where the reference itself was
# within float32 noise of a tie (see test_torch_model's tolerance)
MARGIN = 1e-4
_W = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread for the port's smoke-size CPU tests, put
    back after the module. The suite runs several test workers on the
    machine's cores; a thread pool per worker sized to all of them turns the
    eager loops' many tiny ops into contention that made these tests
    several times slower. Modules that import this fixture get it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights():
    if not _W:
        cfg = ref_get_config("granite-3-2b", smoke=True)
        params = ref_init_params(jax.random.PRNGKey(0), cfg)
        port = params_from_numpy(jax.tree.map(np.asarray, params),
                                 get_config("granite-3-2b", smoke=True), device="cpu")
        _W.update(cfg=cfg, params=params, port=port)
    return _W


class MarginComparator:
    """Greedy streams must be equal, except that they may part where the
    reference's own top-2 logit gap at that token is below ``margin``."""

    def __init__(self, params, cfg, cache_len, margin):
        self.params, self.cfg, self.cache_len, self.margin = params, cfg, cache_len, margin

    def _ref_gap(self, prompt, generated):
        seq = np.concatenate([prompt, np.asarray(generated, np.int32)])[None]
        logits, _ = RM.prefill(self.params, {"tokens": jnp.asarray(seq)}, self.cfg,
                               self.cache_len)
        top = np.sort(np.asarray(logits[0]))[-2:]
        return float(top[1] - top[0])

    def check(self, got: dict, ref: dict, prompts: dict):
        assert got.keys() == ref.keys()
        for rid, want in ref.items():
            have = got[rid]
            d = next((i for i, (a, b) in enumerate(zip(have, want)) if a != b), None)
            if d is None:
                assert len(have) == len(want), rid
                continue
            gap = self._ref_gap(prompts[rid], want[:d])
            assert gap < self.margin, (rid, d, have, want, gap)


def _streams(engine):
    reqs = engine.finished + [r for r in engine.active if r is not None]
    return {r.rid: list(r.generated) for r in reqs}, {r.rid: r.tokens for r in reqs}


@pytest.mark.parametrize("fused,min_prompt_len", [(True, 5), (False, None)])
def test_serve_trace_and_streams_match_reference(fused, min_prompt_len):
    w = _weights()
    kw = dict(batch_slots=4, prompt_len=16, cache_len=64)
    src_kw = dict(prompt_len=16, raw_rate=5, max_new_tokens=4, min_prompt_len=min_prompt_len)
    rates = tuple(float(f) for f in range(1, 6))

    ref_engine = RefEngine(w["cfg"], w["params"], RefEngineConfig(**kw))
    ref_tr = ref_serve(ref_engine, RefAdaptive(rates=rates, V=20.0, capacity=32),
                       RefSource(vocab_size=w["cfg"].vocab_size, **src_kw),
                       horizon=12, steps_per_slot=2, fused=fused)
    engine = Engine(w["port"], EngineConfig(**kw))
    tr = serve(engine, AdaptiveScheduler(rates=rates, V=20.0, capacity=32),
               RequestSource(vocab_size=w["cfg"].vocab_size, **src_kw),
               horizon=12, steps_per_slot=2, fused=fused)
    for col in COLUMNS:
        np.testing.assert_array_equal(tr[col], ref_tr[col], err_msg=col)
    assert engine.counters() == ref_engine.counters()

    got, prompts = _streams(engine)
    want, _ = _streams(ref_engine)
    assert sum(map(len, got.values())) > 0
    MarginComparator(w["params"], w["cfg"], 64, MARGIN).check(got, want, prompts)


def _launch(module, *extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", module, "--arch", "granite-3-2b", "--smoke",
                          "--horizon", "12", *extra], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_launcher_summary_line_matches_reference():
    ours = _launch("repro_torch.launch.serve", "--device", "cpu")
    ref = _launch("repro.launch.serve")
    assert ours[0] == ref[0]
    assert ours[0].startswith("policy=adaptive served=24 dropped=0 tail_backlog=5.6 "
                              "mean_rate=2.67 dispatches_per_slot=1.50")
    assert ours[1] == ref[1]  # the latency dict too


def test_launcher_refuses_unported_paths(capsys):
    """The model zoo beyond dense and SSM stacks still raises naming its
    ROADMAP.md queue-1 item; the observability and reliability flags run
    (their lines are held to the reference's in tests/test_torch_obs.py
    and tests/test_torch_reliability.py)."""
    from repro_torch.launch import serve as launcher
    for arch in ("olmoe-1b-7b", "recurrentgemma-2b"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 11"):
            launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--horizon", "2"])
    for argv in (["--policy", "conformal-slo", "--tenants", "gold:1:1:6"],
                 ["--tenants", "gold:1:1:6"], ["--metrics"]):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu", "--horizon", "2",
                       *argv])
    out = capsys.readouterr().out
    assert "slo: degrade_level=" in out and "# TYPE repro_steps counter" in out
    assert "'tenants': {'gold'" in out


def test_engine_defaults_to_the_card():
    from repro_torch.models import init_params
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(get_config("granite-3-2b", smoke=True))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(min_prompt_len=3),
    dict(min_prompt_len=3, long_frac=0.3, long_prompt_len=40),
    dict(long_frac=0.5, max_new_tokens=7),
])
def test_request_source_draws_match_reference(kw):
    ours = RequestSource(vocab_size=512, prompt_len=16, seed=7, **kw)
    ref = RefSource(vocab_size=512, prompt_len=16, seed=7, **kw)
    for t, rate in enumerate(np.random.default_rng(0).uniform(0, 12, 20)):
        a, b = ours.poll(t, float(rate)), ref.poll(t, float(rate))
        assert [(r.rid, r.arrival_slot, r.tokens.tolist(), r.max_new_tokens) for r in a] == \
            [(r.rid, r.arrival_slot, r.tokens.tolist(), r.max_new_tokens) for r in b]
    assert ours.produced == ref.produced
