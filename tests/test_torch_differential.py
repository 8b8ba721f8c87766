"""The port's own equivalence contract across engines and serving modes
(the matrix of tests/test_differential.py): {dense, paged, paged with
prefix sharing} x {fused, sync-free, chunked} on a bursty ragged workload
and on one whose requests share a system prompt. Every cell's greedy
streams equal the dense fused engine's bit for bit, every request retires
exactly once, and the per-slot served counts plus the drain account for
every finished request. The quantized matrix, {dense, paged} x {fused,
sync-free, chunked} over int8 K/V, is mutually ``Exact`` and
first-token-exact against native (``BoundedDivergence``), as the
reference's quantized cells are."""
import pytest

from repro_torch.runtime import Engine, EngineConfig, PagedEngine, PagedEngineConfig
from test_differential import (BoundedDivergence, Exact, drive, make_shared_workload,
                               make_workload)
from test_torch_engine import _weights, one_torch_thread  # noqa: F401  (autouse fixture)

KINDS = ("dense", "paged", "shared")
MODES = ("fused", "sync", "chunked")
WORKLOADS = {"fixed_seed": lambda: make_workload(seed=0),
             "shared_prefix": lambda: make_shared_workload(seed=23)}
_REF = {}


def _engine(kind: str, chunk_size: int = 0, kv_precision: str = ""):
    port = _weights()["port"]
    if kind == "dense":
        return Engine(port, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64,
                                         chunk_size=chunk_size, kv_precision=kv_precision))
    return PagedEngine(port, PagedEngineConfig(
        prompt_len=16, cache_len=64, page_size=8, num_pages=32, max_active=6,
        prefix_sharing=kind == "shared", chunk_size=chunk_size, kv_precision=kv_precision))


def _reference(workload: str):
    """The dense fused engine's streams and retirement on the workload."""
    if workload not in _REF:
        reqs, schedule = WORKLOADS[workload]()
        streams, retired, _ = drive(_engine("dense"), "fused", reqs, schedule)
        _REF[workload] = (streams, retired)
    return _REF[workload]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_port_cell_matches_dense_fused(workload, kind, mode):
    reqs, schedule = WORKLOADS[workload]()
    eng = _engine(kind, chunk_size=4 if mode == "chunked" else 0)
    streams, retired, (served, finished) = drive(eng, mode, reqs, schedule)
    ref_streams, ref_retired = _reference(workload)
    assert served == finished == len(reqs)
    assert retired == ref_retired
    assert streams == ref_streams
    if mode != "fused":
        assert eng.blocking_syncs == 0
    if kind != "dense":
        eng.allocator.check()
        pinned = len(eng._prefix) if kind == "shared" else 0
        assert eng.allocator.used_pages == pinned   # only the index's pins outlive the run
    if kind == "shared" and workload == "shared_prefix":
        assert eng.prefix_hits > 0


def _quant_reference():
    """The dense fused int8 cell's streams on the fixed-seed workload."""
    if "int8" not in _REF:
        reqs, schedule = WORKLOADS["fixed_seed"]()
        _REF["int8"] = drive(_engine("dense", kv_precision="int8"), "fused", reqs, schedule)[0]
    return _REF["int8"]


@pytest.mark.parametrize("kind", ("dense", "paged"))
@pytest.mark.parametrize("mode", MODES)
def test_port_quant_cell_matches_dense_fused_int8(kind, mode):
    """int8 K/V (a quantized dense ring, an all-int8 page pool): every
    cell's streams equal the dense fused int8 cell's bit for bit (each
    performs the same quantized writes and dequantized reads), and leave
    the native streams no earlier than token 1 (prompt attention reads
    native K/V; rounding reaches the logits from the first decode step)."""
    reqs, schedule = WORKLOADS["fixed_seed"]()
    eng = _engine(kind, chunk_size=4 if mode == "chunked" else 0, kv_precision="int8")
    streams, retired, (served, finished) = drive(eng, mode, reqs, schedule)
    native, native_retired = _reference("fixed_seed")
    assert served == finished == len(reqs)
    assert retired == native_retired
    BoundedDivergence(max_first_divergence_step=1).check_streams(streams, native,
                                                                 ctx=(kind, mode, "vs native"))
    Exact().check_streams(streams, _quant_reference(), ctx=(kind, mode))
    if mode != "fused":
        assert eng.blocking_syncs == 0
    if kind == "paged":
        eng.allocator.check()
        assert eng.allocator.used_pages == 0
