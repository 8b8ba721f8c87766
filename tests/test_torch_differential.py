"""The port's own equivalence contract across engines and serving modes
(the matrix of tests/test_differential.py): {dense, paged, paged with
prefix sharing} x {fused, sync-free, chunked} on a bursty ragged workload
and on one whose requests share a system prompt. Every cell's greedy
streams equal the dense fused engine's bit for bit, every request retires
exactly once, and the per-slot served counts plus the drain account for
every finished request."""
import pytest

from repro_torch.runtime import Engine, EngineConfig, PagedEngine, PagedEngineConfig
from test_differential import drive, make_shared_workload, make_workload
from test_torch_engine import _weights, one_torch_thread  # noqa: F401  (autouse fixture)

KINDS = ("dense", "paged", "shared")
MODES = ("fused", "sync", "chunked")
WORKLOADS = {"fixed_seed": lambda: make_workload(seed=0),
             "shared_prefix": lambda: make_shared_workload(seed=23)}
_REF = {}


def _engine(kind: str, chunk_size: int = 0):
    port = _weights()["port"]
    if kind == "dense":
        return Engine(port, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64,
                                         chunk_size=chunk_size))
    return PagedEngine(port, PagedEngineConfig(
        prompt_len=16, cache_len=64, page_size=8, num_pages=32, max_active=6,
        prefix_sharing=kind == "shared", chunk_size=chunk_size))


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
