"""The decode-graph machinery (``repro_torch.runtime.graph``) where it runs
here: on the CPU a DecodeGraph runs its body eagerly at every call, and the
engines' fused and sync-free decodes go through it without capturing. The
capture and the replays are held on the card
(tests/test_torch_kernels_gpu.py, ``-k graph``)."""
import copy

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.runtime import Engine, EngineConfig, PagedEngine, PagedEngineConfig, RequestSource
from repro_torch.runtime.graph import DecodeGraph, _write_back, function_name
from test_torch_engine import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = torch.device("cpu")


def test_cpu_graph_runs_the_body_eagerly_every_call():
    g = DecodeGraph("fused", CPU)
    assert DecodeGraph.enabled and not g.capture
    calls = []

    def body(x, host):
        calls.append(1)
        return (x + 1, host), (x * host,)
    x = torch.zeros(3)
    for i in range(3):
        (x, _), (out,) = g(body, (x, np.arange(3, dtype=np.float32)), key=i)
        assert torch.equal(out, torch.arange(3.0) * i)
    assert len(calls) == 3 and g.graph is None and g.replays == 0
    assert torch.equal(x, torch.full((3,), 3.0))


def test_write_back_reads_every_carry_before_writing():
    """A carry that is another static input (the sync-free decode's
    ``last_tok`` after one step is the input ``cur_tok``) is read before
    that input is overwritten."""
    a, b = torch.tensor([1, 2]), torch.tensor([3, 4])
    _write_back([a, b], [b, a + 10])
    assert torch.equal(a, torch.tensor([3, 4])) and torch.equal(b, torch.tensor([11, 12]))
    c = torch.tensor([5])
    _write_back([c], [c])
    assert torch.equal(c, torch.tensor([5]))


@pytest.mark.parametrize("symbol, name", [
    ("_ZN51_GLOBAL__N__db73d750_18_flash_attention_cu_2c13897922flash_attention_kernelIfaLi128EE"
     "EvPKT_PKT0_S6_PKfS8_PKiPS1_iiiiiif", "flash_attention_kernel"),
    ("_Z23decode_attention_kernelI13__nv_bfloat16Li64EEvPKT_S3_S3_PKiS5_PS1_iiiif",
     "decode_attention_kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "sm90_xmma_gemm_bf16bf16_bf16f32")])
def test_function_name_of_a_kernel_symbol(symbol, name):
    assert function_name(symbol) == name


def test_graph_launch_counts_count_the_wrappers_kernels_only():
    nodes = {"decode_attention_kernel": 80, "paged_decode_attention_quant_kernel": 3,
             "decode_attention_quant_kernel": 2, "sm90_xmma_gemm_bf16bf16_bf16f32": 160,
             "vectorized_elementwise_kernel": 400, "chunk_attention_kernel_wgmma": 40,
             "paged_chunk_attention_kernel_wgmma": 38, "paged_chunk_attention_kernel": 2}
    want = {"decode_attention_kernel": 80, "paged_decode_attention_quant_kernel": 3,
            "decode_attention_quant_kernel": 2, "chunk_attention_kernel": 40,
            "paged_chunk_attention_kernel": 40}
    assert kernels.graph_launch_counts(nodes) == want
    # the wrappers' counts summed per function: K4p's kernel serves two counters
    assert kernels.function_counts({
        "decode_attention": 80, "paged_decode_attention_quant": 3, "decode_attention_quant": 2,
        "chunk_attention": 40, "paged_chunk_attention": 30, "paged_chunk_attention_quant": 10,
        "flash_attention": 0}) == want


def test_add_launch_counts():
    kernels.reset_launch_counts()
    kernels.add_launch_counts({"decode_attention": 80, "flash_attention": 2})
    kernels.add_launch_counts({"decode_attention": 80})
    counts = kernels.launch_counts()
    assert counts["decode_attention"] == 160 and counts["flash_attention"] == 2
    assert sum(counts.values()) == 162
    kernels.reset_launch_counts()


def test_engines_decode_through_uncaptured_graphs_on_the_cpu():
    cfg = get_config("granite-3-2b", smoke=True)
    model = init_params(cfg, seed=0, device="cpu")
    reqs = RequestSource(vocab_size=cfg.vocab_size, prompt_len=16, raw_rate=3,
                         max_new_tokens=5, seed=2).poll(0, 3.0)
    for eng, step, mode in (
            (Engine(model, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64)),
             "step_slot", "fused"),
            (Engine(model, EngineConfig(batch_slots=4, prompt_len=16, cache_len=64)),
             "step_slot_sync", "sync"),
            (PagedEngine(model, PagedEngineConfig(prompt_len=16, cache_len=64, page_size=8,
                                                  num_pages=24, max_active=4)),
             "step_slot", "fused"),
            (PagedEngine(model, PagedEngineConfig(prompt_len=16, cache_len=64, page_size=8,
                                                  num_pages=24, max_active=4)),
             "step_slot_sync", "sync")):
        eng.warm_decode(2, sync=mode == "sync")   # nothing to warm on the CPU
        assert not eng._graphs and eng.warmup_dispatches == 0
        eng.submit(copy.deepcopy(reqs))
        for t in range(6):
            getattr(eng, step)(t, n_steps=2)
        if mode == "sync":
            eng.drain()
        assert set(eng._graphs) == {mode} and not eng._graphs[mode].capture
        assert eng.graph_replays == 0 and eng.decode_dispatches > 1
        assert len(eng.finished) == len(reqs)
        assert all(len(r.generated) == r.max_new_tokens for r in eng.finished)
