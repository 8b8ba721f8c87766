"""Drive the port's main path on one NVIDIA H100 and hold every kernel of it
against its plain version. Exits nonzero on any fault; nothing is caught.

  python3 chip_smoke.py

Phases, each printing one JSON line: device, build (nvcc, all sources at
once; each flash_attention, chunk attention (K4, K4p, K4q), SSD scan (K6)
and decode (K2, K3) instantiation's shared memory, registers and spills),
kernels (each
CUDA kernel against its plain PyTorch version, element by element, at the
full-width granite-3-2b serving shapes in bf16 and in f32 and at the smoke
shapes in f32, with CUDA-event times, the roofline bound and the time of
the library's counterpart for the record: one scaled_dot_product_attention
call, or for the paged kernel a page gather plus that call; each main row
also with the device time of the kernel and of its library route from
torch.profiler, as has K2 at the serves' own geometry, rows that have not
wrapped, whose empty tiles it skips; the prefill and
chunk rows name their instantiation, bf16 on wgmma and f32 on the CUDA
cores, and bf16 prefill adds keys that rise tile by tile so every tile
rescales the output), flash_anatomy (the bf16 prefill kernel beside
variants that each change one factor of its work), chunk_anatomy (the
CTA-tiles and longest CTA chain of the main bf16 K4, K4q and K4p cases,
with the device time of each kernel and of its library route from
torch.profiler, and the time per tile), model (full-width granite-3-2b
prefill + greedy decode through the kernels against the plain versions on
the same weights, with a path whose decode attention skips one KV tile read
beside it to show the tolerance catches such a fault, and the smoke model
on the card against the CPU path the CPU tests hold against the JAX
package), paged_model (the
same prompts through the paged decode against the dense one, equal bit for
bit on every step, with a path whose block table swaps two pages of one
row beside it), preemption (a
full-width paged engine whose pool is too small for both of its rows to
grow, against the dense engine's tokens), chunk_model (full-width prompts
through chunk_step in chunks of 128, K4, against the one-shot ragged
prefill, K1r, then 16 decode steps, with a path whose chunk attention
sees only the chunk itself beside it), serve (the launcher's main path
at full width, with the kernels' launch counts), profile (device time by
kernel over an identical second serve run), then serve and profile again
for the paged path (``--paged --policy memory-aware``), the sync-free
path (``--sync-free``) and the chunked path (``--chunked --policy
token-aware``); every slot of the last two runs its engine work under
``torch.cuda.set_sync_debug_mode("error")`` (only the scheduler's first
decision, which seeds its pipeline, before it), and the chunked trace is
held to the same launcher's on the CPU with the smoke model. The Mamba-2 path
(mamba2-130m at full width): the SSD scan kernel among the kernels (against
its plain version and, in f32, its sequential oracle), ssd_anatomy (the
bf16 scan's three kernels each against its plain phase, two launches bit
for bit, and the device time of the call and of each kernel beside the f32
CUDA-core kernel's at the serve's shape), ssm_model (prefill
logits at positions around the chunk boundaries and 16 greedy decode steps
through the kernel against the plain scan, with a scan that drops the state
carried between chunks beside it, and the smoke model on the card against
the CPU path), then ssm_serve, ssm_profile, ssm_sync_serve and
ssm_sync_profile (the fused and the sync-free loops, their traces held to
the CPU run's). The dense quantized ring: K1q/K1rq and K2q among the
kernels (int8 and fp8 codes, with an extreme-scale sweep), dense_quant_model
(full-width int8 and fp8 rings through K1r and K2q against the plain path,
two faulty K2q paths beside it, the int8 ring against an all-int8 page pool
bit for bit, and K1q on the int8 prefill's own ring), then
dense_quant_serve and dense_quant_profile (``--kv-precision int8`` on the
main path) and dense_quant_chunked_serve (``--chunked --kv-precision fp8``,
under the sync debug mode), their traces held to the CPU run's. Each serve
phase zeroes the launch counts just before it and reads them just after.
On the fused, sync-free and chunked loops, dense and paged, every dispatch
the loop replays is warmed up and captured before the first slot, and
every slot's admission (one graph per prompt bucket), decode or mixed
(chunk + decode) dispatch is one CUDA graph replay (``runtime/graph.py``):
the serve phases check one replay per dispatch (one admission-graph replay
per admission, each admission graph holding K1r once per layer, or K6's
kernels on Mamba-2, and one chunk-graph replay per mixed dispatch) and
print each graph's kernel nodes, which the capture read from libcuda and
which every replay adds to the launch counts; the profile phases count the
host's kernel and graph launch calls slot by slot, admitting slots beside
the others, and hold the profiled decode kernels to the wrappers' counts.
fleet_serve serves four sync-free granite-3-2b replicas on the card
(``--replicas 4 --router drift``) and paged_fleet_serve two paged chunked
ones, replica 1 failing at slot 6: each prints its phase line first, then
checks that requests are conserved, every dispatch of every replica is a
replay, no slot synchronizes, the merged streams equal one engine's over
the same requests but at its near-ties, and, after the failure, that the
survivor finishes the requeued work with no page left held. obs_serve
serves the sync-free path with ``--metrics``, ``--trace-out`` and
``--decisions-out``: streams, trace columns, replays and launch counts
equal sync_serve's, 0 blocking syncs, the Prometheus text parses, the
lifecycle events and one rate record per slot (each record's argmax the
dispatched rate) check out, and ms per slot with telemetry off and on,
interleaved. slo_serve serves it with two tenants under ``--policy
conformal-slo`` in overload: trace, sheds, levels and the slo: line equal
the CPU run's, requests are conserved and every shed is in the decision
log. chaos_shared_x2 runs the reference's shared-x2 chaos cell at full
width (two paged prefix-sharing replicas, ``reliability.harness.
chaos_drive`` with replica failure, allocator shortfalls, readback delays
and prefix evictions): streams equal one clean engine's but at near-ties,
everything retires once, no page leaks. sampling holds
per-request sampling on the card to the CPU (the threefry keys and random
bits over the vocabulary bit for bit, ``sample_rows``' tokens but at
near-ties), and sampled_serve and sampled_chunked_serve serve the main and
chunked paths with temperature, top-k, top-p and a repetition penalty.
graph_ab serves each captured path
(dense fused, sync-free, paged, paged sync-free, Mamba-2, chunked, paged
chunked and the two sampled ones) eagerly and graphed in this call: ms per
slot, host launches per slot over a window of slots, and equal traces,
token streams and launch counts. fig2 replays the paper's Fig. 2 fixture (tests/fixtures/
fig2_golden.npz) through the port's rollouts on the card, bit for bit, and
holds the port's own Fig. 2 to the reference's claims. Then the
``kernels`` summary line, the card's name and power limit from
nvidia-smi, and the result line.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# |kernel - plain| allowed per element, per unit of (env + |plain|), where env
# is the plain version run on |v| (the weighted mean of |v| that the output
# averages). In bf16 each side rounds p (by at most 2^-8 of p, so of env in
# the output) and the output (2^-8 of it): the worst case is 2^-7 per unit,
# and the rule allows twice that. In f32 only the summation order differs.
KERNEL_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
L2_FLUSH_BYTES = 64 << 20   # larger than the 50 MB L2: every launch starts cold
# max |kernel-path logit - plain-path logit| over the full-width model's 17
# steps: about twice the largest reading (0.123 at logit scale 7.69, PERF.md);
# the two paths round bf16 hidden states at other points and 40 layers carry
# that forward. The faulty path in check_model shows what a wrong kernel gives.
MODEL_TOL = 0.25
SERVE_ARGS = ["--arch", "granite-3-2b", "--slots", "8", "--prompt-len", "512",
              "--min-prompt-len", "128", "--cache-len", "1024", "--raw-rate", "5",
              "--horizon", "12"]
# the paged path: 16 rows over a pool of 192 pages of 16 rows (3,072 tokens,
# ~252 MB of K/V over 40 layers), which prompts of 128-512 tokens fill
PAGED_POOL = ["--paged", "--max-active", "16", "--page-size", "16", "--num-pages", "192"]
PAGED_ARGS = SERVE_ARGS + PAGED_POOL + ["--policy", "memory-aware"]
SYNC_ARGS = SERVE_ARGS + ["--sync-free"]
# continuous batching under TokenBacklogAware: chunks of 512 // 4 = 128 and
# a token budget of one slot's chunk budget (8 x 128), at which the CPU
# rehearsal's rate both falls and rises within the 12 slots
CHUNKED_ARGS = SERVE_ARGS + ["--chunked", "--policy", "token-aware", "--token-budget", "1024"]
# the paged path over a mixed pool under PrecisionAware: 128 native bf16
# pages (~168 MB over 40 layers) and 64 int8 pages (~42 MB, plus scales);
# admissions move onto int8 pages once occupancy reaches 0.5 and back at 0.3,
# at which the CPU rehearsal's latch flips both ways within the 12 slots
QUANT_ARGS = SERVE_ARGS + PAGED_POOL + [
    "--policy", "precision-aware", "--kv-precision", "int8", "--quant-pages", "64",
    "--downgrade-at", "0.5", "--upgrade-at", "0.3"]
# the Mamba-2 path: the main path's geometry with mamba2-130m (24 layers, d 768,
# 24 SSD heads of 64, state 128, chunk 128, bf16); its admission prefill runs
# over the full 512-token bucket (a recurrent stack is not ragged)
SSM_ARGS = SERVE_ARGS + ["--arch", "mamba2-130m"]
SSM_SYNC_ARGS = SSM_ARGS + ["--sync-free"]
# the paged pool on the sync-free loop, and under continuous batching with
# the chunked serve's token budget (chunks of 128 written through the
# block tables, K4p)
PAGED_SYNC_ARGS = PAGED_ARGS + ["--sync-free"]
# the dense quantized ring: the main path over an int8 ring (K2q's decode),
# and the chunked path over an fp8 one (its prompt phase reads the native
# staging buffers through K4)
DENSE_QUANT_ARGS = SERVE_ARGS + ["--kv-precision", "int8"]
DENSE_QUANT_CHUNKED_ARGS = CHUNKED_ARGS + ["--kv-precision", "fp8"]
PAGED_CHUNKED_ARGS = SERVE_ARGS + PAGED_POOL + ["--chunked", "--policy", "token-aware",
                                                "--token-budget", "1024"]
# per-request sampling (the engine-default SamplingParams) on the main path
# and the chunked one: temperature, top-k, top-p and a repetition penalty,
# every token drawn with the reference's request-keyed threefry keys
SAMPLING = ["--temperature", "0.8", "--top-k", "50", "--top-p", "0.95", "--rep-penalty",
            "1.1", "--sampling-seed", "7"]
SAMPLED_ARGS = SERVE_ARGS + SAMPLING
SAMPLED_CHUNKED_ARGS = CHUNKED_ARGS + SAMPLING
# prefix_serve: the paged chunked loop with prefix sharing on an all-int8
# pool of PAGED_POOL's geometry, fed by tenants' system prompts (the
# shape of tests/test_differential.py::make_shared_workload and
# examples/serve_prefix_cache.py at full width): each prompt is one of 4
# tenants' 392-token system prompts (24 pages and a half) and a 16-120-token
# suffix, so a hit shares 24 pages and forks the 25th copy-on-write. The
# chunk budget is 4 chunks of 128 per slot: at the default (16 x 128) every
# claimed row prefills at once, the prompts overcommit the 192 pages, and
# eviction empties the index before a tenant's second request can hit it.
PREFIX_TENANTS, PREFIX_SYS_LEN, PREFIX_SUFFIX = 4, 392, (16, 120)
PREFIX_CHUNK_BUDGET = 512
# max |kernel-path logit - plain-path logit| of the full-width paged
# chunked prefill with prefix hits on an int8 pool and 16 decode steps
# (check_paged_chunk_model): 1.5x the largest reading (0.109 at logit
# scale 7.31, PERF.md), as SSM_MODEL_TOL was set. The chunk attention that
# reads staging for the hit lands 0.88-6.1 away, the one with unit scales
# 0.64-6.6.
PAGED_CHUNK_MODEL_TOL = 0.16
# max |kernel-path logit - plain-path logit| of the full-width mamba2-130m
# check (prefill logits around the chunk boundaries and 16 decode steps):
# 1.5x the largest reading (0.098 at logit scale 3.16, PERF.md). The kernel
# keeps the scan's weights and carried-state term in f32 where the plain
# version rounds them to bf16, and 24 layers carry that forward. The scan
# that drops the state carried between chunks lands 0.18-0.27 away at the
# steps after each chunk boundary.
SSM_MODEL_TOL = 0.15


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line per phase, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - T0, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
class Timer:
    """Mean ms of a callable over ``n`` launches, each after an L2 flush,
    timed by CUDA events around the launch alone."""

    def __init__(self):
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, n: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(n):
            self.flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / n


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------- kernels
def _prefill_work(B, S, H, KVH, hd, esize, lens, window):
    """Bytes and FLOPs this prefill needs: q/k/v rows below each row's
    length read once, the whole output written once, 4*hd FLOPs per
    (query, visible key) pair."""
    lens = [S] * B if lens is None else lens
    pairs = 0
    for n in lens:
        qpos = np.arange(n)
        lo = np.zeros(n) if window is None else np.maximum(qpos - window + 1, 0)
        pairs += int((qpos - lo + 1).sum())
    rows = sum(lens)
    nbytes = esize * (rows * (H + 2 * KVH) * hd + B * S * H * hd)
    return nbytes, 4.0 * hd * H * pairs


def _decode_work(B, L, H, KVH, hd, esize, sp, pos, window):
    """Bytes and FLOPs this decode needs: K/V of valid slots, all of
    slot_pos, q, pos and the output; 4*hd FLOPs per (head, valid slot)."""
    valid = (sp >= 0) & (sp <= pos[:, None])
    if window is not None:
        valid &= sp > pos[:, None] - window
    nv = int(valid.sum())
    nbytes = esize * (2 * nv * KVH * hd + 2 * B * H * hd) + 4 * (B * L + B)
    return nbytes, 4.0 * hd * H * nv


def _paged_work(H, KVH, hd, esize, ps, block_tables, pos):
    """Bytes and FLOPs this paged decode needs: K/V rows of valid slots
    (allocated page, j <= pos), q, the output, the block tables and pos;
    4*hd FLOPs per (head, valid slot)."""
    B, MP = block_tables.shape
    valid = np.repeat(block_tables >= 0, ps, axis=1) & (
        np.arange(MP * ps)[None, :] <= pos[:, None])
    nv = int(valid.sum())
    nbytes = esize * (2 * nv * KVH * hd + 2 * B * H * hd) + 4 * (block_tables.size + B)
    return nbytes, 4.0 * hd * H * nv


def _paged_inputs(rng, B, MP, ps, KVH, hd, pos):
    """A pool of B * MP pages and block tables over a random permutation of
    it: row b holds the pages covering positions 0..pos[b], then -1 (pos
    -1: an inactive row, all -1). Pool rows that no table reaches at or
    below its pos hold +-1e30, as recycled pages would. Numpy arrays."""
    N = B * MP
    perm = rng.permutation(N).astype(np.int32)
    bt = np.full((B, MP), -1, np.int32)
    live = np.zeros((N, ps), bool)
    for b in range(B):
        n = pos[b] // ps + 1 if pos[b] >= 0 else 0
        bt[b, :n] = perm[b * MP: b * MP + n]
        for j in range(pos[b] + 1):
            live[bt[b, j // ps], j % ps] = True
    k = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    junk = np.where(rng.random((N, ps, KVH, hd)) < 0.5, -1e30, 1e30).astype(np.float32)
    return (np.where(live[..., None, None], k, junk), np.where(live[..., None, None], v, -junk),
            bt, np.maximum(pos, 0).astype(np.int32))


def _chunk_work(H, KVH, hd, esize, C, sp, pos0, valid):
    """Bytes and FLOPs this chunk attention needs: q rows below each row's
    valid count, K/V and slot_pos of the slots up to its last query
    position (the kernel's live range), pos0/valid, the whole output; 4*hd
    FLOPs per (head, query, visible key)."""
    B, L = sp.shape
    live = pairs = 0
    for b in range(B):
        n = int(valid[b])
        if not n:
            continue
        end = min(int(pos0[b]) + n, L)
        live += end
        qpos = int(pos0[b]) + np.arange(n)
        pairs += int(((sp[b][None, :] >= 0) & (sp[b][None, :] <= qpos[:, None])).sum())
    rows = int(valid.sum())
    nbytes = esize * (rows * H * hd + 2 * live * KVH * hd + B * C * H * hd) + 4 * (live + 2 * B)
    return nbytes, 4.0 * hd * H * pairs


def _chunk_inputs(rng, B, C, L, KVH, hd):
    """A chunk mix: per row a first chunk (pos0 0), mid-prompt chunks (one
    with a hole in its prefix), partial final chunks (valid < C) and an
    inactive row (valid 0). Each row's cache holds positions 0..pos0+valid-1
    in order; every empty slot (beyond the written prefix, the hole) has
    slot_pos -1 and +-1e30 in K/V. Numpy arrays."""
    if C == 128:
        pos0 = np.asarray([0, 128, 256, 384, 128, 0, 128, 256], np.int32)[:B]
        valid = np.asarray([128, 128, 128, 77, 0, 128, 128, 50], np.int32)[:B]
    else:
        pos0 = np.asarray([0, C, 2 * C, C], np.int32)[:B]
        valid = np.asarray([C, C, C - 3, 0], np.int32)[:B]
    sp = np.full((B, L), -1, np.int32)
    for b in range(B):
        end = int(pos0[b] + valid[b])
        sp[b, :end] = np.arange(end)
    sp[1, 5] = -1
    k = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    junk = np.where(rng.random((B, L, KVH, hd)) < 0.5, -1e30, 1e30).astype(np.float32)
    empty = (sp < 0)[..., None, None]
    return np.where(empty, junk, k), np.where(empty, -junk, v), sp, pos0, valid


def _chunk_tiles(H, C, pos0, valid, k_end, has_key=None):
    """The 64 x 64 CTA-tiles a chunk kernel computes and its longest CTA
    chain, counted from the inputs as the kernel walks them: per (batch
    row, head) each 64-query tile below ``valid`` visits the key tiles
    below ``k_end(b, last)`` (``last`` one past the tile's last live query
    position), less those ``has_key(b, t, end)`` finds without a key."""
    tiles = chain = 0
    for b in range(len(valid)):
        nv, p0 = int(valid[b]), int(pos0[b])
        for q0 in range(0, min(C, nv), 64):
            end = k_end(b, p0 + min(q0 + 64, nv))
            n = sum(1 for t in range(-(-end // 64)) if has_key is None or has_key(b, t, end))
            tiles += H * n
            chain = max(chain, n)
    return {"cta_tiles": tiles, "longest_chain": chain}


def _ring_slot_pos(B, L, pos):
    """slot i holds the latest position p <= pos with p % L == i (-1: none)."""
    i = np.arange(L)[None, :]
    p = pos[:, None]
    sp = np.where(i <= p % L, p - p % L + i, p - p % L - L + i)
    return np.where(sp < 0, -1, sp).astype(np.int32)


# which kernel serves each dtype of q, in csrc/flash_attention.cu (K1) and in
# the chunk attention files (K4, K4p, K4q) alike
KERNEL_ROUTE = {torch.bfloat16: "wgmma (tensor cores)", torch.float32: "CUDA cores"}


def _rising(S):
    """(S,) factors 1, 2, 3, ... per 64-key tile: keys scaled by them make
    each later KV tile hold a new row maximum, so every tile rescales the
    running output."""
    return (1 + torch.arange(S, device="cuda") // 64).float()


def check_kernels(timer) -> dict:
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import paged_attention as kp
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def record(case, name, dtype, got, want, env, fn, plain, lib, work, main,
               library="scaled_dot_product_attention", rtol=KERNEL_RTOL, device=False,
               **extra):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        tol = rtol[dtype] * (env.float() + want.float().abs())
        err, worst = diff.max().item(), (diff / tol.clamp_min(1e-30)).max().item()
        bms, by = bound(*work, dtype)
        row = {"case": case, "kernel": name, "dtype": str(dtype).removeprefix("torch."),
               "max_abs_err": err, "max_err_over_tol": worst,
               "tol_at_max_err": tol.flatten()[diff.argmax()].item(),
               "ms": timer(fn), "plain_ms": timer(plain, n=5),
               "bound_ms": bms, "bound_us": bms * 1e3, "bound_by": by,
               "library_ms": timer(lib) if lib is not None else None, "library": library,
               "bytes": work[0], "flops": work[1], **extra}
        if main or device:   # the device time of the kernel and of its library route
            row["device_ms"] = _device_ms(fn)
            row["library_device_ms"] = _device_ms(lib) if lib is not None else None
        if main:
            rows[name] = row
        emit("kernels", **row)
        if not worst <= 1.0:
            raise AssertionError(f"{case}: an element is {worst:.3g}x its tolerance")
        if "device_ms" in row:
            _hold_to_bound(case, row["device_ms"], bms)

    def sdpa_prefill(q, k, v, lens, window, causal_only):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if causal_only:
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True)
        mask = _prefill_mask(q.shape[1], lens, window)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

    # K1 / K1r: (B, S, H, KVH, hd, dtype, main-path shape and dtype?). bf16
    # runs the wgmma kernel, f32 the CUDA-core one; the f32 run of the
    # main-path shape holds the CUDA-core kernel's cross-tile rescale and
    # tile skips to 2e-5, and the bf16 rising-score runs (each later KV tile
    # holds a new row maximum) hold the wgmma kernel's.
    for B, S, H, KVH, hd, dtype, main in ((8, 512, 32, 8, 64, torch.bfloat16, True),
                                          (8, 512, 32, 8, 64, torch.float32, False),
                                          (4, 16, 8, 2, 32, torch.float32, False)):
        q = randn((B, S, H, hd), dtype)
        k, v = randn((B, S, KVH, hd), dtype), randn((B, S, KVH, hd), dtype)
        lens_l = ([512, 300, 129, 1, 512, 64, 200, 511] if S == 512 else [16, 1, 9, 5])
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        esize = q.element_size()
        variants = [("flash_attention", None, None, k),
                    ("flash_attention_ragged", lens, None, k),
                    ("flash_attention", None, 37 if S == 512 else 5, k)]
        if dtype == torch.bfloat16:
            kr = (k.float() * _rising(S)[None, :, None, None]).to(dtype)
            variants += [("flash_attention", None, None, kr),
                         ("flash_attention_ragged", lens, None, kr)]
        for name, sl, win, kk in variants:
            case = f"{name} B{B} S{S} H{H}/{KVH} hd{hd} {str(dtype)[6:]}" + (
                f" window{win}" if win else "") + (" rising-scores" if kk is not k else "")
            fn = lambda sl=sl, win=win, kk=kk: kf.flash_attention(q, kk, v, sl, window=win)
            plain = lambda sl=sl, win=win, kk=kk: ref.attention_ref(q, kk, v, window=win,
                                                                    seq_lens=sl)
            env = ref.attention_ref(q, kk, v.abs(), window=win, seq_lens=sl)
            record(case, name, dtype, fn(), plain(), env, fn, plain,
                   sdpa_prefill(q, kk, v, sl, win, sl is None and win is None),
                   _prefill_work(B, S, H, KVH, hd, esize, lens_l if sl is not None else None, win),
                   main and win is None and kk is k, instantiation=KERNEL_ROUTE[dtype])

    # K2: ring caches with empty slots (row 0) and wrapped rows
    for B, L, H, KVH, hd, dtype, main in ((8, 1024, 32, 8, 64, torch.bfloat16, True),
                                          (8, 1024, 32, 8, 64, torch.float32, False),
                                          (4, 64, 8, 2, 32, torch.float32, False)):
        q = randn((B, H, hd), dtype)
        k, v = randn((B, L, KVH, hd), dtype), randn((B, L, KVH, hd), dtype)
        pos_np = np.asarray([L // 2 - 1] + [L + 37 * b for b in range(1, B)], np.int32)
        sp_np = _ring_slot_pos(B, L, pos_np)
        sp, pos = torch.from_numpy(sp_np).cuda(), torch.from_numpy(pos_np).cuda()
        for win in (None, 300 if L == 1024 else 20):
            case = f"decode_attention B{B} L{L} H{H}/{KVH} hd{hd} {str(dtype)[6:]}" + (
                f" window{win}" if win else "")
            fn = lambda win=win: kd.decode_attention(q, k, v, sp, pos, window=win)
            plain = lambda win=win: ref.decode_attention_ref(q, k, v, sp, pos, window=win)
            env = ref.decode_attention_ref(q, k, v.abs(), sp, pos, window=win)
            valid = (sp >= 0) & (sp <= pos[:, None])
            if win is not None:
                valid = valid & (sp > pos[:, None] - win)
            qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            mask = valid[:, None, None, :]
            lib = lambda mask=mask: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                   enable_gqa=True)
            record(case, "decode_attention", dtype, fn(), plain(), env, fn, plain, lib,
                   _decode_work(B, L, H, KVH, hd, q.element_size(), sp_np, pos_np, win),
                   main and win is None, device=main)
    # K2 at the granite serves' own geometry: rows that have not wrapped
    # (prompts of 128-512 plus decode steps in a ring of 1024), so about
    # half of the ring's tiles hold no valid slot and are skipped unread
    B, L, H, KVH, hd, dtype = 8, 1024, 32, 8, 64, torch.bfloat16
    pos_np = np.random.default_rng(21).integers(128, 541, B).astype(np.int32)
    sp_np = _ring_slot_pos(B, L, pos_np)
    q = randn((B, H, hd), dtype)
    k, v = randn((B, L, KVH, hd), dtype), randn((B, L, KVH, hd), dtype)
    sp, pos = torch.from_numpy(sp_np).cuda(), torch.from_numpy(pos_np).cuda()
    fn = lambda: kd.decode_attention(q, k, v, sp, pos)
    plain = lambda: ref.decode_attention_ref(q, k, v, sp, pos)
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = ((sp >= 0) & (sp <= pos[:, None]))[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    record(f"decode_attention B{B} L{L} H{H}/{KVH} hd{hd} bf16 unwrapped pos 128-540",
           "decode_attention", dtype, fn(), plain(),
           ref.decode_attention_ref(q, k, v.abs(), sp, pos), fn, plain, lib,
           _decode_work(B, L, H, KVH, hd, q.element_size(), sp_np, pos_np, None), False,
           device=True, valid_tiles=int(((sp_np >= 0).reshape(B, L // 64, 64)).any(-1).sum()),
           tiles=B * L // 64)

    # K3: the paged serve's shape (16 rows, 64-page tables of 16 rows), pos
    # spread over 128-1023, tables over a random permutation of the pool
    # with trailing -1, garbage in every row no table reaches; the small
    # case adds an inactive row (no valid slot: the kernel writes zeros,
    # the plain version averages garbage page 0, so it is checked apart)
    rng = np.random.default_rng(3)
    for B, MP, ps, H, KVH, hd, dtype, main in ((16, 64, 16, 32, 8, 64, torch.bfloat16, True),
                                               (16, 64, 16, 32, 8, 64, torch.float32, False),
                                               (4, 6, 8, 8, 2, 32, torch.float32, False)):
        pos_np = rng.integers(128 if MP * ps > 128 else ps, MP * ps, B).astype(np.int32)
        if not main:
            pos_np[0] = -1
        k_np, v_np, bt_np, pos_np = _paged_inputs(rng, B, MP, ps, KVH, hd, pos_np)
        q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).cuda().to(dtype)
        k, v = (torch.from_numpy(a).cuda().to(dtype) for a in (k_np, v_np))
        bt, pos = torch.from_numpy(bt_np).cuda(), torch.from_numpy(pos_np).cuda()
        has = torch.from_numpy((bt_np >= 0).any(axis=1)).cuda()
        case = f"paged_decode_attention B{B} MP{MP} ps{ps} H{H}/{KVH} hd{hd} {str(dtype)[6:]}"
        fn = lambda: kp.paged_decode_attention(q, k, v, bt, pos)
        plain = lambda: ref.paged_decode_attention_ref(q, k, v, bt, pos)
        env = ref.paged_decode_attention_ref(q, k, v.abs(), bt, pos)
        got = fn()
        torch.cuda.synchronize()
        if got[~has].any():
            raise AssertionError(f"{case}: a row with no valid slot is not zeros")
        N = k.shape[0]
        flat = bt.clamp(0, N - 1).flatten()
        valid = (torch.repeat_interleave(bt >= 0, ps, dim=1)
                 & (torch.arange(MP * ps, device="cuda")[None, :] <= pos[:, None]))
        mask = valid[:, None, None, :]

        def lib(flat=flat, mask=mask, q=q, k=k, v=v, B=B, MP=MP, ps=ps, KVH=KVH, hd=hd):
            kk = k.index_select(0, flat).view(B, MP * ps, KVH, hd).transpose(1, 2)
            vv = v.index_select(0, flat).view(B, MP * ps, KVH, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(q[:, :, None], kk, vv, attn_mask=mask,
                                                  enable_gqa=True)
        record(case, "paged_decode_attention", dtype, got[has], plain()[has], env[has], fn,
               plain, lib, _paged_work(H, KVH, hd, q.element_size(), ps, bt_np, pos_np), main,
               library="index_select of the K and V pages + scaled_dot_product_attention")
    # K4: the chunked serve's shape (8 rows, chunks of 128, ring 1024) with
    # the chunk mix above; the small case has an inactive row too
    from repro_torch.kernels import chunk_attention as kc
    for B, C, L, H, KVH, hd, dtype, main in ((8, 128, 1024, 32, 8, 64, torch.bfloat16, True),
                                             (8, 128, 1024, 32, 8, 64, torch.float32, False),
                                             (4, 16, 64, 8, 2, 32, torch.float32, False)):
        k_np, v_np, sp_np, p0_np, nv_np = _chunk_inputs(rng, B, C, L, KVH, hd)
        q = torch.from_numpy(rng.standard_normal((B, C, H, hd)).astype(np.float32)).cuda().to(dtype)
        k, v = (torch.from_numpy(a).cuda().to(dtype) for a in (k_np, v_np))
        sp, pos0, valid = (torch.from_numpy(a).cuda() for a in (sp_np, p0_np, nv_np))
        case = f"chunk_attention B{B} C{C} L{L} H{H}/{KVH} hd{hd} {str(dtype)[6:]}"
        fn = lambda: kc.chunk_attention(q, k, v, sp, pos0, valid)
        plain = lambda: ref.chunk_attention_ref(q, k, v, sp, pos0, valid)
        env = ref.chunk_attention_ref(q, k, v.abs(), sp, pos0, valid)
        got = fn()
        torch.cuda.synchronize()
        if got[torch.from_numpy(nv_np == 0).cuda()].any():
            raise AssertionError(f"{case}: an inactive row is not zeros")
        qpos = pos0[:, None] + torch.arange(C, device="cuda")[None, :]
        mask = ((sp[:, None, :] >= 0) & (sp[:, None, :] <= qpos[:, :, None]))[:, None]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = lambda mask=mask, qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        record(case, "chunk_attention", dtype, got, plain(), env, fn, plain, lib,
               _chunk_work(H, KVH, hd, q.element_size(), C, sp_np, p0_np, nv_np), main,
               instantiation=KERNEL_ROUTE[dtype],
               **_chunk_tiles(H, C, p0_np, nv_np,
                              lambda b, last, p0_np=p0_np, L=L: last
                              if p0_np[b] >= 0 and last <= L else L))
    check_flash_anatomy(timer)
    check_quant_kernel(rng, record)
    check_quant_attention_kernels(rng, record)
    check_paged_chunk_kernels(rng, record)
    check_chunk_anatomy(rows)
    check_ssd_kernel(record)
    rows.update(check_ssd_anatomy(timer))
    return rows


def check_flash_anatomy(timer) -> None:
    """What bounds the bf16 prefill kernel: K1 at the main shape beside
    variants that each change one factor, with the CTA-tiles each computes
    (64 queries x 64 keys, the diagonal tiles' masked halves included) and
    the tensor-core rate on them: every tile without masking (non-causal),
    more tiles per CTA (S 2048, B 2), four times the K/V bytes over the same
    tiles (no GQA: KV heads = query heads) and twice the FLOPs per tile (hd
    128 on half the heads)."""
    from repro_torch.kernels import flash_attention as kf

    g = torch.Generator(device="cuda").manual_seed(18)
    variants = []
    for label, B, S, H, KVH, hd, causal in (("main", 8, 512, 32, 8, 64, True),
                                            ("non-causal", 8, 512, 32, 8, 64, False),
                                            ("S 2048", 2, 2048, 32, 8, 64, True),
                                            ("no GQA", 8, 512, 32, 32, 64, True),
                                            ("hd 128", 8, 512, 16, 4, 128, True)):
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                   for shape in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd)))
        ms = timer(lambda q=q, k=k, v=v, causal=causal: kf.flash_attention(q, k, v,
                                                                            causal=causal))
        nq = S // 64
        tiles = B * H * (nq * (nq + 1) // 2 if causal else nq * nq)
        variants.append({"variant": label, "B": B, "S": S, "H": H, "KVH": KVH, "hd": hd,
                         "causal": causal, "ms": ms, "cta_tiles": tiles,
                         "us_per_1000_tiles": ms * 1e6 / tiles,
                         "tflops_on_tiles": tiles * 4.0 * 64 * 64 * hd / ms / 1e9})
    emit("flash_anatomy", variants=variants)


def _device_ms(fn, n: int = 20, sessions: int = 3) -> float:
    """Mean device time of one ``fn()`` call over ``n`` calls, each after an
    L2 flush: the time of the kernels it launches, from torch.profiler, so
    the host's time to issue them is not in it (the flush's kernel is left
    out). ``Timer`` reads event to event, which takes in the host's issue
    time where a call's kernels are shorter than it.

    The calls run ``PROFILE_MARGIN_S`` after the profile starts and it
    stops that long after they end. A session counts only if its profile
    holds a device record of every kernel launch its host side shows
    (``_launches_unrecorded``), ``n`` flushes, and each port kernel as
    many times as its wrappers launched it; one that does not is run
    again, up to ``sessions`` in all. If none of them was
    complete, the calls are timed with CUDA events around each call
    instead, and a ``device_ms_by_events`` line says so."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(sessions):
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(n):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        us, records = 0.0, {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            records[e.key] = records.get(e.key, 0) + e.count
            if "bitwise_not" not in e.key:
                dev = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if dev is None else dev
        issued, unrecorded = _launches_unrecorded(prof)
        flushes = sum(c for k, c in records.items() if "bitwise_not" in k)
        ours = _function_records(records)
        launched = kernels.function_counts(kernels.launch_counts())
        if (issued and not unrecorded and flushes == n
                and all(ours.get(f, 0) == c for f, c in launched.items())):
            return us / n / 1e3
        seen.append({"launches": issued, "without_a_device_record": unrecorded,
                     "flushes": flushes,
                     "port_kernels": {f: [ours.get(f, 0), c] for f, c in launched.items()}})
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(n)]
    for start, end in pairs:
        flush.bitwise_not_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sum(start.elapsed_time(end) for start, end in pairs) / n
    emit("device_ms_by_events", profiler_sessions=seen, ms=ms)
    if not ms > 0:
        raise AssertionError("neither the profiler nor CUDA events saw device time")
    return ms


# torch.profiler (kineto) keeps only the device records whose timestamps,
# converted to the host's clock, fall inside its window, and on the H100 it
# dropped records of kernels run right at the window's edges (its log counts
# them "Out-of-range"): whole calls of some _device_ms sessions, 44 of 960 K3
# in one serve profile. So every profile opens this long before its work and
# closes this long after it.
PROFILE_MARGIN_S = 0.05


def _function_records(records: dict) -> dict:
    """Profiled records (kernel name -> count) per kernel function, keyed as
    ``kernels.function_counts``: the unqualified name, ``_wgmma`` dropped."""
    out: dict = {}
    for k, c in records.items():
        m = re.search(r"::(\w+)[<(]", k)
        if m:
            f = m.group(1).removesuffix("_wgmma")
            out[f] = out.get(f, 0) + c
    return out


def _launches_unrecorded(prof) -> tuple:
    """(kernel and graph launches a profile's host side issued, how many of
    them have no device record), matched by CUPTI correlation id."""
    events = prof.profiler.kineto_results.events()
    ran = {e.correlation_id() for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA}
    issued = [e.correlation_id() for e in events
              if e.device_type() == torch.autograd.DeviceType.CPU and _LAUNCH_CALL.match(e.name())]
    return len(issued), sum(c not in ran for c in issued)


def _hold_to_bound(name: str, device_ms: float, bound_ms: float) -> None:
    """No kernel beats the card's bound for its work: a device time below
    it is a measurement that lost kernels, or a bound that overcounts."""
    if not device_ms >= bound_ms:
        raise AssertionError(f"{name}: device time {device_ms:.5g} ms is below the bound "
                             f"{bound_ms:.5g} ms")


# the main bf16 cases of the kernels phase that chunk_anatomy reads
CHUNK_ANATOMY = ("chunk_attention", "chunk_attention_quant", "paged_chunk_attention",
                 "paged_chunk_attention_quant")


def check_chunk_anatomy(rows) -> None:
    """What bounds the bf16 chunk kernels: for the main K4, K4q and K4p
    cases of the kernels phase, the CTA-tiles each computes (64 chunk
    queries x 64 key slots, skipped tiles not counted) and the longest CTA
    chain, beside the device time of the kernel and of its library route
    (``_device_ms``, read by the kernels phase for every main row; its
    ``ms`` is kept beside it), and from the kernel's device time the time
    per 1,000 tiles across the card, the tensor-core rate on the tiles
    computed and the time per tile of the longest chain."""
    cases = []
    for name in CHUNK_ANATOMY:
        r = rows[name]
        hd = int(r["case"].split(" hd")[1].split()[0])
        dev, lib_dev = r["device_ms"], r["library_device_ms"]
        cases.append({"kernel": name, "case": r["case"], "instantiation": r["instantiation"],
                      "ms": r["ms"], "device_ms": dev, "library": r["library"],
                      "library_device_ms": lib_dev, "over_library": dev / lib_dev,
                      "cta_tiles": r["cta_tiles"], "longest_chain": r["longest_chain"],
                      "us_per_1000_tiles": dev * 1e6 / r["cta_tiles"],
                      "tflops_on_tiles": r["cta_tiles"] * 4.0 * 64 * 64 * hd / dev / 1e9,
                      "us_per_chain_tile": dev * 1e3 / r["longest_chain"]})
    emit("chunk_anatomy", cases=cases)


def _abs_codes(c):
    """|dequantized value| as codes: int8 magnitudes, or fp8 with the sign
    bit cleared (the scales are positive)."""
    if c.dtype == torch.int8:
        return c.abs()
    return (c.view(torch.uint8) & 0x7F).view(torch.float8_e4m3fn)


def _quant_work(H, KVH, hd, esize, ps, Nn, block_tables, pos):
    """Bytes and FLOPs this quantized or mixed paged decode needs: per valid
    slot its K and V rows, in q's dtype on a native page or as one-byte
    codes plus a 4-byte scale per KV head on a quantized page; q, the
    output, the block tables and pos; 4*hd FLOPs per (head, valid slot)."""
    B, MP = block_tables.shape
    slot_ok = np.repeat(block_tables >= 0, ps, axis=1) & (
        np.arange(MP * ps)[None, :] <= pos[:, None])
    quant = np.repeat(block_tables >= Nn, ps, axis=1) & slot_ok
    nv, nq = int(slot_ok.sum()), int(quant.sum())
    nbytes = (2 * KVH * ((nv - nq) * hd * esize + nq * (hd + 4)) + esize * 2 * B * H * hd
              + 4 * (block_tables.size + B))
    return nbytes, 4.0 * hd * H * nv


def check_quant_kernel(rng, record) -> None:
    """K3q at K3's main-path shape (16 rows, 64-page tables of 16 rows, H
    32/8, hd 64) in bf16 and f32, over an all-int8 pool, an all-fp8 pool
    and a mixed pool (the lower half native, the upper half int8): rows 1-3
    at page-boundary positions, an inactive row 0 (all -1: the kernel
    writes zeros, checked apart), unallocated table tails, +-1e30 garbage
    (quantized to +-qmax codes) in every row no table reaches. The mixed
    bf16 case is the quantized serve's and goes into the ``kernels`` line.
    Each case also holds K3q to K3 over the same pool with its code pages
    dequantized (``dequantize_kv``) after the native ones, under the same
    table ids: equal bit for bit, as both run decode_core.cuh."""
    from repro_torch.cache import parse_kv_precision
    from repro_torch.kernels import paged_attention as kp
    from repro_torch.kernels import paged_attention_quant as kq
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import dequantize_kv, quantize_kv

    B, MP, ps, H, KVH, hd = 16, 64, 16, 32, 8, 64
    for pool in ("mixed", "int8", "fp8"):
        pos_np = rng.integers(128, MP * ps, B).astype(np.int32)
        pos_np[1:4] = (ps - 1, ps, 2 * ps - 1)
        pos_np[0] = -1
        k_np, v_np, bt_np, pos_np = _paged_inputs(rng, B, MP, ps, KVH, hd, pos_np)
        prec = parse_kv_precision("fp8" if pool == "fp8" else "int8")
        Nn = k_np.shape[0] // 2 if pool == "mixed" else 0
        qk, ks = quantize_kv(torch.from_numpy(k_np[Nn:]).cuda(), prec)
        qv, vs = quantize_kv(torch.from_numpy(v_np[Nn:]).cuda(), prec)
        bt, pos = torch.from_numpy(bt_np).cuda(), torch.from_numpy(pos_np).cuda()
        has = torch.from_numpy((bt_np >= 0).any(axis=1)).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).cuda()
            q = q.to(dtype)
            k = v = None
            if Nn:
                k, v = (torch.from_numpy(a[:Nn]).cuda().to(dtype) for a in (k_np, v_np))
            case = f"paged_decode_attention_quant {pool} B{B} MP{MP} ps{ps} H{H}/{KVH} hd{hd} " \
                   f"{str(dtype)[6:]}"
            fn = lambda q=q, k=k, v=v: kq.paged_decode_attention_quant(q, k, v, qk, qv, ks, vs,
                                                                        bt, pos)
            if Nn:
                plain = lambda q=q, k=k, v=v: ref.paged_decode_attention_mixed_ref(
                    q, k, v, qk, qv, ks, vs, bt, pos)
                env = ref.paged_decode_attention_mixed_ref(q, k, v.abs(), qk, _abs_codes(qv), ks,
                                                           vs, bt, pos)
            else:
                plain = lambda q=q: ref.paged_decode_attention_quant_ref(q, qk, qv, ks, vs, bt,
                                                                         pos)
                env = ref.paged_decode_attention_quant_ref(q, qk, _abs_codes(qv), ks, vs, bt, pos)
            got = fn()
            kk, vv = dequantize_kv(qk, ks, dtype), dequantize_kv(qv, vs, dtype)
            if k is not None:
                kk, vv = torch.cat((k, kk)), torch.cat((v, vv))
            native = kp.paged_decode_attention(q, kk, vv, bt, pos)
            torch.cuda.synchronize()
            if got[~has].any():
                raise AssertionError(f"{case}: a row with no valid slot is not zeros")
            if not torch.equal(got, native):
                raise AssertionError(f"{case}: not K3 over the dequantized pool bit for bit")
            flat = bt.clamp(0, k_np.shape[0] - 1).flatten()
            valid = (torch.repeat_interleave(bt >= 0, ps, dim=1)
                     & (torch.arange(MP * ps, device="cuda")[None, :] <= pos[:, None]))
            mask = valid[:, None, None, :]

            def lib(q=q, k=k, v=v, flat=flat, mask=mask):
                kk, vv = dequantize_kv(qk, ks, q.dtype), dequantize_kv(qv, vs, q.dtype)
                if k is not None:
                    kk, vv = torch.cat((k, kk)), torch.cat((v, vv))
                kk = kk.index_select(0, flat).view(B, MP * ps, KVH, hd).transpose(1, 2)
                vv = vv.index_select(0, flat).view(B, MP * ps, KVH, hd).transpose(1, 2)
                return F.scaled_dot_product_attention(q[:, :, None], kk, vv, attn_mask=mask,
                                                      enable_gqa=True)
            record(case, "paged_decode_attention_quant", dtype, got[has], plain()[has], env[has],
                   fn, plain, lib,
                   _quant_work(H, KVH, hd, q.element_size(), ps, Nn, bt_np, pos_np),
                   pool == "mixed" and dtype == torch.bfloat16,
                   library="dequantize + index_select of the K and V pages + "
                           "scaled_dot_product_attention", equal_to_k3_dequantized=True)


def _prefill_quant_work(B, S, H, KVH, hd, esize, lens, window):
    """``_prefill_work`` over codes: per K/V row below a row's length one
    byte per code and a 4-byte scale per KV head."""
    nbytes, flops = _prefill_work(B, S, H, KVH, hd, esize, lens, window)
    rows = B * S if lens is None else sum(lens)
    return nbytes - esize * 2 * rows * KVH * hd + 2 * rows * KVH * (hd + 4), flops


def _decode_quant_work(B, L, H, KVH, hd, esize, sp, pos, window):
    """``_decode_work`` over ring codes: per valid slot one byte per code
    and a 4-byte scale per KV head."""
    nbytes, flops = _decode_work(B, L, H, KVH, hd, esize, sp, pos, window)
    valid = (sp >= 0) & (sp <= pos[:, None])
    if window is not None:
        valid &= sp > pos[:, None] - window
    nv = int(valid.sum())
    return nbytes - esize * 2 * nv * KVH * hd + 2 * nv * KVH * (hd + 4), flops


def _prefill_mask(S, lens, window):
    """The boolean (B or 1, 1, S, S) mask of a causal prefill with a window
    and per-row lengths, for scaled_dot_product_attention."""
    qp = torch.arange(S, device="cuda")[:, None]
    kp = torch.arange(S, device="cuda")[None, :]
    mask = (kp <= qp)[None]
    if window is not None:
        mask = mask & (kp > qp - window)[None]
    if lens is not None:
        mask = mask & (kp[None] < lens[:, None, None])
    return mask[:, None]


# the quantized prefill's ragged lengths at the main path's shape (128-512)
QUANT_PREFILL_LENS = [512, 300, 129, 128, 450, 200, 384, 511]


def check_quant_attention_kernels(rng, record) -> None:
    """K1q/K1rq (one kernel) and K2q against their plain versions
    (``attention_quant_ref``, ``decode_attention_quant_ref``) over int8 and
    fp8 codes, bf16 and f32 q: K1q at the main path's prefill (B 8, S 512,
    H 32/8, hd 64) dense, ragged (lengths 128-512) and with a window of 37,
    and at the smoke shapes in f32; an extreme-scale sweep in f32 (the KV
    heads' values spread over 1e-3..1e3, so their scales do) held to the
    same f32 rule; K2q over a ring of 1,024 slots (rows 0 and 1 partly
    empty, the rest wrapped) with and without a window of 300, and at the
    smoke shapes in f32, each also held to K2 over the dequantized ring
    (``dequantize_kv``): equal bit for bit, as both run decode_core.cuh;
    and K2q at the dense int8 serve's own geometry (unwrapped rows, pos
    128-540), as K2's row in check_kernels. The library route, timed for the
    record only, is dequantize + one scaled_dot_product_attention. The int8
    bf16 cases without a window go into the ``kernels`` line."""
    from repro_torch.cache import parse_kv_precision
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import dequantize_kv, quantize_kv

    def codes(shape, prec, spread=None, rising=False):
        out = []
        for i in range(2):
            x = rng.standard_normal(shape).astype(np.float32)
            if spread is not None:
                x *= spread[None, None, :, None]
            if rising and i == 0:   # K only: see _rising
                x *= _rising(shape[1]).cpu().numpy()[None, :, None, None]
            out.extend(quantize_kv(torch.from_numpy(x).cuda(), parse_kv_precision(prec)))
        qk, ks, qv, vs = out
        return qk, qv, ks, vs

    lib_name = "dequantize + scaled_dot_product_attention"
    # (..., extreme: KV heads' scales spread over 1e-3..1e3, rising: see _rising)
    prefill_cases = [(8, 512, 32, 8, 64, prec, dtype, False, False) for prec in ("int8", "fp8")
                     for dtype in (torch.bfloat16, torch.float32)]
    prefill_cases += [(4, 16, 8, 2, 32, prec, torch.float32, False, False)
                      for prec in ("int8", "fp8")]
    prefill_cases += [(8, 512, 32, 8, 64, prec, torch.float32, True, False)
                      for prec in ("int8", "fp8")]
    prefill_cases += [(8, 512, 32, 8, 64, "int8", torch.bfloat16, False, True)]
    for B, S, H, KVH, hd, prec, dtype, extreme, rising in prefill_cases:
        spread = np.logspace(-3, 3, KVH).astype(np.float32) if extreme else None
        qk, qv, ks, vs = codes((B, S, KVH, hd), prec, spread, rising)
        q = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32)).cuda()
        q = q.to(dtype)
        lens_l = QUANT_PREFILL_LENS if S == 512 else [16, 1, 9, 5]
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        variants = [(None, None), (lens, None)] + ([] if extreme or rising else [
            (None, 37 if S == 512 else 5)])
        for sl, win in variants:
            name = "flash_attention_quant" + ("" if sl is None else "_ragged")
            case = (f"{name} {prec} B{B} S{S} H{H}/{KVH} hd{hd} {str(dtype)[6:]}"
                    + (f" window{win}" if win else "") + (" extreme-scales" if extreme else "")
                    + (" rising-scores" if rising else ""))
            fn = lambda q=q, qk=qk, qv=qv, ks=ks, vs=vs, sl=sl, win=win: \
                kf.flash_attention_quant(q, qk, qv, ks, vs, sl, window=win)
            plain = lambda q=q, qk=qk, qv=qv, ks=ks, vs=vs, sl=sl, win=win: \
                ref.attention_quant_ref(q, qk, qv, ks, vs, window=win, seq_lens=sl)
            env = ref.attention_quant_ref(q, qk, _abs_codes(qv), ks, vs, window=win, seq_lens=sl)
            mask = None if sl is None and win is None else _prefill_mask(S, sl, win)

            def lib(q=q, qk=qk, qv=qv, ks=ks, vs=vs, mask=mask):
                kk = dequantize_kv(qk, ks, q.dtype).transpose(1, 2)
                vv = dequantize_kv(qv, vs, q.dtype).transpose(1, 2)
                if mask is None:
                    return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv,
                                                          is_causal=True, enable_gqa=True)
                return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv,
                                                      attn_mask=mask, enable_gqa=True)
            record(case, name, dtype, fn(), plain(), env, fn, plain, lib,
                   _prefill_quant_work(B, S, H, KVH, hd, q.element_size(),
                                       lens_l if sl is not None else None, win),
                   prec == "int8" and dtype == torch.bfloat16 and win is None and S == 512
                   and not rising, library=lib_name, instantiation=KERNEL_ROUTE[dtype])

    decode_cases = [(8, 1024, 32, 8, 64, prec, dtype) for prec in ("int8", "fp8")
                    for dtype in (torch.bfloat16, torch.float32)]
    decode_cases += [(4, 64, 8, 2, 32, prec, torch.float32) for prec in ("int8", "fp8")]
    for B, L, H, KVH, hd, prec, dtype in decode_cases:
        qk, qv, ks, vs = codes((B, L, KVH, hd), prec)
        q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).cuda().to(dtype)
        pos_np = np.asarray([L // 2 - 1, L // 8] + [L + 37 * b for b in range(2, B)], np.int32)
        sp_np = _ring_slot_pos(B, L, pos_np)
        sp, pos = torch.from_numpy(sp_np).cuda(), torch.from_numpy(pos_np).cuda()
        for win in (None, 300 if L == 1024 else 20):
            case = (f"decode_attention_quant {prec} B{B} L{L} H{H}/{KVH} hd{hd} "
                    f"{str(dtype)[6:]}" + (f" window{win}" if win else ""))
            fn = lambda q=q, qk=qk, qv=qv, ks=ks, vs=vs, win=win: kd.decode_attention_quant(
                q, qk, qv, ks, vs, sp, pos, window=win)
            plain = lambda q=q, qk=qk, qv=qv, ks=ks, vs=vs, win=win: \
                ref.decode_attention_quant_ref(q, qk, qv, ks, vs, sp, pos, window=win)
            env = ref.decode_attention_quant_ref(q, qk, _abs_codes(qv), ks, vs, sp, pos,
                                                 window=win)
            valid = (sp >= 0) & (sp <= pos[:, None])
            if win is not None:
                valid = valid & (sp > pos[:, None] - win)
            mask = valid[:, None, None, :]

            def lib(q=q, qk=qk, qv=qv, ks=ks, vs=vs, mask=mask):
                kk = dequantize_kv(qk, ks, q.dtype).transpose(1, 2)
                vv = dequantize_kv(qv, vs, q.dtype).transpose(1, 2)
                return F.scaled_dot_product_attention(q[:, :, None], kk, vv, attn_mask=mask,
                                                      enable_gqa=True)
            got = fn()
            native = kd.decode_attention(q, dequantize_kv(qk, ks, dtype),
                                         dequantize_kv(qv, vs, dtype), sp, pos, window=win)
            torch.cuda.synchronize()
            if not torch.equal(got, native):
                raise AssertionError(f"{case}: not K2 over the dequantized ring bit for bit")
            record(case, "decode_attention_quant", dtype, got, plain(), env, fn, plain, lib,
                   _decode_quant_work(B, L, H, KVH, hd, q.element_size(), sp_np, pos_np, win),
                   prec == "int8" and dtype == torch.bfloat16 and win is None and L == 1024,
                   library=lib_name, equal_to_k2_dequantized=True)

    # K2q at the dense int8 serve's own geometry: rows that have not wrapped
    # (prompts of 128-512 plus decode steps in a ring of 1024), so about half
    # of the ring's tiles hold no valid slot and are skipped unread (its own
    # generator, so the phases after it see the data they saw before)
    B, L, H, KVH, hd, dtype = 8, 1024, 32, 8, 64, torch.bfloat16
    srng = np.random.default_rng(22)
    pos_np = np.random.default_rng(21).integers(128, 541, B).astype(np.int32)
    sp_np = _ring_slot_pos(B, L, pos_np)
    int8 = parse_kv_precision("int8")
    (qk, ks), (qv, vs) = (quantize_kv(torch.from_numpy(
        srng.standard_normal((B, L, KVH, hd)).astype(np.float32)).cuda(), int8) for _ in range(2))
    q = torch.from_numpy(srng.standard_normal((B, H, hd)).astype(np.float32)).cuda().to(dtype)
    sp, pos = torch.from_numpy(sp_np).cuda(), torch.from_numpy(pos_np).cuda()
    fn = lambda: kd.decode_attention_quant(q, qk, qv, ks, vs, sp, pos)
    plain = lambda: ref.decode_attention_quant_ref(q, qk, qv, ks, vs, sp, pos)
    mask = ((sp >= 0) & (sp <= pos[:, None]))[:, None, None, :]

    def lib():
        kk = dequantize_kv(qk, ks, q.dtype).transpose(1, 2)
        vv = dequantize_kv(qv, vs, q.dtype).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None], kk, vv, attn_mask=mask,
                                              enable_gqa=True)
    got = fn()
    native = kd.decode_attention(q, dequantize_kv(qk, ks, dtype), dequantize_kv(qv, vs, dtype),
                                 sp, pos)
    torch.cuda.synchronize()
    case = f"decode_attention_quant int8 B{B} L{L} H{H}/{KVH} hd{hd} bf16 unwrapped pos 128-540"
    if not torch.equal(got, native):
        raise AssertionError(f"{case}: not K2 over the dequantized ring bit for bit")
    record(case, "decode_attention_quant", dtype, got, plain(),
           ref.decode_attention_quant_ref(q, qk, _abs_codes(qv), ks, vs, sp, pos), fn, plain, lib,
           _decode_quant_work(B, L, H, KVH, hd, q.element_size(), sp_np, pos_np, None), False,
           library=lib_name, device=True, equal_to_k2_dequantized=True,
           valid_tiles=int(((sp_np >= 0).reshape(B, L // 64, 64)).any(-1).sum()),
           tiles=B * L // 64)


def _chunk_quant_work(H, KVH, hd, esize, C, sp, pos0, valid):
    """``_chunk_work`` over codes: per live slot one byte per code and a
    4-byte scale per KV head for K and V."""
    nbytes, flops = _chunk_work(H, KVH, hd, esize, C, sp, pos0, valid)
    B, L = sp.shape
    live = sum(min(int(pos0[b]) + int(valid[b]), L) for b in range(B) if valid[b])
    return nbytes - esize * 2 * live * KVH * hd + 2 * live * KVH * (hd + 4), flops


def _paged_chunk_inputs(rng, B, C, MP, ps, KVH, hd, Nn, staged):
    """Rows cycling through a first chunk (base 0), a chunk right after a
    prefix hit ending mid-page (base 24), the prefix serve's hit (base 392:
    24 pages and 8 forked rows) with a 120-token chunk, a one-token chunk
    after a hit of all but the last prompt token (base = pos0 = L - 1), a
    second chunk after a mid-page hit (base 200, pos0 328) and an inactive
    row (all -1). Tables over a random permutation of B * MP pages, ids
    below Nn native; pool rows no query may read (past the chunk, and with
    staging (``staged``) at or past base) hold +-1e30. Numpy arrays: k, v
    (the whole pool as floats), block tables, pos0, valid, base, staging
    buffers (B, MP * ps + 1, KVH, hd) or None."""
    N, P = B * MP, MP * ps
    perm = rng.permutation(N).astype(np.int32)
    bt = np.full((B, MP), -1, np.int32)
    live = np.zeros((N, ps), bool)
    pos0, valid, base = (np.zeros(B, np.int32) for _ in range(3))
    for b in range(B):
        kind = b % 6
        if kind == 5:
            continue
        L1 = int(rng.integers(200, 513))
        p0, nv, bs = ((0, C, 0), (24, C, 24), (392, 120, 392), (L1 - 1, 1, L1 - 1),
                      (328, C, 200))[kind]
        pos0[b], valid[b], base[b] = p0, nv, bs
        n = (p0 + nv - 1) // ps + 1
        bt[b, :n] = perm[b * MP: b * MP + n]
        for j in range(bs if staged else p0 + nv):
            live[bt[b, j // ps], j % ps] = True
    k = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((N, ps, KVH, hd)).astype(np.float32)
    junk = np.where(rng.random((N, ps, KVH, hd)) < 0.5, -1e30, 1e30).astype(np.float32)
    stage = None
    if staged:
        stage = rng.standard_normal((2, B, P + 1, KVH, hd)).astype(np.float32)
    return (np.where(live[..., None, None], k, junk), np.where(live[..., None, None], v, -junk),
            bt, pos0, valid, base, stage)


def _paged_chunk_keys(bt, ps, Nn, pos0, valid, base, staged):
    """Per row, the source of each logical key position up to its chunk's
    last (0 none, 1 native page, 2 quantized page, 3 staging), the
    kernel's resolution."""
    B, MP = bt.shape
    out = []
    for b in range(B):
        end = int(pos0[b] + valid[b]) if valid[b] else 0
        j = np.arange(end)
        page = np.where(j // ps < MP, bt[b, np.minimum(j // ps, MP - 1)], -1)
        src = np.where(page < 0, 0, np.where(page < Nn, 1, 2))
        if staged:
            src = np.where(j >= base[b], 3, src)
        out.append(src)
    return out


def _paged_chunk_work(H, KVH, hd, esize, ps, Nn, bt, pos0, valid, base, staged, C):
    """Bytes and FLOPs this K4p call needs: each key position up to a row's
    last query read once from its source (K and V rows in q's dtype from a
    native page or staging, one-byte codes and a 4-byte scale per KV head
    from a quantized page), q rows below valid, the whole output, the
    tables and the per-row ints; 4*hd FLOPs per (head, query, visible key)."""
    B = bt.shape[0]
    nbytes = esize * B * C * H * hd + 4 * (bt.size + 3 * B)
    pairs = 0
    for b, src in enumerate(_paged_chunk_keys(bt, ps, Nn, pos0, valid, base, staged)):
        nbytes += 2 * KVH * (hd * esize * int(((src == 1) | (src == 3)).sum())
                             + (hd + 4) * int((src == 2).sum()))
        nbytes += esize * int(valid[b]) * H * hd
        have = np.cumsum(src > 0)
        pairs += int(sum(have[int(pos0[b]) + i] for i in range(int(valid[b]))))
    return nbytes, 4.0 * hd * H * pairs


def check_paged_chunk_kernels(rng, record) -> None:
    """K4q at the chunked serve's shape (B 8, C 128, L 1024, H 32/8, hd 64)
    over int8 and fp8 codes of ``_chunk_inputs``'s mix, bf16 q and one f32
    case; K4p at the paged pool's shape (B 16, 64-page tables of 16 rows,
    chunks of 128) on a native pool without staging and on int8, fp8 and
    mixed pools with staging, bases at 0, mid-page and L - 1 (plus an int8
    f32 case). Each against its plain version, with the library route's
    time for the record: dequantize, ``index_select`` the pages (and
    concatenate staging), ``scaled_dot_product_attention``. K4p's native
    bf16 case goes into the ``kernels`` line as paged_chunk_attention, its
    int8 bf16 case as paged_chunk_attention_quant (K4q's arithmetic through
    the tables); the standalone K4q entry serves no path."""
    from repro_torch.cache import parse_kv_precision
    from repro_torch.kernels import paged_chunk_attention as kpc
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import dequantize_kv, quantize_kv

    B, C, L, H, KVH, hd = 8, 128, 1024, 32, 8, 64
    for prec, dtype in (("int8", torch.bfloat16), ("fp8", torch.bfloat16),
                        ("int8", torch.float32)):
        k_np, v_np, sp_np, p0_np, nv_np = _chunk_inputs(rng, B, C, L, KVH, hd)
        spec = parse_kv_precision(prec)
        qk, ks = quantize_kv(torch.from_numpy(k_np).cuda(), spec)
        qv, vs = quantize_kv(torch.from_numpy(v_np).cuda(), spec)
        q = torch.from_numpy(rng.standard_normal((B, C, H, hd)).astype(np.float32)).cuda()
        q = q.to(dtype)
        sp, pos0, valid = (torch.from_numpy(a).cuda() for a in (sp_np, p0_np, nv_np))
        case = f"chunk_attention_quant {prec} B{B} C{C} L{L} H{H}/{KVH} hd{hd} {str(dtype)[6:]}"
        fn = lambda q=q, qk=qk, qv=qv, ks=ks, vs=vs: kpc.chunk_attention_quant(
            q, qk, qv, ks, vs, sp, pos0, valid)
        plain = lambda q=q, qk=qk, qv=qv, ks=ks, vs=vs: ref.chunk_attention_quant_ref(
            q, qk, qv, ks, vs, sp, pos0, valid)
        env = ref.chunk_attention_quant_ref(q, qk, _abs_codes(qv), ks, vs, sp, pos0, valid)
        got = fn()
        torch.cuda.synchronize()
        if got[torch.from_numpy(nv_np == 0).cuda()].any():
            raise AssertionError(f"{case}: an inactive row is not zeros")
        qpos = pos0[:, None] + torch.arange(C, device="cuda")[None, :]
        mask = ((sp[:, None, :] >= 0) & (sp[:, None, :] <= qpos[:, :, None]))[:, None]

        def lib(q=q, qk=qk, qv=qv, ks=ks, vs=vs, mask=mask):
            kk = dequantize_kv(qk, ks, q.dtype).transpose(1, 2)
            vv = dequantize_kv(qv, vs, q.dtype).transpose(1, 2)
            return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv, attn_mask=mask,
                                                  enable_gqa=True)
        # K4q's tile has a key where a slot of it has slot_pos >= 0 (the live
        # range bounds the tiles, not the slots inside one)
        has_key = lambda b, t, end, sp_np=sp_np: bool((sp_np[b, t * 64:t * 64 + 64] >= 0).any())
        record(case, "chunk_attention_quant", dtype, got, plain(), env, fn, plain, lib,
               _chunk_quant_work(H, KVH, hd, q.element_size(), C, sp_np, p0_np, nv_np),
               prec == "int8" and dtype == torch.bfloat16,
               library="dequantize + scaled_dot_product_attention",
               instantiation=KERNEL_ROUTE[dtype],
               **_chunk_tiles(H, C, p0_np, nv_np,
                              lambda b, last, p0_np=p0_np: last
                              if p0_np[b] >= 0 and last <= L else L, has_key))

    B, MP, ps = 16, 64, 16
    N = B * MP
    for pool, staged, dtype in (("native", False, torch.bfloat16),
                                ("int8", True, torch.bfloat16), ("fp8", True, torch.bfloat16),
                                ("mixed", True, torch.bfloat16), ("int8", True, torch.float32)):
        Nn = N if pool == "native" else N // 2 if pool == "mixed" else 0
        k_np, v_np, bt_np, p0_np, nv_np, base_np, st_np = _paged_chunk_inputs(
            rng, B, C, MP, ps, KVH, hd, Nn, staged)
        kn = vn = qk = qv = ks = vs = stk = stv = None
        if Nn:
            kn, vn = (torch.from_numpy(a[:Nn]).cuda().to(dtype) for a in (k_np, v_np))
        if Nn < N:
            spec = parse_kv_precision("fp8" if pool == "fp8" else "int8")
            qk, ks = quantize_kv(torch.from_numpy(k_np[Nn:]).cuda(), spec)
            qv, vs = quantize_kv(torch.from_numpy(v_np[Nn:]).cuda(), spec)
        if staged:
            stk, stv = (torch.from_numpy(a).cuda().to(dtype) for a in st_np)
        q = torch.from_numpy(rng.standard_normal((B, C, H, hd)).astype(np.float32)).cuda()
        q = q.to(dtype)
        bt, pos0, valid, base = (torch.from_numpy(a).cuda() for a in (bt_np, p0_np, nv_np,
                                                                     base_np))
        name = "paged_chunk_attention" if pool == "native" else "paged_chunk_attention_quant"
        case = f"{name} {pool}{' staged' if staged else ''} B{B} MP{MP} ps{ps} C{C} " \
               f"H{H}/{KVH} hd{hd} {str(dtype)[6:]}"
        args = (q, kn, vn, qk, qv, ks, vs, bt, pos0, valid)
        kw = dict(stage_k=stk, stage_v=stv, base=base)
        fn = lambda args=args, kw=kw: kpc.paged_chunk_attention(*args, **kw)
        plain = lambda args=args, kw=kw: ref.paged_chunk_attention_ref(*args, **kw)
        env = ref.paged_chunk_attention_ref(
            q, kn, None if vn is None else vn.abs(), qk, None if qv is None else _abs_codes(qv),
            ks, vs, bt, pos0, valid, stage_k=stk, stage_v=None if stv is None else stv.abs(),
            base=base)
        got = fn()
        torch.cuda.synchronize()
        if got[torch.from_numpy(nv_np == 0).cuda()].any():
            raise AssertionError(f"{case}: an inactive row is not zeros")
        keys = _paged_chunk_keys(bt_np, ps, Nn, p0_np, nv_np, base_np, staged)
        S = MP * ps + (MP * ps + 1 if staged else 0)
        ok = np.zeros((B, C, S), bool)   # the reference's mask: pool slots, then staging
        for b, src in enumerate(keys):
            for i in range(int(nv_np[b])):
                j = np.arange(int(p0_np[b]) + i + 1)
                sel = src[j]
                ok[b, i, j[(sel == 1) | (sel == 2)]] = True
                if staged:
                    ok[b, i, MP * ps + j[sel == 3]] = True
        mask = torch.from_numpy(ok).cuda()[:, None]
        flat = bt.clamp(0, N - 1).flatten()

        def lib(q=q, kn=kn, vn=vn, qk=qk, qv=qv, ks=ks, vs=vs, stk=stk, stv=stv, mask=mask,
                flat=flat):
            kk = [] if kn is None else [kn]
            vv = [] if vn is None else [vn]
            if qk is not None:
                kk.append(dequantize_kv(qk, ks, q.dtype))
                vv.append(dequantize_kv(qv, vs, q.dtype))
            kk = torch.cat(kk).index_select(0, flat).view(B, MP * ps, KVH, hd)
            vv = torch.cat(vv).index_select(0, flat).view(B, MP * ps, KVH, hd)
            if stk is not None:
                kk, vv = torch.cat((kk, stk), 1), torch.cat((vv, stv), 1)
            return F.scaled_dot_product_attention(q.transpose(1, 2), kk.transpose(1, 2),
                                                  vv.transpose(1, 2), attn_mask=mask,
                                                  enable_gqa=True)
        has_key = lambda b, t, end, keys=keys: bool((keys[b][t * 64:min(end, t * 64 + 64)]
                                                     > 0).any())
        record(case, name, dtype, got, plain(), env, fn, plain, lib,
               _paged_chunk_work(H, KVH, hd, q.element_size(), ps, Nn, bt_np, p0_np, nv_np,
                                 base_np, staged, C),
               dtype == torch.bfloat16 and pool in ("native", "int8"),
               library="dequantize + index_select of the pages (+ staging) + "
                       "scaled_dot_product_attention",
               instantiation=KERNEL_ROUTE[dtype],
               **_chunk_tiles(H, C, p0_np, nv_np, lambda b, last: last, has_key))


def _ssd_work(B, S, H, P, N, Q, esize, init):
    """Bytes and FLOPs this SSD scan needs: x read and y written in x's
    dtype; dt, A, B, C, the final state (and the initial one) in f32; per
    head and chunk of v real steps, 2 N v(v+1)/2 FLOPs for the causal half
    of C B^T, 2 P v(v+1)/2 for W x, and 2 v N P each for the carried
    state's term and the state update."""
    nbytes = esize * 2 * B * S * H * P + 4 * (B * S * H + H + 2 * B * S * N
                                              + B * H * P * N * (2 if init else 1))
    flops = 0
    for c0 in range(0, S, Q):
        v = min(Q, S - c0)
        flops += (N + P) * v * (v + 1) + 4 * v * N * P
    return nbytes, float(flops * B * H)


# K6 against its plain version, per unit of (env + |plain|). In f32 the two
# sum dt*A over a chunk in other orders (the kernel in sequence, torch.cumsum
# by a scan); |LA| reaches 1e2-1e3, so LA's rounding differs by ~1e-5 of a
# step's decay exponent, which exp turns into a relative error of the same
# size: the first full-width run found 1.3x the 2e-5 rule from an initial
# state. bf16 keeps KERNEL_RTOL's 2^-6, which covers the plain version's
# rounding of the weights and the carried state's term.
SSD_RTOL = {torch.float32: 1e-4, torch.bfloat16: KERNEL_RTOL[torch.bfloat16]}
# K6 against ssd_ref in f32: the chunked form's cumulative log-decay departs
# from the product of per-step decays (5e-5 of env between the plain version
# and ssd_ref on the CPU at the full shape)
SSD_REF_RTOL = 2e-4


def check_ssd_kernel(record) -> None:
    """K6 at the full mamba2-130m prefill shape (B 8, S 512, H 24, P 64, N
    128, chunk 128; bf16 x is the serve's, the f32 run is also held to the
    sequential oracle ssd_ref), at 300 steps (a tail chunk), from an
    initial state, and at the smoke shape (P 32, N 32, chunk 16, S 40) in
    f32. dt = softplus(N(0,1)) and A = -linspace(1, 16, H), as the model
    gives them. Held element by element to its plain version (y and the
    final state) by SSD_RTOL, env the plain version on |x|, |B|, |C| and
    |init|; the final state is f32 on both sides and held to the f32 rule
    in every case."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd

    g = torch.Generator(device="cuda").manual_seed(6)
    for B, S, H, P, N, Q, dtype, init, main in (
            (8, 512, 24, 64, 128, 128, torch.bfloat16, False, True),
            (8, 512, 24, 64, 128, 128, torch.float32, False, False),
            (8, 300, 24, 64, 128, 128, torch.float32, False, False),
            (8, 512, 24, 64, 128, 128, torch.float32, True, False),
            (4, 40, 8, 32, 32, 16, torch.float32, False, False)):
        x = torch.randn((B, S, H, P), generator=g, device="cuda").to(dtype)
        dt = F.softplus(torch.randn((B, S, H), generator=g, device="cuda"))
        A = -torch.linspace(1.0, 16.0, H, device="cuda")
        Bm, Cm = (torch.randn((B, S, N), generator=g, device="cuda") for _ in range(2))
        st = 0.5 * torch.randn((B, H, P, N), generator=g, device="cuda") if init else None
        case = (f"ssd_scan B{B} S{S} H{H} P{P} N{N} chunk{Q} {str(dtype)[6:]}"
                + (" init" if init else ""))
        fn = lambda x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, st=st, Q=Q: kssd.ssd_scan(
            x, dt, A, Bm, Cm, chunk=Q, init_state=st)
        plain = lambda x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, st=st, Q=Q: ref.ssd_chunked(
            x, dt, A, Bm, Cm, Q, st)
        y, fin = fn()
        ry, rfin = plain()
        ey, efin = ref.ssd_chunked(x.abs(), dt, A, Bm.abs(), Cm.abs(), Q,
                                   None if st is None else st.abs())
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(fin).all()):
            raise AssertionError(f"{case}: non-finite output")
        st_tol = SSD_RTOL[torch.float32] * (efin + rfin.abs())
        st_worst = ((fin - rfin).abs() / st_tol.clamp_min(1e-30)).max().item()
        flat = lambda a, b: torch.cat([a.float().flatten(), b.flatten()])
        record(case, "ssd_scan", dtype, flat(y, fin), flat(ry, rfin), flat(ey, efin), fn, plain,
               None, _ssd_work(B, S, H, P, N, Q, x.element_size(), init), main,
               library="none: no single PyTorch call computes the SSD scan", rtol=SSD_RTOL)
        oracle = {}
        if dtype == torch.float32 and not init:
            oy, ofin = ref.ssd_ref(x, dt, A, Bm, Cm)
            torch.cuda.synchronize()
            for name, a, b, e in (("y", y, oy, ey), ("state", fin, ofin, efin)):
                tol = SSD_REF_RTOL * (e + b.abs())
                oracle[name] = {"max_err_over_tol": ((a - b).abs() / tol.clamp_min(1e-30))
                                .max().item(), "max_abs_err": (a - b).abs().max().item()}
        emit("ssd_checks", case=case, state_max_err_over_f32_tol=st_worst, vs_ssd_ref=oracle,
             ssd_ref_rtol=SSD_REF_RTOL)
        if not st_worst <= 1.0 or any(not o["max_err_over_tol"] <= 1.0 for o in oracle.values()):
            raise AssertionError(f"{case}: the final state or the oracle check is beyond its "
                                 "tolerance")


# the bf16 route's three kernels (csrc/ssd_scan.cu), by wrapper
SSD_PHASES = ("ssd_chunk_states", "ssd_state_passing", "ssd_chunk_outputs")


def _ssd_phase_work(B, S, H, P, N, Q):
    """Bytes and FLOPs each bf16 phase kernel needs, as _ssd_work counts
    them: its inputs read once and outputs written once (the scratch of
    states (B, nc, H, P, N) f32 and decays (B, nc, H) f32 among them); per
    head and chunk of v real steps 2 v N P FLOPs for the chunk states, 2 P N
    for the state passing, and for the outputs N v(v+1) (C B^T's causal
    half, once per chunk: shared by the heads) plus P v(v+1) + 2 v N P per
    head."""
    nc = -(-S // Q)
    x, dtb, bc = 2 * B * S * H * P, 4 * (B * S * H + H), 4 * B * S * N
    scratch, decay, state = 4 * B * nc * H * P * N, 4 * B * nc * H, 4 * B * H * P * N
    vs = [min(Q, S - c0) for c0 in range(0, S, Q)]
    return {"ssd_chunk_states": (x + dtb + bc + scratch + decay,
                                 float(B * H * sum(2 * v * N * P for v in vs))),
            "ssd_state_passing": (2 * scratch + decay + state, float(2 * B * nc * H * P * N)),
            "ssd_chunk_outputs": (2 * x + dtb + 2 * bc + scratch,
                                  float(B * sum(N * v * (v + 1) + H * (P * v * (v + 1)
                                                                       + 2 * v * N * P)
                                                for v in vs)))}


def check_ssd_anatomy(timer) -> dict:
    """What bounds K6 at the serve's shape (B 8, S 512, H 24, P 64, N 128,
    chunk 128): the bf16 call (three kernels on the tensor cores) and each
    of its phase kernels, beside the f32 CUDA-core kernel at the same shape
    (the first port's design; x in f32), with device times (``_device_ms``)
    and ``Timer``'s, FLOPs, TFLOP/s and bounds. Each phase kernel is held to
    its plain version on the same inputs (chunk states and entering states
    by the f32 rule, y by the bf16 one; env the plain phase on |x|, |B|,
    |C|), and two launches of the bf16 call are compared bit for bit.
    Returns the phase kernels' rows for the kernels line."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd

    g = torch.Generator(device="cuda").manual_seed(20)
    B, S, H, P, N, Q = 8, 512, 24, 64, 128, 128
    x = torch.randn((B, S, H, P), generator=g, device="cuda").to(torch.bfloat16)
    dt = F.softplus(torch.randn((B, S, H), generator=g, device="cuda"))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm, Cm = (torch.randn((B, S, N), generator=g, device="cuda") for _ in range(2))
    work = _ssd_phase_work(B, S, H, P, N, Q)
    rows, phases = {}, []

    def check(name, got, want, env, rtol, fn, plain):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        worst = (diff / (rtol * (env.float() + want.float().abs())).clamp_min(1e-30)).max().item()
        dev = _device_ms(fn)
        bms, by = bound(*work[name], torch.bfloat16)
        row = {"kernel": name, "max_abs_err": diff.max().item(), "max_err_over_tol": worst,
               "rtol": rtol, "ms": timer(fn), "plain_ms": timer(plain, n=5), "device_ms": dev,
               "bound_ms": bms, "bound_by": by, "bytes": work[name][0], "flops": work[name][1],
               "tflops": work[name][1] / dev / 1e9, "library_ms": None,
               "library_device_ms": None}
        rows[name] = row
        phases.append(row)
        if not worst <= 1.0:
            emit("ssd_anatomy", phases=phases)
            raise AssertionError(f"{name}: an element is {worst:.3g}x its tolerance")
        _hold_to_bound(name, dev, bms)

    f32 = SSD_RTOL[torch.float32]
    contrib, decay = kssd.chunk_states(x, dt, A, Bm, chunk=Q)
    rcontrib, rdecay = ref.ssd_chunk_states_ref(x, dt, A, Bm, Q)
    econtrib, _ = ref.ssd_chunk_states_ref(x.abs(), dt, A, Bm.abs(), Q)
    check("ssd_chunk_states", torch.cat([contrib.flatten(), decay.flatten()]),
          torch.cat([rcontrib.flatten(), rdecay.flatten()]),
          torch.cat([econtrib.flatten(), rdecay.flatten()]), f32,
          lambda: kssd.chunk_states(x, dt, A, Bm, chunk=Q),
          lambda: ref.ssd_chunk_states_ref(x, dt, A, Bm, Q))
    entering = rcontrib.clone()   # the plain contributions: phase 2 alone is held
    fin = kssd.state_passing(entering, rdecay)
    rentering, rfin = ref.ssd_state_passing_ref(rcontrib, rdecay)
    eentering, efin = ref.ssd_state_passing_ref(econtrib, rdecay)
    scratch = rcontrib.clone()    # timed launches overwrite it in place
    check("ssd_state_passing", torch.cat([entering.flatten(), fin.flatten()]),
          torch.cat([rentering.flatten(), rfin.flatten()]),
          torch.cat([eentering.flatten(), efin.flatten()]), f32,
          lambda: kssd.state_passing(scratch, rdecay),
          lambda: ref.ssd_state_passing_ref(rcontrib, rdecay))
    y = kssd.chunk_outputs(x, dt, A, Bm, Cm, rentering, chunk=Q)
    ry = ref.ssd_chunk_outputs_ref(x, dt, A, Bm, Cm, rentering, Q)
    ey = ref.ssd_chunk_outputs_ref(x.abs(), dt, A, Bm.abs(), Cm.abs(), eentering, Q)
    check("ssd_chunk_outputs", y, ry, ey, SSD_RTOL[torch.bfloat16],
          lambda: kssd.chunk_outputs(x, dt, A, Bm, Cm, rentering, chunk=Q),
          lambda: ref.ssd_chunk_outputs_ref(x, dt, A, Bm, Cm, rentering, Q))

    y1, f1 = kssd.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    y2, f2 = kssd.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    torch.cuda.synchronize()
    equal = bool(torch.equal(y1, y2) and torch.equal(f1, f2))
    flops = _ssd_work(B, S, H, P, N, Q, 2, False)[1]
    calls = {}
    for label, xx in (("bf16 (three kernels, tensor cores)", x),
                      ("f32 (one kernel, CUDA cores)", x.float())):
        fn = lambda xx=xx: kssd.ssd_scan(xx, dt, A, Bm, Cm, chunk=Q)
        work_all = _ssd_work(B, S, H, P, N, Q, xx.element_size(), False)
        bms, by = bound(*work_all, xx.dtype)
        dev = _device_ms(fn)
        calls[label] = {"device_ms": dev, "ms": timer(fn), "bound_ms": bms, "bound_by": by,
                        "flops": flops, "tflops": flops / dev / 1e9, "over_bound": dev / bms}
        _hold_to_bound(f"ssd_scan {label}", dev, bms)
    bf, f3 = calls.values()
    emit("ssd_anatomy", shape={"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": Q},
         calls=calls, phases=phases, phase_device_ms_sum=sum(r["device_ms"] for r in phases),
         bf16_over_f32_device=bf["device_ms"] / f3["device_ms"], two_launches_equal=equal,
         smem_bytes={**kssd.smem_bytes(Q, P, N, torch.bfloat16),
                     **kssd.smem_bytes(Q, P, N, torch.float32)})
    if not equal:
        raise AssertionError("two launches of the bf16 K6 differ")
    return rows


# --------------------------------------------------------------- model
def _attention_impls():
    """Stand-ins for ``repro_torch.kernels.ops`` that the model's attention
    calls: the plain versions, and a deliberately faulty decode that skips
    one KV tile (slots 64-127), as a kernel with a wrong tile loop would."""
    from types import SimpleNamespace

    from repro_torch.kernels import ref

    def flash(q, k, v, seq_lens=None, *, causal, window):
        return ref.attention_ref(q, k, v, causal=causal, window=window, seq_lens=seq_lens)

    def decode(q, k, v, slot_pos, pos, *, k_scale=None, v_scale=None, window=None):
        if k_scale is not None:
            return ref.decode_attention_quant_ref(q, k, v, k_scale, v_scale, slot_pos, pos,
                                                  window=window)
        return ref.decode_attention_ref(q, k, v, slot_pos, pos, window=window)

    def decode_skipping_a_tile(q, k, v, slot_pos, pos, **kw):
        sp = slot_pos.clone()
        sp[:, 64:128] = -1
        return decode(q, k, v, sp, pos, **kw)

    return (SimpleNamespace(flash_attention=flash, decode_attention=decode),
            SimpleNamespace(flash_attention=flash, decode_attention=decode_skipping_a_tile))


def _greedy_logits(model, toks, cache_len, lens, impl, feed=None):
    """Prefill + 16 decode steps with the model's attention pointed at
    ``impl``; returns the (17, B, V) float32 logits. ``feed`` (16, B) fixes
    the decoded tokens, else each step takes the previous step's argmax."""
    from repro_torch.models import attention as A
    from repro_torch.models import decode_step, prefill

    kernels_ops, A.ops = A.ops, impl
    logits, state = prefill(model, toks, cache_len, prompt_lens=lens)
    out = [logits.float()]
    for step in range(16):
        nxt = out[-1].argmax(-1).to(torch.int32) if feed is None else feed[step]
        logits, state = decode_step(model, state, nxt)
        out.append(logits.float())
    A.ops = kernels_ops
    del state
    return torch.stack(out)


def check_model() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config("granite-3-2b")
    model = init_params(cfg, seed=0, device="cuda")
    B, S, L = 8, 512, 1024
    rng = np.random.default_rng(0)
    lens = torch.tensor([512, 300, 129, 1, 512, 64, 200, 511], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    plain, faulty = _attention_impls()
    lp = _greedy_logits(model, toks, L, lens, plain)
    feed = lp[:-1].argmax(-1).to(torch.int32)   # every path decodes the same tokens
    lk = _greedy_logits(model, toks, L, lens, ops, feed)
    lf = _greedy_logits(model, toks, L, lens, faulty, feed)
    torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and lk.shape == (17, B, cfg.vocab_size)):
        raise AssertionError("bad kernel-path logits")
    errs = (lk - lp).abs().amax(dim=(1, 2)).tolist()
    fault_errs = (lf - lp).abs().amax(dim=(1, 2)).tolist()
    top2 = lp.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > MODEL_TOL
    flips = int((lk.argmax(-1) != lp.argmax(-1))[sure].sum())
    res = {"logit_scale": lp.abs().max().item(), "tol": MODEL_TOL,
           "max_abs_err_per_step": errs, "tokens_checked": int(sure.sum()),
           "token_mismatches_beyond_margin": flips,
           "tile_skipping_decode_max_abs_err_per_step": fault_errs,
           "tile_skipping_decode_token_mismatches":
               int((lf.argmax(-1) != lp.argmax(-1))[sure].sum())}
    del model, lk, lp, lf
    if max(errs) > MODEL_TOL or flips:
        emit("model", **res)
        raise AssertionError("kernel path and plain path disagree")
    if not max(fault_errs) > MODEL_TOL:
        emit("model", **res)
        raise AssertionError("the model tolerance does not catch a skipped KV tile")

    # the smoke model on the card against the CPU path the CPU tests hold
    # against the JAX package (float32 both; see tests/test_torch_model.py)
    smoke = get_config("granite-3-2b", smoke=True)
    cpu_m = init_params(smoke, seed=0, device="cpu")
    gpu_m = init_params(smoke, seed=0, device="cpu").cuda()
    st = torch.from_numpy(rng.integers(0, smoke.vocab_size, (4, 16)).astype(np.int32))
    sl = torch.tensor([16, 1, 9, 5], dtype=torch.int32)
    lc, scpu = prefill(cpu_m, st, 64, prompt_lens=sl)
    lg, sgpu = prefill(gpu_m, st.cuda(), 64, prompt_lens=sl.cuda())
    smoke_err = [(lg.cpu() - lc).abs().max().item()]
    for _ in range(3):
        nxt = lc.argmax(-1).to(torch.int32)
        lc, scpu = decode_step(cpu_m, scpu, nxt)
        lg, sgpu = decode_step(gpu_m, sgpu, nxt.cuda())
        smoke_err.append((lg.cpu() - lc).abs().max().item())
    res.update(smoke_max_abs_err=smoke_err, smoke_tol=1e-4)
    emit("model", **res)
    if max(smoke_err) > 1e-4:
        raise AssertionError("smoke model on the card disagrees with the CPU path")
    torch.cuda.empty_cache()
    return res


def _paged_state(model, toks, lens, ps, MP, n_steps, prec="", native_pages=None):
    """Prefill ``toks`` (cache_len = the bucket) and copy each row's dense
    cache into pages of a fresh pool: row b gets the pages for
    lens[b] + n_steps positions, in a shuffled order. ``prec`` (int8, fp8)
    makes the pool's ids from ``native_pages`` on (None: all) a quantized
    region, which the copy quantizes into. Returns the prefill logits and a
    PagedDecodeState."""
    from repro_torch.cache import pages_for
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    B, S = toks.shape
    N = B * MP
    perm = np.random.default_rng(7).permutation(N).astype(np.int32)
    bt = np.full((B, MP), -1, np.int32)
    page_idx = np.full((B, S // ps), N, np.int32)
    lens_np = lens.cpu().numpy()
    used = 0
    for b in range(B):
        n = pages_for(int(lens_np[b]) + n_steps, ps)
        bt[b, :n] = perm[used:used + n]
        used += n
        k = min(n, S // ps)
        page_idx[b, :k] = bt[b, :k]
    logits, dense = M.prefill(model, toks, S, prompt_lens=lens)
    cfg = model.cfg.replace(kv_precision=prec) if prec else model.cfg
    pools = M.paged_splice_prompt(T.paged_pools_init(cfg, N, ps, "cuda", native_pages),
                                  dense.caches, page_idx)
    state = M.PagedDecodeState(pools, torch.from_numpy(bt).cuda(), lens.clone(),
                               dense.last_tok)
    return logits, state


def check_paged_model() -> dict:
    """Full-width granite-3-2b: the same prompts and fed tokens through the
    dense decode (K2 over the ring cache) and the paged decode (K3 over
    pages in shuffled order), 16 steps; logits equal bit for bit on every
    step (K2 and K3 share csrc/decode_core.cuh, its split and its combine
    order), and within MODEL_TOL. Beside it
    a paged path whose block table swaps the first two pages of the row
    with the 1-token prompt must land beyond MODEL_TOL."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import decode_step, decode_step_paged, init_params, prefill

    cfg = get_config("granite-3-2b")
    model = init_params(cfg, seed=0, device="cuda")
    B, S, L, ps, MP = 8, 512, 1024, 16, 64
    rng = np.random.default_rng(0)
    lens = torch.tensor([512, 300, 129, 1, 512, 64, 200, 511], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    logits, dstate = prefill(model, toks, L, prompt_lens=lens)
    dense = [logits.float()]
    for _ in range(16):
        logits, dstate = decode_step(model, dstate, dense[-1].argmax(-1).to(torch.int32))
        dense.append(logits.float())
    del dstate
    dense = torch.stack(dense)
    feed = dense[:-1].argmax(-1).to(torch.int32)

    def swapped(q, k, v, bt, pos):
        bt = bt.clone()
        bt[3, [0, 1]] = bt[3, [1, 0]]
        return ops.paged_decode_attention(q, k, v, bt, pos)

    out = {}
    for name, impl in (("paged", ops),
                       ("swapped", SimpleNamespace(flash_attention=ops.flash_attention,
                                                   paged_decode_attention=swapped))):
        kernels_ops, A.ops = A.ops, impl
        logits, state = _paged_state(model, toks, lens, ps, MP, 16)
        steps = [logits.float()]
        for step in range(16):
            logits, state = decode_step_paged(model, state, feed[step])
            steps.append(logits.float())
        A.ops = kernels_ops
        del state
        out[name] = torch.stack(steps)
    torch.cuda.synchronize()
    lp, ls = out["paged"], out["swapped"]
    if not (torch.isfinite(lp).all() and lp.shape == dense.shape):
        raise AssertionError("bad paged-path logits")
    errs = (lp - dense).abs().amax(dim=(1, 2)).tolist()
    fault = (ls - dense).abs().amax(dim=(1, 2)).tolist()
    top2 = dense.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > MODEL_TOL
    res = {"tol": MODEL_TOL, "logit_scale": dense.abs().max().item(),
           "max_abs_err_per_step": errs, "bitwise_equal_steps": int(sum(e == 0 for e in errs)),
           "token_mismatches_beyond_margin": int((lp.argmax(-1) != dense.argmax(-1))[sure].sum()),
           "swapped_pages_max_abs_err_per_step": fault}
    emit("paged_model", **res)
    del model, dense, lp, ls
    torch.cuda.empty_cache()
    if max(errs) > MODEL_TOL or res["token_mismatches_beyond_margin"]:
        raise AssertionError("paged path and dense path disagree")
    if res["bitwise_equal_steps"] < len(errs):   # K2 and K3 share one core (decode_core.cuh)
        raise AssertionError(f"paged equals dense on {res['bitwise_equal_steps']} of "
                             f"{len(errs)} steps, not on all")
    if not max(fault) > MODEL_TOL:
        raise AssertionError("the model tolerance does not catch two swapped pages")
    return res


def _quant_impls():
    """Stand-ins for ``repro_torch.kernels.ops`` in the quantized model
    check: the plain versions, and two deliberately faulty decodes: one
    that reads a mixed pool's quantized page ids as native pages (the
    offset by native_pages forgotten), one that dequantizes each page with
    the scales of the neighbouring page."""
    from types import SimpleNamespace

    from repro_torch.kernels import ops, ref

    def flash(q, k, v, seq_lens=None, *, causal, window):
        return ref.attention_ref(q, k, v, causal=causal, window=window, seq_lens=seq_lens)

    def quant(q, k, v, qk, qv, ks, vs, bt, pos):
        if k is None:
            return ref.paged_decode_attention_quant_ref(q, qk, qv, ks, vs, bt, pos)
        return ref.paged_decode_attention_mixed_ref(q, k, v, qk, qv, ks, vs, bt, pos)

    def quant_ids_as_native(q, k, v, qk, qv, ks, vs, bt, pos):
        Nn = k.shape[0]
        return ops.paged_decode_attention(q, k, v, torch.where(bt >= Nn, bt - Nn, bt), pos)

    def neighbour_scales(q, k, v, qk, qv, ks, vs, bt, pos):
        return ops.paged_decode_attention_quant(q, k, v, qk, qv, ks.roll(1, 0), vs.roll(1, 0),
                                                bt, pos)

    return (SimpleNamespace(flash_attention=flash, paged_decode_attention_quant=quant),
            {"mixed": ("quant_ids_read_as_native", SimpleNamespace(
                flash_attention=ops.flash_attention,
                paged_decode_attention_quant=quant_ids_as_native)),
             "fp8": ("neighbour_page_scales", SimpleNamespace(
                 flash_attention=ops.flash_attention,
                 paged_decode_attention_quant=neighbour_scales))})


def _kernel_launches(fn):
    """The CUDA kernels ``fn()`` launches, counted by torch.profiler, and
    its result."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n, out


def check_quant_model() -> dict:
    """Full-width granite-3-2b on seeded weights, prompts of 1-512 tokens,
    prefill and 16 decode steps on fed tokens over a quantized pool of
    shuffled pages: a mixed one (the lower half of the ids native bf16,
    the upper half int8) and an all-fp8 one. Per pool the kernel path (K1r,
    K3q) must stay within MODEL_TOL of the plain path (plain attention and
    the plain quantized decode), and a faulty path must land beyond it.
    The distance of each pool's kernel path from the native pool's (K3) is
    printed on its own line, for the record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import decode_step_paged, init_params

    cfg = get_config("granite-3-2b")
    model = init_params(cfg, seed=0, device="cuda")
    B, S, ps, MP = 8, 512, 16, 64
    N = B * MP
    rng = np.random.default_rng(0)
    lens = torch.tensor([512, 300, 129, 1, 512, 64, 200, 511], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    plain, faults = _quant_impls()

    launches = {}

    def run(impl, prec="", native_pages=None, feed=None, count=None):
        """The logits of prefill and 16 steps; ``count`` names the pool
        whose first decode step's kernel launches are counted."""
        kernels_ops, A.ops = A.ops, impl
        logits, state = _paged_state(model, toks, lens, ps, MP, 16, prec, native_pages)
        steps = [logits.float()]
        for step in range(16):
            nxt = steps[-1].argmax(-1).to(torch.int32) if feed is None else feed[step]
            if count and step == 0:
                launches[count], (logits, state) = _kernel_launches(
                    lambda: decode_step_paged(model, state, nxt))
            else:
                logits, state = decode_step_paged(model, state, nxt)
            steps.append(logits.float())
        A.ops = kernels_ops
        del state
        return torch.stack(steps)

    native = run(ops, count="native")
    feed = native[:-1].argmax(-1).to(torch.int32)   # every path decodes the same tokens
    res, failed = {"tol": MODEL_TOL, "logit_scale": native.abs().max().item()}, []
    for pool, prec, nn in (("mixed", "int8", N // 2), ("fp8", "fp8", 0)):
        lk = run(ops, prec, nn, feed, count=pool)
        lp = run(plain, prec, nn, feed)
        fault_name, fault_impl = faults[pool]
        lf = run(fault_impl, prec, nn, feed)
        torch.cuda.synchronize()
        if not (torch.isfinite(lk).all() and lk.shape == native.shape):
            raise AssertionError(f"bad {pool} kernel-path logits")
        errs = (lk - lp).abs().amax(dim=(1, 2)).tolist()
        fault = (lf - lp).abs().amax(dim=(1, 2)).tolist()
        top2 = lp.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > MODEL_TOL
        res[pool] = {"max_abs_err_per_step": errs, "tokens_checked": int(sure.sum()),
                     "token_mismatches_beyond_margin":
                         int((lk.argmax(-1) != lp.argmax(-1))[sure].sum()),
                     "fault": fault_name, "fault_max_abs_err_per_step": fault}
        emit("quant_vs_native", pool=pool,
             max_abs_logit_diff_per_step=(lk - native).abs().amax(dim=(1, 2)).tolist(),
             argmax_agreement=float((lk.argmax(-1) == native.argmax(-1)).float().mean()))
        if max(errs) > MODEL_TOL or res[pool]["token_mismatches_beyond_margin"]:
            failed.append(f"{pool}: kernel path and plain path disagree")
        if not max(fault) > MODEL_TOL:
            failed.append(f"{pool}: the model tolerance does not catch {fault_name}")
        del lk, lp, lf
    # the decode step's kernel launches over each pool: on the mixed pool
    # every row's write lands in one region or the other, on the fp8 pool
    # all in the quantized one, so the difference from the native pool is
    # what the quantize-on-write costs in launches (40 layers per step)
    res["decode_step_kernel_launches"] = launches
    emit("quant_model", **res)
    del model, native
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return res


def _dense_quant_impls():
    """Stand-ins for ``repro_torch.kernels.ops`` in the dense quantized
    model check: the plain versions, and two deliberately faulty ring
    decodes through K2q: one that dequantizes with unit scales (the scale
    table not read), one that skips a KV tile (slots 64-127)."""
    from types import SimpleNamespace

    from repro_torch.kernels import ops, ref

    def flash(q, k, v, seq_lens=None, *, causal, window):
        return ref.attention_ref(q, k, v, causal=causal, window=window, seq_lens=seq_lens)

    def decode(q, k, v, slot_pos, pos, *, k_scale, v_scale, window=None):
        return ref.decode_attention_quant_ref(q, k, v, k_scale, v_scale, slot_pos, pos,
                                              window=window)

    def unit_scales(q, k, v, slot_pos, pos, *, k_scale, v_scale, window=None):
        one = torch.ones_like(k_scale)
        return ops.decode_attention(q, k, v, slot_pos, pos, k_scale=one, v_scale=one,
                                    window=window)

    def skipped_tile(q, k, v, slot_pos, pos, **kw):
        sp = slot_pos.clone()
        sp[:, 64:128] = -1
        return ops.decode_attention(q, k, v, sp, pos, **kw)

    return (SimpleNamespace(flash_attention=flash, decode_attention=decode),
            {"int8": ("unit_scales", SimpleNamespace(flash_attention=ops.flash_attention,
                                                     decode_attention=unit_scales)),
             "fp8": ("skipped_tile", SimpleNamespace(flash_attention=ops.flash_attention,
                                                     decode_attention=skipped_tile))})


def check_dense_quant_model() -> dict:
    """Full-width granite-3-2b on seeded weights, prompts of 1-512 tokens,
    a dense ring of 1,024 slots at int8 and at fp8: prefill (K1r over the
    prompt's native K/V, then the quantized write) and 16 decode steps on
    fed tokens. Per precision the kernel path (K1r, K2q) stays within
    MODEL_TOL of the plain path (plain attention and the plain quantized
    decode), and a faulty K2q path (unit scales; a skipped tile) lands
    beyond it. The same prompts over an all-int8 page pool (K3q) give the
    dense int8 ring's logits bit for bit at every step. K1q is held once
    more on the int8 prefill's own data: the layer-0 codes and scales it
    wrote into its ring, with that layer's queries."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as A
    from repro_torch.models import decode_step, decode_step_paged, init_params, prefill

    cfg = get_config("granite-3-2b")
    model = init_params(cfg, seed=0, device="cuda")
    B, S, L, ps, MP = 8, 512, 1024, 16, 64
    rng = np.random.default_rng(0)
    lens = torch.tensor([512, 300, 129, 1, 512, 64, 200, 511], dtype=torch.int32, device="cuda")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    plain, faults = _dense_quant_impls()
    seen = {}

    def first_queries(q, k, v, seq_lens=None, *, causal, window):
        seen.setdefault("q", q)   # the first call is layer 0's
        return ops.flash_attention(q, k, v, seq_lens, causal=causal, window=window)

    def run(impl, prec, feed=None, on_prefill=None):
        kernels_ops, A.ops = A.ops, impl
        logits, state = prefill(model, toks, L, prompt_lens=lens, kv_precision=prec)
        if on_prefill is not None:
            on_prefill(state)
        steps = [logits.float()]
        for step in range(16):
            nxt = steps[-1].argmax(-1).to(torch.int32) if feed is None else feed[step]
            logits, state = decode_step(model, state, nxt)
            steps.append(logits.float())
        A.ops = kernels_ops
        del state
        return torch.stack(steps)

    real = {}

    def k1q_on_the_ring(state):
        c = state.caches[0]
        qk, qv, ks, vs = (t[0, :, :S].contiguous() for t in (c.k, c.v, c.k_scale, c.v_scale))
        q = seen["q"]
        got = kf.flash_attention_quant(q, qk, qv, ks, vs, lens)
        want = ref.attention_quant_ref(q, qk, qv, ks, vs, seq_lens=lens)
        env = ref.attention_quant_ref(q, qk, _abs_codes(qv), ks, vs, seq_lens=lens)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        tol = KERNEL_RTOL[q.dtype] * (env.float() + want.float().abs())
        real.update(max_abs_err=diff.max().item(),
                    max_err_over_tol=(diff / tol.clamp_min(1e-30)).max().item())

    capture = SimpleNamespace(flash_attention=first_queries, decode_attention=ops.decode_attention)
    res, failed = {"tol": MODEL_TOL}, []
    feed = None
    for prec in ("int8", "fp8"):
        if feed is None:   # the int8 kernel path greedy; every later path is fed its tokens
            lk = run(capture, prec, on_prefill=k1q_on_the_ring)
            feed = lk[:-1].argmax(-1).to(torch.int32)
        else:
            lk = run(ops, prec, feed)
        lp = run(plain, prec, feed)
        fault_name, fault_impl = faults[prec]
        lf = run(fault_impl, prec, feed)
        torch.cuda.synchronize()
        if not (torch.isfinite(lk).all() and lk.shape == (17, B, cfg.vocab_size)):
            raise AssertionError(f"bad {prec} kernel-path logits")
        errs = (lk - lp).abs().amax(dim=(1, 2)).tolist()
        fault = (lf - lp).abs().amax(dim=(1, 2)).tolist()
        top2 = lp.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > MODEL_TOL
        res[prec] = {"logit_scale": lp.abs().max().item(), "max_abs_err_per_step": errs,
                     "tokens_checked": int(sure.sum()),
                     "token_mismatches_beyond_margin":
                         int((lk.argmax(-1) != lp.argmax(-1))[sure].sum()),
                     "fault": fault_name, "fault_max_abs_err_per_step": fault}
        if max(errs) > MODEL_TOL or res[prec]["token_mismatches_beyond_margin"]:
            failed.append(f"{prec}: kernel path and plain path disagree")
        if not max(fault) > MODEL_TOL:
            failed.append(f"{prec}: the model tolerance does not catch {fault_name}")
        if prec == "int8":
            kernels_ops, A.ops = A.ops, ops
            logits, pstate = _paged_state(model, toks, lens, ps, MP, 16, "int8")
            paged = [logits.float()]
            for step in range(16):
                logits, pstate = decode_step_paged(model, pstate, feed[step])
                paged.append(logits.float())
            A.ops = kernels_ops
            del pstate
            paged = torch.stack(paged)
            res["paged_int8_equal_steps"] = [bool(torch.equal(a, b)) for a, b in zip(paged, lk)]
            res["paged_int8_max_abs_diff_per_step"] = (paged - lk).abs().amax(dim=(1, 2)).tolist()
            if not all(res["paged_int8_equal_steps"]):
                failed.append("the dense int8 ring and the all-int8 page pool disagree")
            del paged
        del lk, lp, lf
    res["k1q_on_the_int8_ring_layer0"] = real
    if not real["max_err_over_tol"] <= 1.0:
        failed.append("K1q disagrees with its plain version on the int8 ring's codes")
    emit("dense_quant_model", **res)
    del model
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return res


def check_preemption() -> dict:
    """Full-width paged engine, 2 rows, a pool too small for both to grow:
    admission fits both 160-token prompts (11 pages each with the slot's
    writes), but 24 pages cannot hold both rows at their full 199 tokens
    (13 pages each), so a row is preempted and recomputed. The streams must
    equal the dense engine's wherever the dense path's top-2 margin exceeds
    MODEL_TOL."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    from repro_torch.runtime import (Engine, EngineConfig, PagedEngine, PagedEngineConfig,
                                     RequestSource)

    cfg = get_config("granite-3-2b")
    model = init_params(cfg, seed=0, device="cuda")
    src = RequestSource(vocab_size=cfg.vocab_size, prompt_len=160, raw_rate=2,
                        max_new_tokens=40, seed=5)
    reqs = src.poll(0, 2.0)
    paged = PagedEngine(model, PagedEngineConfig(prompt_len=160, cache_len=256, page_size=16,
                                                 num_pages=24, max_active=2,
                                                 max_pages_per_req=13))
    dense = Engine(model, EngineConfig(batch_slots=2, prompt_len=160, cache_len=256))
    for eng in (paged, dense):
        eng.warm_decode(2)
        eng.submit([copy.deepcopy(r) for r in reqs])
        for t in range(80):
            eng.step_slot(t, n_steps=2)
            if len(eng.finished) == len(reqs):
                break
    got = {r.rid: r.generated for r in paged.finished}
    want = {r.rid: r.generated for r in dense.finished}
    prompts = {r.rid: r.tokens for r in reqs}
    parted = {}
    for rid, w in want.items():
        g = got.get(rid, [])
        d = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if d is None and len(g) == len(w):
            continue
        seq = np.concatenate([prompts[rid], np.asarray(w[:d], np.int32)])[None]
        lg, _ = prefill(model, torch.from_numpy(seq).cuda(), seq.shape[1])
        top = lg[0].float().topk(2).values
        parted[rid] = {"at": d, "margin": (top[0] - top[1]).item()}
    res = {"preemptions": paged.preemptions, "finished": len(paged.finished),
           "tokens": sum(map(len, got.values())), "streams_parted": parted,
           "counters": paged.counters()}
    emit("preemption", **res)
    del model, paged, dense
    torch.cuda.empty_cache()
    if res["preemptions"] <= 0:
        raise AssertionError("no row was preempted")
    if res["finished"] != len(reqs) or any(v["margin"] > MODEL_TOL for v in parted.values()):
        raise AssertionError("the preempted paged engine's tokens left the dense engine's")
    return res


def _chunked_logits(model, toks, lens, C, L, feed, impl):
    """The prompts through ``chunk_step`` in chunks of C (a row's first
    chunk resets the boot prefill's cache, as a recycled engine row's
    does), then 16 decode steps fed ``feed``; returns the (17, B, V) float32
    logits: each row's activation logits (its final chunk's), then the
    decode steps."""
    from repro_torch.models import attention as A
    from repro_torch.models import chunk_step, decode_step, prefill

    kernels_ops, A.ops = A.ops, impl
    B, P = toks.shape
    lens_np = lens.cpu().numpy()
    _, state = prefill(model, torch.zeros_like(toks), L)
    first = torch.zeros((B, model.cfg.vocab_size), dtype=torch.float32, device="cuda")
    for pos0 in range(0, P, C):
        valid_np = np.clip(lens_np - pos0, 0, C).astype(np.int32)
        if not valid_np.any():
            break
        p0_np = np.full(B, pos0, np.int32)
        tok = toks[:, pos0:pos0 + C].contiguous()
        logits, state = chunk_step(model, state, tok, torch.from_numpy(p0_np).cuda(),
                                   torch.from_numpy(valid_np).cuda(),
                                   torch.from_numpy(p0_np == 0).cuda())
        fin = torch.from_numpy(pos0 + valid_np == lens_np).cuda() & torch.from_numpy(
            valid_np > 0).cuda()
        first = torch.where(fin[:, None], logits.float(), first)
    out = [first]
    for step in range(16):
        logits, state = decode_step(model, state, feed[step])
        out.append(logits.float())
    A.ops = kernels_ops
    del state
    return torch.stack(out)


def check_chunk_model() -> dict:
    """Full-width granite-3-2b on seeded weights: prompts of 128-512 tokens
    through ``chunk_step`` in chunks of 128 (K4) and through the one-shot
    ragged prefill (K1r), then 16 greedy decode steps (K2) on the same fed
    tokens; the activation logits and every decode step agree within
    MODEL_TOL. On the card K4 and K1r sum in other orders (on the CPU the
    two paths agree to ~1e-6, tests/test_torch_chunked.py), so the
    tolerance is the model check's. Beside it a path whose chunk attention
    sees only the chunk itself (earlier chunks masked) must land beyond."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    cfg = get_config("granite-3-2b")
    model = init_params(cfg, seed=0, device="cuda")
    B, S, L, C = 8, 512, 1024, 128
    rng = np.random.default_rng(1)
    lens = torch.tensor([512, 300, 129, 128, 512, 200, 384, 450], dtype=torch.int32,
                        device="cuda")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    lp = _greedy_logits(model, toks, L, lens, ops)
    feed = lp[:-1].argmax(-1).to(torch.int32)

    def own_chunk_only(q, k, v, slot_pos, pos0, valid):
        sp = torch.where(slot_pos < pos0[:, None], -1, slot_pos)
        return ops.chunk_attention(q, k, v, sp, pos0, valid)

    lc = _chunked_logits(model, toks, lens, C, L, feed, ops)
    lf = _chunked_logits(model, toks, lens, C, L, feed,
                         SimpleNamespace(flash_attention=ops.flash_attention,
                                         decode_attention=ops.decode_attention,
                                         chunk_attention=own_chunk_only))
    torch.cuda.synchronize()
    if not (torch.isfinite(lc).all() and lc.shape == lp.shape):
        raise AssertionError("bad chunked-path logits")
    errs = (lc - lp).abs().amax(dim=(1, 2)).tolist()
    fault = (lf - lp).abs().amax(dim=(1, 2)).tolist()
    top2 = lp.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > MODEL_TOL
    res = {"tol": MODEL_TOL, "logit_scale": lp.abs().max().item(), "chunk": C,
           "prompt_lens": lens.tolist(), "max_abs_err_per_step": errs,
           "token_mismatches_beyond_margin": int((lc.argmax(-1) != lp.argmax(-1))[sure].sum()),
           "own_chunk_only_max_abs_err_per_step": fault}
    emit("chunk_model", **res)
    del model, lp, lc, lf
    torch.cuda.empty_cache()
    if max(errs) > MODEL_TOL or res["token_mismatches_beyond_margin"]:
        raise AssertionError("chunked path and one-shot prefill disagree")
    if not max(fault) > MODEL_TOL:
        raise AssertionError("the model tolerance does not catch a chunk that "
                             "ignores the earlier chunks")
    return res


def _paged_chunk_impls():
    """Stand-ins for ``repro_torch.kernels.ops`` in the paged chunked model
    check: the plain versions, and two deliberately faulty chunk
    attentions: one that reads the staging buffers for the prefix hit [0,
    base) as well (base taken as 0), one that dequantizes with unit
    scales."""
    from types import SimpleNamespace

    from repro_torch.kernels import ops, ref

    def quant(q, k, v, qk, qv, ks, vs, bt, pos):
        return ref.paged_decode_attention_quant_ref(q, qk, qv, ks, vs, bt, pos)

    def staging_for_the_hit(q, *pool_and_tables, stage_k=None, stage_v=None, base=None):
        return ops.paged_chunk_attention(q, *pool_and_tables, stage_k=stage_k, stage_v=stage_v,
                                         base=torch.zeros_like(base))

    def unit_scales(q, k, v, qk, qv, ks, vs, *rest, **kw):
        return ops.paged_chunk_attention(q, k, v, qk, qv, torch.ones_like(ks),
                                         torch.ones_like(vs), *rest, **kw)

    plain = SimpleNamespace(paged_chunk_attention=ref.paged_chunk_attention_ref,
                            paged_decode_attention_quant=quant)
    faults = {name: SimpleNamespace(paged_chunk_attention=fn,
                                    paged_decode_attention_quant=ops.paged_decode_attention_quant)
              for name, fn in (("staging_read_for_the_prefix_hit", staging_for_the_hit),
                               ("unit_scales", unit_scales))}
    return plain, faults


def _paged_chunk_logits(model, sys_toks, suffixes, impl, feed=None):
    """Full width, an all-int8 pool with staging buffers: rows 0-3 (the
    writers) each prefill tenant i's system prompt and a suffix through
    ``chunk_step_paged`` in chunks of 128; rows 4-7 (the readers) share the
    writer's 24 full system-prompt pages, fork its 25th page copy-on-write
    (``fork_pages``) and prefill only their own tokens from base 392 on,
    reading the hit from the pool and the rest from staging; then 16
    decode steps on ``feed`` (None: each step's argmax). Returns the
    (17, 8, V) float32 logits: each row's activation logits, then the
    decode steps."""
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T

    kernels_ops, A.ops = A.ops, impl
    cfg = model.cfg.replace(kv_precision="int8")
    B, P, ps, MP, C = 8, 512, 16, 64, 128
    N = B * MP
    toks = [np.concatenate([sys_toks[b % 4], suffixes[b]]) for b in range(B)]
    lens = np.asarray([len(t) for t in toks], np.int32)
    perm = np.random.default_rng(3).permutation(N).astype(np.int32)
    bt = perm.reshape(B, MP).copy()
    hit = PREFIX_SYS_LEN // ps
    bt[4:, :hit] = bt[:4, :hit]              # the readers share the writers' full pages
    pools = T.paged_pools_init(cfg, N, ps, "cuda", stage_rows=B, stage_len=P)
    state = M.PagedDecodeState(pools, torch.from_numpy(bt).cuda(),
                               torch.zeros(B, dtype=torch.int32, device="cuda"),
                               torch.zeros(B, dtype=torch.int32, device="cuda"))
    first = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device="cuda")
    base = np.where(np.arange(B) >= 4, PREFIX_SYS_LEN, 0).astype(np.int32)
    for rows in (range(4), range(4, B)):
        if rows.start:   # the readers' copy-on-write forks of the boundary pages
            M.fork_pages(pools, torch.from_numpy(bt[:4, hit].astype(np.int64)).cuda(),
                         torch.from_numpy(bt[4:, hit].astype(np.int64)).cuda())
        for pos0 in range(int(base[rows.start]), P, C):
            tok = np.zeros((B, C), np.int32)
            p0 = np.zeros(B, np.int32)
            nv = np.zeros(B, np.int32)
            for b in rows:
                n = int(np.clip(lens[b] - pos0, 0, C))
                tok[b, :n] = toks[b][pos0:pos0 + n]
                p0[b], nv[b] = pos0, n
            if not nv.any():
                break
            logits, state = M.chunk_step_paged(
                model, state, *(torch.from_numpy(a).cuda() for a in (tok, p0, nv, base)))
            fin = torch.from_numpy((nv > 0) & (p0 + nv == lens)).cuda()
            first = torch.where(fin[:, None], logits.float(), first)
    out = [first]
    for step in range(16):
        nxt = out[-1].argmax(-1).to(torch.int32) if feed is None else feed[step]
        logits, state = M.decode_step_paged(model, state, nxt)
        out.append(logits.float())
    A.ops = kernels_ops
    del state, pools
    return torch.stack(out)


def check_paged_chunk_model() -> dict:
    """Full-width granite-3-2b on seeded weights, bf16: the paged chunked
    prefill with prefix hits on an int8 pool (``_paged_chunk_logits``) and
    16 decode steps through the kernels (K4p, K3q) against the plain
    versions on the same fed tokens; the two faulty chunk attentions of
    ``_paged_chunk_impls`` must land beyond PAGED_CHUNK_MODEL_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    cfg = get_config("granite-3-2b")
    model = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(2)
    sys_toks = [rng.integers(0, cfg.vocab_size, PREFIX_SYS_LEN).astype(np.int32)
                for _ in range(4)]
    suffixes = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in (120, 16, 64, 100, 16, 120, 77, 40)]
    plain, faults = _paged_chunk_impls()
    lp = _paged_chunk_logits(model, sys_toks, suffixes, plain)
    feed = lp[:-1].argmax(-1).to(torch.int32)
    lk = _paged_chunk_logits(model, sys_toks, suffixes, ops, feed)
    torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and lk.shape == lp.shape):
        raise AssertionError("bad paged chunked kernel-path logits")
    errs = (lk - lp).abs().amax(dim=(1, 2)).tolist()
    reader_errs = (lk[:, 4:] - lp[:, 4:]).abs().amax(dim=(1, 2)).tolist()
    top2 = lp.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > PAGED_CHUNK_MODEL_TOL
    res = {"tol": PAGED_CHUNK_MODEL_TOL, "logit_scale": lp.abs().max().item(),
           "max_abs_err_per_step": errs, "readers_max_abs_err_per_step": reader_errs,
           "tokens_checked": int(sure.sum()),
           "token_mismatches_beyond_margin": int((lk.argmax(-1) != lp.argmax(-1))[sure].sum())}
    failed = []
    for name, impl in faults.items():
        lf = _paged_chunk_logits(model, sys_toks, suffixes, impl, feed)
        torch.cuda.synchronize()
        fault = (lf - lp).abs().amax(dim=(1, 2)).tolist()
        res[f"{name}_max_abs_err_per_step"] = fault
        if not max(fault) > PAGED_CHUNK_MODEL_TOL:
            failed.append(f"the tolerance does not catch {name}")
        del lf
    emit("paged_chunk_model", **res)
    del model, lp, lk
    torch.cuda.empty_cache()
    if max(errs) > PAGED_CHUNK_MODEL_TOL or res["token_mismatches_beyond_margin"]:
        failed.append("paged chunked kernel path and plain path disagree")
    if failed:
        raise AssertionError("; ".join(failed))
    return res


def _ssd_impls():
    """Stand-ins for ``repro_torch.kernels.ops`` that the Mamba-2 block's
    prefill calls: the plain scan, and a deliberately faulty one that runs
    the kernel on each chunk from a zero state, as a kernel that dropped the
    state carried between chunks would."""
    from types import SimpleNamespace

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd

    def plain(x, dt, A, Bm, Cm, *, chunk, init_state=None):
        return ref.ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state)

    def no_carry(x, dt, A, Bm, Cm, *, chunk, init_state=None):
        ys, st = [], None
        for a in range(0, x.shape[1], chunk):
            part = (t[:, a:a + chunk].contiguous() for t in (x, dt, Bm, Cm))
            px, pdt, pB, pC = part
            y, st = kssd.ssd_scan(px, pdt, A, pB, pC, chunk=chunk,
                                  init_state=init_state if a == 0 else None)
            ys.append(y)
        return torch.cat(ys, dim=1), st

    return SimpleNamespace(ssd=plain), SimpleNamespace(ssd=no_carry)


# prompt positions whose logits the Mamba-2 check compares: the first and
# last step of each 128-step chunk and the steps after each boundary, where
# the state carried between chunks decides the output (with random weights
# the decay exp(sum dt A) over a whole chunk is ~0, so the last position
# alone would not see it)
SSM_POSITIONS = (0, 1, 64, 127, 128, 129, 130, 255, 256, 257, 383, 384, 385, 511)


def _ssm_logits(model, toks, impl, feed=None):
    """The logits at SSM_POSITIONS of the prompt (the last is the prefill's)
    and 16 greedy decode steps, with the Mamba-2 blocks' scan pointed at
    ``impl``; (len(SSM_POSITIONS) + 16, B, V) float32. ``feed`` (16, B)
    fixes the decoded tokens, else each step takes the previous argmax."""
    from repro_torch.models import decode_step
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rmsnorm, unembed

    kernels_ops, SSM.ops = SSM.ops, impl
    cfg = model.cfg
    B, S = toks.shape
    h, caches = T.prefill_hidden(model.stack, M._embed(model, toks), cfg, cache_len=S)
    out = [unembed(model.tok, rmsnorm(model.ln_f, h[:, p], cfg.norm_eps)).float()
           for p in SSM_POSITIONS]
    del h
    state = M.DecodeState(caches=caches,
                          pos=torch.full((B,), S, dtype=torch.int32, device=toks.device),
                          last_tok=toks[:, -1])
    for step in range(16):
        nxt = out[-1].argmax(-1).to(torch.int32) if feed is None else feed[step]
        logits, state = decode_step(model, state, nxt)
        out.append(logits.float())
    SSM.ops = kernels_ops
    del state
    return torch.stack(out)


def check_ssm_model() -> dict:
    """Full-width mamba2-130m on seeded weights (24 layers, d 768, 24 SSD
    heads of 64, state 128, bf16): 8 prompts of 512 tokens (the serve's
    bucket) through the prefill, then 16 greedy decode steps on fed tokens,
    with the scan on K6 and on the plain version; the logits at
    SSM_POSITIONS and every step within SSM_MODEL_TOL, and a path whose
    scan drops the state carried between chunks beyond it. Then the smoke
    model on the card against the CPU path the CPU tests hold against the
    JAX package (float32 both; S 40: two chunks of 16 and a tail)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config("mamba2-130m")
    model = init_params(cfg, seed=0, device="cuda")
    B, S = 8, 512
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    plain, no_carry = _ssd_impls()
    lp = _ssm_logits(model, toks, plain)
    n = len(SSM_POSITIONS)
    feed = lp[n - 1:-1].argmax(-1).to(torch.int32)   # every path decodes the same tokens
    lk = _ssm_logits(model, toks, ops, feed)
    lf = _ssm_logits(model, toks, no_carry, feed)
    torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and lk.shape == (n + 16, B, cfg.vocab_size)):
        raise AssertionError("bad kernel-path logits")
    errs = (lk - lp).abs().amax(dim=(1, 2)).tolist()
    fault = (lf - lp).abs().amax(dim=(1, 2)).tolist()
    top2 = lp.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > SSM_MODEL_TOL
    flips = int((lk.argmax(-1) != lp.argmax(-1))[sure].sum())
    res = {"logit_scale": lp.abs().max().item(), "tol": SSM_MODEL_TOL,
           "positions": list(SSM_POSITIONS),
           "max_abs_err_per_position": errs[:n], "max_abs_err_per_step": errs[n:],
           "tokens_checked": int(sure.sum()), "token_mismatches_beyond_margin": flips,
           "no_carry_max_abs_err_per_position": fault[:n],
           "no_carry_max_abs_err_per_step": fault[n:]}
    del model, lk, lp, lf
    torch.cuda.empty_cache()
    if max(errs) > SSM_MODEL_TOL or flips:
        emit("ssm_model", **res)
        raise AssertionError("mamba2 kernel path and plain path disagree")
    if not max(fault) > SSM_MODEL_TOL:
        emit("ssm_model", **res)
        raise AssertionError("the model tolerance does not catch a dropped state carry")

    smoke = get_config("mamba2-130m", smoke=True)
    cpu_m = init_params(smoke, seed=0, device="cpu")
    gpu_m = init_params(smoke, seed=0, device="cpu").cuda()
    st = torch.from_numpy(rng.integers(0, smoke.vocab_size, (4, 40)).astype(np.int32))
    lc, scpu = prefill(cpu_m, st, 64)
    lg, sgpu = prefill(gpu_m, st.cuda(), 64)
    smoke_err = [(lg.cpu() - lc).abs().max().item()]
    for _ in range(3):
        nxt = lc.argmax(-1).to(torch.int32)
        lc, scpu = decode_step(cpu_m, scpu, nxt)
        lg, sgpu = decode_step(gpu_m, sgpu, nxt.cuda())
        smoke_err.append((lg.cpu() - lc).abs().max().item())
    state_err = max((g.ssd.cpu() - c.ssd).abs().max().item()
                    for g, c in zip(sgpu.caches, scpu.caches))
    res.update(smoke_max_abs_err=smoke_err, smoke_state_max_abs_err=state_err, smoke_tol=1e-4)
    emit("ssm_model", **res)
    if max(smoke_err) > 1e-4 or state_err > 1e-4:
        raise AssertionError("smoke mamba2 model on the card disagrees with the CPU path")
    return res


# --------------------------------------------------------------- serve
# kernels each path must launch
DENSE_KERNELS = ("flash_attention", "flash_attention_ragged", "decode_attention")
PAGED_KERNELS = ("flash_attention_ragged", "paged_decode_attention")
SYNC_KERNELS = ("flash_attention_ragged", "decode_attention")
CHUNKED_KERNELS = ("chunk_attention", "decode_attention")
QUANT_KERNELS = ("flash_attention_ragged", "paged_decode_attention_quant")
SSM_KERNELS = ("ssd_scan",)
PAGED_SYNC_KERNELS = PAGED_KERNELS
PAGED_CHUNKED_KERNELS = ("paged_chunk_attention", "paged_decode_attention")
PREFIX_KERNELS = ("paged_chunk_attention_quant", "paged_decode_attention_quant")
DENSE_QUANT_KERNELS = ("flash_attention", "flash_attention_ragged", "decode_attention_quant")
DENSE_QUANT_CHUNKED_KERNELS = ("chunk_attention", "decode_attention_quant")


def _sync_checked(sched) -> None:
    """Run every control slot's engine work, from slot 0's, under
    ``set_sync_debug_mode("error")``: any call that synchronizes the
    stream raises. Only the scheduler's first decision is exempt
    (``control_async`` waits for it to seed its pipeline); the mode is
    switched on as that call returns, after the warm-up and the captures,
    and stays on through the serve's ``drain``."""
    control, calls = sched.control_async, [0]

    def checked(*a, **kw):
        calls[0] += 1
        out = control(*a, **kw)
        if calls[0] == 1:
            torch.cuda.set_sync_debug_mode("error")
        return out
    sched.control_async = checked


def _watch_precision(sched, engine) -> list:
    """Record, each slot, the admission precision the scheduler picks and,
    once the slot's admissions are in, the quantized region's used pages
    and the regions of the rows the decode runs."""
    log, ask, ensure = [], sched.admit_precision, engine._ensure_pages

    def watched(occupancy):
        log.append({"chosen": ask(occupancy)})
        return log[-1]["chosen"]

    def ensure_watched(n_steps, sync=False):
        ensure(n_steps, sync)
        alloc = engine.allocator
        log[-1].update(quant_used_pages=alloc.stats().quant_used_pages,
                       regions=sorted({alloc.precision_of(r) for r in alloc.holders()}))
    sched.admit_precision = watched
    engine._ensure_pages = ensure_watched
    return log


def _count_mixed(engine) -> list:
    """Count the engine's mixed (chunk + decode) dispatches, those with a
    row whose prompt starts past a prefix-cache hit (base > 0: its chunk
    attention reads the hit's pool pages), and the warm-up's idle ones
    (``warm_decode``, before the first slot)."""
    mixed, run = [0, 0, 0], engine._chunk_decode_sync

    def counted(plan, n_steps, **kw):
        if engine._warming:
            mixed[2] += 1
        else:
            mixed[0] += 1
            mixed[1] += bool((plan["ints"][3] > 0).any())
        return run(plan, n_steps, **kw)
    engine._chunk_decode_sync = counted
    return mixed


def _warm(engine, sync: bool = False, chunked: bool = False) -> float:
    """Warm up and capture the dispatches a serve replays
    (``Engine.warm_decode``, which ``serve`` calls before its first slot)
    ahead of a timed serve, the garbage of earlier phases collected first:
    an earlier engine's graphs freed mid-serve would synchronize the device.
    Returns the seconds it took."""
    gc.collect()
    t = time.perf_counter()
    engine.warm_decode(2, sync=sync, chunked=chunked)
    torch.cuda.synchronize()
    return time.perf_counter() - t


def _chunk_replays(engine) -> int:
    """Replays of the engine's mixed-dispatch graphs ("chunk", "chunk+s")."""
    return sum(g.replays for m, g in engine._graphs.items() if m.startswith("chunk"))


def _warmups(args, engine) -> tuple:
    """The dispatches ``warm_decode`` runs before a launcher serve's first
    slot, and of them the admissions: each mode the loop replays (the
    chunked loop's mixed dispatch and its decode-only one; the fused and
    sync-free loops' decode and their admission of each prompt bucket),
    twice with an engine-default sampler (the greedy and the sampled
    graph)."""
    if args.legacy_loop:
        return 0, 0
    sampled = any(getattr(args, f) is not None for f in
                  ("temperature", "top_k", "top_p", "rep_penalty", "sampling_seed"))
    variants = 2 if sampled else 1
    if args.chunked:
        return 2 * variants, 0
    buckets = len(engine._warm_buckets())
    return (1 + buckets) * variants, buckets * variants


def _prefill_graph_launches(engine) -> dict:
    """The kernels one admission graph must hold: K1r once per layer on an
    attention stack, the SSD scan's (K6) on a Mamba-2 one."""
    n = engine.cfg.n_layers
    if engine.cfg.is_ssm:
        return {k: n for k in ("ssd_scan", *SSD_PHASES)}
    return {"flash_attention_ragged": n}


def _check_prefill_graphs(phase: str, engine) -> None:
    """Every admission graph the engine captured holds its kernels (their
    nodes read from libcuda at the capture) and every admission dispatch
    was a replay of one."""
    want = _prefill_graph_launches(engine)
    for mode, g in engine._graphs.items():
        if "prefill" in mode and g.graph is not None and g.launches != want:
            raise AssertionError(f"{phase}: the {mode} graph holds {g.launches}, not {want}")
    if engine.prefill_replays != engine.prefill_dispatches:
        raise AssertionError(f"{phase}: {engine.prefill_replays} admission graph replays for "
                             f"{engine.prefill_dispatches} admission dispatches")


def _paged_decode_sync_checked():
    """Run the paged fused loop's decode dispatch under
    ``set_sync_debug_mode("error")``: the eager body (``_decode_n_paged``,
    which also runs at the warm-up and inside the capture) and every graph
    replay with its static fills. The write targets come from the device,
    so nothing in the dispatch reads back to the host (fault F1); the slot's
    one counted readback, the tokens, comes after it. Returns the function
    that puts the originals back."""
    from repro_torch.runtime import engine as E
    from repro_torch.runtime import graph as G

    decode, replay = E._decode_n_paged, G.DecodeGraph._replay

    def checked(fn):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run
    E._decode_n_paged = checked(decode)
    G.DecodeGraph._replay = checked(replay)

    def restore():
        E._decode_n_paged = decode
        G.DecodeGraph._replay = replay
    return restore


def _memory_start() -> int:
    """Collect garbage (an earlier phase's engine, freed before this one's
    peak), reset the peak and return the memory allocated now, which the
    peak counts too."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _memory(held: int) -> dict:
    """A phase's peak: all memory allocated at its highest, what was
    allocated at its start (``_memory_start``), and the phase's own, their
    difference."""
    peak = torch.cuda.max_memory_allocated()
    return {"max_memory_allocated": peak, "allocated_at_start": held,
            "own_peak_gb": (peak - held) / 1e9}


def drive_main_path(argv: list, phase: str = "serve", path_kernels=DENSE_KERNELS,
                    keep: bool = False) -> dict:
    """One of the launcher's paths: build (the dense engine's boot prefill
    runs K1, or K6 on a Mamba-2 stack) and serve. The launch counts are
    zeroed just before the build and read just after the serve; every
    kernel of the path must have launched. The sync-free and chunked paths
    run under the sync debug mode after their first slot
    (``_sync_checked``); the chunked, quantized and Mamba-2 traces are held
    to the same launcher's on the CPU (``cpu_trace``). The result also
    holds the finished requests' streams (``streams``, not printed) and,
    with ``keep``, the parsed arguments, engine, scheduler and trace
    (``run``) for the caller's own checks."""
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher

    args = launcher.build_parser().parse_args(argv)
    held = _memory_start()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    engine, sched, src = launcher.build(args)
    torch.cuda.synchronize()
    asynchronous = args.sync_free or args.chunked
    if asynchronous:
        _sync_checked(sched)
    restore = _paged_decode_sync_checked() if args.paged and not asynchronous else None
    mixed = _count_mixed(engine) if args.chunked else [0, 0, 0]
    watch = args.policy == "precision-aware"
    precision = _watch_precision(sched, engine) if watch else []
    warm_s = 0.0 if args.legacy_loop else _warm(engine, args.sync_free, args.chunked)
    t1 = time.perf_counter()
    try:
        tr = launcher.run(args, engine, sched, src)
        if asynchronous:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()   # the last slot's work, before the clock stops
    finally:
        torch.cuda.set_sync_debug_mode(0)
        if restore is not None:
            restore()
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    captured = not args.legacy_loop
    res = {"summary": launcher.summary(args, tr, sched), "build_s": t1 - t0 - warm_s,
           "warmup_s": warm_s, "serve_s": t2 - t1, "ms_per_slot": (t2 - t1) / args.horizon * 1e3,
           "launches": counts, "served": int(tr["served"].sum()),
           "dispatches_per_slot": float(tr["dispatches"].mean()),
           "decode_dispatches": engine.decode_dispatches,
           "prefill_dispatches": engine.prefill_dispatches,
           "warmup_dispatches": engine.warmup_dispatches,
           "prefill_warmups": engine.prefill_warmups,
           "graph_replays": engine.graph_replays,
           "prefill_replays": engine.prefill_replays,
           # each graph's launches per counter and kernel nodes per kernel
           # function, read from libcuda at its capture (equal summed per
           # function): what every replay adds to the counts
           "graph_nodes": {m: g.launches for m, g in engine._graphs.items() if g.graph},
           "graph_kernel_nodes": {m: g.nodes for m, g in engine._graphs.items() if g.graph},
           **_memory(held), "counters": engine.counters(), "syncs": tr["syncs"].tolist(),
           "trace": {c: tr[c].tolist() for c in ("rate", "served", "backlog", "dispatches")}}
    if args.paged:
        res.update(paged=launcher.paged_summary(tr, engine),
                   peak_occupancy=float(tr["occupancy"].max()),
                   occupancy=tr["occupancy"].tolist())
    if args.chunked:
        res.update(mixed_dispatches=mixed[0], mixed_warmups=mixed[2],
                   chunk_graph_replays=_chunk_replays(engine))
    if engine.ecfg.sampling is not None:
        res["sampling"] = launcher.sampling_summary(engine)
    if watch:
        chosen = [p["chosen"] for p in precision]
        res.update(quant=launcher.quant_summary(args, engine), admit_precision=chosen,
                   flips=[[a, b] for a, b in zip(chosen, chosen[1:]) if a != b],
                   quant_used_pages=[p["quant_used_pages"] for p in precision],
                   slots_with_both_regions=sum(len(p["regions"]) == 2 for p in precision))
    emit(phase, **res)
    if res["served"] <= 0 or res["dispatches_per_slot"] > 2:
        raise AssertionError(f"{phase}: the path served nothing or over-dispatched")
    missing = [k for k in path_kernels if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{phase}: kernels never launched on the path: {missing}")
    # every decode, mixed and admission dispatch: warmed up and captured
    # before the first slot (warm_decode), then one replay each
    warm, warm_prefill = _warmups(args, engine)
    want_replays = engine.decode_dispatches + engine.prefill_dispatches if captured else 0
    if (engine.graph_replays != want_replays or engine.warmup_dispatches != warm
            or engine.prefill_warmups != warm_prefill):
        raise AssertionError(f"{phase}: {engine.graph_replays} graph replays for "
                             f"{engine.decode_dispatches} decode and "
                             f"{engine.prefill_dispatches} admission dispatches "
                             f"({engine.warmup_dispatches} warm-ups, "
                             f"{engine.prefill_warmups} of admissions)")
    if captured:
        _check_prefill_graphs(phase, engine)
    if args.chunked and (_chunk_replays(engine) != mixed[0]
                         or mixed[2] != warm // 2):
        raise AssertionError(f"{phase}: {_chunk_replays(engine)} chunk graph replays for "
                             f"{mixed[0]} mixed dispatches ({mixed[2]} warm-ups)")
    n_layers = engine.cfg.n_layers
    ssm = engine.cfg.is_ssm
    quant = args.kv_precision in ("int8", "fp8")
    ring = "decode_attention_quant" if quant else "decode_attention"   # the dense decode
    want = {}
    # the admissions (their warm-ups too) and the decodes (theirs too)
    prefills = engine.prefill_dispatches + engine.prefill_warmups
    decodes = engine.decode_dispatches + engine.warmup_dispatches - engine.prefill_warmups
    if ssm:   # every prefill (the boot's too) runs the scan once per layer, bf16: three kernels
        want = {k: n_layers * (prefills + 1) for k in ("ssd_scan", *SSD_PHASES)}
    elif args.paged:
        quant = args.kv_precision in ("int8", "fp8")
        decode = "paged_decode_attention_quant" if quant else "paged_decode_attention"
        want = {"flash_attention_ragged": n_layers * prefills,
                decode: n_layers * decodes * 2}
        if args.chunked:
            chunk = "paged_chunk_attention_quant" if quant else "paged_chunk_attention"
            want[chunk] = n_layers * (mixed[0] + mixed[2])
    else:
        want = {"flash_attention_ragged": n_layers * prefills,
                ring: n_layers * decodes * 2,
                "chunk_attention": n_layers * (mixed[0] + mixed[2])}
        if quant:   # a quantized ring never reaches the native decode
            want["decode_attention"] = 0
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"{phase}: launches {counts} are not {want}")
    if asynchronous and (engine.blocking_syncs or max(res["syncs"])):
        raise AssertionError(f"{phase}: blocking syncs {res['syncs']} on a sync-free path")
    if args.chunked:
        if engine.prefill_dispatches or max(res["trace"]["dispatches"]) > 1 or not mixed[0]:
            raise AssertionError(f"{phase}: a chunked slot ran a prefill or over-dispatched")
    if watch:
        if ["native", "int8"] not in res["flips"] or ["int8", "native"] not in res["flips"]:
            raise AssertionError(f"{phase}: the latch did not flip both ways: {res['flips']}")
        if not max(res["quant_used_pages"]) or not res["slots_with_both_regions"]:
            raise AssertionError(f"{phase}: the quantized region was not used beside the "
                                 "native one")
    sampled = engine.ecfg.sampling is not None
    if args.chunked or watch or ssm or (args.paged and asynchronous) or quant or sampled:
        res["trace"]["occupancy"] = tr["occupancy"].tolist()
        cpu = cpu_trace(argv)
        if cpu != res["trace"]:
            raise AssertionError(f"{phase}: the trace {res['trace']} is not the CPU run's {cpu}")
    res["streams"] = {r.rid: list(r.generated) for r in engine.finished}
    if keep:
        res["run"] = (args, engine, sched, tr)
    return res


PREFIX_HORIZON = 12


def _prefix_source():
    """prefix_serve's seeded request source: the launcher's raw rate of 5
    per slot subsampled at the controller's rate, max_new_tokens 4; each
    prompt is one of PREFIX_TENANTS fixed PREFIX_SYS_LEN-token system
    prompts and a random suffix of PREFIX_SUFFIX tokens. Token ids below
    256 serve the smoke model's vocabulary and the full one alike: a prefix
    hit depends on the ids only."""
    from repro_torch.runtime import Request

    class TenantPromptSource:
        def __init__(self, seed: int = 0, raw_rate: int = 5):
            self.rng = np.random.default_rng(seed)
            self.raw_rate = raw_rate
            self.system = [self.rng.integers(0, 256, PREFIX_SYS_LEN, dtype=np.int32)
                           for _ in range(PREFIX_TENANTS)]
            self.next_id = 0

        def poll(self, slot: int, rate: float) -> list:
            out = []
            for _ in range(int(self.rng.binomial(self.raw_rate, min(rate / self.raw_rate, 1.0)))):
                tenant = int(self.rng.integers(0, PREFIX_TENANTS))
                n = int(self.rng.integers(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1))
                toks = np.concatenate([self.system[tenant],
                                       self.rng.integers(0, 256, n, dtype=np.int32)])
                out.append(Request(rid=self.next_id, arrival_slot=slot, tokens=toks,
                                   max_new_tokens=4))
                self.next_id += 1
            return out

    return TenantPromptSource()


def _prefix_build(device: str = "cuda", smoke: bool = False):
    """prefix_serve's model, engine and scheduler: PagedEngine with prefix
    sharing on an all-int8 pool (16 rows, 192 pages of 16, prompt_len 512,
    cache_len 1024, chunks of 128, PREFIX_CHUNK_BUDGET prompt tokens per
    slot) under TokenBacklogAware (token budget 1024, the chunked serve's),
    and the seeded tenant source."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import PagedEngine, PagedEngineConfig, TokenAwareScheduler

    cfg = get_config("granite-3-2b", smoke=smoke)
    model = init_params(cfg, seed=0, device=device)
    engine = PagedEngine(model, PagedEngineConfig(
        prompt_len=512, cache_len=1024, page_size=16, num_pages=192, max_active=16,
        prefix_sharing=True, kv_precision="int8", chunk_budget=PREFIX_CHUNK_BUDGET))
    sched = TokenAwareScheduler(rates=tuple(float(f) for f in range(1, 6)), V=20.0,
                                token_budget=1024.0, tokens_per_request=512.0, capacity=32)
    return engine, sched, _prefix_source()


def _prefix_run(engine, sched, src) -> dict:
    """The launcher's loop (``repro_torch.runtime.serve``), chunked."""
    from repro_torch.runtime import serve

    return serve(engine, sched, src, horizon=PREFIX_HORIZON, steps_per_slot=2, chunked=True)


def drive_prefix_serve() -> dict:
    """prefix_serve at full width: every slot after the first under the
    sync debug mode with 0 blocking syncs; the launch counts (K4p over the
    int8 pool once per layer and mixed dispatch, K3q per layer and decode
    step); prefix hits and copy-on-write forks taken, and K4p launched on
    the quantized pages of a hit; the trace held to the CPU run's with the
    smoke model."""
    from repro_torch import kernels
    from repro_torch.launch.serve import paged_summary, prefix_summary

    held = _memory_start()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    engine, sched, src = _prefix_build()
    torch.cuda.synchronize()
    _sync_checked(sched)
    mixed = _count_mixed(engine)
    warm_s = _warm(engine, chunked=True)
    t1 = time.perf_counter()
    try:
        tr = _prefix_run(engine, sched, src)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    n_layers = engine.cfg.n_layers
    line = prefix_summary(engine)
    print(line, flush=True)
    res = {"prefix": line, "paged": paged_summary(tr, engine), "build_s": t1 - t0 - warm_s,
           "warmup_s": warm_s, "serve_s": t2 - t1, "ms_per_slot": (t2 - t1) / PREFIX_HORIZON * 1e3,
           "launches": counts, "served": int(tr["served"].sum()),
           "mixed_dispatches": mixed[0], "mixed_dispatches_with_a_hit": mixed[1],
           "mixed_warmups": mixed[2], "quantized_hit_launches": n_layers * mixed[1],
           "decode_dispatches": engine.decode_dispatches,
           "prefill_dispatches": engine.prefill_dispatches,
           "warmup_dispatches": engine.warmup_dispatches,
           "prefill_warmups": engine.prefill_warmups,
           "graph_replays": engine.graph_replays,
           "prefill_replays": engine.prefill_replays, "chunk_graph_replays": _chunk_replays(engine),
           "graph_nodes": {m: g.launches for m, g in engine._graphs.items() if g.graph},
           "graph_kernel_nodes": {m: g.nodes for m, g in engine._graphs.items() if g.graph},
           **_memory(held), "counters": engine.counters(), "syncs": tr["syncs"].tolist(),
           "trace": {c: tr[c].tolist() for c in ("rate", "served", "backlog", "dispatches",
                                                 "occupancy")}}
    emit("prefix_serve", **res)
    c = res["counters"]
    want = {"paged_chunk_attention_quant": n_layers * (mixed[0] + mixed[2]),
            "paged_decode_attention_quant":
                n_layers * (engine.decode_dispatches + engine.warmup_dispatches) * 2}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"prefix_serve: launches {counts} are not {want}")
    if (engine.graph_replays != engine.decode_dispatches or engine.warmup_dispatches != 2
            or _chunk_replays(engine) != mixed[0] or mixed[2] != 1):
        raise AssertionError(f"prefix_serve: {engine.graph_replays} graph replays "
                             f"({_chunk_replays(engine)} mixed) for "
                             f"{engine.decode_dispatches} dispatches ({mixed[0]} mixed)")
    if res["served"] <= 0 or engine.prefill_dispatches or max(res["trace"]["dispatches"]) > 1:
        raise AssertionError("prefix_serve: served nothing, ran a prefill or over-dispatched")
    if engine.blocking_syncs or max(res["syncs"]):
        raise AssertionError(f"prefix_serve: blocking syncs {res['syncs']}")
    if not (c["prefix_hit_tokens"] > 0 and c["prefix_forks"] > 0 and mixed[1] > 0):
        raise AssertionError("prefix_serve: no prefix hit, fork or K4p launch on a hit's "
                             "quantized pages")
    engine.allocator.check()
    cpu_engine, cpu_sched, cpu_src = _prefix_build("cpu", smoke=True)
    cpu = _prefix_run(cpu_engine, cpu_sched, cpu_src)
    cpu = {k: cpu[k].tolist() for k in res["trace"]}
    if cpu != res["trace"] or cpu_engine.prefix_hits != engine.prefix_hits:
        raise AssertionError(f"prefix_serve: the trace {res['trace']} is not the CPU run's {cpu}")
    return res


# the fleet phases: granite-3-2b at published widths behind the drift router,
# four sync-free replicas on the one card, and two paged chunked ones of
# which replica 1 fails at slot PAGED_FLEET_FAIL_AT
FLEET_ARGS = SYNC_ARGS + ["--replicas", "4", "--router", "drift"]
PAGED_FLEET_ARGS = PAGED_CHUNKED_ARGS + ["--replicas", "2"]
PAGED_FLEET_FAIL_AT = 6
# a merged stream may leave the one engine's only at a token where that
# engine's own top-2 logit gap is below this: a replica admits other batches,
# so it prefills through other buckets, whose bf16 rounding differs (the
# model phases' rule, MODEL_TOL, on the same weights)
FLEET_TIE = MODEL_TOL


def _one_engine_streams(fleet, reqs: list, mode: str) -> dict:
    """The fleet's requests served again, from scratch, by one engine of the
    replicas' geometry over the same model, stepped until each finishes."""
    import copy

    proto = fleet.replicas[0]
    eng = type(proto)(proto.model, proto.ecfg)
    fresh = []
    for r in reqs:
        r = copy.copy(r)
        r.generated = r.admit_slot = r.start_slot = r.first_token_slot = r.finish_slot = None
        fresh.append(r)
    eng.submit(fresh)
    step = eng.step_slot_chunked if mode == "chunked" else eng.step_slot_sync
    t = 0
    while len(eng.finished) < len(fresh) and t < 400:
        step(t, n_steps=2)
        t += 1
    eng.drain()
    if len(eng.finished) != len(fresh):
        raise AssertionError(f"the one-engine serve finished {len(eng.finished)} of {len(fresh)}")
    return {r.rid: list(r.generated) for r in eng.finished}


def _near_ties(model, got: dict, want: dict, prompts: dict, cache_len: int) -> list:
    """The streams compared with the near-tie rule (``FLEET_TIE``): each
    entry (rid, first differing token, the one engine's top-2 gap there).
    Raises where a stream parts at a gap at or above the rule."""
    from repro_torch.models import model as M

    if got.keys() != want.keys():
        raise AssertionError(f"the fleet finished {sorted(got)}, one engine {sorted(want)}")
    parts = []
    for rid, w in want.items():
        h = got[rid]
        d = next((i for i, (a, b) in enumerate(zip(h, w)) if a != b), None)
        if d is None:
            if len(h) != len(w):
                raise AssertionError(f"request {rid}: {len(h)} tokens, one engine {len(w)}")
            continue
        seq = np.concatenate([prompts[rid], np.asarray(w[:d], np.int32)])[None]
        logits, _ = M.prefill(model, torch.from_numpy(seq).cuda(), cache_len)
        top = torch.topk(logits[0].float(), 2).values
        gap = float(top[0] - top[1])
        parts.append((rid, d, gap))
        if gap >= FLEET_TIE:
            raise AssertionError(f"request {rid} parts from the one engine at token {d}, where "
                                 f"its top-2 gap is {gap} (rule {FLEET_TIE})")
    return parts


def drive_fleet(argv: list, phase: str, fail_at=None) -> dict:
    """A ``ReplicaFleet`` through the launcher (``--replicas``), every
    replica warmed up and captured before slot 0 (``ReplicaFleet.warm_decode``)
    and every slot's engine work under the sync debug mode. With
    ``fail_at`` replica 1 fails at that slot (before its arrivals), and
    after the serve the fleet runs until every admitted request finishes.
    Checks: requests conserved (arrivals = served + dropped + backlog +
    active); every dispatch of every replica a graph replay; 0 blocking
    syncs; the merged streams equal one engine's serving the same requests
    but at its near-ties; after a failure, requeues and no page leaked."""
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher

    args = launcher.build_parser().parse_args(argv)
    emit(phase, stage="start", replicas=args.replicas, router=args.router, fail_at=fail_at)
    held = _memory_start()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fleet, sched, src = launcher.build(args)
    torch.cuda.synchronize()
    mode = "chunked" if args.chunked else "sync"
    arrivals, poll = [], src.poll

    def polled(t, rate):
        if t == fail_at:
            requeued = fleet.fail_replica(1)
            emit(phase, stage="fail_replica", slot=t, requeued=len(requeued))
        reqs = poll(t, rate)
        arrivals.extend(reqs)
        return reqs
    src.poll = polled
    _sync_checked(sched)
    warm_s = _warm(fleet, args.sync_free, args.chunked)
    t1 = time.perf_counter()
    try:
        tr = launcher.run(args, fleet, sched, src)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t2 = time.perf_counter()
    active = sum(r is not None for r in fleet.active)
    served, backlog = int(tr["served"].sum()), fleet.queue_len()
    conserved = len(arrivals) == served + sched.dropped + backlog + active
    res = {"summary": launcher.summary(args, tr, sched),
           "fleet": launcher.fleet_summary(args, fleet), "build_s": t1 - t0 - warm_s,
           "warmup_s": warm_s, "serve_s": t2 - t1, "ms_per_slot": (t2 - t1) / args.horizon * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **_memory(held),
           "served_per_replica": [len(e.finished) for e in fleet.replicas],
           "arrivals": len(arrivals), "served": served, "dropped": sched.dropped,
           "backlog": backlog, "active": active, "conserved": conserved,
           "requeues": fleet.requeues, "alive": list(fleet.alive),
           "routed_per_replica": np.bincount(fleet.router.routed,
                                             minlength=args.replicas).tolist(),
           "prefill_dispatches": [e.prefill_dispatches for e in fleet.replicas],
           "decode_dispatches": [e.decode_dispatches for e in fleet.replicas],
           "warmup_dispatches": [e.warmup_dispatches for e in fleet.replicas],
           "graph_replays": [e.graph_replays for e in fleet.replicas],
           "prefill_replays": [e.prefill_replays for e in fleet.replicas],
           "blocking_syncs": fleet.blocking_syncs, "syncs": tr["syncs"].tolist(),
           "launches": kernels.launch_counts(),
           "trace": {c: tr[c].tolist() for c in ("rate", "served", "backlog", "dispatches")}}
    if args.paged:
        res["paged"] = launcher.paged_summary(tr, fleet)
    emit(phase, **res)
    if not conserved or served <= 0:
        raise AssertionError(f"{phase}: {len(arrivals)} arrivals, {served} served, "
                             f"{sched.dropped} dropped, {backlog} queued, {active} active")
    for i, e in enumerate(fleet.replicas):
        warm, warm_prefill = _warmups(args, e)
        if (e.graph_replays != e.decode_dispatches + e.prefill_dispatches
                or e.warmup_dispatches != warm or e.prefill_warmups != warm_prefill):
            raise AssertionError(f"{phase}: replica {i} replayed {e.graph_replays} graphs for "
                                 f"{e.decode_dispatches} decode and {e.prefill_dispatches} "
                                 f"admission dispatches ({e.warmup_dispatches} warm-ups)")
        _check_prefill_graphs(f"{phase} replica {i}", e)
    if fleet.blocking_syncs or max(res["syncs"]):
        raise AssertionError(f"{phase}: blocking syncs {res['syncs']}")
    if min(res["served_per_replica"]) <= 0:
        raise AssertionError(f"{phase}: a replica served nothing: {res['served_per_replica']}")
    if fail_at is not None:
        t = args.horizon   # every admitted request finishes on the survivor
        while fleet.pending or any(r is not None for r in fleet.active):
            fleet.step_slot_chunked(t, n_steps=2) if mode == "chunked" else \
                fleet.step_slot_sync(t, n_steps=2)
            t += 1
            if t > args.horizon + 400:
                raise AssertionError(f"{phase}: the survivors did not finish the work")
        fleet.drain()
        torch.cuda.synchronize()
        leaks = [e.allocator.stats().used_pages for e in fleet.replicas]
        for e in fleet.replicas:
            e.allocator.check()
        emit(phase, stage="after_failure", finished=len(fleet.finished), slots=t,
             requeues=fleet.requeues, used_pages=leaks)
        if fleet.requeues <= 0 or fleet.alive[1] or any(leaks):
            raise AssertionError(f"{phase}: requeues {fleet.requeues}, alive {fleet.alive}, "
                                 f"pages still held {leaks}")
        if len(fleet.finished) != len(arrivals) - sched.dropped:
            raise AssertionError(f"{phase}: {len(fleet.finished)} finished of "
                                 f"{len(arrivals) - sched.dropped} admitted")
    got = {r.rid: list(r.generated) for r in fleet.finished}
    prompts = {r.rid: np.asarray(r.tokens[:args.prompt_len], np.int32) for r in fleet.finished}
    want = _one_engine_streams(fleet, fleet.finished, mode)
    parts = _near_ties(fleet.replicas[0].model, got, want, prompts, args.cache_len)
    emit(phase, stage="streams", compared=len(want), near_tie_parts=parts)
    return res


# the observability and reliability phases, granite-3-2b at published widths
# (40 layers, bf16, seeded weights): obs_serve is the sync-free serve with
# every collector on (the file paths are added at run time); slo_serve is
# it with two tenants under ConformalSLO and its degradation ladder, the raw
# rate raised from 5 to 32 (rates 1..32) so the load overruns 8 rows: the
# CPU rehearsal at smoke widths reaches overload level 1 at slot 1 and 2 at
# slots 2-3, and the ladder expires 8 queued requests and sheds 20 of the
# lowest tier; chaos_shared_x2 is tests/test_reliability.py's shared-x2
# matrix cell at full width (the injector's seed 40 + 3 x 2)
OBS_AB_REPS = 2
SLO_ARGS = SYNC_ARGS + ["--tenants", "gold:0.3:1:6,bulk:0.7:0:24", "--policy", "conformal-slo",
                        "--raw-rate", "32"]
CHAOS_CONFIG = dict(seed=46, start_slot=2, p_replica_fail=0.25, max_failures=1,
                    p_alloc_shortfall=0.1, p_readback_delay=0.25, delay_polls=2,
                    p_evict_prefix=0.25, evict_pages=2)
CHAOS_SLOTS, CHAOS_RATE = 8, 2.5   # arrival slots of the tenant source, and its rate
CHAOS_KERNELS = ("flash_attention_ragged", "paged_decode_attention")


def _timed_serve(argv: list) -> float:
    """ms per slot of one launcher serve of ``argv``, built and warmed (and
    the graphs captured) off the clock, its last slot's work waited for."""
    from repro_torch.launch import serve as launcher

    args = launcher.build_parser().parse_args(argv)
    engine, sched, src = launcher.build(args)
    _warm(engine, args.sync_free, args.chunked)
    t = time.perf_counter()
    launcher.run(args, engine, sched, src)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / args.horizon * 1e3


def drive_obs_serve(sync_path: dict) -> dict:
    """obs_serve: ``SYNC_ARGS`` with ``--metrics``, ``--trace-out`` and
    ``--decisions-out`` through the launcher, every slot after slot 0 under
    the sync debug mode (``drive_main_path``). Held to sync_serve (the same
    call, telemetry off): equal streams and trace columns, graph replays,
    dispatches and kernel counts. The Prometheus text parses and counts the
    finished requests; the lifecycle trace has an arrival per admission or
    queued request and a retirement per finished one; the decision log has
    one rate record per slot, each record's argmax the rate the scheduler
    dispatched in its slot (read one slot later on this loop). Then ms per
    slot with telemetry off and on, interleaved (off, on, on, off, ...)."""
    import shutil
    import tempfile

    from repro_torch.launch import serve as launcher
    from repro_torch.obs import parse_prometheus

    tmp = tempfile.mkdtemp(prefix="obs_serve_")
    try:
        argv = SYNC_ARGS + ["--metrics", "--trace-out", f"{tmp}/trace.json",
                            "--decisions-out", f"{tmp}/decisions.json"]
        res = drive_main_path(argv, "obs_serve", SYNC_KERNELS, keep=True)
        args, engine, sched, tr = res.pop("run")
        lines = launcher.telemetry_lines(args, engine, sched)
        metrics = parse_prometheus(lines[0])
        with open(f"{tmp}/trace.json") as f:
            events = [e for e in json.load(f)["traceEvents"] if e["ph"] != "M"]
        decisions = engine.obs.decisions
        records = list(decisions.rates)
        dispatched = sched.rate_history[1:] + [float(sched._pending_rate["host"])]
        kinds = {k: sum(e["cat"] == k for e in events) for k in
                 ("arrival", "admission", "retirement", "dispatch", "readback")}
        check = {"metric_lines": len(lines[0].splitlines()), "trace_line": lines[1],
                 "decisions_line": lines[2], "events": kinds,
                 "metrics_requests_finished": metrics["repro_requests_finished"],
                 "finished": len(engine.finished), "pending": len(engine.pending),
                 "rate_records": len(records), "slots": args.horizon,
                 "record_argmax": [r["argmax"] for r in records], "dispatched": dispatched}
        del engine, sched, tr
        off, on = [], []
        for i in range(2 * OBS_AB_REPS):   # interleaved: off, on, on, off, ...
            telemetry = i % 4 in (1, 2)
            (on if telemetry else off).append(_timed_serve(argv if telemetry else SYNC_ARGS))
        timing = {"ms_per_slot_off": off, "ms_per_slot_on": on,
                  "overhead": min(on) / min(off) - 1.0}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("obs_serve", stage="telemetry", **check, **timing,
         sync_serve_ms_per_slot=sync_path["ms_per_slot"], ms_per_slot=res["ms_per_slot"],
         peak_gb=res["max_memory_allocated"] / 1e9)
    same = {k: (res[k], sync_path[k]) for k in ("trace", "streams", "launches", "graph_replays",
                                                "prefill_replays", "decode_dispatches",
                                                "prefill_dispatches", "syncs")}
    differ = [k for k, (a, b) in same.items() if a != b]
    if differ:
        raise AssertionError(f"obs_serve: {differ} differ from sync_serve's with telemetry on")
    if check["metrics_requests_finished"] != check["finished"]:
        raise AssertionError("obs_serve: the exported repro_requests_finished is not the count")
    if (kinds["arrival"] != kinds["admission"] + check["pending"]
            or kinds["retirement"] != check["finished"]):
        raise AssertionError(f"obs_serve: lifecycle events {kinds} for {check['finished']} "
                             f"finished and {check['pending']} queued")
    if check["rate_records"] != args.horizon or check["record_argmax"] != dispatched:
        raise AssertionError(f"obs_serve: {check['rate_records']} rate records, argmax "
                             f"{check['record_argmax']}, dispatched {dispatched}")
    return {**res, **timing}


def _watch_ladder(levels: list, arrivals: list):
    """Record each slot's offered requests and overload level at the SLO
    scheduler's admission; returns the function that puts it back."""
    from repro_torch.reliability import SLOScheduler

    admit = SLOScheduler.admit

    def watched(self, engine, reqs, now):
        arrivals.extend(reqs)
        out = admit(self, engine, reqs, now)
        levels.append(self.degrade_level)
        return out
    SLOScheduler.admit = watched
    return lambda: setattr(SLOScheduler, "admit", admit)


def drive_slo_serve() -> dict:
    """slo_serve: ``SLO_ARGS`` through the launcher, every slot after slot 0
    under the sync debug mode (``drive_main_path``), its decision log on
    (``--decisions-out``). The trace columns, the drop count, the ladder's
    sheds (slot, rid, tenant, rung), each slot's overload level and the slo:
    line equal the same launcher's on the CPU with the smoke model; requests
    are conserved (arrivals = served + dropped + shed + queued + active);
    every shed is in the decision log; the ladder armed."""
    import shutil
    import tempfile

    from repro_torch.launch import serve as launcher

    def ladder(sched, tr, levels) -> dict:
        return {"trace": {k: tr[k].tolist() for k in ("rate", "served", "backlog", "dispatches")},
                "slo": launcher.slo_summary(sched), "dropped": sched.dropped,
                "shed_log": [list(e) for e in sched.shed_log], "levels": list(levels)}

    tmp = tempfile.mkdtemp(prefix="slo_serve_")
    try:
        argv = SLO_ARGS + ["--decisions-out", f"{tmp}/decisions.json"]
        levels, arrivals = [], []
        restore = _watch_ladder(levels, arrivals)
        try:
            res = drive_main_path(argv, "slo_serve", SYNC_KERNELS, keep=True)
        finally:
            restore()
        args, engine, sched, tr = res.pop("run")
        got = ladder(sched, tr, levels)
        c = sched.counters()
        shed = c["requests_shed_expired"] + c["requests_shed_priority"] + c["requests_shed_capped"]
        logged = list(engine.obs.decisions.sheds)
        check = {"arrivals": len(arrivals), "served": int(tr["served"].sum()),
                 "dropped": sched.dropped, "shed": shed, "queued": engine.queue_len(),
                 "active": sum(r is not None for r in engine.active),
                 "shed_records": len(logged), "latency": launcher.latency_stats(engine)}
        del engine, sched, tr
        cpu_levels = []
        restore = _watch_ladder(cpu_levels, [])
        try:
            cpu_args = launcher.build_parser().parse_args([*argv, "--smoke", "--device", "cpu"])
            cpu_engine, cpu_sched, cpu_src = launcher.build(cpu_args)
            cpu = ladder(cpu_sched, launcher.run(cpu_args, cpu_engine, cpu_sched, cpu_src),
                         cpu_levels)
        finally:
            restore()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("slo_serve", stage="ladder", **got, **{k: v for k, v in check.items() if k not in got},
         ms_per_slot=res["ms_per_slot"], peak_gb=res["max_memory_allocated"] / 1e9)
    if got != cpu:
        raise AssertionError(f"slo_serve: {got} is not the CPU run's {cpu}")
    if check["arrivals"] != (check["served"] + check["dropped"] + shed + check["queued"]
                             + check["active"]):
        raise AssertionError(f"slo_serve: requests not conserved: {check}")
    if len(logged) != shed or [(e["rid"], e["reason"]) for e in logged] != \
            [(e[1], e[3]) for e in got["shed_log"]]:
        raise AssertionError(f"slo_serve: {shed} sheds, {len(logged)} in the decision log")
    if max(got["levels"]) < 1 or not shed:
        raise AssertionError(f"slo_serve: the ladder never armed: levels {got['levels']}")
    return res


def _chaos_cell(device: str = "cuda", smoke: bool = False) -> tuple:
    """chaos_shared_x2's model, fleet, injector and workload: two paged
    granite-3-2b engines (prompt_len 512, cache_len 1024, 16 rows, 192 pages
    of 16, native bf16, prefix sharing) behind the drift router, armed with
    ``CHAOS_CONFIG``, and CHAOS_SLOTS slots of ``_prefix_source``'s tenant
    workload at CHAOS_RATE. Returns (model, fleet, chaos, reqs, schedule)."""
    from repro_torch.configs import get_config
    from repro_torch.control import FleetRouter
    from repro_torch.models import init_params
    from repro_torch.reliability import ChaosConfig, ChaosInjector
    from repro_torch.runtime import PagedEngine, PagedEngineConfig, ReplicaFleet

    model = init_params(get_config("granite-3-2b", smoke=smoke), seed=0, device=device)
    ecfg = PagedEngineConfig(prompt_len=512, cache_len=1024, page_size=16, num_pages=192,
                             max_active=16, prefix_sharing=True)
    chaos = ChaosInjector(ChaosConfig(**CHAOS_CONFIG))
    fleet = ReplicaFleet.build(lambda: PagedEngine(model, ecfg), 2,
                               router=FleetRouter(kind="drift"), chaos=chaos)
    src = _prefix_source()
    schedule = [(t, b) for t in range(CHAOS_SLOTS) if (b := src.poll(t, CHAOS_RATE))]
    return model, fleet, chaos, [r for _, b in schedule for r in b], schedule


def drive_chaos_shared_x2() -> dict:
    """chaos_shared_x2: tests/test_reliability.py's shared-x2 matrix cell at
    full width (``_chaos_cell``), the replicas' admissions and decodes
    warmed and captured before slot 0, driven by
    ``reliability.harness.chaos_drive(fleet, "sync")`` under the fault mix:
    replica failure, allocator shortfalls, readback delays and prefix
    evictions. Checks: the streams equal one clean engine's serving the
    same requests but at its near-ties (``FLEET_TIE``, as drive_fleet), the
    same set retires, served = finished = arrivals, no page leaks
    (``assert_no_leaks``), every dispatch of every replica a graph replay,
    both kernels launched, and the fault log, the served counts and the
    retirement equal the same cell's on the CPU with the smoke model (the
    schedule depends on no token)."""
    from repro_torch import kernels
    from repro_torch.reliability import assert_no_leaks, chaos_drive

    held = _memory_start()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model, fleet, chaos, reqs, schedule = _chaos_cell()
    warm_s = _warm(fleet, sync=True)
    t1 = time.perf_counter()
    streams, retired, (served, finished) = chaos_drive(fleet, "sync", reqs, schedule,
                                                       chaos=chaos)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    slots = fleet.steps // 2
    counts = kernels.launch_counts()
    assert_no_leaks(fleet)
    res = {"requests": len(reqs), "served": served, "finished": finished, "slots": slots,
           "ms_per_slot": (t2 - t1) / max(slots, 1) * 1e3, "build_s": t1 - t0 - warm_s,
           "warmup_s": warm_s, "serve_s": t2 - t1, **_memory(held),
           "chaos": chaos.counters(), "chaos_log_len": len(chaos.log),
           "chaos_log": chaos.log, "alive": list(fleet.alive), "requeues": fleet.requeues,
           "served_per_replica": [len(e.finished) for e in fleet.replicas],
           "alloc_failures": [e.alloc_failures for e in fleet.replicas],
           "preemptions": [e.preemptions for e in fleet.replicas],
           "prefix_hit_tokens": [e.prefix_hits for e in fleet.replicas],
           "readback_waits": [e.readback_waits for e in fleet.replicas],
           "decode_dispatches": [e.decode_dispatches for e in fleet.replicas],
           "prefill_dispatches": [e.prefill_dispatches for e in fleet.replicas],
           "graph_replays": [e.graph_replays for e in fleet.replicas],
           "blocking_syncs": fleet.blocking_syncs, "launches": counts}
    emit("chaos_shared_x2", **res)
    if not (served == finished == len(reqs)) or retired != frozenset(r.rid for r in reqs):
        raise AssertionError(f"chaos_shared_x2: {served} served, {finished} finished of "
                             f"{len(reqs)}")
    for i, e in enumerate(fleet.replicas):
        if e.graph_replays != e.decode_dispatches + e.prefill_dispatches:
            raise AssertionError(f"chaos_shared_x2: replica {i} replayed {e.graph_replays} "
                                 f"graphs for {e.decode_dispatches + e.prefill_dispatches} "
                                 "dispatches")
    missing = [k for k in CHAOS_KERNELS if counts[k] <= 0]
    if missing or not chaos.delays_injected or not chaos.shortfalls_injected:
        raise AssertionError(f"chaos_shared_x2: kernels never launched {missing}, or no "
                             f"fault injected: {chaos.counters()}")
    got = {rid: list(s) for rid, s in streams.items()}
    prompts = {r.rid: np.asarray(r.tokens[:512], np.int32) for r in fleet.finished}
    want = _one_engine_streams(fleet, fleet.finished, "sync")
    parts = _near_ties(model, got, want, prompts, 1024)
    _, cpu_fleet, cpu_chaos, cpu_reqs, cpu_schedule = _chaos_cell("cpu", smoke=True)
    _, cpu_retired, cpu_served = chaos_drive(cpu_fleet, "sync", cpu_reqs, cpu_schedule,
                                             chaos=cpu_chaos)
    same_as_cpu = (cpu_chaos.log == chaos.log and cpu_retired == retired
                   and cpu_served == (served, finished)
                   and cpu_fleet.served_history == fleet.served_history)
    emit("chaos_shared_x2", stage="streams", compared=len(want), near_tie_parts=parts,
         same_as_cpu=same_as_cpu)
    if not same_as_cpu:
        raise AssertionError(f"chaos_shared_x2: the CPU run's fault log {cpu_chaos.log} or "
                             "served counts differ from the card's")
    return res


def cpu_trace(argv: list) -> dict:
    """The same launcher arguments with ``--smoke --device cpu``: the
    rate, served, backlog, dispatches and occupancy columns. With no EOS
    the schedule does not depend on the model or the device."""
    from repro_torch.launch import serve as launcher

    cpu_args = launcher.build_parser().parse_args([*argv, "--smoke", "--device", "cpu"])
    engine, sched, src = launcher.build(cpu_args)
    tr = launcher.run(cpu_args, engine, sched, src)
    return {c: tr[c].tolist() for c in ("rate", "served", "backlog", "dispatches", "occupancy")}


# kernel name fragments of each kind of device work, tried in order
# ("decode_attention_kernel" is also inside the paged kernel's name)
KERNEL_KINDS = (("K6", ("ssd_scan_kernel", "ssd_chunk_states_kernel", "ssd_state_passing_kernel",
                        "ssd_chunk_outputs_kernel")),
                ("K4p/K4q", ("paged_chunk_attention_kernel",)),
                ("K3q", ("paged_decode_attention_quant_kernel",)),
                ("K3", ("paged_decode_attention_kernel",)),
                ("K2q", ("decode_attention_quant_kernel",)),
                ("K2", ("decode_attention_kernel",)),
                ("K1/K1r/K1q", ("flash_attention_kernel",)),
                ("K4", ("chunk_attention_kernel",)),
                ("matmuls", ("nvjet", "gemm", "cutlass", "xmma")))


def kernel_kind(name: str) -> str:
    """The kind of a profiled kernel: an attention kernel of the port, a
    matmul, or other (elementwise, copy, index, reduction)."""
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


# the host-side runtime calls that put work on the card: a kernel or a graph
_LAUNCH_CALL = re.compile(r"cu(da)?(LaunchKernel(Ex(C)?)?|GraphLaunch)(_v\d+)?$")
SLOT_MARK = "chip_smoke.slot"


def _slot_marks(sched, on_slot=None) -> None:
    """Wrap the scheduler's control calls, the first thing every slot of
    the serve loop does, in a ``SLOT_MARK`` profiler range, so a profile can
    be cut at slot starts; ``on_slot(t)`` runs before slot t's control."""
    from torch.profiler import record_function

    for name in ("control", "control_async"):
        control, calls = getattr(sched, name), [0]

        def marked(*a, _control=control, _calls=calls, **kw):
            if on_slot is not None:
                on_slot(_calls[0])
            _calls[0] += 1
            with record_function(SLOT_MARK):
                return _control(*a, **kw)
        setattr(sched, name, marked)


def _host_launches(prof) -> list:
    """Host launches (kernel and graph launch calls) per slot of a profile
    taken with ``_slot_marks``: each call goes to the last slot that
    started before it; calls before the first slot (the decode's warm-up
    and capture) go to none."""
    import bisect

    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    # (the profiler also shows each mark on the device's timeline: CPU only)
    starts = sorted(e.time_range.start for e in cpu if e.name == SLOT_MARK)
    per_slot = [0] * max(len(starts), 1)
    for e in cpu:
        slot = bisect.bisect_right(starts, e.time_range.start) - 1
        if _LAUNCH_CALL.match(e.name) and slot >= 0:
            per_slot[slot] += 1
    return per_slot


def _admissions(engine) -> int:
    """Requests admitted so far, less those preempted back to the queue:
    the finished and the active ones (a chunked claim counts, its prompt
    prefills inside the mixed dispatch). It grows in exactly the slots
    that admit."""
    return len(engine.finished) + sum(r is not None for r in engine.active)


def _time_replays():
    """Time every decode-graph replay with CUDA events on the stream:
    (the (start, end) pairs, the function that puts the original back)."""
    from repro_torch.runtime import graph as G

    replay, pairs = G.DecodeGraph._replay, []

    def timed(self, *a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = replay(self, *a, **kw)
        end.record()
        pairs.append((start, end))
        return out
    G.DecodeGraph._replay = timed
    return pairs, lambda: setattr(G.DecodeGraph, "_replay", replay)


def profile_main_path(argv: list, serve_s: float, phase: str = "profile",
                      prefix: bool = False) -> None:
    """Device time by kernel over a second, identical serve run (same seeds,
    same work): the launcher's with ``argv``, or prefix_serve's. The
    profiler slows the host, so the device's idle share is taken against
    the unprofiled run's serve time. Host launches per slot count the
    runtime's kernel and graph launch calls, slot by slot: a captured path
    warms up and captures its decode before the first slot, and every
    slot's decode is a replay. Each replay is also timed with CUDA events,
    and the profile, which opens and closes ``PROFILE_MARGIN_S`` around the
    serve, must hold every port kernel as many times as its wrappers
    counted, inside the graphs or not."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.launch import serve as launcher

    if prefix:
        engine, sched, src = _prefix_build()
        horizon = PREFIX_HORIZON
        run = lambda: _prefix_run(engine, sched, src)
        _warm(engine, chunked=True)
    else:
        args = launcher.build_parser().parse_args(argv)
        engine, sched, src = launcher.build(args)
        horizon = args.horizon
        run = lambda: launcher.run(args, engine, sched, src)
        _warm(engine, args.sync_free, args.chunked)
    # each slot's admission count (an admission dispatch or a chunked claim)
    # at its start, to split the host launches by admitting slots
    admitted = []
    _slot_marks(sched, lambda t: admitted.append(_admissions(engine)))
    pairs, restore = _time_replays()
    kernels.reset_launch_counts()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
    finally:
        restore()
    counts = kernels.launch_counts()
    rows, records = [], {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue   # kernels only: an op's device time is its kernels'
        records[e.key] = records.get(e.key, 0) + e.count
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if dev > 0:
            rows.append({"name": e.key[:90], "device_ms": dev / 1e3, "count": e.count,
                         "kind": kernel_kind(e.key)})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    by_kind = {}
    for r in rows:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["device_ms"] / horizon
    host = _host_launches(prof)
    admitted.append(_admissions(engine))
    admits = [b > a for a, b in zip(admitted, admitted[1:])]
    by_admission = {k: [n for n, a in zip(host, admits) if a == want]
                    for k, want in (("admitting", True), ("not_admitting", False))}
    replay_ms = sum(a.elapsed_time(b) for a, b in pairs)
    # every port kernel the wrappers counted, inside a graph or not, is in
    # the profile, as many times as they launched it
    ports = set(kernels.function_counts(dict.fromkeys(counts, 1)))
    profiled = {f: n for f, n in _function_records(records).items() if f in ports}
    counted = kernels.function_counts(counts)
    emit(phase, slots=horizon,
         device_busy_ms=busy if rows else "not measured",
         device_busy_ms_per_slot=busy / horizon if rows else "not measured",
         device_ms_per_slot_by_kind=by_kind,
         kernel_launches_per_slot=sum(r["count"] for r in rows) / horizon,
         host_launches_per_slot=sum(host) / horizon,
         host_launches_by_slot=host,
         host_launches_per_admitting_slot=(
             sum(by_admission["admitting"]) / len(by_admission["admitting"])
             if by_admission["admitting"] else None),
         host_launches_per_other_slot=(
             sum(by_admission["not_admitting"]) / len(by_admission["not_admitting"])
             if by_admission["not_admitting"] else None),
         admitting_slots=sum(admits), graph_replays=len(pairs),
         graph_replay_event_ms_per_slot=replay_ms / horizon,
         kernel_records=profiled, kernel_records_missing={
             f: counted.get(f, 0) - profiled.get(f, 0) for f in {*profiled, *counted}
             if counted.get(f, 0) != profiled.get(f, 0)},
         unprofiled_serve_ms=serve_s * 1e3,
         idle_share=(1 - busy / (serve_s * 1e3)) if rows else "not measured",
         top=rows[:14], attention=[r for r in rows if "attention" in r["name"]])
    if profiled != counted:
        raise AssertionError(f"{phase}: the profile holds {profiled} port kernels, the "
                             f"wrappers counted {counted}")


# the paths whose dispatches are one CUDA graph replay each, served eager and
# graphed side by side (graph_ab)
GRAPH_AB = (("serve", SERVE_ARGS), ("sync", SYNC_ARGS), ("paged", PAGED_ARGS),
            ("paged_sync", PAGED_SYNC_ARGS), ("ssm", SSM_ARGS), ("chunked", CHUNKED_ARGS),
            ("paged_chunked", PAGED_CHUNKED_ARGS), ("sampled", SAMPLED_ARGS),
            ("sampled_chunked", SAMPLED_CHUNKED_ARGS))
# every row's graphed host launches, in every slot of the window (each
# admits), must stay below this share of eager's: the admission, the decode
# and the mixed dispatch are one replay each where eager issues thousands
GRAPH_HOST_SHARE = 0.05
# the slots whose host launches graph_ab counts under the profiler: the
# first three, which admit (the decode was warmed up and captured before)
AB_WINDOW = (0, 2)


def _graphs_on(graph: bool):
    """Switch the decode graphs on or off (``DecodeGraph.enabled``); returns
    the function that switches them back on."""
    from repro_torch.runtime.graph import DecodeGraph

    DecodeGraph.enabled = graph
    return lambda: setattr(DecodeGraph, "enabled", True)


def _ab_serve(argv: list, graph: bool) -> dict:
    """One unprofiled launcher serve with the decode graphs on or off: ms
    per slot, the decode's warm-up and capture done before the clock
    starts; the trace columns, the finished requests' token streams and the
    launch counts (the warm-up's included)."""
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher

    args = launcher.build_parser().parse_args(argv)
    kernels.reset_launch_counts()
    engine, sched, src = launcher.build(args)
    restore = _graphs_on(graph)
    try:
        _warm(engine, args.sync_free, args.chunked)
        t0 = time.perf_counter()
        tr = launcher.run(args, engine, sched, src)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        restore()
    return {"ms_per_slot": (t2 - t0) / args.horizon * 1e3,
            "trace": {c: tr[c].tolist() for c in ("rate", "served", "backlog", "dispatches",
                                                  "occupancy", "syncs", "active")},
            "streams": {r.rid: list(r.generated) for r in engine.finished},
            "launches": kernels.launch_counts(), "graph_replays": engine.graph_replays,
            "prefill_replays": engine.prefill_replays,
            "graph_nodes": {m: g.launches for m, g in engine._graphs.items() if g.graph},
            "decode_dispatches": engine.decode_dispatches,
            "prefill_dispatches": engine.prefill_dispatches, "chunked": args.chunked}


def _ab_host_launches(argv: list, graph: bool) -> list:
    """Host launches of each slot in ``AB_WINDOW``, from a profile of that
    window of another identical serve."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve as launcher

    args = launcher.build_parser().parse_args(argv)
    engine, sched, src = launcher.build(args)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_slot(t):
        if t == AB_WINDOW[0]:
            prof.start()
        elif t == AB_WINDOW[1] + 1:
            torch.cuda.synchronize()
            prof.stop()
    _slot_marks(sched, on_slot)
    restore = _graphs_on(graph)
    try:
        torch.cuda.synchronize()
        launcher.run(args, engine, sched, src)
        torch.cuda.synchronize()
    finally:
        restore()
    return _host_launches(prof)


def graph_ab() -> dict:
    """Each captured path served eagerly and graphed in this one call: ms
    per slot, host launches per slot over ``AB_WINDOW``, and the two serves'
    trace columns, token streams (sampled ones too, bit for bit) and launch
    counts, which must be equal. The graphed serve replays once per
    dispatch, the admissions included, and issues fewer than
    ``GRAPH_HOST_SHARE`` of eager's host launches in every slot of the
    window."""
    out = {}
    for name, argv in GRAPH_AB:
        eager, graph = _ab_serve(argv, False), _ab_serve(argv, True)
        host = {"eager": _ab_host_launches(argv, False), "graph": _ab_host_launches(argv, True)}
        res = {"path": name,
               "eager_ms_per_slot": eager["ms_per_slot"],
               "graph_ms_per_slot": graph["ms_per_slot"],
               "window": list(AB_WINDOW),
               "eager_host_launches_by_slot": host["eager"],
               "graph_host_launches_by_slot": host["graph"],
               "eager_host_launches_per_slot": sum(host["eager"]) / len(host["eager"]),
               "graph_host_launches_per_slot": sum(host["graph"]) / len(host["graph"]),
               "traces_equal": eager["trace"] == graph["trace"],
               "streams_equal": eager["streams"] == graph["streams"],
               "streams": len(graph["streams"]),
               "launches_equal": eager["launches"] == graph["launches"],
               "graph_replays": graph["graph_replays"],
               "prefill_replays": graph["prefill_replays"], "graph_nodes": graph["graph_nodes"],
               "decode_dispatches": graph["decode_dispatches"],
               "prefill_dispatches": graph["prefill_dispatches"], "trace": graph["trace"]}
        emit("graph_ab", **res)
        out[name] = res
        if not (res["traces_equal"] and res["streams_equal"] and res["launches_equal"]
                and res["streams"] > 0):
            raise AssertionError(f"graph_ab {name}: the graphed serve left the eager one's "
                                 "trace, streams or launch counts")
        dispatches = graph["decode_dispatches"] + graph["prefill_dispatches"]
        if (eager["graph_replays"] or graph["graph_replays"] != dispatches
                or graph["prefill_replays"] != graph["prefill_dispatches"]):
            raise AssertionError(f"graph_ab {name}: {graph['graph_replays']} replays "
                                 f"({graph['prefill_replays']} of admissions) for "
                                 f"{graph['decode_dispatches']} decode and "
                                 f"{graph['prefill_dispatches']} admission dispatches")
        if len(host["eager"]) != len(host["graph"]) or any(
                g >= GRAPH_HOST_SHARE * e for g, e in zip(host["graph"], host["eager"])):
            raise AssertionError(f"graph_ab {name}: host launches {host['graph']} are not "
                                 f"below {GRAPH_HOST_SHARE} of the eager serve's "
                                 f"{host['eager']}")
    return out


# the sampling phase: keys and bits over granite-3-2b's vocabulary for a
# spread of (seed, rid, age), and the sampler over a batch of rows
SAMPLING_V = 49155
SAMPLING_SEEDS = (0, 7, 2**31 + 5, 2**32 - 1)
SAMPLING_RIDS = (0, 1, 977, 2**31 - 1)
SAMPLING_AGES = (0, 1, 63, 4095)
# where two draws may part: the top-2 perturbed scores within SCORE_TIE, or
# the top-p boundary's cum - probs within BOUNDARY_TIE of top_p
SCORE_TIE, BOUNDARY_TIE = 1e-5, 1e-6


def _sampling_tables(rng, B, V):
    """A batch of B rows mixing the sampler's knobs: greedy rows (one with
    penalties), temperatures, top-k (beyond V too), top-p and the three
    penalties, over a random history; (tables, ages, gen)."""
    from repro_torch.runtime.sampling import SamplingParams, row_tables

    resolved = []
    for i in range(B):
        if i % 8 == 0:
            resolved.append(None)
            continue
        resolved.append((SamplingParams(
            temperature=float(rng.choice([0.0, 0.5, 0.8, 1.0, 1.3])),
            top_k=int(rng.choice([0, 1, 50, 1000, V + 7])),
            top_p=float(rng.choice([1.0, 0.95, 0.8, 0.5])),
            repetition_penalty=float(rng.choice([1.0, 1.1, 2.0])),
            presence_penalty=float(rng.choice([0.0, 0.4])),
            frequency_penalty=float(rng.choice([0.0, 0.2])),
            seed=int(rng.choice([7, 2**32 - 3]))), int(rng.integers(0, 2**31 - 1))))
    ages = rng.integers(0, 48, B).astype(np.int32)
    gen = rng.integers(0, V, (B, 64)).astype(np.int32)
    return row_tables(resolved, 7), ages, gen


def _sampling_ties(logits, samp, ages, gen) -> np.ndarray:
    """The rows (B,) bool where a token may rightly differ between two
    devices: the sampler's own steps on the CPU in float64 where a draw is
    decided, a row marked when its top-2 perturbed scores (penalized logits
    for a greedy row) lie within SCORE_TIE or its top-p boundary within
    BOUNDARY_TIE."""
    from repro_torch.runtime import sampling as S

    lg = S._penalize(logits.float(), samp, gen, torch.from_numpy(ages))
    greedy = samp.greedy.numpy()
    t = (lg / torch.clamp(samp.temp, min=S.GREEDY_TEMP)[:, None]).double()
    srt = torch.sort(t, dim=-1, descending=True, stable=True).values
    probs = torch.softmax(srt, dim=-1)
    below = (torch.cumsum(probs, dim=-1) - probs - samp.top_p.double()[:, None]).abs()
    boundary = (below.min(dim=-1).values < BOUNDARY_TIE).numpy() & (samp.top_p < 1).numpy()
    noise = S.threefry.gumbel(S.draw_keys(samp, torch.from_numpy(ages)), lg.shape[1])
    scores = torch.where(torch.from_numpy(greedy)[:, None], lg, noise + t.float())
    top2 = torch.topk(scores.double(), 2, dim=-1).values
    return boundary | ((top2[:, 0] - top2[:, 1]) < SCORE_TIE).numpy()


def check_sampling() -> dict:
    """Per-request sampling on the card against the same functions on the
    CPU: the threefry keys fold_in(fold_in(PRNGKey(seed), rid), age) and
    their random bits over the full vocabulary bit for bit, the Gumbel
    noise within 2 ulps of max(|g|, 1) (each log within an ulp), and
    ``sample_rows`` over logits of the full width: equal tokens but at the
    near-ties ``_sampling_ties`` marks. Device times of one draw at the
    serve's batch."""
    from repro_torch.runtime import sampling as S
    from repro_torch.runtime import threefry as tf

    grid = np.array([(s, r, a) for s in SAMPLING_SEEDS for r in SAMPLING_RIDS
                     for a in SAMPLING_AGES], np.int64).T
    out = {}
    for dev in ("cuda", "cpu"):
        seed, rid, age = (torch.from_numpy(x).to(dev) for x in grid)
        key = tf.fold_in(tf.fold_in(tf.seed(seed), rid), age)
        out[dev] = (key, tf.random_bits(key, SAMPLING_V), tf.gumbel(key, SAMPLING_V))
    keys_equal = all(torch.equal(a.cpu(), b) for a, b in zip(out["cuda"][0], out["cpu"][0]))
    bits_equal = torch.equal(out["cuda"][1].cpu(), out["cpu"][1])
    g_dev, g_cpu = out["cuda"][2].cpu().numpy(), out["cpu"][2].numpy()
    noise_ulps = float((np.abs(g_dev - g_cpu)
                        / np.spacing(np.maximum(np.abs(g_cpu), np.float32(1)))).max())

    rng = np.random.default_rng(11)
    B = 64
    samp, ages, gen = _sampling_tables(rng, B, SAMPLING_V)
    logits = torch.from_numpy((rng.standard_normal((B, SAMPLING_V)) * 4).astype(np.float32))
    cpu = S.sample_rows(logits, samp.to("cpu"), torch.from_numpy(ages), torch.from_numpy(gen),
                        torch.from_numpy(ages))
    dsamp = samp.to("cuda")
    dargs = (logits.cuda(), dsamp, torch.from_numpy(ages).cuda(), torch.from_numpy(gen).cuda(),
             torch.from_numpy(ages).cuda())
    card = S.sample_rows(*dargs).cpu()
    ties = _sampling_ties(logits, samp.to("cpu"), ages, torch.from_numpy(gen))
    differ = (card != cpu).numpy()
    b8 = tuple(a[:8] if isinstance(a, torch.Tensor) else S.RowSampling(*(t[:8] for t in a))
               for a in dargs)
    res = {"V": SAMPLING_V, "keys": int(grid.shape[1]), "keys_equal": keys_equal,
           "bits_equal": bits_equal, "noise_max_ulps_of_max_abs_1": noise_ulps,
           "rows": B, "tokens_equal": int((~differ).sum()), "near_ties": int(ties.sum()),
           "differ_off_ties": int((differ & ~ties).sum()),
           "sample_rows_device_ms_B8": _device_ms(lambda: S.sample_rows(*b8)),
           "random_bits_device_ms_B8": _device_ms(
               lambda: tf.gumbel(S.draw_keys(b8[1], b8[2]), SAMPLING_V))}
    emit("sampling", **res)
    if not (keys_equal and bits_equal) or noise_ulps > 2.0 or res["differ_off_ties"]:
        raise AssertionError(f"sampling: the card's draws left the CPU's: {res}")
    return res


FIG2_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "fig2_golden.npz"


def check_fig2() -> dict:
    """The paper's Fig. 2 on the card (``repro_torch.core.trace``): the
    fixture's shared service trace replayed through all four curves must
    give its backlog and rate bit for bit on every slot; the port's own
    ``fig2_experiment`` (its own seeded trace, drawn on the CPU and moved)
    must meet the reference's claims (tests/test_fig2.py), with a bounded
    queue that drops under fixed f = 10 and never under the controller.
    Rollouts run eagerly, slot by slot: ms per curve."""
    from repro_torch.core.trace import (CURVES, Fig2Config, fig2_experiment,
                                        make_service_trace, rollout_controller, rollout_fixed,
                                        summarize)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    golden = dict(np.load(FIG2_FIXTURE))
    cfg = Fig2Config()
    mus = torch.from_numpy(golden["service"]).cuda()
    run = {"fixed_10": lambda: rollout_fixed(mus, cfg.f_max, cfg.capacity),
           "V_high": lambda: rollout_controller(mus, cfg.V_high, cfg),
           "V_low": lambda: rollout_controller(mus, cfg.V_low, cfg),
           "fixed_1": lambda: rollout_fixed(mus, 1.0, cfg.capacity)}
    ms, departed = {}, {}
    for name in CURVES:
        tr, ms[name] = timed(run[name])
        for col in ("backlog", "rate"):
            got = tr[col].cpu().numpy()
            departed[f"{name}.{col}"] = int((got != golden[f"{name}.{col}"]).sum())
    own, own_ms = timed(lambda: fig2_experiment(cfg))
    s = summarize(own)
    bounded = Fig2Config(capacity=150.0)
    capped, capped_ms = timed(lambda: fig2_experiment(bounded))
    b = {k: own[k]["backlog"] for k in CURVES}
    third, half = cfg.horizon // 3, cfg.horizon // 2
    claims = {
        "service_mean_below_threshold": 9.0 < float(own["service"].mean()) < 10.0,
        "fixed_10_overflows": float(b["fixed_10"][-1]) > 500.0 and float(
            b["fixed_10"][-third:].mean()) > 1.3 * float(b["fixed_10"][third:2 * third].mean()),
        "controller_stabilizes_both_V": all(
            float(b[k].max()) < 200.0 and float(b[k][-500:].mean())
            < 3.0 * float(b[k][half:half + 500].mean()) + 5.0 for k in ("V_high", "V_low")),
        "backlog_ordering_O_of_V":
            s["V_high"]["tail_mean_backlog"] > s["V_low"]["tail_mean_backlog"],
        "utility_ordering_O_of_1_over_V": s["V_high"]["mean_rate"] > s["V_low"]["mean_rate"]
            > s["fixed_1"]["mean_rate"],
        "fixed_1_stable_lowest_utility": s["fixed_1"]["tail_mean_backlog"] <= 1.5 and all(
            s[k]["mean_rate"] > s["fixed_1"]["mean_rate"] for k in ("V_high", "V_low",
                                                                    "fixed_10")),
        "bounded_queue_drops_only_fixed_10":
            float(capped["fixed_10"]["final"].dropped) > 0.0
            and float(rollout_controller(capped["service"], bounded.V_high, bounded,
                                         capacity=150.0)["final"].dropped) == 0.0
            and float(rollout_controller(capped["service"], bounded.V_low, bounded,
                                         capacity=150.0)["final"].dropped) == 0.0,
        "same_trace_as_the_cpu": torch.equal(own["service"].cpu(),
                                             make_service_trace(cfg, device="cpu")),
    }
    res = {"fixture_slots": cfg.horizon, "departed_slots": departed, "ms_per_curve": ms,
           "fig2_experiment_ms": own_ms, "bounded_fig2_experiment_ms": capped_ms,
           "summary": s, "claims": claims}
    emit("fig2", **res)
    if any(departed.values()) or not all(claims.values()):
        raise AssertionError(f"fig2: departed {departed}, claims {claims}")
    return res


_FLASH_SYMBOL = re.compile(r"flash_attention_kernel(_wgmma)?I(f|13__nv_bfloat16)?"
                           r"(a|f|13__nv_fp8_e4m3|13__nv_bfloat16)Li(\d+)E")
_CXX_TYPE = {"a": "int8", "f": "float32", "13__nv_fp8_e4m3": "fp8", "13__nv_bfloat16": "bf16"}


def flash_instantiations(ptxas: list) -> list:
    """Each instantiation of csrc/flash_attention.cu's two kernels, from
    ``-Xptxas -v`` (build.BUILD_INFO): q and K/V types, hd, route,
    registers and spill bytes."""
    out = []
    for f in ptxas:
        m = _FLASH_SYMBOL.search(f["function"])
        if m is None:
            continue
        wgmma = m.group(1) is not None
        out.append({"q": "bf16" if wgmma else "float32", "kv": _CXX_TYPE[m.group(3)],
                    "hd": int(m.group(4)),
                    "route": KERNEL_ROUTE[torch.bfloat16 if wgmma else torch.float32],
                    "registers": f.get("registers"), "spill_stores": f.get("spill_stores"),
                    "spill_loads": f.get("spill_loads")})
    return sorted(out, key=lambda r: (r["q"], r["kv"], r["hd"]))


_CHUNK_SYMBOL = re.compile(r"(paged_)?chunk_attention_kernel(_wgmma)?I(f)?(a|13__nv_fp8_e4m3)?"
                           r"Li(\d+)E(?:Lb([01])E)?")


def chunk_instantiations(ptxas: list) -> list:
    """Each instantiation of the chunk attention kernels (K4 in
    csrc/chunk_attention.cu; K4p and K4q in csrc/paged_chunk_attention.cu),
    from ``-Xptxas -v``: kernel, q and code types, hd, route, dynamic shared
    memory (K4p's bf16 kernel over a native pool and over one with codes),
    registers and spill bytes."""
    from repro_torch.kernels import chunk_attention as kc
    from repro_torch.kernels import paged_chunk_attention as kpc

    out = []
    for f in ptxas:
        m = _CHUNK_SYMBOL.search(f["function"])
        if m is None:
            continue
        dtype = torch.bfloat16 if m.group(2) else torch.float32
        hd = int(m.group(5))
        row = {"kernel": "K4" if m.group(1) is None else "K4p" if m.group(6) == "1" else "K4q",
               "q": str(dtype).removeprefix("torch."), "hd": hd, "route": KERNEL_ROUTE[dtype]}
        if m.group(1) is None:
            row["smem_bytes"] = kc.smem_bytes(hd, dtype)
        else:
            row["codes"] = _CXX_TYPE[m.group(4)]
            row["smem_bytes"] = kpc.smem_bytes(hd, dtype, quantized=True)
            if row["kernel"] == "K4p" and dtype == torch.bfloat16:
                row["smem_bytes_native_pool"] = kpc.smem_bytes(hd, dtype)
        out.append({**row, "registers": f.get("registers"),
                    "spill_stores": f.get("spill_stores"), "spill_loads": f.get("spill_loads")})
    return sorted(out, key=lambda r: (r["kernel"], r["q"], r.get("codes", ""), r["hd"]))


_SSD_SYMBOL = re.compile(r"(ssd_scan_kernel|ssd_chunk_states_kernel|ssd_state_passing_kernel|"
                         r"ssd_chunk_outputs_kernel)(?:I(?:f|Li(\d+)E))?")


def ssd_instantiations(ptxas: list) -> list:
    """Each kernel of csrc/ssd_scan.cu from ``-Xptxas -v``: K6's f32
    CUDA-core kernel and the bf16 route's three (the outputs kernel per
    count of 64-row tiles in a chunk), with the route, the dynamic shared
    memory at the serve's shape (chunk 128, P 64, N 128; the outputs kernel
    at its own tile count's chunk), registers and spill bytes."""
    from repro_torch.kernels import ssd_scan as kssd

    out = []
    for f in ptxas:
        m = _SSD_SYMBOL.search(f["function"])
        if m is None:
            continue
        name = m.group(1)
        f32 = name == "ssd_scan_kernel"
        row = {"kernel": name, "route": KERNEL_ROUTE[torch.float32 if f32 else torch.bfloat16]}
        if m.group(2):
            row["chunk_tiles"] = int(m.group(2))
        chunk = 64 * row.get("chunk_tiles", 2)
        smem = kssd.smem_bytes(chunk, 64, 128, torch.float32 if f32 else torch.bfloat16)
        if name in smem:
            row["smem_bytes"] = smem[name]
            row["smem_at"] = {"chunk": chunk, "P": 64, "N": 128}
        out.append({**row, "registers": f.get("registers"),
                    "spill_stores": f.get("spill_stores"), "spill_loads": f.get("spill_loads")})
    return sorted(out, key=lambda r: (r["kernel"], r.get("chunk_tiles", 0)))


_DECODE_SYMBOL = re.compile(r"(paged_)?decode_attention(_quant)?_kernelI(f|13__nv_bfloat16)"
                            r"(a|13__nv_fp8_e4m3)?Li(\d+)E")


def resident_ctas(threads: int, registers: int, smem: int) -> int:
    """CTAs of ``threads`` threads that one H100 SM holds at once, by its
    65,536 registers (allocated to a warp in units of 256), its 233,472
    bytes of shared memory (1,024 reserved a CTA), its 2,048 threads and
    its 32 CTAs."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    return min(65536 // (warps * per_warp), 233472 // (smem + 1024), 2048 // threads, 32)


def decode_instantiations(ptxas: list) -> list:
    """Each instantiation of K2 (csrc/decode_attention.cu), K3
    (csrc/paged_attention.cu), K2q (csrc/decode_attention_quant.cu) and K3q
    (csrc/paged_attention_quant.cu), all csrc/decode_core.cuh, from
    ``-Xptxas -v``: kernel, dtype, code type, hd, the dynamic shared memory
    of one CTA at G 4 (128 threads), registers, spill bytes and the CTAs an
    SM holds at once (``resident_ctas``)."""
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import paged_attention as kp
    from repro_torch.kernels import paged_attention_quant as kpq

    smem = {("K2", False): kd.smem_bytes, ("K3", False): kp.smem_bytes,
            ("K2q", True): kd.quant_smem_bytes, ("K3q", True): kpq.smem_bytes}
    out = []
    for f in ptxas:
        m = _DECODE_SYMBOL.search(f["function"])
        if m is None:
            continue
        dtype = torch.float32 if m.group(3) == "f" else torch.bfloat16
        hd, quant = int(m.group(5)), m.group(2) is not None
        kernel = ("K3" if m.group(1) else "K2") + ("q" if quant else "")
        row = {"kernel": kernel, "dtype": str(dtype).removeprefix("torch."), "hd": hd,
               "smem_bytes_G4": smem[kernel, quant](hd, 4, dtype),
               "registers": f.get("registers"), "spill_stores": f.get("spill_stores"),
               "spill_loads": f.get("spill_loads")}
        if quant:
            row["codes"] = _CXX_TYPE[m.group(4)]
        row["resident_ctas_per_sm_G4"] = resident_ctas(128, row["registers"],
                                                       row["smem_bytes_G4"])
        out.append(row)
    return sorted(out, key=lambda r: (r["kernel"], r["dtype"], r.get("codes", ""), r["hd"]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls (the default)
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build()
    from repro_torch.kernels import chunk_attention as kc
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import paged_attention as kp
    from repro_torch.kernels import paged_attention_quant as kpq
    from repro_torch.kernels import paged_chunk_attention as kpc
    from repro_torch.kernels import ssd_scan as kssd
    emit("build", wall_s=time.perf_counter() - t0, sources=info,
         dynamic_smem_bytes={"flash_attention_hd64_f32_cuda_cores":
                                 kf.smem_bytes(64, torch.float32),
                             "flash_attention_hd64_bf16_wgmma": kf.smem_bytes(64, torch.bfloat16),
                             "flash_attention_quant_hd64_f32_cuda_cores":
                                 kf.smem_bytes(64, torch.float32, quantized=True),
                             "flash_attention_quant_hd64_bf16_wgmma":
                                 kf.smem_bytes(64, torch.bfloat16, quantized=True),
                             "decode_attention_hd64_G4_bf16": kd.smem_bytes(64, 4),
                             "decode_attention_quant_hd64_G4_bf16": kd.quant_smem_bytes(64, 4),
                             "paged_decode_attention_hd64_G4_bf16": kp.smem_bytes(64, 4),
                             "paged_decode_attention_quant_hd64_G4_bf16": kpq.smem_bytes(64, 4),
                             "chunk_attention_hd64_f32_cuda_cores":
                                 kc.smem_bytes(64, torch.float32),
                             "chunk_attention_hd64_bf16_wgmma": kc.smem_bytes(64, torch.bfloat16),
                             "paged_chunk_attention_hd64_f32_cuda_cores":
                                 kpc.smem_bytes(64, torch.float32),
                             "paged_chunk_attention_hd64_bf16_wgmma_native_pool":
                                 kpc.smem_bytes(64, torch.bfloat16),
                             "paged_chunk_attention_hd64_bf16_wgmma_codes":
                                 kpc.smem_bytes(64, torch.bfloat16, quantized=True),
                             "ssd_scan_f32_chunk128_P64_N128":
                                 kssd.smem_bytes(128, 64, 128, torch.float32),
                             "ssd_scan_bf16_chunk128_P64_N128":
                                 kssd.smem_bytes(128, 64, 128, torch.bfloat16)},
         flash_attention_instantiations=flash_instantiations(info["flash_attention"]["ptxas"]),
         chunk_attention_instantiations=chunk_instantiations(
             info["chunk_attention"]["ptxas"] + info["paged_chunk_attention"]["ptxas"]),
         ssd_scan_instantiations=ssd_instantiations(info["ssd_scan"]["ptxas"]),
         decode_instantiations=decode_instantiations(
             [f for n in ("decode_attention", "paged_attention", "decode_attention_quant",
                          "paged_attention_quant") for f in info[n]["ptxas"]]))

    timer = Timer()
    rows = check_kernels(timer)
    del timer
    check_model()
    check_paged_model()
    check_preemption()
    check_chunk_model()
    check_quant_model()
    check_dense_quant_model()
    check_paged_chunk_model()
    check_ssm_model()
    main_path = drive_main_path(SERVE_ARGS)
    profile_main_path(SERVE_ARGS, main_path["serve_s"])
    paged_path = drive_main_path(PAGED_ARGS, "paged_serve", PAGED_KERNELS)
    profile_main_path(PAGED_ARGS, paged_path["serve_s"], "paged_profile")
    sync_path = drive_main_path(SYNC_ARGS, "sync_serve", SYNC_KERNELS)
    profile_main_path(SYNC_ARGS, sync_path["serve_s"], "sync_profile")
    chunked_path = drive_main_path(CHUNKED_ARGS, "chunked_serve", CHUNKED_KERNELS)
    profile_main_path(CHUNKED_ARGS, chunked_path["serve_s"], "chunked_profile")
    quant_path = drive_main_path(QUANT_ARGS, "quant_serve", QUANT_KERNELS)
    profile_main_path(QUANT_ARGS, quant_path["serve_s"], "quant_profile")
    ssm_path = drive_main_path(SSM_ARGS, "ssm_serve", SSM_KERNELS)
    profile_main_path(SSM_ARGS, ssm_path["serve_s"], "ssm_profile")
    ssm_sync = drive_main_path(SSM_SYNC_ARGS, "ssm_sync_serve", SSM_KERNELS)
    profile_main_path(SSM_SYNC_ARGS, ssm_sync["serve_s"], "ssm_sync_profile")
    paged_sync = drive_main_path(PAGED_SYNC_ARGS, "paged_sync_serve", PAGED_SYNC_KERNELS)
    profile_main_path(PAGED_SYNC_ARGS, paged_sync["serve_s"], "paged_sync_profile")
    paged_chunked = drive_main_path(PAGED_CHUNKED_ARGS, "paged_chunked_serve",
                                    PAGED_CHUNKED_KERNELS)
    profile_main_path(PAGED_CHUNKED_ARGS, paged_chunked["serve_s"], "paged_chunked_profile")
    prefix = drive_prefix_serve()
    profile_main_path([], prefix["serve_s"], "prefix_profile", prefix=True)
    dense_quant = drive_main_path(DENSE_QUANT_ARGS, "dense_quant_serve", DENSE_QUANT_KERNELS)
    profile_main_path(DENSE_QUANT_ARGS, dense_quant["serve_s"], "dense_quant_profile")
    drive_main_path(DENSE_QUANT_CHUNKED_ARGS, "dense_quant_chunked_serve",
                    DENSE_QUANT_CHUNKED_KERNELS)
    check_sampling()
    sampled = drive_main_path(SAMPLED_ARGS, "sampled_serve", DENSE_KERNELS)
    profile_main_path(SAMPLED_ARGS, sampled["serve_s"], "sampled_profile")
    sampled_chunked = drive_main_path(SAMPLED_CHUNKED_ARGS, "sampled_chunked_serve",
                                      CHUNKED_KERNELS)
    profile_main_path(SAMPLED_CHUNKED_ARGS, sampled_chunked["serve_s"],
                      "sampled_chunked_profile")
    drive_fleet(FLEET_ARGS, "fleet_serve")
    drive_fleet(PAGED_FLEET_ARGS, "paged_fleet_serve", fail_at=PAGED_FLEET_FAIL_AT)
    drive_obs_serve(sync_path)
    drive_slo_serve()
    drive_chaos_shared_x2()
    graph_ab()
    check_fig2()

    # launches: each kernel's count from the run of the path it serves
    counts = {**main_path["launches"],
              "paged_decode_attention": paged_path["launches"]["paged_decode_attention"],
              "paged_decode_attention_quant":
                  quant_path["launches"]["paged_decode_attention_quant"],
              "chunk_attention": chunked_path["launches"]["chunk_attention"],
              **{k: ssm_path["launches"][k] for k in ("ssd_scan", *SSD_PHASES)},
              "paged_chunk_attention": paged_chunked["launches"]["paged_chunk_attention"],
              "paged_chunk_attention_quant": prefix["launches"]["paged_chunk_attention_quant"],
              # K1q/K1rq: no serve path attends quantized K/V at prefill (every
              # prefill attends its own native K/V, as the reference's does)
              "flash_attention_quant": dense_quant["launches"]["flash_attention_quant"],
              "flash_attention_quant_ragged":
                  dense_quant["launches"]["flash_attention_quant_ragged"],
              "decode_attention_quant": dense_quant["launches"]["decode_attention_quant"]}
    src = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:57"),
           "flash_attention_ragged": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                      "src/repro/kernels/flash_attention.py:118"),
           "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:32"),
           "paged_decode_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                      "src/repro/kernels/paged_attention.py:38"),
           "paged_decode_attention_quant": (
               "src/repro_torch/kernels/csrc/paged_attention_quant.cu",
               "src/repro/kernels/paged_attention.py:56"),
           "chunk_attention": ("src/repro_torch/kernels/csrc/chunk_attention.cu",
                               "src/repro/kernels/chunk_attention.py:48"),
           "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan.py:28"),
           # the bf16 K6's three kernels, each held to its plain phase (ssd_anatomy)
           **{k: ("src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:28")
              for k in SSD_PHASES},
           # K4p: no Pallas kernel; the reference's attn_chunk_paged gathers in XLA
           "paged_chunk_attention": ("src/repro_torch/kernels/csrc/paged_chunk_attention.cu",
                                     "src/repro/models/attention.py:731"),
           # K4p over quantized pages: K4q's dequantizing loads
           "paged_chunk_attention_quant": (
               "src/repro_torch/kernels/csrc/paged_chunk_attention.cu",
               "src/repro/kernels/chunk_attention.py:75"),
           "flash_attention_quant": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                     "src/repro/kernels/flash_attention.py:57"),
           "flash_attention_quant_ragged": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                            "src/repro/kernels/flash_attention.py:118"),
           # K2q: no Pallas kernel; the reference's attn_decode dequantizes the
           # ring in XLA
           "decode_attention_quant": ("src/repro_torch/kernels/csrc/decode_attention_quant.cu",
                                      "src/repro/models/attention.py:584")}
    line = [{"name": n, "route": "cuda", "source": src[n][0], "replaces": src[n][1],
             "launches": counts[n], "max_abs_err": rows[n]["max_abs_err"],
             "ms": rows[n]["ms"], "plain_ms": rows[n]["plain_ms"],
             "bound_ms": rows[n]["bound_ms"], "bound_by": rows[n]["bound_by"],
             "library_ms": rows[n]["library_ms"], "device_ms": rows[n]["device_ms"],
             "library_device_ms": rows[n]["library_device_ms"]} for n in src]
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
