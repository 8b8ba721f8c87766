"""Drive the port's main path on one NVIDIA H100 and hold every kernel of it
against its plain version. Exits nonzero on any fault; nothing is caught.

  python3 chip_smoke.py

Phases, each printing one JSON line: device, build (nvcc, all sources at
once), kernels (each CUDA kernel against its plain PyTorch version, element
by element, at the full-width granite-3-2b serving shapes in bf16 and in
f32 and at the smoke shapes in f32, with CUDA-event times, the roofline
bound and the time of the library's counterpart for the record: one
scaled_dot_product_attention call, or for the paged kernel a page gather
plus that call), model (full-width granite-3-2b prefill + greedy decode
through the kernels against the plain versions on the same weights, with a
path whose decode attention skips one KV tile read beside it to show the
tolerance catches such a fault, and the smoke model on the card against
the CPU path the CPU tests hold against the JAX package), paged_model (the
same prompts through the paged decode against the dense one, with a path
whose block table swaps two pages of one row beside it), preemption (a
full-width paged engine whose pool is too small for both of its rows to
grow, against the dense engine's tokens), chunk_model (full-width prompts
through chunk_step in chunks of 128, K4, against the one-shot ragged
prefill, K1r, then 16 decode steps, with a path whose chunk attention
sees only the chunk itself beside it), serve (the launcher's main path
at full width, with the kernels' launch counts), profile (device time by
kernel over an identical second serve run), then serve and profile again
for the paged path (``--paged --policy memory-aware``), the sync-free
path (``--sync-free``) and the chunked path (``--chunked --policy
token-aware``); every slot of the last two after the first runs under
``torch.cuda.set_sync_debug_mode("error")``, and the chunked trace is held
to the same launcher's on the CPU with the smoke model. The Mamba-2 path
(mamba2-130m at full width): the SSD scan kernel among the kernels (against
its plain version and, in f32, its sequential oracle), ssm_model (prefill
logits at positions around the chunk boundaries and 16 greedy decode steps
through the kernel against the plain scan, with a scan that drops the state
carried between chunks beside it, and the smoke model on the card against
the CPU path), then ssm_serve, ssm_profile, ssm_sync_serve and
ssm_sync_profile (the fused and the sync-free loops, their traces held to
the CPU run's). Each serve phase zeroes the launch counts just before it
and reads them just after. Then the ``kernels`` summary line, the card's
name and power limit from nvidia-smi, and the result line.
"""
from __future__ import annotations

import json
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
# max |kernel-path logit - plain-path logit| of the full-width mamba2-130m
# check (prefill logits around the chunk boundaries and 16 decode steps):
# 1.5x the largest reading (0.098 at logit scale 3.16, PERF.md). The kernel
# keeps the scan's weights and carried-state term in f32 where the plain
# version rounds them to bf16, and 24 layers carry that forward. The scan
# that drops the state carried between chunks lands 0.18-0.27 away at the
# steps after each chunk boundary.
SSM_MODEL_TOL = 0.15


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def _ring_slot_pos(B, L, pos):
    """slot i holds the latest position p <= pos with p % L == i (-1: none)."""
    i = np.arange(L)[None, :]
    p = pos[:, None]
    sp = np.where(i <= p % L, p - p % L + i, p - p % L - L + i)
    return np.where(sp < 0, -1, sp).astype(np.int32)


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
               library="scaled_dot_product_attention", rtol=KERNEL_RTOL):
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
               "bytes": work[0], "flops": work[1]}
        emit("kernels", **row)
        if not worst <= 1.0:
            raise AssertionError(f"{case}: an element is {worst:.3g}x its tolerance")
        if main:
            rows[name] = row

    def sdpa_prefill(q, k, v, lens, window, causal_only):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if causal_only:
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True)
        S = q.shape[1]
        qp = torch.arange(S, device="cuda")[:, None]
        kp = torch.arange(S, device="cuda")[None, :]
        mask = (kp <= qp)[None]
        if window is not None:
            mask = mask & (kp > qp - window)[None]
        if lens is not None:
            mask = mask & (kp[None] < lens[:, None, None])
        mask = mask[:, None]
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

    # K1 / K1r: (B, S, H, KVH, hd, dtype, main-path shape and dtype?). The
    # f32 run of the main-path shape holds the cross-tile rescale and the
    # tile skips to 2e-5.
    for B, S, H, KVH, hd, dtype, main in ((8, 512, 32, 8, 64, torch.bfloat16, True),
                                          (8, 512, 32, 8, 64, torch.float32, False),
                                          (4, 16, 8, 2, 32, torch.float32, False)):
        q = randn((B, S, H, hd), dtype)
        k, v = randn((B, S, KVH, hd), dtype), randn((B, S, KVH, hd), dtype)
        lens_l = ([512, 300, 129, 1, 512, 64, 200, 511] if S == 512 else [16, 1, 9, 5])
        lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
        esize = q.element_size()
        for name, sl, win in (("flash_attention", None, None),
                              ("flash_attention_ragged", lens, None),
                              ("flash_attention", None, 37 if S == 512 else 5)):
            case = f"{name} B{B} S{S} H{H}/{KVH} hd{hd} {str(dtype)[6:]}" + (
                f" window{win}" if win else "")
            fn = lambda sl=sl, win=win: kf.flash_attention(q, k, v, sl, window=win)
            plain = lambda sl=sl, win=win: ref.attention_ref(q, k, v, window=win, seq_lens=sl)
            env = ref.attention_ref(q, k, v.abs(), window=win, seq_lens=sl)
            record(case, name, dtype, fn(), plain(), env, fn, plain,
                   sdpa_prefill(q, k, v, sl, win, sl is None and win is None),
                   _prefill_work(B, S, H, KVH, hd, esize, lens_l if sl is not None else None, win),
                   main and win is None)

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
                   main and win is None)

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
               _chunk_work(H, KVH, hd, q.element_size(), C, sp_np, p0_np, nv_np), main)
    check_quant_kernel(rng, record)
    check_ssd_kernel(record)
    return rows


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
    bf16 case is the quantized serve's and goes into the ``kernels`` line."""
    from repro_torch.cache import parse_kv_precision
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
            torch.cuda.synchronize()
            if got[~has].any():
                raise AssertionError(f"{case}: a row with no valid slot is not zeros")
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
                           "scaled_dot_product_attention")


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


# --------------------------------------------------------------- model
def _attention_impls():
    """Stand-ins for ``repro_torch.kernels.ops`` that the model's attention
    calls: the plain versions, and a deliberately faulty decode that skips
    one KV tile (slots 64-127), as a kernel with a wrong tile loop would."""
    from types import SimpleNamespace

    from repro_torch.kernels import ref

    def flash(q, k, v, seq_lens=None, *, causal, window):
        return ref.attention_ref(q, k, v, causal=causal, window=window, seq_lens=seq_lens)

    def decode(q, k, v, slot_pos, pos, *, window):
        return ref.decode_attention_ref(q, k, v, slot_pos, pos, window=window)

    def decode_skipping_a_tile(q, k, v, slot_pos, pos, *, window):
        sp = slot_pos.clone()
        sp[:, 64:128] = -1
        return ref.decode_attention_ref(q, k, v, sp, pos, window=window)

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
    pages in shuffled order), 16 steps; logits within MODEL_TOL. Beside it
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
                                   torch.from_numpy(p0_np == 0).cuda(),
                                   A.chunk_write_targets(p0_np, valid_np, L, "cuda"))
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


def _sync_checked(sched) -> None:
    """Run every control slot after the first under
    ``set_sync_debug_mode("error")``: any call that synchronizes the
    stream raises. The first slot is exempt (``control_async`` seeds its
    pipeline there); the mode is switched on as the second slot's control
    starts and stays on through the serve's ``drain``."""
    control, calls = sched.control_async, [0]

    def checked(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            torch.cuda.set_sync_debug_mode("error")
        return control(*a, **kw)
    sched.control_async = checked


def _watch_precision(sched, engine) -> list:
    """Record, each slot, the admission precision the scheduler picks and,
    once the slot's admissions are in, the quantized region's used pages
    and the regions of the rows the decode runs."""
    log, ask, ensure = [], sched.admit_precision, engine._ensure_pages

    def watched(occupancy):
        log.append({"chosen": ask(occupancy)})
        return log[-1]["chosen"]

    def ensure_watched(n_steps):
        ensure(n_steps)
        alloc = engine.allocator
        log[-1].update(quant_used_pages=alloc.stats().quant_used_pages,
                       regions=sorted({alloc.precision_of(r) for r in alloc.holders()}))
    sched.admit_precision = watched
    engine._ensure_pages = ensure_watched
    return log


def _count_mixed(engine) -> list:
    """Count the engine's mixed (chunk + decode) dispatches."""
    mixed, run = [0], engine._chunk_decode_sync

    def counted(plan, n_steps):
        mixed[0] += 1
        return run(plan, n_steps)
    engine._chunk_decode_sync = counted
    return mixed


def drive_main_path(argv: list, phase: str = "serve", path_kernels=DENSE_KERNELS) -> dict:
    """One of the launcher's paths: build (the dense engine's boot prefill
    runs K1, or K6 on a Mamba-2 stack) and serve. The launch counts are
    zeroed just before the build and read just after the serve; every
    kernel of the path must have launched. The sync-free and chunked paths
    run under the sync debug mode after their first slot
    (``_sync_checked``); the chunked, quantized and Mamba-2 traces are held
    to the same launcher's on the CPU (``cpu_trace``)."""
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher

    args = launcher.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    engine, sched, src = launcher.build(args)
    torch.cuda.synchronize()
    asynchronous = args.sync_free or args.chunked
    if asynchronous:
        _sync_checked(sched)
    mixed = _count_mixed(engine) if args.chunked else [0]
    watch = args.policy == "precision-aware"
    precision = _watch_precision(sched, engine) if watch else []
    t1 = time.perf_counter()
    try:
        tr = launcher.run(args, engine, sched, src)
        if asynchronous:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()   # the last slot's work, before the clock stops
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    res = {"summary": launcher.summary(args, tr, sched), "build_s": t1 - t0,
           "serve_s": t2 - t1, "ms_per_slot": (t2 - t1) / args.horizon * 1e3,
           "launches": counts, "served": int(tr["served"].sum()),
           "dispatches_per_slot": float(tr["dispatches"].mean()),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "counters": engine.counters(), "syncs": tr["syncs"].tolist(),
           "trace": {c: tr[c].tolist() for c in ("rate", "served", "backlog", "dispatches")}}
    if args.paged:
        res.update(paged=launcher.paged_summary(tr, engine),
                   peak_occupancy=float(tr["occupancy"].max()),
                   occupancy=tr["occupancy"].tolist())
    if args.chunked:
        res["mixed_dispatches"] = mixed[0]
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
    n_layers = engine.cfg.n_layers
    ssm = engine.cfg.is_ssm
    want = {}
    if ssm:   # every prefill (the boot's too) runs the scan once per layer
        want = {"ssd_scan": n_layers * (engine.prefill_dispatches + 1)}
    elif args.paged:
        decode = ("paged_decode_attention_quant" if args.kv_precision in ("int8", "fp8")
                  else "paged_decode_attention")
        want = {"flash_attention_ragged": n_layers * engine.prefill_dispatches,
                decode: n_layers * engine.decode_dispatches * 2}
    elif asynchronous:
        want = {"flash_attention_ragged": n_layers * engine.prefill_dispatches,
                "decode_attention": n_layers * engine.decode_dispatches * 2,
                "chunk_attention": n_layers * mixed[0]}
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
    if args.chunked or watch or ssm:
        res["trace"]["occupancy"] = tr["occupancy"].tolist()
        cpu = cpu_trace(argv)
        if cpu != res["trace"]:
            raise AssertionError(f"{phase}: the trace {res['trace']} is not the CPU run's {cpu}")
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
KERNEL_KINDS = (("K6", ("ssd_scan_kernel",)),
                ("K3q", ("paged_decode_attention_quant_kernel",)),
                ("K3", ("paged_decode_attention_kernel",)),
                ("K2", ("decode_attention_kernel",)),
                ("K1/K1r", ("flash_attention_kernel",)),
                ("K4", ("chunk_attention_kernel",)),
                ("matmuls", ("nvjet", "gemm", "cutlass", "xmma")))


def kernel_kind(name: str) -> str:
    """The kind of a profiled kernel: an attention kernel of the port, a
    matmul, or other (elementwise, copy, index, reduction)."""
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def profile_main_path(argv: list, serve_s: float, phase: str = "profile") -> None:
    """Device time by kernel over a second, identical serve run (same seeds,
    same work). The profiler slows the host, so the device's idle share is
    taken against the unprofiled run's serve time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve as launcher

    args = launcher.build_parser().parse_args(argv)
    engine, sched, src = launcher.build(args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        launcher.run(args, engine, sched, src)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue   # kernels only: an op's device time is its kernels'
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
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + r["device_ms"] / args.horizon
    emit(phase, slots=args.horizon, device_busy_ms=busy,
         device_busy_ms_per_slot=busy / args.horizon, device_ms_per_slot_by_kind=by_kind,
         kernel_launches_per_slot=sum(r["count"] for r in rows) / args.horizon,
         unprofiled_serve_ms=serve_s * 1e3,
         idle_share=(1 - busy / (serve_s * 1e3)) if rows else "not measured",
         top=rows[:14], attention=[r for r in rows if "attention_kernel" in r["name"]])


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
    from repro_torch.kernels import ssd_scan as kssd
    emit("build", wall_s=time.perf_counter() - t0, sources=info,
         dynamic_smem_bytes={"flash_attention_hd64": kf.smem_bytes(64),
                             "decode_attention_hd64_G4": kd.smem_bytes(64, 4),
                             "paged_decode_attention_hd64_G4": kp.smem_bytes(64, 4),
                             "paged_decode_attention_quant_hd64_G4": kpq.smem_bytes(64, 4),
                             "chunk_attention_hd64": kc.smem_bytes(64),
                             "ssd_scan_chunk128_P64_N128": kssd.smem_bytes(128, 64, 128)})

    timer = Timer()
    rows = check_kernels(timer)
    del timer
    check_model()
    check_paged_model()
    check_preemption()
    check_chunk_model()
    check_quant_model()
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

    # launches: each kernel's count from the run of the path it serves
    counts = {**main_path["launches"],
              "paged_decode_attention": paged_path["launches"]["paged_decode_attention"],
              "paged_decode_attention_quant":
                  quant_path["launches"]["paged_decode_attention_quant"],
              "chunk_attention": chunked_path["launches"]["chunk_attention"],
              "ssd_scan": ssm_path["launches"]["ssd_scan"]}
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
                        "src/repro/kernels/ssd_scan.py:28")}
    line = [{"name": n, "route": "cuda", "source": src[n][0], "replaces": src[n][1],
             "launches": counts[n], "max_abs_err": rows[n]["max_abs_err"],
             "ms": rows[n]["ms"], "plain_ms": rows[n]["plain_ms"],
             "bound_ms": rows[n]["bound_ms"], "bound_by": rows[n]["bound_by"],
             "library_ms": rows[n]["library_ms"]} for n in src]
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
