"""Continuous-batching inference engine (dense ring caches, greedy).

Fixed decode slots (batch dimension B). Each slot holds one in-flight
request's KV cache row. Per control slot (``step_slot``):

  1. batched admission: pop up to k pending requests for the k free slots,
     run ONE bucketed prefill of the whole batch (pad rows fill it), and
     splice the k new cache rows into the batch cache with one scatter,
  2. fused decode: ``n_steps`` greedy decode steps over all B slots in one
     Python call (inactive slots compute but are masked out on the host),
     returning per-step tokens so the host can attribute service mu(t) to
     individual steps,
  3. retire finished requests (max_new_tokens reached or EOS).

So one control slot costs <= 1 prefill + 1 decode dispatch
(``prefill_dispatches`` / ``decode_dispatches``); the legacy per-step path
(``step``) costs k prefills + one decode per call. ``blocking_syncs``
counts the synchronous device-to-host readbacks that gate the next
dispatch, exactly where the reference counts them. The fused decode is one
dispatch in the count; a CUDA-graph capture of it is later work.

Admission buckets prompts into power-of-two sub-buckets (P/4, P/2, P) of
``prompt_len`` and passes per-row real lengths to the length-aware prefill:
logits come from each row's real last token, decode resumes at pos = len,
and cache slots beyond len stay empty. Every arch the port runs is a dense
attention stack, which the length-aware prefill covers, so admission is
always ragged; only the boot prefill is padded.

The engine updates its decode state in place: the splices and the decode
steps write into the cache tensors of ``self.state``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.runtime.request import Request

# Sentinel for short-prompt padding (identical across requests).
PAD_ID = 0


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 8
    prompt_len: int = 32
    cache_len: int = 128
    greedy: bool = True           # the port serves greedy only
    shape_window: Optional[int] = None
    eos_id: Optional[int] = None  # stop token (None = length-only stopping)
    kv_precision: str = ""        # "" / "native" only


def _bucket_prompt(tokens, prompt_len: int) -> tuple[np.ndarray, bool]:
    """Fit a prompt to the fixed prefill bucket.

    Long prompts are truncated (flagged, so the caller can record it on the
    Request); short prompts are padded with the PAD_ID sentinel.
    """
    toks = np.asarray(tokens[:prompt_len], np.int32)
    truncated = len(tokens) > prompt_len
    if len(toks) < prompt_len:
        toks = np.concatenate(
            [toks, np.full(prompt_len - len(toks), PAD_ID, np.int32)]
        )
    return toks, truncated


def _prompt_buckets(P: int, quantum: int = 1) -> list:
    """Power-of-two prompt sub-buckets {P/4, P/2, P}, rounded up to the
    engine's placement quantum."""
    out = set()
    for b in (P // 4, P // 2, P):
        b = -(-max(b, 1) // quantum) * quantum
        if 0 < b <= P:
            out.add(b)
    return sorted(out) or [P]


def _decode_one(model, state, toks, shape_window):
    logits, state = M.decode_step(model, state, toks, shape_window=shape_window)
    return torch.argmax(logits, dim=-1).to(torch.int32), state


def _decode_n(model, state, toks, n, shape_window):
    """n fused greedy decode steps; returns per-step tokens (n, B)."""
    outs = []
    for _ in range(n):
        toks, state = _decode_one(model, state, toks, shape_window)
        outs.append(toks)
    return torch.stack(outs), state


def _splice_one(state: M.DecodeState, one: M.DecodeState, slot: int) -> M.DecodeState:
    """Insert batch-1 prefill state into the batch state at ``slot``, in place."""
    for big, new in zip(state.caches, one.caches, strict=True):
        for a, b in zip(big, new, strict=True):
            a[:, slot] = b[:, 0]
    state.pos[slot] = one.pos[0]
    state.last_tok[slot] = one.last_tok[0]
    return state


def _splice_many(state: M.DecodeState, new: M.DecodeState,
                 slots: np.ndarray) -> M.DecodeState:
    """Insert prefill rows at the given slot indices (one scatter per leaf),
    in place. Pad rows carry the out-of-range slot index B and are dropped,
    so the bucketed batch-B prefill can splice any k <= B rows."""
    B = state.pos.shape[0]
    rows = np.nonzero(slots < B)[0]
    dev = state.pos.device
    src = torch.as_tensor(rows, device=dev)
    dst = torch.as_tensor(slots[rows].astype(np.int64), device=dev)
    for big, nw in zip(state.caches, new.caches, strict=True):
        for a, b in zip(big, nw, strict=True):
            a[:, dst] = b[:, src]
    state.pos[dst] = new.pos[src]
    state.last_tok[dst] = new.last_tok[src]
    return state


def _host_take(row_toks, req: Request, age: int, n_steps: int,
               eos_id: Optional[int]) -> tuple[int, bool]:
    """How many of this slot's tokens a request consumes (budget- and
    EOS-limited) and whether it finished."""
    if eos_id is not None and req.generated and req.generated[-1] == eos_id:
        return 0, True  # finished at admission: first token was EOS
    limit = int(min(n_steps, req.max_new_tokens - age))
    if eos_id is not None:
        for j in range(limit):
            if int(row_toks[j]) == eos_id:
                return j + 1, True
    return limit, age + limit >= req.max_new_tokens


class Engine:
    """Dense serving engine over ``model`` (on the model's device)."""

    def __init__(self, model: M.Model, ecfg: EngineConfig):
        if ecfg.kv_precision not in ("", "native"):
            raise NotImplementedError(
                f"kv_precision {ecfg.kv_precision!r} is not ported yet; see "
                "ROADMAP.md queue 1 item 9 (quantized KV pages)")
        if not ecfg.greedy:
            raise NotImplementedError(
                "sampling is not ported yet; see ROADMAP.md queue 1 item 7 "
                "(per-request sampling)")
        self.cfg, self.model, self.ecfg = model.cfg, model, ecfg
        self.device = model.device
        B, P = ecfg.batch_slots, ecfg.prompt_len
        self._buckets = _prompt_buckets(P)

        # boot: empty batch state from a dummy prefill over the whole batch
        boot = torch.zeros((B, P), dtype=torch.int32, device=self.device)
        _, self.state = M.prefill(model, boot, ecfg.cache_len,
                                  shape_window=ecfg.shape_window)
        self.active: list = [None] * B
        self.pending: list = []
        self.finished: list = []
        self.slot_age = np.zeros(B, np.int32)
        self.steps = 0
        self.served_history: list = []
        self.prefill_dispatches = 0   # excludes the boot prefill
        self.decode_dispatches = 0
        self.blocking_syncs = 0       # dispatch-gating synchronous readbacks
        self.peak_active = 0

    # ------------------------------------------------------------------
    def queue_len(self) -> int:
        return len(self.pending)

    def submit(self, reqs: list) -> None:
        for r in reqs:
            if r.sampling is not None:
                raise NotImplementedError(
                    f"request {r.rid} asks for sampling, which is not ported "
                    "yet; see ROADMAP.md queue 1 item 7 (per-request sampling)")
        self.pending.extend(reqs)

    def counters(self) -> dict:
        """The reference engine's counter/gauge surface. The paged,
        chunked, sampling and sync-free keys stay 0 on this engine."""
        return {
            "steps": self.steps,
            "requests_finished": len(self.finished),
            "requests_active": sum(r is not None for r in self.active),
            "requests_pending": len(self.pending),
            "requests_prefilling": 0,
            "requests_sampled": 0,
            "prefill_dispatches": self.prefill_dispatches,
            "decode_dispatches": self.decode_dispatches,
            "fork_dispatches": 0,
            "blocking_syncs": self.blocking_syncs,
            "readback_waits": 0,
            "preemptions": 0,
            "alloc_failures": 0,
            "eviction_raced_hits": 0,
            "peak_active": self.peak_active,
            "prefix_hit_tokens": 0,
            "prefix_forks": 0,
            "prefix_inserted_pages": 0,
            "prefix_evicted_pages": 0,
            "occupancy": 0.0,
            "occupancy_hwm": 0.0,
            "committed_occupancy": 0.0,
            "pages_used": 0,
            "pages_free": 0,
            "pages_shared": 0,
            "pages_pinned": 0,
            "frag_tokens": 0,
            "peak_pages": 0,
            "pages_quant": 0,
            "pages_quant_used": 0,
            "quant_occupancy": 0.0,
        }

    def _slot_stats(self, n_active: int, served: int, **extra) -> dict:
        self.peak_active = max(self.peak_active, n_active)
        d = {
            "active": n_active,
            "queue": len(self.pending),
            "served": served,
            "finished_total": len(self.finished),
            "prefilling": 0,
            "occupancy": 0.0,
            "preemptions": 0,
            "blocking_syncs": self.blocking_syncs,
        }
        d.update(extra)
        return d

    def free_slots(self) -> list:
        return [i for i, r in enumerate(self.active) if r is None]

    def _bucket(self, tokens, req: Optional[Request] = None,
                bucket: Optional[int] = None) -> np.ndarray:
        toks, truncated = _bucket_prompt(tokens, bucket or self.ecfg.prompt_len)
        if req is not None and truncated:
            req.truncated = True
        return toks

    def _pick_bucket(self, need: int) -> int:
        for b in self._buckets:
            if b >= need:
                return b
        return self.ecfg.prompt_len

    def _run_prefill(self, toks: np.ndarray, lens: np.ndarray):
        """One bucketed, length-aware prefill dispatch."""
        return M.prefill(self.model, torch.as_tensor(toks, device=self.device),
                         self.ecfg.cache_len, shape_window=self.ecfg.shape_window,
                         prompt_lens=torch.as_tensor(lens, device=self.device))

    def _admit_one(self, req: Request, slot: int, now: int) -> None:
        """Legacy batch-1 admission (the fused path's equivalence oracle)."""
        P = self.ecfg.prompt_len
        L = max(1, min(len(req.tokens), P))
        bucket = self._pick_bucket(L)
        logits, one = self._run_prefill(self._bucket(req.tokens, req, bucket)[None, :],
                                        np.asarray([L], np.int32))
        self.prefill_dispatches += 1
        self.state = _splice_one(self.state, one, slot)
        self.blocking_syncs += 1
        req.start_slot = now
        req.first_token_slot = now   # first token came from this prefill
        req.generated = [int(torch.argmax(logits[0]))]
        self.active[slot] = req
        self.slot_age[slot] = 1
        req.admit_slot = now

    def admit_pending(self, now: int) -> int:
        """Fill all free slots from the pending queue with ONE prefill.

        The prefill batch is padded to the full batch_slots rows (pad rows
        are dropped by the splice's out-of-range slot index) and to the
        smallest power-of-two prompt bucket covering the admitted lengths.
        Returns k.
        """
        B, P = self.ecfg.batch_slots, self.ecfg.prompt_len
        slots = self.free_slots()[: len(self.pending)]
        if not slots:
            return 0
        reqs = [self.pending.pop(0) for _ in slots]
        k = len(reqs)
        lens = np.full(B, P, np.int32)
        for j, r in enumerate(reqs):
            lens[j] = max(1, min(len(r.tokens), P))
        bucket = self._pick_bucket(int(lens[:k].max()))
        lens = np.minimum(lens, bucket)
        toks = np.zeros((B, bucket), np.int32)
        for j, r in enumerate(reqs):
            toks[j] = self._bucket(r.tokens, r, bucket)
        slot_idx = np.full(B, B, np.int32)  # B = out of range -> splice drops
        slot_idx[:k] = slots
        logits, new = self._run_prefill(toks, lens)
        self.prefill_dispatches += 1
        self.state = _splice_many(self.state, new, slot_idx)
        self.blocking_syncs += 1
        first = torch.argmax(logits[:k], dim=-1).cpu().numpy()
        for j, (req, slot) in enumerate(zip(reqs, slots, strict=True)):
            req.start_slot = now
            req.first_token_slot = now
            req.generated = [int(first[j])]
            self.active[slot] = req
            self.slot_age[slot] = 1  # first token came from prefill
            req.admit_slot = now
        return k

    def _retire(self, i: int, r: Request, now: int) -> None:
        r.finish_slot = now
        self.finished.append(r)
        self.active[i] = None

    def step(self, now: int) -> dict:
        """Legacy engine slot: admit one-by-one -> one decode -> retire."""
        eos = self.ecfg.eos_id
        for slot in self.free_slots():
            if not self.pending:
                break
            self._admit_one(self.pending.pop(0), slot, now)

        served = 0  # finishers THIS call
        for i, r in enumerate(self.active):  # already complete at admission
            if r is not None and (self.slot_age[i] >= r.max_new_tokens or (
                    eos is not None and r.generated[-1] == eos)):
                self._retire(i, r, now)
                served += 1
        n_active = sum(r is not None for r in self.active)
        if n_active:
            toks = torch.tensor([r.generated[-1] if r else 0 for r in self.active],
                                dtype=torch.int32, device=self.device)
            nxt, self.state = _decode_one(self.model, self.state, toks,
                                          self.ecfg.shape_window)
            self.decode_dispatches += 1
            self.blocking_syncs += 1
            nxt = nxt.cpu().numpy()
            for i, r in enumerate(self.active):
                if r is None:
                    continue
                r.generated.append(int(nxt[i]))
                self.slot_age[i] += 1
                if self.slot_age[i] >= r.max_new_tokens or (
                        eos is not None and int(nxt[i]) == eos):
                    self._retire(i, r, now)
                    served += 1

        self.served_history.append(served)
        self.steps += 1
        return self._slot_stats(n_active, served)

    def step_slot(self, now: int, n_steps: int = 1) -> dict:
        """One control slot, fused: batched admit -> n-step decode -> retire.

        At most 1 prefill + 1 decode dispatch regardless of how many
        requests are admitted or how many decode steps run. A slot whose
        request finishes mid-dispatch keeps decoding (its extra tokens are
        discarded on the host), so per-step served counts mu(t) match what
        the legacy per-step loop would observe.
        """
        admitted = self.admit_pending(now)
        n_active = sum(r is not None for r in self.active)
        per_step = [0] * n_steps
        if n_active:
            toks = torch.tensor([r.generated[-1] if r else 0 for r in self.active],
                                dtype=torch.int32, device=self.device)
            all_toks, self.state = _decode_n(self.model, self.state, toks, n_steps,
                                             self.ecfg.shape_window)
            self.decode_dispatches += 1
            self.blocking_syncs += 1
            all_toks = all_toks.cpu().numpy()  # (n_steps, B)
            for i, r in enumerate(self.active):
                if r is None:
                    continue
                take, hit = _host_take(all_toks[:, i], r, int(self.slot_age[i]),
                                       n_steps, self.ecfg.eos_id)
                r.generated.extend(int(x) for x in all_toks[:take, i])
                self.slot_age[i] += take
                if hit or self.slot_age[i] >= r.max_new_tokens:
                    per_step[max(take - 1, 0)] += 1
                    self._retire(i, r, now)
        served = sum(per_step)
        self.served_history.append(served)
        self.steps += n_steps
        return self._slot_stats(n_active, served, served_per_step=per_step,
                                admitted=admitted)
