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

``PagedEngine`` serves the same loop from one shared pool of KV pages:
admission allocates pages, page growth and preempt-and-recompute keep the
decode covered, and retirement frees the pages (see its docstring).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.cache import PageAllocator, resolve_kv_precision
from repro_torch.models import model as M
from repro_torch.models import transformer as T
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


@dataclasses.dataclass
class PagedEngineConfig(EngineConfig):
    """Engine config plus the paged-pool geometry.

    KV memory = num_pages * page_size rows (vs batch_slots * cache_len for
    the dense engine); ``max_active`` is the decode batch (rows), bounded by
    compute, not memory. ``max_pages_per_req`` bounds one request's block
    table; 0 derives it from cache_len, and raising it past
    cache_len/page_size is how requests grow beyond the dense cache_len.
    ``quant_pages`` (a quantized page region) and ``prefix_sharing`` are
    the reference's options that the port refuses until ROADMAP.md queue 1
    items 9 and 8 bring them.
    """

    page_size: int = 16
    num_pages: int = 64
    max_active: int = 8
    max_pages_per_req: int = 0    # 0 => cache_len // page_size
    quant_pages: int = -1         # -1 or 0: no quantized region
    prefix_sharing: bool = False


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


def _decode_n_paged(model, state, toks, n):
    """n fused greedy decode steps over the paged pools; per-step tokens (n, B)."""
    outs = []
    for _ in range(n):
        logits, state = M.decode_step_paged(model, state, toks)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
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

    def _run_prefill(self, toks: np.ndarray, lens: np.ndarray,
                     cache_len: Optional[int] = None):
        """One bucketed, length-aware prefill dispatch."""
        return M.prefill(self.model, torch.as_tensor(toks, device=self.device),
                         cache_len or self.ecfg.cache_len,
                         shape_window=self.ecfg.shape_window,
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


_ITEM8 = "ROADMAP.md queue 1 item 8 (prefix sharing)"
_ITEM9 = "ROADMAP.md queue 1 item 9 (quantized KV pages)"
_ITEM6 = "ROADMAP.md queue 1 item 6 (the sync-free loop and chunked batching)"


class PagedEngine(Engine):
    """Continuous batching over a paged KV cache.

    Where ``Engine`` reserves a dense ``batch_slots x cache_len`` cache row
    per request, this engine admits a request by allocating pages from one
    shared pool (``repro_torch.cache.PageAllocator``): a short request holds
    only the pages it writes, so at equal KV memory more requests are in
    flight. Requests grow by appending pages — past ``cache_len`` if
    ``max_pages_per_req`` allows — and retirement returns pages to the free
    list. Ragged admission pays only for each prompt's real length.

    The dense engine's dispatch budget holds: one control slot costs <= 1
    bucketed batch prefill (every admission of the slot, its dense cache
    copied into pages) + 1 fused n-step decode over all ``max_active``
    rows. Page tables are host-side bookkeeping; block tables and positions
    go to the device with the decode. Before each decode every active row
    is extended to cover the slot's ``n_steps`` writes; a row the pool
    cannot cover is preempted (pages freed, request re-queued for a fresh
    prefill — the same tokens under greedy decoding).

    Greedy generation is per request the dense engine's: every per-row op
    matches the dense path. ``occupancy()`` is the pool's fill fraction,
    the signal ``MemoryAware`` prices. The port serves native precision,
    greedy, fused, without prefix sharing; the other paths raise
    NotImplementedError naming the ROADMAP.md item that brings them.
    """

    def __init__(self, model: M.Model, ecfg: PagedEngineConfig):
        cfg = model.cfg
        if not T.paged_segments_supported(cfg):
            raise ValueError(f"{cfg.name}: paged decode needs an all-attention stack")
        if ecfg.shape_window is not None:
            raise ValueError("paged decode does not support sliding windows")
        ps, P, R = ecfg.page_size, ecfg.prompt_len, ecfg.max_active
        if P % ps:
            raise ValueError(f"prompt_len {P} must be a multiple of page_size {ps}")
        if ecfg.kv_precision:
            cfg = cfg.replace(kv_precision=ecfg.kv_precision)
        kvp = resolve_kv_precision(cfg.kv_precision, cfg.cache_dtype)
        if not kvp.is_native or ecfg.quant_pages > 0:
            raise NotImplementedError(
                f"paged KV precision {kvp.tag!r} (quant_pages "
                f"{ecfg.quant_pages}) is not ported yet; see {_ITEM9}")
        if ecfg.prefix_sharing:
            raise NotImplementedError(f"prefix sharing is not ported yet; see {_ITEM8}")
        if not ecfg.greedy:
            raise NotImplementedError(
                "sampling is not ported yet; see ROADMAP.md queue 1 item 7 "
                "(per-request sampling)")
        self.cfg, self.model, self.ecfg = cfg, model, ecfg
        self.device = model.device
        self.MP = ecfg.max_pages_per_req or max(ecfg.cache_len // ps, P // ps + 1)
        self._buckets = _prompt_buckets(P, quantum=ps)
        self.pools = T.paged_pools_init(cfg, ecfg.num_pages, ps, self.device)
        self.allocator = PageAllocator(ecfg.num_pages, ps)
        self.block_tables = np.full((R, self.MP), -1, np.int32)
        self.pos = np.zeros(R, np.int32)
        self.active: list = [None] * R
        self.pending: list = []
        self.finished: list = []
        self.slot_age = np.zeros(R, np.int32)
        self.steps = 0
        self.served_history: list = []
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.blocking_syncs = 0
        self.alloc_failures = 0       # admissions deferred: pool exhausted
        self.preemptions = 0          # active requests bounced for pages
        self.peak_active = 0
        # high-water occupancy of the last control slot (post-admission,
        # pre-retirement): the commitment peak the controller must price;
        # end-of-slot occupancy dips as finished requests free pages
        self.occupancy_hwm = 0.0

    # ----------------------------------------------------- observability
    def counters(self) -> dict:
        c = super().counters()
        st = self.allocator.stats()
        c.update(
            preemptions=self.preemptions,
            alloc_failures=self.alloc_failures,
            occupancy=self.allocator.occupancy(),
            occupancy_hwm=float(self.occupancy_hwm),
            committed_occupancy=self.allocator.committed_occupancy(),
            pages_used=st.used_pages,
            pages_free=st.free_pages,
            pages_shared=st.shared_pages,
            pages_pinned=st.pinned_pages,
            frag_tokens=st.frag_tokens,
            peak_pages=st.peak_used_pages,
        )
        return c

    def _slot_stats(self, n_active: int, served: int, **extra) -> dict:
        d = super()._slot_stats(n_active, served, **extra)
        d["occupancy"] = self.occupancy()
        d["preemptions"] = self.preemptions
        return d

    def occupancy(self) -> float:
        return self.allocator.occupancy()

    # ------------------------------------------------------------------
    def step(self, now: int) -> dict:
        raise NotImplementedError("the paged engine has no legacy per-step loop")

    def _admit_one(self, req: Request, slot: int, now: int) -> None:
        raise NotImplementedError("the paged engine admits via admit_pending")

    def step_slot_sync(self, now: int, n_steps: int = 1) -> dict:
        raise NotImplementedError(f"the sync-free paged loop is not ported yet; see {_ITEM6}")

    def step_slot_chunked(self, now: int, n_steps: int = 1) -> dict:
        raise NotImplementedError(f"chunked paged batching is not ported yet; see {_ITEM6}")

    def _retire(self, row: int, r: Request, now: int) -> None:
        super()._retire(row, r, now)
        self._release_row(row)

    def _release_row(self, row: int) -> None:
        self.allocator.free(row)
        self.block_tables[row] = -1
        self.pos[row] = 0
        self.slot_age[row] = 0

    def _preempt(self, row: int) -> None:
        """Bounce an active request back to pending (pages exhausted). Its
        pages return to the pool and its generation restarts from a fresh
        prefill on re-admission — the same tokens under greedy decoding."""
        req = self.active[row]
        self._release_row(row)
        self.active[row] = None
        req.generated = None
        req.admit_slot = None
        req.start_slot = None
        req.first_token_slot = None
        self.pending.insert(0, req)
        self.preemptions += 1

    def admit_pending(self, now: int, lookahead: int = 1) -> int:
        """Fill free rows from the pending queue with ONE bucketed prefill.

        Admission = page allocation: a request enters only if the pool can
        cover its real prompt length plus this slot's ``lookahead`` decode
        writes (so admission never immediately preempts; growth beyond the
        slot comes page by page). All k admissions share one batch-R
        prefill whose dense cache (cache_len = the bucket) is copied into
        the pages; pad rows carry out-of-pool page ids and copy nothing.
        """
        R, P, ps = self.ecfg.max_active, self.ecfg.prompt_len, self.ecfg.page_size
        N = self.ecfg.num_pages
        take: list = []
        for row in self.free_slots():
            if not self.pending:
                break
            req = self.pending[0]
            if req.max_new_tokens > self.MP * ps - P + 1:
                raise ValueError(
                    f"request {req.rid}: max_new_tokens {req.max_new_tokens} "
                    f"exceeds the block table ({self.MP} pages x {ps})")
            L = max(1, min(len(req.tokens), P))
            # pages are keyed by engine row: a row uniquely owns its request
            # while active, whereas rids are unique only per RequestSource
            pages = self.allocator.alloc(row, min(L + lookahead, self.MP * ps))
            if pages is None:
                self.alloc_failures += 1
                break
            self.pending.pop(0)
            take.append((row, req, pages, L))
        if not take:
            return 0
        bucket = self._pick_bucket(max(L for *_, L in take))
        npp = bucket // ps
        toks = np.zeros((R, bucket), np.int32)
        lens = np.full(R, bucket, np.int32)
        page_idx = np.full((R, npp), N, np.int32)   # N: outside the pool, not copied
        for j, (_row, req, pages, L) in enumerate(take):
            toks[j] = self._bucket(req.tokens, req, bucket)
            lens[j] = L
            pg = pages[:npp]
            page_idx[j, : len(pg)] = pg
        # cache_len == bucket: the dense prefill cache is exactly the prompt
        # rows, ready to copy into pages (no ring wraparound)
        logits, state = self._run_prefill(toks, lens, bucket)
        self.prefill_dispatches += 1
        self.pools = M.paged_splice_prompt(self.pools, state.caches, page_idx)
        del state
        self.blocking_syncs += 1
        first = torch.argmax(logits[: len(take)], dim=-1).cpu().numpy()
        for j, (row, req, pages, L) in enumerate(take):
            req.start_slot = now
            req.first_token_slot = now
            req.generated = [int(first[j])]
            req.admit_slot = now
            self.active[row] = req
            self.block_tables[row, : len(pages)] = pages
            self.pos[row] = L
            self.slot_age[row] = 1   # first token came from prefill
        self.peak_active = max(self.peak_active, sum(r is not None for r in self.active))
        return len(take)

    def _ensure_pages(self, n_steps: int) -> None:
        """Pre-extend every active row to cover this slot's decode writes.

        The fused decode writes rows pos..pos+n_steps-1 for every active row
        (rows finishing mid-dispatch keep writing, masked), so the pages
        must exist up front; growing here keeps the decode free of host
        round-trips. Rows the pool cannot cover are preempted."""
        ps = self.ecfg.page_size
        for row, req in enumerate(self.active):
            if req is None:
                continue
            need = min(int(self.pos[row]) + n_steps, self.MP * ps)
            pages = self.allocator.extend(row, need)
            if pages is None:
                self._preempt(row)
                continue
            self.block_tables[row, : len(pages)] = pages

    def step_slot(self, now: int, n_steps: int = 1) -> dict:
        """One control slot: batched admit -> page extension -> fused decode
        -> retire (pages freed). <= 1 prefill + 1 decode dispatch."""
        admitted = self.admit_pending(now, lookahead=n_steps)
        self._ensure_pages(n_steps)
        self.occupancy_hwm = self.occupancy()
        n_active = sum(r is not None for r in self.active)
        per_step = [0] * n_steps
        if n_active:
            toks = torch.tensor([r.generated[-1] if r else 0 for r in self.active],
                                dtype=torch.int32, device=self.device)
            state = M.PagedDecodeState(
                pools=self.pools,
                block_tables=torch.tensor(self.block_tables, device=self.device),
                pos=torch.tensor(self.pos, device=self.device),
                last_tok=toks)
            all_toks, state = _decode_n_paged(self.model, state, toks, n_steps)
            self.pools = state.pools
            self.decode_dispatches += 1
            self.blocking_syncs += 1
            all_toks = all_toks.cpu().numpy()  # (n_steps, R)
            for row, req in enumerate(self.active):
                if req is None:
                    continue
                self.pos[row] += n_steps     # the decode wrote n_steps rows
                take, hit = _host_take(all_toks[:, row], req, int(self.slot_age[row]),
                                       n_steps, self.ecfg.eos_id)
                req.generated.extend(int(x) for x in all_toks[:take, row])
                self.slot_age[row] += take
                if hit or self.slot_age[row] >= req.max_new_tokens:
                    per_step[max(take - 1, 0)] += 1
                    self._retire(row, req, now)
        served = sum(per_step)
        self.served_history.append(served)
        self.steps += n_steps
        return self._slot_stats(n_active, served, served_per_step=per_step,
                                admitted=admitted)
