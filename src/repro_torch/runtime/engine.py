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

Admission on a dense attention stack buckets prompts into power-of-two
sub-buckets (P/4, P/2, P) of ``prompt_len`` and passes per-row real lengths
to the length-aware prefill: logits come from each row's real last token,
decode resumes at pos = len, and cache slots beyond len stay empty. A
recurrent (SSM) stack integrates every position, so its admission runs the
padded prefill over the full ``prompt_len`` bucket, as the reference's
does: a short prompt's state runs through the PAD_ID pads and its first
token is predicted after the last pad (ROADMAP R7). The boot prefill is
always padded.

The engine updates its decode state in place: the splices and the decode
steps write into the cache tensors (KV rings or recurrent states) of
``self.state``.

Sync-free serving (``step_slot_sync``). ``step_slot`` pays two blocking
readbacks per slot: admission reads the first tokens back and the decode
reads its tokens back before the host can retire anything. The sync-free
loop keeps greedy selection, EOS detection, per-row stop masks and a
generated-token ring buffer on the device (``SyncState``): admission
computes the first token there, the host dispatches each slot from
device-resident state, and only *starts* a copy of the small ``done``,
``age``, ``gen_buf`` and per-step ``served`` counters into pinned host
buffers behind a CUDA event. Slot t's packet is consumed at slot t+1,
after that slot's dispatch is queued, so no device read gates a dispatch:
``blocking_syncs`` stays 0. A finished request retires one slot
late; ``drain`` flushes the last packet. Every host-to-device input of
these paths goes through pinned memory with ``non_blocking=True``.

Chunked continuous batching (``step_slot_chunked``). Admission is host
bookkeeping only: a claimed row gets a ``PrefillCursor``, and its prompt
enters the cache ``chunk_size`` tokens per slot inside ONE mixed dispatch:
per-row prompt chunks (``chunk_step``), device-side activation of the rows
whose final chunk ran (their first token), then the n-step sync-free
decode. Rows mid-prompt ride the decode done-masked. ``chunk_budget``
bounds the prompt tokens one slot adds across rows. The slot runs no
prefill pass over padded buckets at all.

``PagedEngine`` serves the fused loop from one shared pool of KV pages:
admission allocates pages, page growth and preempt-and-recompute keep the
decode covered, and retirement frees the pages (see its docstring).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.cache import PageAllocator, resolve_kv_precision
from repro_torch.device import host_to_device
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.runtime.request import Request

# Sentinel for short-prompt padding (identical across requests).
PAD_ID = 0


class ReadbackTimeout(RuntimeError):
    """A pending readback packet never became ready within the engine's
    ``readback_timeout_s`` bound. Carries the control slot whose counters
    were in flight, the array the consumer waited on and the rows whose
    retirement the packet was carrying."""

    def __init__(self, slot: int, array: str, rows: list, timeout_s: float):
        self.slot = slot
        self.array = array
        self.rows = list(rows)
        self.timeout_s = timeout_s
        super().__init__(
            f"readback for slot {slot} not ready after {timeout_s:g}s "
            f"(array {array!r}; rows awaiting retirement: {self.rows})")


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 8
    prompt_len: int = 32
    cache_len: int = 128
    greedy: bool = True           # the port serves greedy only
    shape_window: Optional[int] = None
    eos_id: Optional[int] = None  # stop token (None = length-only stopping)
    gen_buf_len: int = 0          # sync-free token ring capacity; 0 => cache_len
    # continuous batching (step_slot_chunked): prompt chunk width per row per
    # slot (0 => prompt_len // 4) and the per-slot prefill token budget
    # across rows (0 => batch_slots * chunk width)
    chunk_size: int = 0
    chunk_budget: int = 0
    # the bounded wait on a pending readback packet before the consumer
    # raises ReadbackTimeout; <= 0 waits without a bound
    readback_timeout_s: float = 30.0
    # KV storage: "" / "native" on the dense engine; the paged engine also
    # takes "int8" / "fp8" (a quantized page region)
    kv_precision: str = ""


@dataclasses.dataclass
class PagedEngineConfig(EngineConfig):
    """Engine config plus the paged-pool geometry.

    KV memory = num_pages * page_size rows (vs batch_slots * cache_len for
    the dense engine); ``max_active`` is the decode batch (rows), bounded by
    compute, not memory. ``max_pages_per_req`` bounds one request's block
    table; 0 derives it from cache_len, and raising it past
    cache_len/page_size is how requests grow beyond the dense cache_len.
    Under a quantized ``kv_precision`` (int8, fp8) ``quant_pages`` sizes the
    quantized region at the top of the pool: -1 quantizes every page, a
    value in (0, num_pages) builds a mixed pool whose region new
    admissions draw from is ``PagedEngine.admit_precision``.
    ``prefix_sharing`` is the reference's option that the port refuses
    until ROADMAP.md queue 1 item 8 brings it.
    """

    page_size: int = 16
    num_pages: int = 64
    max_active: int = 8
    max_pages_per_req: int = 0    # 0 => cache_len // page_size
    quant_pages: int = -1         # -1: every page if kv_precision is quantized, else none
    prefix_sharing: bool = False


class SyncState(NamedTuple):
    """Device-resident per-row generation state of the sync-free loop.

    The decode owns greedy selection, stop masks and the generated-token
    ring buffer, so the host never waits on token values. ``gen_buf`` is
    written at ``age % cap`` (admission keeps max_new_tokens <= cap, so it
    never wraps before retirement); ``done`` freezes a row: its decode
    keeps running, masked, until the host retires it a slot later.
    """

    cur_tok: torch.Tensor   # (B,) int32 next decode input (last token)
    age: torch.Tensor       # (B,) int32 tokens generated so far
    budget: torch.Tensor    # (B,) int32 max_new_tokens; 0 = inactive row
    done: torch.Tensor      # (B,) bool finished or inactive
    gen_buf: torch.Tensor   # (B, cap) int32 generated-token ring buffer


def sync_state_init(batch: int, cap: int, device) -> SyncState:
    z = torch.zeros(batch, dtype=torch.int32, device=device)
    return SyncState(cur_tok=z, age=z.clone(), budget=z.clone(),
                     done=torch.ones(batch, dtype=torch.bool, device=device),
                     gen_buf=torch.zeros((batch, cap), dtype=torch.int32, device=device))


def _ring_write(buf: torch.Tensor, col: torch.Tensor, rows: torch.Tensor,
                tok: torch.Tensor) -> torch.Tensor:
    """``buf`` (B, cap) with ``tok`` written at column ``col`` of the rows
    where ``rows`` is True: a select, so no index leaves the device."""
    cols = torch.arange(buf.shape[1], device=buf.device)
    at = rows[:, None] & (cols[None, :] == col[:, None])
    return torch.where(at, tok[:, None], buf)


def _sync_step(sync: SyncState, nxt: torch.Tensor, eos_id: Optional[int]):
    """One decode step's sync-state advance: write the new token into the
    ring, advance ages, latch stop masks. Returns (sync, the step's newly
    finished count), the count a 0-d int32 device tensor."""
    cap = sync.gen_buf.shape[1]
    active = ~sync.done
    tok = torch.where(active, nxt, sync.cur_tok)
    gen_buf = _ring_write(sync.gen_buf, sync.age % cap, active, tok)
    age = sync.age + active.to(torch.int32)
    fin = age >= sync.budget
    if eos_id is not None:
        fin = fin | (tok == eos_id)
    done = sync.done | (active & fin)
    served = (done & active).sum(dtype=torch.int32)
    return SyncState(tok, age, sync.budget, done, gen_buf), served


def _first_tokens(logits: torch.Tensor, budgets: torch.Tensor, eos_id: Optional[int]):
    """Greedy first tokens of newly activated rows and whether each
    finished with it (a budget of 1, or EOS)."""
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    fin = budgets <= 1
    if eos_id is not None:
        fin = fin | (first == eos_id)
    return first, fin


def _sync_admit(sync: SyncState, logits: torch.Tensor, rows: torch.Tensor,
                budgets: torch.Tensor, eos_id: Optional[int]) -> SyncState:
    """Device-side admission: the first token of each admitted row (prefill
    row j -> engine row rows[j]) and its sync-state reset, with no logits
    readback."""
    first, fin = _first_tokens(logits, budgets, eos_id)
    return SyncState(
        cur_tok=sync.cur_tok.index_put((rows,), first),
        age=sync.age.index_put((rows,), torch.ones_like(first)),
        budget=sync.budget.index_put((rows,), budgets),
        done=sync.done.index_put((rows,), fin),
        gen_buf=sync.gen_buf.index_put((rows, torch.zeros_like(rows)), first))


def _sync_activate(sync: SyncState, logits: torch.Tensor, final: torch.Tensor,
                   budgets: torch.Tensor, eos_id: Optional[int]) -> SyncState:
    """Device-side activation of the rows whose final prompt chunk ran in
    this dispatch: their first token comes from the chunk's last-token
    logits, masked into the sync state, with no logits readback."""
    first, fin = _first_tokens(logits, budgets, eos_id)
    zero = torch.zeros_like(sync.age)
    return SyncState(
        cur_tok=torch.where(final, first, sync.cur_tok),
        age=torch.where(final, 1, sync.age),
        budget=torch.where(final, budgets, sync.budget),
        done=torch.where(final, fin, sync.done),
        gen_buf=_ring_write(sync.gen_buf, zero, final, first))


def _decode_n_sync(model, state, sync: SyncState, n: int, shape_window,
                   eos_id: Optional[int]):
    """Sync-free fused decode: selection, EOS and the ring buffer stay on
    the device. Rows whose stop mask latched keep computing (masked) but
    stop advancing: their pos freezes, so a finished row rewrites its own
    last cache slot. Returns (state, sync, served per step (n,) int32)."""
    served = []
    for _ in range(n):
        logits, nstate = M.decode_step(model, state, sync.cur_tok,
                                       shape_window=shape_window)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        state = nstate._replace(pos=torch.where(sync.done, state.pos, nstate.pos))
        sync, s = _sync_step(sync, nxt, eos_id)
        served.append(s)
    return state, sync, torch.stack(served)


@dataclasses.dataclass
class PrefillCursor:
    """Host-side chunked-prefill progress of one admitted request.

    The request holds its engine row from admission, but its prompt enters
    the cache chunk by chunk: ``off`` tokens are written. The row joins the
    decode (and becomes retirable) only at the dispatch carrying its final
    chunk; until then the device's ``done`` flag for the row is stale and
    the readback consumer skips it.
    """

    req: Request
    row: int
    toks: np.ndarray          # (L,) int32 the real (truncated) prompt
    cached: int = 0           # prompt tokens already resident at the claim

    def __post_init__(self):
        self.off = self.cached
        self.started = False   # start_slot stamped at the first real chunk

    @property
    def remaining(self) -> int:
        return len(self.toks) - self.off


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
    """Insert batch-1 prefill state into the batch state at ``slot``, in
    place. Every cache leaf (KVCache or SSMState) has the layer axis first
    and the batch axis second."""
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
    idx = host_to_device(np.stack([rows, slots[rows]]).astype(np.int64), state.pos.device)
    src, dst = idx[0], idx[1]
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
                f"kv_precision {ecfg.kv_precision!r} on the dense engine is not ported "
                "yet (the paged engine takes it); see ROADMAP.md queue 1 item 9 (the "
                "dense quantized ring cache)")
        if not ecfg.greedy:
            raise NotImplementedError(
                "sampling is not ported yet; see ROADMAP.md queue 1 item 7 "
                "(per-request sampling)")
        self.cfg, self.model, self.ecfg = model.cfg, model, ecfg
        self.device = model.device
        B, P = ecfg.batch_slots, ecfg.prompt_len
        self._buckets = _prompt_buckets(P)
        self._gen_cap = ecfg.gen_buf_len or ecfg.cache_len

        # boot: empty batch state from a dummy prefill over the whole batch
        boot = torch.zeros((B, P), dtype=torch.int32, device=self.device)
        _, self.state = M.prefill(model, boot, ecfg.cache_len,
                                  shape_window=ecfg.shape_window)
        self.sync = sync_state_init(B, self._gen_cap, self.device)
        self.active: list = [None] * B
        self.pending: list = []
        self.finished: list = []
        self.slot_age = np.zeros(B, np.int32)
        self.steps = 0
        self.served_history: list = []
        self.prefill_dispatches = 0   # excludes the boot prefill
        self.decode_dispatches = 0
        self.blocking_syncs = 0       # dispatch-gating synchronous readbacks
        self.readback_waits = 0       # sync-free consumes that found a copy in flight
        self.peak_active = 0
        self._init_sync_free(B)
        self._chunk = ecfg.chunk_size or max(P // 4, 1)
        self._chunk_ok = T.chunked_prefill_supported(self.cfg) and ecfg.shape_window is None

    def _init_sync_free(self, rows: int) -> None:
        self._pending_read = None     # the last slot's readback packet
        # admission epoch per row: a packet retires a row only if the row
        # still hosts the request the packet observed
        self._row_epoch = np.zeros(rows, np.int64)
        # continuous batching: per-row chunked-prefill cursors (insertion
        # order = admission order = chunk-scheduling priority)
        self._cursors: dict = {}
        # two sets of pinned host buffers, alternating, so that a slot's
        # copy never overwrites the previous slot's packet before it is read
        self._readback_bufs = ({}, {})
        self._readback_flip = 0

    # ------------------------------------------------------------------
    def queue_len(self) -> int:
        return len(self.pending)

    def token_backlog(self) -> int:
        """Pending prompt *tokens*: queued prompts plus the unwritten tails
        of in-flight chunked prefills, the signal ``TokenBacklogAware``
        prices (a request count hides that one long prompt costs what many
        short ones do)."""
        P = self.ecfg.prompt_len
        t = sum(max(1, min(len(r.tokens), P)) for r in self.pending)
        return t + sum(c.remaining for c in self._cursors.values())

    def submit(self, reqs: list) -> None:
        for r in reqs:
            if r.sampling is not None:
                raise NotImplementedError(
                    f"request {r.rid} asks for sampling, which is not ported "
                    "yet; see ROADMAP.md queue 1 item 7 (per-request sampling)")
        self.pending.extend(reqs)

    def counters(self) -> dict:
        """The reference engine's counter/gauge surface. The paged, prefix
        and sampling keys stay 0 on this engine."""
        return {
            "steps": self.steps,
            "requests_finished": len(self.finished),
            "requests_active": sum(r is not None for r in self.active),
            "requests_pending": len(self.pending),
            "requests_prefilling": len(self._cursors),
            "requests_sampled": 0,
            "prefill_dispatches": self.prefill_dispatches,
            "decode_dispatches": self.decode_dispatches,
            "fork_dispatches": 0,
            "blocking_syncs": self.blocking_syncs,
            "readback_waits": self.readback_waits,
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
            "prefilling": len(self._cursors),
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

    @property
    def _ragged(self) -> bool:
        """Length-aware admission: dense attention stacks only."""
        return T.ragged_prefill_supported(self.cfg)

    def _pick_bucket(self, need: int) -> int:
        if not self._ragged:
            return self.ecfg.prompt_len
        for b in self._buckets:
            if b >= need:
                return b
        return self.ecfg.prompt_len

    def _run_prefill(self, toks: np.ndarray, lens: np.ndarray,
                     cache_len: Optional[int] = None):
        """One bucketed prefill dispatch: length-aware on a dense attention
        stack, padded otherwise (``lens`` unused)."""
        return M.prefill(self.model, host_to_device(toks, self.device),
                         cache_len or self.ecfg.cache_len,
                         shape_window=self.ecfg.shape_window,
                         prompt_lens=host_to_device(lens, self.device) if self._ragged
                         else None)

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

    def admit_pending(self, now: int, sync: bool = False) -> int:
        """Fill all free slots from the pending queue with ONE prefill.

        The prefill batch is padded to the full batch_slots rows (pad rows
        are dropped by the splice's out-of-range slot index) and, on a dense
        attention stack, to the smallest power-of-two prompt bucket covering
        the admitted lengths (else to ``prompt_len``).
        ``sync=True`` computes the first tokens on the device
        (``_sync_admit``) instead of reading the logits back. Returns k.
        """
        B, P = self.ecfg.batch_slots, self.ecfg.prompt_len
        slots = self.free_slots()[: len(self.pending)]
        if not slots:
            return 0
        if sync:
            for r in self.pending[: len(slots)]:
                self._validate_gen_cap(r)   # before popping: a raise drops nothing
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
        if sync:
            adm = host_to_device(np.asarray(
                [slots, [r.max_new_tokens for r in reqs]], np.int64), self.device)
            self.sync = _sync_admit(self.sync, logits[:k], adm[0], adm[1].to(torch.int32),
                                    self.ecfg.eos_id)
            for req, slot in zip(reqs, slots, strict=True):
                req.start_slot = now
                req.first_token_slot = now
                req.generated = None   # filled from the device ring at retirement
                self.active[slot] = req
                self.slot_age[slot] = 1
                self._row_epoch[slot] += 1
                req.admit_slot = now
            return k
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

    # ------------------------------------------------- sync-free protocol
    def _validate_gen_cap(self, req: Request) -> None:
        if req.max_new_tokens > self._gen_cap:
            raise ValueError(
                f"request {req.rid}: max_new_tokens {req.max_new_tokens} "
                f"exceeds gen_buf_len {self._gen_cap}")

    def _post_readback(self, now: int, served_steps: torch.Tensor) -> None:
        """Start the copy of this slot's counters to the host: into pinned
        buffers with ``non_blocking=True``, fenced by a recorded CUDA event
        (on the CPU an ordinary copy, ready at once)."""
        arrays = {"done": self.sync.done, "age": self.sync.age,
                  "gen": self.sync.gen_buf, "served": served_steps}
        event = None
        if self.device.type == "cuda":
            bufs = self._readback_bufs[self._readback_flip]
            self._readback_flip ^= 1
            host = {}
            for name, a in arrays.items():
                buf = bufs.get(name)
                if buf is None or buf.shape != a.shape:
                    buf = bufs[name] = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                host[name] = buf.copy_(a, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = {name: a.clone() for name, a in arrays.items()}
        self._pending_read = {"slot": now, "arrays": host, "event": event,
                              "epoch": self._row_epoch.copy()}

    def _readback_ready(self, p: dict) -> bool:
        """Non-blocking: has the packet's copy completed?"""
        return p["event"] is None or p["event"].query()

    def _await_readback(self, p: dict) -> None:
        """Wait for the packet's copy, polling its event for at most
        ``readback_timeout_s``; then raise ``ReadbackTimeout`` rather than
        hang on a wedged transfer. A bound <= 0 waits without one. One
        event fences the packet's arrays; ``done`` is the first read."""
        ev = p["event"]
        if ev is None or ev.query():
            return
        timeout = self.ecfg.readback_timeout_s
        if timeout <= 0:
            ev.synchronize()
            return
        deadline = time.monotonic() + timeout
        while not ev.query():
            if time.monotonic() > deadline:
                rows = [i for i, r in enumerate(self.active)
                        if r is not None and i not in self._cursors]
                raise ReadbackTimeout(p["slot"], "done", rows, timeout)
            time.sleep(2e-4)

    def _consume_read(self, p: Optional[dict], count_waits: bool = True) -> tuple[int, list]:
        """Consume one readback packet: retire finished rows from the host
        copies alone. By protocol this runs after the next slot's dispatch
        is queued, so the wait never starves the device; a copy still in
        flight is an overlap miss, counted in ``readback_waits``."""
        if p is None:
            return 0, []
        if count_waits and not self._readback_ready(p):
            self.readback_waits += 1
        self._await_readback(p)
        done = p["arrays"]["done"].numpy()
        age = p["arrays"]["age"].numpy()
        gen = p["arrays"]["gen"].numpy()
        per_step = [int(x) for x in p["arrays"]["served"].numpy()]
        served = 0
        for row, req in enumerate(self.active):
            if req is None or not done[row]:
                continue
            if row in self._cursors:
                continue  # mid-prefill: the done flag is the previous tenant's
            if p["epoch"][row] != self._row_epoch[row]:
                continue  # row re-admitted after this packet was dispatched
            req.generated = [int(t) for t in gen[row, :min(int(age[row]), gen.shape[1])]]
            self._retire(row, req, p["slot"])
            self.slot_age[row] = 0
            served += 1
        extra = served - sum(per_step)
        if extra > 0:  # admission-time finishers (budget <= 1, or EOS first)
            per_step = per_step or [0]
            per_step[0] += extra
        return served, per_step

    def step_slot_sync(self, now: int, n_steps: int = 1) -> dict:
        """One sync-free control slot: batched admission (first token on
        the device) -> the fused decode from device-resident state -> start
        the counter copy -> THEN consume the previous slot's copy, which has
        ridden beside a full slot of queued work.

        No device read gates a dispatch: 0 blocking syncs per slot. The
        price is retirement lag: a request finishing in slot t retires at
        the end of slot t+1 (call ``drain`` after the last slot). The
        reference also consumes a packet before slot t+1's admission when
        its copy has already landed, which makes its schedule depend on
        the wall clock; here the consume point is fixed, so the schedule is
        the same on every device (ROADMAP R5).
        """
        prev, self._pending_read = self._pending_read, None
        admitted = self.admit_pending(now, sync=True)
        n_active = sum(r is not None for r in self.active)
        if n_active:
            self.state, self.sync, served_steps = _decode_n_sync(
                self.model, self.state, self.sync, n_steps, self.ecfg.shape_window,
                self.ecfg.eos_id)
            self.decode_dispatches += 1
            self._post_readback(now, served_steps)
        served_prev, per_step_prev = self._consume_read(prev)
        self.served_history.append(served_prev)
        self.steps += n_steps
        return self._slot_stats(n_active, served_prev, served_per_step=per_step_prev,
                                admitted=admitted)

    def drain(self) -> dict:
        """Flush the in-flight slot's readback (shutdown; waits once)."""
        p, self._pending_read = self._pending_read, None
        served, per_step = self._consume_read(p, count_waits=False)
        return {"served": served, "served_per_step": per_step}

    # --------------------------------------- continuous batching (chunked)
    def _require_chunked(self) -> None:
        if not self._chunk_ok:
            raise ValueError(
                f"{self.cfg.name}: chunked prefill needs a dense-attention "
                "stack and no sliding window")

    def _admit_chunked(self, now: int) -> int:
        """Claim free rows for pending requests: host bookkeeping only.

        No prefill runs here: the prompt is staged on the host and enters
        the cache chunk by chunk through the mixed dispatch. ``start_slot``
        is stamped at the first chunk (service start).
        """
        P = self.ecfg.prompt_len
        k = 0
        for row in self.free_slots():
            if not self.pending:
                break
            self._validate_gen_cap(self.pending[0])   # raise before popping
            req = self.pending.pop(0)
            L = max(1, min(len(req.tokens), P))
            if len(req.tokens) > P:
                req.truncated = True
            toks = np.asarray(req.tokens[:L], np.int32)
            if len(toks) < L:   # an empty prompt: one PAD_ID token
                toks = np.concatenate([toks, np.full(L - len(toks), PAD_ID, np.int32)])
            self.active[row] = req
            self.slot_age[row] = 0
            cached = self._claim_row(row, toks)
            self._cursors[row] = PrefillCursor(req=req, row=row, toks=toks, cached=cached)
            req.admit_slot = now
            k += 1
        return k

    def _claim_row(self, row: int, toks: np.ndarray) -> int:
        """Engine-specific setup when a chunked admission claims a row;
        returns the prompt tokens already resident (0 on the dense engine:
        the cursor starts at the prompt's beginning)."""
        return 0

    def _on_activate(self, row: int, cur: PrefillCursor, now: int) -> None:
        """A row's final chunk just shipped: its first token is computed in
        this slot's dispatch (``_sync_activate``)."""
        cur.req.first_token_slot = now

    def _chunk_reserve(self, row: int, cur: PrefillCursor, take: int,
                       fin: bool, n_steps: int) -> bool:
        """Engine-specific capacity check for one scheduled chunk; False
        defers it. The dense engine's rows always have room."""
        return True

    def _chunk_plan(self, n_steps: int) -> Optional[dict]:
        """Pick this slot's chunk rows under the per-slot token budget.

        Cursors are visited in admission (FIFO) order; each scheduled row
        advances up to ``chunk_size`` tokens, and scheduling stops once
        ``chunk_budget`` prompt tokens are packed. Chunks may be partial
        (budget or prompt tail), so any budget >= 1 makes progress.
        """
        if not self._cursors:
            return None
        B, C = len(self.active), self._chunk
        left = self.ecfg.chunk_budget or (B * C)
        toks = np.zeros((B, C), np.int32)
        ints = np.zeros((3, B), np.int32)        # pos0, valid, budgets
        flags = np.zeros((2, B), bool)           # reset, final
        plan = []
        for row, cur in list(self._cursors.items()):
            if left <= 0:
                break
            take = min(C, cur.remaining, left)
            if take <= 0:
                continue
            fin = cur.off + take == len(cur.toks)
            if not self._chunk_reserve(row, cur, take, fin, n_steps):
                continue
            left -= take
            toks[row, :take] = cur.toks[cur.off:cur.off + take]
            ints[:, row] = (cur.off, take, cur.req.max_new_tokens)
            flags[:, row] = (cur.off == 0, fin)
            plan.append((row, cur, take, fin))
        if not plan:
            return None
        return {"toks": toks, "ints": ints, "flags": flags, "plan": plan}

    def _finish_chunk_plan(self, plan: dict, now: int) -> None:
        """Advance the cursors after the chunk dispatch. A row whose final
        chunk just shipped becomes live: its cursor drops (the readback
        consumer may retire it again) and its epoch moves on, so packets of
        earlier dispatches can never retire it."""
        for row, cur, take, fin in plan["plan"]:
            if not cur.started:
                cur.started = True
                cur.req.start_slot = now
            cur.off += take
            if fin:
                del self._cursors[row]
                self._row_epoch[row] += 1
                self.slot_age[row] = 1
                self._on_activate(row, cur, now)

    def _chunk_decode_sync(self, plan: dict, n_steps: int):
        """ONE mixed dispatch: the rows' prompt chunks (K/V written at
        [pos0, pos0 + valid)), device-side activation of the rows finishing
        their prompt, then the n-step sync-free decode. Rows mid-prompt
        carry done, so the decode freezes their pos; their one masked write
        (a dummy token's K/V at the next chunk offset) is overwritten by
        that chunk before anything attends it."""
        dev = self.device
        toks = host_to_device(plan["toks"], dev)
        ints = host_to_device(plan["ints"], dev)
        flags = host_to_device(plan["flags"], dev)
        pos0, valid, budgets = ints[0], ints[1], ints[2]
        writes = A.chunk_write_targets(plan["ints"][0], plan["ints"][1],
                                       self.ecfg.cache_len, dev)
        logits, state = M.chunk_step(self.model, self.state, toks, pos0, valid,
                                     flags[0], writes)
        sync = _sync_activate(self.sync, logits, flags[1], budgets, self.ecfg.eos_id)
        return _decode_n_sync(self.model, state, sync, n_steps, self.ecfg.shape_window,
                              self.ecfg.eos_id)

    def step_slot_chunked(self, now: int, n_steps: int = 1) -> dict:
        """One continuous-batching control slot: admission (host bookkeeping
        only) -> ONE mixed dispatch of per-row prompt chunks and the fused
        sync-free decode -> the counter copy, consumed a slot later.

        A slot costs exactly one dispatch whatever the prompt lengths, and
        a long prompt adds at most ``chunk_budget`` prefill tokens to any
        slot, so in-flight decodes never stall behind it. First tokens stay
        on the device (``_sync_activate``).
        """
        self._require_chunked()
        prev, self._pending_read = self._pending_read, None
        admitted = self._admit_chunked(now)
        plan = self._chunk_plan(n_steps)
        n_active = sum(r is not None for r in self.active)
        if plan is not None:
            self.state, self.sync, served_steps = self._chunk_decode_sync(plan, n_steps)
            self.decode_dispatches += 1
            self._finish_chunk_plan(plan, now)
            self._post_readback(now, served_steps)
        elif n_active:
            self.state, self.sync, served_steps = _decode_n_sync(
                self.model, self.state, self.sync, n_steps, self.ecfg.shape_window,
                self.ecfg.eos_id)
            self.decode_dispatches += 1
            self._post_readback(now, served_steps)
        served_prev, per_step_prev = self._consume_read(prev)
        self.served_history.append(served_prev)
        self.steps += n_steps
        return self._slot_stats(n_active, served_prev, served_per_step=per_step_prev,
                                admitted=admitted)


_ITEM8 = "ROADMAP.md queue 1 item 8 (prefix sharing)"
_ITEM9 = "ROADMAP.md queue 1 item 9 (quantized KV pages)"
_ITEM6 = ("ROADMAP.md queue 1 item 6 (the paged sync-free loop and paged chunked "
          "batching)")


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
    the signal ``MemoryAware`` prices.

    Under a quantized ``kv_precision`` the pool has a quantized region
    (``quant_pages``): its pages hold int8 or fp8 codes with per-token-
    per-head scales, written by quantizing the K/V rows bound there.
    Prefill still runs at native storage (the model's own dense caches),
    and the page copy quantizes the blocks that land in the quantized
    region. New admissions draw pages from the region named by
    ``admit_precision`` ("native" or the quantized tag), which the
    ``PrecisionAware`` scheduler sets between slots; a row grows inside its
    own region, and a preempted request is re-admitted wherever
    ``admit_precision`` points then. ``quant_occupancy()`` is the
    quantized region's fill, the signal ``PrecisionAware`` prices.

    The port serves greedy and fused, without prefix sharing; the other
    paths raise NotImplementedError naming the ROADMAP.md item that brings
    them.
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
        if kvp.is_cast:
            raise NotImplementedError(
                f"unscaled KV storage casts ({kvp.tag!r}) are not ported yet; see {_ITEM9}")
        # the quantized region: the top quant_pages ids of the pool; -1 means
        # every page under a quantized precision and none otherwise
        qp = ecfg.quant_pages
        if qp < 0:
            qp = ecfg.num_pages if kvp.is_quantized else 0
        if qp and not kvp.is_quantized:
            raise ValueError(f"quant_pages={qp} needs a quantized kv_precision, "
                             f"got {kvp.tag!r}")
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
        self.pools = T.paged_pools_init(cfg, ecfg.num_pages, ps, self.device,
                                        native_pages=ecfg.num_pages - qp)
        self.allocator = PageAllocator(ecfg.num_pages, ps, quant_pages=qp,
                                       quant_precision=kvp.tag if qp else "int8")
        # the region new admissions draw pages from: the PrecisionAware
        # scheduler's lever, which the serve loop sets between slots
        self.admit_precision = "native" if qp < ecfg.num_pages else kvp.tag
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
        self.readback_waits = 0
        self.peak_active = 0
        self._init_sync_free(R)
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
            pages_quant=st.quant_pages,
            pages_quant_used=st.quant_used_pages,
            quant_occupancy=st.quant_occupancy,
        )
        return c

    def _slot_stats(self, n_active: int, served: int, **extra) -> dict:
        d = super()._slot_stats(n_active, served, **extra)
        d["occupancy"] = self.occupancy()
        d["preemptions"] = self.preemptions
        return d

    def occupancy(self) -> float:
        return self.allocator.occupancy()

    def quant_occupancy(self) -> float:
        """In-use fraction of the quantized page region (0.0 without one):
        the signal ``PrecisionAware`` prices."""
        return self.allocator.quant_occupancy()

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
            pages = self.allocator.alloc(row, min(L + lookahead, self.MP * ps),
                                         precision=self.admit_precision)
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
