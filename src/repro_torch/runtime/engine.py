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
dispatch, exactly where the reference counts them. On the card the fused
decode of ``step_slot`` and ``step_slot_sync`` (dense and paged) is one
CUDA graph, replayed once per slot (``runtime/graph.py``), as the
reference's is one jitted scan. ``warm_decode``, which the serve loop calls
before its first slot, runs the decode once over the free rows and
captures it there; a decode never warmed is captured at its first
dispatch, whose blocking syncs then count the capture's device
synchronize. The chunked loops' mixed dispatch (prompt chunks, activation
and decode) is one graph too, its write targets computed on the device at
a fixed shape; a chunked slot with no chunk to run replays the sync-free
decode's graph.

Per-request sampling (``runtime/sampling.py``) runs inside the same
dispatches: a request's ``SamplingParams`` (or the engine's default) enter
as per-row tables, the first token at admission or activation and every
decode step draw with the reference's request-keyed threefry keys. An
all-greedy batch runs today's argmax graphs bit for bit; a batch with a
sampled row runs a second graph per mode ("fused+s", "sync+s",
"chunk+s").

Admission on a dense attention stack buckets prompts into power-of-two
sub-buckets (P/4, P/2, P) of ``prompt_len`` and passes per-row real lengths
to the length-aware prefill: logits come from each row's real last token,
decode resumes at pos = len, and cache slots beyond len stay empty. A
recurrent (Mamba-2 or hybrid RG-LRU) stack integrates every position, so
its admission runs the padded prefill over the full ``prompt_len`` bucket,
as the reference's does: a short prompt's state runs through the PAD_ID
pads and its first token is predicted after the last pad (ROADMAP R7). The
boot prefill is always padded.

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

``PagedEngine`` serves the fused, sync-free and chunked loops from one
shared pool of KV pages: admission allocates pages, page growth and
preempt-and-recompute keep the decode covered, retirement frees the pages,
and prefix sharing maps resident prompt prefixes onto shared pages (see
its docstring).

Observability (``repro_torch.obs``). An engine holds an ``Observability``
bundle (``obs``, default ``OBS_OFF``) and the trace pid it records under
(``obs_pid``, the replica index a fleet stamps). The request lifecycle is
recorded as the reference records it: arrival, admission, chunk,
activation, preemption, raced_hit and retirement events, a ``dispatch``
span per admission, decode, mixed or fork dispatch (the host's enqueue
time of the graph replay, on the host clock) and the readback's initiate
and consume. Every emit sits on the host, around the dispatch and outside
the bodies the engine captures as graphs, so a replay records exactly what
an eager dispatch does, and the warm-ups and captures of ``warm_decode``
record nothing. ``export_metrics`` publishes ``counters()``, host integers
all, into the bundle's registry. With the bundle off every site costs one
branch; on or off, no token changes, and the telemetry reads nothing back
from the card.

Fault injection (``repro_torch.reliability.chaos``) arms an engine through
``_chaos`` (readback delays and hangs, ``_post_readback``) and, on the
paged engine, a forwarding allocator whose calls can fail.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.cache import PageAllocator, PrefixIndex, pages_for, resolve_kv_precision
from repro_torch.device import host_to_device
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.obs import OBS_OFF
from repro_torch.runtime.graph import DecodeGraph, _on_device
from repro_torch.runtime.request import Request
from repro_torch.runtime.sampling import RowSampling, SamplingParams, row_tables, sample_rows

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
    seed: int = 0                 # the sampling seed of params that set none
    # the engine-wide default SamplingParams of requests that carry none
    # (request.sampling always wins); None serves them greedily
    sampling: Optional[SamplingParams] = None
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
    # KV storage: "" (the model config's) / "native" / "int8" / "fp8": the
    # dense ring, or the paged engine's quantized page region, holds codes
    # with per-token-per-head scales
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
    ``prefix_sharing`` shares resident prompt pages between requests
    through a ``PrefixIndex``.
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


def _next_tokens(logits: torch.Tensor, samp: Optional[RowSampling],
                 ages: Optional[torch.Tensor] = None, gen: Optional[torch.Tensor] = None,
                 gen_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row: the argmax, or with ``samp`` each row's sampler
    at ``ages`` over the history ``gen[:, :gen_len]`` (a first token: age
    0, no history)."""
    if samp is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if ages is None:
        ages = torch.zeros(logits.shape[0], dtype=torch.int32, device=logits.device)
    return sample_rows(logits, samp, ages, gen, gen_len)


def _first_tokens(logits: torch.Tensor, budgets: torch.Tensor, eos_id: Optional[int],
                  samp: Optional[RowSampling] = None):
    """First tokens of newly activated rows (argmax, or each row's sampler
    at age 0 with no history) and whether each finished with it (a budget
    of 1, or EOS)."""
    first = _next_tokens(logits, samp)
    fin = budgets <= 1
    if eos_id is not None:
        fin = fin | (first == eos_id)
    return first, fin


def _sync_admit(sync: SyncState, logits: torch.Tensor, rows: torch.Tensor,
                budgets: torch.Tensor, keep: torch.Tensor, eos_id: Optional[int],
                samp: Optional[RowSampling] = None) -> SyncState:
    """Device-side admission at a fixed shape: the first token of every
    prefill row j (``samp`` aligned with the prefill rows) and the sync
    state of engine row rows[j] reset to it where ``keep[j]`` (an
    admitted row), with no logits readback. ``rows`` (B,) never repeats:
    a pad row targets a row not being admitted, which keeps its state
    (gathered, selected and scattered back, ``attention._masked_put``)."""
    first, fin = _first_tokens(logits, budgets, eos_id, samp)
    at = (rows,)
    for t, new in ((sync.cur_tok, first), (sync.age, torch.ones_like(first)),
                   (sync.budget, budgets), (sync.done, fin)):
        A._masked_put(t, at, new, keep)
    A._masked_put(sync.gen_buf, (rows, torch.zeros_like(rows)), first, keep)
    return sync


def _sync_activate(sync: SyncState, logits: torch.Tensor, final: torch.Tensor,
                   budgets: torch.Tensor, eos_id: Optional[int],
                   samp: Optional[RowSampling] = None) -> SyncState:
    """Device-side activation of the rows whose final prompt chunk ran in
    this dispatch: their first token comes from the chunk's last-token
    logits, masked into the sync state, with no logits readback."""
    first, fin = _first_tokens(logits, budgets, eos_id, samp)
    zero = torch.zeros_like(sync.age)
    return SyncState(
        cur_tok=torch.where(final, first, sync.cur_tok),
        age=torch.where(final, 1, sync.age),
        budget=torch.where(final, budgets, sync.budget),
        done=torch.where(final, fin, sync.done),
        gen_buf=_ring_write(sync.gen_buf, zero, final, first))


def _decode_n_sync(step, state, sync: SyncState, n: int, eos_id: Optional[int],
                   samp: Optional[RowSampling] = None):
    """Sync-free fused decode: selection, EOS and the ring buffer stay on
    the device; ``step(state, tokens) -> (logits, state)`` is one decode
    step of the engine (dense or paged). With ``samp`` each row samples at
    its age, its penalties reading the ring (``age`` tokens are live
    there). Rows whose stop mask latched keep computing (masked) but stop
    advancing: their pos freezes, so a finished row rewrites its own last
    cache slot (a paged row's write targets follow that pos on the
    device). Returns (state, sync, served per step (n,) int32)."""
    served = []
    for _ in range(n):
        logits, nstate = step(state, sync.cur_tok)
        nxt = _next_tokens(logits, samp, sync.age, sync.gen_buf, sync.age)
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


def _decode_one(model, state, toks, shape_window, samp: Optional[RowSampling] = None,
                ages=None, hist=None):
    logits, state = M.decode_step(model, state, toks, shape_window=shape_window)
    return _next_tokens(logits, samp, ages, hist, ages), state


def _decode_scan(step, state, toks, n, samp: Optional[RowSampling] = None,
                 ages=None, hist=None):
    """n fused decode steps, ``step(state, tokens) -> (logits, state)``;
    per-step tokens (n, B). With ``samp`` each step samples at ``ages``
    over the host-built history ``hist`` (B, cap), and writes its token
    into ``hist`` at ``ages % cap``, so a later step's penalties see the
    tokens drawn earlier in the dispatch."""
    outs = []
    for _ in range(n):
        logits, state = step(state, toks)
        toks = _next_tokens(logits, samp, ages, hist, ages)
        if samp is not None:
            hist = hist.scatter(1, (ages % hist.shape[1]).long()[:, None], toks[:, None])
            ages = ages + 1
        outs.append(toks)
    return torch.stack(outs), state


def _decode_n(model, state, toks, n, shape_window, samp=None, ages=None, hist=None):
    """n fused decode steps over the dense caches; per-step tokens (n, B)."""
    step = lambda st, tk: M.decode_step(model, st, tk, shape_window=shape_window)
    return _decode_scan(step, state, toks, n, samp, ages, hist)


def _decode_n_paged(model, state, toks, n, samp=None, ages=None, hist=None):
    """n fused decode steps over the paged pools; per-step tokens (n, B)."""
    step = lambda st, tk: M.decode_step_paged(model, st, tk)
    return _decode_scan(step, state, toks, n, samp, ages, hist)


def _admit_mode(sync: bool, sampled: bool, bucket: int) -> str:
    """The admission graph's mode: its loop, variant and prompt bucket."""
    return ("sync-prefill" if sync else "prefill") + ("+s" if sampled else "") + f"/{bucket}"


def _tables(extra: tuple) -> Optional[RowSampling]:
    """A graph body's sampling tables from its trailing inputs (none: the
    greedy graph)."""
    return RowSampling(*extra) if extra else None


def _scan_samp(extra: tuple) -> tuple:
    """The fused scan's sampling arguments (samp, ages, hist) from its
    extra inputs (ages, hist, *tables); () for the greedy scan."""
    return (_tables(extra[2:]), *extra[:2]) if extra else ()


def _leaves(caches) -> list:
    """The tensors of a cache or pool (a NamedTuple of tensors, None where
    a leaf is absent), of a hybrid group's dict of them, or of a list of
    any of these, depth first: the same order for two caches of one
    structure."""
    if isinstance(caches, torch.Tensor):
        return [caches]
    if isinstance(caches, dict):
        caches = caches.values()
    elif not isinstance(caches, (tuple, list)):
        return []   # an absent leaf (None)
    return [t for c in caches for t in _leaves(c)]


def _splice_one(state: M.DecodeState, one: M.DecodeState, slot: int) -> M.DecodeState:
    """Insert batch-1 prefill state into the batch state at ``slot``, in
    place. Every cache leaf (KVCache, SSMState, RecState, nested in a
    hybrid group's dict or not) has the layer axis first and the batch axis
    second; a KVCache's absent leaves (None: the scales and staging buffers
    at native precision) are skipped."""
    for a, b in zip(_leaves(state.caches), _leaves(one.caches), strict=True):
        A.as_bytes(a)[:, slot] = A.as_bytes(b)[:, 0]
    state.pos[slot] = one.pos[0]
    state.last_tok[slot] = one.last_tok[0]
    return state


def _splice_many(state: M.DecodeState, new: M.DecodeState, targets: torch.Tensor,
                 keep: torch.Tensor) -> M.DecodeState:
    """Insert the prefill rows into the batch state, in place, at a fixed
    shape: prefill row j goes to engine row targets[j] where ``keep[j]``
    (an admitted row). ``targets`` (B,) int64 is a permutation of the
    engine rows: a pad row targets a row not being admitted, which is
    gathered, selected and scattered back unchanged
    (``attention._masked_put``), so no index repeats and nothing is read
    back to the host. Covers every cache leaf (KVCache codes, scales and
    staging buffers; SSMState; RecState; a hybrid group's nested ones),
    ``pos`` and ``last_tok``."""
    lead = keep[None]   # every cache leaf has the layer axis first
    for a, b in zip(_leaves(state.caches), _leaves(new.caches), strict=True):
        A._masked_put(a, (slice(None), targets), b, lead)
    A._masked_put(state.pos, (targets,), new.pos, keep)
    A._masked_put(state.last_tok, (targets,), new.last_tok, keep)
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

    def __init__(self, model: M.Model, ecfg: EngineConfig, obs=None):
        cfg = model.cfg
        T.check_servable(cfg)
        if ecfg.kv_precision:
            cfg = cfg.replace(kv_precision=ecfg.kv_precision)
        # one resolution point: warns (once per dtype) when only the
        # deprecated cache_dtype is set, as the reference's engine does
        self.kvp = resolve_kv_precision(cfg.kv_precision, cfg.cache_dtype)
        self.cfg, self.model, self.ecfg = cfg, model, ecfg
        self._init_obs(obs)
        self._init_sampling(ecfg)
        # every prefill builds the dense ring at the engine's precision (a
        # quantized one holds codes and scales, a cast one the cast values,
        # which the decode reads)
        self._prefill_kv = cfg.kv_precision
        self.device = model.device
        B, P = ecfg.batch_slots, ecfg.prompt_len
        self._buckets = _prompt_buckets(P)
        self._gen_cap = ecfg.gen_buf_len or ecfg.cache_len

        # boot: empty batch state from a dummy prefill over the whole batch
        boot = torch.zeros((B, P), dtype=torch.int32, device=self.device)
        _, self.state = M.prefill(model, boot, ecfg.cache_len,
                                  shape_window=ecfg.shape_window,
                                  kv_precision=self._prefill_kv)
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

    def _init_obs(self, obs) -> None:
        """The observability bundle (``OBS_OFF`` when none), the trace pid,
        the current control slot for the emits that run below the slot's
        entry point, and the fault-injection seam."""
        self.obs = obs or OBS_OFF
        self.obs_pid = 0          # replica index (a fleet stamps it)
        self._now = 0
        self._chaos = None        # an armed ChaosInjector

    def _init_sync_free(self, rows: int) -> None:
        self._graphs: dict = {}       # dispatch mode -> its DecodeGraph
        self._prefill_pool = None     # the admission graphs' shared memory pool
        self.warmup_dispatches = 0    # dispatches warm_decode ran before serving
        self.prefill_warmups = 0      # of them, admissions
        self._warming = False
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
        tr = self.obs.trace
        if tr.enabled:
            for r in reqs:
                tr.emit("arrival", slot=r.arrival_slot, rid=r.rid, pid=self.obs_pid,
                        prompt_len=len(r.tokens))
        self.pending.extend(reqs)

    # ------------------------------------------------ per-request sampling
    def _init_sampling(self, ecfg: EngineConfig) -> None:
        """Resolve the engine-default SamplingParams once."""
        default = ecfg.sampling
        if default is not None and default.is_pure_greedy:
            default = None
        self._default_samp = default
        self.requests_sampled = 0   # admissions of requests that sample

    def _effective(self, req: Request) -> Optional[SamplingParams]:
        """The params governing a request: its own, else the engine's
        default; None is the argmax path, so greedy traffic never pays for
        the sampler."""
        p = req.sampling if req.sampling is not None else self._default_samp
        if p is None or p.is_pure_greedy:
            return None
        return p

    def _resolve_rows(self, reqs) -> list:
        """Per-row ``(params, rid)`` entries (None: a greedy or empty row)."""
        out = []
        for r in reqs:
            e = self._effective(r) if r is not None else None
            out.append((e, r.rid) if e is not None else None)
        return out

    def _samp_args(self, force: Optional[bool] = None, rows=None) -> tuple:
        """The sampled graphs' extra inputs over ``rows`` (requests, None
        for an empty or pad row; default the active rows): the host tables,
        or () when no row samples (the greedy graph, bit for bit today's).
        ``force`` picks the variant regardless (the warm-up)."""
        resolved = self._resolve_rows(self.active if rows is None else rows)
        sampled = any(e is not None for e in resolved) if force is None else force
        return tuple(row_tables(resolved, self.ecfg.seed)) if sampled else ()

    def _samp_decode_args(self, force: Optional[bool] = None) -> tuple:
        """The fused path's extra inputs: (ages, hist, *tables), ages each
        row's generated-token count and hist its generated tokens (the
        penalties' history; admission keeps max_new_tokens within its
        capacity), or () when no row samples."""
        tables = self._samp_args(force)
        if not tables:
            return ()
        B, cap = len(self.active), self._gen_cap
        ages = np.zeros(B, np.int32)
        hist = np.zeros((B, cap), np.int32)
        for row, r in enumerate(self.active):
            if r is None or not r.generated:
                continue
            g = r.generated[-cap:]
            hist[row, : len(g)] = g
            ages[row] = len(r.generated)
        return (ages, hist, *tables)

    def _validate_sampled(self, req: Request) -> None:
        """A sampled request must fit the generated-token history on every
        path: its penalties read it, so overflowing it would change the
        stream."""
        if self._effective(req) is not None and req.max_new_tokens > self._gen_cap:
            raise ValueError(
                f"request {req.rid}: max_new_tokens {req.max_new_tokens} "
                f"exceeds the sampled-request history capacity {self._gen_cap} "
                "(gen_buf_len)")

    def _emit_admission(self, req: Request, row: int, now: int) -> None:
        """Stamp the engine claim (preemption clears it; the re-claim
        stamps it again), count a request that samples and record the
        admission."""
        req.admit_slot = now
        if self._effective(req) is not None:
            self.requests_sampled += 1
        tr = self.obs.trace
        if tr.enabled:
            tr.emit("admission", slot=now, rid=req.rid, row=row, pid=self.obs_pid)

    def _emit_retire(self, req: Request, row: int, slot: int) -> None:
        tr = self.obs.trace
        if tr.enabled:
            tr.emit("retirement", slot=slot, rid=req.rid, row=row, pid=self.obs_pid,
                    tokens=len(req.generated or ()))

    def _span(self) -> float:
        """A dispatch span's start on the trace clock (0.0 when off)."""
        tr = self.obs.trace
        return tr.now() if tr.enabled else 0.0

    def _emit_dispatch(self, t0: float, slot: int, what: str, **args) -> None:
        """The host's enqueue span of one dispatch, from ``t0``
        (``_span``): the graph replay's launch, not its device time."""
        tr = self.obs.trace
        if tr.enabled:
            tr.emit("dispatch", slot=slot, pid=self.obs_pid, ts=t0, dur=tr.now() - t0,
                    what=what, **args)

    def export_metrics(self, labels: Optional[dict] = None) -> None:
        """Publish ``counters()`` into the obs registry (a no-op without
        one)."""
        self.obs.export(self.counters(), labels)

    def counters(self) -> dict:
        """The reference engine's counter/gauge surface. The paged and
        prefix keys stay 0 on this engine."""
        return {
            "steps": self.steps,
            "requests_finished": len(self.finished),
            "requests_active": sum(r is not None for r in self.active),
            "requests_pending": len(self.pending),
            "requests_prefilling": len(self._cursors),
            "requests_sampled": self.requests_sampled,
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

    def _prefill(self, toks, lens, cache_len: Optional[int] = None):
        """One bucketed prefill over host arrays or device tensors:
        length-aware on a dense attention stack, padded otherwise (``lens``
        unused)."""
        dev = self.device
        return M.prefill(self.model, _on_device(toks, dev), cache_len or self.ecfg.cache_len,
                         shape_window=self.ecfg.shape_window,
                         prompt_lens=_on_device(lens, dev) if self._ragged else None,
                         kv_precision=self._prefill_kv)

    def _admit_one(self, req: Request, slot: int, now: int) -> None:
        """Legacy batch-1 admission (the fused path's equivalence oracle)."""
        self._validate_sampled(req)
        P = self.ecfg.prompt_len
        L = max(1, min(len(req.tokens), P))
        bucket = self._pick_bucket(L)
        logits, one = self._prefill(self._bucket(req.tokens, req, bucket)[None, :],
                                    np.asarray([L], np.int32))
        self.prefill_dispatches += 1
        self.state = _splice_one(self.state, one, slot)
        self.blocking_syncs += 1
        req.start_slot = now
        req.first_token_slot = now   # first token came from this prefill
        tables = self._samp_args(rows=[req])
        samp = RowSampling(*tables).to(self.device) if tables else None
        req.generated = [int(_next_tokens(logits[:1], samp)[0])]
        self.active[slot] = req
        self.slot_age[slot] = 1
        self._emit_admission(req, slot, now)

    def admit_pending(self, now: int, sync: bool = False) -> int:
        """Fill all free slots from the pending queue with ONE prefill
        dispatch (``_admit_graphed``: one CUDA graph replay per bucket on
        the card).

        The prefill batch is padded to the full batch_slots rows (pad rows
        write nothing: the splice keeps their target rows as they were)
        and, on a dense attention stack, to the smallest power-of-two
        prompt bucket covering the admitted lengths (else to
        ``prompt_len``). ``sync=True`` computes the first tokens on the
        device (``_sync_admit``) instead of reading them back. Returns k.
        """
        B, P = self.ecfg.batch_slots, self.ecfg.prompt_len
        slots = self.free_slots()[: len(self.pending)]
        if not slots:
            return 0
        for r in self.pending[: len(slots)]:   # before popping: a raise drops nothing
            if sync:
                self._validate_gen_cap(r)
            self._validate_sampled(r)
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
        adm = self._admission_table(slots, [r.max_new_tokens for r in reqs])
        t0 = self._span()
        (pos, last), first = self._admit_graphed(bucket, sync, toks, lens, adm,
                                                 (self.state.pos, self.state.last_tok),
                                                 self._samp_args(rows=reqs + [None] * (B - k)))
        self.state = self.state._replace(pos=pos, last_tok=last)
        self.prefill_dispatches += 1
        self._emit_dispatch(t0, now, "prefill", rows=k)
        if sync:
            for req, slot in zip(reqs, slots, strict=True):
                req.start_slot = now
                req.first_token_slot = now
                req.generated = None   # filled from the device ring at retirement
                self.active[slot] = req
                self.slot_age[slot] = 1
                self._row_epoch[slot] += 1
                self._emit_admission(req, slot, now)
            return k
        self.blocking_syncs += 1
        first = first.cpu().numpy()[:k]
        for j, (req, slot) in enumerate(zip(reqs, slots, strict=True)):
            req.start_slot = now
            req.first_token_slot = now
            req.generated = [int(first[j])]
            self.active[slot] = req
            self.slot_age[slot] = 1  # first token came from prefill
            self._emit_admission(req, slot, now)
        return k

    # ------------------------------------------------- graphed admission
    def _admission_table(self, rows: list, budgets: list) -> np.ndarray:
        """The admission's (3, B) int64 table: each prefill row's target
        engine row (the admitted rows' own, then, for the pad rows, the
        rows not being admitted, so no target repeats), its budget and
        whether it is admitted."""
        n, k = len(self.active), len(rows)
        adm = np.zeros((3, n), np.int64)
        taken = set(rows)
        adm[0] = list(rows) + [r for r in range(n) if r not in taken]
        adm[1, :k] = budgets
        adm[2, :k] = 1
        return adm

    def _prefill_splice(self, bucket: int, toks, lens, targets, keep, pos, last_tok):
        """The dense admission's device work: the bucketed prefill, then its
        rows spliced into the batch state where ``keep``. Returns (logits,
        the new pos and last_tok)."""
        logits, new = self._prefill(toks, lens)
        st = _splice_many(self.state._replace(pos=pos, last_tok=last_tok), new, targets, keep)
        return logits, (st.pos, st.last_tok)

    def _admit_graphed(self, bucket: int, sync: bool, toks, lens, adm, spec: tuple,
                       tables: tuple) -> tuple:
        """ONE admission dispatch through the graph of its loop and bucket
        ("prefill/<bucket>", "sync-prefill/<bucket>", "+s" with sampling
        tables): the prefill, the splice (``_prefill_splice``; ``spec`` are
        its engine's own inputs) and the first tokens, every shape fixed by
        the bucket and the batch. Inputs: toks (B, bucket), lens (B,), the
        admission table ``adm`` (``_admission_table``), ``spec``, the sync
        state (``sync``) and the tables. Returns (spec's new values, the
        first tokens (B,) on the device, or None when ``sync``: the
        sync-free loop keeps them in the sync state)."""
        eos, n_spec = self.ecfg.eos_id, len(spec)

        def body(toks, lens, adm, *rest):
            targets, keep = adm[0], adm[2] > 0
            logits, new_spec = self._prefill_splice(bucket, toks, lens, targets, keep,
                                                    *rest[:n_spec])
            rest = rest[n_spec:]
            if not sync:
                first = _next_tokens(logits, _tables(rest))
                return (toks, lens, adm, *new_spec, *rest), (first,)
            sy = _sync_admit(SyncState(*rest[:5]), logits, targets, adm[1].to(torch.int32), keep,
                             eos, _tables(rest[5:]))
            return (toks, lens, adm, *new_spec, *sy, *rest[5:]), ()
        (_, _, _, *rest), outs = self._graphed(
            _admit_mode(sync, bool(tables), bucket), bucket, body,
            (toks, lens, adm, *spec, *(self.sync if sync else ()), *tables), self._cache_leaves())
        if sync:
            self.sync = SyncState(*rest[n_spec:n_spec + 5])
        return tuple(rest[:n_spec]), (outs[0] if outs else None)

    def _cache_leaves(self) -> list:
        """The cache tensors every dispatch writes in place (a graph's
        ``fixed``)."""
        return _leaves(self.state.caches)

    def _idle_spec(self, bucket: int) -> tuple:
        """``_prefill_splice``'s own inputs for an all-pad admission."""
        return self.state.pos, self.state.last_tok

    def _warm_prefill(self, bucket: int, sync: bool, sampled: bool) -> None:
        """An all-pad admission of ``bucket``: it writes nothing into any
        row (the warm-up and capture of its graph)."""
        B = len(self.active)
        self._admit_graphed(bucket, sync, np.zeros((B, bucket), np.int32),
                            np.full(B, bucket, np.int32), self._admission_table([], []),
                            self._idle_spec(bucket), self._samp_args(sampled, [None] * B))

    def _retire(self, i: int, r: Request, now: int) -> None:
        r.finish_slot = now
        self.finished.append(r)
        self.active[i] = None
        self._emit_retire(r, i, now)

    def _release_row(self, row: int) -> None:
        """Give up what a row holds beyond its request (a paged row's
        pages; the fleet's failure path): nothing on the dense engine."""

    def step(self, now: int) -> dict:
        """Legacy engine slot: admit one-by-one -> one decode -> retire."""
        self._now = now
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
            extra = [host_to_device(a, self.device) for a in self._samp_decode_args()]
            t0 = self._span()
            nxt, self.state = _decode_one(self.model, self.state, toks,
                                          self.ecfg.shape_window, *_scan_samp(extra))
            self.decode_dispatches += 1
            self.blocking_syncs += 1
            self._emit_dispatch(t0, now, "decode", n=1)
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
        self._now = now
        admitted = self.admit_pending(now)
        n_active = sum(r is not None for r in self.active)
        per_step = [0] * n_steps
        if n_active:
            toks = np.asarray([r.generated[-1] if r else 0 for r in self.active], np.int32)
            t0 = self._span()
            all_toks = self._decode_fused(toks, n_steps)
            self.decode_dispatches += 1
            self.blocking_syncs += 1
            self._emit_dispatch(t0, now, "decode", n=n_steps)
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

    # ------------------------------------------------- graphed decodes
    def _graphed(self, mode: str, key: int, body, inputs: tuple, fixed: list) -> tuple:
        """One dispatch of ``mode`` through its DecodeGraph: captured at its
        first call and replayed after it on the card, eager on the CPU or
        with ``DecodeGraph.enabled`` off. ``key`` is what the body was
        built for: a decode's step count, an admission's bucket. A sampled
        variant is a mode of its own ("+s"). The admission graphs of one
        engine share one memory pool (``runtime/graph.py``)."""
        g = self._graphs.get(mode)
        if g is None:
            pool = None
            if "prefill" in mode and self.device.type == "cuda" and DecodeGraph.enabled:
                if self._prefill_pool is None:
                    self._prefill_pool = torch.cuda.graph_pool_handle()
                pool = self._prefill_pool
            g = self._graphs[mode] = DecodeGraph(mode, self.device, pool=pool)
        if g.capture and g.graph is None and not self._warming:
            self.blocking_syncs += 1   # a capture mid-serve synchronizes the device
        return g(body, inputs, fixed=fixed, key=key)

    def _warm_buckets(self) -> list:
        """The prompt buckets an admission can pick (``_pick_bucket``)."""
        return list(self._buckets) if self._ragged else [self.ecfg.prompt_len]

    def warm_decode(self, n_steps: int, sync: bool = False, chunked: bool = False) -> None:
        """Before serving, on the card: run each dispatch the loop will
        replay once and, with graphs on, capture it, so no slot pays the
        first use's builds or the capture's device synchronize. The fused
        loop has its "fused" decode and an admission graph per prompt
        bucket ("prefill/<bucket>"), the sync-free one its "sync" decode and
        "sync-prefill/<bucket>", the chunked one its "chunk" dispatch (an
        all-idle plan: every row's valid 0) and the "sync" decode its slots
        without a chunk run. With an engine-default SamplingParams the
        sampled variants ("+s") are warmed too. A decode warm-up runs over
        the free rows, and positions, tokens and the sync state are put
        back; the caches and recurrent states it wrote belong to free rows,
        which admission overwrites (or, chunked, a first chunk resets), as
        every decode does to the rows it runs free. An admission warm-up is
        all pad rows and writes nothing into any row (the paged engine's
        pad blocks land on the scratch pages). Each counts in
        ``warmup_dispatches`` (admissions also in ``prefill_warmups``). A
        no-op on the CPU and for a mode that has run; raises while a row is
        active."""
        if self.device.type != "cuda":
            return
        if chunked:
            self._require_chunked()   # the reference's ValueError, before any capture
            decodes, buckets = ("chunk", "sync"), []
        else:
            decodes, buckets = ("sync" if sync else "fused",), self._warm_buckets()
        variants = (False, True) if self._default_samp is not None else (False,)
        todo = [(m, None, s) for m in decodes for s in variants
                if m + ("+s" if s else "") not in self._graphs]
        todo += [(None, b, s) for b in buckets for s in variants
                 if _admit_mode(sync, s, b) not in self._graphs]
        if not todo:
            return
        if any(r is not None for r in self.active):
            raise RuntimeError("warm_decode runs before any row is admitted")
        saved = self.__dict__.get("state"), self.sync
        self._warming = True
        try:
            for mode, bucket, sampled in todo:
                if bucket is not None:
                    self._warm_prefill(bucket, sync, sampled)
                    self.prefill_warmups += 1
                elif mode == "chunk":
                    self._chunk_decode_sync(self._idle_plan(), n_steps, sampled=sampled)
                elif mode == "sync":
                    self._decode_sync(n_steps, sampled=sampled)
                else:
                    self._decode_fused(np.zeros(len(self.active), np.int32), n_steps,
                                       sampled=sampled)
                self.warmup_dispatches += 1
        finally:
            self._warming = False
            if saved[0] is not None:
                self.state = saved[0]
            self.sync = saved[1]

    @property
    def graph_replays(self) -> int:
        """Dispatches that ran as a replay of a captured graph."""
        return sum(g.replays for g in self._graphs.values())

    @property
    def prefill_replays(self) -> int:
        """Admission dispatches that ran as a graph replay."""
        return sum(g.replays for m, g in self._graphs.items() if "prefill" in m)

    def _decode_fused(self, toks: np.ndarray, n: int,
                      sampled: Optional[bool] = None) -> torch.Tensor:
        """The fused path's n steps from the host's last tokens; per-step
        tokens (n, B) on the device. ``sampled`` forces the variant."""
        sw = self.ecfg.shape_window
        extra = self._samp_decode_args(sampled)

        def body(pos, last_tok, toks, *extra):
            out, st = _decode_n(self.model, self.state._replace(pos=pos, last_tok=last_tok),
                                toks, n, sw, *_scan_samp(extra))
            return (st.pos, st.last_tok, toks, *extra), (out,)
        (pos, last, *_), (all_toks,) = self._graphed(
            "fused+s" if extra else "fused", n, body,
            (self.state.pos, self.state.last_tok, toks, *extra), _leaves(self.state.caches))
        self.state = self.state._replace(pos=pos, last_tok=last)
        return all_toks

    def _decode_sync(self, n: int, sampled: Optional[bool] = None) -> torch.Tensor:
        """The sync-free path's n steps from the device-resident state;
        served per step (n,) int32 on the device. ``sampled`` forces the
        variant."""
        eos = self.ecfg.eos_id
        extra = self._samp_args(sampled)

        def body(pos, last_tok, *rest):
            st, sy, served = _decode_n_sync(
                self._decode_step, self.state._replace(pos=pos, last_tok=last_tok),
                SyncState(*rest[:5]), n, eos, _tables(rest[5:]))
            return (st.pos, st.last_tok, *sy, *rest[5:]), (served,)
        (pos, last, *rest), (served,) = self._graphed(
            "sync+s" if extra else "sync", n, body,
            (self.state.pos, self.state.last_tok, *self.sync, *extra), _leaves(self.state.caches))
        self.state = self.state._replace(pos=pos, last_tok=last)
        self.sync = SyncState(*rest[:5])
        return served

    # ------------------------------------------------- sync-free protocol
    def _decode_step(self, state, tokens: torch.Tensor):
        """One decode step of this engine's state: (logits, state)."""
        return M.decode_step(self.model, state, tokens, shape_window=self.ecfg.shape_window)

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
        tr = self.obs.trace
        if tr.enabled:
            tr.emit("readback", slot=now, pid=self.obs_pid, what="initiate")
        packet = {"slot": now, "arrays": host, "event": event, "epoch": self._row_epoch.copy()}
        if self._chaos is not None:   # fault injection: a delay or hang of its readiness
            packet = self._chaos.wrap_readback(packet)
        self._pending_read = packet

    def _readback_ready(self, p: dict) -> bool:
        """Non-blocking: has the packet's copy completed? An injected delay
        (``polls`` > 0, ``reliability.chaos``) reads not ready until its
        polls are spent, one per call; a hang (``polls`` < 0) never does."""
        polls = p.get("polls", 0)
        if polls:
            if polls > 0:
                p["polls"] = polls - 1
            return False
        return p["event"] is None or p["event"].query()

    def _await_readback(self, p: dict) -> None:
        """Wait for the packet's copy, polling its event for at most
        ``readback_timeout_s``; then raise ``ReadbackTimeout`` rather than
        hang on a wedged transfer. A bound <= 0 waits for the copy without
        one (an injected hang is then ignored). One event fences the
        packet's arrays; ``done`` is the first read."""
        if self._readback_ready(p):
            return
        ev = p["event"]
        timeout = self.ecfg.readback_timeout_s
        if timeout <= 0:
            if ev is not None:
                ev.synchronize()
            return
        deadline = time.monotonic() + timeout
        while not self._readback_ready(p):
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
        waited = count_waits and not self._readback_ready(p)
        if waited:
            self.readback_waits += 1
        self._await_readback(p)
        t0 = self._span()
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
        tr = self.obs.trace
        if tr.enabled:
            tr.emit("readback", slot=p["slot"], pid=self.obs_pid, ts=t0, dur=tr.now() - t0,
                    what="consume", retired=served, waited=waited)
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
        self._now = now
        prev, self._pending_read = self._pending_read, None
        admitted = self.admit_pending(now, sync=True)
        n_active = sum(r is not None for r in self.active)
        if n_active:
            t0 = self._span()
            served_steps = self._decode_sync(n_steps)
            self.decode_dispatches += 1
            self._emit_dispatch(t0, now, "decode", n=n_steps)
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
            self._validate_chunked(self.pending[0])   # raise before popping
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
            self._emit_admission(req, row, now)
            k += 1
        return k

    def _validate_chunked(self, req: Request) -> None:
        """Refuse a request the chunked path can never serve, before it is
        popped."""
        self._validate_gen_cap(req)

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
        ints = np.zeros((4, B), np.int32)        # pos0, valid, budgets, base
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
            # base: the pool-resident prefix (the staging split of a lossy pool)
            ints[:, row] = (cur.off, take, cur.req.max_new_tokens, cur.cached)
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
        tr = self.obs.trace
        for row, cur, take, fin in plan["plan"]:
            if not cur.started:
                cur.started = True
                cur.req.start_slot = now
            if tr.enabled:
                tr.emit("chunk", slot=now, rid=cur.req.rid, row=row, pid=self.obs_pid,
                        off=cur.off, take=take)
            cur.off += take
            if fin:
                del self._cursors[row]
                self._row_epoch[row] += 1
                self.slot_age[row] = 1
                self._on_activate(row, cur, now)
                if tr.enabled:
                    tr.emit("activation", slot=now, rid=cur.req.rid, row=row,
                            pid=self.obs_pid, cached=cur.cached)

    def _idle_plan(self) -> dict:
        """A chunk plan that runs no chunk (every row's valid 0): the
        mixed dispatch's warm-up and capture."""
        B = len(self.active)
        return {"toks": np.zeros((B, self._chunk), np.int32), "ints": np.zeros((4, B), np.int32),
                "flags": np.zeros((2, B), bool), "plan": []}

    def _chunk_decode_sync(self, plan: dict, n_steps: int,
                           sampled: Optional[bool] = None) -> torch.Tensor:
        """ONE mixed dispatch, one "chunk" graph replay on the card: the
        rows' prompt chunks (K/V written at [pos0, pos0 + valid) through
        fixed-shape targets), device-side activation of the rows finishing
        their prompt, then the n-step sync-free decode. Rows mid-prompt
        carry done, so the decode freezes their pos; their one masked write
        (a dummy token's K/V at the next chunk offset) is overwritten by
        that chunk before anything attends it. Its inputs are the plan's
        host arrays (toks (B, C), ints (4, B): pos0, valid, budgets, base;
        flags (2, B): reset, final), the positions, the last tokens and the
        sync state. Returns the served counts per step (n,)."""
        eos = self.ecfg.eos_id
        extra = self._samp_args(sampled)

        def body(toks, ints, flags, pos, last_tok, *rest):
            samp = _tables(rest[5:])
            logits, st = M.chunk_step(self.model, self.state._replace(pos=pos, last_tok=last_tok),
                                      toks, ints[0], ints[1], flags[0])
            sy = _sync_activate(SyncState(*rest[:5]), logits, flags[1], ints[2], eos, samp)
            st, sy, served = _decode_n_sync(self._decode_step, st, sy, n_steps, eos, samp)
            return (toks, ints, flags, st.pos, st.last_tok, *sy, *rest[5:]), (served,)
        (_, _, _, pos, last, *rest), (served,) = self._graphed(
            "chunk+s" if extra else "chunk", n_steps, body,
            (plan["toks"], plan["ints"], plan["flags"], self.state.pos, self.state.last_tok,
             *self.sync, *extra), _leaves(self.state.caches))
        self.state = self.state._replace(pos=pos, last_tok=last)
        self.sync = SyncState(*rest[:5])
        return served

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
        self._now = now
        prev, self._pending_read = self._pending_read, None
        admitted = self._admit_chunked(now)
        plan = self._chunk_plan(n_steps)
        n_active = sum(r is not None for r in self.active)
        if plan is not None:
            t0 = self._span()
            served_steps = self._chunk_decode_sync(plan, n_steps)
            self.decode_dispatches += 1
            self._emit_dispatch(t0, now, "mixed", n=n_steps, chunk_rows=len(plan["plan"]))
            self._finish_chunk_plan(plan, now)
            self._post_readback(now, served_steps)
        elif n_active:
            t0 = self._span()
            served_steps = self._decode_sync(n_steps)
            self.decode_dispatches += 1
            self._emit_dispatch(t0, now, "decode", n=n_steps)
            self._post_readback(now, served_steps)
        served_prev, per_step_prev = self._consume_read(prev)
        self.served_history.append(served_prev)
        self.steps += n_steps
        return self._slot_stats(n_active, served_prev, served_per_step=per_step_prev,
                                admitted=admitted)




def _sync_clear(sync: SyncState, rows: torch.Tensor) -> SyncState:
    """Deactivate the rows where ``rows`` (B,) bool is True (a preempted
    row): latch done, zero the budget. A select, so no index leaves the
    host."""
    return sync._replace(done=sync.done | rows,
                         budget=torch.where(rows, 0, sync.budget))


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
    matches the dense path. ``occupancy()`` is the pool's fill fraction
    (committed occupancy with prefix sharing), the signal ``MemoryAware``
    prices.

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
    Under an unscaled storage cast every page holds the cast dtype: one
    region, tagged "native" as the reference's allocator tags it, filled
    by the cast prefill's rows as they are and read through K3q's and
    K4p's unscaled routes on the card.

    The sync-free loop (``step_slot_sync``) is the dense engine's protocol
    with the decode over the pages: a row's position advances by exactly
    ``n_steps`` per dispatch on the host (a row that finished on the device
    froze there instead and retires at the next consume, its host mirror
    over-covering by at most one page). Chunked continuous batching
    (``step_slot_chunked``) writes prompt chunks through the block tables
    inside the mixed dispatch; a chunk's pages are reserved when it is
    scheduled, and when every occupied row is a stalled prefill the
    youngest is preempted. Over a lossy pool the chunks also land in
    native staging buffers, which the prompt phase reads.

    ``prefix_sharing`` indexes every fully written prompt page in a
    ``PrefixIndex``: the fused and sync-free admissions share resident full
    pages (the whole prompt still prefills; the win is pool capacity), and
    the chunked admission starts the prompt past its resident prefix,
    forking a partially matched page copy-on-write (``_flush_forks``, one
    fixed-shape copy per slot before the mixed dispatch). A hit is capped
    at the prompt's length minus one, so the last prompt token always
    computes the activation logits, and no decode write lands in a shared
    page.
    """

    def __init__(self, model: M.Model, ecfg: PagedEngineConfig, obs=None):
        cfg = model.cfg
        T.check_servable(cfg)
        if not T.paged_segments_supported(cfg):
            raise ValueError(f"{cfg.name}: paged decode needs an all-attention stack")
        if ecfg.shape_window is not None:
            raise ValueError("paged decode does not support sliding windows")
        ps, P, R = ecfg.page_size, ecfg.prompt_len, ecfg.max_active
        if P % ps:
            raise ValueError(f"prompt_len {P} must be a multiple of page_size {ps}")
        if ecfg.kv_precision:
            cfg = cfg.replace(kv_precision=ecfg.kv_precision)
        kvp = self.kvp = resolve_kv_precision(cfg.kv_precision, cfg.cache_dtype)
        # the quantized region: the top quant_pages ids of the pool; -1 means
        # every page under a quantized precision and none otherwise
        qp = ecfg.quant_pages
        if qp < 0:
            qp = ecfg.num_pages if kvp.is_quantized else 0
        if qp and not kvp.is_quantized:
            raise ValueError(f"quant_pages={qp} needs a quantized kv_precision, "
                             f"got {kvp.tag!r}")
        self.cfg, self.model, self.ecfg = cfg, model, ecfg
        self._init_obs(obs)
        self._init_sampling(ecfg)
        # under a quantized precision prefill at native storage: the page
        # copy quantizes what lands in the quantized region; a cast keeps
        # the cast prefill, whose rows the page copy moves as they are
        self._prefill_kv = "native" if kvp.is_quantized else cfg.kv_precision
        self.device = model.device
        self.MP = ecfg.max_pages_per_req or max(ecfg.cache_len // ps, P // ps + 1)
        self._buckets = _prompt_buckets(P, quantum=ps)
        self._gen_cap = ecfg.gen_buf_len or ecfg.cache_len
        # the chunk width rounds up to whole pages unless it was given
        self._chunk = ecfg.chunk_size or -(-max(P // 4, 1) // ps) * ps
        self._chunk_ok = T.chunked_prefill_supported(cfg)
        # a lossy pool's chunked prompt phase reads native staging buffers
        staged = self._chunk_ok and kvp.lossy and kvp.staging == "auto"
        self.pools = T.paged_pools_init(cfg, ecfg.num_pages, ps, self.device,
                                        native_pages=ecfg.num_pages - qp,
                                        stage_rows=R if staged else 0, stage_len=P)
        self.allocator = PageAllocator(ecfg.num_pages, ps, quant_pages=qp,
                                       quant_precision=kvp.tag if qp else "int8")
        # the region new admissions draw pages from: the PrecisionAware
        # scheduler's lever, which the serve loop sets between slots
        self.admit_precision = "native" if qp < ecfg.num_pages else kvp.tag
        # prefix sharing: the radix index over resident prompt pages and the
        # slot's copy-on-write fork plan (row -> (src, dst)), flushed as one
        # device copy before the slot's mixed dispatch
        self._prefix = PrefixIndex(self.allocator) if ecfg.prefix_sharing else None
        self._fork_plan: dict = {}
        self.prefix_hits = 0          # prompt tokens served from the cache
        self.prefix_forks = 0         # copy-on-write forks of partly matched pages
        self.fork_dispatches = 0
        self.eviction_raced_hits = 0  # prefix hits degraded by a racing eviction
        self.block_tables = np.full((R, self.MP), -1, np.int32)
        self.pos = np.zeros(R, np.int32)
        self.sync = sync_state_init(R, self._gen_cap, self.device)
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
            fork_dispatches=self.fork_dispatches,
            preemptions=self.preemptions,
            alloc_failures=self.alloc_failures,
            eviction_raced_hits=self.eviction_raced_hits,
            prefix_hit_tokens=self.prefix_hits,
            prefix_forks=self.prefix_forks,
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
        if self._prefix is not None:
            c.update(prefix_inserted_pages=self._prefix.inserted_pages,
                     prefix_evicted_pages=self._prefix.evicted_pages)
        return c

    def _slot_stats(self, n_active: int, served: int, **extra) -> dict:
        d = super()._slot_stats(n_active, served, **extra)
        d["occupancy"] = self.occupancy()
        d["preemptions"] = self.preemptions
        return d

    def occupancy(self) -> float:
        """The pool's fill fraction. With prefix sharing the controller
        prices committed occupancy: pages only the index pins are
        reclaimable on demand, so charging them would throttle admission
        below the pool's true marginal cost."""
        if self._prefix is None:
            return self.allocator.occupancy()
        return self.allocator.committed_occupancy()

    def quant_occupancy(self) -> float:
        """In-use fraction of the quantized page region (0.0 without one):
        the signal ``PrecisionAware`` prices."""
        return self.allocator.quant_occupancy()

    def prefix_hit_tokens(self, tokens) -> int:
        """Prompt tokens of ``tokens`` resident in the prefix cache at the
        current admission precision, LRU state untouched (a router's
        affinity probe)."""
        if self._prefix is None:
            return 0
        L = max(1, min(len(tokens), self.ecfg.prompt_len))
        return min(self._prefix.peek_tokens(np.asarray(tokens[:L], np.int32),
                                            precision=self.admit_precision), L - 1)

    # ------------------------------------------- page acquisition helpers
    def _evict_short(self, short: int) -> bool:
        """Reclaim ``short`` pages from the prefix index's LRU tail."""
        return (self._prefix is not None and short > 0
                and self._prefix.evict(short) >= short)

    def _raced_hit(self, row: int, what: str) -> None:
        """A prefix hit degraded by an eviction in the same allocation:
        counted, and traced so the cache's race window shows on the
        timeline."""
        self.eviction_raced_hits += 1
        tr = self.obs.trace
        if tr.enabled:
            tr.emit("raced_hit", slot=self._now, row=row, pid=self.obs_pid, what=what)

    def _alloc_pages(self, row: int, tokens: int, shared=(),
                     precision: str = "native") -> tuple[Optional[list], list]:
        """Allocate with one eviction retry. Returns (block table or None,
        the shared pages actually taken): after a deep eviction a shared
        page may itself be gone, and sharing is then dropped for this
        request (a hit saves work; it is never needed for correctness).
        ``precision`` names the region the novel pages come from."""
        shared = list(shared)
        pages = self.allocator.alloc(row, tokens, shared=shared, precision=precision)
        if pages is not None or self._prefix is None:
            return pages, shared
        short = (pages_for(tokens, self.ecfg.page_size) - len(shared)
                 - self.allocator.free_pages_for(precision))
        if not self._evict_short(short):
            return None, shared
        if any(self.allocator.refcount(p) <= 0 for p in shared):
            self._raced_hit(row, "shared-page-evicted")
            shared = []
        return self.allocator.alloc(row, tokens, shared=shared, precision=precision), shared

    def _extend_pages(self, row: int, tokens: int) -> Optional[list]:
        """Extend with one eviction retry; growth stays in the row's own
        region."""
        pages = self.allocator.extend(row, tokens)
        if pages is None and self._prefix is not None:
            prec = self.allocator.precision_of(row)
            short = (pages_for(tokens, self.ecfg.page_size)
                     - len(self.allocator.block_table(row))
                     - self.allocator.free_pages_for(prec))
            if self._evict_short(short):
                pages = self.allocator.extend(row, tokens)
        return pages

    def _flush_forks(self) -> None:
        """Copy every staged copy-on-write page in ONE fixed-shape copy
        (pad entries aim at the scratch page), before the slot's mixed
        dispatch, so a forked page is resident before any chunk writes or
        reads its private copy."""
        if not self._fork_plan:
            return
        R, N = self.ecfg.max_active, self.ecfg.num_pages
        idx = np.zeros((2, R), np.int64)
        idx[1] = N
        for j, (src, dst) in enumerate(self._fork_plan.values()):
            idx[:, j] = (src, dst)
        rows = len(self._fork_plan)
        self._fork_plan.clear()
        t0 = self._span()
        idx = host_to_device(idx, self.device)
        self.pools = M.fork_pages(self.pools, idx[0], idx[1])
        self.fork_dispatches += 1
        self._emit_dispatch(t0, self._now, "fork", rows=rows)

    # ------------------------------------------------------------------
    def step(self, now: int) -> dict:
        raise NotImplementedError("the paged engine has no legacy per-step loop")

    def _admit_one(self, req: Request, slot: int, now: int) -> None:
        raise NotImplementedError("the paged engine admits via admit_pending")

    def _retire(self, row: int, r: Request, now: int) -> None:
        super()._retire(row, r, now)
        self._release_row(row)

    def _release_row(self, row: int) -> None:
        self.allocator.free(row)   # refcounted: shared prefix pages survive
        self._fork_plan.pop(row, None)
        self.block_tables[row] = -1
        self.pos[row] = 0
        self.slot_age[row] = 0

    def _bounce(self, row: int) -> Request:
        """Free a row's pages and put its request back at the head of the
        queue: it restarts from scratch on re-admission (the same tokens
        under greedy decoding)."""
        req = self.active[row]
        self._release_row(row)
        self.active[row] = None
        req.generated = None
        req.admit_slot = None
        req.start_slot = None
        req.first_token_slot = None
        self.pending.insert(0, req)
        self.preemptions += 1
        return req

    def _preempt(self, row: int) -> None:
        """Bounce an active request back to pending (pages exhausted)."""
        req = self._bounce(row)
        tr = self.obs.trace
        if tr.enabled:
            tr.emit("preemption", slot=self._now, rid=req.rid, row=row, pid=self.obs_pid,
                    what="decode")

    def _preempt_cursor(self, row: int) -> None:
        """Bounce a mid-prefill request back to pending (the pool starved by
        concurrent prefills); its prompt restarts from chunk 0."""
        cur = self._cursors.pop(row)
        req = self._bounce(row)
        tr = self.obs.trace
        if tr.enabled:
            tr.emit("preemption", slot=self._now, rid=req.rid, row=row, pid=self.obs_pid,
                    what="prefill", off=cur.off)

    def _decode_step(self, state, tokens: torch.Tensor):
        return M.decode_step_paged(self.model, state, tokens)

    def _decode_fused(self, toks: np.ndarray, n: int,
                      sampled: Optional[bool] = None) -> torch.Tensor:
        """The fused path's n steps over the pools, from the host's block
        tables, positions and last tokens; per-step tokens (n, R)."""
        extra = self._samp_decode_args(sampled)

        def body(block_tables, pos, toks, *extra):
            state = M.PagedDecodeState(self.pools, block_tables, pos, toks)
            out, state = _decode_n_paged(self.model, state, toks, n, *_scan_samp(extra))
            return (block_tables, state.pos, toks, *extra), (out,)
        _, (all_toks,) = self._graphed("fused+s" if extra else "fused", n, body,
                                       (self.block_tables, self.pos, toks, *extra),
                                       _leaves(self.pools))
        return all_toks

    def _decode_sync(self, n: int, sampled: Optional[bool] = None) -> torch.Tensor:
        """The sync-free path's n steps over the pools, from the host's
        block tables and positions and the device-resident sync state;
        served per step (n,) int32."""
        eos = self.ecfg.eos_id
        extra = self._samp_args(sampled)

        def body(block_tables, pos, *rest):
            last = torch.zeros_like(pos)   # unused: the decode reads the sync state's tokens
            state = M.PagedDecodeState(self.pools, block_tables, pos, last)
            state, sy, served = _decode_n_sync(self._decode_step, state, SyncState(*rest[:5]),
                                               n, eos, _tables(rest[5:]))
            return (block_tables, state.pos, *sy, *rest[5:]), (served,)
        (_, _, *rest), (served,) = self._graphed(
            "sync+s" if extra else "sync", n, body,
            (self.block_tables, self.pos, *self.sync, *extra), _leaves(self.pools))
        self.sync = SyncState(*rest[:5])
        return served

    def admit_pending(self, now: int, lookahead: int = 1, sync: bool = False) -> int:
        """Fill free rows from the pending queue with ONE bucketed prefill.

        Admission = page allocation: a request enters only if the pool can
        cover its real prompt length plus this slot's ``lookahead`` decode
        writes (so admission never immediately preempts; growth beyond the
        slot comes page by page). All k admissions share one batch-R
        prefill whose dense cache (cache_len = the bucket) is copied into
        the pages, in one admission dispatch (``_admit_graphed``); pad rows
        carry out-of-pool page ids, whose blocks land on the scratch pages.
        With prefix sharing a request's resident full pages are shared
        (capped at (L - 1) // page_size) and the copy skips them: the whole
        prompt still prefills. ``sync=True`` computes the first tokens on
        the device (``_sync_admit``) instead of reading the logits back.
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
            if sync:
                self._validate_gen_cap(req)
            self._validate_sampled(req)
            # a padded (not ragged) stack prefills and holds the whole bucket
            L = max(1, min(len(req.tokens), P)) if self._ragged else P
            shared: list = []
            if self._prefix is not None:
                hit = self._prefix.lookup(np.asarray(req.tokens[:L], np.int32),
                                          precision=self.admit_precision)
                shared = hit.pages[: (L - 1) // ps]
            # pages are keyed by engine row: a row uniquely owns its request
            # while active, whereas rids are unique only per RequestSource
            pages, shared = self._alloc_pages(row, min(L + lookahead, self.MP * ps),
                                              shared=shared, precision=self.admit_precision)
            if pages is None:
                self.alloc_failures += 1
                break
            self.prefix_hits += len(shared) * ps
            self.pending.pop(0)
            take.append((row, req, pages, L, len(shared)))
        if not take:
            return 0
        k = len(take)
        bucket = self._pick_bucket(max(L for _r, _q, _p, L, _s in take))
        npp = bucket // ps
        toks = np.zeros((R, bucket), np.int32)
        lens = np.full(R, bucket, np.int32)
        page_idx = np.full((R, npp), N, np.int32)   # N: outside the pool (a scratch page)
        for j, (_row, req, pages, L, n_shared) in enumerate(take):
            toks[j] = self._bucket(req.tokens, req, bucket)
            lens[j] = L
            pg = pages[:npp]
            page_idx[j, : len(pg)] = pg
            # a shared page already holds this block's K/V: never write into
            # a page other requests read
            page_idx[j, :n_shared] = N
        # cache_len == bucket: the dense prefill cache is exactly the prompt
        # rows, ready to copy into pages (no ring wraparound)
        adm = self._admission_table([t[0] for t in take], [t[1].max_new_tokens for t in take])
        t0 = self._span()
        _, first = self._admit_graphed(bucket, sync, toks, lens, adm, (page_idx,),
                                       self._samp_args(rows=[t[1] for t in take] + [None] * (R - k)))
        self.prefill_dispatches += 1
        self._emit_dispatch(t0, now, "prefill", rows=k)
        if not sync:
            self.blocking_syncs += 1
            first = first.cpu().numpy()[:k]
        for j, (row, req, pages, L, _ns) in enumerate(take):
            req.start_slot = now
            req.first_token_slot = now
            req.generated = None if sync else [int(first[j])]
            self._emit_admission(req, row, now)
            self.active[row] = req
            self.block_tables[row, : len(pages)] = pages
            self.pos[row] = L
            self.slot_age[row] = 1   # first token came from prefill
            if self._prefix is not None:
                # index the prompt's fully written full pages (shared ones are
                # indexed already: insert walks past them), under the region
                # they were written in
                self._prefix.insert(np.asarray(req.tokens[:L], np.int32), pages[: L // ps],
                                    precision=self.allocator.precision_of(row))
            if sync:
                self._row_epoch[row] += 1
        self.peak_active = max(self.peak_active, sum(r is not None for r in self.active))
        return k

    def _prefill_splice(self, bucket: int, toks, lens, targets, keep, page_idx):
        """The paged admission's device work: the bucketed prefill
        (cache_len = the bucket, native storage), its blocks copied into
        the pages ``page_idx`` (R, bucket // ps) names. Returns (logits,
        (page_idx,))."""
        logits, st = self._prefill(toks, lens, bucket)
        M.paged_splice_prompt(self.pools, st.caches, page_idx)
        return logits, (page_idx,)

    def _cache_leaves(self) -> list:
        return _leaves(self.pools)

    def _idle_spec(self, bucket: int) -> tuple:
        """Every block bound outside the pool: onto the scratch pages."""
        R, N = len(self.active), self.ecfg.num_pages
        return (np.full((R, bucket // self.ecfg.page_size), N, np.int32),)

    def _ensure_pages(self, n_steps: int, sync: bool = False) -> None:
        """Pre-extend every decoding row to cover this slot's decode writes.

        The fused decode writes rows pos..pos+n_steps-1 for every active row
        (rows finishing mid-dispatch keep writing, masked), so the pages
        must exist up front; growing here keeps the decode free of host
        round-trips. Rows the pool cannot cover are preempted, and under the
        sync-free protocol deactivated on the device too. Rows mid-prefill
        are skipped: ``_chunk_reserve`` reserves their pages chunk by
        chunk."""
        ps = self.ecfg.page_size
        cleared = np.zeros(self.ecfg.max_active, bool)
        for row, req in enumerate(self.active):
            if req is None or row in self._cursors:
                continue
            need = min(int(self.pos[row]) + n_steps, self.MP * ps)
            pages = self._extend_pages(row, need)
            if pages is None:
                self._preempt(row)
                cleared[row] = True
                continue
            self.block_tables[row, : len(pages)] = pages
        if sync and cleared.any():
            self.sync = _sync_clear(self.sync, host_to_device(cleared, self.device))

    def step_slot(self, now: int, n_steps: int = 1) -> dict:
        """One control slot: batched admit -> page extension -> fused decode
        -> retire (pages freed). <= 1 prefill + 1 decode dispatch; the
        decode's tokens are read back once (the slot's blocking sync)."""
        self._now = now
        admitted = self.admit_pending(now, lookahead=n_steps)
        self._ensure_pages(n_steps)
        self.occupancy_hwm = self.occupancy()
        n_active = sum(r is not None for r in self.active)
        per_step = [0] * n_steps
        if n_active:
            toks = np.asarray([r.generated[-1] if r else 0 for r in self.active], np.int32)
            t0 = self._span()
            all_toks = self._decode_fused(toks, n_steps)
            self.decode_dispatches += 1
            self.blocking_syncs += 1
            self._emit_dispatch(t0, now, "decode", n=n_steps)
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

    def step_slot_sync(self, now: int, n_steps: int = 1) -> dict:
        """One sync-free control slot over the pool: admission (pages and
        the first token on the device) -> page extension -> the fused
        decode from device-resident state -> start the counter copy -> THEN
        consume the previous slot's copy. Page tables are pure host
        arithmetic: a decoding row's position advances by ``n_steps`` per
        dispatch. No device read gates a dispatch (the reference's early
        consume is left out, as on the dense engine: ROADMAP R5)."""
        self._now = now
        prev, self._pending_read = self._pending_read, None
        admitted = self.admit_pending(now, lookahead=n_steps, sync=True)
        self._ensure_pages(n_steps, sync=True)
        self.occupancy_hwm = self.occupancy()
        n_active = sum(r is not None for r in self.active)
        if n_active:
            t0 = self._span()
            served_steps = self._decode_sync(n_steps)
            self.decode_dispatches += 1
            self._emit_dispatch(t0, now, "decode", n=n_steps)
            for row, req in enumerate(self.active):
                if req is not None:
                    self.pos[row] += n_steps
            self._post_readback(now, served_steps)
        served_prev, per_step_prev = self._consume_read(prev)
        self.served_history.append(served_prev)
        self.steps += n_steps
        return self._slot_stats(n_active, served_prev, served_per_step=per_step_prev,
                                admitted=admitted)

    # --------------------------------------- continuous batching (chunked)
    def _validate_chunked(self, req: Request) -> None:
        """Refuse what the block table cannot hold and a prompt that cannot
        fit the whole pool with its first decode write (it could never
        activate: refusing it beats a silent stall)."""
        ps, P = self.ecfg.page_size, self.ecfg.prompt_len
        if req.max_new_tokens > self.MP * ps - P + 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens {req.max_new_tokens} "
                f"exceeds the block table ({self.MP} pages x {ps})")
        L = max(1, min(len(req.tokens), P))
        if pages_for(L + 1, ps) > self.ecfg.num_pages:
            raise ValueError(
                f"request {req.rid}: prompt of {L} tokens needs {pages_for(L + 1, ps)} "
                f"pages; the pool holds {self.ecfg.num_pages}")
        super()._validate_chunked(req)

    def _claim_row(self, row: int, toks: np.ndarray) -> int:
        """Claim a row for chunked prefill; with prefix sharing, take the
        prompt's resident prefix so the cursor starts past it.

        Full resident pages are shared outright. When the radix walk also
        matches a partial block (the next resident page agrees on its first
        ``fork_len`` tokens), that page is forked copy-on-write: a private
        page joins the row's table, its copy is staged for
        ``_flush_forks``, and only the block's divergent tail recomputes.
        The hit is capped at L - 1 tokens, so the last prompt token always
        computes the activation logits."""
        prec = self.admit_precision
        if self._prefix is None:
            self.allocator.alloc(row, 0, precision=prec)   # remembers the region
            return 0
        ps, L = self.ecfg.page_size, len(toks)
        hit = self._prefix.lookup(np.asarray(toks, np.int32), precision=prec)
        want = hit.pages[: (L - 1) // ps]
        fork_len = 0
        if hit.fork_src is not None and len(want) == len(hit.pages):
            fork_len = max(0, min(hit.fork_len, L - 1 - len(want) * ps))
        pages, shared = self._alloc_pages(row, len(want) * ps + fork_len, shared=want,
                                          precision=prec)
        if pages is None:
            self.allocator.alloc(row, 0, precision=prec)   # a cold start
            return 0
        if len(shared) < len(want):
            cached = len(shared) * ps      # a deep eviction ate part of the hit
        else:
            cached = len(want) * ps
            # the fork source is pinned only by the index and this very
            # allocation's eviction retry may have reclaimed it: fork only
            # while its pin holds (a pinned page is still the node's)
            if fork_len > 0:
                if self.allocator.pages[hit.fork_src].pinned:
                    self._fork_plan[row] = (hit.fork_src, pages[-1])
                    self.prefix_forks += 1
                    cached += fork_len
                else:
                    self._raced_hit(row, "fork-source-evicted")
        self.block_tables[row, : len(pages)] = pages
        self.pos[row] = cached   # chunk writes resume past the resident rows
        self.prefix_hits += cached
        return cached

    def _on_activate(self, row: int, cur: PrefillCursor, now: int) -> None:
        super()._on_activate(row, cur, now)
        if self._prefix is not None:
            # every prompt row is written now: index the full pages (a forked
            # boundary page qualifies: its rows before the fork point equal
            # a recompute)
            L = len(cur.toks)
            pages = self.allocator.block_table(row)
            self._prefix.insert(np.asarray(cur.toks, np.int32),
                                pages[: L // self.ecfg.page_size],
                                precision=self.allocator.precision_of(row))

    def _chunk_reserve(self, row: int, cur: PrefillCursor, take: int,
                       fin: bool, n_steps: int) -> bool:
        """A chunk enters only if the pool covers its writes (plus the slot's
        decode writes when it activates the row); a refused chunk waits for
        pages that retiring decodes free."""
        ps = self.ecfg.page_size
        need = min(cur.off + take + (n_steps if fin else 0), self.MP * ps)
        pages = self._extend_pages(row, need)
        if pages is None:
            self.alloc_failures += 1
            return False
        self.block_tables[row, : len(pages)] = pages
        return True

    def _chunk_decode_sync(self, plan: dict, n_steps: int,
                           sampled: Optional[bool] = None) -> torch.Tensor:
        """ONE mixed dispatch over the pool, one "chunk" graph replay on the
        card: the rows' prompt chunks, written through the block tables
        (and into staging over a lossy pool), device-side activation of the
        rows finishing their prompt, then the n-step sync-free decode. Rows
        mid-prompt carry done, so the decode freezes their pos; their one
        masked write (a dummy token's K/V at the next chunk offset) is
        overwritten by that chunk before anything attends it. Beside the
        dense dispatch's inputs it takes the block tables; the chunk's
        pool-resident prefix (``base``) is ints[3]. Returns the served
        counts per step (n,)."""
        eos = self.ecfg.eos_id
        extra = self._samp_args(sampled)

        def body(toks, ints, flags, block_tables, pos, *rest):
            samp = _tables(rest[5:])
            state = M.PagedDecodeState(self.pools, block_tables, pos, torch.zeros_like(pos))
            logits, state = M.chunk_step_paged(self.model, state, toks, ints[0], ints[1],
                                               ints[3])
            sy = _sync_activate(SyncState(*rest[:5]), logits, flags[1], ints[2], eos, samp)
            state, sy, served = _decode_n_sync(self._decode_step, state, sy, n_steps, eos, samp)
            return (toks, ints, flags, block_tables, state.pos, *sy, *rest[5:]), (served,)
        (_, _, _, _, _, *rest), (served,) = self._graphed(
            "chunk+s" if extra else "chunk", n_steps, body,
            (plan["toks"], plan["ints"], plan["flags"], self.block_tables, self.pos,
             *self.sync, *extra), _leaves(self.pools))
        self.sync = SyncState(*rest[:5])
        return served

    def step_slot_chunked(self, now: int, n_steps: int = 1) -> dict:
        """Continuous batching over the pool: admission (host bookkeeping
        and prefix hits) -> the slot's copy-on-write forks -> ONE mixed
        dispatch of per-row prompt chunks written through the block tables
        and the fused sync-free decode -> the counter copy, consumed a slot
        later. Chunk pages are reserved when a chunk is scheduled; decoding
        rows pre-extend as on the sync-free loop."""
        self._require_chunked()
        self._now = now
        prev, self._pending_read = self._pending_read, None
        admitted = self._admit_chunked(now)
        self._flush_forks()   # forked pages land before this slot's chunks
        self.peak_active = max(self.peak_active, sum(r is not None for r in self.active))
        plan = self._chunk_plan(n_steps)
        if plan is None and len(self._cursors) > 1 and all(
                r is None or row in self._cursors for row, r in enumerate(self.active)):
            # every occupied row is a stalled prefill: no decode will retire
            # and free pages, so bounce the youngest prefill and let the
            # oldest finish
            self._preempt_cursor(next(reversed(self._cursors)))
            plan = self._chunk_plan(n_steps)
        self._ensure_pages(n_steps, sync=True)
        self.occupancy_hwm = self.occupancy()
        n_active = sum(r is not None for r in self.active)
        decoding = any(r is not None and row not in self._cursors
                       for row, r in enumerate(self.active))
        if plan is not None or decoding:
            t0 = self._span()
            if plan is not None:
                served_steps = self._chunk_decode_sync(plan, n_steps)
            else:
                served_steps = self._decode_sync(n_steps)
            self.decode_dispatches += 1
            self._emit_dispatch(t0, now, "mixed" if plan is not None else "decode", n=n_steps,
                                chunk_rows=len(plan["plan"]) if plan else 0)
            for row, req in enumerate(self.active):
                if req is not None and row not in self._cursors:
                    self.pos[row] += n_steps   # decoding rows (the host mirror)
            if plan is not None:
                for row, _cur, take, fin in plan["plan"]:
                    # the chunk's writes, plus the same slot's decode for a row
                    # the chunk activated
                    self.pos[row] += take + (n_steps if fin else 0)
                self._finish_chunk_plan(plan, now)
            self._post_readback(now, served_steps)
        served_prev, per_step_prev = self._consume_read(prev)
        self.served_history.append(served_prev)
        self.steps += n_steps
        return self._slot_stats(n_active, served_prev, served_per_step=per_step_prev,
                                admitted=admitted)
