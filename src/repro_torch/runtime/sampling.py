"""Per-request sampling on the device.

``SamplingParams`` rides on a ``Request``. The engine batches the active
rows' params into per-row tables (``RowSampling``) that enter the decode
dispatch as inputs, as block tables do, so rows with different
temperature, top-k, top-p and repetition, presence and frequency penalties
sample inside one dispatch, and inside its CUDA graph on the card.

The key of a request's token number ``age`` (0: the first generated token,
drawn from the prefill logits) is the reference's

    fold_in(fold_in(PRNGKey(seed), rid), age)

with ``seed = params.seed`` if given, else the engine's seed. Its bits are
JAX's threefry-2x32, computed on the device (``runtime/threefry.py``), so
keys and random bits equal the reference's bit for bit, and a stream is a
pure function of (params, prompt, seed, rid): it does not change with row
placement, batch composition, preemption or requeue.

``sample_rows`` follows the reference's ``sample_rows`` op for op on raw
float32 logits:
  1. penalties over the request's generated tokens (not the prompt): an
     integer ``scatter_add_`` counts them (exact, independent of order);
     repetition divides a seen token's positive logit by r and multiplies
     a negative one; presence subtracts a flat amount once seen, frequency
     an amount per occurrence;
  2. greedy rows (temperature <= ``GREEDY_TEMP``) take the argmax of the
     penalized logits, so temperature 0 is exact greedy, never a divide;
  3. temperature, clamped at ``GREEDY_TEMP``;
  4. one stable descending sort serves top-k (exactly min(k, V) survivors,
     ties to the lowest token id) and top-p (the smallest prefix whose mass
     reaches p; 1.0 is exactly off; at least one candidate);
  5. ``argmax(gumbel + filtered logits)``, which is ``jax.random.categorical``.
Tokens can differ from the reference's only where XLA's and PyTorch's
roundings of log, softmax or cumsum decide a near-tie: two perturbed
scores within float32 noise of each other, or a top-p boundary within it
of ``top_p``.

Everything is tensor ops: no ``.item()``, no ``torch.multinomial``, no
host read, so the sampler captures in a graph.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import host_to_device
from repro_torch.runtime import threefry

# Temperatures at or below this route to exact argmax instead of a divide.
GREEDY_TEMP = 1e-6

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. The defaults are greedy's but for
    ``temperature``, whose 1.0 samples the raw distribution. Validation
    raises at construction, before the request can reach a dispatch."""

    temperature: float = 1.0      # <= 1e-6 => greedy argmax (0 is valid)
    top_k: int = 0                # 0 = full vocabulary; > vocab clamps to vocab
    top_p: float = 1.0            # nucleus mass in (0, 1]; 1.0 = off
    repetition_penalty: float = 1.0   # CTRL-style multiplicative; 1.0 = off
    presence_penalty: float = 0.0     # flat once-seen penalty; 0.0 = off
    frequency_penalty: float = 0.0    # per-occurrence penalty; 0.0 = off
    seed: Optional[int] = None    # None => the engine's seed

    def __post_init__(self):
        if not self.temperature >= 0.0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(
                f"top_k must be >= 0 (0 = full vocabulary), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not self.repetition_penalty > 0.0:
            raise ValueError(
                "repetition_penalty must be > 0 (1 = off), "
                f"got {self.repetition_penalty}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= GREEDY_TEMP

    @property
    def is_pure_greedy(self) -> bool:
        """Greedy with every penalty off: the engine's own argmax, so rows
        carrying it stay on the sampling-free graph."""
        return (self.greedy
                and self.repetition_penalty == 1.0
                and self.presence_penalty == 0.0
                and self.frequency_penalty == 0.0)


class RowSampling(NamedTuple):
    """Per-row parameter tables of one dispatch, aligned with its batch
    axis: (B,) arrays, host-built by ``row_tables`` each slot and moved to
    the device (``to``), or filled into a graph's static inputs, through
    pinned memory."""

    seed: torch.Tensor    # int64, the row's 32-bit base seed
    rid: torch.Tensor     # int32, folded into the key after the seed
    temp: torch.Tensor    # float32
    top_k: torch.Tensor   # int32, 0 = off
    top_p: torch.Tensor   # float32, 1.0 = off
    rep: torch.Tensor     # float32
    pres: torch.Tensor    # float32
    freq: torch.Tensor    # float32
    greedy: torch.Tensor  # bool, argmax rows (their penalties still apply)

    def to(self, device) -> "RowSampling":
        """The tables on ``device``: host arrays through pinned memory,
        tensors as they are."""
        dev = torch.device(device)
        return RowSampling(*(t if isinstance(t, torch.Tensor) else host_to_device(t, dev)
                             for t in self))


def row_tables(resolved: Sequence[Optional[tuple]], default_seed: int) -> RowSampling:
    """The host tables (numpy arrays) of per-row ``(params, rid)`` entries
    (None: an inactive or pure-greedy row), in the dispatch's row order."""
    B = len(resolved)
    seed = np.full(B, default_seed & 0xFFFFFFFF, np.int64)
    rid = np.zeros(B, np.int32)
    temp = np.ones(B, np.float32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    rep = np.ones(B, np.float32)
    pres = np.zeros(B, np.float32)
    freq = np.zeros(B, np.float32)
    greedy = np.ones(B, bool)
    for row, entry in enumerate(resolved):
        if entry is None:
            continue
        p, r = entry
        if p.seed is not None:
            seed[row] = p.seed & 0xFFFFFFFF
        rid[row] = r & 0x7FFFFFFF
        temp[row] = p.temperature
        top_k[row] = p.top_k
        top_p[row] = p.top_p
        rep[row] = p.repetition_penalty
        pres[row] = p.presence_penalty
        freq[row] = p.frequency_penalty
        greedy[row] = p.greedy
    return RowSampling(seed, rid, temp, top_k, top_p, rep, pres, freq, greedy)


def _penalize(lg: torch.Tensor, samp: RowSampling, gen: torch.Tensor,
              gen_len: torch.Tensor) -> torch.Tensor:
    """Repetition, presence and frequency penalties over the generated
    history ``gen[:, :gen_len]`` (the sync-free loops' ring; callers keep
    gen_len <= its capacity, so no live token was overwritten)."""
    B, V = lg.shape
    cap = gen.shape[1]
    live = torch.arange(cap, device=lg.device)[None, :] < torch.clamp(gen_len, max=cap)[:, None]
    counts = torch.zeros((B, V), dtype=torch.int32, device=lg.device)
    counts = counts.scatter_add_(1, gen.long(), live.to(torch.int32)).to(torch.float32)
    seen = counts > 0
    rep = samp.rep[:, None]
    lg = torch.where(seen, torch.where(lg > 0, lg / rep, lg * rep), lg)
    return lg - samp.freq[:, None] * counts - samp.pres[:, None] * seen


def draw_keys(samp: RowSampling, ages: torch.Tensor) -> tuple:
    """Each row's key words, fold_in(fold_in(PRNGKey(seed), rid), age)."""
    return threefry.fold_in(threefry.fold_in(threefry.seed(samp.seed), samp.rid), ages)


def sample_rows(logits: torch.Tensor, samp: RowSampling, ages: torch.Tensor,
                gen: Optional[torch.Tensor] = None,
                gen_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row (B,) int32 under per-row params (module
    docstring). ``ages`` (B,) is each row's generated-token index (0: the
    first token, from the prefill logits); ``gen``/``gen_len`` the
    generated history the penalties read (None: empty, the first token).
    ``samp`` holds tensors on the logits' device."""
    B, V = logits.shape
    lg = logits.to(torch.float32)
    if gen is not None:
        lg = _penalize(lg, samp, gen, gen_len)
    greedy_pick = torch.argmax(lg, dim=-1).to(torch.int32)

    lg = lg / torch.clamp(samp.temp, min=GREEDY_TEMP)[:, None]
    order = torch.sort(lg, dim=-1, descending=True, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(V, device=lg.device).expand(B, V))
    k_eff = torch.where(samp.top_k > 0, torch.clamp(samp.top_k, max=V), V)
    probs = torch.softmax(torch.gather(lg, 1, order), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p_cnt = ((cum - probs) < samp.top_p[:, None]).sum(dim=-1, dtype=torch.int32)
    p_cnt = torch.where(samp.top_p >= 1.0, V, p_cnt)
    n_keep = torch.clamp(torch.minimum(k_eff, p_cnt), min=1)
    lg = torch.where(ranks < n_keep[:, None], lg, _NEG_INF)

    noise = threefry.gumbel(draw_keys(samp, ages), V)
    sampled = torch.argmax(noise + lg, dim=-1).to(torch.int32)
    return torch.where(samp.greedy, greedy_pick, sampled)


def sample_oracle(logits_row, params: SamplingParams, rid: int, default_seed: int,
                  age: int, history=()) -> int:
    """The single-row reference, on the CPU: the token ``sample_rows``
    gives this (params, rid, seed, age, history) at any batch shape or
    row."""
    samp = row_tables([(params, rid)], default_seed).to("cpu")
    lg = torch.as_tensor(np.asarray(logits_row, np.float32))[None, :]
    hist = np.asarray(list(history), np.int32).reshape(1, -1)
    gen = gen_len = None
    if hist.shape[1]:
        gen = torch.from_numpy(hist)
        gen_len = torch.tensor([hist.shape[1]], dtype=torch.int32)
    return int(sample_rows(lg, samp, torch.tensor([age], dtype=torch.int32), gen, gen_len)[0])
