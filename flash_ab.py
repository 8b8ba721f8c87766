"""Device time of K1 (every route: the wide one at hd 128 and 256, the
one-warpgroup wgmma one at hd 64 and over int8 codes) and of the RG-LRU
scan K7 in this checkout against the same kernels built from another
checkout's sources, on one card.

Unpack the other tree (for example the parent commit, with ``git archive``)
into a directory that .gitignore lists, then run on the card:

    python3 flash_ab.py --other build/parent/src/repro_torch/kernels/csrc

Each case (the bf16 rows of chip_smoke.py's kernels phase: K1 at olmoe-1b-7b's
and recurrentgemma-2b's admissions, recurrentgemma's window of 2048 and
qwen3-8b's prefill; granite-3-2b's K1 and K1r at hd 64 and K1q / K1rq over
int8 codes; K7 at recurrentgemma's admission from a zero state and from h0)
calls each build's C entry point directly and is timed in turns this,
other, other, this: torch.profiler's kernel time per call, each call after
an L2 flush, mean of 20 (``chip_smoke._device_ms``). Both builds must
agree with the plain version within chip_smoke.py's bf16 tolerance (K7: bit
for bit). Prints one JSON line per case and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.cache import parse_kv_precision  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.quant import quantize_kv  # noqa: E402

NAMES = ("flash_attention", "rglru_scan")


def build_other(csrc: Path) -> dict:
    """The libraries of ``csrc``'s K1 and K7 sources, built with this tree's flags."""
    out_dir = build.BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{n}.so"),
                                  str(csrc / f"{n}.cu")], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for n in NAMES}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the other {n}.cu:\n{log}")
    return {n: ctypes.CDLL(str(out_dir / f"{n}.so")) for n in NAMES}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _k1(lib, q, k, v, seq_lens=None, window=None):
    """One K1 / K1r launch of ``lib``'s native-K/V entry point (out
    returned): flash_attention_prefix_fwd with no prefix where the build has
    it, else the flash_attention_fwd of sources before the prefix-LM mask."""
    prefix = getattr(lib, "flash_attention_prefix_fwd", None)
    fn = prefix if prefix is not None else lib.flash_attention_fwd
    ints = 9 + (prefix is not None)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * ints + [ctypes.c_float,
                                                                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if seq_lens is None else seq_lens.data_ptr(), out.data_ptr(), B, Sq, Sk, H,
             KVH, hd, 1, -1 if window is None else window, *([0] if prefix is not None else []),
             1, hd ** -0.5, _stream())
    if err:
        raise RuntimeError(f"K1: cudaError_t {err}")
    return out


def _k1q(lib, q, k, v, ks, vs, seq_lens=None):
    """One K1q / K1rq launch of ``lib``'s flash_attention_quant_fwd over int8 codes."""
    fn = lib.flash_attention_quant_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(),
             None if seq_lens is None else seq_lens.data_ptr(), out.data_ptr(), B, Sq, Sk, H,
             KVH, hd, 1, -1, 1, 0, hd ** -0.5, _stream())
    if err:
        raise RuntimeError(f"flash_attention_quant_fwd: cudaError_t {err}")
    return out


def _k7(lib, log_a, gated, h0=None):
    """One K7 launch of ``lib``'s rglru_scan_fwd."""
    fn = lib.rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(gated)
    B, S, R = gated.shape
    err = fn(log_a.data_ptr(), gated.data_ptr(), None if h0 is None else h0.data_ptr(),
             out.data_ptr(), B, S, R, _stream())
    if err:
        raise RuntimeError(f"rglru_scan_fwd: cudaError_t {err}")
    return out


def cases():
    """(label, source name, call(lib), plain, bit_equal) at the kernels
    phase's bf16 shapes."""
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def qkv(B, S, H, KVH, hd):
        return (torch.randn(s, generator=g, device="cuda").to(bf)
                for s in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd)))

    for label, (B, S, H, KVH, hd), window in (
            ("K1 olmoe-1b-7b admission (B 8, S 512, 16/16, hd 128)", (8, 512, 16, 16, 128), None),
            ("K1 recurrentgemma-2b admission (B 8, S 512, 10/1, hd 256)", (8, 512, 10, 1, 256),
             None),
            ("K1 recurrentgemma-2b window 2048 (B 2, S 2560, 10/1, hd 256)",
             (2, 2560, 10, 1, 256), 2048),
            ("K1 qwen3-8b prefill (B 8, S 512, 32/8, hd 128)", (8, 512, 32, 8, 128), None),
            ("K1 granite-3-2b (B 8, S 512, 32/8, hd 64)", (8, 512, 32, 8, 64), None)):
        q, k, v = qkv(B, S, H, KVH, hd)
        yield (label, "flash_attention",
               lambda lib, q=q, k=k, v=v, window=window: _k1(lib, q, k, v, window=window),
               lambda q=q, k=k, v=v, window=window: ref.attention_ref(q, k, v, window=window),
               False)
    lens = torch.tensor([512, 300, 129, 1, 512, 64, 200, 511], dtype=torch.int32, device="cuda")
    yield ("K1r granite-3-2b (B 8, S 512, 32/8, hd 64, ragged)", "flash_attention",
           lambda lib: _k1(lib, q, k, v, lens), lambda: ref.attention_ref(q, k, v, seq_lens=lens),
           False)
    int8 = parse_kv_precision("int8")
    (qk, ks), (qv, vs) = (quantize_kv(t.float(), int8) for t in (k, v))
    qlens = torch.tensor(cs.QUANT_PREFILL_LENS, dtype=torch.int32, device="cuda")
    for label, sl in (("K1q int8 granite-3-2b (B 8, S 512, 32/8, hd 64)", None),
                      ("K1rq int8 granite-3-2b (B 8, S 512, 32/8, hd 64, ragged)", qlens)):
        yield (label, "flash_attention",
               lambda lib, sl=sl: _k1q(lib, q, qk, qv, ks, vs, sl),
               lambda sl=sl: ref.attention_quant_ref(q, qk, qv, ks, vs, seq_lens=sl), False)
    B, S, R = 8, 512, 2560
    sp = torch.log1p(torch.exp(-torch.linspace(2.2, 6.9, R, device="cuda")))
    log_a = -8.0 * torch.rand((B, S, R), generator=g, device="cuda") * sp
    gated = 0.5 * torch.randn((B, S, R), generator=g, device="cuda")
    for label, h0 in (("K7 recurrentgemma-2b admission (B 8, S 512, R 2560)", None),
                      ("K7 recurrentgemma-2b admission from h0",
                       torch.randn((B, R), generator=g, device="cuda"))):
        yield (label, "rglru_scan", lambda lib, h0=h0: _k7(lib, log_a, gated, h0),
               lambda h0=h0: ref.rglru_scan_ref(log_a, gated, h0), True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="the other tree's csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    build.build(NAMES)   # this tree's, all nvcc processes at once
    libs = {"this": {n: build.library(n) for n in NAMES}, "other": build_other(args.other)}
    for label, name, call, plain, bit_equal in cases():
        want = plain()
        turns = []
        for side in ("this", "other", "other", "this"):
            lib = libs[side][name]
            got = call(lib)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = (torch.equal(got, want) if bit_equal else
                  err <= cs.KERNEL_RTOL[torch.bfloat16] * max(1.0, want.float().abs().max().item()))
            if not ok:
                raise AssertionError(f"{label}: the {side} build is {err:.3g} from plain")
            turns.append({"side": side, "device_ms": cs._device_ms(lambda lib=lib: call(lib)),
                          "max_abs_err": err})
        mean = {s: sum(t["device_ms"] for t in turns if t["side"] == s) / 2
                for s in ("this", "other")}
        print(json.dumps({"case": label, "turns": turns, "this_ms": mean["this"],
                          "other_ms": mean["other"],
                          "this_over_other": mean["this"] / mean["other"]}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
