"""Device time of the decode kernels K2, K3, K2q and K3q of this checkout
against the same kernels built from another checkout's sources, on one
card.

Unpack the other tree (for example the parent commit, with ``git archive``)
into a directory that .gitignore lists, then run on the card:

    python3 decode_ab.py --other build/parent/src/repro_torch/kernels/csrc

Each case (the bf16 main rows of chip_smoke.py's kernels phase: K2, K3,
K2q over int8 codes, K3q over the mixed, int8 and fp8 pools; and K2 and
K2q at the granite serves' own geometry: unwrapped rows, pos 128-540 in a
ring of 1024) is timed in turns this, other, other, this: torch.profiler's kernel
time per call, each call after an L2 flush, mean of 20
(``chip_smoke._device_ms``). Both builds must agree with the plain version
within chip_smoke.py's bf16 tolerance. Prints one JSON line per case and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.cache import parse_kv_precision  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import decode_attention as kd  # noqa: E402
from repro_torch.kernels import paged_attention as kp  # noqa: E402
from repro_torch.kernels import paged_attention_quant as kpq  # noqa: E402
from repro_torch.kernels.quant import quantize_kv  # noqa: E402

NAMES = ("decode_attention", "paged_attention", "decode_attention_quant", "paged_attention_quant")


def build_other(csrc: Path) -> dict:
    """The libraries of ``csrc``'s decode kernels, built with this tree's flags."""
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


def cases():
    """(name, library, call, plain) at the kernels phase's main bf16 shapes."""
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    B, L, H, KVH, hd = 8, 1024, 32, 8, 64
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(bf)
    k, v = (torch.randn((B, L, KVH, hd), generator=g, device="cuda").to(bf) for _ in range(2))
    int8 = parse_kv_precision("int8")
    (qk, ks), (qv, vs) = (quantize_kv(t.float(), int8) for t in (k, v))
    serve = np.random.default_rng(21).integers(128, 541, B).astype(np.int32)
    for label, pos_np in (("main (rows 1-7 wrapped)",
                           np.asarray([L // 2 - 1] + [L + 37 * b for b in range(1, B)], np.int32)),
                          ("main (rows 2-7 wrapped)",
                           np.asarray([L // 2 - 1, L // 8] + [L + 37 * b for b in range(2, B)],
                                      np.int32)),
                          ("serve geometry (unwrapped, pos 128-540)", serve)):
        sp = torch.from_numpy(cs._ring_slot_pos(B, L, pos_np)).cuda()
        pos = torch.from_numpy(pos_np).cuda()
        if "rows 2-7" not in label:
            yield (f"K2 {label}", "decode_attention",
                   lambda sp=sp, pos=pos: kd.decode_attention(q, k, v, sp, pos),
                   lambda sp=sp, pos=pos: ref.decode_attention_ref(q, k, v, sp, pos))
        if "rows 1-7" not in label:
            yield (f"K2q int8 {label}", "decode_attention_quant",
                   lambda sp=sp, pos=pos: kd.decode_attention_quant(q, qk, qv, ks, vs, sp, pos),
                   lambda sp=sp, pos=pos: ref.decode_attention_quant_ref(q, qk, qv, ks, vs, sp,
                                                                         pos))
    rng = np.random.default_rng(3)
    B, MP, ps = 16, 64, 16
    pos_np = rng.integers(128, MP * ps, B).astype(np.int32)
    k_np, v_np, bt_np, pos_np = cs._paged_inputs(rng, B, MP, ps, KVH, hd, pos_np)
    q3 = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).cuda().to(bf)
    kk, vv = (torch.from_numpy(a).cuda().to(bf) for a in (k_np, v_np))
    bt, pos = torch.from_numpy(bt_np).cuda(), torch.from_numpy(pos_np).cuda()
    yield ("K3 main (B 16, MP 64, ps 16, pos 128-1023)", "paged_attention",
           lambda: kp.paged_decode_attention(q3, kk, vv, bt, pos),
           lambda: ref.paged_decode_attention_ref(q3, kk, vv, bt, pos))
    # K3q: the same tables over a mixed pool (the lower half of the ids
    # native, the rest int8) and over all-int8 and all-fp8 pools
    for pool in ("mixed", "int8", "fp8"):
        Nn = k_np.shape[0] // 2 if pool == "mixed" else 0
        prec = parse_kv_precision("fp8" if pool == "fp8" else "int8")
        (pk, pks), (pv, pvs) = (quantize_kv(torch.from_numpy(a[Nn:]).cuda(), prec)
                                for a in (k_np, v_np))
        nk = nv = None
        if Nn:
            nk, nv = kk[:Nn].contiguous(), vv[:Nn].contiguous()
        plain = (lambda nk=nk, nv=nv, pk=pk, pv=pv, pks=pks, pvs=pvs:
                 ref.paged_decode_attention_mixed_ref(q3, nk, nv, pk, pv, pks, pvs, bt, pos)
                 if nk is not None else
                 ref.paged_decode_attention_quant_ref(q3, pk, pv, pks, pvs, bt, pos))
        yield (f"K3q {pool} main (B 16, MP 64, ps 16, pos 128-1023)", "paged_attention_quant",
               lambda nk=nk, nv=nv, pk=pk, pv=pv, pks=pks, pvs=pvs:
               kpq.paged_decode_attention_quant(q3, nk, nv, pk, pv, pks, pvs, bt, pos), plain)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="the other tree's csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    build.build(NAMES)   # this tree's, all nvcc processes at once
    this = {n: build.library(n) for n in NAMES}
    other = build_other(args.other)
    for label, name, call, plain in cases():
        want = plain().float()
        turns = []
        for side in ("this", "other", "other", "this"):
            build._LIBS[name] = this[name] if side == "this" else other[name]
            got = call().float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if err > cs.KERNEL_RTOL[torch.bfloat16] * max(1.0, want.abs().max().item()):
                raise AssertionError(f"{label}: the {side} build is {err:.3g} from plain")
            turns.append({"side": side, "device_ms": cs._device_ms(call), "max_abs_err": err})
        build._LIBS[name] = this[name]
        mean = {s: sum(t["device_ms"] for t in turns if t["side"] == s) / 2
                for s in ("this", "other")}
        print(json.dumps({"case": label, "turns": turns, "this_ms": mean["this"],
                          "other_ms": mean["other"],
                          "this_over_other": mean["this"] / mean["other"]}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
