"""Device time of the decode kernels K2, K3, K2q and K3q of this checkout
against the same kernels built from other checkouts' sources, on one card.

Unpack the other tree (for example the parent commit, with ``git archive``)
into a directory that .gitignore lists, then run on the card:

    python3 decode_ab.py --other build/parent/src/repro_torch/kernels/csrc

``--other`` may be given more than once: each case is then timed against
each other build in turn.

Each case (the bf16 main rows of chip_smoke.py's kernels phase: K2, K3,
K2q over int8 codes, K3q over the mixed, int8 and fp8 pools; K2 and K2q at
the granite serves' own geometry: unwrapped rows, pos 128-540 in a ring of
1024; K2 at olmoe-1b-7b's ring, a group of one at hd 128; and K2 and K2q
over int8 and fp8 codes at recurrentgemma-2b's hd 256, 10 heads on one KV
head under window 2048, on the serve's ring of 1024 at pos 512-540 and on
a 2,048-slot ring written past its end) is timed in turns this, other,
other, this: torch.profiler's kernel
time per call, each call after an L2 flush, mean of 20
(``chip_smoke._device_ms``). Both builds must agree with the plain version
within chip_smoke.py's bf16 tolerance. Prints one JSON line per case and
the card's name and power limit.

``--profiles N`` then profiles granite-3-2b's fused and paged serves
(chip_smoke.py's ``SERVE_ARGS`` and ``PAGED_ARGS``) N times with each
build's decode kernels, in turns, as chip_smoke.py's profile phases do
(with each ``--profile-margin`` in turn), and prints for each profile the
port kernels whose records the profile lost against the wrappers' counts
(``kernel_records_missing``; empty when it is complete). With
``KINETO_LOG_LEVEL=1`` in the environment the profiler also logs its own
counts of the records it dropped (``Record counts: Out-of-range = ...``).
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


def start_other(csrc: Path, tag: str) -> dict:
    """Start nvcc on ``csrc``'s decode kernels with this tree's flags, into
    ``build/<tag>``: name -> (process, library path)."""
    out_dir = build.BUILD_DIR / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    return {n: (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{n}.so"),
                                  str(csrc / f"{n}.cu")], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True), out_dir / f"{n}.so")
            for n in NAMES}


def finish_other(procs: dict) -> dict:
    """The libraries ``start_other`` built."""
    for n, (p, _) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the other {n}.cu:\n{log}")
    return {n: ctypes.CDLL(str(so)) for n, (_, so) in procs.items()}


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
    yield from wide_cases(g)


def wide_cases(g):
    """K2 at olmoe-1b-7b's ring (B 8, L 1024, 16 heads on 16, hd 128, pos
    512-540), then K2 and K2q (int8, fp8) at recurrentgemma-2b's hd 256."""
    bf = torch.bfloat16
    rng = np.random.default_rng(29)
    B, L, H, KVH, hd = 8, 1024, 16, 16, 128
    pos_np = (512 + rng.integers(0, 29, B)).astype(np.int32)
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(bf)
    k, v = (torch.randn((B, L, KVH, hd), generator=g, device="cuda").to(bf) for _ in range(2))
    sp = torch.from_numpy(cs._ring_slot_pos(B, L, pos_np)).cuda()
    pos = torch.from_numpy(pos_np).cuda()
    yield ("K2 olmoe-1b-7b (B 8, L 1024, 16/16, hd 128, pos 512-540)", "decode_attention",
           lambda: kd.decode_attention(q, k, v, sp, pos),
           lambda: ref.decode_attention_ref(q, k, v, sp, pos))
    H, KVH, hd, W = 10, 1, 256, 2048
    for L, pos_np, what in ((1024, 512 + rng.integers(0, 29, B), "ring of 1024, pos 512-540"),
                            (2048, 2048 + rng.integers(0, 600, B),
                             "wrapped ring of 2048, pos 2048-2647")):
        pos_np = pos_np.astype(np.int32)
        sp = torch.from_numpy(cs._ring_slot_pos(B, L, pos_np)).cuda()
        pos = torch.from_numpy(pos_np).cuda()
        q = torch.randn((B, H, hd), generator=g, device="cuda").to(bf)
        k, v = (torch.randn((B, L, KVH, hd), generator=g, device="cuda").to(bf) for _ in range(2))
        label = f"recurrentgemma-2b hd 256 (B 8, 10/1, window {W}), {what}"
        yield (f"K2 {label}", "decode_attention",
               lambda q=q, k=k, v=v, sp=sp, pos=pos: kd.decode_attention(q, k, v, sp, pos,
                                                                         window=W),
               lambda q=q, k=k, v=v, sp=sp, pos=pos: ref.decode_attention_ref(q, k, v, sp, pos,
                                                                              window=W))
        for prec in ("int8", "fp8"):
            (qk, ks), (qv, vs) = (quantize_kv(t.float(), parse_kv_precision(prec)) for t in (k, v))
            yield (f"K2q {prec} {label}", "decode_attention_quant",
                   lambda q=q, qk=qk, qv=qv, ks=ks, vs=vs, sp=sp, pos=pos:
                   kd.decode_attention_quant(q, qk, qv, ks, vs, sp, pos, window=W),
                   lambda q=q, qk=qk, qv=qv, ks=ks, vs=vs, sp=sp, pos=pos:
                   ref.decode_attention_quant_ref(q, qk, qv, ks, vs, sp, pos, window=W))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another tree's csrc directory (repeatable)")
    ap.add_argument("--only", default="", help="run only the cases whose label holds this text")
    ap.add_argument("--profiles", type=int, default=0,
                    help="profile the granite serves this many times with each build")
    ap.add_argument("--profile-margin", type=float, action="append",
                    help="seconds the profile opens before and closes after the serve "
                         "(repeatable: each profile round takes each in turn; default "
                         "chip_smoke.PROFILE_MARGIN_S)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 1
    started = {f"other{i}": start_other(csrc, f"other{i}") for i, csrc in enumerate(args.other)}
    build.build()   # this tree's kernels, beside the others' nvcc processes
    builds = {"this": {n: build.library(n) for n in NAMES}}
    builds.update({tag: finish_other(procs) for tag, procs in started.items()})
    others = [s for s in builds if s != "this"]
    for label, name, call, plain in cases() if others else ():
        if args.only not in label:
            continue
        want = plain().float()
        for other in others:
            turns = []
            for side in ("this", other, other, "this"):
                build._LIBS[name] = builds[side][name]
                got = call().float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if err > cs.KERNEL_RTOL[torch.bfloat16] * max(1.0, want.abs().max().item()):
                    raise AssertionError(f"{label}: the {side} build is {err:.3g} from plain")
                turns.append({"side": side, "device_ms": cs._device_ms(call),
                              "max_abs_err": err})
            build._LIBS[name] = builds["this"][name]
            mean = {s: sum(t["device_ms"] for t in turns if t["side"] == s) / 2
                    for s in ("this", other)}
            print(json.dumps({"case": label, "other": str(args.other[others.index(other)]),
                              "turns": turns, "this_ms": mean["this"],
                              "other_ms": mean[other],
                              "this_over_other": mean["this"] / mean[other]}), flush=True)
    margins = args.profile_margin or [cs.PROFILE_MARGIN_S]
    for k in range(args.profiles):
        order = ["this", *others] if k % 2 == 0 else [*others, "this"]
        for side in order:
            build._LIBS.update(builds[side])
            for margin in margins:
                cs.PROFILE_MARGIN_S = margin
                for path, argv in (("fused", cs.SERVE_ARGS), ("paged", cs.PAGED_ARGS)):
                    fields, profiled, counted = cs._profile_serve(argv, 1.0, False)
                    print(json.dumps({"profile": k, "side": side, "path": path,
                                      "margin_s": margin, "complete": profiled == counted,
                                      "graph_replays": fields["graph_replays"],
                                      "kernel_records": profiled,
                                      "kernel_records_missing": fields["kernel_records_missing"]}),
                          flush=True)
        build._LIBS.update(builds["this"])
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
