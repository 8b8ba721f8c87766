"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C functions that return
``cudaError_t``; ``csrc/*.cuh`` holds what they share. At first use a
source is compiled for Hopper (``-gencode arch=compute_90a,code=sm_90a``)
into a shared library under ``build/repro_torch/`` at the repository root,
named by a hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one is reused. No nvcc, or a failed build, raises:
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "decode_attention", "paged_attention", "paged_attention_quant",
           "chunk_attention", "paged_chunk_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
# per source: {"seconds": build wall time (0.0 when reused), "ptxas": [...]}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    """The library path, named by a hash of the source, the shared headers
    it may include, and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_USE = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_ptxas(text: str) -> list:
    """Per entry function: registers and spill bytes from ``-Xptxas -v``."""
    out, cur = [], None
    for line in text.splitlines():
        if m := _PTXAS_FN.search(line):
            cur = {"function": m.group(1)}
            out.append(cur)
        elif cur is not None and (m := _PTXAS_SPILL.search(line)):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := _PTXAS_USE.search(line)):
            cur["registers"] = int(m.group(1))
    return out


def build(names=SOURCES) -> dict:
    """Compile every named source that has no library yet, all nvcc
    processes at once. Returns BUILD_INFO for the named sources."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": [], "library": str(target)})
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                            "ptxas": parse_ptxas(log), "library": str(target)}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: BUILD_INFO[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = ctypes.CDLL(BUILD_INFO[name]["library"])
    return lib
