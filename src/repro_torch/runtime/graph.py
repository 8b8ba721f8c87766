"""One engine dispatch as one CUDA graph.

The reference's fused decode is one jitted ``lax.scan`` over a slot's
decode steps, and its chunked loop's mixed dispatch (prompt chunks,
activation, decode) one jitted function: one XLA executable per slot. Their
counterpart here is a ``torch.cuda.CUDAGraph`` per engine and dispatch mode
("fused", "sync", "chunk", and "+s" for each one's sampled variant),
captured at the first dispatch and replayed once per slot, so a slot's
dispatch costs the host one graph launch in place of some hundred kernel
launches per layer and step.

A body is ``body(*inputs) -> (carry, outs)``. ``inputs`` are the
dispatch's per-slot tensors (positions, tokens, block tables, the
sync-free state, a chunk plan, the sampling tables); ``carry`` holds their
values after the dispatch, one per
input (the input itself where the body leaves it alone); ``outs`` is what
the host reads afterwards (tokens, served counts). Everything else the
body touches (weights, KV rings, page pools, recurrent states) is written
in place and keeps its address: the engine passes those tensors as
``fixed``, and a replay over tensors that moved raises.

On the card the first call is the warm-up: the body runs eagerly on a side
stream (kernels built and loaded, cuBLAS handles made), and that run is the
dispatch. The capture follows over static copies of the inputs. Every
later call fills the static inputs in place: a device tensor by a device
copy, skipped when it is already the static one, a host array through
pinned memory with ``non_blocking=True``. Then it replays and returns the
static inputs, which the graph updated in place, as the carry, with the
graph's outputs. Nothing in a replay waits on the device. The engines
make that first call before serving (``Engine.warm_decode``), so no slot
pays the capture's device synchronize.

The kernels' launch counters count Python calls, and a wrapper called
inside the capture launches nothing. So the capture reads its graph's
kernel nodes from libcuda and counts them by kernel function
(``kernels.graph_launch_counts``). The wrappers' counts made during the
capture are taken back, and summed per kernel function they must equal the
graph's nodes; every replay then adds those counts. The nodes confirm the
count of each kernel function, not how it splits among the counters that
share one function: K4p's kernel counts as K4q, K4p or K4p over quantized
pages, and K1's as K1, K1r, K1q or K1rq, by the wrapper that launched it,
and that split is taken from the wrappers' calls during the capture
alone.

On the CPU, or with ``DecodeGraph.enabled`` off (the eager side of an A/B
run), the body runs eagerly at every call. A capture that fails, or a call
the graph was not captured for, raises: nothing falls back to the eager
loop.
"""
from __future__ import annotations

import ctypes
import gc
import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.device import host_to_device


def _on_device(x, device: torch.device) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else host_to_device(x, device)


def _write_back(static: list, carry: Sequence[torch.Tensor]) -> None:
    """Copy each carry value into its static input, in place. A carry that
    is another static input is cloned first, so no copy reads a buffer an
    earlier copy wrote."""
    ids = {id(s) for s in static}
    carry = [c.clone() if c is not s and id(c) in ids else c
             for s, c in zip(static, carry, strict=True)]
    for s, c in zip(static, carry):
        if c is not s:
            s.copy_(c)


class _KernelNodeParams(ctypes.Structure):
    """libcuda's ``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p),
                *((f, ctypes.c_uint) for f in ("gridDimX", "gridDimY", "gridDimZ", "blockDimX",
                                               "blockDimY", "blockDimZ", "sharedMemBytes")),
                ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_CU_STREAM_CAPTURE_STATUS_ACTIVE = 1
_CU_GRAPH_NODE_TYPE_KERNEL = 0
_LIBCUDA: list = []


def _libcuda() -> ctypes.CDLL:
    if not _LIBCUDA:
        _LIBCUDA.append(ctypes.CDLL("libcuda.so.1"))
    return _LIBCUDA[0]


def _cu(fn: str, *args) -> None:
    err = getattr(_libcuda(), fn)(*args)
    if err:
        raise RuntimeError(f"{fn} failed: CUresult {err}")


def function_name(mangled: str) -> str:
    """The unqualified name of a kernel from its (Itanium-mangled) symbol:
    ``_ZN<len><namespace><len><name>I...`` gives ``<name>``; a name that
    is not mangled is its own."""
    m = re.match(r"_ZN?", mangled)
    if m is None:
        return mangled
    i, name = m.end(), mangled
    while (d := re.match(r"\d+", mangled[i:])) is not None:
        n, i = int(d.group()), i + d.end()
        name, i = mangled[i:i + n], i + n
    return name


def captured_kernels(stream: torch.cuda.Stream) -> dict:
    """The kernel nodes of the graph being captured on ``stream``, counted
    by kernel function name (``function_name``)."""
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    _cu("cuStreamGetCaptureInfo_v2", ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status),
        ctypes.byref(ctypes.c_uint64()), ctypes.byref(graph), ctypes.byref(ctypes.c_void_p()),
        ctypes.byref(ctypes.c_size_t()))
    if status.value != _CU_STREAM_CAPTURE_STATUS_ACTIVE:
        raise RuntimeError("the stream is not capturing a graph")
    n = ctypes.c_size_t()
    _cu("cuGraphGetNodes", graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _cu("cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    counts: dict = {}
    for node in nodes:
        kind = ctypes.c_int()
        _cu("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        p, name = _KernelNodeParams(), ctypes.c_char_p()
        _cu("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(p))
        if p.func:
            _cu("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(p.func))
        else:
            _cu("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(p.kern))
        fn = function_name(name.value.decode())
        counts[fn] = counts.get(fn, 0) + 1
    return counts


class DecodeGraph:
    """One engine's dispatch of one mode (a fused or sync-free decode, or
    a chunked loop's mixed dispatch): captured once, replayed per slot (see
    the module docstring)."""

    # False runs every dispatch eagerly, launch by launch: the eager side of
    # an A/B run beside the graphs
    enabled = True

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device
        self.capture = self.enabled and device.type == "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: list = []
        self.outs: tuple = ()
        self.key = None
        self.fixed: list = []
        self.launches: dict = {}   # the graph's launches per counter, per replay
        self.nodes: dict = {}      # its kernel nodes per kernel function
        self.replays = 0

    def __call__(self, body: Callable, inputs: Sequence, *, fixed: Sequence = (),
                 key=None) -> tuple:
        """Run one dispatch: ``(carry, outs)``. ``key`` names what the
        body was built for (the step count); a replay under another key
        raises."""
        if not self.capture:
            return body(*(_on_device(x, self.device) for x in inputs))
        if self.graph is None:
            return self._capture(body, inputs, fixed, key)
        return self._replay(inputs, fixed, key)

    def _capture(self, body, inputs, fixed, key) -> tuple:
        dev = self.device
        self.static = [x.clone() if isinstance(x, torch.Tensor) else host_to_device(x, dev)
                       for x in inputs]
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            carry, outs = body(*self.static)
            _write_back(self.static, carry)
        cur.wait_stream(side)
        for o in outs:
            o.record_stream(cur)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collected object's CUDA
        # event or graph destroyed then (an earlier engine's, freed with its
        # reference cycles) invalidates the capture
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                carry, graph_outs = body(*self.static)
                _write_back(self.static, carry)
                nodes = kernels.graph_launch_counts(captured_kernels(side))
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of the {self.name} decode failed") from e
        finally:
            if collecting:
                gc.enable()
            after = kernels.launch_counts()
            called = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            kernels.add_launch_counts({k: -n for k, n in called.items()})
        if nodes != kernels.function_counts(called):
            raise RuntimeError(f"the {self.name} decode graph holds the kernel nodes {nodes}, "
                               f"the wrappers were called {called} times")
        self.launches, self.nodes = called, nodes
        self.graph, self.outs, self.key = graph, tuple(graph_outs), key
        self.fixed = [(t.data_ptr(), tuple(t.shape)) for t in fixed]
        return self.static, outs

    def _replay(self, inputs, fixed, key) -> tuple:
        if key != self.key:
            raise ValueError(f"the {self.name} decode graph was captured for {self.key!r}, "
                             f"called with {key!r}")
        if [(t.data_ptr(), tuple(t.shape)) for t in fixed] != self.fixed:
            raise RuntimeError(f"the {self.name} decode graph was captured over other cache "
                               "tensors than this call's")
        if len(inputs) != len(self.static):
            raise ValueError(f"the {self.name} decode graph takes {len(self.static)} inputs, "
                             f"got {len(inputs)}")
        for i, (s, x) in enumerate(zip(self.static, inputs)):
            if x is s:
                continue
            src = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            if src.shape != s.shape or src.dtype != s.dtype:
                raise ValueError(f"the {self.name} decode graph was captured for input {i} "
                                 f"{tuple(s.shape)} {s.dtype}, got {tuple(src.shape)} "
                                 f"{src.dtype}")
            if src.device.type == "cpu":
                src = src.pin_memory()
            s.copy_(src, non_blocking=True)
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        self.replays += 1
        return self.static, self.outs
