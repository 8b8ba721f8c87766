"""Request-lifecycle tracing: bounded ring buffer -> Chrome-trace JSON.

``TraceRecorder`` collects structured events from the serving hot paths —
arrival, admission, chunk, activation, preemption, requeue, raced_hit,
route, retirement, dispatch, readback — keyed by request id and control
slot. Events are stored as tuples in a preallocated ring (oldest dropped
on overflow, counted), so steady-state recording is an index bump plus a
tuple build.

Disabled tracing must be free: engines hold a ``NullRecorder`` by default
and guard every emit with ``if recorder.enabled`` — the hot path pays one
attribute load and one branch (the overhead budget
tests/test_observability.py asserts).

``chrome_trace()`` exports the Chrome trace event format (Perfetto opens
it directly): ``pid`` = replica, ``tid`` = engine row (so each slot/row is
one timeline lane), complete events ("X") for spans with a duration
(dispatch enqueue, readback consume), instant events ("i") for lifecycle
points. Timestamps are wall-clock microseconds since the recorder's epoch;
``slot`` (control-slot index) rides in ``args``.

In the port every emit sits on the host, outside the bodies the engines
capture as CUDA graphs (a call inside a captured body would run once, at
the capture, and never at a replay), and a ``dispatch`` span is the host's
enqueue time of one graph replay, read from the host clock: nothing here
waits on the card.
"""
from __future__ import annotations

import json
import time

# Event kinds the runtime emits. Not enforced
# at emit time — the recorder is generic — but tests pin the runtime to it.
EVENT_KINDS = (
    "arrival",       # request entered an engine's pending queue
    "admission",     # engine claimed a row for the request
    "chunk",         # one prompt chunk entered the mixed dispatch
    "activation",    # final chunk shipped; first token computed on device
    "preemption",    # active/mid-prefill request bounced back to pending
    "requeue",       # fleet moved the request off a failed/drained replica
    "raced_hit",     # prefix-cache hit degraded by a concurrent eviction
    "route",         # fleet router picked a replica for the request
    "retirement",    # request finished; row freed
    "dispatch",      # host enqueue span of one jitted dispatch
    "readback",      # async counter-copy lifecycle (initiate/consume)
)


class TraceRecorder:
    """Bounded ring buffer of (kind, slot, rid, row, pid, ts, dur, args)."""

    enabled = True

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._buf: list = [None] * capacity
        self._head = 0          # next write index
        self._count = 0         # live events (<= capacity)
        self.dropped = 0        # overwritten events
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Microseconds since the recorder's epoch (wall clock)."""
        return (time.perf_counter() - self._t0) * 1e6

    def emit(self, kind: str, *, slot=None, rid=None, row=None, pid: int = 0,
             ts=None, dur=None, **args) -> None:
        if ts is None:
            ts = self.now()
        i = self._head
        if self._buf[i] is not None:
            self.dropped += 1
        else:
            self._count += 1
        self._buf[i] = (kind, slot, rid, row, pid, ts, dur,
                        args if args else None)
        self._head = (i + 1) % self.capacity

    def __len__(self) -> int:
        return self._count

    def events(self) -> list:
        """Live events as dicts, oldest first."""
        out = []
        start = (self._head - self._count) % self.capacity
        for j in range(self._count):
            kind, slot, rid, row, pid, ts, dur, args = (
                self._buf[(start + j) % self.capacity])
            e = {"kind": kind, "slot": slot, "rid": rid, "row": row,
                 "pid": pid, "ts": ts}
            if dur is not None:
                e["dur"] = dur
            if args:
                e.update(args)
            out.append(e)
        return out

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._head = self._count = 0
        self.dropped = 0
        self._t0 = time.perf_counter()

    # --------------------------------------------------------- exports
    def chrome_trace(self) -> dict:
        """Chrome trace event format (Perfetto/about:tracing-compatible)."""
        events = []
        pids, lanes = set(), set()
        for e in self.events():
            pid = int(e["pid"] or 0)
            tid = int(e["row"]) if e.get("row") is not None else 0
            pids.add(pid)
            lanes.add((pid, tid))
            args = {k: v for k, v in e.items()
                    if k not in ("kind", "pid", "ts", "dur") and v is not None}
            name = e["kind"]
            if e.get("what"):
                name = f"{name}:{e['what']}"
            ev = {"name": name, "cat": e["kind"], "pid": pid, "tid": tid,
                  "ts": float(e["ts"]), "args": args}
            if "dur" in e:
                ev["ph"] = "X"
                ev["dur"] = float(e["dur"])
            else:
                ev["ph"] = "i"
                ev["s"] = "t"   # instant scoped to its thread lane
            events.append(ev)
        meta = [{"name": "process_name", "ph": "M", "pid": p, "tid": 0,
                 "args": {"name": f"replica {p}"}} for p in sorted(pids)]
        meta += [{"name": "thread_name", "ph": "M", "pid": p, "tid": t,
                  "args": {"name": f"row {t}"}} for p, t in sorted(lanes)]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


class NullRecorder(TraceRecorder):
    """Disabled recorder: ``enabled`` is False and every emit is a no-op.

    Hot paths check ``enabled`` before building event kwargs, so a disabled
    engine pays one branch per site; ``emit`` still being callable keeps
    unguarded cold-path sites (shutdown, drains) safe.
    """

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def emit(self, kind: str, **kw) -> None:  # noqa: ARG002 — deliberate no-op
        return None


NULL_TRACE = NullRecorder()
