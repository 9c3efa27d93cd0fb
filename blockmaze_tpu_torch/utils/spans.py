"""The port's in-process span recorder.

    with spans.span("prover.upload"):
        ...

records, while the recorder is on (enable() ... disable()), one Span per
block: its name, start and end in time.perf_counter_ns() (the host clock
portbench's traced window puts the card's operations on), its id, its
parent's id (0 for none) and the id of its request's root, the outermost
span open when it started (its own id for a root). Spans nest per thread
and are kept in memory, per process, until drain() takes them out.
carry(fn) hands the spans open on the calling thread to a call of fn on
another thread: prove_batch's combines, on the Prover's combine thread,
nest under the batch's prover.prove_batch and share its root.

Off, span() returns one shared no-op context manager (NOOP) and records
nothing. A dict put in the `info` of what span() returns is the recorded
span's info; NOOP drops it. A span never synchronises the device: where
one covers a wait for the card (device.wait, prover.fetch), the code
inside it waits, as it would without the span.

While the recorder is on, a gc.callbacks hook records each collection of
the interpreter's cyclic garbage collector as a span host.gc, nested under
the span open in the collecting thread, with {"generation": g} as its
info. Durations are inclusive: a span's time holds the host.gc spans and
other spans nested in it.

Timed(name) is a span that is timed whether or not the recorder is on:
its `seconds` after the block (the Prover's laps, which fill
Prover.timings, and prove_batch's limbs), the same start and end as the
span it records when the recorder is on. With sync=, that callable runs
at the block's end, inside the span, unless the block raised. A dict the
block puts in its `info` is the recorded span's info.

The spans the port opens, by layer (`layer.stage`):

- prover: prover.prove and prover.prove_batch (request roots unless a
  service call is open); the laps prover.wires, prover.qap, prover.msm,
  prover.combine (prove) and prover.blinds, prover.dispatch,
  prover.drain (prove_batch); inside them prover.limbs (its info
  {"wires": n, "wide": k}: the witness's n rows and the k of them that
  left the native pass for Python's), prover.upload (its info {"bytes":
  copied to the device, "pinned": 1 if the words crossed from pinned
  memory, else 0, "wide": k}), prover.blinds
  (prove's two make_blind), prover.fetch, prover.unblind, prover.group
  and prover.submit (groth16/prover.py; in prove_batch prover.unblind and
  prover.group run on the combine thread, children of
  prover.prove_batch); prover.blinds (in prove and prove_batch),
  prover.unblind and prover.group carry {"muls": n}, the scalar products
  of curves/native.py they made (2, 5, 6 a proof);
- msm: msm.query, one MSM on one card (msm/pippenger.py msm, which the
  Prover calls five times a proof), its info {"curve", "points", "c",
  "windows": W, "live": the stream's items, "lanes": T, "per_lane": L}
  (lane_cut's T and L; both 0 for an empty stream), host ints the code
  holds anyway; inside it msm.stream, the live stream: digits, window
  keys, the partition with its live count (device.wait) and the sort;
- device.wait: every blocking read of the card on the proof path: the
  Prover's synchronise at the end of each lap and the live count of each
  MSM's stream (msm/pippenger.py sort_live);
- zktx: zktx.prove and zktx.verify (request roots) around every
  gen_*_proof and verify_*_proof, and inside a proof call zktx.notes,
  zktx.witness and zktx.encode (zktx/api.py); zktx.witness carries
  {"gc_held": 1} when zktx/api.py's hold_gc switched the collector off
  for zktx.notes and zktx.witness, {"gc_held": 0} when it was off
  already;
- host.gc: the hook above.
"""

from __future__ import annotations

import functools
import gc
import itertools
import threading
import time
from typing import NamedTuple, Optional


class Span(NamedTuple):
    name: str
    start: int          # time.perf_counter_ns()
    end: int
    id: int
    parent: int         # 0: none
    root: int
    info: Optional[dict] = None


class _Noop:
    """The shared context manager span() returns while the recorder is
    off; what is put in its info is dropped."""
    __slots__ = ()

    @property
    def info(self):
        return None

    @info.setter
    def info(self, value):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()

_on = False
_records: list = []
_ids = itertools.count(1)
_local = threading.local()
_gc_start = [0, 0]      # the running collection's start and generation


def _stack() -> list:
    """The calling thread's open spans, as ids, outermost first."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _open() -> tuple:
    """A new span's (id, parent, root), pushed on the thread's stack."""
    stack = _stack()
    sid = next(_ids)
    ids = (sid, stack[-1], stack[0]) if stack else (sid, 0, sid)
    stack.append(sid)
    return ids


def _close(name: str, start: int, end: int, ids: tuple, info=None):
    stack = _stack()
    if stack and stack[-1] == ids[0]:
        stack.pop()
    _records.append(Span(name, start, end, *ids, info))


class Timed:
    """A block timed whether or not the recorder is on (module docstring);
    recorded as the span `name` when the recorder is on at its start,
    with the `info` the block sets (None unless it sets one)."""
    __slots__ = ("name", "sync", "seconds", "info", "_start", "_ids")

    def __init__(self, name: str, sync=None):
        self.name = name
        self.sync = sync
        self.seconds = 0.0
        self.info = None

    def __enter__(self):
        self._ids = _open() if _on else None
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, *exc):
        if self.sync is not None and exc_type is None:
            self.sync()
        end = time.perf_counter_ns()
        self.seconds = (end - self._start) / 1e9
        if self._ids is not None:
            _close(self.name, self._start, end, self._ids, self.info)
        return False


def span(name: str):
    """The block recorded as the span `name` while the recorder is on;
    NOOP while it is off."""
    return Timed(name) if _on else NOOP


def traced(name: str):
    """A decorator: each call of the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def carry(fn):
    """fn, to be called on another thread, with the spans open on this
    thread now pushed on that thread's stack for the call: what it records
    has the innermost of them as parent and their root as root."""
    ids = tuple(_stack())

    def call(*args, **kwargs):
        stack = _stack()
        n = len(stack)
        stack.extend(ids)
        try:
            return fn(*args, **kwargs)
        finally:
            del stack[n:]
    return call


def _on_gc(phase: str, info: dict):
    if phase == "start":
        _gc_start[0] = time.perf_counter_ns()
        _gc_start[1] = info["generation"]
        return
    end = time.perf_counter_ns()
    stack = _stack()
    sid = next(_ids)
    parent, root = (stack[-1], stack[0]) if stack else (0, sid)
    _records.append(Span("host.gc", _gc_start[0], end, sid, parent, root,
                         {"generation": _gc_start[1]}))


def enable():
    """Start recording (spans and host.gc) in this process."""
    global _on
    _on = True
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def disable():
    """Stop recording; what was recorded stays until drain()."""
    global _on
    _on = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def drain() -> list:
    """The spans recorded since the last drain, in the order they closed;
    the recorder keeps none of them."""
    global _records
    out, _records = _records, []
    return out
