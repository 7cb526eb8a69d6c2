"""Structured span tracer with a JSONL event sink.

One :class:`Tracer` serializes every record it emits — span closes,
instant events, counter bumps — as one JSON line, appended to a
per-process trace file AND kept in an in-memory list, so the same
derivation code (``repro_torch.obs.report``) can build ``BENCH_sweep``
records live (``runner.LADDER_PERF``) and reconstruct them offline
from the file, bit-exactly.

Threading model: the tracer is fully thread-safe.  Each thread carries
its own *implicit* span stack (``threading.local``), so nested ``with
span(...)`` blocks parent naturally within a thread; work handed to a
different thread (``run_ladder``'s producer pool) attaches to the right
fill via an *explicit* ``parent=`` handle — a :class:`Span` or its
integer id.  Record emission (id allocation, list append, file write)
happens under one lock.

When the file is written: a record joins the in-memory list at once,
and the file at the next root-level record (one with no parent: a root
span closing, an event or count outside any span, a metrics snapshot),
at ``flush`` or at ``close``, when every record not yet in it is
serialized, appended in emission order and flushed.  So a span tree
reaches the file whole when its root closes, and the spans that close
inside it (``trace_gen`` on the generating pool's threads among them)
cost a list append.  A write and flush for each would let go of the
interpreter lock in their system call, and a pool thread would then wait
behind the other generating threads for up to a switch interval (5 ms)
to take it back.  A process killed inside a tree loses that tree's
lines, not the ones before it.

Clock: a span's ``t0`` (and an event's ``t``) is ``time.time()``, the
host's wall clock, which is the clock of ``torch.profiler``'s chrome
trace: an event's ``ts`` plus the trace's ``baseTimeNanoseconds`` / 1e3
is ``time.time()`` in microseconds, so ``t0 * 1e6 - baseTimeNanoseconds
/ 1e3`` places a span on the trace's timeline (held by
``tests/test_torch_spans.py``).  ``dur_s`` is measured on
``time.perf_counter()``.  ``t0`` is stamped when the span is made, not
when it is entered: a caller may make a span, do work, and hand it on to
be entered and closed elsewhere (``core.mmu``'s ``stage`` span, made by
the runner before it stacks the traces).

Records are sanitized to plain JSON values at emission time
(numpy and torch scalars become Python numbers), which is what makes the
file ↔ memory round trip exact: ``json.loads(json.dumps(rec)) == rec``.

The sink path resolves lazily: ``REPRO_OBS_TRACE`` names an explicit
file; otherwise traces land in ``REPRO_OBS_DIR`` (default
``.obs_trace_torch/`` next to the port's sim cache, ``.sim_cache_torch/``
or ``REPRO_TORCH_SIM_CACHE``) as ``trace-torch-<pid>.jsonl``, so a run
of the port and one of the reference never share a trace file.  The
file itself is only created when the first record is written — an
import alone never touches the filesystem.

This module deliberately imports nothing of the package (stdlib only),
so every layer — ``sim.parallel`` included — can emit into it without a
cycle.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

SCHEMA = 1  # JSONL record schema (the "meta" header line carries it)

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.abspath(os.environ.get(
        "REPRO_TORCH_SIM_CACHE",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "..", "..", ".sim_cache_torch")))), ".obs_trace_torch")


def default_path() -> str:
    """The sink path a fresh tracer would write to (env-resolved)."""
    env = os.environ.get("REPRO_OBS_TRACE", "").strip()
    if env:
        return env
    d = os.environ.get("REPRO_OBS_DIR", "").strip() or _DEFAULT_DIR
    return os.path.join(d, f"trace-torch-{os.getpid()}.jsonl")


def _jsonable(v):
    """Coerce an attr value to a plain JSON value (or raise).

    numpy and torch scalars carry ``.item()``; arrays become lists via
    ``.tolist()``.  Anything else non-JSON is repr'd — attrs are
    telemetry, a lossy string beats a crashed sweep — EXCEPT under the
    round-trip-critical kinds, which only ever receive plain values.
    """
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item") and getattr(v, "ndim", None) in (0, None):
        try:
            return _jsonable(v.item())
        except Exception:
            pass
    if hasattr(v, "tolist"):
        try:
            return _jsonable(v.tolist())
        except Exception:
            pass
    return repr(v)


class Span:
    """A handle for an open span: settable attrs, explicit-parent anchor.

    Created via :meth:`Tracer.span`; use as a context manager.  The
    record is emitted at CLOSE time (one line per span), carrying
    ``t0`` (wall clock at open), ``dur_s`` (monotonic duration), the
    span ``id``, its ``parent`` id and ``thread`` name.
    """

    __slots__ = ("tracer", "name", "id", "parent_id", "attrs",
                 "_t0_wall", "_t0_mono", "_closed")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent_id: int | None, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0_wall = time.time()
        self._t0_mono = time.perf_counter()
        self._closed = False

    def set(self, **attrs) -> "Span":
        """Attach/override attrs before the span closes."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.tracer._push(self)
        return self

    def __exit__(self, *exc) -> None:
        self.close(error=bool(exc and exc[0] is not None))

    def close(self, error: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        dur = time.perf_counter() - self._t0_mono
        self.tracer._pop(self)
        rec = {"kind": "span", "name": self.name, "id": self.id,
               "parent": self.parent_id,
               "thread": threading.current_thread().name,
               "t0": self._t0_wall, "dur_s": dur,
               "attrs": {k: _jsonable(v) for k, v in self.attrs.items()}}
        if error:
            rec["error"] = True
        self.tracer._emit(rec)


class Tracer:
    """Thread-safe span tracer + JSONL sink (see module docstring).

    ``overhead_s`` accumulates the monotonic time spent *inside* record
    emission (append, and at a root-level record serialize + write +
    flush) — the number the <2%%-of-sim overhead acceptance test
    bounds.
    """

    def __init__(self, path: str | None = None):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._path = path or default_path()
        self._file = None
        self.events: list[dict] = []
        self._unwritten: list[dict] = []  # records the file lacks yet
        self.overhead_s = 0.0

    @property
    def path(self) -> str:
        return self._path

    # ------------------------------------------------- span plumbing

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, sp: Span) -> None:
        self._stack().append(sp)

    def _pop(self, sp: Span) -> None:
        st = self._stack()
        if sp in st:
            # tolerate out-of-order closes (explicit .close() calls)
            st.remove(sp)

    def current(self) -> Span | None:
        """This thread's innermost open span (implicit parent)."""
        st = self._stack()
        return st[-1] if st else None

    @staticmethod
    def _parent_id(parent) -> int | None:
        if parent is None:
            return None
        return parent.id if isinstance(parent, Span) else int(parent)

    def span(self, name: str, parent: Span | int | None = None,
             **attrs) -> Span:
        """Open a span.  ``parent`` overrides the implicit thread-local
        parent — REQUIRED when the span runs on a different thread than
        the logical parent (e.g. producer-pool trace generation)."""
        pid = (self._parent_id(parent) if parent is not None
               else (self.current().id if self.current() else None))
        with self._lock:
            sid = next(self._ids)
        return Span(self, name, sid, pid, dict(attrs))

    def event(self, name: str, parent: Span | int | None = None,
              **attrs) -> dict:
        """Emit an instant event record."""
        pid = (self._parent_id(parent) if parent is not None
               else (self.current().id if self.current() else None))
        with self._lock:
            sid = next(self._ids)
        rec = {"kind": "event", "name": name, "id": sid, "parent": pid,
               "t": time.time(),
               "attrs": {k: _jsonable(v) for k, v in attrs.items()}}
        self._emit(rec)
        return rec

    def count(self, name: str, n=1, parent: Span | int | None = None,
              **attrs) -> dict:
        """Emit a counter-bump record (the registry increment is the
        caller's job — ``repro_torch.obs.count`` does both)."""
        pid = (self._parent_id(parent) if parent is not None
               else (self.current().id if self.current() else None))
        with self._lock:
            sid = next(self._ids)
        rec = {"kind": "count", "name": name, "id": sid, "parent": pid,
               "t": time.time(), "n": _jsonable(n),
               "attrs": {k: _jsonable(v) for k, v in attrs.items()}}
        self._emit(rec)
        return rec

    def metrics(self, snapshot: dict) -> dict:
        """Emit a metrics-registry snapshot record."""
        rec = {"kind": "metrics", "t": time.time(),
               "data": _jsonable(snapshot)}
        self._emit(rec)
        return rec

    # ------------------------------------------------------ the sink

    def _open(self):
        d = os.path.dirname(self._path)
        if d:
            os.makedirs(d, exist_ok=True)
        f = open(self._path, "a", encoding="utf-8")
        if f.tell() == 0:
            f.write(json.dumps(
                {"kind": "meta", "schema": SCHEMA, "pid": os.getpid(),
                 "t": time.time()}) + "\n")
        return f

    def _emit(self, rec: dict) -> None:
        t0 = time.perf_counter()
        with self._lock:
            self.events.append(rec)
            self._unwritten.append(rec)
            if rec.get("parent") is None:
                self._write()
            self.overhead_s += time.perf_counter() - t0

    def _write(self) -> None:
        """Append the records not yet in the file to it, and flush (with
        the lock held)."""
        if self._file is None:
            self._file = self._open()
        self._file.write("".join(json.dumps(r) + "\n"
                                 for r in self._unwritten))
        self._file.flush()
        self._unwritten.clear()

    def flush(self) -> None:
        with self._lock:
            if self._unwritten or self._file is not None:
                self._write()

    def close(self) -> None:
        with self._lock:
            if self._unwritten:
                self._write()
            if self._file is not None:
                self._file.close()
                self._file = None
