"""Span tracer for the solver lifecycle.

The session lifecycle — ``analyse -> partition -> schedule -> factorize ->
solve -> refresh`` — emits *nested spans*: each span records its name, a
monotonically increasing id, its parent span, the wall-clock start offset and
duration, and free-form attributes. Spans wrap **host-side staging only**
(plan construction, executor dispatch, probe loops) and never touch a
tensor, so toggling tracing cannot change a solve's result.

Alignment with ``torch.profiler`` timelines comes from two channels:

* an enabled span enters ``torch.profiler.record_function`` under its own
  name, so host spans appear on the profiler's CPU rows next to the kernels
  they launched;
* the executors open ``sptrsv.level_solve`` / ``sptrsv.tile_update`` /
  ``sptrsv.superstep`` ranges around their launches
  (:func:`executor_scopes`), only when a tracer is enabled or a profiler
  session is active, so a solve with both off does no extra work.

Enable with env ``REPRO_TORCH_TRACE=path.jsonl`` (picked up on the first
:func:`get_tracer` call) or programmatically via :func:`configure_tracing` /
the :func:`trace_to` context manager. Disabled tracing routes through a
shared no-op span object — no allocation, no timestamp reads, no file I/O.

JSONL schema (one JSON object per line, appended so subprocesses can share a
file):

    {"type": "span", "name": "sptrsv.solve", "id": 7, "parent": null,
     "t0_us": 1234.5, "dur_us": 210.0, "attrs": {"R": 1}}
    {"type": "metrics", "t_unix_s": 99.0, "metrics": {...}}   # registry snapshots

Children close before their parents, so a parent's line always appears
*after* all of its children's — readers that need tree order sort by ``id``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

ENV_TRACE = "REPRO_TORCH_TRACE"


class Span:
    """One live span. Use as a context manager; ``set()`` attaches attrs."""

    __slots__ = ("_tracer", "name", "span_id", "parent_id", "t0_ns", "dur_us",
                 "attrs", "_ann")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent_id: int | None, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0_ns = 0
        self.dur_us = 0.0
        self.attrs = attrs
        self._ann = None

    @property
    def enabled(self) -> bool:
        return True

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (e.g. plan shape)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_us = (time.perf_counter_ns() - self.t0_ns) / 1e3
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        self._tracer._finish(self)
        return False


class _NullSpan:
    """Shared do-nothing span: the disabled-tracing fast path."""

    __slots__ = ()
    enabled = False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _NullTracer:
    """Disabled tracer: every call is a constant-time no-op."""

    enabled = False
    path = None

    def span(self, name: str, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def write(self, record: dict) -> None:
        pass

    def export(self) -> list:
        return []

    def close(self) -> None:
        pass


NULL_TRACER = _NullTracer()


class Tracer:
    """Collects nested spans; optionally appends them to a JSONL file.

    Span ids increase monotonically in *open* order, giving a deterministic
    total order independent of wall-clock resolution. Nesting uses a
    per-thread stack so concurrent host threads cannot corrupt parenting;
    the record list and file writes are lock-protected.
    """

    enabled = True

    def __init__(self, path: str | None = None):
        self.path = path
        self._records: list[dict] = []
        self._next_id = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._file = None
        self._t0_ns = time.perf_counter_ns()

    # -- span lifecycle ---------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs) -> Span:
        stack = self._stack()
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        parent = stack[-1].span_id if stack else None
        s = Span(self, name, span_id, parent, attrs)
        stack.append(s)
        return s

    def _finish(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        rec = {
            "type": "span",
            "name": span.name,
            "id": span.span_id,
            "parent": span.parent_id,
            "t0_us": (span.t0_ns - self._t0_ns) / 1e3,
            "dur_us": span.dur_us,
        }
        if span.attrs:
            rec["attrs"] = _jsonable(span.attrs)
        self.write(rec)

    # -- sink -------------------------------------------------------------

    def write(self, record: dict) -> None:
        """Record an arbitrary JSONL line (spans, metrics snapshots, ...)."""
        with self._lock:
            self._records.append(record)
            if self.path is not None:
                if self._file is None:
                    # append + line-buffered: subprocesses can share the file
                    self._file = open(self.path, "a", buffering=1)
                self._file.write(json.dumps(record, sort_keys=True) + "\n")

    def export(self) -> list:
        """All records so far (the in-memory mirror of the JSONL sink)."""
        with self._lock:
            return list(self._records)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def _jsonable(attrs: dict) -> dict:
    """Coerce attribute values to JSON-serializable scalars/strings."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        elif hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            out[k] = v.item()  # numpy scalar
        else:
            out[k] = str(v)
    return out


# -- global tracer ---------------------------------------------------------

_active: Tracer | _NullTracer | None = None


def get_tracer() -> Tracer | _NullTracer:
    """The active tracer. First call honors env ``REPRO_TORCH_TRACE=path.jsonl``;
    without it, tracing stays a no-op until :func:`configure_tracing`."""
    global _active
    if _active is None:
        path = os.environ.get(ENV_TRACE)
        _active = Tracer(path=path) if path else NULL_TRACER
    return _active


def configure_tracing(path: str | None = None, *, enabled: bool = True
                      ) -> Tracer | _NullTracer:
    """Install a tracer (``path=None`` keeps spans in memory only);
    ``enabled=False`` disables tracing entirely. Returns the new tracer."""
    global _active
    if _active is not None:
        _active.close()
    _active = Tracer(path=path) if enabled else NULL_TRACER
    return _active


@contextlib.contextmanager
def trace_to(path: str | None = None):
    """Temporarily install a tracer (tests, scoped CLI runs); restores the
    previous tracer on exit."""
    global _active
    prev = _active
    tracer = Tracer(path=path)
    _active = tracer
    try:
        yield tracer
    finally:
        tracer.close()
        _active = prev


def executor_scopes() -> bool:
    """Whether the executors open their ``record_function`` ranges for this
    solve: a tracer is enabled or a ``torch.profiler`` session is recording.
    Read once per solve, so a solve with both off does no per-level work."""
    return get_tracer().enabled or torch.autograd._profiler_enabled()
