"""Typed metrics registry.

One home for the plan-static quantities (``dispatch_stats`` / ``cut_stats`` /
``comm_bytes_per_solve``) and the runtime ones (cache hit rates, refresh
counts, per-solve wall-clock, probe timings). Three instrument types:

* :class:`Counter`   — monotonically increasing event count (``inc``),
* :class:`Gauge`     — last-written value (``set``),
* :class:`Histogram` — running count/sum/min/max/last of observations
  (``observe``) — enough for wall-clock distributions without binning.

``snapshot()`` returns a plain JSON-serializable dict and ``dump()`` appends
it as one JSONL line (the same sink format the span tracer uses, so a trace
file can interleave spans and metrics snapshots).

:func:`record_plan_metrics` mirrors a plan's ``dispatch_stats``/``cut_stats``
and its byte counts under ``plan.*`` gauges, so a snapshot of a known plan
agrees field for field with the stats it unifies.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time


class Counter:
    __slots__ = ("value",)

    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, v: int = 1) -> None:
        self.value += v

    def snap(self):
        return self.value


class Gauge:
    __slots__ = ("value",)

    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def snap(self):
        return self.value


class Histogram:
    __slots__ = ("count", "total", "vmin", "vmax", "last")

    kind = "histogram"

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.last = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.last = v

    def snap(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "last": 0.0}
        return {"count": self.count, "sum": self.total, "min": self.vmin,
                "max": self.vmax, "mean": self.total / self.count,
                "last": self.last}


class MetricsRegistry:
    """Named typed instruments, created on first use.

    Re-requesting a name with a different instrument type is a programming
    error and raises — one name, one meaning, for the life of the registry.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """``{name: value}`` for every instrument (histograms as summary
        dicts), JSON-serializable, sorted by name."""
        with self._lock:
            return {name: _jsonable(self._metrics[name].snap())
                    for name in sorted(self._metrics)}

    def dump(self, path: str) -> dict:
        """Append one ``{"type": "metrics", ...}`` JSONL line; returns the
        snapshot it wrote."""
        snap = self.snapshot()
        rec = {"type": "metrics", "t_unix_s": time.time(), "metrics": snap}
        with open(path, "a", buffering=1) as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        return snap

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


def _jsonable(v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (int, float, str)) or v is None:
        return v
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()  # numpy scalar
    return str(v)


def record_plan_metrics(registry: MetricsRegistry, plan, *, prefix: str = "plan"
                        ) -> MetricsRegistry:
    """Mirror a plan's static probes into ``prefix.*`` gauges.

    Covers exactly the quantities the solver already reports — launch /
    dispatch / exchange counts, the fused executor's on-chip plan
    (``streamed``, ``fused_vmem_bytes``, ``stream_dma_bytes``, by the port's
    Hopper rule), the collective payload (``comm_bytes_per_solve``), and the
    partition's cut/balance statistics (``boundary_fraction``,
    ``level_cost_imbalance``, ...) — so the registry snapshot reconciles
    field for field with ``dispatch_stats``/``cut_stats``.
    """
    from repro_torch.core.partition import cut_stats
    from repro_torch.core.solver import dispatch_stats

    g = registry.gauge
    for k, v in dispatch_stats(plan).items():
        g(f"{prefix}.{k}").set(_jsonable(v))
    g(f"{prefix}.comm_bytes_per_solve").set(plan.comm_bytes_per_solve)
    g(f"{prefix}.n_levels").set(plan.n_levels)
    g(f"{prefix}.n_devices").set(plan.n_devices)
    g(f"{prefix}.n_buckets").set(len(plan.buckets))
    g(f"{prefix}.n_boundary_rows").set(plan.n_boundary_rows)
    for f in dataclasses.fields(cs := cut_stats(plan.bs, plan.part)):
        g(f"{prefix}.{f.name}").set(_jsonable(getattr(cs, f.name)))
    return registry


# -- global registry -------------------------------------------------------

_global = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (contexts record here unless handed
    their own)."""
    return _global
