"""Telemetry: span tracing, metrics registry, measured calibration.

* :mod:`repro_torch.obs.trace`       — nested lifecycle spans -> JSONL
  (``REPRO_TORCH_TRACE=path.jsonl``), aligned with ``torch.profiler``
  timelines through ``record_function`` ranges.
* :mod:`repro_torch.obs.metrics`     — typed counters/gauges/histograms
  unifying the solver's plan-static and runtime stats behind one
  ``snapshot()``/JSONL sink.
* :mod:`repro_torch.obs.calibration` — measured probe timings persisted per
  (device type, backend, bucket-width signature) and fitted back into
  ``core.costmodel.calibrate_weights`` (``REPRO_TORCH_CALIBRATION=weights.json``).
* :mod:`repro_torch.obs.timing`      — device time of a run of launches by
  CUDA events, without the host's gaps.

Tracing never touches a tensor, so solve results are bit-identical with it
on or off; with it off the null tracer is a shared no-op.
"""
from repro_torch.obs.calibration import (
    CalibrationStore,
    calibrated_stream_limit,
    calibrated_stream_ratio,
    fitted_weights,
    get_store,
    probe_signature,
    set_store,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    record_plan_metrics,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    Tracer,
    configure_tracing,
    get_tracer,
    trace_to,
)

__all__ = [
    "CalibrationStore", "calibrated_stream_limit", "calibrated_stream_ratio",
    "fitted_weights",
    "get_store", "probe_signature",
    "set_store", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "record_plan_metrics", "NULL_TRACER", "Tracer",
    "configure_tracing", "get_tracer", "trace_to",
]
