"""Measured calibration: probe solves fitted back into the cost model.

The auto-tuner's probe solves (:func:`repro_torch.api.autotune.tune`) are
measured samples of the cost model's compute term. This module keeps them
and feeds them back into :func:`repro_torch.core.costmodel.calibrate_weights`,
so a session with ``probe_solves=0`` inherits weights *fitted from earlier
measured runs* instead of the measured per-op kernel weights (card) or the
analytic counts (CPU).

Model
-----
One measured solve of a plan at RHS width R costs, in the block-op model,

    us  ~=  c0  +  c_solve * su  +  c_mem * tu  +  c_flop * tf

where ``(su, tu, tf) = (sum(ws)*R, sum(wu), sum(wu)*R)`` are the plan's
schedule work units (:func:`repro_torch.api.autotune.plan_work_units`) and
``c0`` is a fixed per-solve dispatch overhead, fitted and discarded: it is
the same for every candidate of a solve, so it cancels in plan ranking. Each
probe records one sample keyed by ``(device type, backend, B)`` and
deduplicated by the plan's *bucket-width signature* (re-probing the same
schedule replaces its sample). Fitting:

* samples spanning >= 2 distinct R and a full-rank system fit all three
  marginal coefficients directly;
* the uniform-R case collapses ``tu``/``tf`` into one tile column (they are
  collinear); the fitted total tile cost is split into its mem/flop parts by
  the unfitted weights' ratio at the samples' mean R (``calibrate_weights``
  with ``feedback=False``: measured on the card, analytic on the CPU);
* when the sample set mixes schedulers whose work units price differently,
  the pooled fit can violate the sign guards; the fitter then retries per
  sched group — largest group first — and returns the first trustworthy fit;
* under-determined or ill-conditioned sample sets return ``None`` and the
  caller keeps the unfitted weights.

**Samples from the CPU and the card never mix.** On the CPU the fused
backends run the megakernel's plain version, so every group key and probe
signature carries the device type (``cuda:fused/B32``).

Persistence: ``CalibrationStore(path=...)`` saves after every ``record`` and
loads on construction; env ``REPRO_TORCH_CALIBRATION=weights.json`` makes the
process-global store durable across sessions.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading

import numpy as np
import torch

ENV_CALIBRATION = "REPRO_TORCH_CALIBRATION"

MIN_SAMPLES = 2  # one sample cannot separate solve from tile cost
COND_LIMIT = 1e8  # reject ill-conditioned fits (near-collinear work units)


def _device_type(device) -> str:
    return torch.device(device).type


def probe_signature(plan, R: int = 1, device="cuda") -> str:
    """Stable id of what a probe measured: device type x sched x comm x
    backend x block size x the plan's bucket-width schedule x RHS width.
    Same schedule, same signature — re-probes replace the sample."""
    from repro_torch.core.solver import level_widths

    cfg = plan.config
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(level_widths(plan)).tobytes())
    head = (f"{_device_type(device)}:{cfg.sched}/{cfg.comm}/"
            f"{cfg.kernel_backend or 'default'}")
    return f"{head}/B{plan.bs.B}/R{int(R)}/{h.hexdigest()[:12]}"


class CalibrationStore:
    """Measured (work-units -> wall-clock) samples per (device type, backend,
    B), with least-squares weight fitting and JSON persistence."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._samples: dict[str, dict] = {}  # "cuda:backend/B##" -> {sig: sample}
        self._fits: dict[str, tuple | None] = {}
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            self.load(path)

    @staticmethod
    def _key(backend: str, B: int, device) -> str:
        return f"{_device_type(device)}:{backend}/B{int(B)}"

    def record(self, *, backend: str, B: int, device, signature: str,
               solve_units: float, tile_units: float, tile_flop_units: float,
               R: int, measured_us: float, persist: bool = True) -> None:
        """Install one measured sample (replacing any prior sample with the
        same signature) and persist when the store has a path and
        ``persist`` (false on the ranks of a group but rank 0, so two ranks
        never write one file)."""
        sample = {
            "su": float(solve_units), "tu": float(tile_units),
            "tf": float(tile_flop_units), "R": int(R),
            "us": float(measured_us),
        }
        key = self._key(backend, B, device)
        with self._lock:
            self._samples.setdefault(key, {})[signature] = sample
            self._fits.pop(key, None)
        if self.path and persist:
            self.save(self.path)

    def samples(self, backend: str, B: int, device) -> dict:
        with self._lock:
            return dict(self._samples.get(self._key(backend, B, device), {}))

    def sample_groups(self) -> dict[str, dict]:
        """Snapshot of every ``"device:backend/B##" -> {sig: sample}`` group."""
        with self._lock:
            return {k: dict(v) for k, v in self._samples.items()}

    def n_samples(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._samples.values())

    # -- fitting ----------------------------------------------------------

    def fitted_weights(self, B: int, backend: str, device) -> tuple | None:
        """``(1.0, w_tile_mem, w_tile_flop)`` fitted from this store's
        samples for ``(device type, backend, B)``, or ``None`` when the
        samples cannot support a trustworthy fit. Cached per key until new
        samples arrive, so repeat calls return the identical tuple."""
        key = self._key(backend, B, device)
        with self._lock:
            if key in self._fits:
                return self._fits[key]
            samples = dict(self._samples.get(key, {}))
        fit = _fit_weights(samples, B, backend, device)
        with self._lock:
            self._fits[key] = fit
        return fit

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        with self._lock:
            blob = {"version": 1, "samples": self._samples}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic: concurrent readers see old or new

    def load(self, path: str) -> None:
        with open(path) as f:
            blob = json.load(f)
        if blob.get("version") != 1:
            raise ValueError(f"unknown calibration file version in {path!r}")
        with self._lock:
            self._samples = {k: dict(v) for k, v in blob["samples"].items()}
            self._fits.clear()


def _fit_weights(samples: dict, B: int, backend: str, device) -> tuple | None:
    """Fit ``{signature: sample}``; pooled first, per-sched groups on guard
    failure (heterogeneous schedulers price a work unit differently)."""
    fit = _fit_sample_set(list(samples.values()), B, backend, device)
    if fit is not None:
        return fit
    groups: dict[str, list] = {}
    for sig, s in samples.items():
        groups.setdefault(sig.split("/", 1)[0], []).append(s)
    for _, grp in sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[0])):
        if len(grp) < len(samples):
            fit = _fit_sample_set(grp, B, backend, device)
            if fit is not None:
                return fit
    return None


def _fit_sample_set(samples: list, B: int, backend: str, device) -> tuple | None:
    if len(samples) < MIN_SAMPLES:
        return None
    su = np.array([s["su"] for s in samples], dtype=np.float64)
    tu = np.array([s["tu"] for s in samples], dtype=np.float64)
    tf = np.array([s["tf"] for s in samples], dtype=np.float64)
    us = np.array([s["us"] for s in samples], dtype=np.float64)
    if not (np.all(np.isfinite(us)) and np.all(us > 0) and np.all(su > 0)):
        return None

    if len(samples) >= 3 and len({s["R"] for s in samples}) >= 2:
        w = _solve_affine(np.stack([su, tu, tf], axis=1), us)
        if w is not None and w[0] > 0 and w[1] >= 0 and w[2] >= 0:
            return (1.0, float(w[1] / w[0]), float(w[2] / w[0]))

    # uniform-R (or rank-deficient) path: tu and tf are collinear, so fit the
    # total tile coefficient and split it by the unfitted weights' ratio
    w = _solve_affine(np.stack([su, tu], axis=1), us)
    if w is None or w[0] <= 0 or w[1] < 0:
        return None
    c_tile = float(w[1] / w[0])  # w_tile_mem + w_tile_flop*mean R, w_solve-normed
    r_mean = float(np.mean([s["R"] for s in samples]))
    from repro_torch.core.costmodel import calibrate_weights

    _, hm, hf = calibrate_weights(B, backend, device=device, feedback=False)
    denom = hm + hf * r_mean
    if denom <= 0:
        return (1.0, c_tile, 0.0)  # tiles priced free: keep it all mem-side
    return (1.0, c_tile * hm / denom, c_tile * hf / denom)


def _solve_affine(A: np.ndarray, y: np.ndarray) -> np.ndarray | None:
    """Least squares with an intercept column absorbing the fixed per-solve
    dispatch overhead; the intercept is dropped from the returned vector.
    Falls back to the homogeneous fit when rows cannot support an intercept."""
    ones = np.ones((A.shape[0], 1), dtype=np.float64)
    w = _solve_ls(np.concatenate([ones, A], axis=1), y)
    if w is not None:
        return w[1:]
    return _solve_ls(A, y)


def _solve_ls(A: np.ndarray, y: np.ndarray) -> np.ndarray | None:
    """Least squares with rank/conditioning guards; None when untrustworthy."""
    if A.shape[0] < A.shape[1]:
        return None
    if np.linalg.matrix_rank(A) < A.shape[1]:
        return None
    if np.linalg.cond(A) > COND_LIMIT:
        return None
    w, *_ = np.linalg.lstsq(A, y, rcond=None)
    if not np.all(np.isfinite(w)):
        return None
    return w


# -- streamed/resident crossover --------------------------------------------

# Clamps of the calibrated limit, in resident store bytes (diag + tiles,
# core.solver.resident_store_bytes), from the crossover table behind
# core.solver.DEFAULT_STREAM_LIMIT (perf/stream_crossover.py, NVIDIA H100
# 80GB HBM3 at 700.00 W, PERF.md section 6). Floor: streamed was faster at
# the smallest plan measured (side 32, 0.16 MB, ratio 0.80 at B = 16), so
# nothing keeps a plan resident from below. Ceiling: from side 64 at B = 32
# (1,310,720 bytes) on, the ratio stops moving (0.79-0.82 up to 398 MB), so
# no probe may keep a larger plan resident.
STREAM_LIMIT_FLOOR = 0
STREAM_LIMIT_CEIL = 1_310_720


def _unit_cost(samples: list) -> float | None:
    """Median measured microseconds per schedule work unit (su + tu)."""
    units = np.array([s["su"] + s["tu"] for s in samples], dtype=np.float64)
    us = np.array([s["us"] for s in samples], dtype=np.float64)
    ok = np.isfinite(us) & (us > 0) & (units > 0)
    if not np.any(ok):
        return None
    return float(np.median(us[ok] / units[ok]))


def calibrated_stream_ratio(store: CalibrationStore | None = None,
                            device="cuda") -> float | None:
    """Median streamed / resident time per schedule work unit over the block
    sizes with both ``fused`` and ``fused_streamed`` probe samples on
    ``device``'s type (the card by default: CPU samples time the plain
    versions and say nothing about the card), or ``None`` without a pair."""
    prefix = f"{_device_type(device)}:"
    groups = (store or get_store()).sample_groups()
    fused: dict[str, list] = {}
    streamed: dict[str, list] = {}
    for key, sig_map in groups.items():
        if not key.startswith(prefix):
            continue
        backend, _, b_tag = key[len(prefix):].partition("/")
        if backend == "fused":
            fused.setdefault(b_tag, []).extend(sig_map.values())
        elif backend == "fused_streamed":
            streamed.setdefault(b_tag, []).extend(sig_map.values())
    ratios = []
    for b_tag in sorted(set(fused) & set(streamed)):
        cf = _unit_cost(fused[b_tag])
        cs = _unit_cost(streamed[b_tag])
        if cf is not None and cs is not None and cf > 0:
            ratios.append(cs / cf)
    return float(np.median(ratios)) if ratios else None


def calibrated_stream_limit(store: CalibrationStore | None = None,
                            device="cuda") -> int | None:
    """Measured streamed/resident crossover in resident store bytes, or
    ``None``.

    The auto-tuner's probes time the same compacted schedules under the
    resident (``fused``) and streamed (``fused_streamed``) megakernels;
    their per-work-unit time ratio (:func:`calibrated_stream_ratio`) is a
    direct measurement of what streaming costs.
    :data:`repro_torch.core.solver.DEFAULT_STREAM_LIMIT` is scaled by it and
    clamped to ``[STREAM_LIMIT_FLOOR, STREAM_LIMIT_CEIL]``. ``None`` when no
    block size has paired samples: callers keep the default. Env
    ``REPRO_TORCH_STREAM_LIMIT`` overrides both
    (:func:`repro_torch.core.solver.stream_limit`).
    """
    ratio = calibrated_stream_ratio(store, device)
    if ratio is None:
        return None
    from repro_torch.core.solver import DEFAULT_STREAM_LIMIT

    lim = DEFAULT_STREAM_LIMIT * ratio
    return int(np.clip(lim, STREAM_LIMIT_FLOOR, STREAM_LIMIT_CEIL))


# -- global store ----------------------------------------------------------

_store: CalibrationStore | None = None


def get_store() -> CalibrationStore:
    """The process-global store; durable when env ``REPRO_TORCH_CALIBRATION``
    names a file (loaded on first access, saved after every recorded probe)."""
    global _store
    if _store is None:
        _store = CalibrationStore(path=os.environ.get(ENV_CALIBRATION))
    return _store


def set_store(store: CalibrationStore | None) -> None:
    """Swap the global store (tests; ``None`` re-reads the env on next use)."""
    global _store
    _store = store


def fitted_weights(B: int, backend: str | None = None, device=None) -> tuple | None:
    """Global-store fit for the *resolved executor* backend on ``device``
    (``None``: the card) — the thing the probes actually measured."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    return get_store().fitted_weights(B, ops.executor_backend(backend, dev), dev)
