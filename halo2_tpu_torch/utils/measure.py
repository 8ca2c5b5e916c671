"""Env-gated timing spans and kernel-time counters.

Counterpart of `halo2_tpu/utils/measure.py` (the reference's measurement
harness, `plonk.rs:48-140`: `start_measure` / `stop_measure` with an
indent counter printed under MEASURE=1, `log_info` under INFO=1, and the
FFT / MSM totals reset per proof, `poly/domain.rs:21`, `arithmetic.rs:39`).

A span is a host timer that first waits for queued CUDA work
(`torch.cuda.synchronize()`, when CUDA is in use), so a stage's seconds
include the device work it launched; it is also a
`torch.profiler.record_function` range, so the same names label a profiler
trace. Seconds accumulate per span name, and per category ('fft' | 'msm')
into the per-proof totals.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

import torch

_state = threading.local()
_lock = threading.Lock()
_totals = {"fft": 0.0, "msm": 0.0}
_records: dict = {}  # span name -> accumulated wall seconds (always on)


def measure_enabled() -> bool:
    return os.environ.get("MEASURE", "0") not in ("", "0")


def info_enabled() -> bool:
    return os.environ.get("INFO", "0") not in ("", "0")


def log_info(msg: str):
    """Gated print (reference plonk.rs:127-140)."""
    if info_enabled():
        print(msg)


def _indent() -> int:
    return getattr(_state, "indent", 0)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def span(name: str, category: str = None):
    """Time the enclosed block into the record for `name` and, for a
    category of the totals, into that total; print it with indentation
    under MEASURE=1."""
    enabled = measure_enabled()
    if enabled:
        print("  " * _indent() + f"{name} ...")
        _state.indent = _indent() + 1
    _sync()
    start = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _sync()
        dt = time.perf_counter() - start
        with _lock:
            if category in _totals:
                _totals[category] += dt
            _records[name] = _records.get(name, 0.0) + dt
        if enabled:
            _state.indent = _indent() - 1
            print("  " * _indent() + f"{name}: {dt * 1e3:.2f} ms")


def reset_totals():
    """Reset the per-proof totals (reference prover.rs:63-67)."""
    with _lock:
        for k in _totals:
            _totals[k] = 0.0


def get_totals() -> dict:
    with _lock:
        return dict(_totals)


def report_totals():
    """Print the per-proof totals under MEASURE=1 (reference prover.rs:697-704)."""
    if measure_enabled():
        t = get_totals()
        print(f"FFT total: {t['fft'] * 1e3:.2f} ms; MSM total: {t['msm'] * 1e3:.2f} ms")


def reset_records():
    with _lock:
        _records.clear()


def get_records() -> dict:
    """Per-span-name accumulated wall seconds since the last reset."""
    with _lock:
        return dict(_records)
