"""Wall-clock spans for the prover's stages.

Counterpart of `halo2_tpu/utils/measure.py` without the profiler hooks: a
span is a host timer that first waits for queued CUDA work
(`torch.cuda.synchronize()`, when CUDA is in use), so a stage's seconds
include the device work it launched. Seconds accumulate per span name.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import torch

_lock = threading.Lock()
_records: dict = {}  # span name -> accumulated wall seconds


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def span(name: str):
    """Time the enclosed block into the record for `name`."""
    _sync()
    start = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        dt = time.perf_counter() - start
        with _lock:
            _records[name] = _records.get(name, 0.0) + dt


def reset_records():
    with _lock:
        _records.clear()


def get_records() -> dict:
    """Per-span-name accumulated wall seconds since the last reset."""
    with _lock:
        return dict(_records)
