"""Build and load the port's CUDA kernels (plain C interface, bound by ctypes).

Each source in `halo2_tpu_torch/csrc/` is compiled at first use with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into `build/` at the repository root. The library name carries a hash of the
sources, so an edited kernel is rebuilt and an unchanged one is reused.
`build_all()` starts one nvcc per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
SOURCES = ("ntt_cg", "msm_bucket")
ARCH = "arch=compute_90a,code=sm_90a"

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", CSRC / "field.cuh"):
        h.update(src.read_bytes())
    h.update(ARCH.encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library in parallel; returns wall seconds."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The library for csrc/<name>.cu, built if needed, with each C entry
    point's argument types set from `signatures` (restype is int: the
    entry point returns cudaGetLastError())."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the wrapper launches its kernel), False for a
    CPU tensor (it runs the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def check_tensor(t: torch.Tensor, shape, name: str, device: torch.device) -> None:
    """Raise unless t is a contiguous int32 tensor of `shape` on `device`."""
    if (t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape)
            or t.device != device):
        raise ValueError(
            f"{name}: expected contiguous int32 {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}"
        )


class FieldConsts(ctypes.Structure):
    """Host mirror of `FieldConsts` in csrc/field.cuh."""

    _fields_ = [
        ("p", ctypes.c_uint32 * 8),
        ("twop", ctypes.c_uint32 * 8),
        ("one", ctypes.c_uint32 * 8),
        ("b3", ctypes.c_uint32 * 8),
        ("n0", ctypes.c_uint32),
    ]


@functools.lru_cache(maxsize=None)
def field_consts(p: int, b3_mont: int = 0) -> FieldConsts:
    """Kernel constants of the field mod p (and of a curve with 3b = b3_mont),
    built once per modulus and shared by every launch."""
    def words(v):
        return (ctypes.c_uint32 * 8)(*[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)])

    return FieldConsts(
        words(p), words(2 * p), words((1 << 256) % p), words(b3_mont),
        (-pow(p, -1, 1 << 32)) % (1 << 32),
    )
