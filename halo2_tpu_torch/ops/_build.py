"""Build and load the port's CUDA kernels (plain C interface, bound by ctypes).

Each source in `halo2_tpu_torch/csrc/` is compiled at first use with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into `build/` at the repository root. The library name carries a hash of the
source and of every header of `csrc/` (and of any `-D` defines a variant is
built with), so an edited kernel is rebuilt and an unchanged one is reused;
nvcc's `-Xptxas -v` output
lies beside it under the same name, `.log` for `.so`. `build_all()` starts
one nvcc per library at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
SOURCES = ("ntt_cg", "msm_bucket", "msm_sorted", "ntt_mr", "tile_bench", "field_ew", "fold", "scan",
           "polyeval", "ipa_round")
ARCH = "arch=compute_90a,code=sm_90a"

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(ARCH.encode())
    for d in defines:
        h.update(b"\0-D" + d.encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """The `-Xptxas -v` output of the build of _target(name, defines)."""
    return _target(name, defines).with_suffix(".log")


def build_all(names: Iterable[str] = SOURCES, defines: Iterable[Tuple[str, ...]] = ((),)) -> float:
    """Compile every missing library, each name under each tuple of `-D`
    defines ("NAME=VALUE"), in parallel; returns wall seconds. A library
    whose log is missing counts as missing."""
    t0 = time.perf_counter()
    todo = [(n, d) for n in names for d in defines
            if not (_target(n, d).exists() and log_path(n, d).exists())]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, defs in todo:
        out = _target(name, defs)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *(f"-D{d}" for d in defs), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, tuple], defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The library for csrc/<name>.cu (built with `-D` `defines`), built if
    needed, with each C entry point's argument types set from `signatures`
    (restype is int: the entry point returns cudaGetLastError())."""
    lib = _libs.get((name, defines))
    if lib is None:
        build_all([name], [defines])
        lib = ctypes.CDLL(str(_target(name, defines)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _libs[(name, defines)] = lib
    return lib


def _kernel_name(mangled: str) -> str:
    """'_ZN...15op_chain_kernelILi6EEEv...' -> 'op_chain_kernel<6>': the first
    length-prefixed name that ends in 'kernel', with its integer and bool
    template arguments."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end():m.end() + int(m.group())]
        if name.endswith("kernel"):
            rest = mangled[m.end() + len(name):]
            args = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
            if args is None:
                return name
            return name + "<" + ",".join(re.findall(r"(\d+)E", args.group(1))) + ">"
    return mangled


def ptxas_usage(name: str, defines: Tuple[str, ...] = ()) -> Dict[str, dict]:
    """Registers, spill bytes (stores and loads) and stack frame bytes (the
    thread's local memory) of each kernel of the library `load(name, ..., defines)` loads, read from its build's
    `-Xptxas -v` output (log_path); raises if that build left none."""
    log = log_path(name, defines)
    if not log.exists():
        raise FileNotFoundError(f"{log}: no ptxas output for the current {name}.cu")
    usage: Dict[str, dict] = {}
    kernel = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
            usage[kernel] = {}
        elif kernel is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                usage[kernel]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[kernel]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes stack frame", line)
            if m:
                usage[kernel]["stack_bytes"] = int(m.group(1))
    return usage


_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def completion_counter(device: torch.device) -> torch.Tensor:
    """The completion counter of kernels D and F for the current stream of a
    CUDA device: one int32 word, 0 between launches (the launch's last block
    sets it back, see csrc/scan.cuh last_block), made at the first call on
    that stream. Launches on one stream run one after another, so they take
    turns on its word; launches on two streams have two words. A CUDA
    graph's capture cannot make it, so a call on the capturing stream must
    come first (as a warm-up on that stream does), and the graph's launches
    keep that stream's word: replay it where no launch on that stream runs
    at the same time."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    counter = _counters.get(key)
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("completion_counter: first asked for inside a CUDA graph's capture; "
                               "call the kernel once on the capturing stream before capturing it")
        counter = _counters[key] = torch.zeros(1, dtype=torch.int32, device=f"cuda:{index}")
    return counter


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def on_card(t, what: str) -> bool:
    """True for a CUDA tensor or device (the wrapper launches its kernel),
    False for a CPU one (it runs the plain version); any other device
    raises."""
    dev = torch.device(t) if isinstance(t, (str, torch.device)) else t.device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {dev}")


def check_tensor(t: torch.Tensor, shape, name: str, device: torch.device, align: int = 0) -> None:
    """Raise unless t is a contiguous int32 tensor of `shape` on `device`
    and, with `align`, its data starts on a multiple of `align` bytes (a
    kernel that loads 16-byte vectors from a view that does not would fault
    with a misaligned address and spoil the CUDA context)."""
    if (t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != tuple(shape)
            or t.device != device):
        raise ValueError(
            f"{name}: expected contiguous int32 {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}"
        )
    if align and t.data_ptr() % align:
        raise ValueError(f"{name}: data at {t.data_ptr():#x} is not {align}-byte aligned")


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
