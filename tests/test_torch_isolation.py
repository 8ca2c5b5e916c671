"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

from halo2_tpu_torch.circuits import MulCircuit
from halo2_tpu_torch.curves import Vesta
from halo2_tpu_torch.dev.mock_prover import MockProver
from halo2_tpu_torch.ops import msm_bucket, msm_sorted, ntt_mr, tile_bench
from halo2_tpu_torch.ops.curve import CurveCtx
from halo2_tpu_torch.poly.ipa import ParamsIPA, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "halo2_tpu_torch")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], prefix="halo2_tpu_torch."))


def test_importing_every_port_module_loads_no_jax():
    mods = ["halo2_tpu_torch"] + _port_modules()
    assert "halo2_tpu_torch.ops.msm_sorted" in mods
    assert {"halo2_tpu_torch.ops.ntt_mr", "halo2_tpu_torch.ops.mxu_mont",
            "halo2_tpu_torch.tools.profile_kernels"} <= set(mods)
    assert {"halo2_tpu_torch.dev.mock_prover", "halo2_tpu_torch.plonk.batch",
            "halo2_tpu_torch.gadgets.poseidon"} <= set(mods)
    assert {f"halo2_tpu_torch.gadgets.{m}" for m in (
        "ecc", "ecc_mul", "ecc_fixed", "ecc_api", "sinsemilla_primitives", "sinsemilla",
        "sinsemilla_fused", "sinsemilla_merkle", "sha256")} <= set(mods)
    assert {f"halo2_tpu_torch.parallel{m}" for m in (
        "", ".context", ".ntt", ".msm", ".quotient")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'halo2_tpu' or n.startswith('halo2_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) > 30


@pytest.mark.parametrize("path", ["halo2_tpu_torch", "chip_smoke.py"])
def test_sources_name_no_jax_import(path):
    full = os.path.join(ROOT, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs if f.endswith(".py")]
    for fn in files:
        tree = ast.parse(open(fn).read(), fn)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "halo2_tpu"), f"{fn}: imports {name}"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParamsIPA.cached(Vesta, 4)
    assert resolve_device("cpu") == torch.device("cpu")


def test_mock_prover_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MockProver.run(4, MulCircuit(7, 2, 3), [[252]])
    prover = MockProver.run(4, MulCircuit(7, 2, 3), [[252]], device="cpu")
    assert prover.device == torch.device("cpu") and prover.verify(vectorized=True) == []


def test_kernel_wrappers_refuse_other_devices():
    cc = CurveCtx(Vesta)
    meta = torch.empty((2, 16, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        msm_bucket.msm_accum(meta, meta[0], meta[0], 4, 64, 8, cc)
    with pytest.raises(ValueError, match="unsupported device"):
        msm_bucket.msm_fold(torch.empty((1, 16, 3, 16, 8), dtype=torch.int32, device="meta"), cc)
    with pytest.raises(ValueError, match="unsupported device"):
        msm_bucket.msm_lane_reduce(torch.empty((1, 3, 16, 8), dtype=torch.int32, device="meta"), cc)



def test_sorted_msm_wrappers_refuse_other_devices():
    cc = CurveCtx(Vesta)
    entries = torch.empty((16, 8), dtype=torch.int32, device="meta")
    gstart = torch.empty((16, msm_sorted.LANES + 2), dtype=torch.int32, device="meta")
    rows = torch.empty((8, 16), dtype=torch.int32, device="meta")
    buckets = torch.empty((16, msm_sorted.LANES, msm_sorted.KB, 3, 16), dtype=torch.int32,
                          device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        msm_sorted.msm_sorted_accum(entries, gstart, rows, rows, cc)
    with pytest.raises(ValueError, match="unsupported device"):
        msm_sorted.msm_sorted_fold(buckets, entries, gstart, rows, rows, cc)
    with pytest.raises(ValueError, match="unsupported device"):
        msm_sorted.msm_sorted_horner(torch.empty((16, 3, 16), dtype=torch.int32, device="meta"), cc)


def test_slice_three_wrappers_refuse_other_devices():
    cc = CurveCtx(Vesta)
    ctx = cc.fctx
    x = torch.empty((2, 4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ntt_mr.mr_col_ntt(x, torch.empty((2, 2, 16), dtype=torch.int32, device="meta"), None, ctx)
    rows = torch.empty((8, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tile_bench.tile_mul(rows, rows, ctx)
    with pytest.raises(ValueError, match="unsupported device"):
        tile_bench.tile_padd(rows, rows, rows, rows, rows, cc)
