"""The port stands alone: it imports neither JAX nor the reference package,
and with no GPU its entry points raise instead of running on the CPU."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get
from repro_torch.kernels import _build, ops
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.launch.serve import Request, serve_batch
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.launch.train import train
from repro_torch.optim.optimizers import adamw
from repro_torch.streaming.apps import streaming_inference
from repro_torch.models import transformer
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$|,)|"
    r"from\s+repro(\.|\s))", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_import_leaves_jax_and_repro_out():
    code = ("import importlib, sys\n"
            f"for m in {['repro_torch'] + _modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_streaming_inference_runs_without_jax_or_repro():
    """The predictor's path imports nothing lazily: after a run of the
    inference app, neither ``jax`` nor ``repro`` is loaded."""
    code = ("import sys\n"
            "from repro_torch.streaming.apps import streaming_inference\n"
            "from repro_torch.streaming.runtime import run_app\n"
            "app = streaming_inference(model_versions=1, device='cpu')\n"
            "r = run_app(app, {}, batch=16, max_batches=4, dispatch_depth=2)\n"
            "assert r.states['sink'][0]['seen'] == 64, r.states['sink']\n"
            "assert app.kernels['predictor'].predictor.batches['cpu'] == 4\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_no_source_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hit = FORBIDDEN.search(f.read_text())
        assert hit is None, f"{f.relative_to(ROOT)}: {hit.group(0).strip()}"


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.models import config", "from repro import ops",
                 "import repro"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.kernels import ops",
                 "import jaxlib_free_module_name"):
        assert not FORBIDDEN.search(line), line


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get("smollm_360m", smoke=True)
    params = transformer.init(torch.Generator(), cfg, device="cpu")
    req = [Request(0, np.array([1, 2, 3], np.int32), 2)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch(cfg, params, req, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_decode_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, adamw(1e-3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("smollm_360m", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.load()
    assert _build._lib is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_inference()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_inference(device="cuda:0")


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._find_nvcc()


def test_steps_refuse_params_on_another_device():
    cfg = get("smollm_360m", smoke=True)
    params = transformer.init(torch.Generator(), cfg, device="meta")
    with pytest.raises(ValueError, match="params live on meta"):
        make_prefill_step(cfg, device="cpu")(params, {"inputs": [[1, 2]]})


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    launches on CUDA or raises; it is never computed by the plain version."""
    x = torch.empty(4, 8, device="meta")
    s = torch.empty(8, device="meta")
    q = torch.empty(1, 2, 4, 32, device="meta")
    k = torch.empty(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(x, s)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, :, 0], k, k,
                             length=torch.ones(1, dtype=torch.int32,
                                               device="meta"))
    u = torch.empty(2, 5, 8, device="meta")
    bc = torch.empty(2, 5, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.mamba_scan(u, u, torch.empty(8, 4, device="meta"), bc, bc,
                       torch.empty(8, device="meta"))
    for fn in (rmsnorm_cuda, flash_attention_cuda, decode_attention_cuda,
               mamba_scan_cuda):
        assert fn.launches == 0


def test_cuda_sources_exist_and_target_sm90a():
    names = {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert {"rmsnorm.cu", "flash_attention.cu", "flash_attention_sm90.cu",
            "flash_attention_bwd_sm90.cu", "decode_attention.cu",
            "mamba_scan.cu"} <= names
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name, replaced in (("rmsnorm.cu", "rmsnorm_pallas"),
                           ("flash_attention.cu", "flash_attention_pallas"),
                           ("flash_attention_sm90.cu",
                            "flash_attention_pallas"),
                           ("flash_attention_bwd_sm90.cu",
                            "flash_attention_pallas"),
                           ("decode_attention.cu", "decode_attention_pallas"),
                           ("mamba_scan.cu", "mamba_scan_pallas")):
        head = (PKG / "csrc" / name).read_text().split("#include")[0]
        assert "Replaces: src/repro/kernels/" in head and replaced in head
        assert "Bound on an H100" in head and "Design" in head
    for name, argtypes in _build.SIGNATURES.items():
        for cu in (PKG / "csrc").glob("*.cu"):
            if f'extern "C" int {name}(' in cu.read_text():
                break
        else:
            pytest.fail(f"no C entry point {name}")
