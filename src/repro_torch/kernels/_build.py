"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`. The library goes to
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, so an unchanged tree builds once. :func:`load` builds at
first use and raises if there is no CUDA device, no ``nvcc`` or a failed
build: nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    # x, scale, y, rows, d, eps, dtype, stream
    "rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _P],
    # x, scale, dy, dx, partial (max_blocks, d), dscale, rows, d,
    # max_blocks, SMs, eps, dtype, stream
    "rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, o, lse (or null), their strides (3 int64 each of q, k, v,
    # o: batch, head, sequence), B, Hq, Hkv, Sq, Skv, D, causal, window,
    # offset, scale, dtype, stream
    "flash_attention_fwd": [_P] * 9 + [_I] * 9 + [_F, _I, _P],
    # q, k, v, o, dout, dq, dk, dv, lse, delta, 24 strides (int64: batch,
    # head, sequence of each of those 8 tensors), B, Hq, Hkv, Sq, Skv, D,
    # causal, window, offset, scale, dtype, stream
    "flash_attention_bwd": [_P] * 11 + [_I] * 9 + [_F, _I, _P],
    # the same, bf16 only (no dtype), lse read: the forward's log-sum-exp
    "flash_attention_bwd_wgmma": [_P] * 11 + [_I] * 9 + [_F, _P],
    # q, k, v, length, o, B, Hq, Hkv, S, D, n_split, chunk, window, scale,
    # dtype, stream
    "decode_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _F, _I, _P],
    # u, dt, A, B, C, D, h0, y, hT, hs (null when serving), Bt, T, d_in, n,
    # B batch/time strides, C batch/time strides, u dtype, stream
    "mamba_scan_fwd": [_P] * 10 + [_I] * 4 + [_L] * 4 + [_I, _P],
    # u, dt, A, B, C, D, hs, dy, dhT (or null), du, ddt, dB, dC, dA, dD, dh0,
    # the partial sums of dB/dC, dA, dD, partial blocks, Bt, T, d_in, n, B
    # batch/time strides, C batch/time strides, u dtype, stream
    "mamba_scan_bwd": [_P] * 19 + [_I] * 5 + [_L] * 4 + [_I, _P],
    # n, u dtype -> resident blocks per SM of that scan instance, forward
    # and backward
    "mamba_scan_blocks_per_sm": [_I, _I],
    "mamba_scan_bwd_blocks_per_sm": [_I, _I],
    # g, numel, partial (blocks), blocks, dtype, stream
    "adamw_sumsq": [_P, _L, _P, _I, _I, _P],
    # partial, its length, max_norm, out (norm, scale), stream
    "adamw_clip_finalize": [_P, _I, _F, _P, _P],
    # p, g, m, v, numel, lr, c1, c2, scale (or null), b1, 1 - b1, b2,
    # 1 - b2, eps, weight decay, decay, blocks, dtype, stream
    "adamw_update": [_P] * 4 + [_L] + [_P] * 4 + [_F] * 6 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None
# What the last build in this process did: path, seconds, compiler output.
last_build: dict = {}


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin);"
                       " the port's CUDA kernels cannot be built")


def _source_key(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/`` into the shared library (if not built yet) and
    return its path. Raises RuntimeError with the compiler output on
    failure."""
    sources = sorted(CSRC.glob("*.cu"))
    key = _source_key(sources + sorted(CSRC.glob("*.cuh")))
    lib_path = BUILD_DIR / f"libreprotorch_{key}.so"
    if lib_path.exists():
        last_build.update(path=str(lib_path), seconds=0.0, cached=True, log="")
        return lib_path
    nvcc = _find_nvcc()
    obj_dir = BUILD_DIR / f"obj_{key}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for src in sources:
            obj = obj_dir / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp = obj_dir / lib_path.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *(str(o) for _, o, _ in procs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, lib_path)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(obj_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / f"build_{key}.log").write_text(log)
    last_build.update(path=str(lib_path), seconds=seconds, cached=False, log=log)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use. Raises RuntimeError
    when there is no CUDA device or the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on the "
                           "card (CPU tensors take the plain versions)")
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = load().repro_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_handle(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
