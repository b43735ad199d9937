"""Builds the hand-written Hopper kernels and counts their launches.

Every ``csrc/*.cu`` file is compiled by one ``nvcc`` call into a shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), which is
loaded with ``ctypes``. The library goes to ``coral_tpu_torch/_build/`` under a
name that hashes the sources and the flags, so an edited source or another
GELU table set builds anew and a stale library is never loaded. The build runs
at the first kernel launch, never at import: the CPU tests import every module
on machines without ``nvcc``. A failed build raises.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from .gelu_poly import GELU_POLY_CHOICE

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# Launches of each kernel since the last reset: a wrapper adds one right after
# its kernel was launched without error, and nowhere else. ``chip_smoke.py``
# reads them to show that a run went through the kernels.
launch_counts: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points and their argument types (see each csrc/*.cu).
_SIGNATURES = {
    # x, gamma, beta, y, rows, C, is_bf16, apply_gelu, eps, stream
    "coral_ln_gelu": [_P, _P, _P, _P, _LL, _I, _I, _I, _F, _P],
    # x, w, bias, gamma, beta, y, B, T_in, T_out, C, K, eps, stream
    "coral_conv_ln_gelu": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, bq, bk, bv, key_bias, o, lse, B, T, H, stride_b, stride_t,
    # scale, stream
    "coral_attention_fwd": [_P] * 9 + [_I, _I, _I, _LL, _LL, _F, _P],
    # x, w1, b1, gamma, beta, g, M, D, F, eps, stream
    "coral_ffn_ln_fwd": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built"
    )


def _flags() -> list[str]:
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    if GELU_POLY_CHOICE == "f32":
        flags.append("-DCORAL_GELU_POLY_F32=1")
    return flags


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha256(" ".join(_flags()).encode())
        for path in sorted(CSRC.iterdir()):
            digest.update(path.name.encode() + path.read_bytes())
        target = BUILD_DIR / f"libcoral_kernels_{digest.hexdigest()[:16]}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *_flags(), "-o", tmp, *map(str, sources)]
            start = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            build_seconds = time.perf_counter() - start
            (BUILD_DIR / (target.stem + ".ptxas.txt")).write_text(proc.stderr)
            os.replace(tmp, target)  # atomic: concurrent builds agree
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def launch(symbol: str, kernel: str, *args) -> None:
    """Calls C entry point ``symbol`` on the current stream, raises unless the
    launch succeeded, and counts it under ``kernel``."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: launch failed with CUDA error {err}")
    launch_counts[kernel] += 1


def check_cuda(name: str, dtype, *tensors) -> None:
    """Raises unless every tensor is a contiguous CUDA tensor on one device,
    16-byte aligned and of ``dtype``."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs 16-byte aligned tensors")


def require_cuda(name: str, x) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain path for device {x.device}")
