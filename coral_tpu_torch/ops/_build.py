"""Builds the hand-written Hopper kernels and counts their launches.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together (``-gencode arch=compute_90a,code=sm_90a``), and the objects are
linked into one shared library with a plain C interface, which is loaded with
``ctypes``. The library goes to ``coral_tpu_torch/_build/`` under a
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

import torch

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
_U = ctypes.c_uint
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points and their argument types (see each csrc/*.cu).
_SIGNATURES = {
    # x, gamma, beta, y, rows, C, is_bf16, gb_bf16, apply_gelu, eps, stream
    "coral_ln_gelu": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
    # x, gamma, beta, dy, dx, part, part_blocks, dvec, rows, C, x_bf16,
    # dy_bf16, gb_bf16, apply_gelu, eps, stream (the row kernel, then the
    # column kernel that writes dvec)
    "coral_ln_bwd": [_P] * 6 + [_I, _P, _LL, _I, _I, _I, _I, _I, _F, _P],
    # C, x_bf16, dy_bf16, apply_gelu: the row kernel's grid on the current
    # card, the rows of part coral_ln_bwd needs at most (found once per card),
    # -1 for an unbuilt combination (no launch)
    "coral_ln_bwd_blocks": [_I, _I, _I, _I],
    # x, w, bias, gamma, beta, y, xhat, rstd, B, T_in, T_out, C, K, eps, stream
    "coral_conv_ln_gelu": [_P] * 8 + [_I] * 5 + [_F, _P],
    # x, w, gamma, beta, xhat, rstd, dy, da, dx, dw_part, dvec_part, dw, dvec,
    # B, T_in, T_out, C, K, row_blocks, R, stream
    "coral_conv_ln_gelu_bwd": [_P] * 13 + [_I] * 7 + [_P],
    # mode, then coral_conv_ln_gelu_bwd's arguments up to R, events (4
    # cudaEvent_t or null), stream: the probe's modes (tools/probe_fe_bwd.py)
    "coral_conv_ln_gelu_bwd_probe": [_I] + [_P] * 13 + [_I] * 7 + [_P, _P],
    # x, w, out, M, D, F, n1, n2, prng, seed, stream (tools/probe_gelu_cost.py)
    "coral_probe_gelu_cost": [_P] * 3 + [_LL, _I, _I, _I, _I, _I, _U, _P],
    # x, w, ones, out, M, D, mxu, nred, stream (tools/probe_lane_reduce.py)
    "coral_probe_lane_reduce": [_P] * 4 + [_LL, _I, _I, _I, _P],
    # q, k, v, bq, bk, bv, key_bias, o, lse, B, T, H, head_dim, stride_b,
    # stride_t, scale, v1, stream (bq null: without biases; lse null: o alone;
    # v1: the v1 forward)
    "coral_attention_fwd": [_P] * 9 + [_I, _I, _I, _I, _LL, _LL, _F, _I, _P],
    # q, k, v, B, T, H, D, stride_b, stride_t, reps: host ns per forward
    # launch spent encoding its tensor maps (no launch)
    "coral_attention_fwd_map_ns": [_P] * 3 + [_I, _I, _I, _I, _LL, _LL, _I],
    # q, k, v, bq, bk, bv, key_bias, do, lse, o, delta, dq, dk, dv, db_part, B,
    # T, H, head_dim, stride_b, stride_t, stride_d, scale, sm_scale, stream (bq
    # null: the kernels without biases; delta: the dq kernel's scratch)
    "coral_attention_bwd": [_P] * 15 + [_I, _I, _I, _I, _LL, _LL, _LL, _F, _F, _P],
    # q, k, v, key_bias, do, lse, o, m, l, delta, dq, dk, dv, B, T, H,
    # head_dim, stride_b, stride_t, stride_d, scale, sm_scale, mode, stream
    # (the other routes' backwards, whose dq kernel sweeps the keys twice and
    # writes m, l and delta for the dkv kernel, csrc/attention_rows.cu)
    "coral_attention_bwd_rows": [_P] * 13 + [_I, _I, _I, _I, _LL, _LL, _LL, _F, _F, _I, _P],
    # x, w1, b1, gamma, beta, seeds, g, M, D, F, T, threshold, scale, eps,
    # stream
    "coral_ffn_ln_fwd": [_P] * 7 + [_LL, _I, _I, _I, _U, _F, _F, _P],
    # x, w1, b1, gamma, beta, dy, w2, seeds, g, dh, ln_out, db1_part, dl, M, D,
    # F, T, threshold, scale, eps, stream
    "coral_ffn_bwd": [_P] * 13 + [_LL, _I, _I, _I, _U, _F, _F, _P],
    # D: the kernels' rows per block at width D, -1 for an unbuilt width (no
    # launch)
    "coral_ffn_row_tile": [_I],
    # x, w1, b1, seeds, g, M, D, F, T, threshold, scale, stream
    "coral_ffn_fc1_fwd": [_P] * 5 + [_LL, _I, _I, _I, _U, _F, _P],
    # x, w1, b1, dg, seeds, g (null: not written), dh, db1_part, dx, M, D, F,
    # T, threshold, scale, stream
    "coral_ffn_fc1_bwd": [_P] * 9 + [_LL, _I, _I, _I, _U, _F, _P],
    # x, w1, b1, gamma, beta, dg, seeds, dh, ln_out, db1_part, dl, M, D, F, T,
    # threshold, scale, eps, stream
    "coral_ffn_ln_fc1_bwd": [_P] * 11 + [_LL, _I, _I, _I, _U, _F, _F, _P],
    # x, w1, b1, gamma, beta, dg, seeds, g, dh, ln_out, db1_part, dl, M, D, F,
    # T, threshold, scale, eps, stream
    "coral_ffn_ln_g_bwd": [_P] * 12 + [_LL, _I, _I, _I, _U, _F, _F, _P],
    # x, w1, b1, gamma, beta, dy, dg, seeds, g, dh, ln_out, db1_part, dl, dw1,
    # dw2, dw_part, M, D, F, T, threshold, scale, eps, R, stream (dw_part: dW's
    # (R, 2, F D) fp32 partials, read where R > 1)
    "coral_ffn_ln_dw_bwd": [_P] * 16 + [_LL, _I, _I, _I, _U, _F, _F, _I, _P],
    # x, w1, b1, gamma, beta, w2, b2, seeds, y, ln (the normalised rows,
    # scratch), M, D, F, T, threshold, scale, eps, stream
    "coral_ffn_ln_fc2_fwd": [_P] * 10 + [_LL, _I, _I, _I, _U, _F, _F, _P],
    # D, *cluster: N7's cluster size at width D into *cluster; returns the
    # clusters the current card holds at once, -1 for an unbuilt width or a
    # failed query (no launch)
    "coral_ffn_ln_fc2_clusters": [_I, _P],
    # x, w, b, gamma, beta, y, M, D, F, eps, stream
    "coral_ln_dense_fwd": [_P] * 6 + [_LL, _I, _I, _F, _P],
    # x, w, gamma, beta, dy, ln_out, db_part, dl, M, D, F, eps, stream
    "coral_ln_dense_bwd": [_P] * 8 + [_LL, _I, _I, _F, _P],
    # emit, skip, valid, lengths, out, T, B, S, ld (emit's row pitch), stream
    "coral_ctc_alpha": [_P] * 5 + [_I] * 4 + [_P],
    # emit, skip, valid, lengths, last, out, T, B, S, ld, stream
    "coral_ctc_beta": [_P] * 6 + [_I] * 4 + [_P],
    # mode (0 the kernel, 1 its latency floor), R (states a thread, 0: the
    # kernel's choice), beta, emit, skip, valid, lengths, last, out, T, B, S,
    # ld, stream (tools/probe_ctc.py)
    "coral_ctc_probe": [_I, _I, _I] + [_P] * 6 + [_I] * 4 + [_P],
    # q, k, v, o, m, l, seg, B, T, Tk, H, head_dim, stride_b, stride_t, scale,
    # stream
    "coral_flash_attention_fwd": [_P] * 7 + [_I] * 5 + [_LL, _LL, _F, _P],
    # q, k, v, o, dout, m, l, seg, di, dq, dk, dv, B, T, Tk, H, head_dim,
    # stride_b, stride_t, scale, stream (dq non-null: the dq kernel, which
    # writes di; else the dkv kernel, which reads it)
    "coral_flash_attention_bwd": [_P] * 12 + [_I] * 5 + [_LL, _LL, _F, _P],
    # q, k, v, dout, B, T, H, head_dim, stride_b, stride_t, reps: host ns per
    # backward launch spent encoding its tensor maps (no launch)
    "coral_flash_attention_bwd_map_ns": [_P] * 4 + [_I] * 4 + [_LL, _LL, _I],
    # x, dy, out, seeds, B, T, F, threshold, scale, stream
    "coral_gelu_dropout": [_P] * 4 + [_I, _I, _I, _U, _F, _P],
    # q, k, v, mask, out, B, K, n_keys, H, L, layer, C, scale, stream (mask
    # null: the cross-attention; C: the cluster size, one launch)
    "coral_decode_attention": [_P] * 5 + [_I] * 7 + [_F, _P],
    # K: the blocks a call of K beams may launch on the current card (one
    # wave, at most two an SM), -1 if the query fails
    "coral_decode_wave_blocks": [_I],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
# Each source's nvcc seconds in the last build (the processes run together).
source_seconds: dict[str, float] = {}


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
    """The flags of each source's compilation."""
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    if GELU_POLY_CHOICE == "f32":
        flags.append("-DCORAL_GELU_POLY_F32=1")
    return flags


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Runs the commands as processes started together; waits for every one.
    Each result's ``seconds`` is its process's wall time."""
    start = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    done: list = [None] * len(cmds)

    def wait(i: int) -> None:
        out, err = procs[i].communicate()
        done[i] = subprocess.CompletedProcess(cmds[i], procs[i].returncode, out, err)
        done[i].seconds = time.perf_counter() - start

    waiters = [threading.Thread(target=wait, args=(i,)) for i in range(len(cmds))]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    return done


def _compile(sources: list[Path], target: Path) -> str:
    """Compiles ``sources`` in parallel and links them into ``target``;
    returns ptxas's report. Raises with nvcc's output if a step fails."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        lib = str(Path(tmp) / "lib.so")
        steps = [_run_all([[_nvcc(), *_flags(), "-c", "-o", obj, str(src)]
                           for src, obj in zip(sources, objs)])]
        if all(p.returncode == 0 for p in steps[0]):
            steps.append(_run_all([[_nvcc(), "-shared", "-o", lib, *objs]]))
        for proc in (p for step in steps for p in step):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(proc.args)}\n"
                                   f"{proc.stdout}\n{proc.stderr}")
        os.replace(lib, target)  # atomic: concurrent builds agree
    source_seconds.clear()
    source_seconds.update({src.name: p.seconds for src, p in zip(sources, steps[0])})
    return "".join(p.stderr for p in steps[0])


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use; once it
    is loaded, without taking the lock."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
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
            start = time.perf_counter()
            report = _compile(sources, target)
            build_seconds = time.perf_counter() - start
            (BUILD_DIR / (target.stem + ".ptxas.txt")).write_text(report)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def current_stream() -> int:
    """The current device's current CUDA stream, the handle that
    ``torch.cuda.current_stream().cuda_stream`` gives, without making a
    ``Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(symbol: str, kernel: str, *args) -> None:
    """Calls C entry point ``symbol`` on the current stream, raises unless the
    launch succeeded, and counts it under ``kernel``."""
    err = getattr(library(), symbol)(*args, current_stream())
    if err != 0:
        raise RuntimeError(f"{symbol}: launch failed with CUDA error {err}")
    launch_counts[kernel] += 1


def check_cuda(name: str, dtype, *tensors) -> None:
    """Raises unless every tensor is a contiguous CUDA tensor on one device,
    16-byte aligned and of ``dtype``."""
    dev = tensors[0].get_device()
    for t in tensors:
        if (t.get_device() != dev or t.dtype != dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            _layout_error(name, dtype, tensors)


def _layout_error(name: str, dtype, tensors) -> None:
    """Raises for the first tensor that ``check_cuda`` refuses, saying why."""
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
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain path for device {x.device}")
