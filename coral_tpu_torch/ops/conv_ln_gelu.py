"""Fused stride-2 conv + bias + LayerNorm + polynomial GELU (forward).

Port of ``coral_tpu/ops/conv_ln_gelu_pallas.py`` ``conv_ln_gelu``: the
feature-encoder blocks 1-6 of XLS-R. On a CUDA tensor the wrapper launches
``csrc/conv_ln_gelu.cu`` for every T_in (the JAX wrapper's exact-fit routing
to XLA guards its TPU backward and has no counterpart here); on a CPU tensor it
runs the plain version beside it.

Weights use PyTorch's ``Conv1d`` layout, (C_out, C_in, k).
"""

from __future__ import annotations

import torch

from . import _build
from .gelu_poly import gelu_poly

_KERNEL_C = 512


def conv_ln_gelu_plain(x, w, b, gamma, beta, eps: float = 1e-5):
    """The same math in plain ops, with the conv accumulated and kept in fp32
    up to the LayerNorm, as the kernel does. (The JAX ``_xla_reference``
    rounds the conv output to ``x.dtype`` first; in fp32 the two agree.)"""
    B, _, C_in = x.shape
    C_out, _, k = w.shape
    patches = x.unfold(1, k, 2)  # (B, T_out, C_in, k)
    T_out = patches.shape[1]
    out = patches.reshape(B, T_out, C_in * k).float() @ w.reshape(C_out, -1).float().t()
    out = out + b.float()
    mu = out.mean(dim=-1, keepdim=True)
    cen = out - mu
    var = (cen * cen).mean(dim=-1, keepdim=True)
    z = cen * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return gelu_poly(z).to(x.dtype)


def conv_ln_gelu(x, w, b, gamma, beta, eps: float = 1e-5):
    """``gelu(layer_norm(conv1d(x, w, stride=2) + b))``.

    Args:
        x: (B, T, C) rows; on CUDA bf16 with C = 512.
        w: (C_out, C_in, k) conv weight, k in {2, 3}; cast to ``x.dtype``.
        b, gamma, beta: (C_out,) fp32.

    Returns:
        (B, (T - k) // 2 + 1, C_out) in ``x.dtype``.
    """
    name = "coral_conv_ln_gelu"
    k = w.shape[-1]
    if k not in (2, 3):
        raise ValueError(f"{name}: covers the k=2/k=3 stride-2 layers, got k={k}")
    if not _build.require_cuda(name, x):
        return conv_ln_gelu_plain(x, w, b, gamma, beta, eps)
    B, T_in, C = x.shape
    T_out = (T_in - k) // 2 + 1
    if C != _KERNEL_C or w.shape != (C, C, k):
        raise ValueError(
            f"{name}: the kernel takes C_in = C_out = {_KERNEL_C}, got x {tuple(x.shape)}"
            f" and w {tuple(w.shape)}"
        )
    if T_out < 1:
        raise ValueError(f"{name}: T_in={T_in} is shorter than the kernel k={k}")
    # (C_out, k, C_in): each output channel's k*C_in reduction values
    # contiguous, matching the input rows 2t .. 2t+k-1 read as one span.
    wp = w.to(x.dtype).permute(0, 2, 1).contiguous()
    _build.check_cuda(name, torch.bfloat16, x, wp)
    _build.check_cuda(name, torch.float32, b, gamma, beta)
    for v in (b, gamma, beta):
        if v.shape != (C,) or v.device != x.device:
            raise ValueError(f"{name}: b, gamma, beta must be ({C},) on {x.device}")
    y = torch.empty((B, T_out, C), dtype=x.dtype, device=x.device)
    _build.launch(
        name, "conv_ln_gelu", x.data_ptr(), wp.data_ptr(), b.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), B, T_in, T_out, C, k,
        float(eps),
    )
    return y
