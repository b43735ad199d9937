"""The pre-LN FFN block, forward: ``gelu(layer_norm(x) @ W1^T + b1) @ W2^T + b2``.

Port of ``coral_tpu/ops/ffn_pallas.py`` ``ffn_ln_block`` at dropout rate 0
(serving). On a CUDA tensor the wrapper launches ``csrc/ffn.cu`` for
``g = gelu(bf16(layer_norm(x)) @ W1^T + b1)`` (the JAX ``_fwd_kernel_ln``) and
applies fc2 with ``torch.matmul``, which the JAX package also leaves outside
its kernel (``_fc2``). On a CPU tensor it runs the plain version beside it.

Weights use PyTorch's ``Linear`` layout: W1 (F, D), W2 (D, F).
"""

from __future__ import annotations

import torch

from . import _build
from .gelu_poly import gelu_poly

_KERNEL_D = 1024
_KERNEL_F_TILE = 256


def ffn_ln_fc1_plain(x, w1, b1, gamma, beta, eps: float = 1e-5):
    """``g`` in plain ops: fp32 LayerNorm rounded to ``x.dtype`` (the
    product's operand, as ``_ln_matmul``), the product accumulated in fp32,
    + b1, polynomial GELU, cast to ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    cen = x32 - mu
    var = (cen * cen).mean(dim=-1, keepdim=True)
    ln = (cen * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(x.dtype)
    h = ln.float() @ w1.to(x.dtype).float().t() + b1.float()
    return gelu_poly(h).to(x.dtype)


def _fc2(g, w2, b2):
    """fc2 as ``_fc2``: the product with fp32 accumulation, + b2 in fp32,
    cast to g.dtype. (For bf16 ``torch.matmul`` rounds its output to bf16
    before the bias add; in fp32 the two agree.)"""
    return (torch.matmul(g, w2.to(g.dtype).t()).float() + b2.float()).to(g.dtype)


def ffn_ln_fc1(x, w1, b1, gamma, beta, eps: float = 1e-5):
    """``g = gelu(bf16(layer_norm(x)) @ W1^T + b1)``, the kernel's output.

    Args:
        x: (..., D); on CUDA bf16 with D = 1024.
        w1: (F, D), cast to ``x.dtype``; on CUDA F a multiple of 256.
        b1: (F,) fp32.  gamma, beta: (D,) fp32.

    Returns:
        (..., F) in ``x.dtype``.
    """
    name = "coral_ffn_ln_fwd"
    if not _build.require_cuda(name, x):
        return ffn_ln_fc1_plain(x, w1, b1, gamma, beta, eps)
    D = x.shape[-1]
    F = w1.shape[0]
    if D != _KERNEL_D or w1.shape != (F, D) or F % _KERNEL_F_TILE:
        raise ValueError(
            f"{name}: the kernel takes D = {_KERNEL_D} and F a multiple of "
            f"{_KERNEL_F_TILE}, got x {tuple(x.shape)} and w1 {tuple(w1.shape)}"
        )
    w1 = w1.to(x.dtype)
    _build.check_cuda(name, torch.bfloat16, x, w1)
    _build.check_cuda(name, torch.float32, b1, gamma, beta)
    if b1.shape != (F,) or gamma.shape != (D,) or beta.shape != (D,):
        raise ValueError(f"{name}: b1 must be ({F},), gamma and beta ({D},)")
    if any(t.device != x.device for t in (w1, b1, gamma, beta)):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    g = torch.empty((*x.shape[:-1], F), dtype=x.dtype, device=x.device)
    _build.launch(
        name, "ffn_ln", x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), g.data_ptr(), x.numel() // D, D, F,
        float(eps),
    )
    return g


def ffn_ln_block_plain(x, w1, b1, gamma, beta, w2, b2, eps: float = 1e-5):
    """``ffn_ln_block`` in plain ops (the JAX ``_xla_reference_ln`` + ``_fc2``)."""
    return _fc2(ffn_ln_fc1_plain(x, w1, b1, gamma, beta, eps), w2, b2)


def ffn_ln_block(x, w1, b1, gamma, beta, w2, b2, eps: float = 1e-5):
    """The whole pre-LN FFN at dropout rate 0.

    Args:
        x: (B, T, D) residual stream.
        w1: (F, D); b1: (F,); gamma, beta: (D,); w2: (D, F); b2: (D,).

    Returns:
        (B, T, D) in ``x.dtype`` (the residual add stays outside).
    """
    return _fc2(ffn_ln_fc1(x, w1, b1, gamma, beta, eps), w2, b2)
