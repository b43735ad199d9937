"""Row LayerNorm (+ polynomial GELU): ``ln_gelu`` and ``ln_fused``.

Port of ``coral_tpu/ops/ln_gelu_pallas.py`` (forward only). On a CUDA tensor
the wrappers launch ``csrc/ln_gelu.cu`` (one kernel, ``apply_gelu`` a flag);
on a CPU tensor they run the plain version beside it, the same fp32 math as
the JAX off-TPU path.
"""

from __future__ import annotations

import torch

from . import _build
from .gelu_poly import gelu_poly

_EPS = 1e-5
_KERNEL_C = (512, 1024)


def ln_gelu_plain(x, gamma, beta, eps: float = _EPS, apply_gelu: bool = True):
    """Two-pass fp32 statistics over the last axis (mean, then the mean of
    the squared deviations), affine in fp32, optional GELU, cast to x.dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    c = x32 - mu
    var = (c * c).mean(dim=-1, keepdim=True)
    z = c * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    if apply_gelu:
        z = gelu_poly(z)
    return z.to(x.dtype)


def _ln(x, gamma, beta, eps, apply_gelu):
    name = "coral_ln_gelu"
    if not _build.require_cuda(name, x):
        return ln_gelu_plain(x, gamma, beta, eps, apply_gelu)
    C = x.shape[-1]
    if C not in _KERNEL_C:
        raise ValueError(f"{name}: the kernel takes C in {_KERNEL_C}, got {C}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the kernel takes bf16 or fp32, got {x.dtype}")
    _build.check_cuda(name, x.dtype, x)
    _build.check_cuda(name, torch.float32, gamma, beta)
    if gamma.shape != (C,) or beta.shape != (C,) or gamma.device != x.device:
        raise ValueError(f"{name}: gamma and beta must be ({C},) on {x.device}")
    y = torch.empty_like(x)
    _build.launch(
        name, "ln_gelu" if apply_gelu else "ln_fused", x.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), x.numel() // C, C,
        int(x.dtype == torch.bfloat16), int(apply_gelu), float(eps),
    )
    return y


def ln_gelu(x, gamma, beta, eps: float = _EPS):
    """``gelu(layer_norm(x) * gamma + beta)`` over the last axis.

    Args:
        x: (..., C) bf16 or fp32; on CUDA, C is 512 or 1024.
        gamma, beta: (C,) fp32.

    Returns:
        Same shape and dtype as ``x``.
    """
    return _ln(x, gamma, beta, eps, True)


def ln_fused(x, gamma, beta, eps: float = _EPS):
    """Plain LayerNorm through the same kernel, without the GELU."""
    return _ln(x, gamma, beta, eps, False)
