"""Row LayerNorm (+ polynomial GELU): ``ln_gelu`` and ``ln_fused``, with backward.

Port of ``coral_tpu/ops/ln_gelu_pallas.py``: the forward ``_fwd_kernel`` and
the backward ``_bwd_kernel`` with its ``custom_vjp`` (:195-219). On a CUDA
tensor the wrappers launch ``csrc/ln_gelu.cu`` (``apply_gelu`` a flag of one
kernel each way); on a CPU tensor they run the plain versions beside them,
the same fp32 math as the JAX kernels. ``plain=True`` runs the plain versions
on any device: the reference the kernel path is held against on the card.

The backward writes dx and per-block dgamma/dbeta partials; their sum, as in
the JAX package, runs outside the kernel. Gradients come back in the dtype of
each input, so bf16 work copies of gamma and beta get bf16 gradients, as
``.astype(gamma.dtype)`` gives them in JAX.
"""

from __future__ import annotations

import torch

from . import _build
from .gelu_poly import _dgelu, gelu_poly

# Where a width no kernel was built for is queued.
WIDTHS_ROADMAP = "other widths: ROADMAP.md, Queue 2 item 3"

_EPS = 1e-5
# Widths the kernels take, by the dtype of x (csrc/ln_gelu.cu): the forward
# at every wav2vec2 encoder width in bf16 (XLS-R-300M, -1B, -2B; 512 is the
# feature encoder's), the backward at every model width with a bf16 x (the
# encoder LNs' gradients, and the FFN backward's LN step with an fp32 dy).
KERNEL_C = {torch.bfloat16: (512, 1024, 1280, 1920), torch.float32: (512, 1024)}
KERNEL_C_BWD = {torch.bfloat16: (384, 512, 768, 1024, 1280, 1920),
                torch.float32: (512, 1024, 1280)}


def _name(base: str, C: int) -> str:
    """The launch counter's name: the base at 512 and 1024, which the first
    instantiations took, else with the width (``ln_bwd_1920``)."""
    return base if C in (512, 1024) else f"{base}_{C}"


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


def ln_bwd_plain(x, gamma, beta, dy, eps: float = _EPS, apply_gelu: bool = True):
    """``_bwd_kernel`` in plain ops: the statistics recomputed from x in fp32,
    ``g = dy * gelu'(z)`` with GELU, ``dx = (dn - mean(dn) - n mean(dn n))
    rstd`` for ``dn = g gamma``. Returns (dx in x.dtype, dgamma, dbeta) fp32."""
    C = x.shape[-1]
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    c = x32 - mu
    rstd = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    n = c * rstd
    gamma = gamma.float()
    g = dy.float()
    if apply_gelu:
        g = g * _dgelu(n * gamma + beta.float())
    dn = g * gamma
    dx = (dn - dn.mean(dim=-1, keepdim=True)
          - n * (dn * n).mean(dim=-1, keepdim=True)) * rstd
    return dx.to(x.dtype), (g * n).reshape(-1, C).sum(0), g.reshape(-1, C).sum(0)


def _check_row_op(name, x, gamma, beta, widths):
    C = x.shape[-1]
    if x.dtype not in widths:
        raise TypeError(f"{name}: the kernel takes bf16 or fp32, got {x.dtype}")
    if C not in widths[x.dtype]:
        raise ValueError(f"{name}: the kernel takes C in {widths[x.dtype]} for {x.dtype}, "
                         f"got {C}; " + WIDTHS_ROADMAP)
    _build.check_cuda(name, x.dtype, x)
    _build.check_cuda(name, torch.float32, gamma, beta)
    if gamma.shape != (C,) or beta.shape != (C,) or gamma.device != x.device:
        raise ValueError(f"{name}: gamma and beta must be ({C},) on {x.device}")
    return C


def _ln(x, gamma, beta, eps, apply_gelu):
    name = "coral_ln_gelu"
    if not _build.require_cuda(name, x):
        return ln_gelu_plain(x, gamma, beta, eps, apply_gelu)
    C = _check_row_op(name, x, gamma, beta, KERNEL_C)
    y = torch.empty_like(x)
    _build.launch(
        name, _name("ln_gelu" if apply_gelu else "ln_fused", C), x.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), x.numel() // C, C,
        int(x.dtype == torch.bfloat16), int(apply_gelu), float(eps),
    )
    return y


def ln_bwd(x, gamma, beta, dy, eps: float = _EPS, apply_gelu: bool = True):
    """The backward kernel: (dx in x.dtype, dgamma (C,) fp32, dbeta (C,) fp32).

    Args:
        x: (..., C) the forward's input, bf16 or fp32; on CUDA C is in
            ``KERNEL_C_BWD`` for its dtype.
        gamma, beta: (C,) fp32.
        dy: x's shape; bf16 (with a bf16 x) or fp32.
    """
    name = "coral_ln_bwd"
    if not _build.require_cuda(name, x):
        return ln_bwd_plain(x, gamma, beta, dy, eps, apply_gelu)
    C = _check_row_op(name, x, gamma, beta, KERNEL_C_BWD)
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    if dy.dtype not in (torch.bfloat16, torch.float32) or (
        dy.dtype == torch.bfloat16 and x.dtype != torch.bfloat16
    ):
        raise TypeError(f"{name}: the kernel takes dy in bf16 (with bf16 x) or fp32, "
                        f"got {dy.dtype} with {x.dtype}")
    _build.check_cuda(name, dy.dtype, dy)
    rows = x.numel() // C
    # As many blocks as the card holds at once (the library's choice); the
    # partials are (blocks, 2, C).
    flags = (int(x.dtype == torch.bfloat16), int(dy.dtype == torch.bfloat16), int(apply_gelu))
    blocks = _build.library().coral_ln_bwd_blocks(rows, C, *flags)
    if blocks < 1:
        raise RuntimeError(f"{name}: no block count for C = {C} ({x.dtype} x, {dy.dtype} dy)")
    dx = torch.empty_like(x)
    part = torch.empty((blocks, 2, C), dtype=torch.float32, device=x.device)
    _build.launch(
        name, _name("ln_bwd", C), x.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), dy.data_ptr(), dx.data_ptr(), part.data_ptr(), rows, C, blocks,
        *flags, float(eps),
    )
    dvec = part.sum(0)
    return dx, dvec[0], dvec[1]


class _LayerNorm(torch.autograd.Function):
    """``_ln_gelu``'s custom VJP: residuals (x, gamma, beta), backward kernel.
    Given ``saved`` (the output a remat policy kept), the forward returns it
    without a launch."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, apply_gelu, plain, saved):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.apply_gelu, ctx.plain = eps, apply_gelu, plain
        if saved is not None:
            return saved.detach()
        fwd = ln_gelu_plain if plain else _ln
        return fwd(x, gamma.float(), beta.float(), eps, apply_gelu)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        bwd = ln_bwd_plain if ctx.plain else ln_bwd
        dx, dg, db = bwd(x, gamma.float(), beta.float(), dy.contiguous(), ctx.eps,
                         ctx.apply_gelu)
        return dx, dg.to(gamma.dtype), db.to(beta.dtype), None, None, None, None


def ln_gelu(x, gamma, beta, eps: float = _EPS, plain: bool = False):
    """``gelu(layer_norm(x) * gamma + beta)`` over the last axis, differentiable.

    Args:
        x: (..., C) bf16 or fp32; on CUDA, C is in ``KERNEL_C`` for its dtype.
        gamma, beta: (C,); cast to fp32 for the kernel.
        plain: run the plain versions (forward and backward) on any device.

    Returns:
        Same shape and dtype as ``x``.
    """
    return _LayerNorm.apply(x, gamma, beta, eps, True, plain, None)


def ln_fused(x, gamma, beta, eps: float = _EPS, plain: bool = False, saved=None):
    """Plain LayerNorm through the same kernels, without the GELU; ``saved``
    is the output a checkpoint replay already holds (no launch)."""
    return _LayerNorm.apply(x, gamma, beta, eps, False, plain, saved)
