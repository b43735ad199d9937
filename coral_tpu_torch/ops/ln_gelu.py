"""Row LayerNorm (+ polynomial GELU): ``ln_gelu`` and ``ln_fused``, with backward.

Port of ``coral_tpu/ops/ln_gelu_pallas.py``: the forward ``_fwd_kernel`` and
the backward ``_bwd_kernel`` with its ``custom_vjp`` (:195-219). On a CUDA
tensor the wrappers launch ``csrc/ln_gelu.cu`` (``apply_gelu`` a flag of one
kernel each way); on a CPU tensor they run the plain versions beside them,
the same fp32 math as the JAX kernels. ``plain=True`` runs the plain versions
on any device: the reference the kernel path is held against on the card.

gamma and beta go to the kernels in their own dtype, bf16 or fp32 (the same
for both), and are widened to fp32 in registers, as the TPU kernel's
``.astype(jnp.float32)`` does. The backward's one C call writes dx and then,
from the row kernel's per-block partials, dgamma and dbeta, summed in a
fixed order and rounded once to gamma's dtype: what ``_ln_gelu_bwd``'s sum
and ``.astype(gamma.dtype)`` give. So bf16 work copies of the weights get
bf16 gradients with no cast or sum kernel around the two launches.

``ln_gelu`` and ``ln_fused`` call the forward wrapper directly when autograd
would record nothing (grad mode off, or no input that requires a gradient);
else they go through ``_LayerNorm``, the same kernels.
"""

from __future__ import annotations

import torch

from . import _build
from .gelu_poly import _dgelu, gelu_poly

# Where a width no kernel was built for is queued.
WIDTHS_ROADMAP = "other widths: ROADMAP.md, Queue 2 item 3"

_EPS = 1e-5
# Widths the kernels take, by the dtype of x (csrc/ln_gelu.cu): the forward
# at every wav2vec2 encoder width in bf16 (wav2vec2-base, XLS-R-300M, -1B,
# -2B; 512 is the feature encoder's), the backward at every model width with a bf16 x (the
# encoder LNs' gradients, and the FFN backward's LN step with an fp32 dy).
KERNEL_C = {torch.bfloat16: (512, 768, 1024, 1280, 1920), torch.float32: (512, 1024)}
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
    rstd`` for ``dn = g gamma``. Returns (dx in x.dtype, dgamma in gamma's
    dtype, dbeta in beta's), the sums over rows in fp32, rounded once."""
    C = x.shape[-1]
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    c = x32 - mu
    rstd = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    n = c * rstd
    gamma32 = gamma.float()
    g = dy.float()
    if apply_gelu:
        g = g * _dgelu(n * gamma32 + beta.float())
    dn = g * gamma32
    dx = (dn - dn.mean(dim=-1, keepdim=True)
          - n * (dn * n).mean(dim=-1, keepdim=True)) * rstd
    return (dx.to(x.dtype), (g * n).reshape(-1, C).sum(0).to(gamma.dtype),
            g.reshape(-1, C).sum(0).to(beta.dtype))


_PARAM_DTYPES = (torch.bfloat16, torch.float32)


def _check_row_op(name, x, gamma, beta, widths):
    C = x.shape[-1]
    built = widths.get(x.dtype)
    if built is None:
        raise TypeError(f"{name}: the kernel takes bf16 or fp32, got {x.dtype}")
    if C not in built:
        raise ValueError(f"{name}: the kernel takes C in {built} for {x.dtype}, "
                         f"got {C}; " + WIDTHS_ROADMAP)
    if gamma.dtype not in _PARAM_DTYPES or beta.dtype != gamma.dtype:
        raise TypeError(f"{name}: the kernel takes gamma and beta both in bf16 or both in "
                        f"fp32, got {gamma.dtype} and {beta.dtype}")
    _build.check_cuda(name, x.dtype, x)
    _build.check_cuda(name, gamma.dtype, gamma, beta)
    if gamma.shape != (C,) or beta.shape != (C,) or gamma.get_device() != x.get_device():
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
        int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16), int(apply_gelu),
        float(eps),
    )
    return y


# The backward's buffers by (device, C, x_bf16, dy_bf16, apply_gelu, gamma's
# dtype): stride-0 templates of the row kernel's (blocks, 2, C) fp32 partials
# and of (2, C) dgamma and dbeta, for ``torch.empty_like``, which allocates
# faster than ``torch.empty`` with a shape, a dtype and a device. blocks is
# the grid the library finds once per card (``coral_ln_bwd_blocks``).
_BWD_BUFFERS: dict = {}


def _bwd_buffers(x, C, x_bf16, dy_bf16, apply_gelu, gdtype):
    """The (blocks, 2, C) fp32 scratch of the row kernel's partials and the
    (2, C) dgamma and dbeta in ``gdtype``, newly allocated."""
    key = (x.get_device(), C, x_bf16, dy_bf16, apply_gelu, gdtype)
    templates = _BWD_BUFFERS.get(key)
    if templates is None:
        blocks = _build.library().coral_ln_bwd_blocks(C, x_bf16, dy_bf16, apply_gelu)
        if blocks < 1:
            raise RuntimeError(f"coral_ln_bwd: no grid for C = {C} (x_bf16 {x_bf16}, "
                               f"dy_bf16 {dy_bf16})")
        templates = (torch.empty((), device=x.device).expand(blocks, 2, C),
                     torch.empty((), dtype=gdtype, device=x.device).expand(2, C))
        _BWD_BUFFERS[key] = templates
    return torch.empty_like(templates[0]), torch.empty_like(templates[1])


def ln_bwd(x, gamma, beta, dy, eps: float = _EPS, apply_gelu: bool = True):
    """The backward kernels: (dx in x.dtype, dgamma in gamma's dtype, dbeta
    in beta's), one C call.

    Args:
        x: (..., C) the forward's input, bf16 or fp32; on CUDA C is in
            ``KERNEL_C_BWD`` for its dtype.
        gamma, beta: (C,), both bf16 or both fp32.
        dy: x's shape; bf16 (with a bf16 x) or fp32.
    """
    name = "coral_ln_bwd"
    if not _build.require_cuda(name, x):
        return ln_bwd_plain(x, gamma, beta, dy, eps, apply_gelu)
    C = _check_row_op(name, x, gamma, beta, KERNEL_C_BWD)
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    x_bf16, dy_bf16 = int(x.dtype == torch.bfloat16), int(dy.dtype == torch.bfloat16)
    if not (dy_bf16 or dy.dtype == torch.float32) or (dy_bf16 and not x_bf16):
        raise TypeError(f"{name}: the kernel takes dy in bf16 (with bf16 x) or fp32, "
                        f"got {dy.dtype} with {x.dtype}")
    _build.check_cuda(name, dy.dtype, dy)
    part, dvec = _bwd_buffers(x, C, x_bf16, dy_bf16, int(apply_gelu), gamma.dtype)
    dx = torch.empty_like(x)
    _build.launch(
        name, _name("ln_bwd", C), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), part.data_ptr(), part.shape[0], dvec.data_ptr(),
        x.numel() // C, C, x_bf16, dy_bf16, int(gamma.dtype == torch.bfloat16),
        int(apply_gelu), float(eps),
    )
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
        return fwd(x, gamma, beta, eps, apply_gelu)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        bwd = ln_bwd_plain if ctx.plain else ln_bwd
        dx, dg, db = bwd(x, gamma, beta, dy.contiguous(), ctx.eps, ctx.apply_gelu)
        return dx, dg, db, None, None, None, None


def _layer_norm(x, gamma, beta, eps, apply_gelu, plain, saved):
    """Through ``_LayerNorm`` where autograd records the call; else the same
    forward directly (``saved`` returned as it is, no launch)."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _LayerNorm.apply(x, gamma, beta, eps, apply_gelu, plain, saved)
    if saved is not None:
        return saved.detach()
    return (ln_gelu_plain if plain else _ln)(x, gamma, beta, eps, apply_gelu)


def ln_gelu(x, gamma, beta, eps: float = _EPS, plain: bool = False, saved=None):
    """``gelu(layer_norm(x) * gamma + beta)`` over the last axis, differentiable.

    Args:
        x: (..., C) bf16 or fp32; on CUDA, C is in ``KERNEL_C`` for its dtype.
        gamma, beta: (C,), both bf16 or both fp32, read in their own dtype;
            their gradients come back in it.
        plain: run the plain versions (forward and backward) on any device.
        saved: the output a checkpoint replay already holds, or a stand-in it
            never reads (no launch).

    Returns:
        Same shape and dtype as ``x``.
    """
    return _layer_norm(x, gamma, beta, eps, True, plain, saved)


def ln_fused(x, gamma, beta, eps: float = _EPS, plain: bool = False, saved=None):
    """Plain LayerNorm through the same kernels, without the GELU; ``saved``
    is the output a checkpoint replay already holds (no launch)."""
    return _layer_norm(x, gamma, beta, eps, False, plain, saved)
