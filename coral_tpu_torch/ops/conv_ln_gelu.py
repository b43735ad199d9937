"""Fused stride-2 conv + bias + LayerNorm + polynomial GELU, with backward.

Port of ``coral_tpu/ops/conv_ln_gelu_pallas.py`` ``conv_ln_gelu``: the
feature-encoder blocks 1-6 of XLS-R, the forward ``_fwd_kernel`` and the
backward ``_bwd_kernel`` + ``_halo_fixup`` behind the ``custom_vjp``
``_conv_ln_gelu`` (:501-527), whose residuals are ``(x, w, gamma, beta, xhat,
rstd)``. On a CUDA tensor the wrappers launch ``csrc/conv_ln_gelu.cu`` for
every T_in (the JAX wrapper's exact-fit routing to XLA guards its TPU backward
and has no counterpart here); on a CPU tensor they run the plain versions
beside them; ``plain=True`` runs the plain versions on any device.

Without gradients (serving, a frozen feature encoder) the forward writes y
only. With them it also writes xhat, the pre-affine normalised rows rounded
to ``x.dtype`` (bf16 on the card, as the TPU kernel stores it), and the fp32
rstd, and the backward computes the kernel's formula from those: the plain
backward is that formula too, not autograd through the forward.

Weights use PyTorch's ``Conv1d`` layout, (C_out, C_in, k).
"""

from __future__ import annotations

import torch

from . import _build
from .gelu_poly import _dgelu, gelu_poly

KERNEL_C = 512
_BWD_ROW_BLOCKS = 528  # 4 blocks of 8 rows per SM of an H100; partials (528, 3, C)
_DW_CHUNK = 64  # rows of one batch row in a chunk of dW's reduction
# The dW kernel's blocks at most: 16 tiles of 128 x 128 a tap times R row
# ranges. A constant (four waves of one block an SM on an H100's 132 SMs),
# so that the split, and with it dW's bits, depends on the shape alone.
_DW_BLOCKS = 528


def dw_ranges(B: int, T_out: int, k: int) -> int:
    """R, the ranges of 64-row chunks (one batch row each, ``B * ceil(T_out /
    64)`` of them) over which the dW kernel splits its reduction: as many as
    keep ``16 k R`` within ``_DW_BLOCKS``, at least one chunk each."""
    chunks = B * -(-T_out // _DW_CHUNK)
    return max(1, min(chunks, _DW_BLOCKS // (16 * k)))


def bwd_partials(B: int, T_out: int, k: int) -> tuple[int, int]:
    """(row_blocks, R): the row kernel's blocks, each writing one (3, C)
    partial of dvec, and dW's row ranges, each writing a (k, C, C) partial."""
    return max(1, min(-(-B * T_out // 8), _BWD_ROW_BLOCKS)), dw_ranges(B, T_out, k)


def conv_ln_gelu_fwd_plain(x, w, b, gamma, beta, eps: float = 1e-5):
    """The forward in plain ops, the conv accumulated and kept in fp32 up to
    the LayerNorm as the kernel does. (The JAX ``_xla_reference`` rounds the
    conv output to ``x.dtype`` first; in fp32 the two agree.)

    Returns (y in x.dtype, xhat rounded to x.dtype, rstd (B, T_out) fp32)."""
    B, _, C_in = x.shape
    C_out, _, k = w.shape
    patches = x.unfold(1, k, 2)  # (B, T_out, C_in, k)
    T_out = patches.shape[1]
    out = patches.reshape(B, T_out, C_in * k).float() @ w.reshape(C_out, -1).float().t()
    out = out + b.float()
    cen = out - out.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((cen * cen).mean(dim=-1, keepdim=True) + eps)
    xhat = cen * rstd
    y = gelu_poly(xhat * gamma.float() + beta.float())
    return y.to(x.dtype), xhat.to(x.dtype), rstd.squeeze(-1)


def conv_ln_gelu_plain(x, w, b, gamma, beta, eps: float = 1e-5):
    """y of ``conv_ln_gelu_fwd_plain``."""
    return conv_ln_gelu_fwd_plain(x, w, b, gamma, beta, eps)[0]


def conv_ln_gelu_bwd_plain(x, w, gamma, beta, xhat, rstd, dy):
    """``_bwd_kernel`` in plain ops: ``dh = dy gelu'(xhat gamma + beta)``, ``da
    = (dn - mean(dn) - xhat mean(dn xhat)) rstd`` for ``dn = dh gamma``, da
    rounded to x.dtype for the products; input row ``2t + j`` gets ``da[t]
    W_j^T`` and ``dW_j = sum_t x[2t+j]^T da[t]``. Input rows that no output
    reads get dx = 0.

    Returns (dx in x.dtype, dw (C_out, C_in, k) fp32, dvec (3, C_out) fp32:
    dgamma, dbeta, dbias)."""
    dt = x.dtype
    B, T_in, _ = x.shape
    C_out, C_in, k = w.shape
    T_out = dy.shape[1]
    xh = xhat.float()
    g = gamma.float()
    dh = dy.float() * _dgelu(xh * g + beta.float())
    dn = dh * g
    da = (dn - dn.mean(dim=-1, keepdim=True)
          - xh * (dn * xh).mean(dim=-1, keepdim=True)) * rstd.float()[..., None]
    dvec = torch.stack([(dh * xh).sum(dim=(0, 1)), dh.sum(dim=(0, 1)), da.sum(dim=(0, 1))])
    dab = da.to(dt).float()
    wf = w.to(dt).float()
    xf = x.float()
    dx = torch.zeros((B, T_in, C_in), dtype=torch.float32, device=x.device)
    dws = []
    for j in range(k):
        rows = slice(j, j + 2 * T_out - 1, 2)  # input rows 2t + j, t < T_out
        dx[:, rows] += dab @ wf[:, :, j]
        dws.append(torch.einsum("btc,btd->cd", dab, xf[:, rows]))
    return dx.to(dt), torch.stack(dws, dim=-1), dvec


def _check(name, x, w, *vecs):
    """Raises unless x, w and the (C,) vectors are what the kernel takes;
    returns (B, T_in, T_out, k) and w as (C_out, k, C_in) in x.dtype."""
    B, T_in, C = x.shape
    k = w.shape[-1]
    if C != KERNEL_C or w.shape != (C, C, k):
        raise ValueError(
            f"{name}: the kernel takes C_in = C_out = {KERNEL_C}, got x {tuple(x.shape)}"
            f" and w {tuple(w.shape)}"
        )
    T_out = (T_in - k) // 2 + 1
    if T_out < 1:
        raise ValueError(f"{name}: T_in={T_in} is shorter than the kernel k={k}")
    # (C_out, k, C_in): each output channel's k*C_in reduction values
    # contiguous, matching the input rows 2t .. 2t+k-1 read as one span.
    wp = w.to(x.dtype).permute(0, 2, 1).contiguous()
    _build.check_cuda(name, torch.bfloat16, x, wp)
    _build.check_cuda(name, torch.float32, *vecs)
    for v in vecs:
        if v.shape != (C,) or v.device != x.device:
            raise ValueError(f"{name}: b, gamma, beta must be ({C},) on {x.device}")
    return B, T_in, T_out, k, wp


def _k(name, w):
    k = w.shape[-1]
    if k not in (2, 3):
        raise ValueError(f"{name}: covers the k=2/k=3 stride-2 layers, got k={k}")
    return k


def conv_ln_gelu_fwd(x, w, b, gamma, beta, eps: float = 1e-5, residuals: bool = True):
    """The forward kernel: (y, xhat, rstd) as ``conv_ln_gelu_fwd_plain``, or
    (y, None, None) with ``residuals=False`` (the serving launch).

    Args:
        x: (B, T, C) rows; on CUDA bf16 with C = 512.
        w: (C_out, C_in, k) conv weight, k in {2, 3}; cast to ``x.dtype``.
        b, gamma, beta: (C_out,) fp32.
    """
    name = "coral_conv_ln_gelu"
    _k(name, w)
    if not _build.require_cuda(name, x):
        y, xhat, rstd = conv_ln_gelu_fwd_plain(x, w, b, gamma, beta, eps)
        return (y, xhat, rstd) if residuals else (y, None, None)
    B, T_in, T_out, k, wp = _check(name, x, w, b, gamma, beta)
    C = x.shape[-1]
    y = torch.empty((B, T_out, C), dtype=x.dtype, device=x.device)
    xhat = rstd = None
    if residuals:
        xhat = torch.empty_like(y)
        rstd = torch.empty((B, T_out), dtype=torch.float32, device=x.device)
    _build.launch(
        name, "conv_ln_gelu_train" if residuals else "conv_ln_gelu", x.data_ptr(),
        wp.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        None if xhat is None else xhat.data_ptr(), None if rstd is None else rstd.data_ptr(),
        B, T_in, T_out, C, k, float(eps),
    )
    return y, xhat, rstd


def conv_ln_gelu_bwd(x, w, gamma, beta, xhat, rstd, dy):
    """The backward kernels; arguments and results as ``conv_ln_gelu_bwd_plain``.
    One launch: the row kernel, dx, dW's partials over ``dw_ranges`` row
    ranges, and the finish that sums them (and dvec's) in a fixed order into
    dW in the Conv1d layout: two calls give the same bits.

    Args:
        x: (B, T_in, 512) bf16, the forward's input; w: (C_out, C_in, k).
        gamma, beta: (512,) fp32; xhat, dy: (B, T_out, 512) bf16; rstd (B, T_out)
            fp32.
    """
    name = "coral_conv_ln_gelu_bwd"
    _k(name, w)
    if not _build.require_cuda(name, x):
        return conv_ln_gelu_bwd_plain(x, w, gamma, beta, xhat, rstd, dy)
    B, T_in, T_out, k, wp = _check(name, x, w, gamma, beta)
    C = x.shape[-1]
    _build.check_cuda(name, torch.bfloat16, xhat, dy)
    _build.check_cuda(name, torch.float32, rstd)
    if xhat.shape != (B, T_out, C) or dy.shape != (B, T_out, C) or rstd.shape != (B, T_out):
        raise ValueError(f"{name}: xhat and dy must be ({B}, {T_out}, {C}), rstd ({B}, {T_out})")
    row_blocks, R = bwd_partials(B, T_out, k)
    da = torch.empty_like(dy)
    dx = torch.empty_like(x)
    dw_part = torch.empty((R, k, C, C), dtype=torch.float32, device=x.device)
    dvec_part = torch.empty((row_blocks, 3, C), dtype=torch.float32, device=x.device)
    dw = torch.empty((C, C, k), dtype=torch.float32, device=x.device)
    dvec = torch.empty((3, C), dtype=torch.float32, device=x.device)
    _build.launch(
        name, "conv_ln_gelu_bwd", x.data_ptr(), wp.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), xhat.data_ptr(), rstd.data_ptr(), dy.data_ptr(), da.data_ptr(),
        dx.data_ptr(), dw_part.data_ptr(), dvec_part.data_ptr(), dw.data_ptr(), dvec.data_ptr(),
        B, T_in, T_out, C, k, row_blocks, R,
    )
    return dx, dw, dvec


class _ConvLnGelu(torch.autograd.Function):
    """``_conv_ln_gelu``'s custom VJP: residuals (x, w, gamma, beta, xhat,
    rstd); dW summed in fp32 and rounded to the working
    dtype (the JAX kernel's w is ``w.astype(x.dtype)``), then to w's; db in
    fp32, then b's dtype; dgamma and dbeta cast to their parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, eps, plain):
        fwd = conv_ln_gelu_fwd_plain if plain else conv_ln_gelu_fwd
        y, xhat, rstd = fwd(x, w, b.float(), gamma.float(), beta.float(), eps)
        ctx.save_for_backward(x, w, gamma, beta, xhat, rstd)
        ctx.plain, ctx.b_dtype = plain, b.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, gamma, beta, xhat, rstd = ctx.saved_tensors
        bwd = conv_ln_gelu_bwd_plain if ctx.plain else conv_ln_gelu_bwd
        dx, dw, dvec = bwd(x, w, gamma.float(), beta.float(), xhat, rstd,
                           dy.to(x.dtype).contiguous())
        return (dx, dw.to(x.dtype).to(w.dtype), dvec[2].to(ctx.b_dtype),
                dvec[0].to(gamma.dtype), dvec[1].to(beta.dtype), None, None)


def conv_ln_gelu(x, w, b, gamma, beta, eps: float = 1e-5, plain: bool = False):
    """``gelu(layer_norm(conv1d(x, w, stride=2) + b))``, differentiable.

    Args:
        x: (B, T, C) rows; on CUDA bf16 with C = 512.
        w: (C_out, C_in, k) conv weight, k in {2, 3}; cast to ``x.dtype``.
        b, gamma, beta: (C_out,); cast to fp32 for the kernel.
        plain: run the plain versions (forward and backward) on any device.

    Returns:
        (B, (T - k) // 2 + 1, C_out) in ``x.dtype``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b, gamma, beta)):
        return _ConvLnGelu.apply(x, w, b, gamma, beta, eps, plain)
    if plain:
        return conv_ln_gelu_plain(x, w, b, gamma, beta, eps)
    return conv_ln_gelu_fwd(x, w, b.float(), gamma.float(), beta.float(), eps,
                            residuals=False)[0]
