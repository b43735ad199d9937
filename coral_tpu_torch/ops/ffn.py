"""The pre-LN FFN block: ``dropout(gelu(layer_norm(x) @ W1^T + b1)) @ W2^T + b2``.

Port of ``coral_tpu/ops/ffn_pallas.py`` ``ffn_ln_block`` with
``dg_in_kernel=True`` (``_ffn_ln_block_dg``, :1742-1789), forward and
backward, at any dropout rate, at every width of the repository's configs
(``KERNEL_D``: Whisper tiny, base and small's 384, 512 and 768, XLS-R-300M's
1024, Whisper large-v3's and XLS-R-1B's 1280, XLS-R-2B's 1920); other widths
raise on the card (ROADMAP.md Queue 2 item 3). On a CUDA tensor the wrappers launch
``csrc/ffn.cu``: the forward writes ``g = dropout(gelu(bf16(layer_norm(x)) @
W1^T + b1))`` (``_fwd_kernel_ln`` / ``_fwd_kernel_ln_drop``) and fc2 runs as
``torch.matmul``, which the JAX package also leaves outside its kernel
(``_fc2``); the backward (``_bwd_kernel_ln_g_dg[_drop]``) recomputes h, forms
``dg = dy @ W2^T`` in the kernel, writes g (the dW2 operand), dh and ln_out
(the dW1 operand), computes ``dl = dh @ W1`` in a second kernel and passes dl
through the LayerNorm backward of ``csrc/ln_gelu.cu``. dW1, dW2, db2 and the
sums of the row partials stay outside as products and sums, as in
``_ffn_ln_block_dg_bwd``. On a CPU tensor the plain versions beside them run;
``plain=True`` runs them on any device.

Dropout draws its mask from ``ops/philox.py``: a pure function of (seeds[b],
row, column), so the backward regenerates the forward's mask bit for bit and
a checkpoint replay drops the same elements. It cannot reproduce the TPU's
bits (another generator), and the JAX CPU path (``jax.random.bernoulli``,
``ffn_pallas.py:2136``) is another stream again.

Weights use PyTorch's ``Linear`` layout: W1 (F, D), W2 (D, F).
"""

from __future__ import annotations

import torch

from . import _build
from .gelu_poly import _dgelu, _phi, gelu_poly
from .ln_gelu import WIDTHS_ROADMAP, ln_bwd
from .philox import keep_mask, threshold

# Widths the kernels take, each its own instantiation, counted apart: the
# launches at 1024 under the bare names ("ffn_ln", "ffn_bwd"), the others
# under names ending in the width ("ffn_ln_drop_1920").
KERNEL_D = (384, 512, 768, 1024, 1280, 1920)
KERNEL_F_TILE = 256


def _name(base: str, D: int) -> str:
    return base if D == 1024 else f"{base}_{D}"


def _ln_rows(x, gamma, beta, eps):
    """``_ln_rows``: fp32 LayerNorm; returns (ln rounded to x.dtype, xhat, rstd)."""
    x32 = x.float()
    cen = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((cen * cen).mean(dim=-1, keepdim=True) + eps)
    xhat = cen * rstd
    return (xhat * gamma.float() + beta.float()).to(x.dtype), xhat, rstd


def ffn_ln_fc1_plain(x, w1, b1, gamma, beta, eps: float = 1e-5, rate: float = 0.0,
                     seeds=None):
    """``g`` in plain ops: fp32 LayerNorm rounded to ``x.dtype`` (the
    product's operand, as ``_ln_matmul``), the product accumulated in fp32,
    + b1, polynomial GELU, the dropout mask, cast to ``x.dtype``."""
    ln, _, _ = _ln_rows(x, gamma, beta, eps)
    h = ln.float() @ w1.to(x.dtype).float().t() + b1.float()
    g = gelu_poly(h)
    if rate > 0.0:
        keep = keep_mask(seeds, x.shape[1], w1.shape[0], rate)
        g = torch.where(keep, g * (1.0 / (1.0 - rate)), 0.0)
    return g.to(x.dtype)


def _fc2(g, w2, b2):
    """fc2 as ``_fc2``: the product with fp32 accumulation, + b2 in fp32,
    cast to g.dtype. (For bf16 ``torch.matmul`` rounds its output to bf16
    before the bias add; in fp32 the two agree.)"""
    return (torch.matmul(g, w2.to(g.dtype).t()).float() + b2.float()).to(g.dtype)


def _check_shapes(name, x, w1, F):
    D = x.shape[-1]
    if D not in KERNEL_D or w1.shape != (F, D) or F % KERNEL_F_TILE:
        raise ValueError(
            f"{name}: the kernel takes D in {KERNEL_D} and F a multiple of "
            f"{KERNEL_F_TILE}, got x {tuple(x.shape)} and w1 {tuple(w1.shape)}; "
            + WIDTHS_ROADMAP
        )
    return D


def _check_seeds(name, x, rate, seeds):
    if rate == 0.0:
        return None, 1, 0, 1.0
    if x.dim() != 3 or seeds is None or seeds.shape != (x.shape[0],):
        raise ValueError(f"{name}: dropout needs x (B, T, D) and seeds (B,)")
    if seeds.dtype != torch.int32 or seeds.device != x.device or not seeds.is_contiguous():
        raise ValueError(f"{name}: seeds must be contiguous int32 on {x.device}")
    return seeds.data_ptr(), x.shape[1], threshold(rate), 1.0 / (1.0 - rate)


def ffn_ln_fc1(x, w1, b1, gamma, beta, eps: float = 1e-5, rate: float = 0.0, seeds=None):
    """``g = dropout(gelu(bf16(layer_norm(x)) @ W1^T + b1))``, the kernel's output.

    Args:
        x: (B, T, D); on CUDA bf16 with D in ``KERNEL_D``.
        w1: (F, D), cast to ``x.dtype``; on CUDA F a multiple of 256.
        b1: (F,) fp32.  gamma, beta: (D,) fp32.
        rate: activation-dropout rate in [0, 1).
        seeds: (B,) int32, the mask's seeds (rate > 0).

    Returns:
        (B, T, F) in ``x.dtype``.
    """
    name = "coral_ffn_ln_fwd"
    if not _build.require_cuda(name, x):
        return ffn_ln_fc1_plain(x, w1, b1, gamma, beta, eps, rate, seeds)
    F = w1.shape[0]
    D = _check_shapes(name, x, w1, F)
    w1 = w1.to(x.dtype)
    _build.check_cuda(name, torch.bfloat16, x, w1)
    _build.check_cuda(name, torch.float32, b1, gamma, beta)
    if b1.shape != (F,) or gamma.shape != (D,) or beta.shape != (D,):
        raise ValueError(f"{name}: b1 must be ({F},), gamma and beta ({D},)")
    if any(t.device != x.device for t in (w1, b1, gamma, beta)):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    g = torch.empty((*x.shape[:-1], F), dtype=x.dtype, device=x.device)
    _build.launch(
        name, _name("ffn_ln_drop" if rate > 0.0 else "ffn_ln", D), x.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), gamma.data_ptr(), beta.data_ptr(), seed_ptr, g.data_ptr(),
        x.numel() // D, D, F, T, thr, scale, float(eps),
    )
    return g


def ffn_bwd_plain(x, w1, b1, gamma, beta, dy, w2, eps: float = 1e-5, rate: float = 0.0,
                  seeds=None):
    """``_bwd_kernel_ln_g_dg[_drop]`` + ``_bwd_ln_epilogue`` in plain ops.

    Returns (g, dh, ln_out, dx, db1, dgamma, dbeta): g, dh, ln_out and dx in
    x.dtype; db1 (F,), dgamma and dbeta (D,) fp32. dh is rounded before
    ``dl = dh @ W1`` and summed unrounded into db1, as in the TPU kernel."""
    dt = x.dtype
    D = x.shape[-1]
    ln, xhat, rstd = _ln_rows(x, gamma, beta, eps)
    h = ln.float() @ w1.to(dt).float().t() + b1.float()
    dg = dy.to(dt).float() @ w2.to(dt).float()
    g = h * _phi(h)
    if rate > 0.0:
        keep = keep_mask(seeds, x.shape[1], w1.shape[0], rate)
        scale = 1.0 / (1.0 - rate)
        g = torch.where(keep, g * scale, 0.0)
        dh = torch.where(keep, dg * scale * _dgelu(h), 0.0)
    else:
        dh = dg * _dgelu(h)
    dhb = dh.to(dt)
    dl = dhb.float() @ w1.to(dt).float()
    dn = dl * gamma.float()
    dx = (dn - dn.mean(dim=-1, keepdim=True)
          - xhat * (dn * xhat).mean(dim=-1, keepdim=True)) * rstd
    return (g.to(dt), dhb, ln, dx.to(dt), dh.reshape(-1, dh.shape[-1]).sum(0),
            (dl * xhat).reshape(-1, D).sum(0), dl.reshape(-1, D).sum(0))


def ffn_bwd(x, w1, b1, gamma, beta, dy, w2, eps: float = 1e-5, rate: float = 0.0,
            seeds=None):
    """The backward kernels; arguments and results as ``ffn_bwd_plain``.

    Args:
        x, dy: (B, T, D) bf16, D in ``KERNEL_D``.
        w1: (F, D); w2: (D, F); cast to x.dtype. b1 (F,), gamma, beta (D,) fp32.
    """
    name = "coral_ffn_bwd"
    if not _build.require_cuda(name, x):
        return ffn_bwd_plain(x, w1, b1, gamma, beta, dy, w2, eps, rate, seeds)
    F = w1.shape[0]
    D = _check_shapes(name, x, w1, F)
    w1, w2, dy = w1.to(x.dtype), w2.to(x.dtype).contiguous(), dy.to(x.dtype).contiguous()
    _build.check_cuda(name, torch.bfloat16, x, w1, w2, dy)
    _build.check_cuda(name, torch.float32, b1, gamma, beta)
    if w2.shape != (D, F) or dy.shape != x.shape or b1.shape != (F,):
        raise ValueError(f"{name}: w2 must be ({D}, {F}), dy {tuple(x.shape)}, b1 ({F},)")
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    M = x.numel() // D
    g = torch.empty((*x.shape[:-1], F), dtype=x.dtype, device=x.device)
    dh = torch.empty_like(g)
    ln_out = torch.empty_like(x)
    # One db1 partial per row tile of the kernel (64 rows, 32 at D = 1920).
    row_tile = _build.library().coral_ffn_row_tile(D)
    db1_part = torch.empty((-(-M // row_tile), F), dtype=torch.float32, device=x.device)
    dl = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _build.launch(
        name, _name("ffn_bwd", D), x.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), gamma.data_ptr(), beta.data_ptr(), dy.data_ptr(), w2.data_ptr(),
        seed_ptr, g.data_ptr(), dh.data_ptr(), ln_out.data_ptr(), db1_part.data_ptr(),
        dl.data_ptr(), M, D, F, T, thr, scale, float(eps),
    )
    dx, dgamma, dbeta = ln_bwd(x, gamma, beta, dl, eps, apply_gelu=False)
    return g, dh, ln_out, dx, db1_part.sum(0), dgamma, dbeta


class _FFNBlock(torch.autograd.Function):
    """``_ffn_ln_block_dg``: residuals are the primal inputs and the seeds
    (``ffn_pallas.py:1760``); the backward is the kernels above plus the
    outside products ``dW1 = dh^T ln_out`` and ``dW2 = dy^T g`` (rounded to
    the working dtype, as ``.astype(w1.dtype)`` of the bf16 copies) and
    ``db2 = sum(dy)``. Since no residual comes from the forward, a checkpoint
    replay passes ``saved`` (a tensor it never reads) and nothing runs, as
    the JAX replay drops the block's forward."""

    @staticmethod
    def forward(ctx, x, w1, b1, gamma, beta, w2, b2, seeds, rate, eps, plain, saved):
        ctx.save_for_backward(x, w1, b1, gamma, beta, w2, seeds)
        ctx.rate, ctx.eps, ctx.plain, ctx.b2_dtype = rate, eps, plain, b2.dtype
        if saved is not None:
            return saved.detach()
        fc1 = ffn_ln_fc1_plain if plain else ffn_ln_fc1
        g = fc1(x, w1, b1.float(), gamma.float(), beta.float(), eps, rate, seeds)
        return _fc2(g, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, gamma, beta, w2, seeds = ctx.saved_tensors
        bwd = ffn_bwd_plain if ctx.plain else ffn_bwd
        dt = x.dtype
        g, dh, ln_out, dx, db1, dgamma, dbeta = bwd(
            x, w1, b1.float(), gamma.float(), beta.float(), dy.to(dt), w2, ctx.eps,
            ctx.rate, seeds,
        )
        D, F = x.shape[-1], w1.shape[0]
        dy2 = dy.reshape(-1, D)
        dw1 = torch.matmul(dh.reshape(-1, F).t(), ln_out.reshape(-1, D))
        dw2 = torch.matmul(dy2.to(dt).t(), g.reshape(-1, F))
        db2 = dy2.float().sum(0)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype), None, None, None,
                None, None)


def ffn_ln_block(x, w1, b1, gamma, beta, w2, b2, eps: float = 1e-5, rate: float = 0.0,
                 seeds=None, plain: bool = False, saved=None):
    """The whole pre-LN FFN, differentiable.

    Args:
        x: (B, T, D) residual stream.
        w1: (F, D); b1: (F,); gamma, beta: (D,); w2: (D, F); b2: (D,).
        rate: activation-dropout rate; seeds: (B,) int32 when rate > 0.
        plain: run the plain versions (forward and backward) on any device.
        saved: a checkpoint replay's stand-in for the output, which it does
            not read (no launch).

    Returns:
        (B, T, D) in ``x.dtype`` (the residual add stays outside).
    """
    if rate > 0.0 and seeds is None:
        raise ValueError("ffn_ln_block: dropout needs seeds")
    return _FFNBlock.apply(x, w1, b1, gamma, beta, w2, b2, seeds, float(rate), float(eps),
                           plain, saved)

