"""GELU + dropout in one pass each way: the unfused FFN's activation in training.

Port of ``coral_tpu/ops/gelu_dropout_pallas.py`` ``gelu_dropout`` (the
``custom_vjp`` ``_gelu_dropout`` over ``_call``: ``_fwd_kernel`` and
``_bwd_kernel``). The forward writes ``keep ? gelu(x) / (1 - rate) : 0`` and
the backward ``keep ? dy / (1 - rate) * gelu'(x) : 0``, each in fp32 and
rounded once to x's dtype, as the TPU kernels compute them; the backward
regenerates the mask from the seeds, so the residuals are x and the (B,)
seeds. GELU and gelu' are the polynomial tables of ``ops/gelu_poly.py``,
not erf. On a CUDA tensor the wrappers launch ``csrc/gelu_dropout.cu``; on a
CPU tensor they run the plain versions beside them; ``plain=True`` runs the
plain versions on any device.

The mask is ``ops/philox.py``'s: a pure function of (seeds[b], row, column),
the bits the kernel draws too, so kernel and plain drop the same elements.
The TPU kernels draw from their own per-tile PRNG stream, and the JAX
package's off-TPU fallback (``gelu_dropout_pallas.py:302-309``) from
``jax.random.bernoulli`` and rounds gelu to x's dtype before it scales;
the plain version here follows the TPU kernel's single rounding instead.
"""

from __future__ import annotations

import torch

from . import _build
from .gelu_poly import _dgelu, gelu_poly
from .philox import keep_mask, threshold

# The kernels take rows of F values, F a multiple of this (16-byte vectors).
KERNEL_F_MULTIPLE = 8


def _name(base: str, F: int) -> str:
    """The launch counter's name, by the row width: ``gelu_dropout_4096``."""
    return f"{base}_{F}"


def _scale(rate: float) -> float:
    threshold(rate)  # raises outside [0, 1)
    return 1.0 / (1.0 - rate)


def _keep(x, rate, seeds):
    return keep_mask(seeds, x.shape[1], x.shape[2], rate)


def gelu_dropout_plain(x, rate: float, seeds=None):
    """``_fwd_kernel`` in plain ops: (B, T, F) x -> ``keep ? gelu_poly(x) *
    (1 / (1 - rate)) : 0`` in fp32, cast to x.dtype; rate 0 keeps all."""
    g = gelu_poly(x.float())
    if rate > 0.0:
        g = torch.where(_keep(x, rate, seeds), g * _scale(rate), 0.0)
    return g.to(x.dtype)


def gelu_dropout_bwd_plain(x, dy, rate: float, seeds=None):
    """``_bwd_kernel`` in plain ops: ``keep ? dy * (1 / (1 - rate)) *
    gelu'(x) : 0`` in fp32, cast to x.dtype."""
    dx = dy.float() * _scale(rate) * _dgelu(x.float())
    if rate > 0.0:
        dx = torch.where(_keep(x, rate, seeds), dx, 0.0)
    return dx.to(x.dtype)


def _launch(name, kernel, x, dy, rate, seeds):
    if x.dim() != 3 or x.shape[-1] % KERNEL_F_MULTIPLE:
        raise ValueError(f"{name}: the kernel takes (B, T, F) with F a multiple of "
                         f"{KERNEL_F_MULTIPLE}, got {tuple(x.shape)}")
    B, T, F = x.shape
    _build.check_cuda(name, torch.bfloat16, *(t for t in (x, dy) if t is not None))
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"{name}: dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    thr = threshold(rate)
    if rate > 0.0:
        if seeds is None or seeds.shape != (B,):
            raise ValueError(f"{name}: dropout needs seeds ({B},)")
        if seeds.dtype != torch.int32 or seeds.device != x.device or not seeds.is_contiguous():
            raise ValueError(f"{name}: seeds must be contiguous int32 on {x.device}")
    out = torch.empty_like(x)
    _build.launch(name, _name(kernel, F), x.data_ptr(), None if dy is None else dy.data_ptr(),
                  out.data_ptr(), seeds.data_ptr() if rate > 0.0 else None, B, T, F, thr,
                  _scale(rate))
    return out


def gelu_dropout_fwd(x, rate: float, seeds=None):
    """``dropout(gelu(x), rate)``, the kernel's output.

    Args:
        x: (B, T, F); on CUDA bf16 contiguous, F a multiple of 8.
        rate: drop probability in [0, 1); rate 0 keeps every element.
        seeds: (B,) int32, the mask's seeds (rate > 0).

    Returns:
        (B, T, F) in x.dtype.
    """
    name = "coral_gelu_dropout"
    if not _build.require_cuda(name, x):
        return gelu_dropout_plain(x, rate, seeds)
    return _launch(name, "gelu_dropout", x, None, rate, seeds)


def gelu_dropout_bwd(x, dy, rate: float, seeds=None):
    """The backward kernel: dx from x, dy (B, T, F) and the forward's seeds;
    arguments as ``gelu_dropout_fwd``, dy of x's shape and dtype."""
    name = "coral_gelu_dropout"
    if not _build.require_cuda(name, x):
        return gelu_dropout_bwd_plain(x, dy, rate, seeds)
    return _launch(name, "gelu_dropout_bwd", x, dy, rate, seeds)


class _GeluDropout(torch.autograd.Function):
    """``_gelu_dropout``'s ``custom_vjp``: residuals x and the seeds."""

    @staticmethod
    def forward(ctx, x, rate, seeds, plain):
        ctx.save_for_backward(x, seeds)
        ctx.rate, ctx.plain = rate, plain
        return (gelu_dropout_plain if plain else gelu_dropout_fwd)(x, rate, seeds)

    @staticmethod
    def backward(ctx, dy):
        x, seeds = ctx.saved_tensors
        bwd = gelu_dropout_bwd_plain if ctx.plain else gelu_dropout_bwd
        return bwd(x, dy.to(x.dtype).contiguous(), ctx.rate, seeds), None, None, None


def gelu_dropout(x, rate: float, seeds=None, plain: bool = False):
    """``dropout(gelu(x), rate)``, differentiable in x.

    Args:
        x: (B, T, F), as ``gelu_dropout_fwd`` takes it.
        rate: drop probability in [0, 1); seeds: (B,) int32 when rate > 0.
        plain: run the plain versions (forward and backward) on any device.

    Returns:
        (B, T, F) in x.dtype.
    """
    if rate > 0.0 and seeds is None:
        raise ValueError("gelu_dropout: dropout needs seeds")
    return _GeluDropout.apply(x, float(rate), seeds, plain)
