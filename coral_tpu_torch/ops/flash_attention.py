"""Unmasked, non-causal self-attention for the Whisper encoder, with backward.

Port of ``coral_tpu/ops/flash_attention.py`` ``flash_self_attention``, which
runs JAX's stock TPU flash kernel over T padded to its block grid: the forward
``_flash`` (o only, serving) and ``_flash_res`` (o and the row stats l and m,
training), and the explicit backward ``_grads`` (the stock dkv kernel and the
patched dq kernel) behind the ``custom_vjp`` ``_attention_fwd`` /
``_attention_bwd``, whose residuals are ``(q, k, v, o, l, m)``. On a CUDA
tensor the wrappers launch ``csrc/flash_attention.cu`` on the projections as
they lie, (B, T, H*d) rows read through their strides, with keys past T masked
in the kernels; on a CPU tensor they run the plain versions beside them.

m is each query row's max of the scaled scores and l its sum of ``exp(s -
m)``, both fp32 (B, H, T). The backward is the stock kernel's formula:
``di = rowsum(o do)`` in fp32, ``p = exp(s scale - m) / l``, ``dv =
bf16(p)^T do``, ``ds = (do v^T - di) p scale``, ``dk = bf16(ds)^T q``, ``dq =
bf16(ds) k``, sums in fp32, results in q's dtype.
"""

from __future__ import annotations

import torch

from . import _build

KERNEL_HEAD_DIM = 64


def _heads(t):
    return t.transpose(1, 2).float()  # (B, T, H, d) -> (B, H, T, d) fp32


def flash_attention_fwd_plain(q, k, v):
    """The TPU kernel's math on (B, T, H, d): fp32 scores ``q k^T`` times
    ``d**-0.5``, unnormalised probabilities ``exp(s - m)`` rounded to the
    working dtype for the product with v, the fp32 sum divided by the row sum
    l, cast to q.dtype. Returns (o (B, T, H, d), l, m (B, H, T) fp32), the
    order of ``_flash_res``."""
    dt = q.dtype
    qh, kh, vh = (_heads(t) for t in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = (e.to(dt).float() @ vh) / l[..., None]
    return o.to(dt).transpose(1, 2), l, m


def flash_self_attention_plain(q, k, v):
    """The forward's plain version, o only."""
    return flash_attention_fwd_plain(q, k, v)[0]


def flash_attention_bwd_plain(q, k, v, o, l, m, do):
    """The stock TPU backward (dkv and dq kernels) in plain ops; see the
    module docstring. q, k, v, o, do (B, T, H, d); l, m (B, H, T) fp32.
    Returns (dq, dk, dv), (B, T, H, d) in q.dtype."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5
    qh, kh, vh, oh, doh = (_heads(t) for t in (q, k, v, o, do))
    s = (qh @ kh.transpose(-1, -2)) * scale
    p = torch.exp(s - m[..., None]) * (1.0 / l)[..., None]
    di = (oh * doh).sum(dim=-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ doh
    ds = ((doh @ vh.transpose(-1, -2) - di) * p * scale).to(dt).float()
    dk = ds.transpose(-1, -2) @ qh
    dq = ds @ kh
    return tuple(t.to(dt).transpose(1, 2) for t in (dq, dk, dv))


def _check(name, q, k, v):
    """Raises unless the kernels take q, k, v; returns (B, T, H, stride_b,
    stride_t)."""
    B, T, H, d = q.shape
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, got {d}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: the kernel takes bf16 q, k, v")
    for t in (k, v):
        if t.shape != q.shape or t.stride() != q.stride() or t.device != q.device:
            raise ValueError(f"{name}: q, k, v must share shape, strides and device")
    stride_b, stride_t, stride_h, stride_d = q.stride()
    if stride_d != 1 or stride_h != d or stride_t % 8 or stride_b % 8:
        raise ValueError(f"{name}: each row's H*d values must be contiguous and 16-byte aligned")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: the kernel needs 16-byte aligned q, k, v")
    return B, T, H, stride_b, stride_t


def _launch_fwd(name, kernel, q, k, v, stats: bool):
    B, T, H, stride_b, stride_t = _check(name, q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    l, m = ((torch.empty((B, H, T), dtype=torch.float32, device=q.device) for _ in range(2))
            if stats else (None, None))
    _build.launch(name, kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
                  B, T, H, stride_b, stride_t, float(q.shape[-1]) ** -0.5)
    return o, l, m


def flash_self_attention(q, k, v):
    """``softmax(q k^T * d**-0.5) v`` per head, no mask, not causal (serving:
    no residuals, no gradient).

    Args:
        q, k, v: (B, T, H, d); on CUDA bf16 with d = 64, the (H, d) axes of
            each row contiguous, and the same strides for all three (views of
            one packed projection are taken as they are).

    Returns:
        (B, T, H, d) in q.dtype (contiguous on CUDA).
    """
    name = "coral_flash_attention_fwd"
    if not _build.require_cuda(name, q):
        return flash_self_attention_plain(q, k, v)
    return _launch_fwd(name, "flash_attention", q, k, v, stats=False)[0]


def flash_attention_fwd(q, k, v):
    """The training forward (``_flash_res``): (o, l, m) as
    ``flash_attention_fwd_plain``; q, k, v as ``flash_self_attention``."""
    name = "coral_flash_attention_fwd"
    if not _build.require_cuda(name, q):
        return flash_attention_fwd_plain(q, k, v)
    return _launch_fwd(name, "flash_attention_train", q, k, v, stats=True)


def _launch_bwd(name, kernel, q, k, v, o, l, m, do, dq, dk, dv):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: {kernel} takes CUDA tensors; the plain version of the "
                         "backward is flash_attention_bwd_plain")
    B, T, H, stride_b, stride_t = _check(name, q, k, v)
    _build.check_cuda(name, torch.bfloat16, o, do)
    _build.check_cuda(name, torch.float32, l, m)
    if o.shape != q.shape or do.shape != q.shape or l.shape != (B, H, T) or m.shape != l.shape:
        raise ValueError(f"{name}: o and do must be {tuple(q.shape)}, l and m ({B}, {H}, {T})")
    if o.device != q.device:
        raise ValueError(f"{name}: tensors on {o.device} and {q.device}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(name, kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), m.data_ptr(), l.data_ptr(), ptr(dq), ptr(dk), ptr(dv),
                  B, T, H, stride_b, stride_t, float(q.shape[-1]) ** -0.5)


def flash_attention_bwd_dkv(q, k, v, o, l, m, do):
    """The key-major backward kernel (the stock ``_flash_attention_bwd_dkv``):
    (dk, dv), (B, T, H, d) bf16 contiguous. q, k, v as the forward took them;
    o, do (B, T, H, d) bf16 contiguous; l, m (B, H, T) fp32. CUDA only."""
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    _launch_bwd("coral_flash_attention_bwd", "flash_attention_bwd_dkv", q, k, v, o, l, m, do,
                None, dk, dv)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, o, l, m, do):
    """The query-major backward kernel (``flash_attention_bwd_dq_fixed``):
    dq, arguments as ``flash_attention_bwd_dkv``. CUDA only."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("coral_flash_attention_bwd", "flash_attention_bwd_dq", q, k, v, o, l, m, do,
                dq, None, None)
    return dq


def flash_attention_bwd(q, k, v, o, l, m, do):
    """The backward kernels, dk and dv in one launch and dq in another;
    arguments and results as ``flash_attention_bwd_plain``.

    Args:
        q, k, v: as the forward took them; o, do: (B, T, H, d) bf16
            contiguous; l, m: (B, H, T) fp32.
    """
    if not _build.require_cuda("coral_flash_attention_bwd", q):
        return flash_attention_bwd_plain(q, k, v, o, l, m, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, o, l, m, do)
    return flash_attention_bwd_dq(q, k, v, o, l, m, do), dk, dv


class _FlashAttention(torch.autograd.Function):
    """``_attention_fwd`` / ``_attention_bwd``: residuals (q, k, v, o, l, m).
    Given ``saved`` (the (o, l, m) a remat policy kept, the JAX ``flash_o``,
    ``flash_l`` and ``flash_m``), the forward returns them without a launch."""

    @staticmethod
    def forward(ctx, q, k, v, plain, saved):
        if saved is not None:
            o, l, m = (t.detach() for t in saved)
        else:
            o, l, m = (flash_attention_fwd_plain if plain else flash_attention_fwd)(q, k, v)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.plain = plain
        ctx.mark_non_differentiable(l, m)
        return o, l, m

    @staticmethod
    def backward(ctx, do, _dl, _dm):
        q, k, v, o, l, m = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, l, m, do.contiguous())
        return dq, dk, dv, None, None


def flash_attention(q, k, v, plain: bool = False, saved=None):
    """``flash_self_attention``, differentiable in q, k and v.

    Args:
        q, k, v: (B, T, H, d), as ``flash_self_attention`` takes them.
        plain: run the plain versions (forward and backward) on any device.
        saved: the (o, l, m) a checkpoint replay already holds (no launch).

    Returns:
        (o (B, T, H, d) in q.dtype, l, m (B, H, T) fp32).
    """
    return _FlashAttention.apply(q, k, v, plain, saved)
