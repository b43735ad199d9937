"""Unmasked, non-causal self-attention for the Whisper encoder (forward).

Port of ``coral_tpu/ops/flash_attention.py`` ``flash_self_attention``, which
runs JAX's stock TPU flash kernel over T padded to its block grid. On a CUDA
tensor the wrapper launches ``csrc/flash_attention.cu`` on the projections as
they lie, (B, T, H*d) rows read through their strides, with keys past T
masked in the kernel; on a CPU tensor it runs the plain version beside it.
Inference only: the training slice adds the backward (the TPU module's
``_flash_res`` and ``_grads``).
"""

from __future__ import annotations

import torch

from . import _build

_KERNEL_HEAD_DIM = 64


def flash_self_attention_plain(q, k, v):
    """The TPU kernel's math on (B, T, H, d): fp32 scores ``q k^T`` times
    ``d**-0.5``, unnormalised probabilities ``exp(s - max)`` rounded to the
    working dtype for the product with v, the fp32 sum divided by the row sum,
    cast to q.dtype."""
    dt = q.dtype
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))  # (B, H, T, d)
    s = (qh @ kh.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = (e.to(dt).float() @ vh) / e.sum(dim=-1, keepdim=True)
    return o.to(dt).transpose(1, 2)


def flash_self_attention(q, k, v):
    """``softmax(q k^T * d**-0.5) v`` per head, no mask, not causal.

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
    B, T, H, d = q.shape
    if d != _KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {_KERNEL_HEAD_DIM}, got {d}")
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
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    _build.launch(name, "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  o.data_ptr(), B, T, H, stride_b, stride_t, float(d) ** -0.5)
    return o
