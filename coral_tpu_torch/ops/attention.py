"""Short-T bidirectional attention, forward, with in-kernel q/k/v biases.

Port of ``coral_tpu/ops/attention_pallas.py`` ``short_t_attention_flat`` with
``save_stats="v3"`` and ``qkv_bias``, the wav2vec2 serving default: the
forward ``_fwd_kernel_stats_v2_qb``, which writes o and the per-head
log-sum-exp. On a CUDA tensor the wrapper launches ``csrc/attention.cu``; on a
CPU tensor it runs the plain version beside it.

Padded keys get a finite -1e30 additive bias, never -inf: a row whose keys are
all padded (the ``lengths=1`` filler rows of a partial serving batch) then
averages uniformly instead of turning into NaN, and its lse is clamped at
-1e25, as in the JAX package.
"""

from __future__ import annotations

import torch

from . import _build

_KERNEL_HEAD_DIM = 64


def _prepare(q, pad_mask, head_dim, qkv_bias, sm_scale):
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    key_bias = torch.where(pad_mask, 0.0, -1e30).to(torch.float32)
    return key_bias, [b.to(q.dtype) for b in qkv_bias], sm_scale


def attention_plain(q, k, v, pad_mask, head_dim: int, qkv_bias,
                    sm_scale: float | None = None):
    """``short_t_attention_flat`` in plain ops, the JAX kernel's math: biases
    added and q scaled in the working dtype, fp32 scores and softmax,
    unnormalised probabilities rounded to the working dtype for the product,
    then divided by their sum."""
    key_bias, (bq, bk, bv), sm_scale = _prepare(q, pad_mask, head_dim, qkv_bias, sm_scale)
    B, T, HD = q.shape
    H = HD // head_dim
    dt = q.dtype

    def heads(x):
        return x.reshape(B, T, H, head_dim).transpose(1, 2).float()

    qh = heads((q + bq) * torch.tensor(sm_scale, dtype=dt, device=q.device))
    kh = heads(k + bk)
    vh = heads(v + bv)
    s = qh @ kh.transpose(-1, -2) + key_bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = (e.to(dt).float() @ vh) / l
    o = o.to(dt).transpose(1, 2).reshape(B, T, HD)
    lse = torch.clamp(m + torch.log(l), min=-1e25).squeeze(-1)
    return o, lse


def short_t_attention_flat(q, k, v, pad_mask, head_dim: int, qkv_bias,
                           sm_scale: float | None = None):
    """``softmax((q + bq) (k + bk)^T * scale + key_bias) (v + bv)`` per head.

    Args:
        q, k, v: (B, T, H*head_dim) projections without their biases; on CUDA
            bf16 with head_dim 64, the last axis contiguous and the row strides
            equal for all three (slices of one packed tensor are taken as they
            are).
        pad_mask: (B, T) bool, True for a valid key.
        qkv_bias: (bq, bk, bv), each (H*head_dim,); cast to q.dtype.
        sm_scale: score scale, default head_dim ** -0.5 (rounded to q.dtype
            before use, as the JAX kernel does).

    Returns:
        (o, lse): o (B, T, H*head_dim) in q.dtype, lse (B, H, T) fp32.
    """
    name = "coral_attention_fwd"
    if not _build.require_cuda(name, q):
        return attention_plain(q, k, v, pad_mask, head_dim, qkv_bias, sm_scale)
    key_bias, (bq, bk, bv), sm_scale = _prepare(q, pad_mask, head_dim, qkv_bias, sm_scale)
    B, T, HD = q.shape
    if head_dim != _KERNEL_HEAD_DIM or HD % head_dim:
        raise ValueError(
            f"{name}: the kernel takes head_dim {_KERNEL_HEAD_DIM}, got {head_dim}"
            f" with width {HD}"
        )
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: the kernel takes bf16 q, k, v")
    for t in (k, v):
        if t.shape != q.shape or t.stride() != q.stride() or t.device != q.device:
            raise ValueError(f"{name}: q, k, v must share shape, strides and device")
    stride_b, stride_t, stride_c = q.stride()
    if stride_c != 1 or stride_t % 8 or stride_b % 8:
        raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: the kernel needs 16-byte aligned q, k, v")
    _build.check_cuda(name, torch.bfloat16, bq, bk, bv)
    if any(b.shape != (HD,) for b in (bq, bk, bv)):
        raise ValueError(f"{name}: the biases must be ({HD},)")
    key_bias = key_bias.contiguous()
    if key_bias.shape != (B, T) or key_bias.device != q.device:
        raise ValueError(f"{name}: pad_mask must be ({B}, {T}) on {q.device}")
    H = HD // head_dim
    o = torch.empty((B, T, HD), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    scale = float(torch.tensor(sm_scale, dtype=q.dtype))
    _build.launch(
        name, "attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), bq.data_ptr(),
        bk.data_ptr(), bv.data_ptr(), key_bias.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, T, H, stride_b, stride_t, scale,
    )
    return o, lse
