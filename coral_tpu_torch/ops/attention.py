"""Short-T bidirectional attention with in-kernel q/k/v biases, with backward.

Port of ``coral_tpu/ops/attention_pallas.py`` ``short_t_attention_flat`` with
``save_stats="v3"`` and ``qkv_bias``, the wav2vec2 default: the forward
``_fwd_kernel_stats_v2_qb``, which writes o and the per-head log-sum-exp, and
the backward ``_bwd_kernel_stats_ctx_qb`` behind the ``custom_vjp``
``_attention_stats_v3_qb`` (:1306-1341), whose residuals are
``(q, k, v, bq, bk, bv, key_bias, lse, o)``. On a CUDA tensor the wrappers
launch ``csrc/attention.cu``; on a CPU tensor they run the plain versions
beside them; ``plain=True`` runs the plain versions on any device.

Padded keys get a finite -1e30 additive bias, never -inf: a row whose keys are
all padded (the ``lengths=1`` filler rows of a partial serving batch) then
averages uniformly instead of turning into NaN, and its lse is clamped at
-1e25, as in the JAX package. The backward rebuilds ``p = exp(s + key_bias -
lse)`` from that clamped lse, so such a row gets p = 0 and no gradient, where
autograd through the forward would spread one uniformly: the plain backward
computes the kernel's formula, not the derivative of ``attention_plain``.
"""

from __future__ import annotations

import torch

from . import _build
from .ln_gelu import WIDTHS_ROADMAP

# Head dims the kernels take, each its own instantiation: XLS-R-300M's 64
# (counted as "attention", "attention_bwd"), XLS-R-1B's 80 and XLS-R-2B's 120
# ("attention_fwd_hd80", "attention_bwd_hd120", ...).
KERNEL_HEAD_DIMS = (64, 80, 120)
_TILE = 64


def _name(direction: str, head_dim: int) -> str:
    if head_dim == 64:
        return "attention" if direction == "fwd" else "attention_bwd"
    return f"attention_{direction}_hd{head_dim}"


def _key_bias(pad_mask):
    """The additive key bias: 0 for a valid key, the finite -1e30 for padding."""
    return torch.where(pad_mask, 0.0, -1e30).to(torch.float32).contiguous()


def _heads(x, head_dim):
    B, T, HD = x.shape
    return x.reshape(B, T, HD // head_dim, head_dim).transpose(1, 2).float()


def _flat(x):
    B, H, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, H * d)


def attention_plain(q, k, v, pad_mask, head_dim: int, qkv_bias,
                    sm_scale: float | None = None):
    """``short_t_attention_flat`` in plain ops, the JAX kernel's math: biases
    added and q scaled in the working dtype, fp32 scores and softmax,
    unnormalised probabilities rounded to the working dtype for the product,
    then divided by their sum."""
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    bq, bk, bv = (b.to(q.dtype) for b in qkv_bias)
    return _fwd_plain(q, k, v, bq, bk, bv, _key_bias(pad_mask), head_dim, sm_scale)


def _fwd_plain(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale):
    dt = q.dtype
    qh = _heads((q + bq) * torch.tensor(sm_scale, dtype=dt, device=q.device), head_dim)
    kh = _heads(k + bk, head_dim)
    vh = _heads(v + bv, head_dim)
    s = qh @ kh.transpose(-1, -2) + key_bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = _flat(((e.to(dt).float() @ vh) / l).to(dt))
    lse = torch.clamp(m + torch.log(l), min=-1e25).squeeze(-1)
    return o, lse


def attention_bwd_plain(q, k, v, bq, bk, bv, key_bias, do, lse, o, head_dim: int,
                        sm_scale: float):
    """``_bwd_kernel_stats_ctx_qb`` in plain ops: p rebuilt as
    ``exp(s + key_bias - lse)``, ``delta = rowsum(do * o)``, ``ds = p (dp -
    delta)`` rounded to the working dtype, ``dq = ds (k + bk) sm_scale``,
    ``dk = ds^T q_scaled``, ``dv = bf16(p)^T do``.

    Returns (dq, dk, dv) in q.dtype and db (3, H*head_dim) fp32: the column
    sums of the rounded dq, dk, dv (the bias gradients before their cast)."""
    dt = q.dtype
    qh = _heads((q + bq) * torch.tensor(sm_scale, dtype=dt, device=q.device), head_dim)
    kh = _heads(k + bk, head_dim)
    vh = _heads(v + bv, head_dim)
    doh = _heads(do, head_dim)
    s = qh @ kh.transpose(-1, -2)
    p = torch.exp(s + key_bias[:, None, None, :] - lse[..., None])
    delta = (doh * _heads(o, head_dim)).sum(dim=-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    ds = (p * (dp - delta)).to(dt).float()
    dq = (ds @ kh) * sm_scale
    dk = ds.transpose(-1, -2) @ qh
    dq, dk, dv = (_flat(t).to(dt) for t in (dq, dk, dv))
    db = torch.stack([t.float().sum(dim=(0, 1)) for t in (dq, dk, dv)])
    return dq, dk, dv, db


def _check(name, q, k, v, bq, bk, bv, key_bias, head_dim):
    B, T, HD = q.shape
    if head_dim not in KERNEL_HEAD_DIMS or HD % head_dim:
        raise ValueError(
            f"{name}: the kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {head_dim}"
            f" with width {HD}; " + WIDTHS_ROADMAP
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
    _build.check_cuda(name, torch.float32, key_bias)
    if key_bias.shape != (B, T) or key_bias.device != q.device:
        raise ValueError(f"{name}: pad_mask must be ({B}, {T}) on {q.device}")
    return B, T, HD // head_dim, stride_b, stride_t


def _fwd(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale):
    name = "coral_attention_fwd"
    if not _build.require_cuda(name, q):
        return _fwd_plain(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale)
    B, T, H, stride_b, stride_t = _check(name, q, k, v, bq, bk, bv, key_bias, head_dim)
    o = torch.empty((B, T, H * head_dim), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    scale = float(torch.tensor(sm_scale, dtype=q.dtype))
    _build.launch(
        name, _name("fwd", head_dim), q.data_ptr(), k.data_ptr(), v.data_ptr(), bq.data_ptr(),
        bk.data_ptr(), bv.data_ptr(), key_bias.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, T, H, head_dim, stride_b, stride_t, scale,
    )
    return o, lse


def attention_bwd(q, k, v, bq, bk, bv, key_bias, do, lse, o, head_dim: int,
                  sm_scale: float):
    """The backward kernels; arguments and results as ``attention_bwd_plain``.

    Args:
        q, k, v: (B, T, H*d) bf16 as the forward took them, d in
            ``KERNEL_HEAD_DIMS``; bq, bk, bv (H*d,) bf16; key_bias (B, T)
            fp32; do, o (B, T, H*d) bf16; lse (B, H, T) fp32.
    """
    name = "coral_attention_bwd"
    if not _build.require_cuda(name, q):
        return attention_bwd_plain(q, k, v, bq, bk, bv, key_bias, do, lse, o, head_dim,
                                   sm_scale)
    B, T, H, stride_b, stride_t = _check(name, q, k, v, bq, bk, bv, key_bias, head_dim)
    HD = H * head_dim
    _build.check_cuda(name, torch.bfloat16, do, o)
    _build.check_cuda(name, torch.float32, lse)
    if do.shape != (B, T, HD) or o.shape != (B, T, HD) or lse.shape != (B, H, T):
        raise ValueError(f"{name}: do and o must be ({B}, {T}, {HD}), lse ({B}, {H}, {T})")
    dq, dk, dv = (torch.empty((B, T, HD), dtype=q.dtype, device=q.device) for _ in range(3))
    n_tiles = -(-T // _TILE)
    db_part = torch.empty((B, n_tiles, 3, HD), dtype=torch.float32, device=q.device)
    scale = float(torch.tensor(sm_scale, dtype=q.dtype))
    _build.launch(
        name, _name("bwd", head_dim), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bq.data_ptr(), bk.data_ptr(), bv.data_ptr(), key_bias.data_ptr(), do.data_ptr(),
        lse.data_ptr(), o.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        db_part.data_ptr(), B, T, H, head_dim, stride_b, stride_t, scale, float(sm_scale),
    )
    return dq, dk, dv, db_part.sum(dim=(0, 1))


class _Attention(torch.autograd.Function):
    """``_attention_stats_v3_qb``: residuals (q, k, v, bq, bk, bv, key_bias,
    lse, o), the backward kernels, and bias gradients as the column sums cast
    to the working dtype (``dbsum.astype(bq.dtype)``), then to each bias's.
    Given ``saved`` (the (o, lse) a remat policy kept), the forward returns
    them without a launch."""

    @staticmethod
    def forward(ctx, q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, plain, saved):
        qb, kb, vb = (b.to(q.dtype) for b in (bq, bk, bv))
        if saved is not None:
            o, lse = (t.detach() for t in saved)
        else:
            fwd = _fwd_plain if plain else _fwd
            o, lse = fwd(q, k, v, qb, kb, vb, key_bias, head_dim, sm_scale)
        ctx.save_for_backward(q, k, v, qb, kb, vb, key_bias, lse, o)
        ctx.head_dim, ctx.sm_scale, ctx.plain = head_dim, sm_scale, plain
        ctx.bias_dtypes = (bq.dtype, bk.dtype, bv.dtype)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, qb, kb, vb, key_bias, lse, o = ctx.saved_tensors
        bwd = attention_bwd_plain if ctx.plain else attention_bwd
        dq, dk, dv, db = bwd(q, k, v, qb, kb, vb, key_bias, do.contiguous(), lse, o,
                             ctx.head_dim, ctx.sm_scale)
        dbs = [db[i].to(q.dtype).to(dtype) for i, dtype in enumerate(ctx.bias_dtypes)]
        return dq, dk, dv, *dbs, None, None, None, None, None


def short_t_attention_flat(q, k, v, pad_mask, head_dim: int, qkv_bias,
                           sm_scale: float | None = None, plain: bool = False, saved=None):
    """``softmax((q + bq) (k + bk)^T * scale + key_bias) (v + bv)`` per head,
    differentiable in q, k, v and the biases.

    Args:
        q, k, v: (B, T, H*head_dim) projections without their biases; on CUDA
            bf16 with head_dim in ``KERNEL_HEAD_DIMS``, the last axis contiguous
            and the row strides equal for all three (slices of one packed
            tensor are taken as they are).
        pad_mask: (B, T) bool, True for a valid key.
        qkv_bias: (bq, bk, bv), each (H*head_dim,); cast to q.dtype.
        sm_scale: score scale, default head_dim ** -0.5 (rounded to q.dtype
            before use, as the JAX kernel does).
        plain: run the plain versions (forward and backward) on any device.
        saved: the (o, lse) a checkpoint replay already holds (no launch).

    Returns:
        (o, lse): o (B, T, H*head_dim) in q.dtype, lse (B, H, T) fp32.
    """
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    return _Attention.apply(q, k, v, *qkv_bias, _key_bias(pad_mask), head_dim, sm_scale,
                            plain, saved)
