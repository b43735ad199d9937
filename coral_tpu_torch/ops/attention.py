"""Short-T bidirectional attention, with or without in-kernel q/k/v biases, with backward.

Port of ``coral_tpu/ops/attention_pallas.py`` ``short_t_attention_flat`` with
``save_stats="v3"``. With ``qkv_bias``, the wav2vec2 default: the forward
``_fwd_kernel_stats_v2_qb``, which writes o and the per-head log-sum-exp, and
the backward ``_bwd_kernel_stats_ctx_qb`` behind the ``custom_vjp``
``_attention_stats_v3_qb`` (:1306-1341), whose residuals are
``(q, k, v, bq, bk, bv, key_bias, lse, o)``. Without (``qkv_bias=None``, the
route of ``attention_fused_qkv_bias: false`` and of ``fused_qkv_ln``): the
forward ``_fwd_kernel_stats_v2`` and the backward ``_bwd_kernel_stats_ctx``
behind ``_attention_stats_v3`` (:1271-1302), residuals ``(q, k, v, key_bias,
lse, o)``, no bias gradients. ``short_t_attention_packed`` takes q, k, v as
the lane thirds of one packed (B, T, 3 H*d) projection (``fused_qkv_ln``) and
returns their gradient as one packed tensor, which the backward kernels write
through its row stride. On a CUDA tensor the wrappers launch
``csrc/attention.cu`` (one template with and without the bias loads); on a CPU
tensor they run the plain versions beside them; ``plain=True`` runs the plain
versions on any device.

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
# ("attention_fwd_hd80", "attention_bwd_hd120", ...); without the biases the
# same names with "attention_nb" ("attention_nb_bwd", "attention_nb_fwd_hd80").
KERNEL_HEAD_DIMS = (64, 80, 120)
_TILE = 64


def _name(direction: str, head_dim: int, bias: bool = True) -> str:
    base = "attention" if bias else "attention_nb"
    if head_dim == 64:
        return base if direction == "fwd" else f"{base}_bwd"
    return f"{base}_{direction}_hd{head_dim}"


def _key_bias(pad_mask):
    """The additive key bias: 0 for a valid key, the finite -1e30 for padding."""
    return torch.where(pad_mask, 0.0, -1e30).to(torch.float32).contiguous()


def _heads(x, head_dim):
    B, T, HD = x.shape
    return x.reshape(B, T, HD // head_dim, head_dim).transpose(1, 2).float()


def _flat(x):
    B, H, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, H * d)


def attention_plain(q, k, v, pad_mask, head_dim: int, qkv_bias=None,
                    sm_scale: float | None = None):
    """``short_t_attention_flat`` in plain ops, the JAX kernel's math: biases
    (if any) added and q scaled in the working dtype, fp32 scores and
    softmax, unnormalised probabilities rounded to the working dtype for the
    product, then divided by their sum."""
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    bq, bk, bv = (None,) * 3 if qkv_bias is None else (b.to(q.dtype) for b in qkv_bias)
    return _fwd_plain(q, k, v, bq, bk, bv, _key_bias(pad_mask), head_dim, sm_scale)


def _biased(q, k, v, bq, bk, bv, head_dim, sm_scale):
    """The per-head (B, H, T, d) fp32 operands: the biases added (none with
    bq None) and q scaled, each rounded to the working dtype."""
    dt = q.dtype
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    scale = torch.tensor(sm_scale, dtype=dt, device=q.device)
    return _heads(q * scale, head_dim), _heads(k, head_dim), _heads(v, head_dim)


def _fwd_plain(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale):
    dt = q.dtype
    qh, kh, vh = _biased(q, k, v, bq, bk, bv, head_dim, sm_scale)
    s = qh @ kh.transpose(-1, -2) + key_bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = _flat(((e.to(dt).float() @ vh) / l).to(dt))
    lse = torch.clamp(m + torch.log(l), min=-1e25).squeeze(-1)
    return o, lse


def attention_bwd_plain(q, k, v, bq, bk, bv, key_bias, do, lse, o, head_dim: int,
                        sm_scale: float):
    """``_bwd_kernel_stats_ctx_qb`` (``_bwd_kernel_stats_ctx`` with bq, bk, bv
    None) in plain ops: p rebuilt as ``exp(s + key_bias - lse)``, ``delta =
    rowsum(do * o)``, ``ds = p (dp - delta)`` rounded to the working dtype,
    ``dq = ds (k + bk) sm_scale``, ``dk = ds^T q_scaled``, ``dv = bf16(p)^T do``.

    Returns (dq, dk, dv) in q.dtype and db (3, H*head_dim) fp32: the column
    sums of the rounded dq, dk, dv (the bias gradients before their cast), or
    None without biases."""
    dt = q.dtype
    qh, kh, vh = _biased(q, k, v, bq, bk, bv, head_dim, sm_scale)
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
    if bq is None:
        return dq, dk, dv, None
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
    if (bq is None) != (bk is None) or (bq is None) != (bv is None):
        raise ValueError(f"{name}: give all three biases or none")
    if bq is not None:
        _build.check_cuda(name, torch.bfloat16, bq, bk, bv)
        if any(b.shape != (HD,) for b in (bq, bk, bv)):
            raise ValueError(f"{name}: the biases must be ({HD},)")
    _build.check_cuda(name, torch.float32, key_bias)
    if key_bias.shape != (B, T) or key_bias.device != q.device:
        raise ValueError(f"{name}: pad_mask must be ({B}, {T}) on {q.device}")
    return B, T, HD // head_dim, stride_b, stride_t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale):
    name = "coral_attention_fwd"
    if not _build.require_cuda(name, q):
        return _fwd_plain(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale)
    B, T, H, stride_b, stride_t = _check(name, q, k, v, bq, bk, bv, key_bias, head_dim)
    o = torch.empty((B, T, H * head_dim), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    scale = float(torch.tensor(sm_scale, dtype=q.dtype))
    _build.launch(
        name, _name("fwd", head_dim, bq is not None), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(bq), _ptr(bk), _ptr(bv), key_bias.data_ptr(), o.data_ptr(), lse.data_ptr(), B, T,
        H, head_dim, stride_b, stride_t, scale,
    )
    return o, lse


def attention_bwd(q, k, v, bq, bk, bv, key_bias, do, lse, o, head_dim: int,
                  sm_scale: float, out=None):
    """The backward kernels; arguments and results as ``attention_bwd_plain``.

    Args:
        q, k, v: (B, T, H*d) bf16 as the forward took them, d in
            ``KERNEL_HEAD_DIMS``; bq, bk, bv (H*d,) bf16, or all None (the
            kernels without biases); key_bias (B, T) fp32; do, o (B, T, H*d)
            bf16; lse (B, H, T) fp32.
        out: a contiguous (B, T, 3 H*d) tensor of q.dtype: dq, dk and dv are
            written into its lane thirds (then returned as its views); None
            allocates them apart.
    """
    name = "coral_attention_bwd"
    if not _build.require_cuda(name, q):
        grads = attention_bwd_plain(q, k, v, bq, bk, bv, key_bias, do, lse, o, head_dim,
                                    sm_scale)
        if out is None:
            return grads
        for part, g in zip(out.chunk(3, dim=-1), grads[:3]):
            part.copy_(g)
        return (*out.chunk(3, dim=-1), grads[3])
    B, T, H, stride_b, stride_t = _check(name, q, k, v, bq, bk, bv, key_bias, head_dim)
    HD = H * head_dim
    _build.check_cuda(name, torch.bfloat16, do, o)
    _build.check_cuda(name, torch.float32, lse)
    if do.shape != (B, T, HD) or o.shape != (B, T, HD) or lse.shape != (B, H, T):
        raise ValueError(f"{name}: do and o must be ({B}, {T}, {HD}), lse ({B}, {H}, {T})")
    if out is None:
        dq, dk, dv = (torch.empty((B, T, HD), dtype=q.dtype, device=q.device) for _ in range(3))
    else:
        _build.check_cuda(name, q.dtype, out)
        if out.shape != (B, T, 3 * HD) or out.device != q.device:
            raise ValueError(f"{name}: out must be ({B}, {T}, {3 * HD}) on {q.device}")
        dq, dk, dv = out.chunk(3, dim=-1)
    db_part = None
    if bq is not None:
        n_tiles = -(-T // _TILE)
        db_part = torch.empty((B, n_tiles, 3, HD), dtype=torch.float32, device=q.device)
    scale = float(torch.tensor(sm_scale, dtype=q.dtype))
    _build.launch(
        name, _name("bwd", head_dim, bq is not None), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(bq), _ptr(bk), _ptr(bv), key_bias.data_ptr(), do.data_ptr(), lse.data_ptr(),
        o.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(db_part), B, T, H,
        head_dim, stride_b, stride_t, dq.stride(1), scale, float(sm_scale),
    )
    return dq, dk, dv, None if db_part is None else db_part.sum(dim=(0, 1))


class _Attention(torch.autograd.Function):
    """``_attention_stats_v3_qb``: residuals (q, k, v, bq, bk, bv, key_bias,
    lse, o), the backward kernels, and bias gradients as the column sums cast
    to the working dtype (``dbsum.astype(bq.dtype)``), then to each bias's;
    with the biases None, ``_attention_stats_v3`` (no bias gradients). Given
    ``saved`` (the (o, lse) a remat policy kept), the forward returns them
    without a launch."""

    @staticmethod
    def forward(ctx, q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, plain, saved):
        biases = (bq, bk, bv)
        qb, kb, vb = (None,) * 3 if bq is None else (b.to(q.dtype) for b in biases)
        o, lse = _forward(q, k, v, qb, kb, vb, key_bias, head_dim, sm_scale, plain, saved)
        ctx.save_for_backward(q, k, v, qb, kb, vb, key_bias, lse, o)
        ctx.head_dim, ctx.sm_scale, ctx.plain = head_dim, sm_scale, plain
        ctx.bias_dtypes = None if bq is None else tuple(b.dtype for b in biases)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, qb, kb, vb, key_bias, lse, o = ctx.saved_tensors
        bwd = attention_bwd_plain if ctx.plain else attention_bwd
        dq, dk, dv, db = bwd(q, k, v, qb, kb, vb, key_bias, do.contiguous(), lse, o,
                             ctx.head_dim, ctx.sm_scale)
        dbs = ([None] * 3 if db is None else
               [db[i].to(q.dtype).to(dtype) for i, dtype in enumerate(ctx.bias_dtypes)])
        return dq, dk, dv, *dbs, None, None, None, None, None


def _forward(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, plain, saved):
    """(o, lse): the kept pair of a checkpoint replay (no launch), else the
    forward kernel or its plain version."""
    if saved is not None:
        return tuple(t.detach() for t in saved)
    fwd = _fwd_plain if plain else _fwd
    return fwd(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale)


class _PackedAttention(torch.autograd.Function):
    """``_attention_stats_v3`` on the lane thirds q, k, v of one packed
    projection: residuals (qkv, key_bias, lse, o); the backward kernels write
    dq, dk and dv into one packed gradient (the plain version concatenates
    them). ``saved`` as ``_Attention``."""

    @staticmethod
    def forward(ctx, qkv, key_bias, head_dim, sm_scale, plain, saved):
        q, k, v = qkv.chunk(3, dim=-1)
        o, lse = _forward(q, k, v, None, None, None, key_bias, head_dim, sm_scale, plain, saved)
        ctx.save_for_backward(qkv, key_bias, lse, o)
        ctx.head_dim, ctx.sm_scale, ctx.plain = head_dim, sm_scale, plain
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qkv, key_bias, lse, o = ctx.saved_tensors
        q, k, v = qkv.chunk(3, dim=-1)
        args = (q, k, v, None, None, None, key_bias, do.contiguous(), lse, o, ctx.head_dim,
                ctx.sm_scale)
        if ctx.plain:
            return torch.cat(attention_bwd_plain(*args)[:3], dim=-1), None, None, None, None, None
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        attention_bwd(*args, out=dqkv)
        return dqkv, None, None, None, None, None


def short_t_attention_flat(q, k, v, pad_mask, head_dim: int, qkv_bias=None,
                           sm_scale: float | None = None, plain: bool = False, saved=None):
    """``softmax((q + bq) (k + bk)^T * scale + key_bias) (v + bv)`` per head,
    differentiable in q, k, v and the biases (without ``qkv_bias``, the same
    with no bias added).

    Args:
        q, k, v: (B, T, H*head_dim) projections without their biases; on CUDA
            bf16 with head_dim in ``KERNEL_HEAD_DIMS``, the last axis contiguous
            and the row strides equal for all three (slices of one packed
            tensor are taken as they are).
        pad_mask: (B, T) bool, True for a valid key.
        qkv_bias: (bq, bk, bv), each (H*head_dim,), cast to q.dtype; None for
            the kernels without biases.
        sm_scale: score scale, default head_dim ** -0.5 (rounded to q.dtype
            before use, as the JAX kernel does).
        plain: run the plain versions (forward and backward) on any device.
        saved: the (o, lse) a checkpoint replay already holds (no launch).

    Returns:
        (o, lse): o (B, T, H*head_dim) in q.dtype, lse (B, H, T) fp32.
    """
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    return _Attention.apply(q, k, v, *(qkv_bias or (None,) * 3), _key_bias(pad_mask), head_dim,
                            sm_scale, plain, saved)


def short_t_attention_packed(qkv, pad_mask, head_dim: int, sm_scale: float | None = None,
                             plain: bool = False, saved=None):
    """``short_t_attention_flat`` without biases on q, k, v = the lane thirds
    of ``qkv`` (B, T, 3 H*head_dim), the packed projection of
    ``fused_qkv_ln``; its gradient comes back as one (B, T, 3 H*head_dim)
    tensor. Other arguments and the result as ``short_t_attention_flat``."""
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    return _PackedAttention.apply(qkv, _key_bias(pad_mask), head_dim, sm_scale, plain, saved)
