"""Short-T bidirectional attention, every route of the JAX kernel, with backward.

Port of ``coral_tpu/ops/attention_pallas.py`` ``short_t_attention_flat``. It
picks one of five ``custom_vjp``s by ``save_stats`` and then ``o_residual``
(:1417-1439), each a ``torch.autograd.Function`` here with the same residuals
(``route``):

- ``"stats_v3"`` (``save_stats="v3"``, the setups' default): the forward
  ``_fwd_kernel_stats_v2[_qb]`` writes o and the per-head log-sum-exp; the
  backward ``_bwd_kernel_stats_ctx[_qb]`` rebuilds ``p = exp(s + key_bias -
  lse)`` and takes ``delta = rowsum(do * o)``. Residuals ``(q, k, v, [bq, bk,
  bv,] key_bias, lse, o)``. With ``qkv_bias`` (the wav2vec2 default) the
  q/k/v biases are added in the kernels and the backward returns their
  gradients (``_attention_stats_v3_qb``, :1306-1341); without, the route of
  ``attention_fused_qkv_bias: false`` and of ``fused_qkv_ln`` (:1271-1302).
- ``"stats_v2"`` (``"v2"``, :1242-1268): the same forward; the backward
  ``_bwd_kernel_stats`` (:174) from the lse alone, ``delta = sum_j p dp``.
  Residuals ``(q, k, v, key_bias, lse)``.
- ``"stats"`` (any other true ``save_stats``, :1219-1238): the v1 forward
  ``_fwd_kernel_stats`` (:74), which normalises p in fp32 before rounding it
  to bf16; the backward :174. Residuals ``(q, k, v, key_bias, lse)``.
- ``"ctx"`` (false with ``o_residual``, :1184-1216): the forward
  ``_fwd_kernel`` (:48), o alone; the backward ``_bwd_kernel_ctx`` (:407)
  recomputes ``p = e / l`` from q and k with its own row max and sum, and
  takes ``delta = rowsum(do * o)``. Residuals ``(q, k, v, key_bias, o)``.
- ``"attention"`` (false, :1164-1181): the forward :48; the backward
  ``_bwd_kernel`` (:466), p recomputed as in :407, ``delta = sum_j p dp``.
  Residuals ``(q, k, v, key_bias)``.

Only ``"stats_v3"`` takes ``qkv_bias``, as in the JAX package.
``short_t_attention_packed`` takes q, k, v as the lane thirds of one packed
(B, T, 3 H*d) projection (``fused_qkv_ln``) on any route without biases and
returns their gradient as one packed tensor, which the backward kernels write
through its row stride. On a CUDA tensor the wrappers launch
``csrc/attention.cu`` (the forwards and the v3 backward) and
``csrc/attention_rows.cu`` (the other routes' backwards, whose dq kernel
sweeps the keys twice to form the row stats); every backward is a dq kernel,
then a dkv kernel, on the backward mainloop of ``csrc/attention.cuh``. On a
CPU tensor they run the plain versions beside them; ``plain=True`` runs the
plain versions on any device.

Padded keys get a finite -1e30 additive bias, never -inf: a row whose keys are
all padded (the ``lengths=1`` filler rows of a partial serving batch) then
averages uniformly instead of turning into NaN. The routes with stats clamp
its lse at -1e25, so their backward rebuilds p = 0 there and gives it no
gradient; the routes without recompute p = 1/T from the row's own max and
sum, with no clamp, and give it the nonzero gradients of a uniform average, as
the JAX kernels do. Either way the plain backward computes the kernel's
formula, not the derivative of ``attention_plain``.
"""

from __future__ import annotations

import torch

from . import _build
from .ln_gelu import WIDTHS_ROADMAP

# Head dims the kernels take, each its own instantiation: XLS-R-300M's 64,
# XLS-R-1B's 80 and XLS-R-2B's 120.
KERNEL_HEAD_DIMS = (64, 80, 120)
# Rows of a backward kernel's block: the bias gradients come as one column-sum
# partial per block.
_TILE = 128

ROUTES = ("stats_v3", "stats_v2", "stats", "ctx", "attention")
# The routes whose forward writes the lse, and those whose backward reads o.
LSE_ROUTES = ("stats_v3", "stats_v2", "stats")
O_ROUTES = ("stats_v3", "ctx")
# Launch-count names by route (head_dim 64; "_fwd_hd80", "_bwd_hd120", ...
# at the others): the v3 kernels with biases are "attention" and
# "attention_bwd"; without, "attention_nb"; the stats-free forward (:565)
# "attention_ns", the v1 forward (:631) "attention_v1"; the backwards :581
# "attention_ns_bwd", :597 "attention_ctx_bwd", :676 "attention_stats_bwd".
_FWD_BASE = {"stats_v3": "attention_nb", "stats_v2": "attention_nb", "stats": "attention_v1",
             "ctx": "attention_ns", "attention": "attention_ns"}
_BWD_BASE = {"stats_v3": "attention_nb", "stats_v2": "attention_stats",
             "stats": "attention_stats", "ctx": "attention_ctx", "attention": "attention_ns"}
# coral_attention_bwd_rows's mode of each route it runs.
_ROWS_MODE = {"stats_v2": 0, "stats": 0, "attention": 1, "ctx": 2}


def route(save_stats, o_residual: bool) -> str:
    """The route ``short_t_attention_flat`` picks (attention_pallas.py:1425-1438):
    ``save_stats`` takes precedence over ``o_residual``."""
    if save_stats == "v3":
        return "stats_v3"
    if save_stats == "v2":
        return "stats_v2"
    if save_stats:
        return "stats"
    return "ctx" if o_residual else "attention"


def _name(direction: str, head_dim: int, bias: bool = True, route: str = "stats_v3") -> str:
    """The launch-count name of ``route``'s ``direction`` ("fwd" or "bwd")
    kernel at ``head_dim``, with the q/k/v biases (v3 only) or without."""
    base = "attention" if bias else (_FWD_BASE if direction == "fwd" else _BWD_BASE)[route]
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
                    sm_scale: float | None = None, route: str = "stats_v3"):
    """``short_t_attention_flat``'s forward on ``route`` in plain ops, the JAX
    kernels' math: biases (if any) added and q scaled in the working dtype,
    fp32 scores and softmax; v1 (``"stats"``) rounds the normalised
    probabilities to the working dtype for the product, the others the
    unnormalised ones, then divide by their sum. Returns (o, lse), lse None
    on the routes without stats."""
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    bq, bk, bv = (None,) * 3 if qkv_bias is None else (b.to(q.dtype) for b in qkv_bias)
    return _fwd_plain(q, k, v, bq, bk, bv, _key_bias(pad_mask), head_dim, sm_scale, route)


def _biased(q, k, v, bq, bk, bv, head_dim, sm_scale):
    """The per-head (B, H, T, d) fp32 operands: the biases added (none with
    bq None) and q scaled, each rounded to the working dtype."""
    dt = q.dtype
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    scale = torch.tensor(sm_scale, dtype=dt, device=q.device)
    return _heads(q * scale, head_dim), _heads(k, head_dim), _heads(v, head_dim)


def _fwd_plain(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, route="stats_v3"):
    dt = q.dtype
    qh, kh, vh = _biased(q, k, v, bq, bk, bv, head_dim, sm_scale)
    s = qh @ kh.transpose(-1, -2) + key_bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    if route == "stats":
        o = _flat(((e / l).to(dt).float() @ vh).to(dt))
    else:
        o = _flat(((e.to(dt).float() @ vh) / l).to(dt))
    if route not in LSE_ROUTES:
        return o, None
    return o, torch.clamp(m + torch.log(l), min=-1e25).squeeze(-1)


def attention_bwd_plain(q, k, v, bq, bk, bv, key_bias, do, lse, o, head_dim: int,
                        sm_scale: float, route: str = "stats_v3"):
    """The backward kernel of ``route`` in plain ops: p rebuilt as ``exp(s +
    key_bias - lse)`` from the saved lse (the stats routes) or recomputed as
    ``exp(s + key_bias - m) / l`` with the row's own max and sum, no clamp
    (``"ctx"``, ``"attention"``); ``delta = rowsum(do * o)`` from the saved o
    (``"stats_v3"``, ``"ctx"``) or ``sum_j p dp`` in fp32; ``ds = p (dp -
    delta)`` rounded to the working dtype, ``dq = ds (k + bk) sm_scale``,
    ``dk = ds^T q_scaled``, ``dv = bf16(p)^T do``. lse and o may be None where
    the route does not read them.

    Returns (dq, dk, dv) in q.dtype and db (3, H*head_dim) fp32: the column
    sums of the rounded dq, dk, dv (the bias gradients before their cast), or
    None without biases."""
    dt = q.dtype
    qh, kh, vh = _biased(q, k, v, bq, bk, bv, head_dim, sm_scale)
    doh = _heads(do, head_dim)
    s = qh @ kh.transpose(-1, -2) + key_bias[:, None, None, :]
    if route in LSE_ROUTES:
        p = torch.exp(s - lse[..., None])
    else:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    if route in O_ROUTES:
        delta = (doh * _heads(o, head_dim)).sum(dim=-1, keepdim=True)
    else:
        delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dq = (ds @ kh) * sm_scale
    dk = ds.transpose(-1, -2) @ qh
    dq, dk, dv = (_flat(t).to(dt) for t in (dq, dk, dv))
    if bq is None:
        return dq, dk, dv, None
    db = torch.stack([t.float().sum(dim=(0, 1)) for t in (dq, dk, dv)])
    return dq, dk, dv, db


def tma_layout_error(head_dim: int, stride_b: int, stride_t: int, data_ptrs) -> str | None:
    """Why the forward kernels' tensor maps cannot read bf16 q, k, v of this
    layout, or None if they can.

    A map reads a (B, T, H*d) tensor whose rows are contiguous as the 4-D
    tensor (d, H, T, B): its base must be 16-byte aligned, and each stride
    past the innermost, in bytes (``2 head_dim``, ``2 stride_t``, ``2
    stride_b``), a positive multiple of 16 below 2**40. The views of one
    packed (B, T, 3 H*d) projection pass where the separate tensors do.
    """
    for what, stride in (("head_dim", head_dim), ("row stride", stride_t),
                         ("batch stride", stride_b)):
        nbytes = 2 * stride
        if nbytes % 16 or not 0 < nbytes < 2**40:
            return (f"the {what} is {nbytes} bytes; the tensor maps need a positive multiple "
                    "of 16 bytes below 2**40")
    if any(ptr % 16 for ptr in data_ptrs):
        return "q, k and v must start 16-byte aligned"
    return None


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
    if stride_c != 1:
        raise ValueError(f"{name}: rows must be contiguous")
    error = tma_layout_error(head_dim, stride_b, stride_t, (t.data_ptr() for t in (q, k, v)))
    if error is not None:
        raise ValueError(f"{name}: {error}")
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


def _check_route(name, route, bq):
    if route not in ROUTES:
        raise ValueError(f"{name}: route {route!r}, expected one of {ROUTES}")
    if bq is not None and route != "stats_v3":
        raise ValueError(f"{name}: the q/k/v biases require the v3 route, got {route!r}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, route="stats_v3"):
    """The forward kernel of ``route``: (o, lse) as ``_fwd_plain``."""
    name = "coral_attention_fwd"
    _check_route(name, route, bq)
    if not _build.require_cuda(name, q):
        return _fwd_plain(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, route)
    B, T, H, stride_b, stride_t = _check(name, q, k, v, bq, bk, bv, key_bias, head_dim)
    o = torch.empty((B, T, H * head_dim), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if route in LSE_ROUTES else None)
    scale = float(torch.tensor(sm_scale, dtype=q.dtype))
    _build.launch(
        name, _name("fwd", head_dim, bq is not None, route), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), _ptr(bq), _ptr(bk), _ptr(bv), key_bias.data_ptr(), o.data_ptr(), _ptr(lse),
        B, T, H, head_dim, stride_b, stride_t, scale, int(route == "stats"),
    )
    return o, lse


def attention_bwd(q, k, v, bq, bk, bv, key_bias, do, lse, o, head_dim: int,
                  sm_scale: float, out=None, route: str = "stats_v3"):
    """The backward kernels of ``route``; arguments and results as
    ``attention_bwd_plain``.

    Args:
        q, k, v: (B, T, H*d) bf16 as the forward took them, d in
            ``KERNEL_HEAD_DIMS``; bq, bk, bv (H*d,) bf16 (``"stats_v3"``
            only), or all None (the kernels without biases); key_bias (B, T)
            fp32; do (B, T, H*d) bf16; lse (B, H, T) fp32 on the stats
            routes, o (B, T, H*d) bf16 on ``"stats_v3"`` and ``"ctx"``
            (else None or ignored).
        out: a contiguous (B, T, 3 H*d) tensor of q.dtype: dq, dk and dv are
            written into its lane thirds (then returned as its views); None
            allocates them apart.
        route: the JAX ``custom_vjp`` whose backward this is (``ROUTES``).
    """
    name = "coral_attention_bwd"
    _check_route(name, route, bq)
    if not _build.require_cuda(name, q):
        grads = attention_bwd_plain(q, k, v, bq, bk, bv, key_bias, do, lse, o, head_dim,
                                    sm_scale, route)
        if out is None:
            return grads
        for part, g in zip(out.chunk(3, dim=-1), grads[:3]):
            part.copy_(g)
        return (*out.chunk(3, dim=-1), grads[3])
    B, T, H, stride_b, stride_t = _check(name, q, k, v, bq, bk, bv, key_bias, head_dim)
    HD = H * head_dim
    _build.check_cuda(name, torch.bfloat16, do)
    if do.shape != (B, T, HD):
        raise ValueError(f"{name}: do must be ({B}, {T}, {HD})")
    if route in O_ROUTES:
        _build.check_cuda(name, torch.bfloat16, o)
        if o.shape != (B, T, HD):
            raise ValueError(f"{name}: o must be ({B}, {T}, {HD})")
    if route in LSE_ROUTES:
        _build.check_cuda(name, torch.float32, lse)
        if lse.shape != (B, H, T):
            raise ValueError(f"{name}: lse must be ({B}, {H}, {T})")
    if out is None:
        dq, dk, dv = (torch.empty((B, T, HD), dtype=q.dtype, device=q.device) for _ in range(3))
    else:
        _build.check_cuda(name, q.dtype, out)
        if out.shape != (B, T, 3 * HD) or out.device != q.device:
            raise ValueError(f"{name}: out must be ({B}, {T}, {3 * HD}) on {q.device}")
        dq, dk, dv = out.chunk(3, dim=-1)
    scale = float(torch.tensor(sm_scale, dtype=q.dtype))
    kernel = _name("bwd", head_dim, bq is not None, route)
    # The dq kernel's (B, H, T) fp32 scratch for the dkv kernel: delta, and m
    # and l on the routes that sweep them.
    m, l, delta = torch.empty((3, B, H, T), dtype=torch.float32, device=q.device)
    if route != "stats_v3":
        _build.launch(
            "coral_attention_bwd_rows", kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            key_bias.data_ptr(), do.data_ptr(), _ptr(lse), _ptr(o), m.data_ptr(), l.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H, head_dim,
            stride_b, stride_t, dq.stride(1), scale, float(sm_scale), _ROWS_MODE[route],
        )
        return dq, dk, dv, None
    db_part = None
    if bq is not None:
        n_tiles = -(-T // _TILE)
        db_part = torch.empty((B, n_tiles, 3, HD), dtype=torch.float32, device=q.device)
    _build.launch(
        name, kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bq), _ptr(bk), _ptr(bv),
        key_bias.data_ptr(), do.data_ptr(), lse.data_ptr(), o.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(db_part), B, T, H, head_dim, stride_b,
        stride_t, dq.stride(1), scale, float(sm_scale),
    )
    return dq, dk, dv, None if db_part is None else db_part.sum(dim=(0, 1))


def _forward(route, q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, plain, saved):
    """(o, lse): the kept pair of a checkpoint replay (no launch; lse None on
    the routes without stats), else the forward kernel or its plain version."""
    if saved is not None:
        return tuple(None if t is None else t.detach() for t in saved)
    if plain:
        return _fwd_plain(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, route)
    return _fwd(q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, route)


class _AttentionVjp(torch.autograd.Function):
    """One ``custom_vjp`` of ``attention_pallas.py``, by its subclass's
    ``ROUTE``: the forward on that route, with its residuals (q, k, v, the
    biases on ``"stats_v3"``, key_bias, and lse and o where its backward
    reads them), and the backward kernels of that route. ``k`` None takes q
    as the packed (B, T, 3 H*d) projection: q, k, v are its lane thirds, and
    its gradient comes back as one packed tensor (the plain version
    concatenates). Given ``saved`` (the (o, lse) a remat policy kept) the
    forward returns them without a launch. On ``"stats_v3"`` the bias
    gradients are the column sums cast to the working dtype
    (``dbsum.astype(bq.dtype)``), then to each bias's."""

    ROUTE = "stats_v3"

    @classmethod
    def forward(cls, ctx, q, k, v, bq, bk, bv, key_bias, head_dim, sm_scale, plain, saved):
        packed = k is None
        qs, ks, vs = q.chunk(3, dim=-1) if packed else (q, k, v)
        biases = (bq, bk, bv)
        qb, kb, vb = (None,) * 3 if bq is None else (b.to(q.dtype) for b in biases)
        o, lse = _forward(cls.ROUTE, qs, ks, vs, qb, kb, vb, key_bias, head_dim, sm_scale, plain,
                          saved)
        ctx.save_for_backward(q, k, v, qb, kb, vb, key_bias,
                              lse if cls.ROUTE in LSE_ROUTES else None,
                              o if cls.ROUTE in O_ROUTES else None)
        ctx.head_dim, ctx.sm_scale, ctx.plain, ctx.packed = head_dim, sm_scale, plain, packed
        ctx.bias_dtypes = None if bq is None else tuple(b.dtype for b in biases)
        if lse is not None:
            ctx.mark_non_differentiable(lse)
        return o, lse

    @classmethod
    def backward(cls, ctx, do, _dlse):
        q, k, v, qb, kb, vb, key_bias, lse, o = ctx.saved_tensors
        qs, ks, vs = q.chunk(3, dim=-1) if ctx.packed else (q, k, v)
        args = (qs, ks, vs, qb, kb, vb, key_bias, do.contiguous(), lse, o, ctx.head_dim,
                ctx.sm_scale)
        tail = (None,) * 8
        if ctx.packed:
            if ctx.plain:
                grads = attention_bwd_plain(*args, cls.ROUTE)
                return torch.cat(grads[:3], dim=-1), None, None, *tail
            dqkv = torch.empty_like(q, memory_format=torch.contiguous_format)
            attention_bwd(*args, out=dqkv, route=cls.ROUTE)
            return dqkv, None, None, *tail
        bwd = attention_bwd_plain if ctx.plain else attention_bwd
        dq, dk, dv, db = bwd(*args, route=cls.ROUTE)
        dbs = ([None] * 3 if db is None else
               [db[i].to(q.dtype).to(dtype) for i, dtype in enumerate(ctx.bias_dtypes)])
        return dq, dk, dv, *dbs, None, None, None, None, None


class _AttentionStatsV3(_AttentionVjp):
    """``_attention_stats_v3_qb`` / ``_attention_stats_v3``."""

    ROUTE = "stats_v3"


class _AttentionStatsV2(_AttentionVjp):
    """``_attention_stats_v2``."""

    ROUTE = "stats_v2"


class _AttentionStats(_AttentionVjp):
    """``_attention_stats``."""

    ROUTE = "stats"


class _AttentionCtx(_AttentionVjp):
    """``_attention_ctx``."""

    ROUTE = "ctx"


class _Attention(_AttentionVjp):
    """``_attention``."""

    ROUTE = "attention"


_FUNCTIONS = {f.ROUTE: f for f in (_AttentionStatsV3, _AttentionStatsV2, _AttentionStats,
                                   _AttentionCtx, _Attention)}


def short_t_attention_flat(q, k, v, pad_mask, head_dim: int, qkv_bias=None,
                           sm_scale: float | None = None, plain: bool = False, saved=None,
                           save_stats="v3", o_residual: bool = False):
    """``softmax((q + bq) (k + bk)^T * scale + key_bias) (v + bv)`` per head,
    differentiable in q, k, v and the biases (without ``qkv_bias``, the same
    with no bias added), on the route ``save_stats`` and ``o_residual`` pick.

    Args:
        q, k, v: (B, T, H*head_dim) projections without their biases; on CUDA
            bf16 with head_dim in ``KERNEL_HEAD_DIMS``, the last axis contiguous
            and the row strides equal for all three (slices of one packed
            tensor are taken as they are).
        pad_mask: (B, T) bool, True for a valid key.
        qkv_bias: (bq, bk, bv), each (H*head_dim,), cast to q.dtype; None for
            the kernels without biases. Only with ``save_stats="v3"``.
        sm_scale: score scale, default head_dim ** -0.5 (rounded to q.dtype
            before use, as the JAX kernel does).
        plain: run the plain versions (forward and backward) on any device.
        saved: the (o, lse) a checkpoint replay already holds (no launch;
            lse None on the routes without stats).
        save_stats, o_residual: the JAX keywords (``route``); the default is
            the setups' v3.

    Returns:
        (o, lse): o (B, T, H*head_dim) in q.dtype, lse (B, H, T) fp32 (None
        on the routes without stats).
    """
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    fn = _FUNCTIONS[route(save_stats, o_residual)]
    if qkv_bias is not None and fn is not _AttentionStatsV3:
        raise ValueError(f"qkv_bias requires save_stats='v3', got {save_stats!r}")
    return fn.apply(q, k, v, *(qkv_bias or (None,) * 3), _key_bias(pad_mask), head_dim,
                    sm_scale, plain, saved)


def short_t_attention_packed(qkv, pad_mask, head_dim: int, sm_scale: float | None = None,
                             plain: bool = False, saved=None, save_stats="v3",
                             o_residual: bool = False):
    """``short_t_attention_flat`` without biases on q, k, v = the lane thirds
    of ``qkv`` (B, T, 3 H*head_dim), the packed projection of
    ``fused_qkv_ln``; its gradient comes back as one (B, T, 3 H*head_dim)
    tensor. Other arguments and the result as ``short_t_attention_flat``."""
    if sm_scale is None:
        sm_scale = float(head_dim) ** -0.5
    return _FUNCTIONS[route(save_stats, o_residual)].apply(
        qkv, None, None, None, None, None, _key_bias(pad_mask), head_dim, sm_scale, plain, saved)
