"""Non-causal self-attention with backward: unmasked for the Whisper encoder,
with segment ids for wav2vec2's ``attention_impl: flash`` route.

Port of ``coral_tpu/ops/flash_attention.py`` ``flash_self_attention``, which
runs JAX's stock TPU flash kernel over T padded to its block grid: the forward
``_flash`` (o only, serving) and ``_flash_res`` (o and the row stats l and m,
training), and the explicit backward ``_grads`` (the stock dkv kernel and the
patched dq kernel) behind the ``custom_vjp`` ``_attention_fwd`` /
``_attention_bwd``, whose residuals are ``(q, k, v, o, l, m)``. On a CUDA
tensor the wrappers launch ``csrc/flash_attention.cu`` on the projections as
they lie, (B, T, H*d) rows read through their strides, with keys past T masked
in the kernels; on a CPU tensor they run the plain versions beside them. The
kernels are built at head_dim 64 (Whisper, XLS-R-300M), 80 (XLS-R-1B) and 120
(XLS-R-2B, padded to 128 inside the kernels' tiles), ``KERNEL_HEAD_DIMS``; a
CUDA tensor of another head_dim raises. The plain versions take any d.

m is each query row's max of the scaled scores and l its sum of ``exp(s -
m)``, both fp32 (B, H, T). The backward is the stock kernel's formula:
``di = rowsum(o do)`` in fp32, ``p = exp(s scale - m) / l``, ``dv =
bf16(p)^T do``, ``ds = (do v^T - di) p scale``, ``dk = bf16(ds)^T q``, ``dq =
bf16(ds) k``, sums in fp32, results in q's dtype. ``flash_attention_bwd``
launches the dq kernel first, which also writes di as a (B, H, T) fp32
scratch, then the dkv kernel, which reads it (di is formed once, not once per
key block); both kernels take q, k, v and do through TMA tensor maps, so their
layout rule is the forwards' (``tma_layout_error``), checked before the launch
by ``_check_bwd``, which needs no card.

Segment ids port ``coral_tpu/models/wav2vec2.py`` ``_flash_attention``
(:440-478): the same stock kernel over q, k and v padded with zero rows to a
multiple of 128 (``SEGMENT_BLOCK``), with ``SegmentIds(q=ids, kv=ids)``, ids
1 for valid frames and 0 for padded frames and the grid's rows
(``segment_ids``). A score is masked where the ids differ, so a padded query
attends to every padded key, the grid's zero rows included (score 0, v = 0),
unlike a key mask. The wrappers take q, k, v at T rows and the (B, Tp) ids;
the kernels read rows past T as zeros, so no padded copy is made, and return
T rows, as ``out[:, :, :T]`` does; the gradient of the grid's rows is the
zero the slice gives them. The plain versions take the padded (B, Tp, H, d)
tensors and the ids, the stock call's own arguments.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .attention import KERNEL_HEAD_DIMS, tma_layout_error  # attention.cuh's tiles

# The row grid wav2vec2's flash route pads T to (its block sizes, all 128).
SEGMENT_BLOCK = 128


def _heads(t):
    return t.transpose(1, 2).float()  # (B, T, H, d) -> (B, H, T, d) fp32


def segment_ids(pad_mask):
    """(B, T) bool valid frames -> (B, Tp) int32 segment ids, T padded to a
    multiple of ``SEGMENT_BLOCK``: 1 for valid frames, 0 for padded ones and
    the grid's rows (``jnp.pad(pad_mask.astype(int32), ...)``)."""
    T = pad_mask.shape[1]
    return F.pad(pad_mask.to(torch.int32), (0, -(-T // SEGMENT_BLOCK) * SEGMENT_BLOCK - T))


def _scores(q, k, segment_ids):
    """fp32 (B, H, T, T) scores ``q k^T * d**-0.5``, -inf where the query's
    and the key's segment ids differ."""
    s = (_heads(q) @ _heads(k).transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if segment_ids is None:
        return s
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    return s.masked_fill(~same, float("-inf"))


def flash_attention_fwd_plain(q, k, v, segment_ids=None):
    """The TPU kernel's math on (B, T, H, d): fp32 scores ``q k^T`` times
    ``d**-0.5`` (masked by ``segment_ids`` (B, T) where given), unnormalised
    probabilities ``exp(s - m)`` rounded to the working dtype for the product
    with v, the fp32 sum divided by the row sum l, cast to q.dtype. Returns
    (o (B, T, H, d), l, m (B, H, T) fp32), the order of ``_flash_res``."""
    dt = q.dtype
    s = _scores(q, k, segment_ids)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = (e.to(dt).float() @ _heads(v)) / l[..., None]
    return o.to(dt).transpose(1, 2), l, m


def _bwd_p(q, k, l, m, segment_ids):
    """The stock backward's fp32 (B, H, T, T) ``p = exp(s scale - m) / l``."""
    return torch.exp(_scores(q, k, segment_ids) - m[..., None]) * (1.0 / l)[..., None]


def _bwd_di(o, do):
    """``di = rowsum(o do)`` in fp32, (B, H, T)."""
    return (_heads(o) * _heads(do)).sum(dim=-1)


def _bwd_ds(v, do, di, p):
    """``ds = (do v^T - di) p scale`` rounded to the working dtype, in fp32."""
    scale = v.shape[-1] ** -0.5
    return ((_heads(do) @ _heads(v).transpose(-1, -2) - di[..., None]) * p * scale).to(
        v.dtype).float()


def _bwd_dq_plain(q, k, v, o, l, m, do, segment_ids=None):
    """The dq kernel's plain version on (B, T, H, d) at T rows (no padding):
    (dq (B, T, H, d) in q.dtype, di (B, H, T) fp32)."""
    di = _bwd_di(o, do)
    dq = _bwd_ds(v, do, di, _bwd_p(q, k, l, m, segment_ids)) @ _heads(k)
    return dq.to(q.dtype).transpose(1, 2), di


def _bwd_dkv_plain(q, k, v, l, m, do, di, segment_ids=None):
    """The dkv kernel's plain version: (dk, dv) from di, arguments as
    ``_bwd_dq_plain``."""
    p = _bwd_p(q, k, l, m, segment_ids)
    dv = p.to(q.dtype).float().transpose(-1, -2) @ _heads(do)
    dk = _bwd_ds(v, do, di, p).transpose(-1, -2) @ _heads(q)
    return tuple(t.to(q.dtype).transpose(1, 2) for t in (dk, dv))


def flash_attention_bwd_plain(q, k, v, o, l, m, do, segment_ids=None):
    """The stock TPU backward (dkv and dq kernels) in plain ops; see the
    module docstring. q, k, v, o, do (B, T, H, d); l, m (B, H, T) fp32;
    ``segment_ids`` (B, T) as the forward's. Returns (dq, dk, dv), (B, T, H,
    d) in q.dtype."""
    dq, di = _bwd_dq_plain(q, k, v, o, l, m, do, segment_ids)
    return (dq, *_bwd_dkv_plain(q, k, v, l, m, do, di, segment_ids))


def _pad_rows(t, Tp):
    """(B, T, H, d) -> (B, Tp, H, d), the new rows zero."""
    return F.pad(t, (0, 0, 0, 0, 0, Tp - t.shape[1]))


def _padded_fwd_plain(q, k, v, segment_ids=None):
    """The wrappers' plain forward, through the stock call: q, k, v (B, T, H,
    d) padded with zero rows to the ids' Tp (T without ids), then T rows of
    o, l, m."""
    T = q.shape[1]
    Tp = T if segment_ids is None else segment_ids.shape[1]
    o, l, m = flash_attention_fwd_plain(*(_pad_rows(t, Tp) for t in (q, k, v)), segment_ids)
    return o[:, :T], l[..., :T], m[..., :T]


def _padded_rows(q, l, m, segment_ids):
    """The padded call's row count Tp (T without ids) and l, m padded to it
    with 1 and +inf, which give the padded query rows p = 0 (what they add is
    0 either way: their do is the slice's zero cotangent)."""
    T = q.shape[1]
    Tp = T if segment_ids is None else segment_ids.shape[1]
    lp, mp = (F.pad(t, (0, Tp - T), value=value) for t, value in ((l, 1.0), (m, float("inf"))))
    return Tp, lp, mp


def _padded_dq_plain(q, k, v, o, l, m, do, segment_ids=None):
    """The dq wrapper's plain version, through the stock call: q, k, v, o, do
    padded with zero rows to the ids' Tp, then T rows of dq and of di."""
    T = q.shape[1]
    Tp, lp, mp = _padded_rows(q, l, m, segment_ids)
    dq, di = _bwd_dq_plain(*(_pad_rows(t, Tp) for t in (q, k, v, o)), lp, mp, _pad_rows(do, Tp),
                           segment_ids)
    return dq[:, :T], di[..., :T]


def _padded_dkv_plain(q, k, v, l, m, do, di, segment_ids=None):
    """The dkv wrapper's plain version, through the stock call, from the dq
    wrapper's di (0 on the padded rows, as rowsum(o do) is there)."""
    T = q.shape[1]
    Tp, lp, mp = _padded_rows(q, l, m, segment_ids)
    grads = _bwd_dkv_plain(*(_pad_rows(t, Tp) for t in (q, k, v)), lp, mp, _pad_rows(do, Tp),
                           F.pad(di, (0, Tp - T)), segment_ids)
    return tuple(g[:, :T] for g in grads)


def _padded_bwd_plain(q, k, v, o, l, m, do, segment_ids=None):
    """The wrappers' plain backward, through the stock call: the padded rows
    get do = 0 (the slice's cotangent), and l = 1, m = +inf, which give them
    p = 0 (what they add is 0 either way); then T rows of dq, dk, dv."""
    dq, di = _padded_dq_plain(q, k, v, o, l, m, do, segment_ids)
    return (dq, *_padded_dkv_plain(q, k, v, l, m, do, di, segment_ids))


def flash_self_attention_plain(q, k, v, segment_ids=None):
    """The forward's plain version, o only, T rows; ``segment_ids`` as
    ``flash_self_attention``."""
    return _padded_fwd_plain(q, k, v, segment_ids)[0]


def _check(name, q, k, v):
    """Raises unless the kernels take q, k, v; returns (B, T, H, stride_b,
    stride_t)."""
    B, T, H, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take head_dim {KERNEL_HEAD_DIMS}, got {d} "
                         "(ROADMAP.md, Queue 2 item 3)")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: the kernel takes bf16 q, k, v")
    for t in (k, v):
        if t.shape != q.shape or t.stride() != q.stride() or t.device != q.device:
            raise ValueError(f"{name}: q, k, v must share shape, strides and device")
    stride_b, stride_t, stride_h, stride_d = q.stride()
    if stride_d != 1 or stride_h != d:
        raise ValueError(f"{name}: each row's H*d values must be contiguous")
    error = tma_layout_error(d, stride_b, stride_t, (t.data_ptr() for t in (q, k, v)))
    if error is not None:
        raise ValueError(f"{name}: {error}")
    return B, T, H, stride_b, stride_t


def _check_segments(name, q, segment_ids):
    """Raises unless ``segment_ids`` is (B, Tp >= T) int32 on q's device;
    returns (its pointer, Tp), or (None, T) without ids."""
    B, T = q.shape[:2]
    if segment_ids is None:
        return None, T
    if segment_ids.dim() != 2 or segment_ids.shape[0] != B or segment_ids.shape[1] < T:
        raise ValueError(f"{name}: segment ids must be ({B}, >= {T}), got "
                         f"{tuple(segment_ids.shape)}")
    if (segment_ids.dtype != torch.int32 or not segment_ids.is_contiguous()
            or segment_ids.device != q.device):
        raise ValueError(f"{name}: segment ids must be contiguous int32 on {q.device}")
    return segment_ids.data_ptr(), segment_ids.shape[1]


def _counter(kernel, segment_ids, head_dim):
    """The launch counter's name: the segment-id instantiations apart
    (``flash_attention_seg_train``), and the head dims other than 64 apart
    (``flash_attention_seg_bwd_dq_hd120``)."""
    if segment_ids is not None:
        kernel = kernel.replace("flash_attention", "flash_attention_seg", 1)
    return kernel if head_dim == 64 else f"{kernel}_hd{head_dim}"


def _launch_fwd(name, kernel, q, k, v, stats: bool, segment_ids):
    B, T, H, stride_b, stride_t = _check(name, q, k, v)
    seg, Tk = _check_segments(name, q, segment_ids)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    l, m = ((torch.empty((B, H, T), dtype=torch.float32, device=q.device) for _ in range(2))
            if stats else (None, None))
    d = q.shape[-1]
    _build.launch(name, _counter(kernel, segment_ids, d), q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), None if m is None else m.data_ptr(),
                  None if l is None else l.data_ptr(), seg, B, T, Tk, H, d, stride_b, stride_t,
                  float(d) ** -0.5)
    return o, l, m


def flash_self_attention(q, k, v, segment_ids=None):
    """``softmax(q k^T * d**-0.5) v`` per head, not causal (serving: no
    residuals, no gradient), unmasked or masked by segment ids.

    Args:
        q, k, v: (B, T, H, d); on CUDA bf16 with d in ``KERNEL_HEAD_DIMS``,
            the (H, d) axes of each row contiguous, and the same strides for
            all three (views of one packed projection are taken as they are).
        segment_ids: None, or the (B, Tp) int32 ids of the padded call
            (``segment_ids``), Tp >= T, contiguous: rows past T count as zero
            rows.

    Returns:
        (B, T, H, d) in q.dtype (contiguous on CUDA).
    """
    name = "coral_flash_attention_fwd"
    if not _build.require_cuda(name, q):
        return flash_self_attention_plain(q, k, v, segment_ids)
    return _launch_fwd(name, "flash_attention", q, k, v, False, segment_ids)[0]


def flash_attention_fwd(q, k, v, segment_ids=None):
    """The training forward (``_flash_res``): (o, l, m) as
    ``flash_attention_fwd_plain``, T rows; arguments as
    ``flash_self_attention``."""
    name = "coral_flash_attention_fwd"
    if not _build.require_cuda(name, q):
        return _padded_fwd_plain(q, k, v, segment_ids)
    return _launch_fwd(name, "flash_attention_train", q, k, v, True, segment_ids)


def _check_bwd(name, q, k, v, l, m, do, segment_ids, o=None, di=None):
    """Raises unless the backward kernels take these tensors (on any device:
    it runs before the launch); returns (B, T, Tk, H, stride_b, stride_t, the
    ids' pointer). q, k, v as the forward; o (the dq kernel), do (B, T, H, d)
    bf16 contiguous; l, m and di (the dkv kernel) (B, H, T) fp32 contiguous;
    every tensor 16-byte aligned (the tensor maps read do, and q, k, v
    through ``tma_layout_error``'s rule)."""
    B, T, H, stride_b, stride_t = _check(name, q, k, v)
    seg, Tk = _check_segments(name, q, segment_ids)
    _build.check_cuda(name, torch.bfloat16, *(t for t in (o, do) if t is not None))
    _build.check_cuda(name, torch.float32, *(t for t in (l, m, di) if t is not None))
    if any(t is not None and t.shape != q.shape for t in (o, do)):
        raise ValueError(f"{name}: o and do must be {tuple(q.shape)}")
    if any(t is not None and t.shape != (B, H, T) for t in (l, m, di)):
        raise ValueError(f"{name}: l, m and di must be ({B}, {H}, {T})")
    if any(t.device != q.device for t in (l, m, do, o, di) if t is not None):
        raise ValueError(f"{name}: tensors on other devices than {q.device}")
    return B, T, Tk, H, stride_b, stride_t, seg


def flash_attention_bwd_dq(q, k, v, o, l, m, do, segment_ids=None):
    """The query-major backward kernel (``flash_attention_bwd_dq_fixed``),
    launched first: dq and ``di = rowsum(o do)``, the scratch the dkv kernel
    reads. q, k, v and ``segment_ids`` as the forward took them; o, do (B, T,
    H, d) bf16 contiguous; l, m (B, H, T) fp32. Returns (dq (B, T, H, d)
    bf16 contiguous, di (B, H, T) fp32)."""
    name = "coral_flash_attention_bwd"
    if not _build.require_cuda(name, q):
        return _padded_dq_plain(q, k, v, o, l, m, do, segment_ids)
    B, T, Tk, H, stride_b, stride_t, seg = _check_bwd(name, q, k, v, l, m, do, segment_ids, o=o)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    di = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    d = q.shape[-1]
    _build.launch(name, _counter("flash_attention_bwd_dq", segment_ids, d), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), m.data_ptr(),
                  l.data_ptr(), seg, di.data_ptr(), dq.data_ptr(), None, None, B, T, Tk, H, d,
                  stride_b, stride_t, float(d) ** -0.5)
    return dq, di


def flash_attention_bwd_dkv(q, k, v, l, m, do, di, segment_ids=None):
    """The key-major backward kernel (the stock ``_flash_attention_bwd_dkv``)
    from the dq kernel's ``di``: (dk, dv), (B, T, H, d) bf16 contiguous;
    arguments as ``flash_attention_bwd_dq``."""
    name = "coral_flash_attention_bwd"
    if not _build.require_cuda(name, q):
        return _padded_dkv_plain(q, k, v, l, m, do, di, segment_ids)
    B, T, Tk, H, stride_b, stride_t, seg = _check_bwd(name, q, k, v, l, m, do, segment_ids,
                                                      di=di)
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    d = q.shape[-1]
    _build.launch(name, _counter("flash_attention_bwd_dkv", segment_ids, d), q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), None, do.data_ptr(), m.data_ptr(), l.data_ptr(),
                  seg, di.data_ptr(), None, dk.data_ptr(), dv.data_ptr(), B, T, Tk, H, d,
                  stride_b, stride_t, float(d) ** -0.5)
    return dk, dv


def flash_attention_bwd(q, k, v, o, l, m, do, segment_ids=None):
    """The backward kernels: dq (and di) in one launch, then dk and dv from
    di in another; arguments and results as ``flash_attention_bwd_plain``, T
    rows. On a CPU tensor the two wrappers' plain versions, which give
    ``_padded_bwd_plain``'s values.

    Args:
        q, k, v, segment_ids: as the forward took them; o, do: (B, T, H, d)
            bf16 contiguous; l, m: (B, H, T) fp32.
    """
    dq, di = flash_attention_bwd_dq(q, k, v, o, l, m, do, segment_ids)
    return (dq, *flash_attention_bwd_dkv(q, k, v, l, m, do, di, segment_ids))


class _FlashAttention(torch.autograd.Function):
    """``_attention_fwd`` / ``_attention_bwd``: residuals (q, k, v, o, l, m)
    and the segment ids. Given ``saved`` (the (o, l, m) a remat policy kept,
    the JAX ``flash_o``, ``flash_l`` and ``flash_m``), the forward returns
    them without a launch."""

    @staticmethod
    def forward(ctx, q, k, v, plain, saved, segment_ids):
        if saved is not None:
            o, l, m = (t.detach() for t in saved)
        else:
            o, l, m = (_padded_fwd_plain if plain else flash_attention_fwd)(q, k, v, segment_ids)
        ctx.save_for_backward(q, k, v, o, l, m, segment_ids)
        ctx.plain = plain
        ctx.mark_non_differentiable(l, m)
        return o, l, m

    @staticmethod
    def backward(ctx, do, _dl, _dm):
        q, k, v, o, l, m, segment_ids = ctx.saved_tensors
        bwd = _padded_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, l, m, do.contiguous(), segment_ids)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, plain: bool = False, saved=None, segment_ids=None):
    """``flash_self_attention``, differentiable in q, k and v.

    Args:
        q, k, v: (B, T, H, d), as ``flash_self_attention`` takes them.
        plain: run the plain versions (forward and backward) on any device.
        saved: the (o, l, m) a checkpoint replay already holds (no launch).
        segment_ids: as ``flash_self_attention``.

    Returns:
        (o (B, T, H, d) in q.dtype, l, m (B, H, T) fp32).
    """
    return _FlashAttention.apply(q, k, v, plain, saved, segment_ids)
