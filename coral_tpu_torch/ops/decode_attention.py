"""Decode-step attention over stacked flat (L, rows, H*d) K/V stores.

Port of ``coral_tpu/ops/decode_attention.py``: ``decode_self_attention`` (the
Whisper decoder's self-attention over its cache, with the beam slot mask) and
``decode_cross_attention`` (over the encoder's K/V, shared by the K beams of
an item), with the JAX signatures and shapes. Each reads layer ``layer`` of
the stacked store by offset; no per-layer slice is made. On a CUDA tensor the
wrappers launch ``csrc/decode_attention.cu`` (split over 128-key chunks and
combined, so the normalised probabilities are not rounded to bf16 before the
product as the TPU kernel rounds them); on a CPU tensor they run the plain
versions beside them, which are the JAX package's own off-TPU composition.
Inference only.
"""

from __future__ import annotations

import torch

from . import _build

_NEG = -1e30
KERNEL_HEAD_DIM = 64
_CHUNK = 128
_MAX_BEAMS = 64


def _attend(qh, kh, vh, mask, scale, dtype):
    """qh (B, K, H, d) and kh, vh (B, N, H, d) in the working dtype; mask
    (B, K, N) or None. fp32 scores times scale, the finite -1e30 where the
    mask is not > 0, fp32 softmax, probabilities rounded to the working dtype
    for the fp32-accumulated product with v, cast to ``dtype``."""
    s = torch.einsum("bkhd,bnhd->bkhn", qh.float(), kh.float()) * scale
    if mask is not None:
        s = torch.where(mask[:, :, None, :] > 0, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkhn,bnhd->bkhd", p.to(vh.dtype).float(), vh.float())
    return o.to(dtype)


def decode_self_attention_plain(q, cache_k, cache_v, onehot, n_heads: int, layer: int):
    """The JAX off-TPU composition of ``decode_self_attention``."""
    L, BK, T, HD = cache_k.shape
    B, K, KT = onehot.shape
    d = HD // n_heads
    qh = q.reshape(B, K, n_heads, d)
    kh = cache_k[layer].reshape(B, K * T, n_heads, d)
    vh = cache_v[layer].reshape(B, K * T, n_heads, d)
    return _attend(qh, kh, vh, onehot, d**-0.5, q.dtype).reshape(BK, HD)


def decode_cross_attention_plain(q, k, v, n_heads: int, layer: int):
    """The JAX off-TPU composition of ``decode_cross_attention``."""
    L, B, S, HD = k.shape
    K = q.shape[0] // B
    d = HD // n_heads
    qh = q.reshape(B, K, n_heads, d)
    kh = k[layer].reshape(B, S, n_heads, d)
    vh = v[layer].reshape(B, S, n_heads, d)
    return _attend(qh, kh, vh, None, d**-0.5, q.dtype).reshape(B * K, HD)


def _launch(kernel, q, k, v, mask, B, K, n_keys, n_heads, layer):
    name = "coral_decode_attention"
    L = k.shape[0]
    HD = q.shape[-1]
    d = HD // n_heads
    if d * n_heads != HD or d != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, got {HD} "
                         f"over {n_heads} heads")
    if not 1 <= K <= _MAX_BEAMS:
        raise ValueError(f"{name}: the kernel takes 1 to {_MAX_BEAMS} beams, got {K}")
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} of {L}")
    _build.check_cuda(name, torch.bfloat16, q, k, v)
    if mask is not None:
        _build.check_cuda(name, torch.float32, mask)
        if mask.device != q.device:
            raise ValueError(f"{name}: the mask must be on {q.device}")
    if k.device != q.device or v.device != q.device or v.shape != k.shape:
        raise ValueError(f"{name}: q, k, v on one device, k and v of one shape")
    n_chunks = -(-n_keys // _CHUNK)
    part_o = torch.empty((B * K, n_heads, n_chunks, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B * K, n_heads, n_chunks, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    _build.launch(name, kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  0 if mask is None else mask.data_ptr(), part_o.data_ptr(),
                  part_ml.data_ptr(), out.data_ptr(), B, K, n_keys, n_heads, int(layer),
                  float(d) ** -0.5)
    return out


def decode_self_attention(q, cache_k, cache_v, onehot, n_heads: int, layer: int):
    """One-token self-attention over one layer of a stacked flat cache.

    Args:
        q: (B*K, HD) current-position queries.
        cache_k, cache_v: (L, B*K, T, HD) stacked caches; only ``layer`` is read.
        onehot: (B, K, K*T) 0/1 mask: query beam k of batch item b may attend
            cache slot j at position t iff ``onehot[b, k, j*T + t] > 0`` (the
            ancestor chain and the causal bound; for K = 1 the causal mask).
        n_heads: head count (HD = n_heads * head_dim).
        layer: layer index.

    Returns:
        (B*K, HD) attention outputs in q.dtype. On CUDA everything is bf16 but
        the fp32 onehot, contiguous, with head_dim 64 and K <= 64.
    """
    if not _build.require_cuda("coral_decode_attention", q):
        return decode_self_attention_plain(q, cache_k, cache_v, onehot, n_heads, layer)
    L, BK, T, HD = cache_k.shape
    B, K, KT = onehot.shape
    if BK != B * K or KT != K * T or q.shape != (BK, HD):
        raise ValueError(f"coral_decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(cache_k.shape)} and onehot {tuple(onehot.shape)} disagree")
    return _launch("decode_self_attention", q, cache_k, cache_v, onehot, B, K, K * T,
                   n_heads, layer)


def decode_cross_attention(q, k, v, n_heads: int, layer: int):
    """One-token cross-attention; the K beams of each batch item share K/V.

    Args:
        q: (B*K, HD) queries.
        k, v: (L, B, S, HD) stacked per-layer encoder K/V (not repeated per
            beam); only ``layer`` is read.
        n_heads: head count.
        layer: layer index.

    Returns:
        (B*K, HD) attention outputs in q.dtype (CUDA: as
        ``decode_self_attention``).
    """
    if not _build.require_cuda("coral_decode_attention", q):
        return decode_cross_attention_plain(q, k, v, n_heads, layer)
    L, B, S, HD = k.shape
    if q.shape[0] % B or q.shape[1] != HD:
        raise ValueError(f"coral_decode_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    return _launch("decode_cross_attention", q, k, v, None, B, q.shape[0] // B, S, n_heads,
                   layer)
