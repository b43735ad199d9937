"""Decode-step attention over stacked flat (L, rows, H*d) K/V stores.

Port of ``coral_tpu/ops/decode_attention.py``: ``decode_self_attention`` (the
Whisper decoder's self-attention over its cache, with the beam slot mask) and
``decode_cross_attention`` (over the encoder's K/V, shared by the K beams of
an item), with the JAX signatures and shapes. Each reads layer ``layer`` of
the stacked store as one coordinate of a tensor map; no per-layer slice is
made. On a CUDA tensor the wrappers launch ``csrc/decode_attention.cu``: one
kernel a call, whose thread-block cluster of ``cluster_size`` blocks splits
each (item, head)'s keys into whole 64-key tiles (``cluster_shares``) and
combines them in rank order, the normalised probabilities kept in fp32 until
the output where the TPU kernel rounds them to bf16 before the product. On a
CPU tensor they run the plain versions beside them, which are the JAX
package's own off-TPU composition. Inference only.
"""

from __future__ import annotations

import torch

from . import _build

_NEG = -1e30
KERNEL_HEAD_DIM = 64
TILE = 64  # keys a block streams at a time
MAX_CLUSTER = 8  # the portable cluster size
GROUP = 8  # beams a block takes
_MAX_BEAMS = 64
# (device, K == 1): the blocks a call may launch on that card (``wave_blocks``).
_WAVE: dict = {}


def wave_blocks(K: int, device: int) -> int:
    """The blocks a call of K beams may launch on card ``device``: one wave
    of the kernel's instantiation, at most two an SM (the kernel library's
    occupancy query, once per card)."""
    key = (device, K == 1)
    blocks = _WAVE.get(key)
    if blocks is None:
        blocks = _build.library().coral_decode_wave_blocks(K)
        if blocks < 1:
            raise RuntimeError("coral_decode_wave_blocks: the occupancy query failed")
        _WAVE[key] = blocks
    return blocks


def cluster_size(n_keys: int, items: int, wave: int) -> int:
    """The blocks that split one (item, head, beam group)'s ``n_keys`` keys:
    the largest power of two up to 8 that leaves every block a whole 64-key
    tile and keeps the call's ``items`` x C blocks within ``wave``
    (``wave_blocks``); at least 1."""
    tiles = -(-n_keys // TILE)
    c = 1
    while 2 * c <= min(MAX_CLUSTER, tiles) and 2 * c * items <= wave:
        c *= 2
    return c


def cluster_shares(n_keys: int, C: int) -> list[range]:
    """The keys of each rank of a cluster of ``C``: tiles [c n / C, (c + 1) n
    / C) of the n = ceil(n_keys / 64), cut at ``n_keys``."""
    tiles = -(-n_keys // TILE)
    return [range(c * tiles // C * TILE, min((c + 1) * tiles // C * TILE, n_keys))
            for c in range(C)]


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
    if v.shape != k.shape:
        raise ValueError(f"{name}: k and v of one shape")
    _build.check_cuda(name, torch.bfloat16, q, k, v)
    if mask is not None:
        _build.check_cuda(name, torch.float32, mask)
        if mask.device != q.device:
            raise ValueError(f"{name}: the mask must be on {q.device}")
    out = torch.empty_like(q)
    C = cluster_size(n_keys, B * n_heads * -(-K // GROUP), wave_blocks(K, q.get_device()))
    _build.launch(name, kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  0 if mask is None else mask.data_ptr(), out.data_ptr(), B, K, n_keys,
                  n_heads, L, int(layer), C, float(d) ** -0.5)
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
