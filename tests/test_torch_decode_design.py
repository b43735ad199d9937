"""The decode attention kernel's design, walked in plain PyTorch on the CPU.

``decode_self_attention`` (K8) and ``decode_cross_attention`` (K9) launch one
kernel a call on the card (``coral_tpu_torch/csrc/decode_attention.cu``),
which only a card runs. ``_walk`` below does what that kernel does, in fp32,
at a given cluster size C:

- a thread-block cluster of C blocks per (item, head, group of up to 8
  beams); rank c takes the keys of ``cluster_shares``, whole 64-key tiles
  [c n / C, (c + 1) n / C), the last tile of the row cut at n_keys;
- tile by tile, each of the block's four consumer warps over its own 16 keys
  of the tile: the scores in fp32 times 64**-0.5, the finite -1e30 where the
  onehot is not > 0, -inf past n_keys (the tensor map's zero rows); the
  warp's online max m and sum l per beam, p = exp(s - m), its running p @ v
  rescaled by exp(m_old - m_new) (a warp whose keys so far are all padding
  keeps m = -inf and nothing else);
- after the last tile the warps' (m, l, o) combined in warp order, then the
  cluster's blocks in rank order: M = max m, sum exp(m - M) o over sum
  exp(m - M) l, rounded once.

The walk at every C the kernel takes (1, 2, 4, 8, at most the tiles) is held
against the JAX package's composition (``coral_tpu.ops.decode_attention``
with ``interpret=True``) and against the plain versions, on fp32 inputs at
atol 1e-5 (fp32 sums in another order: the tile-wise rescaling and the
combines add a few roundings of 2**-24 relative to values below 4); with
bf16 inputs, where both references round p to bf16 before p @ v and the
kernel does not, at 2**-9 max|v| plus two bf16 ulps (each p rounded within
2**-9 of itself, over weights that sum to 1; then both sides round once to
bf16). Cases: K = 1, 3 and 64 beams, n_keys not a multiple of the tile and
below the largest cluster, a rank whose keys are all masked (it drops out),
a fully masked row (a uniform average over its K*T slots). Then the cluster
that the wrapper picks (``cluster_size``: the largest that leaves each rank
a tile and keeps the grid within the blocks a call may launch, two an SM on
an H100) at every Whisper decode shape (the five head counts, cache phases
T_b 64-448, S = 1500 encoder rows, K = 1 and 5), each key in exactly one
share. The kernel against the plain versions on the card, at every Whisper
head count, is in ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.decode_attention as jdec
from coral_tpu_torch.ops import decode_attention as dec

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

H, D, L = 4, 64, 3
ATOL = 1e-5
P_ROUNDING, RTOL_BF16 = 2.0**-9, 2.0**-6
WARPS = 4  # the kernel block's consumer warps, each with 16 keys of every tile


def _np(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _walk(q, k, v, mask, n_heads, layer, C):
    """The kernel's schedule at cluster size C: q (B*K, HD); k, v (L, B, N,
    HD) (the self cache read as (L, B, K*T, HD)); mask (B, K, N) or None.
    fp32 out (B*K, HD)."""
    _, B, N, HD = k.shape
    K = q.shape[0] // B
    d = HD // n_heads
    tile = dec.TILE
    tiles = -(-N // tile)
    pad = tiles * tile - N
    qh = q.reshape(B, K, n_heads, d).float()
    kh = torch.nn.functional.pad(k[layer].float(), (0, 0, 0, pad)).reshape(B, -1, n_heads, d)
    vh = torch.nn.functional.pad(v[layer].float(), (0, 0, 0, pad)).reshape(B, -1, n_heads, d)
    ranks = []
    for share in dec.cluster_shares(N, C):
        # Each warp's own online softmax over its 16 keys of every tile.
        m = torch.full((WARPS, B, K, n_heads), -torch.inf)
        l = torch.zeros(WARPS, B, K, n_heads)
        acc = torch.zeros(WARPS, B, K, n_heads, d)
        for t0 in range(share.start, share.stop, tile):
            for w in range(WARPS):
                j0 = t0 + 16 * w
                keys = torch.arange(j0, j0 + 16)
                s = torch.einsum("bkhd,bjhd->bkhj", qh, kh[:, j0:j0 + 16]) * d**-0.5
                if mask is not None:
                    mk = torch.nn.functional.pad(mask, (0, pad), value=1.0)[:, :, keys]
                    s = torch.where(mk[:, :, None, :] > 0, s, dec._NEG)
                s = torch.where(keys < N, s, -torch.inf)
                m_new = torch.maximum(m[w], s.amax(-1))
                m_use = torch.where(m_new == -torch.inf, 0.0, m_new)  # padding alone
                alpha = torch.exp(m[w] - m_use)
                p = torch.exp(s - m_use[..., None])
                l[w] = l[w] * alpha + p.sum(-1)
                m[w] = m_new
                acc[w] = acc[w] * alpha[..., None] + torch.einsum(
                    "bkhj,bjhd->bkhd", p, vh[:, j0:j0 + 16])
        ranks.append(_combine(list(zip(m, l, acc))))
    return _finish(ranks).reshape(B * K, HD)


def _combine(parts):
    """(M, sum exp(m - M) l, sum exp(m - M) o) over (m, l, o) parts in order."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    lsum = torch.zeros_like(M)
    osum = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        w = torch.exp(m - M)
        lsum = lsum + w * l
        osum = osum + w[..., None] * o
    return M, lsum, osum


def _finish(ranks):
    """The cluster's combine in rank order, normalised."""
    _, lsum, osum = _combine(ranks)
    return osum / lsum[..., None]


def _onehot(B, K, T, pos, seed):
    """Query beam k of item b attends, at each position t <= pos, the slot of
    a random ancestor beam (K = 1: the causal mask)."""
    rng = np.random.default_rng(seed)
    onehot = np.zeros((B, K, K * T), np.float32)
    slots = rng.integers(K, size=(B, K, pos + 1)) * T + np.arange(pos + 1)
    np.put_along_axis(onehot, slots, 1.0, axis=2)
    return onehot


def _self_inputs(B, K, T, pos, seed=0):
    q = _np(B * K, H * D, seed=seed)
    ck = _np(L, B * K, T, H * D, seed=seed + 1)
    cv = _np(L, B * K, T, H * D, seed=seed + 2)
    return q, ck, cv, _onehot(B, K, T, pos, seed + 3)


def _clusters(n_keys):
    """Every cluster size the kernel takes for ``n_keys`` keys."""
    return [C for C in (1, 2, 4, 8) if C <= -(-n_keys // dec.TILE)]


def _self_refs(q, ck, cv, onehot, layer, dtype):
    """({C: walk}, JAX composition, plain version, v) of the self-attention,
    from numpy inputs cast to ``dtype`` (``"float32"`` or ``"bfloat16"``)."""
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, ck, cv))
    tm = torch.from_numpy(onehot)
    B, K, KT = onehot.shape
    walk = {C: _walk(tq, tk.reshape(L, B, KT, H * D), tv.reshape(L, B, KT, H * D), tm, H,
                     layer, C) for C in _clusters(KT)}
    jdt = getattr(jnp, dtype)
    jax_out = jdec.decode_self_attention(jnp.asarray(q, jdt), jnp.asarray(ck, jdt),
                                         jnp.asarray(cv, jdt), jnp.asarray(onehot), H,
                                         jnp.int32(layer), interpret=True)
    plain = dec.decode_self_attention(tq, tk, tv, tm, H, layer)
    return walk, np.asarray(jnp.asarray(jax_out, jnp.float32)), plain.float(), tv[layer]


def _cross_refs(q, k, v, layer, dtype):
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    walk = {C: _walk(tq, tk, tv, None, H, layer, C) for C in _clusters(k.shape[2])}
    jdt = getattr(jnp, dtype)
    jax_out = jdec.decode_cross_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                          jnp.asarray(v, jdt), H, jnp.int32(layer),
                                          interpret=True)
    plain = dec.decode_cross_attention(tq, tk, tv, H, layer)
    return walk, np.asarray(jnp.asarray(jax_out, jnp.float32)), plain.float(), tv[layer]


def _check(walks, jax_out, plain, v, dtype):
    """Every cluster size's walk against both references."""
    for walk in walks.values():
        if dtype == "float32":
            np.testing.assert_allclose(walk.numpy(), jax_out, atol=ATOL, rtol=0)
            np.testing.assert_allclose(walk.numpy(), plain.numpy(), atol=ATOL, rtol=0)
        else:  # the kernel rounds once, from fp32 p; the references round p first
            got = walk.to(torch.bfloat16).float().numpy()
            atol = P_ROUNDING * float(v.float().abs().max())
            np.testing.assert_allclose(got, jax_out, atol=atol, rtol=RTOL_BF16)
            np.testing.assert_allclose(got, plain.numpy(), atol=atol, rtol=RTOL_BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,B,T,pos", [(1, 2, 100, 70), (3, 2, 45, 30), (64, 1, 5, 4)],
                         ids=["K1", "K3", "K64"])
def test_self_walk_matches_jax_and_plain(K, B, T, pos, dtype):
    """K = 1 (greedy, 100 slots: two tiles, the second cut at 100), K = 3
    beams (135 keys: three tiles over two ranks, the last cut), K = 64 (320
    keys: five tiles over four ranks, one of them with two)."""
    q, ck, cv, onehot = _self_inputs(B, K, T, pos)
    _check(*_self_refs(q, ck, cv, onehot, 1, dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1, 2, 5])
@pytest.mark.parametrize("S", [1, 5, 100, 1500])
def test_cross_walk_matches_jax_and_plain(S, K, dtype):
    """S = 1 and 5 keys (below the largest cluster: one tile, C = 1 whatever
    the wave), 100 (two tiles) and Whisper's 1500 encoder rows (24 tiles over
    up to 8 ranks), shared by K beams."""
    B = 2
    q = _np(B * K, H * D, seed=10)
    k = _np(L, B, S, H * D, seed=11)
    v = _np(L, B, S, H * D, seed=12)
    if S < dec.MAX_CLUSTER:
        assert dec.cluster_size(S, 1, 10**6) == 1
    _check(*_cross_refs(q, k, v, 2, dtype), dtype)


def test_a_rank_whose_keys_are_all_masked_drops_out():
    """K = 1 over 256 slots (4 ranks of one tile at C = 4): every key of
    rank 1 masked, so its block has m = -1e30 and weight exp(-1e30 - M) = 0;
    at C = 1 and 2 its warps drop out the same way."""
    q, ck, cv, onehot = _self_inputs(2, 1, 256, 200)
    shares = dec.cluster_shares(256, 4)
    onehot[:, :, shares[1].start:shares[1].stop] = 0.0
    walks, jax_out, plain, v = _self_refs(q, ck, cv, onehot, 0, "float32")
    _check(walks, jax_out, plain, v, "float32")
    walk = walks[4]
    # The same as attending only the unmasked keys.
    keep = onehot[0, 0] > 0
    kh = ck[0, 0][keep].reshape(-1, H, D)
    vh = cv[0, 0][keep].reshape(-1, H, D)
    s = np.einsum("hd,jhd->hj", q[0].reshape(H, D), kh) * D**-0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("hj,jhd->hd", p / p.sum(-1, keepdims=True), vh).reshape(-1)
    np.testing.assert_allclose(walk[0].numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("K,T", [(1, 100), (3, 45)])
def test_a_fully_masked_row_averages_uniformly(K, T):
    """A (b, k) row with no key of onehot > 0 scores -1e30 everywhere: every
    rank has m = -1e30, weight 1, and the row is the mean of v over its K*T
    slots (padding past n_keys never counts)."""
    q, ck, cv, onehot = _self_inputs(2, K, T, T - 1)
    onehot[1, K - 1] = 0.0
    walks, jax_out, plain, v = _self_refs(q, ck, cv, onehot, 2, "float32")
    _check(walks, jax_out, plain, v, "float32")
    mean = cv[2].reshape(2, K * T, H * D)[1].mean(0)
    for walk in walks.values():
        np.testing.assert_allclose(walk[2 * K - 1].numpy(), mean, atol=ATOL, rtol=0)


# The blocks a call may launch on an H100 (132 SMs): one wave of either
# instantiation, at most two an SM (``wave_blocks``; the card tests hold the
# occupancy query to it).
WAVE_H100 = 2 * 132
WHISPER_HEADS = {"tiny": 6, "base": 8, "small": 12, "medium": 16, "large-v3": 20}
# Whisper's decode shapes, (items, K): greedy serving at batch 8, and K = 5
# beams at batch 2 (chip_smoke.py's); n_keys: the cache phases' K * T_b
# slots (T_b 64, 128, 256, 448; 225 is large-v3's last) and S = 1500.
WHISPER_SHAPES = [(name, 8 if K == 1 else 2, K, n_keys)
                  for name in WHISPER_HEADS for K in (1, 5)
                  for n_keys in [K * T for T in (64, 128, 225, 256, 448)] + [1500]]
# The cluster the wrapper picks for large-v3 (20 heads) on an H100.
LARGE_V3 = {(1, 64): 1, (1, 128): 1, (1, 225): 1, (1, 256): 1, (1, 448): 1, (1, 1500): 1,
            (5, 320): 4, (5, 640): 4, (5, 1125): 4, (5, 1280): 4, (5, 2240): 4, (5, 1500): 4}


@pytest.mark.parametrize("name,B,K,n_keys", WHISPER_SHAPES,
                         ids=[f"{n}-K{K}-{N}" for n, _, K, N in WHISPER_SHAPES])
def test_the_cluster_covers_every_key_once_at_whisper_shapes(name, B, K, n_keys):
    """C is the largest of 1, 2, 4, 8 that leaves each rank a whole tile and
    the grid within one wave; each rank takes whole tiles (only the row's
    last tile is cut), at least one, and the shares in rank order cover the
    keys exactly once."""
    items = B * WHISPER_HEADS[name] * -(-K // dec.GROUP)
    tiles = -(-n_keys // dec.TILE)
    C = dec.cluster_size(n_keys, items, WAVE_H100)
    assert C in (1, 2, 4, 8) and C <= tiles and (C == 1 or C * items <= WAVE_H100)
    assert 2 * C > min(dec.MAX_CLUSTER, tiles) or 2 * C * items > WAVE_H100
    if name == "large-v3":
        assert C == LARGE_V3[K, n_keys]
    shares = dec.cluster_shares(n_keys, C)
    assert len(shares) == C
    assert [key for share in shares for key in share] == list(range(n_keys))
    for share in shares:
        assert len(share) > 0 and share.start % dec.TILE == 0
        assert share.stop % dec.TILE == 0 or share.stop == n_keys
