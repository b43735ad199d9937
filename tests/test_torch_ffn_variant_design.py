"""The N7 and N6 dW kernels' Hopper design, walked in plain PyTorch on the CPU.

``csrc/ffn_ln_fc2.cu`` (N7) and ``csrc/ffn_ln_g.cu``'s dW kernel (N6) run only
on a card. The walks below do what those kernels do, in their order:

- N7's partition (``cluster_size``, ``ffn.ffn_fc2_cluster``): a cluster of C
  blocks shares a 128-row tile; block r computes the h tiles r, r + C, .. (one
  a round) and owns y's columns [r NY, (r+1) NY), NY = D / C. Its ring
  iterations, round by round: the h tile's D / 64 chunks if it has one, then
  two 64-deep W2 chunks for each tile of the round, its peers in rank order
  from its own rank on (``Sched::peer``: no two blocks read one peer's g at
  once); the producer joins round j's cluster barrier before the copy that
  needs a stage freed after it.
  For every built width and its C, at F = 4 D and at the card tests' F =
  512, every F tile is computed by exactly one block and every y column is
  owned by exactly one.
- N7's y: the LayerNorm of each row once (rounded to the working dtype,
  the cluster's scratch), each h tile over its 64-deep chunks, + b1, GELU,
  the kernel's Philox mask and 1/keep, g rounded once; then, round by round
  and the round's peers in the block's order, y += g_q W2[own columns, tile
  of q]^T over the g tile's two 64-deep halves, in fp32; + b2, rounded
  once. Rows past M load as zeros and are never stored.
- N6's dW (``gemm::atb`` tiles, then the finish): the ``ceil(M / 64)``
  64-row chunks split into ``ffn.ffn_dw_ranges`` ranges, each range's
  partial dh^T ln_out and dy^T g summed chunk by chunk, the partials added
  in range order. The ranges cover every chunk exactly once, and R = 1
  where the tiles alone fill the card (D = 768 to 1920 at F = 4 D).

The walks are held against the JAX package's own functions in interpret
mode, as ``tests/test_torch_ffn_block_variants.py`` runs them: N7's y against
``coral_tpu.ops.ffn_pallas._ffn_ln_block_fc2``, N6's dW1 and dW2 against
``jax.vjp`` of ``_ffn_ln_block_dw``, on fp32 inputs; and against the port's
plain versions (``ffn_ln_fc2_fwd_plain``, ``ffn_dw_plain`` on
``ffn_ln_g_bwd_plain``'s g, dh and ln_out) on bf16 inputs, at rates 0 and 0.1.
D = 128 and 256, F = 4 D, M = 63, 64, 127, 128, 129 and 2 x 37 rows.

Tolerances, from the order of the sums alone (the arithmetic is the same):
fp32 against JAX, y within ``2e-5 + 1e-5 |y|`` (chunked sums of up to 1024
products of order 1 for fc2 and 256 for fc1, rounding at 2**-24 each, as
``tests/test_torch_ffn_design.py`` holds the mainloop) and dW1, dW2 (sums over
up to 129 rows in another order) within 1e-5 of their largest value. bf16
against the plain versions: y within one bf16 ulp of the value (2**-7
relative) plus 2**-9 of max|y|: a g that rounds one ulp apart (fc1's chunked
fp32 sum against one product) moves one term of y's sum by 2**-8 of itself;
dW1 and dW2 on the same bf16 operands within 1e-5 of their largest value
(fp32 sums over rows in another order). The kernels against these plain
versions are in ``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.ffn_pallas as jffn
from coral_tpu_torch.ops import ffn, philox
from coral_tpu_torch.ops.gelu_poly import gelu_poly
from test_torch_ffn_design import _keep_bits

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

ROWS = 128   # a cluster's row tile
TILE = 128   # an h tile's columns
CHUNK = 64   # a stage's K depth; dW's rows a chunk
STAGES = 4   # N7's ring
EPS = 1e-5
BF16_ULP = 2.0**-7
# (B, T): M around the 128-row tile, and two batch rows of a ragged length.
SHAPES = [(1, 63), (1, 64), (1, 127), (1, 128), (1, 129), (2, 37)]
# The walks' widths and cluster sizes: NY = D / C a multiple of 32.
WALKS = [(128, 2), (128, 4), (256, 2), (256, 8)]


def _np(*shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(
        np.float32
    )


def _inputs(D, B, T, dtype, seed=0):
    """x (B, T, D), W1 (F, D), b1, gamma, beta, W2 (D, F), b2, dy (B, T, D)
    in the port's layout, F = 4 D; the matrices in ``dtype``."""
    F = 4 * D
    t = [_np(B, T, D, seed=seed, offset=0.3), _np(F, D, seed=seed + 1, scale=D**-0.5),
         _np(F, seed=seed + 2, scale=0.1), _np(D, seed=seed + 3, scale=0.1, offset=1.0),
         _np(D, seed=seed + 4, scale=0.1), _np(D, F, seed=seed + 5, scale=F**-0.5),
         _np(D, seed=seed + 6, scale=0.1), _np(B, T, D, seed=seed + 7)]
    out = [torch.from_numpy(a) for a in t]
    for i in (0, 1, 5, 7):
        out[i] = out[i].to(dtype)
    return out


def _schedule(C, n_tiles, n_k1):
    """Each block's ring iterations as ``Sched`` in csrc/ffn_ln_fc2.cu lays
    them out: a list of (round, "fc1", tile, chunk) and (round, "fc2", tile,
    half), and each round's first fc2 iteration."""
    rounds = -(-n_tiles // C)
    blocks = []
    for r in range(C):
        its, fc2_start = [], []
        for j in range(rounds):
            if r + C * j < n_tiles:
                its += [(j, "fc1", r + C * j, k) for k in range(n_k1)]
            fc2_start.append(len(its))
            peers = min(C, n_tiles - C * j)
            for k in range(peers):
                its += [(j, "fc2", (r + k) % peers + C * j, h) for h in range(2)]
        # The kernel's closed forms: start(j) = j (n_k1 + 2 C), every round but
        # the last whole.
        full = n_k1 + 2 * C
        own = [r + C * j < n_tiles for j in range(rounds)]
        assert fc2_start == [j * full + (n_k1 if own[j] else 0) for j in range(rounds)]
        assert len(its) == fc2_start[-1] + 2 * min(C, n_tiles - C * (rounds - 1))
        blocks.append((its, fc2_start))
    return blocks


@pytest.mark.parametrize("F_of", [lambda D: 4 * D, lambda D: 512], ids=["F4D", "F512"])
@pytest.mark.parametrize("D", ffn.KERNEL_D)
def test_n7_partition_covers_every_tile_and_column_once(D, F_of):
    """Every built width at its C: each F tile's h is computed by exactly one
    block, each block sums every tile into y (both halves, rounds in order),
    no two blocks read one peer's tile at the same position of a round, the
    y columns are owned once each, and each round's
    cluster barrier comes before any copy that needs a stage freed after it
    while all the copies before the barrier are issued by then."""
    F = F_of(D)
    C = ffn.ffn_fc2_cluster(D)
    NY = D // C
    assert C * NY == D and NY % 32 == 0 and NY <= 256 and C <= 16
    n_tiles = F // TILE
    blocks = _schedule(C, n_tiles, D // CHUNK)
    computed = [t for its, _ in blocks for (_, kind, t, k) in its if kind == "fc1" and k == 0]
    assert sorted(computed) == list(range(n_tiles))
    for its, fc2_start in blocks:
        fc2 = [(j, t, h) for (j, kind, t, h) in its if kind == "fc2"]
        assert [j for j, _, _ in fc2] == sorted(j for j, _, _ in fc2)
        assert sorted((t, h) for _, t, h in fc2) == [
            (t, h) for t in range(n_tiles) for h in range(2)]
        # The producer joins barrier j before copying iteration fc2_start[j] +
        # STAGES (which needs the stage of fc2_start[j], consumed after the
        # barrier); every iteration the consumers need before the barrier
        # (rounds before j, round j's fc1) comes before fc2_start[j].
        joins = [s + STAGES for s in fc2_start]
        assert joins == sorted(joins)
        for j, s in enumerate(fc2_start):
            before = [i for i, (jj, kind, _, _) in enumerate(its)
                      if jj < j or (jj == j and kind == "fc1")]
            assert before == list(range(s))
    for j in range(-(-n_tiles // C)):  # at each position of a round, the blocks' peers differ
        order = [[t for (jj, kind, t, h) in its if kind == "fc2" and jj == j and h == 0]
                 for its, _ in blocks]
        for k in range(len(order[0])):
            assert len({o[k] for o in order}) == min(C, n_tiles - C * j)
    owners = torch.zeros(D, dtype=torch.int64)
    for r in range(C):
        owners[r * NY:(r + 1) * NY] += 1
    assert (owners == 1).all()


def _ln_chunks(x2, gamma, beta, dt):
    """The row statistics once, then each 64-deep chunk of x normalised with
    the chunk's gamma and beta and rounded to dt (gemm::normalise)."""
    x32 = x2.float()
    mean = x32.mean(dim=-1, keepdim=True)
    cen = x32 - mean
    rstd = torch.rsqrt((cen * cen).mean(dim=-1, keepdim=True) + EPS)

    def chunk(k0):
        xc = x32[:, k0:k0 + CHUNK]
        return (((xc - mean) * rstd) * gamma[k0:k0 + CHUNK].float()
                + beta[k0:k0 + CHUNK].float()).to(dt).float()

    return chunk


def _fc2_walk(x, w1, b1, gamma, beta, w2, b2, C, rate=0.0, seeds=None):
    """N7's cluster walked: y (B, T, D) in x.dtype."""
    dt = x.dtype
    B, T, D = x.shape
    F = w1.shape[0]
    M = B * T
    Mp = -(-M // ROWS) * ROWS
    NY, n_tiles = D // C, F // TILE
    x2 = torch.zeros(Mp, D, dtype=dt)
    x2[:M] = x.reshape(M, D)  # the tensor map's zeros past M
    chunk = _ln_chunks(x2, gamma, beta, dt)
    keep = None
    if rate:
        keep = torch.ones(Mp, F, dtype=torch.bool)
        keep[:M] = _keep_bits(seeds, T, M, F, philox.threshold(rate))
    ys = [torch.zeros(Mp, NY) for _ in range(C)]
    for j in range(-(-n_tiles // C)):
        tiles = [q + C * j for q in range(C) if q + C * j < n_tiles]
        g = {}
        for t in tiles:  # fc1 of block t % C: h over 64-deep chunks of D
            cols = slice(t * TILE, (t + 1) * TILE)
            h = None
            for k0 in range(0, D, CHUNK):
                part = chunk(k0) @ w1[cols, k0:k0 + CHUNK].float().t()
                h = part if h is None else h + part
            v = gelu_poly(h + b1[cols].float())
            if rate:
                v = torch.where(keep[:, cols], v * (1.0 / (1.0 - rate)), 0.0)
            g[t] = v.to(dt).float()
        for r in range(C):  # fc2: the round's tiles from rank r on, two halves each
            own = slice(r * NY, (r + 1) * NY)
            for k in range(len(tiles)):
                t = tiles[(r + k) % len(tiles)]
                for half in range(2):
                    k = slice(t * TILE + half * CHUNK, t * TILE + (half + 1) * CHUNK)
                    ys[r] += g[t][:, half * CHUNK:(half + 1) * CHUNK] @ w2[own, k].float().t()
    y = torch.cat(ys, dim=1) + b2.float()
    return y[:M].to(dt).view(B, T, D)


def _dw_walk(dh, ln_out, dy, g):
    """N6's dW walked: the 64-row chunks split into ``ffn_dw_ranges``
    ranges, each range's partials summed chunk by chunk, then the partials in
    range order. Returns (dW1 (F, D), dW2 (D, F)) fp32 and the ranges."""
    M, F = dh.shape
    D = ln_out.shape[1]
    n = -(-M // CHUNK)
    R = ffn.ffn_dw_ranges(M, D, F)
    ranges = [range(r * n // R, (r + 1) * n // R) for r in range(R)]
    out = [torch.zeros(F, D), torch.zeros(D, F)]
    for rng in ranges:
        part = [torch.zeros(F, D), torch.zeros(D, F)]
        for c in rng:
            rows = slice(c * CHUNK, (c + 1) * CHUNK)  # rows past M: none in the slice
            part[0] += dh[rows].float().t() @ ln_out[rows].float()
            part[1] += dy[rows].float().t() @ g[rows].float()
        out = [o + p for o, p in zip(out, part)]
    return out[0], out[1], ranges


@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("D,C", WALKS)
def test_n7_walk_matches_the_jax_fc2_block(D, C, B, T):
    """fp32: y of the walked cluster against ``_ffn_ln_block_fc2`` (LayerNorm,
    fc1, GELU and fc2 in one Pallas kernel, interpret mode) at rate 0."""
    x, w1, b1, gamma, beta, w2, b2, _ = _inputs(D, B, T, torch.float32, seed=D + T)
    args = [jnp.asarray(a.numpy()) for a in (x, w1.t(), b1, gamma, beta, w2.t(), b2)]
    want = jffn._ffn_ln_block_fc2(*args, None, 0.0, EPS, True)
    got = _fc2_walk(x, w1, b1, gamma, beta, w2, b2, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("D,C", WALKS)
def test_n7_walk_matches_the_plain_version(D, C, B, T, rate):
    """bf16: the walked cluster against ``ffn_ln_fc2_fwd_plain``; at rate 0.1
    the threads' Philox draws are ``keep_mask``'s, so both drop the same g."""
    x, w1, b1, gamma, beta, w2, b2, _ = _inputs(D, B, T, torch.bfloat16, seed=T)
    seeds = torch.tensor([20231, -5][:B], dtype=torch.int32) if rate else None
    got = _fc2_walk(x, w1, b1, gamma, beta, w2, b2, C, rate, seeds).float()
    want = ffn.ffn_ln_fc2_fwd_plain(x, w1, b1, gamma, beta, w2, b2, rate=rate,
                                    seeds=seeds).float()
    bound = 2.0**-9 * want.abs().max() + BF16_ULP * want.abs()
    assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("D", [128, 256])
def test_n6_dw_walk_matches_the_jax_dw_block(D, B, T):
    """fp32: dW1 and dW2 of the walked ranges (on the plain pass's dh, g and
    ln_out from dg = dy W2^T, as the JAX backward forms it) against
    ``jax.vjp`` of ``_ffn_ln_block_dw`` (interpret mode) at rate 0."""
    x, w1, b1, gamma, beta, w2, b2, dy = _inputs(D, B, T, torch.float32, seed=D + T)
    args = [jnp.asarray(a.numpy()) for a in (x, w1.t(), b1, gamma, beta, w2.t(), b2)]
    _, vjp = jax.vjp(lambda *a: jffn._ffn_ln_block_dw(*a, None, 0.0, EPS, True), *args)
    want = vjp(jnp.asarray(dy.numpy()))
    dg = dy @ w2
    g, dh, ln_out, *_ = ffn.ffn_ln_g_bwd_plain(x, w1, b1, gamma, beta, dg)
    M = B * T
    dw1, dw2, _ = _dw_walk(dh.reshape(M, -1), ln_out.reshape(M, D), dy.reshape(M, D),
                           g.reshape(M, -1))
    for got, w in ((dw1, np.asarray(want[1]).T), (dw2, np.asarray(want[5]).T)):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0.0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("D", [128, 256])
def test_n6_dw_walk_matches_the_plain_products(D, B, T, rate):
    """bf16: the walked ranges against ``ffn_dw_plain`` on the same g, dh and
    ln_out (N5's pass in plain ops); the ranges cover every 64-row chunk once,
    in order, at least one chunk each."""
    x, w1, b1, gamma, beta, w2, _, dy = _inputs(D, B, T, torch.bfloat16, seed=T)
    seeds = torch.tensor([20231, -5][:B], dtype=torch.int32) if rate else None
    dg = (dy.float() @ w2.float()).to(torch.bfloat16)
    g, dh, ln_out, *_ = ffn.ffn_ln_g_bwd_plain(x, w1, b1, gamma, beta, dg, rate=rate,
                                               seeds=seeds)
    M = B * T
    dw1, dw2, ranges = _dw_walk(dh.reshape(M, -1), ln_out.reshape(M, D), dy.reshape(M, D),
                                g.reshape(M, -1))
    assert [c for rng in ranges for c in rng] == list(range(-(-M // CHUNK)))
    assert all(len(rng) > 0 for rng in ranges)
    for got, want in zip((dw1, dw2), ffn.ffn_dw_plain(dh, ln_out, dy, g)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=1e-5 * want.abs().max().item(), rtol=0.0)


def test_n6_ranges_depend_on_the_shape_alone():
    """R = 1 where the 2 (F / 256) (D / 128) tiles fill the card (D 768 to
    1920 at F = 4 D, the main paths' widths 1024 and 1280 among them), more
    ranges below, never more than the chunks, the same R for the same shape."""
    for D in ffn.KERNEL_D:
        F = 4 * D
        tiles = 2 * (F // ffn._DW_TILE_F) * (D // 128)
        for M in (1, 63, 64, 129, 8 * 499, 8 * 1500):
            R = ffn.ffn_dw_ranges(M, D, F)
            assert 1 <= R <= -(-M // CHUNK) and R * tiles <= max(tiles, ffn._DW_BLOCKS)
            assert R == ffn.ffn_dw_ranges(M, D, F)
            assert (R == 1) == (D >= 768 or M <= CHUNK)
    assert ffn.ffn_dw_ranges(8 * 1500, 384, 1536) == 528 // 36
