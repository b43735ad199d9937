"""The feature-encoder conv block's Hopper design, walked in plain PyTorch on the CPU.

``csrc/conv_ln_gelu.cu`` runs K3's forward and backward on kernels that only a
card runs. The walks below do what those kernels do, in their order:

- forward (``conv_ln_gelu_kernel``): tap j's A operand as its strided view of
  x (input rows 2t + j), rows past T_out zero (the tap map's T_out rows),
  padded to whole 128-row tiles; the K loop in 64-deep chunks, chunk c being
  tap c // 8 and channel block c % 8, accumulated in fp32; + bias; each row's
  sum over the two 256-column halves (the cluster pair's blocks), added in
  rank order, then the centred squares the same way; xhat, rstd and y =
  gelu(xhat gamma + beta);
- the row kernel: dh, the LayerNorm backward's da rounded to the working
  dtype, and the dvec partial of each 8-row block (its warps' sums, each
  warp's rows in order) as the finish kernel adds them (warp w of a 32-column
  group takes partials w, w + 8, .., then the 8 warps in order);
- dx (``conv_bwd_dx_kernel``): tiles of 128 row pairs x 128 input channels;
  even rows 2s = da[s] W0 + da[s-1] W2 (k = 3), odd rows 2s+1 = da[s] W1, two
  accumulators over 64-deep chunks of the output channels; the halo box at
  row s0 - 1, zero at s0 = 0 and da[127] at the tile edge s0 = 128; every dx
  row no output reads is zero;
- dW (``conv_bwd_dw_kernel`` on ``gemm::atb``, then the finish kernel): the
  64-row chunks of each batch row split into ``dw_ranges`` ranges, each
  range's partial da^T x_j summed chunk by chunk, the partials added in range
  order into the (C_out, C_in, k) layout.

The walks are held against the JAX package's own function
(``coral_tpu.ops.conv_ln_gelu_pallas._conv_ln_gelu`` in interpret mode,
forward and ``jax.vjp``, as ``tests/test_torch_ops.py`` runs it) on fp32
inputs, and against the port's plain versions (``conv_ln_gelu_fwd_plain``,
``conv_ln_gelu_bwd_plain``) on bf16 inputs. C = 512, the kernel's width; k =
2 and 3; B = 2; T_out at 63, 64, 65, 127, 128 and 129 around the 64- and
128-row tiles, each from an odd and an even T_in.

Tolerances, from the order of the sums alone (the arithmetic is the same),
each a few times the largest error measured over these cases: fp32 against
JAX, y, xhat and dx within 2e-5 (the bound the JAX package's own op tests
use; chunked sums of up to 1536 products of order 1, rounding at 2**-24 each;
measured 3.8e-6 and 3.1e-6), rstd within 1e-6 relative (measured 2.0e-7), and
the gradients summed over rows (dW, dbias, dgamma, dbeta) within 1e-5 of
their largest value (sums over up to 258 rows in another order; measured
7.7e-7); bf16 against the plain versions, rounded outputs (y, xhat, dx)
within one bf16 ulp of the value (2**-7 relative: an fp32 sum in another order
can move a rounding by one ulp) plus 1e-6, rstd within 1e-6 relative
(measured 2.3e-7), dW and dvec (fp32) within 1e-5 of their largest value
(measured 4.2e-7). The kernels against these
plain versions are in ``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.conv_ln_gelu_pallas as jcg
from coral_tpu_torch.ops import conv_ln_gelu
from coral_tpu_torch.ops.gelu_poly import _dgelu, gelu_poly

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

C = 512         # the kernel's channels
CHUNK = 64      # a stage's K depth
ROWS = 128      # the forward's row tile (a cluster pair's 128 rows)
HALF = 256      # a block's columns of the pair
PAIRS = 128     # dx's row pairs a tile
DX_COLS = 128   # dx's input channels a tile
ROW_WARPS = 8   # the row kernel's rows a block
EPS = 1e-5
BF16_ULP = 2.0**-7

# (k, T_in): T_out = (T_in - k) // 2 + 1 at 63, 64, 65, 127, 128, 129, each
# from an odd and an even T_in.
CASES = [(k, 2 * (t - 1) + k + extra) for k in (3, 2) for t in (63, 64, 65, 127, 128, 129)
         for extra in (0, 1)]


def _np(*shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(
        np.float32
    )


def _inputs(k, T_in, B=2, seed=0):
    """x, w in the Conv1d layout (C_out, C_in, k), b, gamma, beta; dy."""
    T_out = (T_in - k) // 2 + 1
    x = _np(B, T_in, C, seed=seed)
    w = _np(C, C, k, seed=seed + 1, scale=0.05)
    b = _np(C, seed=seed + 2, scale=0.1)
    gamma = _np(C, seed=seed + 3, scale=0.1, offset=1.0)
    beta = _np(C, seed=seed + 4, scale=0.1)
    dy = _np(B, T_out, C, seed=seed + 5)
    return x, w, b, gamma, beta, dy


def _taps(x, k, T_out, rows):
    """Each tap's A operand: input rows 2t + j for t < T_out, zero past T_out
    up to ``rows`` (the tap map's zeros)."""
    B = x.shape[0]
    out = []
    for j in range(k):
        a = torch.zeros((B, rows, C), dtype=torch.float32)
        a[:, :T_out] = x[:, j::2][:, :T_out].float()
        out.append(a)
    return out


def _fwd_walk(x, w, b, gamma, beta):
    """``conv_ln_gelu_kernel``'s schedule: (y, xhat, rstd) in fp32."""
    B, T_in, _ = x.shape
    k = w.shape[-1]
    T_out = (T_in - k) // 2 + 1
    rows = -(-T_out // ROWS) * ROWS
    wk = w.float().permute(0, 2, 1).reshape(C, k * C)  # the (C_out, k C_in) K-major weight
    taps = _taps(x, k, T_out, rows)
    acc = torch.zeros((B, rows, C), dtype=torch.float32)
    for c in range(k * C // CHUNK):
        j, h = divmod(c, C // CHUNK)
        acc += taps[j][..., h * CHUNK:(h + 1) * CHUNK] @ wk[:, c * CHUNK:(c + 1) * CHUNK].t()
    assert not acc[:, T_out:].any()  # rows past T_out: zeros in, nothing stored
    acc = acc + b.float()
    lo, hi = acc[..., :HALF], acc[..., HALF:]
    mean = (lo.sum(-1) + hi.sum(-1)) / C  # rank 0's half, then rank 1's
    cen = acc - mean[..., None]
    q = (cen[..., :HALF] ** 2).sum(-1) + (cen[..., HALF:] ** 2).sum(-1)
    rstd = torch.rsqrt(q / C + EPS)
    xhat = cen * rstd[..., None]
    y = gelu_poly(xhat * gamma.float() + beta.float())
    return y[:, :T_out], xhat[:, :T_out], rstd[:, :T_out]


def _rows_walk(xhat, rstd, dy, gamma, beta, dtype):
    """The row kernel and dvec's finish: (da rounded to dtype, dvec)."""
    B, T_out, _ = dy.shape
    xh, g = xhat.float(), gamma.float()
    dh = dy.float() * _dgelu(xh * g + beta.float())
    dn = dh * g
    da = (dn - dn.mean(-1, keepdim=True) - xh * (dn * xh).mean(-1, keepdim=True)) * rstd[..., None]
    vals = torch.stack([dh * xh, dh, da], dim=2).reshape(B * T_out, 3, C)  # a row's terms
    rows = B * T_out
    blocks, _ = conv_ln_gelu.bwd_partials(B, T_out, 2)
    stride = blocks * ROW_WARPS
    parts = torch.zeros((blocks, 3, C))
    for p in range(blocks):
        for w in range(ROW_WARPS):  # the block's warps in order, each its rows in order
            warp = torch.zeros((3, C))
            for r in range(p * ROW_WARPS + w, rows, stride):
                warp += vals[r]
            parts[p] += warp
    finish = torch.zeros((ROW_WARPS, 3, C))
    for w in range(ROW_WARPS):
        for p in range(w, blocks, ROW_WARPS):
            finish[w] += parts[p]
    dvec = torch.zeros((3, C))
    for w in range(ROW_WARPS):
        dvec += finish[w]
    return da.to(dtype), dvec


def _dx_walk(da, w, T_in):
    """``conv_bwd_dx_kernel``'s tiles: dx in fp32, every input row."""
    B, T_out, _ = da.shape
    k = w.shape[-1]
    wf = w.float()
    pairs = (T_in + 1) // 2
    tiles = -(-pairs // PAIRS)
    dap = torch.zeros((B, tiles * PAIRS + 1, C))  # index s + 1 holds da[s]; da[-1] = 0
    dap[:, 1:T_out + 1] = da.float()
    dx = torch.zeros((B, 2 * tiles * PAIRS, C))
    for pt in range(tiles):
        s0 = pt * PAIRS
        a0, a1 = dap[:, s0 + 1:s0 + 1 + PAIRS], dap[:, s0:s0 + PAIRS]  # rows s0 .., s0 - 1 ..
        if k == 3 and s0 == 0:
            assert not a1[:, 0].any()  # the halo row at s0 = 0: TMA's zeros at row -1
        if k == 3 and s0 == PAIRS and T_out > PAIRS:
            assert torch.equal(a1[:, 0], da[:, PAIRS - 1].float())  # the tile edge's halo
        for n0 in range(0, C, DX_COLS):
            cols = slice(n0, n0 + DX_COLS)
            ev = torch.zeros((B, PAIRS, DX_COLS))
            od = torch.zeros((B, PAIRS, DX_COLS))
            for c in range(C // CHUNK):
                ks = slice(c * CHUNK, (c + 1) * CHUNK)
                ev += a0[..., ks] @ wf[ks, cols, 0]
                od += a0[..., ks] @ wf[ks, cols, 1]
                if k == 3:
                    ev += a1[..., ks] @ wf[ks, cols, 2]
            dx[:, 2 * s0:2 * (s0 + PAIRS):2, cols] = ev
            dx[:, 2 * s0 + 1:2 * (s0 + PAIRS):2, cols] = od
    dx = dx[:, :T_in]
    read = 2 * (T_out - 1) + k
    assert not dx[:, read:].any()  # input rows no output reads
    return dx


def _dw_walk(x, da, k):
    """dW's row ranges and the finish: (C_out, C_in, k) fp32."""
    B, T_out, _ = da.shape
    R = conv_ln_gelu.dw_ranges(B, T_out, k)
    per_b = -(-T_out // CHUNK)
    n = B * per_b
    rows = per_b * CHUNK
    taps = _taps(x, k, T_out, rows)
    dap = torch.zeros((B, rows, C))
    dap[:, :T_out] = da.float()
    parts = torch.zeros((R, k, C, C))
    for r in range(R):
        for i in range(r * n // R, (r + 1) * n // R):
            b, t0 = divmod(i, per_b)
            ts = slice(t0 * CHUNK, (t0 + 1) * CHUNK)
            for j in range(k):
                parts[r, j] += dap[b, ts].t() @ taps[j][b, ts]
    dw = torch.zeros((C, C, k))
    for r in range(R):  # the finish: range order
        dw += parts[r].permute(1, 2, 0)
    return dw


def _bwd_walk(x, w, gamma, beta, xhat, rstd, dy):
    """The backward's four kernels: (dx, dw, dvec)."""
    da, dvec = _rows_walk(xhat, rstd, dy, gamma, beta, x.dtype)
    k = w.shape[-1]
    wk = w.to(x.dtype)
    return _dx_walk(da, wk, x.shape[1]).to(x.dtype), _dw_walk(x, da, k), dvec


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _close_sum(got, want, frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=frac * np.abs(want).max())


def test_cases_cover_the_tile_edges():
    outs = sorted({(k, (t - k) // 2 + 1) for k, t in CASES})
    assert outs == [(k, t) for k in (2, 3) for t in (63, 64, 65, 127, 128, 129)]
    assert {t % 2 for _, t in CASES} == {0, 1}


@pytest.mark.parametrize("k,T_in", CASES)
def test_forward_walk_matches_jax_interpret(k, T_in):
    x, w, b, gamma, beta, _ = _inputs(k, T_in)
    jw = jnp.asarray(w.transpose(2, 1, 0))  # JAX layout (k, C_in, C_out)
    want = jcg._fwd_pallas(jnp.asarray(x), jw, *map(jnp.asarray, (b, gamma, beta)), k, EPS,
                           True)
    got = _fwd_walk(*map(torch.from_numpy, (x, w, b, gamma, beta)))
    _close(got[0], want[0], 2e-5)
    _close(got[1], want[1], 2e-5)
    _close(got[2], np.asarray(want[2]).reshape(got[2].shape), 0.0, rtol=1e-6)


@pytest.mark.parametrize("k,T_in", CASES)
def test_backward_walk_matches_jax_vjp(k, T_in):
    x, w, b, gamma, beta, dy = _inputs(k, T_in)
    jargs = (jnp.asarray(x), jnp.asarray(w.transpose(2, 1, 0)),
             *map(jnp.asarray, (b, gamma, beta)))
    _, vjp = jax.vjp(lambda *a: jcg._conv_ln_gelu(*a, k, EPS, True), *jargs)
    jdx, jdw, jdb, jdg, jdbeta = vjp(jnp.asarray(dy))
    t = {n: torch.from_numpy(a) for n, a in zip("x w b g be dy".split(),
                                                 (x, w, b, gamma, beta, dy))}
    _, xhat, rstd = _fwd_walk(t["x"], t["w"], t["b"], t["g"], t["be"])
    dx, dw, dvec = _bwd_walk(t["x"], t["w"], t["g"], t["be"], xhat, rstd, t["dy"])
    _close(dx, jdx, 2e-5)
    _close_sum(dw, np.asarray(jdw).transpose(2, 1, 0), 1e-5)
    for got, want in zip(dvec, (jdg, jdbeta, jdb)):
        _close_sum(got, want, 1e-5)


@pytest.mark.parametrize("k,T_in", CASES)
def test_walk_matches_plain_versions_in_bf16(k, T_in):
    x, w, b, gamma, beta, dy = (torch.from_numpy(a) for a in _inputs(k, T_in, seed=k + T_in))
    x, dy = x.bfloat16(), dy.bfloat16()
    wb = w.bfloat16()
    y, xhat, rstd = _fwd_walk(x, wb, b, gamma, beta)
    want = conv_ln_gelu.conv_ln_gelu_fwd_plain(x, wb, b, gamma, beta)
    for got, ref in zip((y, xhat), want[:2]):
        ref = ref.float()
        _close(got.bfloat16().float(), ref, 1e-6, rtol=BF16_ULP)
    _close(rstd, want[2], 0.0, rtol=1e-6)
    xhat, rstd = want[1], want[2]  # the residuals the backward gets
    got = _bwd_walk(x, wb, gamma, beta, xhat, rstd, dy)
    ref = conv_ln_gelu.conv_ln_gelu_bwd_plain(x, wb, gamma, beta, xhat, rstd, dy)
    assert got[0].dtype == ref[0].dtype == torch.bfloat16
    _close(got[0].float(), ref[0].float(), 1e-6, rtol=BF16_ULP)
    _close_sum(got[1], ref[1], 1e-5)
    for g, r in zip(got[2], ref[2]):
        _close_sum(g, r, 1e-5)


@pytest.mark.parametrize("B,T_out,k,R", [(8, 15999, 3, 11), (8, 15999, 2, 16), (8, 999, 2, 16),
                                         (2, 63, 3, 2), (1, 64, 2, 1), (1, 65, 3, 2)])
def test_dw_ranges_come_from_the_shape(B, T_out, k, R):
    """At most 528 dW blocks (16 tiles x k taps x R), never more ranges than
    64-row chunks: FE block 1 at 8 x 10 s takes 11 ranges (528 blocks)."""
    assert conv_ln_gelu.dw_ranges(B, T_out, k) == R
    assert 16 * k * R <= 528
    assert R <= B * -(-T_out // 64)
