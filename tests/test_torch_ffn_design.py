"""The FFN up-projection kernels' Hopper design, walked in plain PyTorch on the CPU.

``csrc/ffn_gemm.cuh`` runs K5's forward and backward and N1-N5 (and dl =
dh W1 of every backward) on one mainloop that only a card runs. ``_walk``
below does what its kernels do, in the kernels' order:

- the row-statistics pre-pass: each row's mean and rstd in fp32, two-pass
  (``_ln_rows``), once per block of 128 rows;
- the K loop in 64-deep chunks: each chunk of x normalised with the chunk's
  gamma and beta and rounded to the working dtype on its own (kLn; without
  it the chunk of x as it is), rows past M zero (the tensor map's zeros),
  and the products accumulated in fp32 chunk by chunk: h = A W1^T, and
  beside it dg = dy W2^T over the same chunks of D (kDgIn; without it dg is
  read in);
- the epilogue: + b1, the polynomial GELU, the dropout mask of each
  (row, column) from Philox as the kernel's threads draw it (a quad's two
  pairs of threads each make one call, for row r or r + 8, and swap half of
  the words), g and dh rounded once;
- the db1 partial of each 128-row tile in the kernel's fixed order: a
  thread's two rows (r and r + 8), the warp's 8 row pairs by a butterfly,
  then the 8 consumer warps in order;
- dl = dh W1 over K = F in 64-deep chunks, in fp32.

The bias-only policy (``ln_dense``'s forward, ``csrc/ln_dense.cu``) is walked
too (``_walk_ln_dense``): the same LayerNorm chunks, column tiles of 256
rounded up (W's rows past F zero), any number of tiles a block with a row's
last block taking the rest, + b and one rounding, nothing stored past F;
held against ``_fwd_pallas_lnmm`` in interpret mode (fp32, D 128, F 384: the
half tile of F = 5760) and ``ln_dense_plain`` (bf16), at the tolerances
below.

The walk is held against the JAX package's own function
(``coral_tpu.ops.ffn_pallas.ffn_ln_block`` with ``interpret=True,
dg_in_kernel=True``, forward and VJP, as ``tests/test_torch_ops.py`` runs
it) at rate 0 on fp32 inputs, D 384 and F 1536, rows 75 and 130 (ragged at
the 128-row tile), and against the port's plain versions
(``ffn_ln_fc1_plain``, ``ffn_bwd_plain``, ``ffn_ln_g_bwd_plain``,
``ffn_ln_fc1_bwd_plain``, ``ffn_fc1_plain``, ``ffn_fc1_bwd_plain``) on bf16
inputs, kLn and kDgIn on and off, rates 0 and 0.1, at D 384 (F 1536) and at
one small row count at D 1920 (F 7680). At rate 0.1 the mask obeys the
dropout laws: it is ``philox.keep_mask`` bit for bit, the same forward and
backward, kept values are the rate-0 values times 1 / (1 - rate), and the
keep fraction is 0.9.

Tolerances, from the order of the sums alone (the arithmetic is the same):
fp32 against JAX, values within ``2e-5 + 1e-5 |value|`` (chunked sums of up to
1536 products of order 1, rounding at 2**-24 each) and the gradients summed
over rows (dW1, dW2, db1, db2, dgamma, dbeta) within 1e-4 of their largest
value; bf16 against the plain versions, rounded outputs (g, dh, dx) within
one bf16 ulp of the value (2**-7 relative: an fp32 sum in another order can
move a rounding by one ulp) plus 1e-6, ln_out bit for bit (the same
elementwise arithmetic), the fp32 results (dl's rows, db1, dgamma, dbeta)
within 1e-4 of their largest value, and dx within 2e-4 of its largest
value plus one ulp: a dh that rounds one ulp apart moves a term of its
row's dl by 2**-8 of itself, and through the LayerNorm backward every dx of
the row by about as much, however small that dx is (measured: at most 7.7e-5
of max|dx| over these cases). The kernels against these plain versions are
in ``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.ffn_pallas as jffn
from coral_tpu_torch.ops import ffn, philox
from coral_tpu_torch.ops.gelu_poly import _dgelu, gelu_poly

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

ROWS = 128   # a block's row tile (two consumer warpgroups of 64)
CHUNK = 64   # a stage's K depth
WARPS = 8    # the block's consumer warps, 16 rows each
EPS = 1e-5
BF16_ULP = 2.0**-7
DX_FRAC = 2e-4  # of max|dx|: a dh one ulp apart moves its row's dl and dx


def _np(*shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(
        np.float32
    )


def _inputs(D, F, rows, dtype, seed=0):
    """x (1, rows, D), W1 (F, D), b1, gamma, beta, W2 (D, F), b2, dy, dg in
    the port's layout; the matrices in ``dtype``."""
    t = [_np(1, rows, D, seed=seed, offset=0.3), _np(F, D, seed=seed + 1, scale=D**-0.5),
         _np(F, seed=seed + 2, scale=0.1), _np(D, seed=seed + 3, scale=0.1, offset=1.0),
         _np(D, seed=seed + 4, scale=0.1), _np(D, F, seed=seed + 5, scale=F**-0.5),
         _np(D, seed=seed + 6, scale=0.1), _np(1, rows, D, seed=seed + 7),
         _np(1, rows, F, seed=seed + 8)]
    out = [torch.from_numpy(a) for a in t]
    for i in (0, 1, 5, 7, 8):
        out[i] = out[i].to(dtype)
    return out


def _keep_bits(seeds, T, M, F, threshold):
    """(M, F) bool: the kernel's keep flags, drawn as its threads draw them.

    Thread (row group r0 = 16 w + i, i < 8; quad q) of column group c (8
    columns) makes one Philox call, counter (c * 2 + q // 2, t, 0, 0) and key
    (seed, 0) of row r0 + 8 (q & 1), and sends lane ^ 1 the two words it
    needs: q even keeps words 0 and 1 of row r0 and receives those of r0 + 8,
    q odd the reverse with words 2 and 3."""
    Mp = -(-M // ROWS) * ROWS
    rows = torch.arange(Mp)
    r0 = rows[(rows % 16) < 8]  # the rows a thread holds first
    out = torch.zeros(Mp, F, dtype=torch.bool)
    groups = torch.arange(F // 8)
    words = {}
    for q in range(4):
        mine = (r0 + 8 * (q & 1))[:, None]
        valid = mine < M
        seed = torch.where(valid, seeds.to(torch.int64)[(mine // T).clamp(max=len(seeds) - 1)]
                           & 0xFFFFFFFF, 0)
        t = torch.where(valid, mine % T, 0)
        c0 = (2 * groups + q // 2)[None, :].expand(len(r0), -1)
        words[q] = philox.philox4x32(c0, t.expand_as(c0), seed.expand_as(c0))
    for q in range(4):
        odd = q & 1
        own = words[q][2:4] if odd else words[q][0:2]
        send_partner = words[q ^ 1][0:2] if (q ^ 1) & 1 else words[q ^ 1][2:4]
        first, second = (send_partner, own) if odd else (own, send_partner)
        for e in range(2):
            cols = 8 * groups + 2 * q + e
            out[r0[:, None], cols[None, :]] = first[e] >= threshold
            out[(r0 + 8)[:, None], cols[None, :]] = second[e] >= threshold
    return out[:M]


def _db1_partials(dh):
    """(ceil(M / 128), F) fp32: the column sums of dh (M, F) fp32 per row
    tile in the kernel's order (rows past M add zero)."""
    M, F = dh.shape
    Mp = -(-M // ROWS) * ROWS
    d = torch.zeros(Mp, F)
    d[:M] = dh
    d = d.view(-1, WARPS, 2, 8, F)  # tile, warp, half (r or r + 8), row group i, column
    s = d[:, :, 0] + d[:, :, 1]  # a thread's two rows
    for o in (1, 2, 4):  # lanes xor 4, 8, 16: row groups xor 1, 2, 4
        s = s + s[:, :, torch.arange(8) ^ o]
    s = s[:, :, 0]  # (tiles, warps, F)
    out = torch.zeros(s.shape[0], F)
    for w in range(WARPS):
        out = out + s[:, w]
    return out


def _chunked(a_chunk, b, K):
    """sum over 64-deep chunks k of a_chunk(k) (M, 64) @ b[:, k] (N, 64)^T, in
    fp32, chunk by chunk."""
    acc = None
    for k0 in range(0, K, CHUNK):
        part = a_chunk(k0) @ b[:, k0:k0 + CHUNK].float().t()
        acc = part if acc is None else acc + part
    return acc


def _walk(x, w1, b1, gamma, beta, w2, dy, dg_in, *, ln, dg_in_kernel, rate=0.0, seeds=None):
    """The mainloop's forward and first backward kernel and dl, walked.
    Returns dict: g, dh (fp32 and rounded), ln_out, dg, dl, db1 (summed
    partials), and the keep mask."""
    dt = x.dtype
    B, T, D = x.shape
    F = w1.shape[0]
    M = B * T
    x2 = x.reshape(M, D)
    x32 = x2.float()
    # The row statistics: once per row, before the K loop.
    mean = x32.mean(dim=-1, keepdim=True)
    cen = x32 - mean
    rstd = torch.rsqrt((cen * cen).mean(dim=-1, keepdim=True) + EPS)

    def a_chunk(k0):
        xc = x32[:, k0:k0 + CHUNK]
        if not ln:
            return xc
        return (((xc - mean) * rstd) * gamma[k0:k0 + CHUNK].float()
                + beta[k0:k0 + CHUNK].float()).to(dt).float()

    ln_out = torch.cat([a_chunk(k0) for k0 in range(0, D, CHUNK)], dim=1).to(dt)
    h = _chunked(a_chunk, w1, D) + b1.float()
    if dg_in_kernel:
        dy2 = dy.reshape(M, D).float()
        dg = _chunked(lambda k0: dy2[:, k0:k0 + CHUNK], w2.t(), D)
    else:
        dg = dg_in.reshape(M, F).to(dt).float()
    g = gelu_poly(h)
    dh = dg * _dgelu(h)
    keep = None
    if rate > 0.0:
        keep = _keep_bits(seeds, T, M, F, philox.threshold(rate))
        scale = 1.0 / (1.0 - rate)
        g = torch.where(keep, g * scale, 0.0)
        dh = torch.where(keep, dg * scale * _dgelu(h), 0.0)
    dhb = dh.to(dt)
    dl = _chunked(lambda k0: dhb[:, k0:k0 + CHUNK].float(), w1.t(), F)
    return {"g": g.to(dt), "dh32": dh, "dh": dhb, "ln_out": ln_out, "dg": dg, "dl": dl,
            "db1": _db1_partials(dh).sum(0), "keep": keep, "xhat": cen * rstd, "rstd": rstd,
            "h": h}


def _assemble(w, x, gamma, w2, b2, dy):
    """The block's outputs and gradients around the walked kernels, as the
    port's backward assembles them: y = g W2^T + b2, dx from dl through the
    LayerNorm backward, dW1 = dh^T ln_out, dW2 = dy^T g, db2 = sum(dy)."""
    D = x.shape[-1]
    M = x.numel() // D
    g2 = w["g"].reshape(M, -1).float()
    y = g2 @ w2.float().t() + b2.float()
    dx = ffn._ln_bwd_rows(w["dl"], w["xhat"], w["rstd"], gamma)
    dy2 = dy.reshape(M, D).float()
    return {"y": y, "dx": dx, "dw1": w["dh"].float().t() @ w["ln_out"].float(), "db1": w["db1"],
            "dgamma": (w["dl"] * w["xhat"]).sum(0), "dbeta": w["dl"].sum(0),
            "dw2": dy2.t() @ g2, "db2": dy2.sum(0)}


def _close(got, want, atol, rtol=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _close_max(got, want, frac):
    """Within frac of the largest |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=frac * np.abs(want).max(),
                               rtol=0.0)


@pytest.mark.parametrize("rows", [75, 130])
def test_walk_matches_the_jax_block_and_its_vjp_at_rate_0(rows):
    """fp32, D 384, F 1536: y and the seven cotangents of ``ffn_ln_block``
    (interpret mode, dg formed in the kernel) against the walked kernels."""
    D, F = 384, 1536
    x, w1, b1, gamma, beta, w2, b2, dy, _ = _inputs(D, F, rows, torch.float32)
    jargs = [jnp.asarray(a.numpy()) for a in (x, w1.t(), b1, gamma, beta, w2.t(), b2)]
    want_y, vjp = jax.vjp(lambda *a: jffn.ffn_ln_block(*a, interpret=True, dg_in_kernel=True),
                          *jargs)
    want = vjp(jnp.asarray(dy.numpy()))
    walk = _walk(x, w1, b1, gamma, beta, w2, dy, None, ln=True, dg_in_kernel=True)
    got = _assemble(walk, x, gamma, w2, b2, dy)
    _close(got["y"], np.asarray(want_y).reshape(rows, D), 2e-5, 1e-5)
    _close(got["dx"], np.asarray(want[0]).reshape(rows, D), 2e-5, 1e-5)
    for name, i, transpose in (("dw1", 1, True), ("db1", 2, False), ("dgamma", 3, False),
                               ("dbeta", 4, False), ("dw2", 5, True), ("db2", 6, False)):
        w = np.asarray(want[i])
        _close_max(got[name], w.T if transpose else w, 1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dg_in_kernel", [True, False], ids=["dg_in", "dg_read"])
@pytest.mark.parametrize("ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("D,F,rows", [(384, 1536, 75), (384, 1536, 130), (1920, 7680, 130)])
def test_walk_matches_the_plain_versions(D, F, rows, ln, dg_in_kernel, rate):
    """bf16: the walked kernels against the port's plain versions of the
    instantiation they make: K5 (ln, dg_in), N5 and N4 (ln, dg_read), N3 and
    N2 (no_ln, dg_read; without a LayerNorm dg is always read in, so no_ln
    with dg_in checks the forward and dl alone), the forwards K5 and N1."""
    x, w1, b1, gamma, beta, w2, _, dy, dg = _inputs(D, F, rows, torch.bfloat16, seed=rows)
    seeds = torch.tensor([20231], dtype=torch.int32)
    kw = dict(rate=rate, seeds=seeds if rate else None)
    walk = _walk(x, w1, b1, gamma, beta, w2, dy, dg, ln=ln, dg_in_kernel=dg_in_kernel, **kw)
    g, dh = walk["g"].view(1, rows, F), walk["dh"].view(1, rows, F)
    fwd = (ffn.ffn_ln_fc1_plain(x, w1, b1, gamma, beta, **kw) if ln
           else ffn.ffn_fc1_plain(x, w1, b1, **kw))
    _close(g.float(), fwd.float(), 1e-6, BF16_ULP)
    if ln and dg_in_kernel:
        want = ffn.ffn_bwd_plain(x, w1, b1, gamma, beta, dy, w2, **kw)
    elif ln:
        want = ffn.ffn_ln_g_bwd_plain(x, w1, b1, gamma, beta, dg, **kw)
        n4 = ffn.ffn_ln_fc1_bwd_plain(x, w1, b1, gamma, beta, dg, **kw)
        for a, b in zip(n4, (want[1], want[3], want[2], *want[4:])):
            assert torch.equal(a, b)  # N4 is N5 without g
    else:
        want = None
    if want is not None:
        g_w, dh_w, ln_w, dx_w, db1_w, dgamma_w, dbeta_w = want
        _close(g.float(), g_w.float(), 1e-6, BF16_ULP)
        _close(dh.float(), dh_w.float(), 1e-6, BF16_ULP)
        assert torch.equal(walk["ln_out"].view(1, rows, D), ln_w)
        got = _assemble(walk, x, gamma, w2, torch.zeros(D), dy)
        dx_w = dx_w.float().view(rows, D)
        _close(got["dx"], dx_w, DX_FRAC * dx_w.abs().max().item(), BF16_ULP)
        for a, b in ((got["db1"], db1_w), (got["dgamma"], dgamma_w), (got["dbeta"], dbeta_w)):
            _close_max(a, b, 1e-4)
    elif not dg_in_kernel:
        for emit_g in (False, True):
            want = ffn.ffn_fc1_bwd_plain(x, w1, b1, dg, emit_g=emit_g, **kw)
            _close(dh.float(), want[0].float(), 1e-6, BF16_ULP)
            if emit_g:
                _close(g.float(), want[1].float(), 1e-6, BF16_ULP)
            dx, dx_w = walk["dl"].to(x.dtype).view(1, rows, D), want[-2].float()
            _close(dx.float(), dx_w, DX_FRAC * dx_w.abs().max().item(), BF16_ULP)
            _close_max(walk["db1"], want[-1], 1e-4)
    # dl over K = F chunks against one product of the same bf16 dh.
    dl_plain = walk["dh"].float() @ w1.float()
    _close_max(walk["dl"], dl_plain, 1e-5)


@pytest.mark.parametrize("rows", [75, 130])
def test_walk_masks_obey_the_dropout_laws(rows):
    """Rate 0.1, two batch rows with their own seeds: the threads' pairwise
    Philox draws give ``philox.keep_mask`` bit for bit; the forward's g and
    the backward's dh drop the same elements; kept values are the rate-0
    values times 1 / 0.9; the keep fraction is within 5 sigma of 0.9."""
    D, F = 384, 1536
    x, w1, b1, gamma, beta, w2, _, _, dg = _inputs(D, F, rows, torch.float32)
    x = torch.cat([x, x.flip(1)])
    dg = torch.cat([dg, dg.flip(1)])
    seeds = torch.tensor([7, -12345], dtype=torch.int32)
    base = _walk(x, w1, b1, gamma, beta, w2, None, dg, ln=True, dg_in_kernel=False)
    drop = _walk(x, w1, b1, gamma, beta, w2, None, dg, ln=True, dg_in_kernel=False, rate=0.1,
                 seeds=seeds)
    keep = drop["keep"]
    assert torch.equal(keep.view(2, rows, F), philox.keep_mask(seeds, rows, F, 0.1))
    assert torch.equal(drop["g"][keep], base["g"][keep] * (1.0 / 0.9))
    assert torch.equal(drop["dh32"][keep], (base["dg"] * (1.0 / 0.9) * _dgelu(base["h"]))[keep])
    assert not drop["g"][~keep].any() and not drop["dh32"][~keep].any()
    n = keep.numel()
    frac = keep.float().mean().item()
    assert abs(frac - 0.9) < 5 * (0.09 / n) ** 0.5


def test_db1_partials_sum_in_the_kernels_fixed_order():
    """The db1 partial of each 128-row tile: the tree of the kernel (a
    thread's two rows, the butterfly over the warp's 8 row pairs, the 8
    warps in order) gives the column sums within fp32 rounding, rows past M
    add nothing, and the order is the same on every call."""
    dh = torch.from_numpy(_np(300, 256, seed=3))
    parts = _db1_partials(dh)
    assert parts.shape == (3, 256)
    for t in range(3):
        _close(parts[t], dh[128 * t:128 * (t + 1)].sum(0), 2e-5, 1e-6)
    assert torch.equal(parts, _db1_partials(dh.clone()))
    padded = torch.cat([dh, torch.zeros(84, 256)])
    assert torch.equal(_db1_partials(padded), parts)


# -- the bias-only policy: ln_dense's forward (csrc/ln_dense.cu) ----------------------

COLS = 256  # the forward's column tile


def _tiles_per_block(row_tiles, col_tiles, any_count, sms=132):
    """``gemm::tiles_per_block``: the column tiles a block takes, the fewest
    block-waves times a block's work (its tiles plus a quarter of one); 1,
    2, 4 or 8 dividing the count, or with any_count any of 1 .. 8."""
    best, best_cost = 1, None
    n = 1
    while n <= 8:
        if any_count or col_tiles % n == 0:
            groups = -(-col_tiles // n)
            cost = -(-(row_tiles * groups) // sms) * (n + 0.25)
            if best_cost is None or cost < best_cost:
                best, best_cost = n, cost
        n += 1 if any_count else n
    return best


def _walk_ln_dense(x, w, b, gamma, beta):
    """The bias-only forward, walked: the row statistics and each chunk's
    LayerNorm as ``_walk``'s kLn; column tiles of 256 rounded up (W's rows
    past F are the tensor map's zeros), taken ``_tiles_per_block(..., True)``
    at a time by a block, a row's last block the rest; the epilogue + b in
    fp32, rounded once, stored below F only. Returns y (B, T, F) and the
    column tiles each block took."""
    dt = x.dtype
    B, T, D = x.shape
    F = w.shape[0]
    M = B * T
    x32 = x.reshape(M, D).float()
    mean = x32.mean(dim=-1, keepdim=True)
    cen = x32 - mean
    rstd = torch.rsqrt((cen * cen).mean(dim=-1, keepdim=True) + EPS)

    def a_chunk(k0):
        xc = x32[:, k0:k0 + CHUNK]
        return (((xc - mean) * rstd) * gamma[k0:k0 + CHUNK].float()
                + beta[k0:k0 + CHUNK].float()).to(dt).float()

    col_tiles = -(-F // COLS)
    w_pad = torch.zeros(col_tiles * COLS, D, dtype=w.dtype)
    w_pad[:F] = w
    tiles = _tiles_per_block(-(-M // ROWS), col_tiles, True)
    y = torch.full((M, F), float("nan"), dtype=dt)
    taken = []
    for c0 in range(0, col_tiles, tiles):
        block = list(range(c0, min(c0 + tiles, col_tiles)))
        taken.append(block)
        for c in block:
            n0 = c * COLS
            acc = _chunked(a_chunk, w_pad[n0:n0 + COLS], D)
            cols = min(COLS, F - n0)  # the last tile's second half lies past F at F = 5760
            y[:, n0:n0 + cols] = (acc[:, :cols] + b[n0:n0 + cols].float()).to(dt)
    return y.view(B, T, F), taken


@pytest.mark.parametrize("rows", [75, 130])
def test_ln_dense_walk_matches_the_jax_forward(rows):
    """fp32, D 128, F = 384 = 1.5 column tiles (the tail of F = 5760 at D
    1920): the walk against ``_fwd_pallas_lnmm`` in interpret mode within
    ``2e-5 + 1e-5 |y|`` (chunked sums in another order); every column written
    once, by the blocks the tile count gives."""
    D, F = 128, 384
    x, w, b, gamma, beta, *_ = _inputs(D, F, rows, torch.float32, seed=11)
    want = jffn._fwd_pallas_lnmm(*(jnp.asarray(a.numpy()) for a in (x, w.t(), b, gamma, beta)),
                                 EPS, True)
    got, taken = _walk_ln_dense(x, w, b, gamma, beta)
    _close(got, np.asarray(want), 2e-5, 1e-5)
    assert sorted(c for block in taken for c in block) == [0, 1]


@pytest.mark.parametrize("D,F,rows", [(128, 384, 130), (384, 1152, 75)])
def test_ln_dense_walk_matches_the_plain_version(D, F, rows):
    """bf16: the walk against ``ln_dense_plain`` within one bf16 ulp plus
    1e-6 (the same arithmetic, the product's fp32 sums chunk by chunk against
    torch's), at F = 1.5 and 4.5 column tiles."""
    x, w, b, gamma, beta, *_ = _inputs(D, F, rows, torch.bfloat16, seed=rows)
    got, _ = _walk_ln_dense(x, w, b, gamma, beta)
    want = ffn.ln_dense_plain(x, w, b, gamma, beta)
    _close(got.float(), want.float(), 1e-6, BF16_ULP)


def test_ln_dense_takes_any_tile_count_and_the_others_keep_theirs():
    """At the serving rows (8 x 1499: 94 row tiles, 132 SMs) the bias-only
    forward takes 3 of D 1024's 12 column tiles a block, 4 of 1280's 15 and 6
    of 1920's 23 (4 blocks a row, the last with 5); the counts of the FFN
    forward (F = 4 D, 16 column tiles at 1024) stay the powers of two that
    divide theirs."""
    assert [_tiles_per_block(94, c, True) for c in (12, 15, 23)] == [3, 4, 6]
    assert _tiles_per_block(94, 16, False) == 4 and _tiles_per_block(94, 30, False) == 2
    groups = [list(range(c0, min(c0 + 6, 23))) for c0 in range(0, 23, 6)]
    assert [len(g) for g in groups] == [6, 6, 6, 5]
