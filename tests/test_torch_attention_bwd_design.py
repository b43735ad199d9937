"""The short-T attention backwards' kernel design, walked in plain PyTorch on the CPU.

Every backward of ``short_t_attention_flat`` (v3 with and without the q/k/v
biases, "v2", v1's, the o-residual one and the one that recomputes the
softmax) is a pair of kernels on the backward mainloop of
``coral_tpu_torch/csrc/attention.cuh`` (policies ``bwd::K4``, ``bwd::Stats``,
``bwd::Recompute``, ``bwd::Ctx``), which only a card runs. ``_walk`` below
does what those kernels do, block by block and tile by tile, in fp32 with
bf16 rounding where the kernels round:

- the operands as the tiles hold them: q, k, v plus their biases rounded to
  bf16, q times the bf16 scale rounded again; keys past T (a tile's padding)
  are zero rows with a key bias of -inf;
- the dq kernel per 128 query rows, over key tiles of ``_DQ_TILE[d]`` keys:
  the scores in log2 units, ``s log2 e + b`` by one FMA with b the key bias
  times log2 e; for Stats, Recompute and Ctx first a sweep that forms the
  online m and l and u = sum_j p dp (or sum_j e dp against the running max,
  rescaled with it) and writes delta; then p = exp2(s - lse log2 e), or
  exp2(s - m) times r = 1 / l with m and l kept apart, dS = bf16(p (dP -
  delta)) and dq = bf16(sm_scale dS K);
- the dkv kernel per 128 keys, over query tiles of ``_DKV_TILE[d]`` queries,
  in the transposed space, from the staged row stats: dV += bf16(P^T) dO, dK
  += dS^T Q;
- the bias gradients as column sums of the rounded dq, dk, dv per 128-row
  block, summed over blocks and batch rows outside.

At B 2, H 2, head_dim 64 (and 80, 120 at T 300), T 1, 129 and 300, with
padded keys and a fully masked batch row, the walk gives
``attention_bwd_plain``'s dq, dk and dv within 1e-2 of their largest value
plus two bf16 ulps (bf16 roundings of p and dS that the exp2 in log2 units
moves by one ulp, summed over up to T terms) and db within 1e-3 of its
largest value; the masked row gets no gradient on the routes with an lse and,
on Recompute and Ctx, p = 1/T exactly in both kernels (every key's dv the
mean of do), which folding m log2 e + log2 l into one fp32 constant would not
give.
"""

import re

import numpy as np
import pytest
import torch

from coral_tpu_torch.ops import _build, attention

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
ROWS = 128  # a kernel block's own rows
# Keys of a dq tile and queries of a dkv tile by head dim (bwd::dq_tile,
# bwd::dkv_tile).
_DQ_TILE = {64: 128, 80: 128, 120: 64}
_DKV_TILE = {64: 64, 80: 64, 120: 32}
# The six backwards: (route, with the q/k/v biases).
CASES = {"stats_v3_qb": ("stats_v3", True), "stats_v3": ("stats_v3", False),
         "stats_v2": ("stats_v2", False), "stats": ("stats", False), "ctx": ("ctx", False),
         "attention": ("attention", False)}
# The policies that sweep m and l: p = exp2(s - m) / l, no clamp.
ML_ROUTES = ("ctx", "attention")


def _fma(a, b, c):
    """fp32 a b + c as one FMA: the product of two fp32 values is exact in
    fp64, and the sum is rounded there and then to fp32."""
    return (a.double() * b.double() + c.double()).float()


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _pad_rows(x, rows, value=0.0):
    """x (..., T, n) padded with `value` rows to `rows` along T."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]), value=value)


def _pad_cols(x, cols, value):
    return torch.nn.functional.pad(x, (0, cols - x.shape[-1]), value=value)


def _dq_walk(qh, kh, vh, doh, kb2, lse2, delta_o, route, d, sm_scale):
    """The dq kernel: dq (B, H, T, d) fp32 (bf16 values), the scratch it writes
    (delta, m, l), and p of batch row 1's queries (B = 1 slice) over the keys
    below T."""
    B, H, T, _ = qh.shape
    n = _DQ_TILE[d]
    tiles = -(-T // n)
    kp, vp = _pad_rows(kh, tiles * n), _pad_rows(vh, tiles * n)
    kbp = _pad_cols(kb2, tiles * n, float("-inf"))[:, None, None, :]  # (B, 1, 1, Tp)
    ml = route in ML_ROUTES
    sweep_u = route in ("stats_v2", "stats", "attention")
    dq = torch.empty_like(qh)
    delta = torch.empty(B, H, T)
    m_out, l_out = torch.empty(B, H, T), torch.empty(B, H, T)
    p_rows = torch.empty(H, T, T)
    for q0 in range(0, T, ROWS):
        rows = slice(q0, min(q0 + ROWS, T))
        qb, dob = qh[:, :, rows], doh[:, :, rows]

        def tile(i):
            keys = slice(i * n, (i + 1) * n)
            s = _fma(qb @ kp[:, :, keys].transpose(-1, -2), LOG2E, kbp[..., keys])
            return keys, s, dob @ vp[:, :, keys].transpose(-1, -2)

        c = lse2[:, :, rows, None] if not ml else None
        r = torch.ones_like(qb[..., :1])
        d_rows = None if sweep_u else delta_o[:, :, rows, None]
        if sweep_u or ml:
            m = torch.full_like(qb[..., :1], float("-inf"))
            l, u = torch.zeros_like(m), torch.zeros_like(m)
            for i in range(tiles):
                _, s, dp = tile(i)
                if not ml:
                    u = u + (torch.exp2(s - c) * dp).sum(-1, keepdim=True)
                    continue
                mn = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - mn)
                e = torch.exp2(s - mn)
                l = _fma(l, alpha, e.sum(-1, keepdim=True))
                if sweep_u:
                    u = _fma(u, alpha, (e * dp).sum(-1, keepdim=True))
                m = mn
            if ml:
                c, r = m, 1.0 / l
                m_out[:, :, rows], l_out[:, :, rows] = m[..., 0], l[..., 0]
            if sweep_u:
                d_rows = u / l if ml else u
        delta[:, :, rows] = d_rows[..., 0]
        acc = torch.zeros_like(qb)
        for i in range(tiles):
            keys, s, dp = tile(i)
            p = torch.exp2(s - c) * r if ml else torch.exp2(s - c)
            if B > 1:
                valid = slice(0, max(0, min(keys.stop, T) - keys.start))
                p_rows[:, rows, keys.start:keys.start + valid.stop] = p[1][..., valid]
            acc = acc + _bf16(p * (dp - d_rows)) @ kp[:, :, keys]
        dq[:, :, rows] = _bf16(acc * sm_scale)
    return dq, delta, m_out, l_out, p_rows


def _dkv_walk(qh, kh, vh, doh, kb2, c_rows, r_rows, delta, d):
    """The dkv kernel from the staged row stats (c: the lse log2 e or m, r: 1
    / l or 1, delta; (B, H, T)): dk, dv (B, H, T, d) fp32 (bf16 values), and
    p^T of batch row 1's keys over its queries."""
    B, H, T, _ = qh.shape
    n = _DKV_TILE[d]
    tiles = -(-T // n)
    qp, dop = _pad_rows(qh, tiles * n), _pad_rows(doh, tiles * n)
    cp = _pad_cols(c_rows, tiles * n, float("inf"))
    rp = _pad_cols(r_rows, tiles * n, 1.0)
    dlp = _pad_cols(delta, tiles * n, 0.0)
    dk, dv = torch.empty_like(kh), torch.empty_like(vh)
    p_cols = torch.empty(H, T, T)
    for k0 in range(0, T, ROWS):
        keys = slice(k0, min(k0 + ROWS, T))
        kb, vb = kh[:, :, keys], vh[:, :, keys]
        kbias = kb2[:, None, keys, None]  # (B, 1, R, 1): the threads' keys in registers
        acc_k, acc_v = torch.zeros_like(kb), torch.zeros_like(vb)
        for i in range(tiles):
            qs = slice(i * n, (i + 1) * n)
            st = _fma(kb @ qp[:, :, qs].transpose(-1, -2), LOG2E, kbias)
            pt = torch.exp2(st - cp[:, :, None, qs]) * rp[:, :, None, qs]
            dpt = vb @ dop[:, :, qs].transpose(-1, -2)
            if B > 1:
                valid = max(0, min(qs.stop, T) - qs.start)
                p_cols[:, qs.start:qs.start + valid, keys] = pt[1][..., :valid].transpose(-1, -2)
            acc_v = acc_v + _bf16(pt) @ dop[:, :, qs]
            acc_k = acc_k + _bf16(pt * (dpt - dlp[:, :, None, qs])) @ qp[:, :, qs]
        dk[:, :, keys], dv[:, :, keys] = _bf16(acc_k), _bf16(acc_v)
    return dk, dv, p_cols


def _block_sums(g):
    """A bias gradient as the kernels form it: each 128-row block's column sums
    of the rounded (B, T, H*d) gradient, then the sum over blocks and batch
    rows."""
    T = g.shape[1]
    parts = [g[:, t0:t0 + ROWS].float().sum(dim=1) for t0 in range(0, T, ROWS)]
    return torch.stack(parts, dim=1).sum(dim=(0, 1))


def _walk(q, k, v, bq, bk, bv, key_bias, do, lse, o, d, sm_scale, route):
    """Both kernels of ``route``'s pair: (dq, dk, dv, db) as
    ``attention_bwd_plain`` returns them, and the masked row's p from the dq
    kernel and the dkv kernel."""
    qh, kh, vh = attention._biased(q, k, v, bq, bk, bv, d, sm_scale)
    doh = attention._heads(do, d)
    kb2 = key_bias * LOG2E  # (B, T): the key bias in log2 units
    lse2 = lse * LOG2E if route in attention.LSE_ROUTES else None
    delta_o = ((doh * attention._heads(o, d)).sum(-1) if route in attention.O_ROUTES else None)
    dq, delta, m, l, p_dq = _dq_walk(qh, kh, vh, doh, kb2, lse2, delta_o, route, d, sm_scale)
    ml = route in ML_ROUTES
    c_rows = m if ml else lse2
    r_rows = 1.0 / l if ml else torch.ones_like(delta)
    dk, dv, p_dkv = _dkv_walk(qh, kh, vh, doh, kb2, c_rows, r_rows, delta, d)
    dq, dk, dv = (attention._flat(t).to(q.dtype) for t in (dq, dk, dv))
    db = None if bq is None else torch.stack([_block_sums(t) for t in (dq, dk, dv)])
    return (dq, dk, dv, db), (p_dq, p_dkv)


def _inputs(T, d, bias, H=2, B=2):
    """bf16 q, k, v, do (B, T, H d) from a seed, the biases or None, and the
    key bias: batch row 0 with its last third padded (at T = 1 none), row 1
    fully masked."""
    rng = np.random.default_rng(T + d + bias)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, H * d)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    biases = ((None,) * 3 if not bias else tuple(
        torch.from_numpy(rng.standard_normal(H * d).astype(np.float32) * 0.5)
        .to(torch.bfloat16) for _ in range(3)))
    lengths = torch.tensor([T - T // 3, 0])
    mask = torch.arange(T)[None, :] < lengths[:, None]
    return q, k, v, do, biases, attention._key_bias(mask)


def _near(got, want, frac):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = frac * want.abs().max() + 2.0**-6 * want.abs()
    assert torch.isfinite(got).all()
    assert (err <= bound).all(), f"max err {err.max().item()} vs max {want.abs().max().item()}"


def _check_route(case, T, d):
    route, bias = CASES[case]
    q, k, v, do, (bq, bk, bv), key_bias = _inputs(T, d, bias)
    sm_scale = d**-0.5
    fwd_route = "stats_v2" if route == "stats" else route
    o, lse = attention._fwd_plain(q, k, v, bq, bk, bv, key_bias, d, sm_scale, fwd_route)
    args = (q, k, v, bq, bk, bv, key_bias, do, lse, o, d, sm_scale)
    (dq, dk, dv, db), (p_dq, p_dkv) = _walk(*args, route)
    want = attention.attention_bwd_plain(*args, route=route)
    for g, w in zip((dq, dk, dv), want[:3]):
        assert g.shape == w.shape and g.dtype == w.dtype
        _near(g, w, 1e-2)
    if bias:
        _near(db, want[3], 1e-3)
    else:
        assert want[3] is None and db is None
    if route in ML_ROUTES:
        # p = exp2(s - m) (1 / l) on the fully masked row: s - m = 0, l = T.
        inv_t = torch.tensor(1.0, dtype=torch.float32) / T
        assert torch.equal(p_dq, torch.full_like(p_dq, float(inv_t)))
        assert torch.equal(p_dkv, torch.full_like(p_dkv, float(inv_t)))
        # Every key's dv is then the mean of do over the row's queries.
        mean = do[1].float().mean(dim=0)
        _near(dv[1], mean.expand_as(dv[1]), 1e-2)
    else:
        assert not p_dq.any() and not p_dkv.any()
        assert not any(g[1].any() for g in (dq, dk, dv))


@pytest.mark.parametrize("T", [1, 129, 300])
@pytest.mark.parametrize("case", CASES)
def test_the_kernels_design_is_the_plain_backward(case, T):
    _check_route(case, T, 64)


@pytest.mark.parametrize("d", [80, 120])
@pytest.mark.parametrize("case", CASES)
def test_the_kernels_design_at_the_wider_heads(case, d):
    """The same at XLS-R-1B's and -2B's head dims: 64-key dq and 32-query dkv
    tiles at 120, and q's bf16 scale not a power of two."""
    _check_route(case, 300, d)


def test_one_folded_constant_loses_the_masked_rows_sum():
    """On a fully masked row every score in log2 units is the key bias
    -1e30 log2 e, and so is m. With m and l apart, p = exp2(s - m) / l = 1/T;
    K7's one constant c = m_nat log2 e + log2 l (m_nat the natural-units
    max) rounds to m at -1.44e30, whose ulp is ~1.5e23, so exp2(s - c) loses
    the division by l (p = 1 here, 0 or inf where the two roundings of
    -1e30 log2 e part)."""
    T = 300
    q, k, v, do, _, key_bias = _inputs(T, 64, False)
    qh, kh, _ = attention._biased(q, k, v, None, None, None, 64, 0.125)
    s_nat = qh[1] @ kh[1].transpose(-1, -2) + key_bias[1]  # batch row 1, natural units
    s = _fma(qh[1] @ kh[1].transpose(-1, -2), LOG2E, key_bias[1] * LOG2E)
    m = s.amax(-1, keepdim=True)
    l = torch.exp2(s - m).sum(-1, keepdim=True)
    assert torch.equal(l, torch.full_like(l, float(T)))
    p_apart = torch.exp2(s - m) * (1.0 / l)
    inv_t = float(torch.tensor(1.0, dtype=torch.float32) / T)
    assert torch.equal(p_apart, torch.full_like(p_apart, inv_t))
    m_nat = s_nat.amax(-1, keepdim=True)
    c = _fma(m_nat, LOG2E, torch.log2(l))
    assert torch.equal(c, m)  # log2 l = 8.2 is lost at -1.44e30
    p_folded = torch.exp2(s - c)
    assert not (p_folded == inv_t).any()


def test_the_walks_tiles_are_the_kernels():
    """``_DQ_TILE`` and ``_DKV_TILE`` are the kernels' tiles, and ``ROWS``
    their blocks' rows, as ``attention.cuh`` sets them."""
    text = (_build.CSRC / "attention.cuh").read_text()
    bwd = text[text.index("namespace bwd {"):]
    assert "constexpr int kRows = 64 * kWG;" in bwd and "constexpr int kWG = 2;" in bwd
    for fn, tiles in (("dq_tile", _DQ_TILE), ("dkv_tile", _DKV_TILE)):
        wide, narrow = re.search(
            rf"constexpr int {fn}\(int D\) {{ return D == 120 \? (\d+) : (\d+); }}", bwd).groups()
        assert tiles == {64: int(narrow), 80: int(narrow), 120: int(wide)}
    assert ROWS == attention._TILE
