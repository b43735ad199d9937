"""coral_tpu_torch.ops against coral_tpu.ops: each kernel module of the port.

On the CPU each port wrapper runs its kernel's plain PyTorch version; here it
is held against the JAX function on the same inputs (made by numpy from a
seed), in fp32, where the point is the algorithm. The JAX side runs as the JAX
package's own CPU tests run it: Pallas kernels in interpret mode, or the
off-TPU path. Tolerances: atol 2e-5, the bound the JAX package's own op tests
use (tests/test_conv_ln_gelu.py, tests/test_ffn_pallas.py): fp32 math whose
reductions run in another order. Gradients that are sums over rows (dgamma,
dbeta, the bias gradients, dW) are held at atol 1e-4: sums of a few hundred
fp32 terms of order 1 in another order.
The backward passes are compared through ``jax.vjp`` of the same JAX entry
points. Dropout cannot match the JAX bits (the TPU's PRNG, or
``jax.random.bernoulli`` on the CPU), so its laws are checked instead.
The CUDA kernels against their plain versions on the card are in
tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.attention_pallas as jat
import coral_tpu.ops.conv_ln_gelu_pallas as jcg
import coral_tpu.ops.ctc as jctc
import coral_tpu.ops.decode_attention as jdec
import coral_tpu.ops.ffn_pallas as jffn
import coral_tpu.ops.gelu_dropout_pallas as jgelu
import coral_tpu.ops.ln_gelu_pallas as jln
from coral_tpu_torch.ops import (_build, attention, conv_ln_gelu, ctc, decode_attention, ffn,
                                 flash_attention, gelu_poly, ln_gelu, philox)

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

ATOL = 2e-5
ATOL_SUM = 1e-4


def _np(*shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(
        np.float32
    )


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# -- gelu_poly --------------------------------------------------------------------


def test_gelu_poly_matches_jax_forward_and_derivative():
    x = np.concatenate([np.linspace(-9, 9, 4001, dtype=np.float32),
                        _np(1000, seed=0, scale=3.0)])
    xt = _t(x).requires_grad_(True)
    y = gelu_poly.gelu_poly(xt)
    y.sum().backward()
    _close(y.detach(), jgelu.gelu_poly(jnp.asarray(x)), atol=2e-6)
    _close(xt.grad, jax.grad(lambda v: jnp.sum(jgelu.gelu_poly(v)))(jnp.asarray(x)),
           atol=2e-6)
    _close(gelu_poly._phi(_t(x)), jgelu._phi(jnp.asarray(x)), atol=2e-6)
    assert gelu_poly.GELU_POLY_CHOICE == jgelu._GELU_POLY_CHOICE


# -- ln_gelu / ln_fused -----------------------------------------------------------


@pytest.mark.parametrize("apply_gelu", [True, False], ids=["ln_gelu", "ln_fused"])
@pytest.mark.parametrize("jax_path", ["off_tpu", "pallas_interpret"])
def test_ln_matches_jax(apply_gelu, jax_path):
    x = _np(2, 515, 128, seed=1, scale=2.0, offset=0.5)
    gamma = _np(128, seed=2, scale=0.1, offset=1.0)
    beta = _np(128, seed=3, scale=0.1)
    if jax_path == "off_tpu":
        fn = jln.ln_gelu if apply_gelu else jln.ln_fused
        want = fn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    else:
        want = jln._fwd_pallas(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                               True, apply_gelu=apply_gelu)
    port = ln_gelu.ln_gelu if apply_gelu else ln_gelu.ln_fused
    _close(port(_t(x), _t(gamma), _t(beta)), want)


@pytest.mark.parametrize("apply_gelu", [True, False], ids=["ln_gelu", "ln_fused"])
def test_ln_bwd_matches_jax_interpret(apply_gelu):
    """The backward against ``jax.vjp`` of the custom-VJP ``_ln_gelu`` with the
    Pallas kernels in interpret mode (ragged last 512-row tile)."""
    x = _np(2, 515, 128, seed=1, scale=2.0, offset=0.5)
    gamma = _np(128, seed=2, scale=0.1, offset=1.0)
    beta = _np(128, seed=3, scale=0.1)
    dy = _np(2, 515, 128, seed=4)
    _, vjp = jax.vjp(lambda *a: jln._ln_gelu(*a, True, apply_gelu, 1e-5),
                     *map(jnp.asarray, (x, gamma, beta)))
    want = vjp(jnp.asarray(dy))
    args = [_t(a).requires_grad_(True) for a in (x, gamma, beta)]
    port = ln_gelu.ln_gelu if apply_gelu else ln_gelu.ln_fused
    port(*args).backward(_t(dy))
    _close(args[0].grad, want[0])
    _close(args[1].grad, want[1], atol=ATOL_SUM)
    _close(args[2].grad, want[2], atol=ATOL_SUM)


# -- conv_ln_gelu -----------------------------------------------------------------


def _conv_inputs(k, B, T_in, C, seed=0):
    x = _np(B, T_in, C, seed=seed)
    w = _np(k, C, C, seed=seed + 1, scale=0.05)  # JAX layout (k, C_in, C_out)
    b = _np(C, seed=seed + 2, scale=0.1)
    gamma = _np(C, seed=seed + 3, scale=0.1, offset=1.0)
    beta = _np(C, seed=seed + 4, scale=0.1)
    return x, w, b, gamma, beta


@pytest.mark.parametrize("k,T_in", [(3, 1101), (2, 999)])
def test_conv_ln_gelu_matches_jax_interpret(k, T_in):
    # Ragged T_in over several 256-row TPU slabs (k=3 takes the halo row).
    x, w, b, gamma, beta = _conv_inputs(k, 2, T_in, 128)
    want = jcg._conv_ln_gelu(*map(jnp.asarray, (x, w, b, gamma, beta)), k, 1e-5, True)
    got = conv_ln_gelu.conv_ln_gelu(_t(x), _t(w.transpose(2, 1, 0)), _t(b), _t(gamma),
                                    _t(beta))
    assert got.shape == want.shape == (2, (T_in - k) // 2 + 1, 128)
    _close(got, want)


@pytest.mark.parametrize("k,T_in", [(3, 1101), (2, 999)])
def test_conv_ln_gelu_training_forward_matches_jax_interpret(k, T_in):
    """The training launch's residuals: xhat (pre-affine, in x.dtype) and the
    fp32 rstd, against ``_fwd_pallas`` in interpret mode."""
    x, w, b, gamma, beta = _conv_inputs(k, 2, T_in, 128)
    want = jcg._fwd_pallas(*map(jnp.asarray, (x, w, b, gamma, beta)), k, 1e-5, True)
    got = conv_ln_gelu.conv_ln_gelu_fwd(_t(x), _t(w.transpose(2, 1, 0)), _t(b), _t(gamma),
                                        _t(beta))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.reshape(wnt.shape), wnt)


def _conv_grads(x, w, b, gamma, beta, dy):
    """The port's gradients of every input, in the JAX layout (dW (k, C_in,
    C_out))."""
    args = [_t(a).requires_grad_(True)
            for a in (x, w.transpose(2, 1, 0), b, gamma, beta)]
    conv_ln_gelu.conv_ln_gelu(*args).backward(_t(dy))
    grads = [a.grad for a in args]
    grads[1] = grads[1].permute(2, 1, 0)
    return grads


def _close_conv_grads(got, want):
    _close(got[0], want[0])
    for g, wnt in zip(got[1:], want[1:]):
        _close(g, wnt, atol=ATOL_SUM, rtol=1e-5)


@pytest.mark.parametrize("k,T_in", [(3, 1101), (3, 1102), (2, 999)])
def test_conv_ln_gelu_bwd_matches_jax_interpret(k, T_in):
    """Every gradient against ``jax.vjp`` of ``_conv_ln_gelu``, whose backward
    runs ``_bwd_pallas`` and ``_halo_fixup`` in interpret mode: ragged last
    256-row slabs, the k = 3 row that crosses a slab, and input rows that no
    output reads (T_in 1102 at k = 3, 999 at k = 2), whose dx is 0."""
    x, w, b, gamma, beta = _conv_inputs(k, 2, T_in, 128)
    T_out = (T_in - k) // 2 + 1
    dy = _np(2, T_out, 128, seed=9)
    _, vjp = jax.vjp(lambda *a: jcg._conv_ln_gelu(*a, k, 1e-5, True),
                     *map(jnp.asarray, (x, w, b, gamma, beta)))
    want = vjp(jnp.asarray(dy))
    got = _conv_grads(x, w, b, gamma, beta, dy)
    _close_conv_grads(got, want)
    read = 2 * (T_out - 1) + k
    assert read < T_in or (k, T_in) == (3, 1101)
    assert not got[0][:, read:].any()


def test_conv_ln_gelu_bwd_exact_fit_matches_xla_reference():
    """k = 3, T_in 1025: T_out 512 fills whole 256-row slabs, a shape the JAX
    wrapper routes to XLA; the port's kernels take it, against ``jax.vjp`` of
    ``_xla_reference``."""
    x, w, b, gamma, beta = _conv_inputs(3, 2, 1025, 128)
    dy = _np(2, 512, 128, seed=9)
    _, vjp = jax.vjp(lambda *a: jcg._xla_reference(*a, 3, 1e-5),
                     *map(jnp.asarray, (x, w, b, gamma, beta)))
    _close_conv_grads(_conv_grads(x, w, b, gamma, beta, dy), vjp(jnp.asarray(dy)))


# -- attention --------------------------------------------------------------------


def _attention_inputs(B, T, H, d, seed=0):
    q, k, v = (_np(B, T, H * d, seed=seed + i) for i in range(3))
    bq, bk, bv = (_np(H * d, seed=seed + 3 + i, scale=0.5) for i in range(3))
    mask = np.ones((B, T), bool)
    mask[1, T // 2 + 3:] = False  # padded keys
    mask[2, :] = False  # a fully padded row, like a lengths=1 filler row
    return q, k, v, (bq, bk, bv), mask


@pytest.mark.parametrize("head_dim", [64, 32])
def test_attention_matches_jax_interpret(head_dim):
    B, T, H = 3, 75, 2
    q, k, v, qkv_bias, mask = _attention_inputs(B, T, H, head_dim)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jb = tuple(map(jnp.asarray, qkv_bias))
    want_o = jat.short_t_attention_flat(jq, jk, jv, jnp.asarray(mask), head_dim,
                                        save_stats="v3", qkv_bias=jb, interpret=True)
    bias = jnp.where(jnp.asarray(mask), 0.0, -1e30).astype(jnp.float32)[:, None, :]
    _, want_lse = jat._fwd_pallas_stats_v2_qb(jq, jk, jv, *jb, bias,
                                              float(head_dim) ** -0.5, head_dim, True)
    o, lse = attention.short_t_attention_flat(
        _t(q), _t(k), _t(v), torch.from_numpy(mask), head_dim, tuple(map(_t, qkv_bias))
    )
    assert np.isfinite(o.numpy()).all()
    _close(o, want_o)
    _close(lse, want_lse, rtol=1e-6)
    # The fully padded row averages v + bv uniformly and its lse is clamped.
    _close(o[2], (_t(v[2]) + _t(qkv_bias[2])).mean(dim=0, keepdim=True).expand(T, -1),
           atol=1e-5)
    assert (lse[2] == -1e25).all()


@pytest.mark.parametrize("head_dim", [64, 32])
def test_attention_bwd_matches_jax_interpret(head_dim):
    """All six cotangents against ``jax.vjp`` of the v3 + qkv_bias attention
    in interpret mode, with padded keys and a fully masked row, which gets no
    gradient (its p is rebuilt from the clamped lse as 0)."""
    B, T, H = 3, 75, 2
    q, k, v, qkv_bias, mask = _attention_inputs(B, T, H, head_dim)
    do = _np(B, T, H * head_dim, seed=9)
    _, vjp = jax.vjp(
        lambda q, k, v, *b: jat.short_t_attention_flat(
            q, k, v, jnp.asarray(mask), head_dim, save_stats="v3", qkv_bias=b,
            interpret=True),
        *map(jnp.asarray, (q, k, v, *qkv_bias)),
    )
    want = vjp(jnp.asarray(do))
    args = [_t(a).requires_grad_(True) for a in (q, k, v, *qkv_bias)]
    o, _ = attention.short_t_attention_flat(*args[:3], torch.from_numpy(mask), head_dim,
                                            tuple(args[3:]))
    o.backward(_t(do))
    for a, w in zip(args[:3], want[:3]):
        _close(a.grad, w)
        assert not a.grad[2].any()
    for a, w in zip(args[3:], want[3:]):
        _close(a.grad, w, atol=ATOL_SUM)


# -- ffn_ln_block -----------------------------------------------------------------


def test_ffn_ln_block_matches_jax_interpret():
    D, F = 128, 256
    x = _np(2, 75, D, seed=0, offset=0.3)
    w1 = _np(D, F, seed=1, scale=0.1)  # JAX layout (in, out)
    b1 = _np(F, seed=2, scale=0.1)
    gamma = _np(D, seed=3, scale=0.1, offset=1.0)
    beta = _np(D, seed=4, scale=0.1)
    w2 = _np(F, D, seed=5, scale=0.1)
    b2 = _np(D, seed=6, scale=0.1)
    want = jffn.ffn_ln_block(*map(jnp.asarray, (x, w1, b1, gamma, beta, w2, b2)),
                             interpret=True, dg_in_kernel=True)
    got = ffn.ffn_ln_block(_t(x), _t(w1.T), _t(b1), _t(gamma), _t(beta), _t(w2.T), _t(b2))
    _close(got, want)


def test_ffn_ln_block_bwd_matches_jax_interpret():
    """Every gradient of the block at rate 0 against ``jax.vjp`` of
    ``ffn_ln_block(..., interpret=True, dg_in_kernel=True)``."""
    D, F = 128, 256
    jx = [_np(2, 75, D, seed=0, offset=0.3), _np(D, F, seed=1, scale=0.1),
          _np(F, seed=2, scale=0.1), _np(D, seed=3, scale=0.1, offset=1.0),
          _np(D, seed=4, scale=0.1), _np(F, D, seed=5, scale=0.1), _np(D, seed=6, scale=0.1)]
    dy = _np(2, 75, D, seed=7)
    _, vjp = jax.vjp(lambda *a: jffn.ffn_ln_block(*a, interpret=True, dg_in_kernel=True),
                     *map(jnp.asarray, jx))
    want = vjp(jnp.asarray(dy))
    transposed = (1, 5)  # W1, W2: JAX (in, out), the port (out, in)
    args = [_t(a.T if i in transposed else a).requires_grad_(True) for i, a in enumerate(jx)]
    ffn.ffn_ln_block(*args).backward(_t(dy))
    _close(args[0].grad, want[0])
    for i in range(1, 7):
        got = args[i].grad.T if i in transposed else args[i].grad
        _close(got, want[i], atol=ATOL_SUM)


def test_ffn_ln_block_matches_jax_interpret_at_whisper_large_width():
    """D = 1280, F = 5120 (Whisper large-v3, XLS-R-1B): the width the forward
    kernel gained for Whisper serving, against the JAX block in interpret mode."""
    D, F = 1280, 5120
    x = _np(1, 16, D, seed=0, offset=0.3)
    w1 = _np(D, F, seed=1, scale=D**-0.5)
    b1 = _np(F, seed=2, scale=0.1)
    gamma = _np(D, seed=3, scale=0.1, offset=1.0)
    beta = _np(D, seed=4, scale=0.1)
    w2 = _np(F, D, seed=5, scale=F**-0.5)
    b2 = _np(D, seed=6, scale=0.1)
    want = jffn.ffn_ln_block(*map(jnp.asarray, (x, w1, b1, gamma, beta, w2, b2)),
                             interpret=True, dg_in_kernel=True)
    got = ffn.ffn_ln_block(_t(x), _t(w1.T), _t(b1), _t(gamma), _t(beta), _t(w2.T), _t(b2))
    _close(got, want)


def test_ffn_dropout_laws():
    """Rate 0.1: the keep fraction, the 1/keep scale, a mask fixed by the seeds
    (and per batch row by its own seed), and dh zero exactly where g was
    dropped."""
    rate, B, T, D, F = 0.1, 4, 200, 32, 512
    x = _t(_np(B, T, D, seed=0))
    w1, b1 = _t(_np(F, D, seed=1, scale=0.2)), _t(_np(F, seed=2, scale=0.1))
    gamma, beta = torch.ones(D), torch.zeros(D)
    w2, dy = _t(_np(D, F, seed=3, scale=0.1)), _t(_np(B, T, D, seed=4))
    seeds = torch.tensor([1, 2, -3, 2**31 - 1], dtype=torch.int32)
    keep = philox.keep_mask(seeds, T, F, rate)
    assert abs(keep.float().mean().item() - (1 - rate)) < 5e-3  # 10 sigma
    g0 = ffn.ffn_ln_fc1(x, w1, b1, gamma, beta)
    g = ffn.ffn_ln_fc1(x, w1, b1, gamma, beta, rate=rate, seeds=seeds)
    assert torch.equal(g[keep], g0[keep] * (1.0 / (1.0 - rate)))
    assert not g[~keep].any()
    assert torch.equal(philox.keep_mask(seeds, T, F, rate), keep)
    assert torch.equal(philox.keep_mask(seeds[2:3], T, F, rate), keep[2:3])
    other = philox.keep_mask(seeds + 1, T, F, rate)
    assert 0.1 < (other != keep).float().mean().item() < 0.3
    g_bwd, dh = ffn.ffn_bwd_plain(x, w1, b1, gamma, beta, dy, w2, rate=rate, seeds=seeds)[:2]
    assert torch.equal(g_bwd, g)
    assert not dh[~keep].any() and dh[keep].ne(0).float().mean() > 0.99


def test_philox_known_answer():
    """Philox4x32-10 of counter 0 and key 0 (Random123's known-answer test)."""
    zero = torch.zeros(1, dtype=torch.int64)
    words = [int(w) for w in philox.philox4x32(zero, zero, zero)]
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


# -- ctc --------------------------------------------------------------------------


def _ctc_case(blank):
    T, B, V, L = 30, 5, 7, 6
    rng = np.random.default_rng(0)
    logits = _np(T, B, V, seed=1, scale=2.0)
    labels = rng.integers(0, V, size=(B, L)).astype(np.int64)
    labels = np.where(labels == blank, (blank + 1) % V, labels)
    labels[1, 4:] = -100  # -100 padding past the label length
    in_len = np.array([30, 25, 3, 20, 30], np.int64)  # row 2 is infeasible
    lab_len = np.array([6, 4, 6, 0, 1], np.int64)
    return logits, labels, in_len, lab_len


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_ctc_loss_matches_jax(impl, reduction, monkeypatch):
    """Loss and gradient through log-softmax against the JAX ``ctc_loss`` with
    its lax.scan recursions and with its Pallas kernels in interpret mode;
    an infeasible row (zero_infinity), -100 padding and a nonzero blank."""
    monkeypatch.setenv("CORAL_CTC_IMPL", impl)
    blank = 3
    logits, labels, in_len, lab_len = _ctc_case(blank)

    def jloss(x):
        return jnp.sum(jctc.ctc_loss(jax.nn.log_softmax(x, -1), jnp.asarray(labels),
                                     jnp.asarray(in_len), jnp.asarray(lab_len), blank,
                                     reduction))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = ctc.ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(labels),
                       torch.from_numpy(in_len), torch.from_numpy(lab_len), blank, reduction)
    got.sum().backward()
    _close(got.sum().detach(), want, atol=1e-4)
    _close(x.grad, want_grad, atol=1e-5)
    assert not x.grad[:, 2].any()  # zero_infinity zeroes the infeasible row's gradient


def test_ctc_loss_matches_torch_ctc_loss():
    """An independent oracle: ``torch.nn.functional.ctc_loss`` (tests only)."""
    blank = 3
    logits, labels, in_len, lab_len = _ctc_case(blank)
    grads, losses = [], []
    for fn in (ctc.ctc_loss, torch.nn.functional.ctc_loss):
        x = _t(logits).requires_grad_(True)
        loss = fn(torch.log_softmax(x, -1), torch.from_numpy(np.maximum(labels, 0)),
                  torch.from_numpy(in_len), torch.from_numpy(lab_len), blank, "none", True)
        loss.sum().backward()
        losses.append(loss.detach())
        grads.append(x.grad)
    _close(losses[0], losses[1], atol=1e-4)
    _close(grads[0], grads[1], atol=1e-5)


# -- Whisper's attention: encoder flash and the decode step ------------------------


@pytest.mark.parametrize("T", [100, 150])
def test_flash_self_attention_matches_jax_dot_product_attention(T):
    """The plain flash attention against ``jax.nn.dot_product_attention``,
    which the JAX model runs off-TPU, on (B, T, H, d) in fp32."""
    q, k, v = (_np(2, T, 3, 64, seed=i) for i in range(3))
    want = jax.nn.dot_product_attention(*map(jnp.asarray, (q, k, v)))
    got = flash_attention.flash_self_attention(_t(q), _t(k), _t(v))
    assert got.shape == (2, T, 3, 64)
    _close(got, want, atol=1e-5)


def _ancestor_onehot(B, K, T, pos, seed):
    """A beam-search slot mask: query beam k of item b attends, at every
    position t <= pos, the cache slot of a random ancestor beam."""
    rng = np.random.default_rng(seed)
    onehot = np.zeros((B, K, K * T), np.float32)
    for b in range(B):
        for k in range(K):
            for t in range(pos + 1):
                onehot[b, k, rng.integers(K) * T + t] = 1.0
    return onehot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1, 3])
def test_decode_attention_matches_jax_off_tpu(K, dtype):
    """The plain decode self- and cross-attention against the JAX package's own
    off-TPU composition (``interpret=True``), reading layer 1 of stacked
    stores, K = 1 (the causal mask) and K = 3 (a random ancestor mask). fp32
    within 1e-6; bf16 within one bf16 ulp of the output (2**-7 relative at
    |o| < 1), the products' fp32 sums in another order."""
    B, T, S, H, d, L, pos = 2, 12, 40, 4, 16, 3, 7
    q = _np(B * K, H * d, seed=0)
    cache_k, cache_v = _np(L, B * K, T, H * d, seed=1), _np(L, B * K, T, H * d, seed=2)
    cross_k, cross_v = _np(L, B, S, H * d, seed=3), _np(L, B, S, H * d, seed=4)
    onehot = (_ancestor_onehot(B, K, T, pos, seed=5) if K > 1 else
              np.broadcast_to(np.arange(T) <= pos, (B, 1, T)).astype(np.float32))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = lambda a: jnp.asarray(a).astype(jdt)  # noqa: E731
    p = lambda a: torch.from_numpy(np.array(a)).to(tdt)  # noqa: E731
    want_self = jdec.decode_self_attention(j(q), j(cache_k), j(cache_v), jnp.asarray(onehot),
                                           H, jnp.int32(1), interpret=True)
    want_cross = jdec.decode_cross_attention(j(q), j(cross_k), j(cross_v), H, jnp.int32(1),
                                             interpret=True)
    got_self = decode_attention.decode_self_attention(p(q), p(cache_k), p(cache_v),
                                                      torch.from_numpy(onehot), H, 1)
    got_cross = decode_attention.decode_cross_attention(p(q), p(cross_k), p(cross_v), H, 1)
    atol = 1e-6 if dtype == "float32" else 2.0**-7
    for got, want in ((got_self, want_self), (got_cross, want_cross)):
        assert got.dtype == tdt and got.shape == (B * K, H * d)
        _close(got.float(), np.asarray(want.astype(jnp.float32)), atol=atol)


# -- wrappers on the CPU ----------------------------------------------------------


def test_cpu_tensors_run_plain_and_count_no_launch():
    _build.reset_launch_counts()
    x = _t(_np(1, 9, 512, seed=0))
    one, zero = torch.ones(512), torch.zeros(512)
    ln_gelu.ln_gelu(x, one, zero)
    ln_gelu.ln_fused(x, one, zero)
    conv_ln_gelu.conv_ln_gelu(x, torch.zeros(512, 512, 3), zero, one, zero)
    q = _t(_np(1, 9, 128, seed=1))
    attention.short_t_attention_flat(q, q, q, torch.ones(1, 9, dtype=torch.bool), 64,
                                     (zero[:128],) * 3)
    y = torch.zeros(1, 9, 1024, requires_grad=True)
    ffn.ffn_ln_block(y, torch.zeros(256, 1024), zero[:256], torch.ones(1024),
                     torch.zeros(1024), torch.zeros(1024, 256), torch.zeros(1024)).sum().backward()
    lp = torch.log_softmax(torch.zeros(9, 1, 5, requires_grad=True), -1)
    ctc.ctc_loss(lp, torch.ones(1, 2, dtype=torch.long), torch.tensor([9]),
                 torch.tensor([2])).backward()
    qh = torch.zeros(1, 9, 2, 64)
    flash_attention.flash_self_attention(qh, qh, qh)
    cache = torch.zeros(2, 1, 9, 128)
    decode_attention.decode_self_attention(q[0, :1], cache, cache, torch.ones(1, 1, 9), 2, 1)
    decode_attention.decode_cross_attention(q[0, :1], cache, cache, 2, 0)
    assert sum(_build.launch_counts.values()) == 0
    assert _build._lib is None  # nothing was built either
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ln_gelu.ln_gelu(x.to("meta"), one, zero)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel build that fails raises with nvcc's output; nothing is loaded."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*no sm_90a here"):
        _build.library()
    assert _build._lib is None
    assert not list((tmp_path / "build").glob("*.so"))
