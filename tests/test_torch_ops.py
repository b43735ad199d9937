"""coral_tpu_torch.ops against coral_tpu.ops: each kernel module of the port.

On the CPU each port wrapper runs its kernel's plain PyTorch version; here it
is held against the JAX function on the same inputs (made by numpy from a
seed), in fp32, where the point is the algorithm. The JAX side runs as the JAX
package's own CPU tests run it: Pallas kernels in interpret mode, or the
off-TPU path. Tolerances: atol 2e-5, the bound the JAX package's own op tests
use (tests/test_conv_ln_gelu.py, tests/test_ffn_pallas.py): fp32 math whose
reductions run in another order.
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
import coral_tpu.ops.ffn_pallas as jffn
import coral_tpu.ops.gelu_dropout_pallas as jgelu
import coral_tpu.ops.ln_gelu_pallas as jln
from coral_tpu_torch.ops import _build, attention, conv_ln_gelu, ffn, gelu_poly, ln_gelu

ATOL = 2e-5


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
    y = torch.zeros(1, 9, 1024)
    ffn.ffn_ln_block(y, torch.zeros(256, 1024), zero[:256], torch.ones(1024),
                     torch.zeros(1024), torch.zeros(1024, 256), torch.zeros(1024))
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
