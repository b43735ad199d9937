"""The LayerNorm pair's contract after its Hopper redesign, on the CPU.

``ln_fused`` and ``ln_gelu`` take gamma and beta in their own dtype, as the
TPU kernels read them (``coral_tpu/ops/ln_gelu_pallas.py`` ``_fwd_kernel``
and ``_bwd_kernel`` cast them to fp32 inside), and return dgamma and dbeta in
it, as ``_ln_gelu_bwd`` casts its summed partials to ``gamma.dtype``. Here
the port's wrappers (their plain versions, on CPU tensors) are held against
``jax.vjp`` of ``_ln_gelu`` with the Pallas kernels in interpret mode, as
``tests/test_torch_ops.py`` runs it: with bf16 weights, whose gradients come
back in bf16 on both sides, and with fp32 weights, whose fp32 gradients are
the contract of the FFN backward's LayerNorm step. The wrappers call the
forward directly when autograd would record nothing; that path gives the
recorded path's bits, and a remat ``saved`` output still runs nothing.

Tolerances: dx atol 2e-5 (fp32 math whose reductions run in another order);
fp32 dgamma and dbeta atol 1e-4 (sums of ~1000 terms of order 1 in another
order); bf16 dgamma and dbeta one bf16 ulp (2**-7 of the value) on top,
since the fp32 sums of the two sides may round to neighbouring bf16 values.
The card's kernels against these plain versions, and the bit-for-bit
agreement of bf16 and fp32 weights in the kernels, are in
``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.ln_gelu_pallas as jln
from coral_tpu_torch.ops import ln_gelu

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

ATOL = 2e-5
ATOL_SUM = 1e-4
BF16_ULP = 2.0**-7

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}


def _np(*shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(
        np.float32
    )


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(jnp.asarray(want, jnp.float32)), atol=atol, rtol=rtol)


def _inputs(C=128, rows=515):
    x = _np(2, rows, C, seed=1, scale=2.0, offset=0.5)
    gamma = _np(C, seed=2, scale=0.1, offset=1.0)
    beta = _np(C, seed=3, scale=0.1)
    dy = _np(2, rows, C, seed=4)
    return x, gamma, beta, dy


@pytest.mark.parametrize("weights", ["bf16", "fp32"])
@pytest.mark.parametrize("apply_gelu", [True, False], ids=["ln_gelu", "ln_fused"])
def test_ln_forward_and_backward_match_the_jax_vjp_in_the_weights_dtype(apply_gelu, weights):
    """Forward and every cotangent against ``jax.vjp`` of ``_ln_gelu`` in
    interpret mode (ragged last 512-row tile), the weights in bf16 or fp32:
    dgamma and dbeta come back in the weights' dtype on both sides."""
    tdt, jdt = DTYPES[weights]
    x, gamma, beta, dy = _inputs()
    jx, jg, jb = jnp.asarray(x), jnp.asarray(gamma, jdt), jnp.asarray(beta, jdt)
    want_y, vjp = jax.vjp(lambda *a: jln._ln_gelu(*a, True, apply_gelu, 1e-5), jx, jg, jb)
    want = vjp(jnp.asarray(dy))
    args = [torch.from_numpy(x).requires_grad_(True),
            *(torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(tdt)
              .requires_grad_(True) for a in (jg, jb))]
    port = ln_gelu.ln_gelu if apply_gelu else ln_gelu.ln_fused
    y = port(*args)
    y.backward(torch.from_numpy(dy))
    assert want[1].dtype == want[2].dtype == jdt
    assert args[1].grad.dtype == args[2].grad.dtype == tdt
    _close(y, want_y, ATOL)
    _close(args[0].grad, want[0], ATOL)
    rtol = BF16_ULP if weights == "bf16" else 0.0
    _close(args[1].grad, want[1], ATOL_SUM, rtol)
    _close(args[2].grad, want[2], ATOL_SUM, rtol)


@pytest.mark.parametrize("weights", ["bf16", "fp32"])
@pytest.mark.parametrize("apply_gelu", [True, False])
def test_ln_bwd_returns_the_weights_dtype_as_the_jax_bwd(apply_gelu, weights):
    """``ln_bwd`` itself (the FFN backward's LayerNorm step calls it with fp32
    weights): dx in x's dtype, dgamma and dbeta in the weights', against the
    JAX VJP's backward."""
    tdt, jdt = DTYPES[weights]
    x, gamma, beta, dy = _inputs(C=256, rows=77)
    jg, jb = jnp.asarray(gamma, jdt), jnp.asarray(beta, jdt)
    _, vjp = jax.vjp(lambda *a: jln._ln_gelu(*a, True, apply_gelu, 1e-5),
                     jnp.asarray(x), jg, jb)
    want = vjp(jnp.asarray(dy))
    g, b = (torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(tdt) for a in (jg, jb))
    dx, dg, db = ln_gelu.ln_bwd(torch.from_numpy(x), g, b, torch.from_numpy(dy),
                                apply_gelu=apply_gelu)
    assert dx.dtype == torch.float32 and dg.dtype == db.dtype == tdt
    rtol = BF16_ULP if weights == "bf16" else 0.0
    _close(dx, want[0], ATOL)
    _close(dg, want[1], ATOL_SUM, rtol)
    _close(db, want[2], ATOL_SUM, rtol)


def test_bf16_weights_give_the_fp32_sums_rounded_once():
    """The plain backward with bf16 weights: dx as with the same values in
    fp32, dgamma and dbeta the fp32 sums rounded once to bf16 (no second
    rounding through an fp32 result and a cast)."""
    x, gamma, beta, dy = (torch.from_numpy(a) for a in _inputs())
    g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    for gelu in (True, False):
        dx16, dg16, db16 = ln_gelu.ln_bwd_plain(x, g16, b16, dy, apply_gelu=gelu)
        dx32, dg32, db32 = ln_gelu.ln_bwd_plain(x, g16.float(), b16.float(), dy,
                                                apply_gelu=gelu)
        assert torch.equal(dx16, dx32)
        assert torch.equal(dg16, dg32.to(torch.bfloat16))
        assert torch.equal(db16, db32.to(torch.bfloat16))
        assert torch.equal(ln_gelu.ln_gelu_plain(x, g16, b16, apply_gelu=gelu),
                           ln_gelu.ln_gelu_plain(x, g16.float(), b16.float(), apply_gelu=gelu))


class _NoFunction:
    """Stands in for ``_LayerNorm``: the direct path must not reach it."""

    @staticmethod
    def apply(*args):
        raise AssertionError("the direct path went through the autograd Function")


@pytest.mark.parametrize("fn", [ln_gelu.ln_fused, ln_gelu.ln_gelu], ids=["ln_fused", "ln_gelu"])
def test_direct_path_gives_the_functions_bits(fn, monkeypatch):
    """Under ``torch.no_grad`` and with inputs that need no gradient the
    wrappers skip ``_LayerNorm`` and give the bits of the recorded call."""
    x, gamma, beta, _ = (torch.from_numpy(a) for a in _inputs())
    gamma, beta = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    recorded = fn(x.clone().requires_grad_(True), gamma, beta)
    assert recorded.grad_fn is not None
    monkeypatch.setattr(ln_gelu, "_LayerNorm", _NoFunction)
    with torch.no_grad():
        under_no_grad = fn(x.clone().requires_grad_(True), gamma, beta)
    no_grad_inputs = fn(x, gamma, beta)
    assert under_no_grad.grad_fn is None and no_grad_inputs.grad_fn is None
    assert torch.equal(under_no_grad, recorded.detach())
    assert torch.equal(no_grad_inputs, recorded.detach())
    with pytest.raises(AssertionError, match="autograd Function"):
        fn(x, gamma.clone().requires_grad_(True), beta)


def test_saved_output_runs_nothing_on_the_direct_path(monkeypatch):
    """A remat replay's ``saved`` output comes back as it is, whether or not
    autograd records the call, and no forward runs."""
    x, gamma, beta, _ = (torch.from_numpy(a) for a in _inputs())
    saved = torch.full_like(x, 3.0)
    ran = []
    monkeypatch.setattr(ln_gelu, "_ln", lambda *a: ran.append(a))
    monkeypatch.setattr(ln_gelu, "ln_gelu_plain", lambda *a: ran.append(a))
    with torch.no_grad():
        assert torch.equal(ln_gelu.ln_fused(x, gamma, beta, saved=saved), saved)
    assert torch.equal(ln_gelu.ln_fused(x, gamma, beta, saved=saved, plain=True), saved)
    kept = ln_gelu.ln_fused(x.requires_grad_(True), gamma, beta, saved=saved)
    assert torch.equal(kept, saved) and kept.grad_fn is not None
    assert not ran
