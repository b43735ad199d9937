"""coral_tpu_torch's H100 probes against the JAX package's TPU probes, on the CPU.

The three ``tools/probe_*.py`` modules each time a Pallas kernel; their
ports (``coral_tpu_torch/tools``) hold a plain PyTorch version of every case
beside the kernel's wrapper, and on a CPU tensor the wrappers run those. The
JAX tools run here as the JAX package's own tests run its kernels on the CPU:
their ``pl.pallas_call`` in interpret mode (patched for each test, no JAX
file changes), with ``STEPS`` patched to 2 where a probe has a grid of steps.

- ``fe_bwd``: every mode at B 1, T_in 64, C 512, k 3 and k 2, fp32 (no bf16
  rounding of da on either side). JAX's variants emit per-batch-row dW and
  dvec and a per-slab halo row that the port folds into dx; the test sums
  over the batch and applies JAX's ``_halo_fixup`` where there is more than
  one slab. JAX's ``mm_only`` reads rows past the array without a mask, which
  interpret mode fills with NaN; the port's loaders zero those rows, so its
  ``mm_only`` is its ``no_vpu`` and is held against JAX's ``no_vpu``.
  Tolerance: 1e-5 of max |JAX| (fp32 products of 512-1536 terms in another
  order).
- ``gelu_cost``: the four cases without the mask, bf16 operands with fp32
  sums rounded once to bf16: within one bf16 ulp (2**-7 |JAX|) plus 1e-6.
  The mask case cannot run here (the TPU PRNG has no CPU lowering), so its
  laws are held: 15/16 kept, no rescale, the bits of ``ops/philox.py``.
- ``lane_reduce``: every case, bf16 in and out: ``vpu`` within one bf16 ulp
  plus 1e-6; ``mxu`` plus 1e-3, since its ones product rounds the fp32 rows
  to bf16 first (the MXU's default precision, which the port keeps), and JAX
  on the CPU does not, which shifts a row's means by about 1e-4 of its scale.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from coral_tpu.ops import conv_ln_gelu_pallas as jfe
from coral_tpu_torch.ops import conv_ln_gelu, philox
from coral_tpu_torch.tools import probe_fe_bwd, probe_gelu_cost, probe_lane_reduce

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parent.parent / "tools"


@pytest.fixture
def interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode for the test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _tool(name: str, monkeypatch, **patches):
    """A fresh import of ``tools/<name>.py`` with module attributes patched."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key, value in patches.items():
        monkeypatch.setattr(module, key, value)
    return module


def _rel(got, want):
    scale = np.abs(want).max()
    return np.abs(np.asarray(got) - want).max() / (scale if scale else 1.0)


# -- fe_bwd -------------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 2])
@pytest.mark.parametrize("mode", probe_fe_bwd.MODES)
def test_fe_bwd_modes_match_the_jax_probe(interpret, monkeypatch, mode, k):
    jax_tool = _tool("probe_fe_bwd", monkeypatch)
    B, T_in, C = 1, 64, 512
    T_out = (T_in - k) // 2 + 1
    rng = np.random.default_rng(0)

    def f(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    x, dy, xhat = f(B, T_in, C), f(B, T_out, C), f(B, T_out, C)
    rstd = np.abs(rng.standard_normal((B, T_out, 1))).astype(np.float32)
    w, gamma, beta = f(k, C, C), f(C), f(C)  # w (k, C_in, C_out), the JAX layout
    jax_mode = "no_vpu" if mode == "mm_only" else mode
    dx, dhalo, dw, dvec = jax_tool._bwd_variant(
        *(jnp.asarray(a) for a in (x, w, gamma, beta, xhat, rstd, dy)), k, 1e-5, jax_mode)
    n_fix = dhalo.shape[1] - 1
    if k == 3 and n_fix > 0 and mode != "no_dx":
        dx = jfe._halo_fixup(dx, dhalo, n_fix, True)
    want_dx, want_dw, want_dvec = np.asarray(dx), np.asarray(dw).sum(0), np.asarray(dvec).sum(0)

    t = torch.from_numpy
    got_dx, got_dw, got_dvec = probe_fe_bwd.bwd_variant(
        t(x), t(np.ascontiguousarray(w.transpose(2, 1, 0))), t(gamma), t(beta), t(xhat),
        t(rstd[..., 0]), t(dy), mode)
    assert got_dx.shape == (B, T_in, C) and got_dw.shape == (C, C, k) and got_dvec.shape == (3, C)
    assert _rel(got_dx.numpy(), want_dx) <= 1e-5
    assert _rel(got_dw.numpy().transpose(2, 1, 0), want_dw) <= 1e-5
    assert _rel(got_dvec.numpy(), want_dvec) <= 1e-5
    if mode in ("no_vpu", "no_dvec", "mm_only"):
        assert not got_dvec.any()
    if mode == "no_dw":
        assert not got_dw.any()


def test_fe_bwd_full_is_the_production_backward():
    """``full`` computes ``conv_ln_gelu_bwd_plain`` (on the card: its
    kernels, bit for bit); the no_inter layout moves whole rows of it."""
    B, T_in, k = 2, 601, 3
    rng = np.random.default_rng(1)
    args = [torch.from_numpy((rng.standard_normal(s) * 0.05).astype(np.float32))
            for s in ((B, T_in, 512), (512, 512, k), (512,), (512,))]
    T_out = (T_in - k) // 2 + 1
    xhat, dy = (torch.from_numpy(rng.standard_normal((B, T_out, 512)).astype(np.float32))
                for _ in range(2))
    rstd = torch.from_numpy(np.abs(rng.standard_normal((B, T_out))).astype(np.float32))
    full = probe_fe_bwd.bwd_variant(*args, xhat, rstd, dy, "full")
    want = conv_ln_gelu.conv_ln_gelu_bwd_plain(*args, xhat, rstd, dy)
    for g, w in zip(full, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    split = probe_fe_bwd.bwd_variant(*args, xhat, rstd, dy, "no_inter")[0]
    pairs = (T_in + 1) // 2  # 301: two slabs, the second partial
    s = torch.arange(pairs)
    base = 512 * (s // 256) + s % 256
    assert torch.equal(split[:, base], full[0][:, 2 * s])
    odd = (base + 256 < T_in) & (2 * s + 1 < T_in)
    assert torch.equal(split[:, (base + 256)[odd]], full[0][:, (2 * s + 1)[odd]])


def test_fe_bwd_layer_shapes_and_floor_are_the_jax_tools():
    """Layers 1 and 5 at 10 s (the training batch's clips), the floor at the
    H100's bf16 peak."""
    assert probe_fe_bwd.layer_shape(1, 10.0, 8) == (8, 31999, 15999, 3)
    assert probe_fe_bwd.layer_shape(5, 10.0, 8) == (8, 1999, 999, 2)
    flops = probe_fe_bwd.floor_flops(8, 15999, 3)
    assert flops == 2.0 * 6 * 8 * 15999 * 512 * 512


# -- gelu_cost ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def gelu_inputs():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 256, 1024)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((1024, 4096)) * 0.02, jnp.bfloat16)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    tw = torch.from_numpy(np.asarray(w.astype(jnp.float32)).T.copy()).to(torch.bfloat16)
    return x, w, tx, tw


@pytest.mark.parametrize("name,polys,prng", [c for c in probe_gelu_cost.CASES if not c[2]],
                         ids=[c[0].split()[0] for c in probe_gelu_cost.CASES if not c[2]])
def test_gelu_cost_cases_match_the_jax_probe(interpret, monkeypatch, gelu_inputs, name, polys,
                                             prng):
    jax_tool = _tool("probe_gelu_cost", monkeypatch, STEPS=2)
    x, w, tx, tw = gelu_inputs
    want = np.asarray(jax_tool.run(jnp.zeros((1,), jnp.int32), x, w, polys, False)
                      .astype(jnp.float32))
    got = probe_gelu_cost.gelu_cost(tx, tw, polys, False)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 256, 4096)
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0**-7 * np.abs(want) + 1e-6).all(), err.max()


def test_gelu_cost_prng_case_laws(gelu_inputs):
    """15/16 of the elements kept, unscaled (the matmul-only output's), where
    ``ops/philox.py``'s bits for (seed, row, column) are at least 2**28."""
    _, _, tx, tw = gelu_inputs
    seed = 7
    got = probe_gelu_cost.gelu_cost(tx, tw, (), True, seed=seed)
    plain = probe_gelu_cost.gelu_cost(tx, tw, (), False)
    bits = philox.dropout_bits(torch.tensor([seed], dtype=torch.int32), 512, 4096)[0]
    keep = (bits >= 2**28).reshape(2, 256, 4096)
    assert abs(keep.float().mean().item() - 15 / 16) < 2e-3
    assert torch.equal(got, torch.where(keep, plain, torch.zeros((), dtype=plain.dtype)))
    assert not torch.equal(keep, (philox.dropout_bits(torch.tensor([seed + 1], dtype=torch.int32),
                                                      512, 4096)[0] >= 2**28).reshape(keep.shape))
    with pytest.raises(ValueError, match="cases"):
        probe_gelu_cost.gelu_cost(tx, tw, (13,), True)


# -- lane_reduce --------------------------------------------------------------------


@pytest.mark.parametrize("nred,mode", probe_lane_reduce.CASES,
                         ids=[f"{m}-{n}" for n, m in probe_lane_reduce.CASES])
def test_lane_reduce_cases_match_the_jax_probe(interpret, monkeypatch, gelu_inputs, nred, mode):
    jax_tool = _tool("probe_lane_reduce", monkeypatch, STEPS=2)
    x, _, tx, _ = gelu_inputs
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((1024, 1024)) * 0.02, jnp.bfloat16)
    ones = jnp.ones((1024, 128), jnp.bfloat16)
    want = np.asarray(jax_tool.run(x, w, ones, mode, nred).astype(jnp.float32))
    tw = torch.from_numpy(np.asarray(w.astype(jnp.float32)).T.copy()).to(torch.bfloat16)
    got = probe_lane_reduce.lane_reduce(tx, tw, torch.ones((1024, 128), dtype=torch.bfloat16),
                                        mode, nred)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 256, 1024)
    err = np.abs(got.float().numpy() - want)
    atol = 1e-3 if mode == "mxu" else 1e-6
    assert (err <= 2.0**-7 * np.abs(want) + atol).all(), err.max()
