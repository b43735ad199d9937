"""The port's kernel widths: every model config of the repository, on the CPU.

The setups refuse, before they build a model, a width that no kernel on the
path was built for (``check_kernel_widths``); every ``config/model/*.yaml``
passes, with the architecture the JAX setup infers from it. The plain
versions at the widths the kernels gained (head_dim 80 and 120, D and C =
384 and 1920) are held against the JAX functions with the Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerances. fp32 (the FFN block, the LayerNorm): atol 2e-5 for outputs and
dx, 1e-4 for gradients summed over rows, as tests/test_torch_ops.py (fp32
sums in another order). The attention runs in bf16, as on the card, since
the point there is the rounding of q at scales that are not exact in bf16:
lse (fp32, read from scores of the rounded q and k) within 2e-6 relative,
and o, dq, dk, dv within two bf16 ulps (2**-6 relative) plus 2**-8 of
max|want| for values near zero, which a sum of products rounded once to bf16
in another order can move by one ulp.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import coral_tpu.ops.attention_pallas as jat
import coral_tpu.ops.ffn_pallas as jffn
import coral_tpu.ops.ln_gelu_pallas as jln
import coral_tpu.training.model_setup as jax_setup
from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from coral_tpu_torch.ops import attention, ffn, ln_gelu
from coral_tpu_torch.training import model_setup as port_setup
from test_torch_wav2vec2 import PORT_FLAGS

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "config" / "model").glob("*.yaml"))
WIDTHS = {"wav2vec2": ("hidden_size", "num_hidden_layers", "num_attention_heads",
                       "intermediate_size", "conv_dim"),
          "whisper": ("d_model", "encoder_layers", "decoder_layers", "encoder_attention_heads",
                      "decoder_attention_heads", "ffn_dim", "num_mel_bins")}


def _np(*shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(
        np.float32
    )


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _close(got, want, atol=2e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _close_bf16(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = 2.0**-8 * np.abs(want).max() + 2.0**-6 * np.abs(want)
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _config(path: Path) -> dict:
    return {"model": yaml.safe_load(path.read_text()), "max_seconds_per_example": 10.0}


def test_every_model_config_is_here():
    assert len(CONFIGS) == 11


# The FFN flag pairs of the routes without the block or the folded LayerNorm,
# and the route each family takes (no config in config/model/ sets them).
FFN_FLAGS = {
    "fused_ffn_ln_false": ({"fused_ffn_ln": False},
                           {"wav2vec2": "ffn_block", "whisper": "ffn_ln_block"}),
    "fused_ffn_block_false": ({"fused_ffn_block": False},
                              {"wav2vec2": "ffn_ln_fc1", "whisper": "ffn_ln_fc1"}),
    "both_false": ({"fused_ffn_ln": False, "fused_ffn_block": False},
                   {"wav2vec2": "ffn_fc1", "whisper": "ffn_fc1"}),
}
WIDTH_CASES = [pytest.param(p, None, id=p.stem) for p in CONFIGS] + [
    pytest.param(p, name, id=f"{p.stem}-{name}") for p in CONFIGS for name in FFN_FLAGS]


@pytest.mark.parametrize("path,ffn_flags", WIDTH_CASES)
def test_every_config_passes_the_width_check_on_the_card(path, ffn_flags):
    """The setup on ``cuda`` (nothing is built, so no card is needed) takes
    the config, with the widths of the architecture the JAX setup infers, at
    the default kernel flags and with each FFN flag pair (on its route)."""
    config = _config(path)
    kind = config["model"]["type"]
    if ffn_flags is not None:
        flags, routes = FFN_FLAGS[ffn_flags]
        config["model"].update(flags)
    setup = port_setup.load_model_setup(config, device="cuda")
    if ffn_flags is not None:
        assert setup.model_config.ffn_route == routes[kind]
    if kind == "wav2vec2":
        want = jax_setup.Wav2Vec2Setup._infer_arch(config["model"])()
    else:
        want = jax_setup.WhisperSetup._infer_arch(config["model"])[0]()
    for field in WIDTHS[kind]:
        got, expected = getattr(setup.model_config, field), getattr(want, field)
        if field == "conv_dim":
            got, expected = tuple(got), tuple(expected)
        assert got == expected, field
    port_setup.check_kernel_widths(setup.model_config)


def _refuses(monkeypatch, config, arch_table, key, factory):
    """The setup on the card raises NotImplementedError naming Queue 2 item 3
    and builds nothing; on the CPU it takes the same config."""
    built = []
    monkeypatch.setattr(port_setup, "build_model", lambda *a, **k: built.append(a))
    monkeypatch.setattr(port_setup.W, "build_model", lambda *a, **k: built.append(a))
    if isinstance(arch_table, dict):
        monkeypatch.setitem(arch_table, key, factory)
    else:
        monkeypatch.setattr(port_setup, "_WHISPER_ARCHS", [(key, factory)])
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 2 item 3"):
        port_setup.load_model_setup(config, device="cuda")
    assert not built
    port_setup.load_model_setup(config, device="cpu")


@pytest.mark.parametrize("widths", [
    {"hidden_size": 1000, "num_attention_heads": 10, "intermediate_size": 4000},
    {"hidden_size": 1920, "num_attention_heads": 20, "intermediate_size": 7680},
    {"hidden_size": 1280, "num_attention_heads": 16, "intermediate_size": 5000},
], ids=["hidden_1000", "head_dim_96", "ffn_not_a_multiple_of_256"])
def test_wav2vec2_setup_refuses_an_unported_width_before_building(monkeypatch, widths):
    config = _config(CONFIGS[0].parent / "wav2vec2-large.yaml")
    _refuses(monkeypatch, config, port_setup._W2V2_ARCHS, "2b",
             lambda **kw: Wav2Vec2Config(**widths, **kw))


@pytest.mark.parametrize("widths", [
    {"d_model": 640, "encoder_attention_heads": 10, "decoder_attention_heads": 10},
    {"d_model": 768, "encoder_attention_heads": 8, "decoder_attention_heads": 8},
], ids=["d_model_640", "head_dim_96"])
def test_whisper_setup_refuses_an_unported_width_before_building(monkeypatch, widths):
    config = _config(CONFIGS[0].parent / "whisper-small.yaml")
    _refuses(monkeypatch, config, None, "small",
             lambda **kw: port_setup.W.WhisperConfig(**widths, ffn_dim=3072, **kw))


# -- the plain versions at the new widths against JAX in interpret mode ----------------


def _attention_inputs(head_dim, B=3, T=24, H=2):
    q, k, v = (_np(B, T, H * head_dim, seed=i) for i in range(3))
    bias = tuple(_np(H * head_dim, seed=3 + i, scale=0.5) for i in range(3))
    # Round to bf16 once, so that both packages start from the same values.
    q, k, v, *bias = (np.asarray(_t(a, torch.bfloat16).float()) for a in (q, k, v, *bias))
    mask = np.ones((B, T), bool)
    mask[1, 15:] = False  # padded keys
    mask[2, :] = False  # a fully padded row
    return q, k, v, tuple(bias), mask


@pytest.mark.parametrize("head_dim", [80, 120])
def test_attention_at_xls_r_head_dims_matches_jax_interpret(head_dim):
    """bf16 forward and backward at XLS-R-1B's and -2B's head dims, with the
    q/k/v biases, padded keys and a fully padded row."""
    q, k, v, qkv_bias, mask = _attention_inputs(head_dim)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, *qkv_bias)]
    fn = lambda q, k, v, *b: jat.short_t_attention_flat(  # noqa: E731
        q, k, v, jnp.asarray(mask), head_dim, save_stats="v3", qkv_bias=b, interpret=True)
    want_o, vjp = jax.vjp(fn, *jargs)
    key_bias = jnp.where(jnp.asarray(mask), 0.0, -1e30).astype(jnp.float32)[:, None, :]
    _, want_lse = jat._fwd_pallas_stats_v2_qb(*jargs, key_bias, float(head_dim) ** -0.5,
                                              head_dim, True)
    do = _np(*q.shape, seed=9)
    want = vjp(jnp.asarray(do, jnp.bfloat16))

    args = [_t(a, torch.bfloat16).requires_grad_(True) for a in (q, k, v, *qkv_bias)]
    o, lse = attention.short_t_attention_flat(*args[:3], torch.from_numpy(mask), head_dim,
                                              tuple(args[3:]))
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-6, atol=0)
    assert (lse[2] == -1e25).all()
    _close_bf16(o.float().detach(), np.asarray(want_o, np.float32))
    o.backward(_t(do, torch.bfloat16))
    for a, w in zip(args[:3], want[:3]):
        _close_bf16(a.grad.float(), np.asarray(w, np.float32))
        assert not a.grad[2].any()  # the fully padded row gets no gradient
    for a, w in zip(args[3:], want[3:]):
        _close_bf16(a.grad.float(), np.asarray(w, np.float32))


@pytest.mark.parametrize("D", [384, 1920])
def test_ffn_block_at_whisper_tiny_and_xls_r_2b_widths_matches_jax_interpret(D):
    """The plain FFN block forward and backward at D = 384 and 1920 (F = 256,
    16 rows, rate 0) against ``jax.vjp`` of the JAX block in interpret mode."""
    F = 256
    jx = [_np(1, 16, D, seed=0, offset=0.3), _np(D, F, seed=1, scale=D**-0.5),
          _np(F, seed=2, scale=0.1), _np(D, seed=3, scale=0.1, offset=1.0),
          _np(D, seed=4, scale=0.1), _np(F, D, seed=5, scale=F**-0.5), _np(D, seed=6, scale=0.1)]
    dy = _np(1, 16, D, seed=7)
    want, vjp = jax.vjp(lambda *a: jffn.ffn_ln_block(*a, interpret=True, dg_in_kernel=True),
                        *map(jnp.asarray, jx))
    want_grads = vjp(jnp.asarray(dy))
    transposed = (1, 5)  # W1, W2: JAX (in, out), the port (out, in)
    args = [_t(a.T if i in transposed else a).requires_grad_(True) for i, a in enumerate(jx)]
    out = ffn.ffn_ln_block(*args)
    _close(out.detach(), want)
    out.backward(_t(dy))
    _close(args[0].grad, want_grads[0])
    for i in range(1, 7):
        got = args[i].grad.T if i in transposed else args[i].grad
        _close(got, want_grads[i], atol=1e-4)


@pytest.mark.parametrize("C", [384, 1920])
def test_ln_at_whisper_tiny_and_xls_r_2b_widths_matches_jax_interpret(C):
    """``ln_fused`` forward and backward at C = 384 and 1920 against
    ``jax.vjp`` of the custom-VJP ``_ln_gelu`` in interpret mode (a ragged
    last row tile of 37 rows)."""
    x = _np(1, 37, C, seed=1, scale=2.0, offset=0.5)
    gamma = _np(C, seed=2, scale=0.1, offset=1.0)
    beta = _np(C, seed=3, scale=0.1)
    dy = _np(1, 37, C, seed=4)
    want, vjp = jax.vjp(lambda *a: jln._ln_gelu(*a, True, False, 1e-5),
                        *map(jnp.asarray, (x, gamma, beta)))
    want_grads = vjp(jnp.asarray(dy))
    args = [_t(a).requires_grad_(True) for a in (x, gamma, beta)]
    out = ln_gelu.ln_fused(*args)
    _close(out.detach(), want)
    out.backward(_t(dy))
    _close(args[0].grad, want_grads[0])
    _close(args[1].grad, want_grads[1], atol=1e-4)
    _close(args[2].grad, want_grads[2], atol=1e-4)


def test_kernel_width_tables_cover_every_config():
    """The tables the check reads are the kernels' own: each config width is
    in them, and the widths the kernels gained in this slice are there."""
    assert {384, 512, 768, 1920} <= set(ffn.KERNEL_D)
    assert {1280, 1920} <= set(ln_gelu.KERNEL_C[torch.bfloat16])
    assert {384, 768, 1920} <= set(ln_gelu.KERNEL_C_BWD[torch.bfloat16])
    assert {80, 120} <= set(attention.KERNEL_HEAD_DIMS)
    for factory in (Wav2Vec2Config.xls_r_300m, Wav2Vec2Config.xls_r_1b, Wav2Vec2Config.xls_r_2b):
        port_setup.check_kernel_widths(factory(**PORT_FLAGS))
    with pytest.raises(NotImplementedError, match="Queue 2 item 3"):
        port_setup.check_kernel_widths(Wav2Vec2Config.tiny(**PORT_FLAGS))
