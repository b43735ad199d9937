"""coral_tpu_torch's LayerNorm-folded packed QKV projection and bias-free attention, on the CPU.

The routes of ``fused_qkv_ln`` (the pre-attention LayerNorm folded into one
packed (3D, D) projection, ``ln_dense``, whose lane thirds are q, k and v) and
of ``attention_fused_qkv_bias: false`` (the v3-stats attention without
in-kernel biases), which ``fused_qkv_ln`` implies. On the CPU the kernels'
plain versions run. Each is held against the JAX package as its own tests run
it on the CPU, the Pallas kernels in interpret mode: ``ln_dense`` (D 128, F
384 and 300 rows a batch item, a ragged second block of the JAX grid's 256
rows) forward and every cotangent through ``jax.vjp``, and its XLA route below
128; the bias-free attention (2 heads of 64, padded keys and one fully masked
row) forward and cotangents; one encoder layer against the JAX
``EncoderLayer``; the whole model at hidden 128 (at the tiny config's 32 JAX's
``ln_dense`` takes its XLA route) for logits and one step's gradients with
each flag; the weights through ``convert.py``. Then the setups' flag
resolution against the JAX setup and model, and the checkpoint replays'
forward counts and bits under each named policy.

Tolerances, fp32 on both sides with sums in another order: the entry points
within 1e-5 of max |JAX| (forward and cotangents); the encoder layer and the
model's logits within 1e-4 of max |JAX| (tests/test_torch_wav2vec2.py); one
step's loss within 1e-5 relative and each parameter's gradient within 5e-4
of its max |JAX| (CTC through 2 layers in fp32, measured 5.3e-5 at worst);
the k_proj bias, whose gradient is 0 in exact arithmetic (a shift of every
score of a query), below 1e-5 of the v_proj bias's in both packages (measured
7e-9).
"""

import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.attention_pallas as jat
import coral_tpu.ops.ffn_pallas as jffn
from coral_tpu.audio.features import znorm as jax_znorm
from coral_tpu.config import DictConfig
from coral_tpu.models.wav2vec2 import EncoderLayer as JaxEncoderLayer
from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu.ops import ctc_loss as jax_ctc_loss
from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
from coral_tpu_torch.models import wav2vec2
from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from coral_tpu_torch.models.wav2vec2 import REMAT_POLICIES, Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import attention, ffn, ln_gelu
from coral_tpu_torch.training.model_setup import check_kernel_widths, load_model_setup
from coral_tpu_torch.training.train_state import ctc_loss_and_grads
from test_torch_train import BLANK, CHARS, QUIET, VOCAB, _batch
from test_torch_wav2vec2 import (ARCHS, LENGTHS, N_SAMPLES, PORT_FLAGS, PRODUCTION_FLAGS,
                                 _seeded_params)

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

D, F, T = 128, 384, 300
# The two routes' flags, as the setups resolve them (fused_qkv_ln turns the
# in-kernel biases off).
ROUTES = {
    "fused_qkv_ln": dict(fused_qkv_ln=True, attention_fused_qkv_bias=False),
    "qkv_bias_off": dict(attention_fused_qkv_bias=False),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _ln_dense_inputs(seed=0, width=D, out=F, rows=T):
    """x, W (JAX layout (in, out)), b, gamma, beta in fp32."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((2, rows, width)) + 0.2,
              rng.standard_normal((width, out)) * width**-0.5, rng.standard_normal(out) * 0.1,
              rng.standard_normal(width) * 0.1 + 1.0, rng.standard_normal(width) * 0.1]
    return [a.astype(np.float32) for a in arrays]


def _ln_dense_vjp(arrays, jax_fn):
    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, arrays))
    dy = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    leaves = [torch.from_numpy(a.T.copy() if i == 1 else a).requires_grad_(True)
              for i, a in enumerate(arrays)]
    out = ffn.ln_dense(*leaves)
    out.backward(torch.from_numpy(dy))
    grads = [leaf.grad.T if i == 1 else leaf.grad for i, leaf in enumerate(leaves)]
    return out.detach(), want, grads, vjp(jnp.asarray(dy))


def test_ln_dense_matches_jax_interpret(monkeypatch):
    """The forward and all 5 cotangents (dx, dW, db, dgamma, dbeta) against
    ``jax.vjp`` of the JAX ``ln_dense``, its custom VJP's Pallas kernels
    (``_fwd_pallas_lnmm``, ``_bwd_pallas_lnmm``) in interpret mode; the
    port's autograd Function runs the plain versions, once each way."""
    calls = collections.Counter()
    for name in ("ln_dense_plain", "ln_dense_bwd_plain"):
        fn = getattr(ffn, name)
        monkeypatch.setattr(ffn, name, lambda *a, _fn=fn, _n=name, **kw: (
            calls.update([_n]), _fn(*a, **kw))[1])
    arrays = _ln_dense_inputs()
    out, want, grads, want_grads = _ln_dense_vjp(
        arrays, lambda *a: jffn.ln_dense(*a, interpret=True))
    assert out.shape == want.shape == (2, T, F)
    assert _rel(out, want) <= 1e-5
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert _rel(g, w) <= 1e-5, i
    assert calls == {"ln_dense_plain": 1, "ln_dense_bwd_plain": 1}


def test_ln_dense_below_128_takes_the_xla_route(monkeypatch):
    """D 32, F 96: JAX's ``ln_dense`` composes the LayerNorm and the product
    in XLA (``ffn_pallas.py:2007-2012``); so does the port, under autograd,
    with no call of the kernel's wrappers."""
    for name in ("ln_dense_fwd", "ln_dense_bwd"):
        monkeypatch.setattr(ffn, name, lambda *a, **kw: pytest.fail("a kernel wrapper ran"))
    arrays = _ln_dense_inputs(width=32, out=96, rows=37)
    out, want, grads, want_grads = _ln_dense_vjp(
        arrays, lambda *a: jffn.ln_dense(*a, interpret=True))
    assert _rel(out, want) <= 1e-5
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        assert _rel(g, w) <= 1e-5, i


def test_ln_dense_plain_rounds_as_the_kernel():
    """In bf16 the LayerNorm is rounded before the product, the sum + b once
    at the end, as ``_fwd_kernel_lnmm``; the backward's ln_out is that
    rounded LayerNorm (the dW operand), db the fp32 column sums of dy."""
    x, w, b, gamma, beta = (torch.from_numpy(a) for a in _ln_dense_inputs(rows=37))
    xb, wb = x.to(torch.bfloat16), w.t().contiguous().to(torch.bfloat16)
    y = ffn.ln_dense_plain(xb, wb, b, gamma, beta)
    ln = torch.nn.functional.layer_norm(xb.float(), (D,), gamma, beta, 1e-5).to(torch.bfloat16)
    want = (ln.float() @ wb.float().t() + b).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert (y.float() - want.float()).abs().max() <= 2**-7 * want.float().abs().max()
    dy = torch.randn(2, 37, F, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    dx, ln_out, db, dgamma, dbeta = ffn.ln_dense_bwd_plain(xb, wb, gamma, beta, dy)
    assert dx.dtype == ln_out.dtype == torch.bfloat16 and db.dtype == torch.float32
    assert (ln_out.float() - ln.float()).abs().max() <= 2**-7 * ln.float().abs().max()
    torch.testing.assert_close(db, dy.float().sum(dim=(0, 1)))
    dl = dy.float() @ wb.float()
    torch.testing.assert_close(dbeta, dl.sum(dim=(0, 1)))
    assert dgamma.shape == dbeta.shape == (D,)


# -- the attention without in-kernel biases -------------------------------------------


def _attention_inputs(B=3, Tq=75, H=2, d=64):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, Tq, H * d)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, Tq), bool)
    mask[1, Tq // 2 + 3:] = False  # padded keys
    mask[2, :] = False  # a fully masked row, like a lengths=1 filler row
    return q, k, v, mask


def test_bias_free_attention_matches_jax_interpret():
    """``short_t_attention_flat(save_stats="v3", qkv_bias=None)``: the
    forward (``_fwd_pallas_stats_v2``) and its lse, and the three cotangents
    through ``jax.vjp`` (``_bwd_pallas_stats_ctx``), in interpret mode. The
    fully masked row averages v uniformly, its lse is clamped at -1e25 and it
    gets no gradient."""
    q, k, v, mask = _attention_inputs()
    head_dim = 64
    jmask = jnp.asarray(mask)
    fn = lambda q, k, v: jat.short_t_attention_flat(  # noqa: E731
        q, k, v, jmask, head_dim, save_stats="v3", qkv_bias=None, interpret=True)
    want, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    bias = jnp.where(jmask, 0.0, -1e30).astype(jnp.float32)[:, None, :]
    _, want_lse = jat._fwd_pallas_stats_v2(*map(jnp.asarray, (q, k, v)), bias, head_dim**-0.5,
                                           head_dim, True)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o, lse = attention.short_t_attention_flat(*leaves, torch.from_numpy(mask), head_dim)
    assert _rel(o.detach(), want) <= 1e-5
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-6)
    assert (lse[2] == -1e25).all()
    torch.testing.assert_close(o[2].detach(), leaves[2][2].detach().mean(0).expand(75, -1))
    o.backward(torch.from_numpy(do))
    for leaf, w in zip(leaves, vjp(jnp.asarray(do))):
        assert _rel(leaf.grad, w) <= 1e-5
        assert not leaf.grad[2].any()


def test_packed_attention_is_the_flat_one_on_the_lane_thirds():
    """``short_t_attention_packed`` on (B, T, 3HD) = the bias-free flat
    attention on its thirds, forward and backward bit for bit; the gradient
    comes back as one packed tensor; the plain version concatenates."""
    q, k, v, mask = _attention_inputs()
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1)).requires_grad_(True)
    o, lse = attention.short_t_attention_packed(qkv, torch.from_numpy(mask), 64)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o2, lse2 = attention.short_t_attention_flat(*leaves, torch.from_numpy(mask), 64)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    o.backward(do)
    o2.backward(do)
    assert qkv.grad.shape == qkv.shape
    assert torch.equal(qkv.grad, torch.cat([leaf.grad for leaf in leaves], dim=-1))


def test_bias_free_attention_is_the_biased_one_at_zero_biases():
    """bf16 q + 0 rounds to q: the bias-free forward and backward equal the
    biased ones with zero biases bit for bit, the db partials aside."""
    q, k, v, mask = _attention_inputs()
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    key_bias = attention._key_bias(torch.from_numpy(mask))
    zero = torch.zeros(q.shape[-1], dtype=torch.bfloat16)
    o, lse = attention._fwd(q, k, v, None, None, None, key_bias, 64, 0.125)
    o_b, lse_b = attention._fwd(q, k, v, zero, zero, zero, key_bias, 64, 0.125)
    assert torch.equal(o, o_b) and torch.equal(lse, lse_b)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    got = attention.attention_bwd(q, k, v, None, None, None, key_bias, do, lse, o, 64, 0.125)
    want = attention.attention_bwd(q, k, v, zero, zero, zero, key_bias, do, lse, o, 64, 0.125)
    assert got[3] is None and want[3].shape == (3, q.shape[-1])
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)


# -- the encoder layer and the model ------------------------------------------------


def _narrow(route, **kw):
    """The narrow config (hidden 128, 2 heads of 64, FFN 256) on ``route``:
    the JAX config with the production flags, the port's."""
    flags = {**PRODUCTION_FLAGS, **ROUTES[route]}
    return (JaxConfig(**ARCHS["narrow"], **flags, **kw),
            Wav2Vec2Config(**ARCHS["narrow"], **{**PORT_FLAGS, **ROUTES[route]}, **kw))


@pytest.fixture(scope="module")
def narrow_params():
    """Seeded JAX weights per route (the trees of both routes are one shape)."""
    return {route: _seeded_params(JaxModel(_narrow(route)[0]), seed=0) for route in ROUTES}


def _port_model(params, config):
    model = Wav2Vec2ForCTC(config)
    sd = wav2vec2_state_dict_from_jax(params, config)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    return model


def test_encoder_layer_matches_jax(narrow_params):
    """One layer with ``fused_qkv_ln`` against the JAX ``EncoderLayer`` (its
    ``ln_dense`` and bias-free attention in interpret mode): the output and
    the gradients of x and of every parameter through ``jax.vjp``, padded
    keys and a fully masked row (lengths 75, 40, 0)."""
    jcfg, pcfg = _narrow("fused_qkv_ln")
    layer_params = jax.tree.map(lambda a: a[0],
                                narrow_params["fused_qkv_ln"]["wav2vec2"]["encoder"]["layers"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 75, D)).astype(np.float32)
    pad_mask = np.arange(75)[None, :] < np.array([75, 40, 0])[:, None]
    layer = JaxEncoderLayer(jcfg)
    want, vjp = jax.vjp(lambda p, x: layer.apply({"params": p}, x, jnp.asarray(pad_mask),
                                                 True)[0], layer_params, jnp.asarray(x))
    dy = rng.standard_normal(want.shape).astype(np.float32)
    want_params, want_x = vjp(jnp.asarray(dy))

    port = _port_model(narrow_params["fused_qkv_ln"], pcfg).wav2vec2.encoder.layers[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, torch.from_numpy(pad_mask))
    assert _rel(out.detach(), want) <= 1e-4
    out.backward(torch.from_numpy(dy))
    assert _rel(xt.grad, want_x) <= 1e-4
    grads = dict(port.named_parameters())
    flat, _ = jax.tree_util.tree_flatten_with_path(want_params)
    assert len(flat) == len(grads)
    for path, w in flat:
        keys = [str(getattr(p, "key", p)) for p in path]
        leaf = keys[-1]
        name = ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight"}.get(leaf, leaf)])
        g = grads[name].grad
        g = g.T if leaf == "kernel" else g
        if name == "attention.k_proj.bias":  # 0 in exact arithmetic
            v_scale = np.abs(np.asarray(want_params["attention"]["v_proj"]["bias"])).max()
            assert g.abs().max() <= 1e-5 * v_scale
            continue
        assert _rel(g, w) <= 1e-4, name


@pytest.mark.parametrize("route", ROUTES)
def test_model_logits_match_jax(narrow_params, route):
    """The whole model at the narrow config on each route, logits on a full,
    a padded and a filler row; the plain model is the same function."""
    jcfg, pcfg = _narrow(route)
    params = narrow_params[route]
    audio = np.random.default_rng(1).standard_normal((3, N_SAMPLES)).astype(np.float32)
    want, _ = JaxModel(jcfg).apply({"params": params}, jnp.asarray(audio),
                                   jnp.asarray(LENGTHS), deterministic=True)
    model = _port_model(params, pcfg).eval()
    plain = Wav2Vec2ForCTC(pcfg, plain=True).eval()
    plain.load_state_dict(model.state_dict())
    args = torch.from_numpy(audio), torch.from_numpy(LENGTHS).long()
    with torch.inference_mode():
        out = model(*args)
        torch.testing.assert_close(plain(*args), out, rtol=0, atol=0)
    assert _rel(out[0], want) <= 1e-4


def _jax_loss_and_grads(jcfg, params, batch):
    """The JAX step's microbatch loss (z-norm, the model, the CTC sum over the
    microbatch's size) and its gradients, one microbatch, no dropout."""
    model = JaxModel(jcfg)

    def loss_fn(p):
        lengths = jnp.asarray(batch["input_lengths"][0])
        logits, frames = model.apply(
            {"params": p}, jax_znorm(jnp.asarray(batch["input_values"][0]), lengths), lengths,
            deterministic=True)
        log_probs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        loss = jax_ctc_loss(jnp.transpose(log_probs, (1, 0, 2)),
                            jnp.asarray(batch["labels"][0]), frames,
                            jnp.asarray(batch["label_lengths"][0]), blank_id=BLANK,
                            reduction="sum", zero_infinity=True)
        return loss / batch["labels"].shape[1]

    return jax.value_and_grad(loss_fn)(params)


@pytest.mark.parametrize("route", ROUTES)
def test_one_step_gradients_match_jax(narrow_params, route):
    """The loss and every parameter's gradient of one microbatch (2 clips of
    up to 6400 samples, no dropout, SpecAugment off) on each route, against
    ``jax.value_and_grad`` of the JAX step's microbatch loss; the feature
    encoder trains in both."""
    jcfg, pcfg = _narrow(route, vocab_size=VOCAB, **QUIET)
    params = _seeded_params(JaxModel(jcfg), seed=0)
    batch = _batch(A=1, B=2)
    want_loss, want_grads = _jax_loss_and_grads(jcfg, params, batch)
    want = wav2vec2_state_dict_from_jax(want_grads, pcfg)
    model = _port_model(params, pcfg)
    loss, grads = ctc_loss_and_grads(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     torch.Generator().manual_seed(0), BLANK, "sum", False)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert grads.keys() >= want.keys()
    for name, w in want.items():
        if not w.any():  # masked_spec_embed: SpecAugment is off
            assert not grads[name].any(), name
            continue
        if name.endswith("k_proj.bias"):  # 0 in exact arithmetic
            v_scale = want[name.replace("k_proj", "v_proj")].abs().max()
            assert grads[name].abs().max() <= 1e-5 * v_scale and w.abs().max() <= 1e-5 * v_scale
            continue
        assert _rel(grads[name], w) <= 5e-4, name


def test_convert_carries_the_weights_across(narrow_params):
    """The JAX tree under ``fused_qkv_ln`` has the default route's paths and
    shapes (``_DenseParams`` and ``_LayerNormParams`` on the ``nn.Dense`` and
    ``nn.LayerNorm`` paths), and ``convert.py`` maps it onto the port's
    parameters: the packed projection's thirds are q_proj, k_proj, v_proj."""
    def shapes(tree):
        return [(jax.tree_util.keystr(path), np.shape(leaf))
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]

    default = jax.eval_shape(JaxModel(JaxConfig(**ARCHS["narrow"], **PRODUCTION_FLAGS)).init,
                             jax.random.PRNGKey(0), jnp.zeros((1, N_SAMPLES)),
                             jnp.array([N_SAMPLES]))["params"]
    params = narrow_params["fused_qkv_ln"]
    assert shapes(default) == shapes(params)
    model = _port_model(params, _narrow("fused_qkv_ln")[1])
    layers = params["wav2vec2"]["encoder"]["layers"]
    for i, layer in enumerate(model.wav2vec2.encoder.layers):
        for name in ("q_proj", "k_proj", "v_proj"):
            proj = getattr(layer.attention, name)
            np.testing.assert_array_equal(proj.weight.detach().numpy(),
                                          np.asarray(layers["attention"][name]["kernel"][i]).T)
            np.testing.assert_array_equal(proj.bias.detach().numpy(),
                                          np.asarray(layers["attention"][name]["bias"][i]))
        np.testing.assert_array_equal(layer.layer_norm.weight.detach().numpy(),
                                      np.asarray(layers["layer_norm"]["scale"][i]))


# -- the other attention routes and FFN routes under fused_qkv_ln ---------------------


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_fused_qkv_ln_on_the_xla_and_flash_routes_matches_jax(impl):
    """The packed projection feeding the xla attention or the flash kernel
    with segment ids (``wav2vec2.py:586-598``), at the narrow config with the
    unfused FFN, against JAX's ``fused_qkv_ln`` on its xla route (the flash
    route on the valid frames: JAX's flash route lowers only on a TPU)."""
    flags = dict(fused_qkv_ln=True, fused_ffn=False)
    flags.update(attention_fused_qkv_bias=False, fused_ffn_ln=False)
    jcfg = JaxConfig(**ARCHS["narrow"], **{**PRODUCTION_FLAGS, **flags, "attention_impl": "xla"})
    params = _seeded_params(JaxModel(jcfg), seed=0)
    audio = np.random.default_rng(1).standard_normal((3, N_SAMPLES)).astype(np.float32)
    want, frames = JaxModel(jcfg).apply({"params": params}, jnp.asarray(audio),
                                        jnp.asarray(LENGTHS), deterministic=True)
    model = _port_model(params, Wav2Vec2Config(**ARCHS["narrow"], **{
        **PORT_FLAGS, **flags, "attention_impl": impl})).eval()
    with torch.inference_mode():
        logits, _ = model(torch.from_numpy(audio), torch.from_numpy(LENGTHS).long())
    got, want = logits.numpy(), np.asarray(want)
    scale = np.abs(want).max()
    if impl == "flash":
        valid = np.arange(got.shape[1])[None, :] < np.asarray(frames)[:, None]
        got, want = got[valid], want[valid]
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


# -- the setups ----------------------------------------------------------------------


def _config(tmp_path, **flags):
    return {"model": {"type": "wav2vec2", "architecture": "tiny", "characters_to_keep": CHARS,
                      **flags}, "max_seconds_per_example": 1.0, "model_dir": str(tmp_path)}


RESOLVED = ("attention_impl", "fused_qkv_ln", "attention_fused_qkv_bias", "fused_ffn",
            "fused_ffn_ln", "fused_ffn_block", "fused_ffn_block_dw", "fused_ffn_block_fc2",
            "fused_ffn_block_dg")


@pytest.mark.parametrize("impl", ["pallas", "flash", "xla"])
@pytest.mark.parametrize("qkv_bias", [None, True, False], ids=["bias_unset", "bias_on",
                                                                "bias_off"])
@pytest.mark.parametrize("qkv_ln", [False, True], ids=["no_qkv_ln", "qkv_ln"])
def test_qkv_flags_resolve_as_the_jax_setup(tmp_path, impl, qkv_bias, qkv_ln):
    """Every combination of ``fused_qkv_ln`` x ``attention_fused_qkv_bias``
    (unset, true, false) x ``attention_impl``: where the JAX setup or the JAX
    model refuses it (in-kernel biases with the LN fold or off the pallas
    route), the port's setup raises the same ``ValueError``; elsewhere it
    resolves every route flag as the JAX setup."""
    flags = {"attention_impl": impl, "fused_qkv_ln": qkv_ln}
    if qkv_bias is not None:
        flags["attention_fused_qkv_bias"] = qkv_bias
    config = _config(tmp_path, **flags)
    want = jax_load_model_setup(DictConfig(config)).model_config
    try:
        jax.eval_shape(JaxModel(want).init, jax.random.PRNGKey(0), jnp.zeros((1, 4000)),
                       jnp.array([4000]))
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(" ".join(str(err).split()[:3]))):
            load_model_setup(config, device="cpu")
        return
    got = load_model_setup(config, device="cpu").model_config
    assert {k: getattr(got, k) for k in RESOLVED} == {k: getattr(want, k) for k in RESOLVED}


@pytest.mark.parametrize("ffn_flags", [
    {}, {"fused_ffn": False}, {"fused_ffn_ln": False}, {"fused_ffn_block": False},
    {"fused_ffn_ln": False, "fused_ffn_block": False}, {"fused_ffn_block_dw": True},
    {"fused_ffn_block_fc2": True}, {"fused_ffn_block_dg": False},
], ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()) or "ffn_defaults")
def test_fused_qkv_ln_combines_with_every_ffn_route(tmp_path, ffn_flags):
    """``fused_qkv_ln`` with each FFN route the port has: resolved as the JAX
    setup, and one training forward and backward of the tiny model through
    the setup on the CPU (the packed projection on its XLA route at width
    32, the FFN route's plain kernels)."""
    config = _config(tmp_path, fused_qkv_ln=True, **ffn_flags)
    want = jax_load_model_setup(DictConfig(config)).model_config
    setup = load_model_setup(config, device="cpu")
    got = setup.model_config
    assert {k: getattr(got, k) for k in RESOLVED} == {k: getattr(want, k) for k in RESOLVED}
    model = setup.init_params(seed=0)
    batch = _batch(A=1, B=2)
    batch["labels"] = np.where(batch["labels"] == setup.blank_id, 1, batch["labels"])
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(0),
                                     setup.blank_id, "sum", False)
    assert torch.isfinite(loss)
    assert grads["wav2vec2.encoder.layers.0.layer_norm.weight"].any()
    assert grads["wav2vec2.encoder.layers.0.attention.q_proj.bias"].any()


def test_fused_qkv_ln_refusals_match_jax(tmp_path):
    """The post-LN encoder with the LN fold raises ``ValueError`` in both
    setups; explicit in-kernel biases with it raise in the JAX model and the
    port's setup. (The attention variants with it resolve as the JAX setup's:
    tests/test_torch_attention_variants.py.)"""
    config = _config(tmp_path, fused_qkv_ln=True, do_stable_layer_norm=False)
    with pytest.raises(ValueError, match="do_stable_layer_norm"):
        jax_load_model_setup(DictConfig(config))
    with pytest.raises(ValueError, match="do_stable_layer_norm"):
        load_model_setup(config, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        load_model_setup(_config(tmp_path, fused_qkv_ln=True, attention_fused_qkv_bias=True),
                         device="cpu")


def test_kernel_widths_list_the_packed_projection():
    """On the card the packed projection's kernels take D 1024, 1280, 1920:
    every XLS-R config passes with ``fused_qkv_ln``; a width without a kernel
    (512, which every other kernel on the path takes) is refused before
    anything is built."""
    for arch in (Wav2Vec2Config.xls_r_300m, Wav2Vec2Config.xls_r_1b, Wav2Vec2Config.xls_r_2b):
        for route in ROUTES.values():
            check_kernel_widths(arch(**{**PORT_FLAGS, **route}))
    names = [w[0] for w in wav2vec2.kernel_widths(Wav2Vec2Config(fused_qkv_ln=True))]
    assert any("packed QKV" in n for n in names)
    with pytest.raises(NotImplementedError, match="packed QKV.*Queue 2 item 3"):
        check_kernel_widths(Wav2Vec2Config(hidden_size=512, num_attention_heads=8,
                                           intermediate_size=2048, fused_qkv_ln=True))


# -- the checkpoint replays ---------------------------------------------------------

# Forward runs per layer and microbatch under each policy with fused_qkv_ln:
# the packed projection's forward runs again in the replay unless q, k and v
# are all kept (save_qkv_ctx, save_matmul_inputs[_ffn]: the JAX replay runs
# the custom VJP's forward for any lane third it does not keep, such as
# save_qk_ctx's v), the attention forward unless its o and lse are both kept;
# LN1 is in the projection (no ln_fused), the FFN block's forward never
# replays; no checkpointing runs each once.
QKV_FORWARDS = {
    "nothing_saveable": (2, 2), "save_attn_ctx": (2, 2), "save_ctx_act": (2, 2),
    "save_matmul_inputs": (1, 2), "save_matmul_inputs_ffn": (1, 2),
    "save_attn_ctx_lse": (2, 1), "save_qkv_ctx": (1, 1), "save_qk_ctx": (2, 1),
    "dots_saveable": (2, 2), None: (1, 1),
}


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES) + [None])
def test_policies_replay_what_they_do_not_keep(policy, monkeypatch):
    """The narrow config with ``fused_qkv_ln``, dropout 0.1, SpecAugment on and
    the feature encoder training: spies on the plain forwards (the kernels'
    stand-ins on the CPU) count each replay, and the gradients with
    checkpointing are the bits of those without."""
    calls = collections.Counter()

    def spy(module, name, key):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **kw: (calls.update([key(*a)]),
                                                            fn(*a, **kw))[1])

    spy(ffn, "ln_dense_plain", lambda *a: "ln_dense")
    spy(attention, "_fwd_plain", lambda *a: "attention")
    spy(ffn, "ffn_ln_fc1_plain", lambda *a: "ffn")
    spy(ln_gelu, "ln_gelu_plain", lambda *a: "ln_gelu" if a[4] else "ln_fused")
    batch = {k: torch.from_numpy(v) for k, v in _batch(A=2, B=2).items()}
    grads, counts = [], []
    for remat in (policy is not None, False):
        torch.manual_seed(0)  # the same initial weights each time
        model = Wav2Vec2ForCTC(Wav2Vec2Config(
            vocab_size=VOCAB, **ARCHS["narrow"], **{**PORT_FLAGS, **ROUTES["fused_qkv_ln"]},
            activation_dropout=0.1, hidden_dropout=0.1, mask_feature_length=8))
        torch.nn.init.uniform_(model.wav2vec2.masked_spec_embed)
        model.wav2vec2.encoder.gradient_checkpointing = remat
        model.wav2vec2.encoder.remat_policy = policy or "nothing_saveable"
        calls.clear()
        grads.append(ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(5), BLANK,
                                        "sum", False))
        counts.append(dict(calls))
    A, L = 2, ARCHS["narrow"]["num_hidden_layers"]
    packed, attn = QKV_FORWARDS[policy]
    assert counts[0] == {"ln_dense": packed * L * A, "attention": attn * L * A,
                         "ffn": L * A, "ln_gelu": A}, counts[0]
    assert torch.equal(grads[0][0], grads[1][0])
    for k in grads[0][1]:
        assert torch.equal(grads[0][1][k], grads[1][1][k]), k
    assert grads[0][1]["wav2vec2.encoder.layers.0.layer_norm.weight"].any()
