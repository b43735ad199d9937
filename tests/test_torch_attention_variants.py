"""coral_tpu_torch's other attention routes, on the CPU.

The routes ``short_t_attention_flat`` picks besides v3
(coral_tpu/ops/attention_pallas.py:1417-1439): ``attention_save_stats``
false (the forward without stats, the backward that recomputes the softmax),
false with ``attention_o_residual`` (that backward's delta from the saved o),
true (v1: p normalised before its rounding; the backward from the lse alone)
and "v2" (v3's forward, the lse-only backward). On the CPU the kernels' plain
versions run. Each is held against the JAX package, its Pallas kernels in
interpret mode as its own tests run them:

- the entry points, flat and packed (B 3, T 56, 4 heads of 16; lengths 56,
  37 and a fully masked row), in fp32: o and, where the route emits one, lse
  within 1e-5; dq, dk, dv through ``jax.vjp`` within 1e-4 of max |JAX|; the
  masked row's gradients exact zeros on the stats routes (p rebuilt from the
  lse clamped at -1e25) and JAX's nonzero values on the others (p = 1/T from
  the row's own max and sum);
- the tiny model's logits (1e-4 of max |JAX|, as tests/test_torch_wav2vec2.py)
  and one microbatch's loss (1e-5 relative) and gradients (5e-4 of each max
  |JAX|, as tests/test_torch_qkv_ln.py) on each route, the weights through
  ``wav2vec2_state_dict_from_jax``;
- the attention forward's runs per layer under each remat policy, counted in
  the JAX gradient's jaxpr and by a spy on the port's plain forward, with the
  same gradients, bit for bit, with and without checkpointing;
- the setups' resolution of ``attention_impl`` x ``attention_save_stats`` x
  ``attention_o_residual`` x ``fused_qkv_ln`` x ``attention_fused_qkv_bias``
  against the JAX setup and model (their ``ValueError``s), and both config
  dataclasses' defaults against the JAX ones, field by field.
"""

import collections
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.attention_pallas as jat
from coral_tpu.config import DictConfig
from coral_tpu.models import whisper as JW
from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
from coral_tpu_torch.models import whisper as PW
from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from coral_tpu_torch.models.wav2vec2 import REMAT_POLICIES, Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import attention
from coral_tpu_torch.training.model_setup import load_model_setup
from coral_tpu_torch.training.train_state import ctc_loss_and_grads
from test_torch_qkv_ln import _jax_loss_and_grads, _port_model, _rel
from test_torch_train import BLANK, CHARS, QUIET, VOCAB, _batch
from test_torch_wav2vec2 import LENGTHS, N_SAMPLES, PORT_FLAGS, PRODUCTION_FLAGS, _seeded_params

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

# The four routes by the JAX keywords, and the port's route names.
VARIANTS = {
    "false": dict(save_stats=False, o_residual=False),
    "o_residual": dict(save_stats=False, o_residual=True),
    "true": dict(save_stats=True, o_residual=False),
    "v2": dict(save_stats="v2", o_residual=False),
}
ROUTE = {"false": "attention", "o_residual": "ctx", "true": "stats", "v2": "stats_v2"}
# The JAX forward kernels that emit the lse, by variant.
JAX_LSE_FORWARD = {"true": jat._fwd_pallas_stats, "v2": jat._fwd_pallas_stats_v2}
# The JAX forward kernel each variant's custom VJP runs.
JAX_FORWARD_KERNEL = {"false": "_fwd_kernel", "o_residual": "_fwd_kernel",
                      "true": "_fwd_kernel_stats", "v2": "_fwd_kernel_stats_v2"}
HEAD_DIM = 16


def _config_flags(variant):
    """The model config's attention flags of ``variant`` (no in-kernel biases:
    they need v3)."""
    flags = VARIANTS[variant]
    return dict(attention_save_stats=flags["save_stats"],
                attention_o_residual=flags["o_residual"], attention_fused_qkv_bias=False)


def _inputs(B=3, T=56, H=4):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, T, H * HEAD_DIM)).astype(np.float32) for _ in range(3))
    mask = np.arange(T)[None, :] < np.array([T, 37, 0])[:, None]  # full, padded, fully masked
    do = rng.standard_normal((B, T, H * HEAD_DIM)).astype(np.float32)
    return q, k, v, mask, do


@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_entry_point_matches_jax_interpret(variant, packed):
    """o, lse and the three cotangents against ``short_t_attention_flat`` in
    interpret mode; the packed entry point on the lane thirds of one
    projection gives one packed gradient."""
    q, k, v, mask, do = _inputs()
    jmask = jnp.asarray(mask)
    fn = lambda q, k, v: jat.short_t_attention_flat(  # noqa: E731
        q, k, v, jmask, HEAD_DIM, interpret=True, **VARIANTS[variant])
    want, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    if packed:
        leaf = torch.from_numpy(np.concatenate([q, k, v], axis=-1)).requires_grad_(True)
        o, lse = attention.short_t_attention_packed(leaf, torch.from_numpy(mask), HEAD_DIM,
                                                    **VARIANTS[variant])
    else:
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        o, lse = attention.short_t_attention_flat(*leaves, torch.from_numpy(mask), HEAD_DIM,
                                                  **VARIANTS[variant])
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), atol=1e-5)
    if variant in JAX_LSE_FORWARD:
        bias = jnp.where(jmask, 0.0, -1e30).astype(jnp.float32)[:, None, :]
        _, want_lse = JAX_LSE_FORWARD[variant](*map(jnp.asarray, (q, k, v)), bias,
                                                HEAD_DIM**-0.5, HEAD_DIM, True)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)
        assert (lse[2] == -1e25).all()
    else:
        assert lse is None
    o.backward(torch.from_numpy(do))
    grads = leaf.grad.chunk(3, dim=-1) if packed else [t.grad for t in leaves]
    for g, w in zip(grads, want_grads):
        assert _rel(g, w) <= 1e-4
        if variant in ("true", "v2"):
            assert not g[2].any() and not np.asarray(w)[2].any()
        else:  # the uniform average's gradients, JAX's values within the bound above
            assert g[2].abs().max() > 0.1 * np.abs(np.asarray(w)).max()


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_backward_is_the_jax_kernels_formula(variant):
    """``attention_bwd_plain`` on the route against the JAX backward kernel
    called alone, from the same forward's residuals, and ``attention_bwd``
    (the wrapper) on a CPU tensor is that plain version."""
    q, k, v, mask, do = _inputs()
    route = ROUTE[variant]
    bias = jnp.where(jnp.asarray(mask), 0.0, -1e30).astype(jnp.float32)[:, None, :]
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    scale = HEAD_DIM**-0.5
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    key_bias = attention._key_bias(torch.from_numpy(mask))
    o, lse = attention._fwd(tq, tk, tv, None, None, None, key_bias, HEAD_DIM, scale, route)
    if variant == "false":
        want = jat._bwd_pallas(jq, jk, jv, bias, jdo, scale, HEAD_DIM, True)
    elif variant == "o_residual":
        want = jat._bwd_ctx_pallas(jq, jk, jv, bias, jdo, jnp.asarray(o.numpy()), scale,
                                   HEAD_DIM, True)
    else:
        want = jat._bwd_pallas_stats(jq, jk, jv, bias, jdo, jnp.asarray(lse.numpy()), scale,
                                     HEAD_DIM, True)
    args = (tq, tk, tv, None, None, None, key_bias, tdo, lse, o, HEAD_DIM, scale)
    got = attention.attention_bwd_plain(*args, route=route)
    assert got[3] is None
    for g, w in zip(got[:3], want):
        assert _rel(g, w) <= 1e-5
    for g, w in zip(attention.attention_bwd(*args, route=route)[:3], got[:3]):
        assert torch.equal(g, w)


def test_v1_rounds_the_normalised_probabilities():
    """In bf16 v1's o is ``bf16(e / l) v`` and the others' ``bf16(e) v / l``:
    the two differ, and each is its own formula computed directly."""
    q, k, v, mask, _ = _inputs()
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    o_v1, lse_v1 = attention.attention_plain(tq, tk, tv, tmask, HEAD_DIM, route="stats")
    o_v2, lse_v2 = attention.attention_plain(tq, tk, tv, tmask, HEAD_DIM, route="stats_v2")
    o_ns, lse_ns = attention.attention_plain(tq, tk, tv, tmask, HEAD_DIM, route="attention")
    assert torch.equal(lse_v1, lse_v2) and lse_ns is None and torch.equal(o_ns, o_v2)
    assert not torch.equal(o_v1, o_v2)
    scale = torch.tensor(HEAD_DIM**-0.5, dtype=torch.bfloat16)
    heads = [t.view(3, 56, 4, HEAD_DIM).transpose(1, 2).float() for t in (tq * scale, tk, tv)]
    s = heads[0] @ heads[1].transpose(-1, -2) + attention._key_bias(tmask)[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    want = (p @ heads[2]).to(torch.bfloat16).transpose(1, 2).reshape(3, 56, 4 * HEAD_DIM)
    assert (o_v1.float() - want.float()).abs().max() <= 2.0**-8


# -- the model ------------------------------------------------------------------------


def _tiny(variant, **kw):
    """The tiny config on ``variant``'s route, otherwise at the setups'
    production flags: the JAX config and the port's."""
    flags = _config_flags(variant)
    return (JaxConfig.tiny(**{**PRODUCTION_FLAGS, **flags}, **kw),
            Wav2Vec2Config.tiny(**{**PORT_FLAGS, **flags}, **kw))


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_logits_match_jax(variant):
    """The tiny model on each route: logits on a full, a padded and a filler
    row against the JAX model's; the plain model is the same function."""
    jcfg, pcfg = _tiny(variant)
    params = _seeded_params(JaxModel(jcfg), seed=0)
    audio = np.random.default_rng(1).standard_normal((3, N_SAMPLES)).astype(np.float32)
    want, _ = JaxModel(jcfg).apply({"params": params}, jnp.asarray(audio),
                                   jnp.asarray(LENGTHS), deterministic=True)
    model = _port_model(params, pcfg).eval()
    assert model.wav2vec2.encoder.layers[0].attention.route == ROUTE[variant]
    plain = Wav2Vec2ForCTC(pcfg, plain=True).eval()
    plain.load_state_dict(model.state_dict())
    args = torch.from_numpy(audio), torch.from_numpy(LENGTHS).long()
    with torch.inference_mode():
        out = model(*args)
        torch.testing.assert_close(plain(*args), out, rtol=0, atol=0)
    assert _rel(out[0], want) <= 1e-4


@pytest.mark.parametrize("qkv_ln", [False, True], ids=["flat", "fused_qkv_ln"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_one_step_gradients_match_jax(variant, qkv_ln):
    """The loss and every parameter's gradient of one microbatch (2 clips of
    up to 6400 samples, no dropout, SpecAugment off) on each route, with the
    projections apart and with ``fused_qkv_ln`` (the packed entry point; JAX's
    ``ln_dense`` on its XLA route at width 32), against
    ``jax.value_and_grad`` of the JAX step's microbatch loss."""
    jcfg, pcfg = _tiny(variant, vocab_size=VOCAB, fused_qkv_ln=qkv_ln, **QUIET)
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


# -- the checkpoint replays ------------------------------------------------------------

# The attention forward's runs per layer and microbatch, by policy, for
# (false, o_residual, true, v2), as the JAX gradient's jaxpr has them: false
# and o_residual name o "attn_ctx" (on the op's output, or on its residual),
# so a policy that keeps it skips the forward; v2's backward also reads its
# lse, "attn_lse", so both must be kept; v1's lse has no name, so its forward
# runs again under every policy, and dots_saveable keeps no kernel's output.
# No checkpointing runs it once.
FORWARD_RUNS = {
    "nothing_saveable": (2, 2, 2, 2),
    "save_attn_ctx": (1, 1, 2, 2),
    "save_ctx_act": (1, 1, 2, 2),
    "save_attn_ctx_lse": (1, 1, 2, 1),
    "save_qkv_ctx": (1, 1, 2, 1),
    "save_qk_ctx": (1, 1, 2, 1),
    "save_matmul_inputs": (1, 1, 2, 2),
    "save_matmul_inputs_ffn": (1, 1, 2, 2),
    "dots_saveable": (2, 2, 2, 2),
    None: (1, 1, 1, 1),
}


def _pallas_kernels(jaxpr, counts):
    """Counts the Pallas kernels (by function name) of a jaxpr and its
    sub-jaxprs (the scan over layers, the remat replay)."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            src = eqn.params["jaxpr"].debug_info.func_src_info
            counts[src.split(" ")[0]] += 1
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    _pallas_kernels(sub.jaxpr, counts)
                elif hasattr(sub, "eqns"):
                    _pallas_kernels(sub, counts)
    return counts


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES) + [None])
@pytest.mark.parametrize("variant", VARIANTS)
def test_policies_replay_the_forward_as_jax(variant, policy, monkeypatch):
    """The tiny config at dropout 0.1 with SpecAugment on: the JAX gradient's
    jaxpr holds the route's forward kernel ``FORWARD_RUNS`` times (the scan's
    body once, the remat replay's again); a spy on the port's plain forward
    counts the same per layer and microbatch, and the gradients with
    checkpointing are the bits of those without."""
    want = FORWARD_RUNS[policy][list(VARIANTS).index(variant)]
    jcfg, _ = _tiny(variant, vocab_size=VOCAB)
    jmodel = JaxModel(jcfg, gradient_checkpointing=policy is not None,
                      remat_policy=policy or "nothing_saveable")
    x, lengths = jnp.zeros((1, N_SAMPLES)), jnp.array([N_SAMPLES])
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, lengths)

    def loss(p):
        return jmodel.apply(p, x, lengths, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1),
                                  "spec_augment": jax.random.PRNGKey(2)})[0].sum()

    counts = _pallas_kernels(jax.make_jaxpr(jax.grad(loss))(params).jaxpr, collections.Counter())
    assert counts[JAX_FORWARD_KERNEL[variant]] == want, counts

    calls = collections.Counter()
    fwd = attention._fwd_plain
    monkeypatch.setattr(attention, "_fwd_plain",
                        lambda *a, **kw: (calls.update(["attention"]), fwd(*a, **kw))[1])
    batch = {k: torch.from_numpy(v) for k, v in _batch(A=2, B=2).items()}
    grads, runs = [], []
    for remat in (policy is not None, False):
        torch.manual_seed(0)  # the same initial weights each time
        model = Wav2Vec2ForCTC(_tiny(variant, vocab_size=VOCAB, activation_dropout=0.1,
                                     hidden_dropout=0.1, mask_feature_length=8)[1])
        torch.nn.init.uniform_(model.wav2vec2.masked_spec_embed)
        model.wav2vec2.encoder.gradient_checkpointing = remat
        model.wav2vec2.encoder.remat_policy = policy or "nothing_saveable"
        calls.clear()
        grads.append(ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(5), BLANK,
                                        "sum", False))
        runs.append(calls["attention"])
    A, L = 2, model.config.num_hidden_layers
    assert runs == [want * L * A, L * A]
    assert torch.equal(grads[0][0], grads[1][0])
    for k in grads[0][1]:
        assert torch.equal(grads[0][1][k], grads[1][1][k]), k


# -- the setups and the config dataclasses ---------------------------------------------

RESOLVED = ("attention_impl", "attention_save_stats", "attention_o_residual", "fused_qkv_ln",
            "attention_fused_qkv_bias", "fused_ffn", "fused_ffn_ln", "fused_ffn_block",
            "fused_ffn_block_dw", "fused_ffn_block_fc2", "fused_ffn_block_dg")


def _jax_resolution(config):
    """The JAX setup's model config, or the ``ValueError`` its setup or its
    model (traced once by ``jax.eval_shape``) raises."""
    try:
        want = jax_load_model_setup(DictConfig(config)).model_config
        jax.eval_shape(JaxModel(want).init, jax.random.PRNGKey(0), jnp.zeros((1, 4000)),
                       jnp.array([4000]))
    except ValueError as err:
        return err
    return want


@pytest.mark.parametrize("qkv_bias", [None, True, False], ids=["bias_unset", "bias_on",
                                                                "bias_off"])
@pytest.mark.parametrize("qkv_ln", [False, True], ids=["no_qkv_ln", "qkv_ln"])
@pytest.mark.parametrize("o_residual", [None, True], ids=["o_res_unset", "o_res"])
@pytest.mark.parametrize("stats", [None, False, True, "v2", "v3"],
                         ids=["stats_unset", "stats_false", "stats_true", "stats_v2", "stats_v3"])
@pytest.mark.parametrize("impl", ["pallas", "flash", "xla"])
def test_attention_flags_resolve_as_the_jax_setup(tmp_path, impl, stats, o_residual, qkv_ln,
                                                  qkv_bias):
    """Every combination of the attention's flags (each unset or set) on the
    tiny config: where the JAX setup or model refuses it (in-kernel biases
    with the LN fold, off the pallas route or with stats other than "v3"),
    the port's setup raises the same ``ValueError``; elsewhere it builds, with
    every route flag as the JAX setup resolves it and the attention route
    they pick."""
    flags = {"attention_impl": impl, "fused_qkv_ln": qkv_ln}
    for key, value in (("attention_save_stats", stats), ("attention_o_residual", o_residual),
                       ("attention_fused_qkv_bias", qkv_bias)):
        if value is not None:
            flags[key] = value
    config = {"model": {"type": "wav2vec2", "architecture": "tiny", "characters_to_keep": CHARS,
                        **flags}, "max_seconds_per_example": 1.0, "model_dir": str(tmp_path)}
    want = _jax_resolution(config)
    if isinstance(want, ValueError):
        with pytest.raises(ValueError, match=re.escape(" ".join(str(want).split()[:3]))):
            load_model_setup(config, device="cpu")
        return
    setup = load_model_setup(config, device="cpu")
    got = setup.model_config
    assert {k: getattr(got, k) for k in RESOLVED} == {k: getattr(want, k) for k in RESOLVED}
    assert got.attention_route == (attention.route(want.attention_save_stats,
                                                   want.attention_o_residual)
                                   if impl == "pallas" else None)


def _dtype_name(dtype):
    return str(dtype).rsplit(".", 1)[-1].strip("'>")


@pytest.mark.parametrize("port_cls,jax_cls", [(Wav2Vec2Config, JaxConfig),
                                              (PW.WhisperConfig, JW.WhisperConfig)],
                         ids=["wav2vec2", "whisper"])
def test_config_defaults_are_the_jax_dataclasses(port_cls, jax_cls):
    """Every field the two dataclasses share has the same default (dtype by
    name), the kernel flags among them: a model built from a factory alone
    takes the JAX model's routes."""
    port = {f.name: f.default for f in dataclasses.fields(port_cls)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_cls)}
    shared = port.keys() & ref.keys()
    assert {"fused_ffn", "fused_ffn_ln", "fused_ffn_block", "fused_ffn_block_dg"} <= shared
    if port_cls is Wav2Vec2Config:
        assert {"attention_save_stats", "attention_o_residual",
                "attention_fused_qkv_bias"} <= shared
    for name in sorted(shared):
        if name == "dtype":
            assert _dtype_name(port[name]) == _dtype_name(ref[name])
        else:
            assert port[name] == ref[name], name
