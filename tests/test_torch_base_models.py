"""The wav2vec2 base models in coral_tpu_torch against coral_tpu, on the CPU.

The base models' architecture (facebook/wav2vec2-base: ``feat_extract_norm
= "group"``, a GroupNorm of one channel a group after conv 0 and no norm
after the others; ``do_stable_layer_norm = False``, post-LN layers with the
encoder's plain LayerNorm before them; ``conv_bias = False``) at the JAX tiny
config's widths and at a 128-wide one (its FFN on the kernels' width), on
the production kernel routes that the JAX setup allows post-LN
(``fused_ffn_ln`` false: the LayerNorm-less FFN block). Weights are drawn by
numpy into the JAX tree and bridged by ``wav2vec2_state_dict_from_jax``
(the JAX ``group_norm`` onto HF's ``conv_layers.0.layer_norm``). Held: the
logits against JAX's, 1e-4 of their max; 3 CTC train steps with the
feature encoder training against JAX's ``make_ctc_train_step`` (loss 1e-4,
gradient norm 5e-4 relative; tests/test_torch_train.py's bounds); one
Hugging Face base checkpoint (``transformers``, weight-norm keys) loaded by
both packages' converters gives the same logits; the post-LN replay
(bit-identical gradients under every policy, the FFN block's forward run
again since the final LayerNorm reads its output, no "attn_in" or
"ffn_in"); the setups' post-LN refusals as JAX's
(tests/test_model_setup_traps.py); the card's width check at 768.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coral_tpu.config import DictConfig
from coral_tpu.models.convert import wav2vec2_params_from_torch
from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
from coral_tpu_torch.models import wav2vec2
from coral_tpu_torch.models.convert import (wav2vec2_state_dict_from_hf,
                                            wav2vec2_state_dict_from_jax)
from coral_tpu_torch.models.wav2vec2 import REMAT_POLICIES, Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import ffn, ln_gelu
from coral_tpu_torch.training.model_setup import check_kernel_widths, load_model_setup
from coral_tpu_torch.training.train_state import ctc_loss_and_grads
from test_torch_train import BLANK, QUIET, VOCAB, _batch, _steps_match_jax
from test_torch_wav2vec2 import LENGTHS, N_SAMPLES, PRODUCTION_FLAGS, _seeded_params

torch.set_num_threads(1)

BASE_ARCH = dict(feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False)
# The production routes with the LayerNorm-less FFN block, as the JAX setup
# resolves them for a post-LN config with fused_ffn_ln: false.
FLAGS = {**PRODUCTION_FLAGS, "fused_ffn_ln": False}
PORT = {k: v for k, v in FLAGS.items() if k != "pos_conv_fold"}
ARCHS = {
    "tiny": dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, conv_dim=(16,) * 4, conv_stride=(5, 4, 4, 4),
                 conv_kernel=(10, 3, 3, 3), num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=2),
    "narrow": dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                   intermediate_size=256, conv_dim=(128, 128, 128), conv_stride=(5, 2, 2),
                   conv_kernel=(10, 3, 2), num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=2),
}
CHARS = "abcdefghijklmnopqrstuvwxyzæøå0123456789éü"


def _jax_model(arch, **kw):
    return JaxModel(JaxConfig(vocab_size=VOCAB, **ARCHS[arch], **BASE_ARCH, **FLAGS, **QUIET),
                    **kw)


def _port_model(arch, params, policy="nothing_saveable", **kw):
    model = Wav2Vec2ForCTC(Wav2Vec2Config(vocab_size=VOCAB, **ARCHS[arch], **BASE_ARCH,
                                          **{**PORT, **QUIET, **kw}))
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    model.wav2vec2.encoder.gradient_checkpointing = True
    model.wav2vec2.encoder.remat_policy = policy
    return model


@pytest.fixture(scope="module", params=sorted(ARCHS))
def case(request):
    arch = request.param
    jax_model = _jax_model(arch)
    return arch, jax_model, _seeded_params(jax_model, seed=0)


def test_the_routes_are_the_base_models(case):
    arch, _, params = case
    model = _port_model(arch, params)
    convs = model.wav2vec2.feature_extractor.conv_layers
    assert [c.norm for c in convs] == ["group"] + [None] * (len(convs) - 1)
    assert not any(c.fused for c in convs) and all(c.conv.bias is None for c in convs)
    assert isinstance(convs[0].layer_norm, torch.nn.GroupNorm)
    assert convs[0].layer_norm.num_groups == convs[0].conv.out_channels
    assert not any(hasattr(c, "layer_norm") for c in convs[1:])
    layers = model.wav2vec2.encoder.layers
    assert all(not layer.pre_ln and layer.feed_forward.route == "ffn_block" for layer in layers)
    # The JAX tree's group_norm is HF's conv_layers.0.layer_norm.
    sd = wav2vec2_state_dict_from_jax(params, model.config)
    np.testing.assert_array_equal(
        sd["wav2vec2.feature_extractor.conv_layers.0.layer_norm.weight"].numpy(),
        params["wav2vec2"]["feature_extractor"]["conv_layers_0"]["group_norm"]["scale"])


def test_logits_match_jax(case):
    arch, jax_model, params = case
    audio = np.random.default_rng(1).standard_normal((3, N_SAMPLES)).astype(np.float32)
    want, want_frames = jax_model.apply({"params": params}, jnp.asarray(audio),
                                        jnp.asarray(LENGTHS), deterministic=True)
    with torch.inference_mode():
        got, frames = _port_model(arch, params)(torch.from_numpy(audio),
                                                torch.from_numpy(LENGTHS).long())
    np.testing.assert_array_equal(frames.numpy(), np.asarray(want_frames))
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-4)


@pytest.mark.parametrize("policy", ["nothing_saveable", "save_qk_ctx"])
def test_train_steps_with_the_feature_encoder_match_jax(case, policy):
    """The feature encoder trains (the GroupNorm's gradients included)."""
    arch, _, params = case
    model = _port_model(arch, params, policy)
    pstate, initial, final = _steps_match_jax(
        _jax_model(arch, gradient_checkpointing=True, remat_policy=policy), params, model, False)
    for k in ("wav2vec2.feature_extractor.conv_layers.0.layer_norm.weight",
              "wav2vec2.feature_extractor.conv_layers.1.conv.weight"):
        assert not torch.equal(final[k], initial[k])
        assert not torch.equal(pstate.params[k], initial[k]), k


def _hf_base_state_dict(seed=0):
    """A Hugging Face ``Wav2Vec2ForCTC`` at the tiny widths with the base
    models' architecture, every tensor drawn by numpy (tests/hf_checkpoints.py)."""
    from transformers import Wav2Vec2ForCTC as HFModel

    from hf_checkpoints import fill, w2v2_config

    config = w2v2_config(VOCAB)
    for key, value in BASE_ARCH.items():
        setattr(config, key, value)
    model = HFModel(config)
    fill(model, seed)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_a_hf_base_checkpoint_loads_through_both_converters():
    sd = _hf_base_state_dict()
    assert "wav2vec2.feature_extractor.conv_layers.0.layer_norm.weight" in sd
    assert "wav2vec2.feature_extractor.conv_layers.1.layer_norm.weight" not in sd
    assert "wav2vec2.feature_extractor.conv_layers.0.conv.bias" not in sd
    jax_config = JaxConfig(vocab_size=VOCAB, **ARCHS["tiny"], **BASE_ARCH, **FLAGS)
    params = wav2vec2_params_from_torch(sd, jax_config)
    model = Wav2Vec2ForCTC(Wav2Vec2Config(vocab_size=VOCAB, **ARCHS["tiny"], **BASE_ARCH,
                                          **PORT)).eval()
    model.load_state_dict(wav2vec2_state_dict_from_hf(sd, model))
    audio = np.random.default_rng(2).standard_normal((3, N_SAMPLES)).astype(np.float32)
    want, _ = JaxModel(jax_config).apply({"params": params}, jnp.asarray(audio),
                                         jnp.asarray(LENGTHS), deterministic=True)
    with torch.inference_mode():
        got, _ = model(torch.from_numpy(audio), torch.from_numpy(LENGTHS).long())
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-4)


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_post_ln_checkpointing_gives_identical_gradients(case, policy, monkeypatch):
    """Dropout on, SpecAugment on, the feature encoder training: the same
    gradient bits with checkpointing under each policy and without it. The
    replay runs the LN-less block's forward again (the final LayerNorm packs
    its output), and keeps no "attn_in" or "ffn_in", which post-LN layers do
    not name."""
    arch, _, params = case
    kept = collections.Counter()
    keep = wav2vec2._Remat.keep

    def spy_keep(self, name, t):
        if not self.replaying and name in self.names:
            kept[name] += 1
        return keep(self, name, t)

    monkeypatch.setattr(wav2vec2._Remat, "keep", spy_keep)
    fc1 = collections.Counter()
    plain = ffn.ffn_fc1_plain
    monkeypatch.setattr(ffn, "ffn_fc1_plain",
                        lambda *a, **k: (fc1.update(["fwd"]), plain(*a, **k))[1])
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads = []
    for remat in (True, False):
        model = _port_model(arch, params, policy, activation_dropout=0.1, hidden_dropout=0.1,
                            mask_time_prob=0.5, mask_feature_prob=0.5, mask_feature_length=8)
        model.wav2vec2.encoder.gradient_checkpointing = remat
        grads.append(ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(5), BLANK,
                                        "sum", False))
    assert torch.equal(grads[0][0], grads[1][0])
    for k in grads[0][1]:
        assert torch.equal(grads[0][1][k], grads[1][1][k]), k
    L, A = 2, 2
    assert fc1["fwd"] == (2 + 1) * L * A  # forward and replay, then no checkpoint
    assert not {"attn_in", "ffn_in"} & set(kept)
    # What the layer names on this route, less the o and lse a policy keeps
    # only together (the v3 backward reads both).
    names = set(wav2vec2.remat_names(policy, model.config))
    if not {"attn_ctx", "attn_lse"} <= names:
        names -= {"attn_ctx", "attn_lse"}
    assert set(kept) == names & {"q", "k", "v", "attn_ctx", "attn_lse", "attn_out"}


def _setup_config(**model):
    return {"model": {"type": "wav2vec2", "architecture": "tiny", "characters_to_keep": CHARS,
                      **model},
            "max_seconds_per_example": 1.0}


@pytest.mark.parametrize("model,error", [
    ({"do_stable_layer_norm": False}, ValueError),
    ({"do_stable_layer_norm": False, "fused_ffn_ln": False, "fused_qkv_ln": True}, ValueError),
    ({"do_stable_layer_norm": False, "fused_ffn": False, "fused_ffn_ln": False,
      "fused_ffn_block": False, "fused_ffn_block_dg": False}, None),
    ({"do_stable_layer_norm": False, "fused_ffn_ln": False}, None),
])
def test_post_ln_refusals_match_jax(model, error, tmp_path):
    """As tests/test_model_setup_traps.py:35-56: the LN folds, fused_ffn_ln by
    its default too, raise with the post-LN encoder in both setups; without
    them both setups resolve the same post-LN routes."""
    config = {**_setup_config(**model), "model_dir": str(tmp_path)}
    if error is not None:
        with pytest.raises(error, match="do_stable_layer_norm"):
            jax_load_model_setup(DictConfig(config))
        with pytest.raises(error, match="do_stable_layer_norm"):
            load_model_setup(config, device="cpu")
        return
    want = jax_load_model_setup(DictConfig(config)).model_config
    got = load_model_setup(config, device="cpu").model_config
    for key in ("do_stable_layer_norm", "fused_ffn", "fused_ffn_ln", "fused_ffn_block",
                "fused_qkv_ln", "attention_fused_qkv_bias"):
        assert getattr(got, key) == getattr(want, key), key
    assert not got.do_stable_layer_norm


def test_the_width_check_takes_the_base_width():
    """On the card the base model's path runs ``ln_fused`` at 768 and the FFN
    and attention kernels at D 768, head_dim 64: it passes; under group norm
    no feature-encoder width is listed. A width no config uses (896) is
    refused, naming its queue."""
    config = Wav2Vec2Config.base(**PORT)
    assert (config.hidden_size, config.num_hidden_layers, config.num_attention_heads,
            config.intermediate_size) == (768, 12, 12, 3072)
    check_kernel_widths(config)
    widths = {what: (value, takes) for what, value, takes in wav2vec2.kernel_widths(config)}
    value, takes = widths["hidden_size (the encoder LayerNorm)"]
    assert value == 768 and takes == ln_gelu.KERNEL_C[torch.bfloat16] and 768 in takes
    assert not any(what.startswith("conv_dim") for what in widths)
    check_kernel_widths(dataclasses.replace(config, encoder_ln_impl="xla"))
    with pytest.raises(NotImplementedError, match="896.*Queue 2 item 3"):
        check_kernel_widths(dataclasses.replace(config, hidden_size=896, num_attention_heads=14,
                                                intermediate_size=3584))
