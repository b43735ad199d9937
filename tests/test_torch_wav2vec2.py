"""coral_tpu_torch's wav2vec2 model against coral_tpu's, on bridged weights.

The JAX model runs ``Wav2Vec2ForCTC.apply(deterministic=True)`` with the
production kernel flags of ``coral_tpu/training/model_setup.py`` (its Pallas
kernels in interpret mode or their off-TPU paths, as on the CPU); its weights
are drawn by numpy from a seed into the flax tree, with non-zero biases so
that every bias path counts, and bridged into the port by
``wav2vec2_state_dict_from_jax``. Two configs: the JAX ``tiny`` config, and a
narrow one that takes every kernel route of XLS-R (fused FE convs k=3 and k=2,
the FFN block kernel at D, F multiples of 128, 64-wide heads).

Tolerance: max |port - JAX| / max |JAX| <= 1e-4 over all frames, the bound
the JAX package's own model-parity tests use (tests/test_wav2vec2.py): fp32
throughout, reductions in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops.ffn import ffn_ln_block

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

# coral_tpu/training/model_setup.py's production defaults.
PRODUCTION_FLAGS = dict(
    attention_impl="pallas", attention_save_stats="v3", attention_fused_qkv_bias=True,
    fused_fe_conv=True, encoder_ln_impl="pallas", fused_ffn=True, fused_ffn_ln=True,
    fused_ffn_block=True, fused_ffn_block_dg=True, pos_conv_fold=True,
)
# The same routes on the port's config, whose dataclass (like the JAX one)
# defaults to others: every field of PRODUCTION_FLAGS the port has.
PORT_FLAGS = {k: v for k, v in PRODUCTION_FLAGS.items()
              if k in {f.name for f in dataclasses.fields(Wav2Vec2Config)}}
ARCHS = {
    "tiny": {},
    "narrow": dict(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
        conv_dim=(128, 128, 128), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
    ),
}
N_SAMPLES = 4000
LENGTHS = np.array([N_SAMPLES, 2500, 1], np.int32)  # full, padded, filler row


def _port_config(name):
    return Wav2Vec2Config(**ARCHS[name], **PORT_FLAGS) if name != "tiny" else (
        Wav2Vec2Config.tiny(**PORT_FLAGS))


def _jax_config(name):
    if name == "tiny":
        return JaxConfig.tiny(**PRODUCTION_FLAGS)
    return JaxConfig(**ARCHS[name], **PRODUCTION_FLAGS)


def _seeded_params(model, seed):
    """The flax tree of ``model`` filled by numpy: LayerNorm scales near 1,
    everything else small and non-zero."""
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, N_SAMPLES)),
        jnp.array([N_SAMPLES]),
    )["params"]
    rng = np.random.default_rng(seed)
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in paths:
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        fan_in = int(np.prod(leaf.shape[-3:-1])) if leaf.ndim >= 2 else 1
        a = rng.standard_normal(leaf.shape).astype(np.float32) / np.sqrt(fan_in)
        if "norm" in name and name.endswith("scale"):
            a = 1.0 + 0.1 * a
        elif name.endswith("bias"):
            a = 0.1 * a
        leaves.append(a.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def case(request):
    name = request.param
    jax_model = JaxModel(_jax_config(name))
    params = _seeded_params(jax_model, seed=0)
    audio = np.random.default_rng(1).standard_normal((3, N_SAMPLES)).astype(np.float32)
    logits, frames = jax_model.apply(
        {"params": params}, jnp.asarray(audio), jnp.asarray(LENGTHS), deterministic=True
    )
    port = Wav2Vec2ForCTC(_port_config(name)).eval()
    port.load_state_dict(wav2vec2_state_dict_from_jax(params, port.config))
    return name, params, port, audio, np.asarray(logits), np.asarray(frames)


def test_bridge_fills_every_parameter_in_pytorch_layout(case):
    _, params, port, *_ = case
    sd = wav2vec2_state_dict_from_jax(params, port.config)
    want = port.state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)
    layers = params["wav2vec2"]["encoder"]["layers"]
    np.testing.assert_array_equal(
        sd["wav2vec2.encoder.layers.1.attention.q_proj.weight"].numpy(),
        np.asarray(layers["attention"]["q_proj"]["kernel"][1]).T,
    )
    np.testing.assert_array_equal(
        sd["wav2vec2.feature_extractor.conv_layers.1.conv.weight"].numpy(),
        np.asarray(params["wav2vec2"]["feature_extractor"]["conv_layers_1"]["conv_kernel"])
        .transpose(2, 1, 0),
    )


def test_logits_and_frame_lengths_match_jax(case):
    _, _, port, audio, want_logits, want_frames = case
    with torch.inference_mode():
        logits, frames = port(torch.from_numpy(audio), torch.from_numpy(LENGTHS).long())
    np.testing.assert_array_equal(frames.numpy(), want_frames)
    assert want_frames[-1] <= 0  # the filler row masks every key
    assert np.isfinite(logits.numpy()).all()
    scale = np.abs(want_logits).max()
    np.testing.assert_allclose(logits.numpy() / scale, want_logits / scale, atol=1e-4)


def test_routes_follow_the_jax_model(case):
    name, _, port, *_ = case
    convs = port.wav2vec2.feature_extractor.conv_layers
    if name == "narrow":
        assert [c.fused for c in convs] == [False, True, True]
    else:  # stride-4 convs take the unfused route
        assert not any(c.fused for c in convs)
    # At every width the FFN calls the kernel's wrapper, which runs the plain
    # version on the CPU and the kernel (or raises) on the card.
    assert all(layer.feed_forward.route == "ffn_ln_block"
               and layer.feed_forward.ops.ffn_ln_block is ffn_ln_block
               for layer in port.wav2vec2.encoder.layers)


def test_plain_model_is_the_same_function(case):
    _, _, port, audio, *_ = case
    plain = Wav2Vec2ForCTC(port.config, plain=True).eval()
    plain.load_state_dict(port.state_dict())
    args = torch.from_numpy(audio), torch.from_numpy(LENGTHS).long()
    with torch.inference_mode():
        torch.testing.assert_close(plain(*args), port(*args), rtol=0, atol=0)


@pytest.mark.parametrize("kw", [{"feat_extract_norm": "group"},
                                {"do_stable_layer_norm": False}])
def test_base_architectures_build(kw):
    """The base models' two fields build their routes (parity with JAX in
    tests/test_torch_base_models.py): block 0's GroupNorm and no norm after
    the other convs, or the post-LN layers, which fold no LayerNorm."""
    model = Wav2Vec2ForCTC(Wav2Vec2Config.tiny(**PORT_FLAGS, **kw))
    convs = model.wav2vec2.feature_extractor.conv_layers
    layers = model.wav2vec2.encoder.layers
    if "feat_extract_norm" in kw:
        assert [c.norm for c in convs] == ["group", None, None, None]
    else:
        assert all(not layer.pre_ln and not layer.ln_folded for layer in layers)
        assert model.config.ffn_route == "ffn_block"
    with pytest.raises(ValueError, match="feat_extract_norm"):
        Wav2Vec2Config(feat_extract_norm="batch")
