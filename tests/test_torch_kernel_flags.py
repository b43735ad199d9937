"""The wav2vec2 kernel flags off their defaults, against coral_tpu, on the CPU.

``fused_fe_conv: false`` (every feature-encoder block as the conv + the
LayerNorm+GELU kernel K1, no K3), ``encoder_ln_impl: xla`` (the encoder
LayerNorms as plain fp32 LayerNorms, flax ``nn.LayerNorm``),
``remat_feature_encoder: true`` (the feature encoder replayed in the
backward keeping each conv's output, "conv_raw") and the ``dots_saveable``
remat policy (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).
Each runs 3 steps of both packages' ``make_ctc_train_step`` from the same
numpy-seeded weights (tests/test_torch_train.py's ``_steps_match_jax``: loss
1e-4, gradient norm 5e-4 relative), the feature encoder training where the
flag concerns it, on the config whose 128-wide feature encoder takes K3 by
default. The replays are counted by spies on the plain versions (K1 at every
block and again at all but the last under ``remat_feature_encoder``; K3's
training forward twice), and their gradients are the bits of no replay.
``dots_saveable`` keeps, layer by layer, tensors of the shapes that
``jax.ad_checkpoint.print_saved_residuals`` lists for the JAX layer at width 128
(the kernels' route) under that policy, on each FFN and attention route and
post-LN.
"""

import collections
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from coral_tpu.models.wav2vec2 import _REMAT_POLICIES
from coral_tpu.models.wav2vec2 import EncoderLayer as JaxEncoderLayer
from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu_torch.models import wav2vec2
from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import conv_ln_gelu, ln_gelu
from coral_tpu_torch.training.model_setup import load_model_setup
from coral_tpu_torch.training.train_state import ctc_loss_and_grads
from test_torch_train import (BLANK, CHARS, FE_ARCH, QUIET, VOCAB, _batch, _fe_port_model,
                              _steps_match_jax)
from test_torch_wav2vec2 import PRODUCTION_FLAGS, _seeded_params

torch.set_num_threads(1)


def _jax_model(policy="nothing_saveable", remat_fe=False, **flags):
    return JaxModel(JaxConfig(vocab_size=VOCAB, **FE_ARCH, **{**PRODUCTION_FLAGS, **QUIET,
                                                              **flags}),
                    gradient_checkpointing=True, remat_policy=policy,
                    remat_feature_encoder=remat_fe)


@pytest.fixture(scope="module")
def params():
    return _seeded_params(_jax_model(), seed=0)


@pytest.mark.parametrize("flags,policy,remat_fe", [
    ({"fused_fe_conv": False}, "save_qk_ctx", False),
    ({"encoder_ln_impl": "xla"}, "save_qk_ctx", False),
    ({"encoder_ln_impl": "xla", "fused_ffn_ln": False}, "save_matmul_inputs", False),
    ({}, "save_qk_ctx", True),
    ({"fused_fe_conv": False}, "save_qk_ctx", True),
    ({}, "dots_saveable", False),
    ({"fused_ffn": False, "fused_ffn_ln": False}, "dots_saveable", False),
], ids=["fe_conv_apart", "ln_xla", "ln_xla_ln2_apart", "remat_fe", "remat_fe_conv_apart",
        "dots", "dots_unfused"])
def test_train_step_matches_jax(params, flags, policy, remat_fe):
    model = _fe_port_model(params, policy, **flags)
    model.wav2vec2.feature_extractor.remat = remat_fe
    convs = model.wav2vec2.feature_extractor.conv_layers
    assert [c.fused for c in convs] == [False] + [flags.get("fused_fe_conv", True)] * 3
    assert all(layer.ln_impl == flags.get("encoder_ln_impl", "pallas")
               for layer in model.wav2vec2.encoder.layers)
    pstate, initial, final = _steps_match_jax(_jax_model(policy, remat_fe, **flags), params,
                                              model, False)
    for k in initial:
        if "feature_extractor" in k:  # trained in both packages
            assert not torch.equal(pstate.params[k], initial[k]), k


def _counted(monkeypatch):
    calls = collections.Counter()
    ln, k3 = ln_gelu.ln_gelu_plain, conv_ln_gelu.conv_ln_gelu_fwd_plain

    def count_ln(*args, **kw):
        gelu = args[4] if len(args) > 4 else kw.get("apply_gelu", True)
        calls["ln_gelu" if gelu else "ln_fused"] += 1
        return ln(*args, **kw)

    def count_k3(*args, **kw):
        calls["conv_ln_gelu"] += 1
        return k3(*args, **kw)

    monkeypatch.setattr(ln_gelu, "ln_gelu_plain", count_ln)
    monkeypatch.setattr(conv_ln_gelu, "conv_ln_gelu_fwd_plain", count_k3)
    return calls


@pytest.mark.parametrize("fused", [True, False], ids=["conv_blocks", "conv_apart"])
def test_remat_feature_encoder_replays_what_it_does_not_keep(params, fused, monkeypatch):
    """Per microbatch of 4 blocks: with K3, K1 (block 0) and each K3 training
    forward run twice, since the fused blocks name no "conv_raw"; with the
    conv apart, K1 runs at every block and again at blocks 0-2, whose output
    the next conv's weight gradient reads (the last block's is read by no
    one in the replay), while each conv's product is kept. The gradients are
    the bits of no replay."""
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    out = {}
    for remat in (True, False):
        calls = _counted(monkeypatch)
        model = _fe_port_model(params, "save_qk_ctx", activation_dropout=0.1,
                               fused_fe_conv=fused)
        model.wav2vec2.feature_extractor.remat = remat
        out[remat] = (ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(5), BLANK,
                                         "sum", False), dict(calls))
    A = 2
    replayed = {"ln_gelu": (1 + 1) * A, "conv_ln_gelu": (3 + 3) * A} if fused else {
        "ln_gelu": (4 + 3) * A}
    assert {k: v for k, v in out[True][1].items() if k != "ln_fused"} == replayed
    (loss_r, grads_r), (loss, grads) = out[True][0], out[False][0]
    assert torch.equal(loss_r, loss)
    for k in grads:
        assert torch.equal(grads_r[k], grads[k]), k


def test_remat_feature_encoder_through_the_setup():
    """The top-level key, as the JAX setup reads it, reaches the model; the
    step runs and trains the feature encoder."""
    from coral_tpu_torch.training import TrainState, create_optimizer

    config = {"model": {"type": "wav2vec2", "architecture": "tiny", "characters_to_keep": CHARS,
                        "freeze_feature_encoder": False, "fused_fe_conv": False,
                        "encoder_ln_impl": "xla", "remat_policy": "dots_saveable"},
              "max_seconds_per_example": 1.0, "bf16_allowed": False, "augment_audio": False,
              "remat_feature_encoder": True}
    setup = load_model_setup(config, device="cpu")
    assert setup.remat_policy == "dots_saveable" and setup.remat_feature_encoder
    model = setup.init_params(seed=0)
    assert model.wav2vec2.feature_extractor.remat
    tx, schedule = create_optimizer(1e-3, warmup_steps=1, max_steps=10)
    state = TrainState.create(model, tx)
    before = {k: v.clone() for k, v in state.params.items()}
    batch = _batch(seed=0)
    batch["labels"] = np.where(batch["labels"] == setup.blank_id, 0, batch["labels"])
    step = setup.make_train_step(tx, schedule)
    for _ in range(2):  # the first step's learning rate is the warmup's 0
        state, metrics = step(state, batch, torch.Generator().manual_seed(0))
        assert np.isfinite(float(metrics["loss"]))
    key = "wav2vec2.feature_extractor.conv_layers.1.conv.weight"
    assert not torch.equal(state.params[key], before[key])


# dots_saveable on a 128-wide layer (the FFN and attention kernels' route in
# the JAX package: below width 128 its FFN runs in XLA), by route.
WIDE = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=512,
            conv_dim=(128, 128, 128), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)
ROUTES = {
    "production": {},
    "fc1": {"fused_ffn_block": False},
    "ln_apart": {"fused_ffn_ln": False},
    "unfused": {"fused_ffn": False, "fused_ffn_ln": False},
    "xla_attention": {"attention_impl": "xla", "attention_fused_qkv_bias": False},
    "qkv_ln": {"fused_qkv_ln": True, "attention_fused_qkv_bias": False},
    "ln_xla": {"encoder_ln_impl": "xla"},
    "post_ln": {"do_stable_layer_norm": False, "fused_ffn_ln": False},
    "post_ln_fc1": {"do_stable_layer_norm": False, "fused_ffn_ln": False,
                    "fused_ffn_block": False},
    "post_ln_unfused": {"do_stable_layer_norm": False, "fused_ffn": False,
                        "fused_ffn_ln": False},
}


def _jax_saved_shapes(flags, B, T):
    """The shapes of the residuals that the JAX layer's ``nn.remat`` under
    dots_saveable saves, beside its input and parameters."""
    cfg = JaxConfig(vocab_size=VOCAB, **WIDE, **{**PRODUCTION_FLAGS, **QUIET, **flags})
    layer = nn.remat(JaxEncoderLayer, static_argnums=(3,),
                     policy=_REMAT_POLICIES["dots_saveable"])(cfg)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((B, T, 128)), jnp.float32)
    mask = jnp.ones((B, T), bool)
    variables = layer.init(jax.random.PRNGKey(0), x, mask, True)

    def f(variables, x):
        return jnp.sum(layer.apply(variables, x, mask, True)[0])

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax.ad_checkpoint.print_saved_residuals(f, variables, x)
    # Lines like "f32[2,9,128] named 'q' from ..." or "... output of ...".
    return sorted(tuple(int(n) for n in line.split("[", 1)[1].split("]", 1)[0].split(","))
                  for line in out.getvalue().splitlines()
                  if " from the argument " not in line and " from a constant" not in line)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_dots_saveable_keeps_what_jax_keeps(route, monkeypatch):
    flags = {**PRODUCTION_FLAGS, **QUIET, **ROUTES[route]}
    port_flags = {k: v for k, v in flags.items() if k != "pos_conv_fold"}
    model = Wav2Vec2ForCTC(Wav2Vec2Config(vocab_size=VOCAB, **WIDE, **port_flags))
    model.wav2vec2.encoder.gradient_checkpointing = True
    model.wav2vec2.encoder.remat_policy = "dots_saveable"
    kept = []
    keep = wav2vec2._Remat.keep

    def spy(self, name, t):
        if not self.replaying and name in self.names:
            kept.append(tuple(t.shape))
        return keep(self, name, t)

    monkeypatch.setattr(wav2vec2._Remat, "keep", spy)
    batch = {k: torch.from_numpy(v[:1]) for k, v in _batch().items()}
    ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(0), BLANK, "sum", True)
    L = WIDE["num_hidden_layers"]
    assert len(kept) % L == 0 and kept
    B, T, _ = kept[0]
    per_layer = sorted(kept[: len(kept) // L])
    assert sorted(kept) == sorted(per_layer * L)
    assert per_layer == _jax_saved_shapes(ROUTES[route], B, T)
