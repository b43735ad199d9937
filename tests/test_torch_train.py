"""coral_tpu_torch's train step against coral_tpu's, on the CPU.

The whole step (``make_ctc_train_step``: z-norm, the model in training mode,
the CTC loss, accumulation over A = 2 microbatches, clip + AdamW with a bf16
first moment, the warmup-cosine schedule) runs in both packages from the same
numpy-seeded weights and batch, with the production kernel flags, in fp32, at
activation dropout 0 and the SpecAugment probabilities 0 (their random
streams differ by design; their laws are checked separately): on the JAX
``tiny`` config with the feature encoder frozen, and on a config whose
128-wide feature encoder takes the fused conv route with the encoder
training, under ``nothing_saveable`` and ``save_qk_ctx``. The JAX side runs
as its own tests run it on the CPU: Pallas kernels in interpret mode or their
off-TPU paths. The named remat policies, ``dots_saveable`` included, are
checked against no checkpointing (the same gradient bits) and by the
forwards each replays.

Tolerances, fp32 throughout with sums in another order: the loss 1e-4 and the
gradient norm 5e-4 relative (both move apart once the parameters do, after
the first update); the learning rate 1e-6 relative. The parameters after 3
steps: Adam divides each gradient by its own running size, so an element
whose gradient is near zero turns fp32 noise into an update of up to the
learning rate, either way. So the bound is on the distribution of |port -
JAX| over all parameters (29036 in the tiny config): median <= 1e-5 and 99th percentile <= 5e-5
(measured about 1e-6 and 6e-6), and every element within 3e-3, twice the
1.5e-3 that the two non-zero updates (learning rates 5e-4 and 1e-3) can move
one (a sign flip).
"""

import collections
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu.models.wav2vec2 import _span_mask
from coral_tpu.training import TrainState as JaxTrainState
from coral_tpu.training import create_optimizer as jax_create_optimizer
from coral_tpu.training.train_state import make_ctc_train_step as jax_make_ctc_train_step
from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from coral_tpu_torch.models.wav2vec2 import (REMAT_POLICIES, Wav2Vec2Config, Wav2Vec2ForCTC,
                                             draw_randomness, span_dilate)
from coral_tpu_torch.ops import attention, ffn, ln_gelu
from coral_tpu_torch.training import TrainState, create_optimizer, make_ctc_train_step
from coral_tpu_torch.training.model_setup import load_model_setup
from coral_tpu_torch.training.optimizer import create_learning_rate_schedule
from coral_tpu_torch.training.train_state import _device_audio, ctc_loss_and_grads
from test_torch_wav2vec2 import PORT_FLAGS, PRODUCTION_FLAGS, _seeded_params

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

VOCAB = 12
BLANK = VOCAB - 1
QUIET = dict(activation_dropout=0.0, mask_time_prob=0.0, mask_feature_prob=0.0)
CHARS = "abcdefghijklmnopqrstuvwxyzæøå0123456789éü"


def _batch(seed=3, A=2, B=4, T=6400, L=8):
    rng = np.random.default_rng(seed)
    batch = {
        "input_values": rng.standard_normal((A, B, T)).astype(np.float32),
        "input_lengths": rng.integers(T // 2, T + 1, size=(A, B)).astype(np.int32),
        "labels": rng.integers(0, VOCAB - 1, size=(A, B, L)).astype(np.int32),
        "label_lengths": rng.integers(1, L + 1, size=(A, B)).astype(np.int32),
    }
    batch["input_lengths"][0, 0] = T
    batch["labels"][0, 1, batch["label_lengths"][0, 1]:] = -100
    return batch


@pytest.fixture(scope="module")
def jax_case():
    model = JaxModel(JaxConfig.tiny(vocab_size=VOCAB, **PRODUCTION_FLAGS, **QUIET),
                     gradient_checkpointing=True, remat_policy="nothing_saveable")
    return model, _seeded_params(model, seed=0)


def _port_model(params, **kw):
    model = Wav2Vec2ForCTC(Wav2Vec2Config.tiny(vocab_size=VOCAB, **{**PORT_FLAGS, **QUIET, **kw}))
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    model.wav2vec2.encoder.gradient_checkpointing = True
    return model


def _steps_match_jax(jax_model, params, model, freeze_feature_encoder, grad_dtype=None):
    """Three steps of both packages' ``make_ctc_train_step`` from the same
    weights and batch; returns (the port's state, the initial weights, the
    JAX weights after the steps) as state dicts."""
    batch = _batch()
    tx, schedule = jax_create_optimizer(1e-3, warmup_steps=2, max_steps=20,
                                        mu_dtype="bfloat16")
    state = JaxTrainState.create(params, tx)
    step = jax.jit(jax_make_ctc_train_step(jax_model, tx, schedule, blank_id=BLANK,
                                           freeze_feature_encoder=freeze_feature_encoder,
                                           grad_dtype=grad_dtype))
    want = []
    for i in range(3):
        state, m = step(state, batch, jax.random.PRNGKey(i))
        want.append({k: float(v) for k, v in m.items()})

    ptx, pschedule = create_optimizer(1e-3, warmup_steps=2, max_steps=20, mu_dtype="bfloat16")
    pstate = TrainState.create(model, ptx)
    pstep = make_ctc_train_step(ptx, pschedule, BLANK,
                                freeze_feature_encoder=freeze_feature_encoder,
                                grad_dtype=grad_dtype)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        pstate, m = pstep(pstate, batch, gen)
        got = {k: float(v) for k, v in m.items()}
        np.testing.assert_allclose(got["loss"], want[i]["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want[i]["grad_norm"], rtol=5e-4)
        np.testing.assert_allclose(got["learning_rate"], want[i]["learning_rate"], rtol=1e-6)
    assert pstate.step == 3
    initial = wav2vec2_state_dict_from_jax(params, model.config)
    final = wav2vec2_state_dict_from_jax(jax.device_get(state.params), model.config)
    assert all(pstate.params[k].dtype == torch.float32 for k in final)
    diff = torch.cat([(pstate.params[k] - final[k]).abs().flatten() for k in final])
    assert diff.median() <= 1e-5
    assert torch.quantile(diff, 0.99) <= 5e-5
    assert diff.max() <= 3e-3
    return pstate, initial, final


@pytest.mark.parametrize("grad_dtype", [None, "bfloat16"], ids=["fp32_grads", "bf16_grads"])
def test_train_step_matches_jax(jax_case, grad_dtype):
    jax_model, params = jax_case
    pstate, initial, _ = _steps_match_jax(jax_model, params, _port_model(params), True,
                                          grad_dtype)
    for k in initial:
        if "feature_extractor" in k:  # frozen: unchanged in both packages
            assert torch.equal(pstate.params[k], initial[k])


# The tiny config's 16-wide feature encoder never reaches conv_ln_gelu (its
# strides are 4); this one does: FE blocks 1-3 at 128 channels, stride 2,
# k = 3, 3, 2, and 40x downsampling (159 frames from 6400 samples).
FE_ARCH = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
               conv_dim=(128,) * 4, conv_stride=(5, 2, 2, 2), conv_kernel=(10, 3, 3, 2),
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)


def _jax_fe_model(policy="nothing_saveable"):
    return JaxModel(JaxConfig(vocab_size=VOCAB, **FE_ARCH, **PRODUCTION_FLAGS, **QUIET),
                    gradient_checkpointing=True, remat_policy=policy)


@pytest.fixture(scope="module")
def fe_params():
    return _seeded_params(_jax_fe_model(), seed=0)


def _fe_port_model(params, policy="nothing_saveable", **kw):
    model = Wav2Vec2ForCTC(Wav2Vec2Config(vocab_size=VOCAB, **FE_ARCH,
                                          **{**PORT_FLAGS, **QUIET, **kw}))
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    model.wav2vec2.encoder.gradient_checkpointing = True
    model.wav2vec2.encoder.remat_policy = policy
    return model


@pytest.mark.parametrize("policy", ["nothing_saveable", "save_qk_ctx"])
def test_train_step_with_the_feature_encoder_matches_jax(fe_params, policy):
    """``freeze_feature_encoder=False``: the conv blocks train through the
    fused conv's backward (the JAX model's off-TPU route is the XLA reference
    under autodiff), under the remat policy JAX defaults to and the one that
    replays everything. Tolerances as above."""
    model = _fe_port_model(fe_params, policy)
    assert [c.fused for c in model.wav2vec2.feature_extractor.conv_layers] == [False] + [True] * 3
    pstate, initial, final = _steps_match_jax(_jax_fe_model(policy), fe_params, model, False)
    for k in initial:
        if "feature_extractor" in k:  # trained in both packages
            assert not torch.equal(final[k], initial[k])
            assert not torch.equal(pstate.params[k], initial[k]), k


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES))
def test_gradient_checkpointing_gives_identical_gradients(fe_params, policy):
    """Dropout at 0.1, SpecAugment on and the feature encoder training: the
    replay draws nothing, and an output a policy keeps is the one the forward
    made, so the gradients with checkpointing under each named policy and
    without it are the same bits."""
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads = []
    for remat in (True, False):
        model = _fe_port_model(fe_params, policy, activation_dropout=0.1, hidden_dropout=0.1,
                               mask_time_prob=0.5, mask_feature_prob=0.5,
                               mask_feature_length=8)
        model.wav2vec2.encoder.gradient_checkpointing = remat
        gen = torch.Generator().manual_seed(5)
        grads.append(ctc_loss_and_grads(model, batch, gen, BLANK, "sum", False))
    assert torch.equal(grads[0][0], grads[1][0])
    assert grads[0][1].keys() == grads[1][1].keys()
    for k in grads[0][1]:
        assert torch.equal(grads[0][1][k], grads[1][1][k]), k
    assert grads[0][1]["wav2vec2.masked_spec_embed"].any()  # SpecAugment was on
    assert grads[0][1]["wav2vec2.feature_extractor.conv_layers.2.conv.weight"].any()


# Forward runs per layer and microbatch under each policy: the attention
# forward runs again in the replay unless its o and lse are both kept, LN1
# unless "attn_in" is kept, and the FFN block's forward never (its residuals
# are its inputs); no checkpointing runs each once.
FORWARDS = {
    "nothing_saveable": (2, 2), "save_attn_ctx": (2, 2), "save_ctx_act": (2, 2),
    "save_matmul_inputs": (2, 1), "save_matmul_inputs_ffn": (2, 1),
    "save_attn_ctx_lse": (1, 2), "save_qkv_ctx": (1, 2), "save_qk_ctx": (1, 2),
    "dots_saveable": (2, 2), None: (1, 1),
}


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES) + [None])
def test_named_policies_replay_what_they_do_not_keep(fe_params, policy, monkeypatch):
    """Spies on the plain forwards (the kernels' stand-ins on the CPU):
    ``save_qk_ctx`` runs the attention forward once per layer, as the JAX
    replay does, which reads the kept q, k, o and lse."""
    calls = collections.Counter()

    def spy(module, name, key):
        fn = getattr(module, name)

        def counted(*args, **kw):
            calls[key(*args)] += 1
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, counted)

    spy(attention, "_fwd_plain", lambda *a: "attention")
    spy(ffn, "ffn_ln_fc1_plain", lambda *a: "ffn")
    spy(ln_gelu, "ln_gelu_plain", lambda *a: "ln_gelu" if a[4] else "ln_fused")
    model = _fe_port_model(fe_params, policy or "nothing_saveable", activation_dropout=0.1)
    model.wav2vec2.encoder.gradient_checkpointing = policy is not None
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(0), BLANK, "sum", False)
    A, L = 2, FE_ARCH["num_hidden_layers"]
    attn, ln1 = FORWARDS[policy]
    assert calls == {"attention": attn * L * A, "ln_fused": ln1 * L * A, "ffn": L * A,
                     "ln_gelu": A}


def _setup_config(**over):
    cfg = {
        "model": {"type": "wav2vec2", "architecture": "tiny", "characters_to_keep": CHARS,
                  "freeze_feature_encoder": True, "activation_dropout": 0.1,
                  "mask_time_prob": 0.5, "mask_time_length": 10, "mask_feature_prob": 0.5,
                  "mask_feature_length": 8, "layerdrop": 0.1, "ctc_loss_reduction": "sum",
                  "learning_rate": 1e-3, "sampling_rate": 16_000},
        "max_seconds_per_example": 1.0, "bf16_allowed": False, "grad_dtype": "bfloat16",
        "gradient_checkpointing": True, "remat_policy": "nothing_saveable",
        "augment_audio": False,
    }
    for k, v in over.items():
        if k.startswith("model."):
            cfg["model"][k[6:]] = v
        else:
            cfg[k] = v
    return cfg


def test_loss_decreases_through_the_setup():
    """The production configuration at the tiny size through the entry point
    (as tests/test_train_step.py:48 does for the JAX step)."""
    setup = load_model_setup(_setup_config(), device="cpu")
    model = setup.init_params(seed=0)
    tx, schedule = create_optimizer(setup.learning_rate, warmup_steps=1, max_steps=100,
                                    mu_dtype="bfloat16")
    state = TrainState.create(model, tx)
    step = setup.make_train_step(tx, schedule)
    batch = _batch(seed=0)
    batch["labels"] = np.where(batch["labels"] == setup.blank_id, 0, batch["labels"])
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert float(metrics["learning_rate"]) > 0 and state.step == 6


def test_production_settings_train_through_the_setup(tmp_path):
    """The settings of config/model/wav2vec2-small.yaml and
    config/asr_finetuning.yaml at the tiny size: the feature encoder trains,
    augmentation is on with a background-noise bank, and with no remat_policy
    key the JAX default save_qk_ctx applies; the step runs and the FE and the
    encoder get gradients."""
    np.save(tmp_path / "bank.npy",
            np.random.default_rng(0).standard_normal((3, 8000)).astype(np.float32))
    cfg = _setup_config(**{"model.freeze_feature_encoder": False, "augment_audio": True,
                           "background_noise_path": str(tmp_path / "bank.npy")})
    del cfg["remat_policy"]
    setup = load_model_setup(cfg, device="cpu")
    assert setup.remat_policy == "save_qk_ctx" and not setup.freeze_feature_encoder
    model = setup.init_params(seed=0)
    assert model.wav2vec2.encoder.remat_policy == "save_qk_ctx"
    tx, schedule = create_optimizer(setup.learning_rate, warmup_steps=1, max_steps=100)
    state = TrainState.create(model, tx)
    before = {k: v.clone() for k, v in state.params.items()}
    step = setup.make_train_step(tx, schedule)
    batch = _batch(seed=0)
    batch["labels"] = np.where(batch["labels"] == setup.blank_id, 0, batch["labels"])
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, metrics = step(state, batch, gen)
        assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    for k in ("wav2vec2.feature_extractor.conv_layers.1.conv.weight",
              "wav2vec2.encoder.layers.0.attention.q_proj.weight"):
        assert not torch.equal(state.params[k], before[k]), k


@pytest.mark.parametrize("over,match", [
    ({"mesh": [2, 1]}, "item 7"),
    ({"distributed": True}, "item 7"),
])
def test_unported_training_inputs_raise(over, match):
    setup = load_model_setup(_setup_config(**over), device="cpu")
    tx, schedule = create_optimizer(1e-3, 1, 10)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{match}"):
        setup.make_train_step(tx, schedule)


@pytest.mark.parametrize("over", [{"remat_policy": "dots_saveable"},
                                  {"remat_feature_encoder": True,
                                   "model.freeze_feature_encoder": False}],
                         ids=["dots_saveable", "remat_feature_encoder"])
def test_training_inputs_once_refused_now_train(over):
    """``dots_saveable`` and ``remat_feature_encoder: true`` reach the model
    through the setup and its step runs (their parity with JAX's step is in
    tests/test_torch_kernel_flags.py)."""
    setup = load_model_setup(_setup_config(**over), device="cpu")
    model = setup.init_params(seed=0)
    assert model.wav2vec2.encoder.remat_policy == setup.remat_policy
    assert model.wav2vec2.feature_extractor.remat == bool(over.get("remat_feature_encoder"))
    tx, schedule = create_optimizer(1e-3, 1, 10)
    state = TrainState.create(model, tx)
    batch = _batch(seed=0)
    batch["labels"] = np.where(batch["labels"] == setup.blank_id, 0, batch["labels"])
    state, metrics = setup.make_train_step(tx, schedule)(state, batch,
                                                         torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0


def test_whisper_training_raises():
    """Whisper's seq2seq step builds on the CPU through the setup; training on
    more than one device still raises (its parity with the JAX step is in
    tests/test_torch_whisper_train.py)."""
    model_cfg = {"type": "whisper", "architecture": "tiny_test"}
    tx, schedule = create_optimizer(1e-3, 1, 10)
    setup = load_model_setup({"model": model_cfg}, device="cpu")
    assert callable(setup.make_train_step(tx, schedule))
    setup = load_model_setup({"model": model_cfg, "mesh": [2, 1]}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        setup.make_train_step(tx, schedule)


def test_remat_policy_warnings_match_jax(caplog):
    """save_ctx_act degrades to save_attn_ctx under the FFN block, and both
    replay the attention forward for its unsaved lse (the JAX setup's
    warnings)."""
    for policy, n in (("save_ctx_act", 2), ("save_attn_ctx", 1), ("save_qk_ctx", 0)):
        caplog.clear()
        load_model_setup(_setup_config(remat_policy=policy), device="cpu")
        assert len([r for r in caplog.records if r.levelname == "WARNING"]) == n, policy


def test_span_dilation_matches_jax_span_mask(monkeypatch):
    """Given the same Bernoulli starts, the port's dilation is ``_span_mask``'s
    convolve-and-truncate: t is masked iff a start lies in (t - span, t]."""
    starts = np.random.default_rng(0).random((6, 97)) < 0.05
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(starts))
    for span in (1, 10, 64):
        want = np.asarray(_span_mask(jax.random.PRNGKey(0), 6, 97, 0.5, span))
        got = span_dilate(torch.from_numpy(starts), span).numpy()
        np.testing.assert_array_equal(got, want)


def test_spec_augment_laws():
    """Coverage 1 - (1 - p/span)^span away from the left edge; the time mask
    keeps off padded frames and fills masked_spec_embed; the feature mask zeroes
    whole channels over all frames."""
    cfg = Wav2Vec2Config.tiny(mask_time_prob=0.5, mask_time_length=10, mask_feature_prob=0.5,
                              mask_feature_length=4)
    rnd = draw_randomness(cfg, 256, 400, torch.Generator().manual_seed(0), "cpu")
    tmask = span_dilate(rnd.time_starts, 10)
    expected = 1 - (1 - 0.05) ** 10
    assert abs(tmask[:, 10:].float().mean().item() - expected) < 0.01
    model = Wav2Vec2ForCTC(cfg).wav2vec2
    torch.nn.init.uniform_(model.masked_spec_embed)
    hidden = torch.randn(256, 400, 32)
    pad = torch.arange(400)[None, :] < torch.randint(100, 401, (256,))[:, None]
    out = model.spec_augment(hidden, pad, rnd)
    fmask = span_dilate(rnd.feature_starts, 4)
    t_only = tmask & pad
    assert torch.equal(out[~fmask[:, None, :].expand_as(out) & t_only[..., None].expand_as(out)],
                       model.masked_spec_embed.expand_as(out)[
                           ~fmask[:, None, :].expand_as(out) & t_only[..., None].expand_as(out)])
    assert not out[fmask[:, None, :].expand_as(out)].any()
    untouched = ~t_only[..., None].expand_as(out) & ~fmask[:, None, :].expand_as(out)
    assert torch.equal(out[untouched], hidden[untouched])


def test_optimizer_and_schedule_match_optax():
    """clip_by_global_norm + adamw with a bf16 first moment, four updates (the
    clip on and off), against optax on the same numpy tensors."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx, schedule = jax_create_optimizer(1e-2, warmup_steps=2, max_steps=6,
                                        mu_dtype="bfloat16")
    ptx, pschedule = create_optimizer(1e-2, warmup_steps=2, max_steps=6, mu_dtype="bfloat16")
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ptx.init(tparams)
    for i, scale in enumerate((3.0, 0.01, 5.0, 0.02)):
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        ptx.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate, tparams)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), atol=1e-7,
                                       rtol=1e-6)
            assert tstate.mu[k].dtype == torch.bfloat16
    for count in range(12):
        np.testing.assert_allclose(pschedule(count), float(schedule(count)), rtol=1e-6,
                                   atol=1e-12)
    s0 = create_learning_rate_schedule(1e-4, 0, 5)
    assert s0(0) == pytest.approx(1e-4)


def test_pcm16_infeed():
    pcm = torch.tensor([-32768, 0, 16384], dtype=torch.int16)
    assert torch.equal(_device_audio(pcm), torch.tensor([-1.0, 0.0, 0.5]))
    f = torch.ones(3)
    assert _device_audio(f) is f


def test_randomness_is_drawn_before_the_model_runs():
    """Every draw happens in draw_randomness, in a fixed order: the same seed
    gives the same masks and seeds; another seed gives others."""
    cfg = Wav2Vec2Config.tiny()
    a = draw_randomness(cfg, 4, 20, torch.Generator().manual_seed(1), "cpu")
    b = draw_randomness(cfg, 4, 20, torch.Generator().manual_seed(1), "cpu")
    c = draw_randomness(cfg, 4, 20, torch.Generator().manual_seed(2), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.layers, c.layers)
    assert a.layers.shape == (cfg.num_hidden_layers, 3, 4) and a.layers.dtype == torch.int32


def test_copy_of_config_is_not_mutated():
    cfg = _setup_config()
    before = copy.deepcopy(cfg)
    load_model_setup(cfg, device="cpu")
    assert cfg == before
