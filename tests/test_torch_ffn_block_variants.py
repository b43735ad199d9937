"""coral_tpu_torch's LayerNorm-folded FFN block in each of its variants, on the CPU.

``ffn_ln_block``'s flags pick, with the JAX precedence dw > fc2 > dg
(``coral_tpu/ops/ffn_pallas.py:2139-2147``): "dg_in" (the setups' default,
dg = dy W2^T inside K5's backward), "dg_out" (``fused_ffn_block_dg: false``:
dg outside, the backward N5), "fc2" (``fused_ffn_block_fc2``: LayerNorm, fc1,
GELU, dropout and fc2 in one forward kernel, N7, the backward N5) and "dw"
(``fused_ffn_block_dw``: the weight gradients formed in the backward's
kernels, N6). On the CPU the kernels' plain versions run. Each variant is
held against JAX's ``ffn_ln_block`` with the same flags at rate 0, its Pallas
kernels in interpret mode as the JAX package's own tests run them (D 128, F
256 and 37 rows a batch item: a ragged tile of the JAX grid), the forward and
all 7 cotangents through ``jax.vjp``; at rate 0.1 the packages draw other
masks, so the laws are checked: the keep fraction, the 1/keep scale, the
backward on the forward's mask, and N7's plain y equal to ``_fc2`` of fc1's
on the same seeds. Then the wav2vec2 model (narrow: the JAX kernels in
interpret mode) and the CTC step (tiny), Whisper's training forward (narrow)
and seq2seq step (tiny_test) on each variant against JAX's, and the
checkpoint replays, which run no block forward.

Tolerances, fp32 on both sides with sums in another order: the entry point
within 1e-5 of max |JAX| (forward and cotangents); the models' logits within
1e-4 of max |JAX| (tests/test_torch_wav2vec2.py); the train steps as
tests/test_torch_train.py and tests/test_torch_whisper_train.py hold them.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.ffn_pallas as jffn
from coral_tpu.models import whisper as JW
from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu_torch.models import whisper as PW
from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax, whisper_state_dict_from_jax
from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import ffn, philox
from coral_tpu_torch.ops.gelu_poly import gelu_poly
from coral_tpu_torch.training.train_state import ctc_loss_and_grads
from test_torch_ffn_routes import _grad, _inputs, _port_leaves, _rel
from test_torch_train import BLANK, FE_ARCH, QUIET, VOCAB, _batch, _steps_match_jax
from test_torch_wav2vec2 import (ARCHS, LENGTHS, N_SAMPLES, PORT_FLAGS, PRODUCTION_FLAGS,
                                 _seeded_params)
from test_torch_whisper import NARROW, SETUP_FLAGS
from test_torch_whisper import _seeded_params as whisper_params
from test_torch_whisper_train import _steps_match_jax as whisper_steps_match_jax

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

D, F, T = 128, 256, 37
BLOCK = (0, 1, 2, 3, 4, 5, 6)  # x, W1, b1, gamma, beta, W2, b2
# Each variant's flags, as the setups pass them (the JAX and the port's
# ``ffn_ln_block`` take the same keywords).
VARIANTS = {
    "dg_in": dict(dw_in_kernel=False, fc2_in_kernel=False, dg_in_kernel=True),
    "dg_out": dict(dw_in_kernel=False, fc2_in_kernel=False, dg_in_kernel=False),
    "fc2": dict(dw_in_kernel=False, fc2_in_kernel=True, dg_in_kernel=True),
    "dw": dict(dw_in_kernel=True, fc2_in_kernel=False, dg_in_kernel=True),
}
# The setups' flags of the off-default variants.
CONFIG_FLAGS = {"dg_out": dict(fused_ffn_block_dg=False), "fc2": dict(fused_ffn_block_fc2=True),
                "dw": dict(fused_ffn_block_dw=True)}


def _port_block(*leaves, **kw):
    x, w1, b1, gamma, beta, w2, b2 = leaves
    return ffn.ffn_ln_block(x, w1, b1, gamma, beta, w2, b2, **kw)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax_interpret_at_rate_0(variant):
    """The forward and all 7 cotangents against ``jax.vjp`` of the JAX
    ``ffn_ln_block`` with the same flags (``_ffn_ln_block_dg``,
    ``_ffn_ln_block``, ``_ffn_ln_block_fc2``, ``_ffn_ln_block_dw``), its
    Pallas kernels in interpret mode."""
    flags = VARIANTS[variant]
    arrays = _inputs()
    want, vjp = jax.vjp(lambda *a: jffn.ffn_ln_block(*a, interpret=True, **flags),
                        *(jnp.asarray(a) for a in arrays))
    dy = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(dy))
    leaves = _port_leaves(arrays, BLOCK)
    out = _port_block(*leaves, **flags)
    assert out.shape == want.shape == (2, T, D)
    assert _rel(out.detach().numpy(), want) <= 1e-5
    out.backward(torch.from_numpy(dy))
    for i, leaf, w in zip(BLOCK, leaves, want_grads):
        assert _rel(_grad(leaf, i), w) <= 1e-5, i


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_dropout_laws_at_rate_0_1(variant):
    """Keep fraction 0.9 over (2, 300, 512), kept activations scaled by
    1/0.9, the backward on the forward's mask (regenerated from the seeds:
    the gradients of the function with that mask fixed, through autograd);
    N7's plain forward is ``_fc2`` of fc1's, bit for bit, on the same seeds."""
    rate = 0.1
    arrays = _inputs(seed=2, rows=300, width=512)
    seeds = torch.tensor([3, -7], dtype=torch.int32)
    keep = philox.keep_mask(seeds, 300, 512, rate)
    assert abs(keep.float().mean().item() - 0.9) < 0.003
    leaves = _port_leaves(arrays, BLOCK)
    out = _port_block(*leaves, rate=rate, seeds=seeds, **VARIANTS[variant])
    ref = _port_leaves(arrays, BLOCK)
    x, w1, b1, gamma, beta, w2, b2 = ref
    a = torch.nn.functional.layer_norm(x, (D,), gamma, beta, 1e-5)
    g = torch.where(keep, gelu_poly(a @ w1.t() + b1) / (1.0 - rate), 0.0)
    want = g @ w2.t() + b2
    assert _rel(out.detach().numpy(), want.detach().numpy()) <= 1e-5
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(out.shape)
                          .astype(np.float32))
    out.backward(dy)
    want.backward(dy)
    for i, leaf, r in zip(BLOCK, leaves, ref):
        assert _rel(_grad(leaf, i), _grad(r, i)) <= 1e-5, i
    if variant == "fc2":
        args = [t.detach() for t in leaves]
        fc1 = ffn.ffn_ln_fc1_plain(*args[:5], rate=rate, seeds=seeds)
        assert torch.equal(ffn.ffn_ln_fc2_fwd_plain(*args, rate=rate, seeds=seeds),
                           ffn._fc2(fc1, args[5], args[6]))


def _spy(monkeypatch, names):
    """Counts the calls of ``ops.ffn``'s functions ``names``."""
    calls = collections.Counter()
    for name in names:
        fn = getattr(ffn, name)
        monkeypatch.setattr(ffn, name, lambda *a, _fn=fn, _name=name, **kw: (
            calls.update([_name]), _fn(*a, **kw))[1])
    return calls


def test_dw_wins_over_fc2(monkeypatch):
    """With dw and fc2 both set, the forward is K5's with fc2 outside and the
    backward N6, as in the JAX dispatch; it matches JAX with both flags."""
    flags = dict(dw_in_kernel=True, fc2_in_kernel=True, dg_in_kernel=False)
    assert ffn.block_variant(**flags) == "dw"
    assert ffn.block_variant(fc2_in_kernel=True, dg_in_kernel=False) == "fc2"
    calls = _spy(monkeypatch, ("ffn_ln_fc1_plain", "ffn_ln_fc2_fwd_plain",
                               "ffn_ln_dw_bwd_plain", "ffn_ln_g_bwd_plain"))
    arrays = _inputs()
    want, vjp = jax.vjp(lambda *a: jffn.ffn_ln_block(*a, interpret=True, **flags),
                        *(jnp.asarray(a) for a in arrays))
    leaves = _port_leaves(arrays, BLOCK)
    out = _port_block(*leaves, **flags)
    dy = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    out.backward(torch.from_numpy(dy))
    assert calls == {"ffn_ln_fc1_plain": 1, "ffn_ln_dw_bwd_plain": 1, "ffn_ln_g_bwd_plain": 1}
    assert _rel(out.detach().numpy(), want) <= 1e-5
    for i, leaf, w in zip(BLOCK, leaves, vjp(jnp.asarray(dy))):
        assert _rel(_grad(leaf, i), w) <= 1e-5, i


# -- the models on each variant --------------------------------------------------------


@pytest.mark.parametrize("variant", CONFIG_FLAGS)
def test_wav2vec2_model_matches_jax(variant):
    """The narrow config (D 128, F 256: the JAX FFN kernels in interpret
    mode), logits on a full, a padded and a filler row."""
    jax_model = JaxModel(JaxConfig(**ARCHS["narrow"],
                                   **{**PRODUCTION_FLAGS, **CONFIG_FLAGS[variant]}))
    params = _seeded_params(jax_model, seed=0)
    audio = np.random.default_rng(1).standard_normal((3, N_SAMPLES)).astype(np.float32)
    want, _ = jax_model.apply({"params": params}, jnp.asarray(audio), jnp.asarray(LENGTHS),
                              deterministic=True)
    model = Wav2Vec2ForCTC(Wav2Vec2Config(**ARCHS["narrow"],
                                          **{**PORT_FLAGS, **CONFIG_FLAGS[variant]})).eval()
    assert model.config.ffn_variant == variant
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    with torch.inference_mode():
        logits, _ = model(torch.from_numpy(audio), torch.from_numpy(LENGTHS).long())
    assert _rel(logits.numpy(), want) <= 1e-4


@pytest.mark.parametrize("variant", CONFIG_FLAGS)
def test_wav2vec2_train_step_matches_jax(variant):
    """Three steps of both packages' CTC step (tiny, fp32, activation dropout
    0, SpecAugment off) under nothing_saveable."""
    flags = {**PRODUCTION_FLAGS, **CONFIG_FLAGS[variant]}
    jax_model = JaxModel(JaxConfig.tiny(vocab_size=VOCAB, **flags, **QUIET),
                         gradient_checkpointing=True, remat_policy="nothing_saveable")
    params = _seeded_params(jax_model, seed=0)
    model = Wav2Vec2ForCTC(Wav2Vec2Config.tiny(vocab_size=VOCAB,
                                               **{**PORT_FLAGS, **CONFIG_FLAGS[variant]}, **QUIET))
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    model.wav2vec2.encoder.gradient_checkpointing = True
    model.wav2vec2.encoder.remat_policy = "nothing_saveable"
    _steps_match_jax(jax_model, params, model, True)


@pytest.mark.parametrize("variant", CONFIG_FLAGS)
def test_whisper_training_forward_matches_jax(variant):
    """``forward`` with gradients and checkpointing at the narrow config (the
    JAX FFN kernels in interpret mode, encoder and decoder) against JAX
    ``forward``, and ``encode``."""
    jc = JW.WhisperConfig(**NARROW, **{**SETUP_FLAGS, **CONFIG_FLAGS[variant]})
    pc = PW.WhisperConfig(**NARROW, **{**SETUP_FLAGS, **CONFIG_FLAGS[variant]})
    assert pc.ffn_variant == variant
    params = whisper_params(jc, seed=1)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 200, 80)).astype(np.float32)
    ids = rng.integers(0, 300, size=(2, 12))
    want = np.asarray(JW.forward(params, jc, jnp.asarray(feats), jnp.asarray(ids)))
    model = PW.WhisperForConditionalGeneration(pc)
    model.load_state_dict(whisper_state_dict_from_jax(params, pc))
    logits = PW.forward(model, torch.from_numpy(feats), torch.from_numpy(ids),
                        gradient_checkpointing=True)
    assert logits.requires_grad and logits.shape == want.shape
    assert _rel(logits.detach().numpy(), want) <= 1e-4
    with torch.inference_mode():
        enc = PW.encode(model, torch.from_numpy(feats))
    assert _rel(enc.numpy(), JW.encode(params, jc, jnp.asarray(feats))) <= 1e-4


@pytest.mark.parametrize("variant", CONFIG_FLAGS)
def test_whisper_train_step_matches_jax(variant):
    """Three steps of both packages' seq2seq step (tiny_test, fp32, dropout
    and SpecAugment off, save_matmul_inputs)."""
    jc = JW.WhisperConfig.tiny_test(vocab_size=300, **{**SETUP_FLAGS, **CONFIG_FLAGS[variant]},
                                    **QUIET)
    pc = PW.WhisperConfig.tiny_test(vocab_size=300, **{**SETUP_FLAGS, **CONFIG_FLAGS[variant]},
                                    **QUIET)
    whisper_steps_match_jax(jc, pc)


# -- remat: the replays run no block forward --------------------------------------------

# The plain functions each variant's forward and backward call once a layer.
CALLS = {"dg_in": ("ffn_ln_fc1_plain", "ffn_bwd_plain"),
         "dg_out": ("ffn_ln_fc1_plain", "ffn_ln_g_bwd_plain"),
         "fc2": ("ffn_ln_fc2_fwd_plain", "ffn_ln_g_bwd_plain"),
         "dw": ("ffn_ln_fc1_plain", "ffn_ln_dw_bwd_plain")}
SPIED = ("ffn_ln_fc1_plain", "ffn_ln_fc2_fwd_plain", "ffn_bwd_plain", "ffn_ln_g_bwd_plain",
         "ffn_ln_dw_bwd_plain")


def _expected(variant, n):
    """Calls of the spied functions for n block forwards and backwards (N7's
    and N6's plain versions call fc1's and N5's)."""
    fwd, bwd = CALLS[variant]
    out = collections.Counter({fwd: n, bwd: n})
    if variant == "fc2":
        out["ffn_ln_fc1_plain"] += n
    if variant == "dw":
        out["ffn_ln_g_bwd_plain"] += n
    return out


@pytest.mark.parametrize("variant", CONFIG_FLAGS)
def test_wav2vec2_replay_runs_no_block_forward(variant, monkeypatch):
    """Dropout 0.1, SpecAugment on and the feature encoder training, under
    nothing_saveable: the gradients with checkpointing are the bits of those
    without, and the block's forward and backward run once a layer and
    microbatch either way."""
    calls = _spy(monkeypatch, SPIED)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads, counts = [], []
    for remat in (True, False):
        torch.manual_seed(0)  # the same initial weights each time
        model = Wav2Vec2ForCTC(Wav2Vec2Config(
            vocab_size=VOCAB, **FE_ARCH, **{**PORT_FLAGS, **CONFIG_FLAGS[variant]},
            activation_dropout=0.1,
            hidden_dropout=0.1, mask_feature_length=8))
        torch.nn.init.uniform_(model.wav2vec2.masked_spec_embed)
        model.wav2vec2.encoder.gradient_checkpointing = remat
        model.wav2vec2.encoder.remat_policy = "nothing_saveable"
        calls.clear()
        grads.append(ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(5), BLANK,
                                        "sum", False))
        counts.append(dict(calls))
    A, L = 2, FE_ARCH["num_hidden_layers"]
    assert counts == [_expected(variant, L * A)] * 2, counts
    assert torch.equal(grads[0][0], grads[1][0])
    for k in grads[0][1]:
        assert torch.equal(grads[0][1][k], grads[1][1][k]), k
    assert grads[0][1]["wav2vec2.encoder.layers.0.feed_forward.output_dense.weight"].any()


@pytest.mark.parametrize("variant", CONFIG_FLAGS)
def test_whisper_replay_runs_no_block_forward(variant, monkeypatch):
    """tiny_test, activation and embedding dropout 0.1, SpecAugment on,
    save_matmul_inputs: the same bits with and without checkpointing, and the
    block's forward and backward once a layer in both stacks."""
    calls = _spy(monkeypatch, SPIED)
    jc = JW.WhisperConfig.tiny_test(vocab_size=300, **SETUP_FLAGS)
    pc = PW.WhisperConfig.tiny_test(vocab_size=300, **{**SETUP_FLAGS, **CONFIG_FLAGS[variant]},
                                    dropout=0.1, mask_feature_length=8)
    params = whisper_params(jc, seed=0)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((2, 200, 80)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 300, size=(2, 12)))
    grads, counts = [], []
    for remat in (True, False):
        model = PW.WhisperForConditionalGeneration(pc)
        model.load_state_dict(whisper_state_dict_from_jax(params, pc))
        calls.clear()
        logits = PW.forward(model, feats, ids, deterministic=False,
                            generator=torch.Generator().manual_seed(5),
                            gradient_checkpointing=remat)
        torch.log_softmax(logits, -1)[..., 7].sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        counts.append(dict(calls))
    L = pc.encoder_layers + pc.decoder_layers
    assert counts == [_expected(variant, L)] * 2, counts
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
    assert grads[0]["model.encoder.layers.0.fc2.weight"].any()
