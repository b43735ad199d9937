"""coral_tpu_torch's FFN routes without the block or the folded LayerNorm, on the CPU.

The routes behind ``fused_ffn_ln: false`` and ``fused_ffn_block: false``:
``ffn_fc1`` (the fc1 kernel without a LayerNorm, N1, and its backward N2),
``ffn_block`` (the LayerNorm-less block: N1 forward, N3 backward with g) and
``ffn_ln_fc1`` (K5's forward, the backward N4). Each entry point is held
against the JAX package's at rate 0, the Pallas kernels in interpret mode as
the JAX package's own tests run them (D 128, F 256 and 37 rows a batch item:
a ragged tile of the JAX grid's 256 rows), forward and every cotangent
through ``jax.vjp``; at rate 0.1 the two packages draw other masks (JAX's
off-TPU dropout is ``jax.random.bernoulli``), so the laws are checked: the
keep fraction, the 1/keep scale, and a backward on the forward's mask. Then
the wav2vec2 model (narrow: the JAX kernels in interpret mode) and the CTC
train step (tiny) on each route against JAX's, Whisper's training forward
and seq2seq step likewise, the remat replays' bits and fc1 counts, and the
setups' resolution of the FFN flags against the JAX setups' and models'.

Tolerances, fp32 on both sides with sums in another order: the entry points
within 1e-5 of max |JAX| (forward and cotangents); the models' logits within
1e-4 of max |JAX| (tests/test_torch_wav2vec2.py); the train steps as
tests/test_torch_train.py and tests/test_torch_whisper_train.py hold them.
"""

import collections
import dataclasses
import functools
import itertools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.ffn_pallas as jffn
from coral_tpu.config import DictConfig
from coral_tpu.models import whisper as JW
from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
from coral_tpu_torch.models import whisper as PW
from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax, whisper_state_dict_from_jax
from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import ffn, philox
from coral_tpu_torch.ops.gelu_poly import gelu_poly
from coral_tpu_torch.training.model_setup import load_model_setup
from coral_tpu_torch.training.train_state import ctc_loss_and_grads
from test_torch_train import BLANK, CHARS, FE_ARCH, QUIET, VOCAB, _batch, _steps_match_jax
from test_torch_wav2vec2 import (ARCHS, LENGTHS, N_SAMPLES, PORT_FLAGS, PRODUCTION_FLAGS,
                                 _seeded_params)
from test_torch_whisper import NARROW, SETUP_FLAGS
from test_torch_whisper import _seeded_params as whisper_params
from test_torch_whisper_train import _steps_match_jax as whisper_steps_match_jax

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

D, F, T = 128, 256, 37
ENTRIES = ("ffn_fc1", "ffn_ln_fc1", "ffn_block")


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(seed=0, rows=T, width=F):
    """x, W1, b1, gamma, beta, W2, b2 in the JAX layouts (W (in, out)), fp32."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((2, rows, D)) + 0.2, rng.standard_normal((D, width)) * D**-0.5,
              rng.standard_normal(width) * 0.1, rng.standard_normal(D) * 0.1 + 1.0,
              rng.standard_normal(D) * 0.1, rng.standard_normal((width, D)) * width**-0.5,
              rng.standard_normal(D) * 0.1]
    return [a.astype(np.float32) for a in arrays]


# Each entry point's operands (indices into ``_inputs``), its JAX function,
# and the port's (which takes W1 and W2 as (out, in)).
CALLS = {
    "ffn_fc1": ((0, 1, 2), lambda *a: jffn.ffn_fc1(*a, interpret=True),
                lambda x, w1, b1, **kw: ffn.ffn_fc1(x, w1, b1, **kw)),
    "ffn_ln_fc1": ((0, 1, 2, 3, 4), lambda *a: jffn.ffn_ln_fc1(*a, interpret=True),
                   lambda x, w1, b1, g, b, **kw: ffn.ffn_ln_fc1(x, w1, b1, g, b, **kw)),
    "ffn_block": ((0, 1, 2, 5, 6), lambda *a: jffn.ffn_block(*a, interpret=True),
                  lambda x, w1, b1, w2, b2, **kw: ffn.ffn_block(x, w1, b1, w2, b2, **kw)),
}


def _port_leaves(arrays, which):
    """Torch leaves of ``arrays[which]``, the weights transposed to (out, in)."""
    return [torch.from_numpy(arrays[i].T.copy() if i in (1, 5) else arrays[i])
            .requires_grad_(True) for i in which]


def _grad(leaf, i):
    return (leaf.grad.T if i in (1, 5) else leaf.grad).numpy()


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_point_matches_jax_interpret_at_rate_0(entry):
    """The forward and every cotangent against ``jax.vjp`` of the JAX entry
    point, whose custom VJP runs its Pallas kernels in interpret mode
    (``_fwd_pallas``/``_bwd_pallas``, ``_fwd_pallas_ln``/``_bwd_pallas_ln``,
    ``_fwd_pallas``/``_bwd_pallas_g``)."""
    which, jax_fn, port_fn = CALLS[entry]
    arrays = _inputs()
    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(arrays[i]) for i in which))
    dy = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(dy))
    leaves = _port_leaves(arrays, which)
    out = port_fn(*leaves)
    assert out.shape == want.shape == (2, T, D if entry == "ffn_block" else F)
    assert _rel(out.detach().numpy(), want) <= 1e-5
    out.backward(torch.from_numpy(dy))
    for i, leaf, w in zip(which, leaves, want_grads):
        assert _rel(_grad(leaf, i), w) <= 1e-5, i


def _reference(entry, leaves, keep, rate):
    """The entry point's function written out under autograd with a fixed
    keep mask: the law its forward and backward must follow."""
    x, w1, b1 = leaves[:3]
    a = x
    if entry == "ffn_ln_fc1":
        a = torch.nn.functional.layer_norm(x, (D,), leaves[3], leaves[4], 1e-5)
    g = torch.where(keep, gelu_poly(a @ w1.t() + b1) / (1.0 - rate), 0.0)
    return g @ leaves[3].t() + leaves[4] if entry == "ffn_block" else g


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_point_dropout_laws_at_rate_0_1(entry):
    """Keep fraction 0.9 over (2, 300, 512), kept activations scaled by
    1/0.9, the backward on the forward's mask (regenerated from the seeds,
    so the gradients are those of the function with that mask fixed), other
    seeds another mask, and no seeds an error."""
    rate = 0.1
    which, _, port_fn = CALLS[entry]
    arrays = _inputs(seed=2, rows=300, width=512)
    seeds = torch.tensor([3, -7], dtype=torch.int32)
    keep = philox.keep_mask(seeds, 300, 512, rate)
    assert abs(keep.float().mean().item() - 0.9) < 0.003
    leaves = _port_leaves(arrays, which)
    out = port_fn(*leaves, rate=rate, seeds=seeds)
    ref_leaves = _port_leaves(arrays, which)
    want = _reference(entry, ref_leaves, keep, rate)
    assert _rel(out.detach().numpy(), want.detach().numpy()) <= 1e-5
    if entry != "ffn_block":
        assert not out[~keep].any()
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal(out.shape)
                          .astype(np.float32))
    out.backward(dy)
    want.backward(dy)
    for i, leaf, ref in zip(which, leaves, ref_leaves):
        assert _rel(_grad(leaf, i), _grad(ref, i)) <= 1e-5, i
    other = port_fn(*(t.detach() for t in leaves), rate=rate, seeds=seeds + 1)
    assert not torch.equal(other, out.detach())
    with pytest.raises(ValueError, match="seeds"):
        port_fn(*leaves, rate=rate)


# -- the models on each route ----------------------------------------------------------

# The JAX setups' resolved flags of each pair of the table, and the port's route.
PAIRS = {
    "fused_ffn_ln=false": dict(fused_ffn_ln=False),
    "fused_ffn_block=false": dict(fused_ffn_block=False),
    "both_false": dict(fused_ffn_ln=False, fused_ffn_block=False),
}
W2V2_ROUTES = {"fused_ffn_ln=false": "ffn_block", "fused_ffn_block=false": "ffn_ln_fc1",
               "both_false": "ffn_fc1"}
WHISPER_ROUTES = {"fused_ffn_ln=false": "ffn_ln_block", "fused_ffn_block=false": "ffn_ln_fc1",
                  "both_false": "ffn_fc1"}


@pytest.mark.parametrize("pair", PAIRS)
def test_wav2vec2_model_matches_jax(pair):
    """The narrow config (D 128, F 256: the JAX FFN kernels in interpret
    mode; LN2 through ``ln_fused`` off the LayerNorm-folded routes), logits on
    a full, a padded and a filler row."""
    jax_model = JaxModel(JaxConfig(**ARCHS["narrow"], **{**PRODUCTION_FLAGS, **PAIRS[pair]}))
    params = _seeded_params(jax_model, seed=0)
    audio = np.random.default_rng(1).standard_normal((3, N_SAMPLES)).astype(np.float32)
    want, _ = jax_model.apply({"params": params}, jnp.asarray(audio), jnp.asarray(LENGTHS),
                              deterministic=True)
    model = Wav2Vec2ForCTC(Wav2Vec2Config(**ARCHS["narrow"],
                                          **{**PORT_FLAGS, **PAIRS[pair]})).eval()
    assert model.config.ffn_route == W2V2_ROUTES[pair]
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    plain = Wav2Vec2ForCTC(model.config, plain=True).eval()
    plain.load_state_dict(model.state_dict())
    args = torch.from_numpy(audio), torch.from_numpy(LENGTHS).long()
    with torch.inference_mode():
        logits, _ = model(*args)
        torch.testing.assert_close(plain(*args)[0], logits, rtol=0, atol=0)
    assert _rel(logits.numpy(), want) <= 1e-4


@pytest.mark.parametrize("pair", PAIRS)
def test_wav2vec2_train_step_matches_jax(pair):
    """Three steps of both packages' CTC step (tiny, fp32, activation dropout
    0, SpecAugment off) under save_ctx_act, which keeps "ffn_act" on the fc1
    routes in both packages."""
    flags = {**PRODUCTION_FLAGS, **PAIRS[pair]}
    jax_model = JaxModel(JaxConfig.tiny(vocab_size=VOCAB, **flags, **QUIET),
                         gradient_checkpointing=True, remat_policy="save_ctx_act")
    params = _seeded_params(jax_model, seed=0)
    model = Wav2Vec2ForCTC(Wav2Vec2Config.tiny(vocab_size=VOCAB, **{**PORT_FLAGS, **PAIRS[pair]},
                                               **QUIET))
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    model.wav2vec2.encoder.gradient_checkpointing = True
    model.wav2vec2.encoder.remat_policy = "save_ctx_act"
    _steps_match_jax(jax_model, params, model, True)


@pytest.mark.parametrize("pair", PAIRS)
def test_whisper_training_forward_matches_jax(pair):
    """``forward`` with gradients and checkpointing at the narrow config (the
    JAX FFN kernels in interpret mode, encoder and decoder) against JAX
    ``forward``; ``fused_ffn_ln: false`` alone keeps the block."""
    jc = JW.WhisperConfig(**NARROW, **{**SETUP_FLAGS, **PAIRS[pair]})
    pc = PW.WhisperConfig(**NARROW, **{**SETUP_FLAGS, **PAIRS[pair]})
    assert pc.ffn_route == WHISPER_ROUTES[pair]
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


@pytest.mark.parametrize("pair", ["fused_ffn_block=false", "both_false"])
def test_whisper_train_step_matches_jax(pair):
    """Three steps of both packages' seq2seq step (tiny_test, fp32, dropout
    and SpecAugment off, save_matmul_inputs) on the fc1 routes."""
    jc = JW.WhisperConfig.tiny_test(vocab_size=300, **{**SETUP_FLAGS, **PAIRS[pair]}, **QUIET)
    pc = PW.WhisperConfig.tiny_test(vocab_size=300, **{**SETUP_FLAGS, **PAIRS[pair]}, **QUIET)
    whisper_steps_match_jax(jc, pc)


# -- remat: the replays' bits and fc1 counts -------------------------------------------


def _count_fc1(monkeypatch):
    """Counts the fc1 forwards (the kernels' plain stand-ins on the CPU)."""
    calls = collections.Counter()
    for name in ("ffn_fc1_plain", "ffn_ln_fc1_plain"):
        fn = getattr(ffn, name)
        monkeypatch.setattr(ffn, name, lambda *a, _fn=fn, **kw: (
            calls.update(["fc1"]), _fn(*a, **kw))[1])
    return calls


# fc1 forwards per layer and microbatch under checkpointing: the blocks'
# forward never runs in the replay (their residuals are their inputs), the
# fc1 routes' does unless "ffn_act" keeps its output.
FC1_FORWARDS = {("ffn_block", p): 1 for p in ("nothing_saveable", "save_qk_ctx", "save_ctx_act")}
FC1_FORWARDS.update({(r, p): 2 for r in ("ffn_ln_fc1", "ffn_fc1")
                     for p in ("nothing_saveable", "save_qk_ctx")})
FC1_FORWARDS.update({(r, "save_ctx_act"): 1 for r in ("ffn_ln_fc1", "ffn_fc1")})


@pytest.mark.parametrize("pair,policy", [(pair, p) for pair in PAIRS
                                         for p in ("nothing_saveable", "save_qk_ctx",
                                                   "save_ctx_act")])
def test_wav2vec2_policies_keep_the_bits(pair, policy, monkeypatch):
    """Dropout 0.1, SpecAugment on and the feature encoder training: the
    gradients with checkpointing under the policy are the bits of those
    without, and the fc1 forward runs as ``FC1_FORWARDS`` says."""
    calls = _count_fc1(monkeypatch)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads, counts = [], []
    for remat in (True, False):
        torch.manual_seed(0)  # the same initial weights each time
        model = Wav2Vec2ForCTC(Wav2Vec2Config(
            vocab_size=VOCAB, **FE_ARCH, **{**PORT_FLAGS, **PAIRS[pair]}, activation_dropout=0.1,
            hidden_dropout=0.1, mask_feature_length=8))
        torch.nn.init.uniform_(model.wav2vec2.masked_spec_embed)
        model.wav2vec2.encoder.gradient_checkpointing = remat
        model.wav2vec2.encoder.remat_policy = policy
        calls.clear()
        grads.append(ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(5), BLANK,
                                        "sum", False))
        counts.append(calls["fc1"])
    A, L = 2, FE_ARCH["num_hidden_layers"]
    assert counts == [FC1_FORWARDS[W2V2_ROUTES[pair], policy] * L * A, L * A], counts
    assert torch.equal(grads[0][0], grads[1][0])
    for k in grads[0][1]:
        assert torch.equal(grads[0][1][k], grads[1][1][k]), k
    assert grads[0][1]["wav2vec2.encoder.layers.0.feed_forward.intermediate_dense.weight"].any()


@pytest.mark.parametrize("pair,policy", [(pair, p) for pair in ("fused_ffn_block=false",
                                                                "both_false")
                                         for p in sorted(PW.REMAT_POLICIES)])
def test_whisper_policies_keep_the_bits(pair, policy, monkeypatch):
    """tiny_test, activation and embedding dropout 0.1, SpecAugment on: the
    same bits with and without checkpointing; no Whisper policy names fc1's
    output, so its forward runs twice a layer under every one, in both
    stacks."""
    calls = _count_fc1(monkeypatch)
    jc = JW.WhisperConfig.tiny_test(vocab_size=300, **SETUP_FLAGS)
    pc = PW.WhisperConfig.tiny_test(vocab_size=300, **{**SETUP_FLAGS, **PAIRS[pair]}, dropout=0.1,
                                    mask_feature_length=8, remat_policy=policy)
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
        counts.append(calls["fc1"])
    L = pc.encoder_layers + pc.decoder_layers
    assert counts == [2 * L, L], counts
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
    assert grads[0]["model.encoder.layers.0.fc1.weight"].any()


# -- the setups' resolution ------------------------------------------------------------

FLAG_VALUES = ((), (True,), (False,))
COMBOS = [{k: v[0] for k, v in zip(("fused_ffn", "fused_ffn_ln", "fused_ffn_block"), values)
           if v} for values in itertools.product(FLAG_VALUES, repeat=3)]
VARIANTS = ({"fused_ffn_block_dw": True}, {"fused_ffn_block_fc2": True},
            {"fused_ffn_block_dg": False})
FLAGS = ("fused_ffn", "fused_ffn_ln", "fused_ffn_block")
VARIANT_FLAGS = ("fused_ffn_block_dw", "fused_ffn_block_fc2", "fused_ffn_block_dg")
JAX_FFN = ("ffn_ln_block", "ffn_block", "ffn_ln_fc1", "ffn_fc1")


def _config(family, flags, tmp_path):
    model = ({"type": "wav2vec2", "architecture": "tiny", "characters_to_keep": CHARS}
             if family == "wav2vec2" else
             {"type": "whisper", "architecture": "tiny_test", "sampling_rate": 16_000})
    return {"model": {**model, **flags}, "max_seconds_per_example": 1.0,
            "model_dir": str(tmp_path)}


@functools.lru_cache(maxsize=None)
def _jax_route(family, resolved):
    """The FFN function of ``coral_tpu.ops.ffn_pallas`` the JAX model calls
    at these resolved flags (``FLAGS`` and ``VARIANT_FLAGS``; None: the
    unfused FFN) and the variant keywords it passes with their values,
    traced with ``jax.eval_shape``."""
    seen = []
    saved = {name: getattr(jffn, name) for name in JAX_FFN}

    def spy(name):
        def call(*args, **kw):
            seen.append((name, tuple(sorted((k, v) for k, v in kw.items()
                                            if k.endswith("_in_kernel")))))
            return saved[name](*args, **kw)
        return call

    for name in JAX_FFN:
        setattr(jffn, name, spy(name))
    try:
        flags = dict(zip(FLAGS + VARIANT_FLAGS, resolved))
        if family == "wav2vec2":
            model = JaxModel(JaxConfig.tiny(vocab_size=VOCAB, **flags))
            jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, N_SAMPLES)),
                           jnp.array([N_SAMPLES]))
        else:
            cfg = JW.WhisperConfig.tiny_test(vocab_size=300, **flags)
            jax.eval_shape(lambda: JW.forward(JW.init_whisper_params(jax.random.PRNGKey(0), cfg),
                                              cfg, jnp.zeros((1, 200, 80)),
                                              jnp.zeros((1, 4), jnp.int32)))
    finally:
        for name, fn in saved.items():
            setattr(jffn, name, fn)
    assert len(set(seen)) <= 1, seen
    return seen[0] if seen else (None, ())


@pytest.mark.parametrize("family", ["wav2vec2", "whisper"])
@pytest.mark.parametrize("flags", COMBOS, ids=lambda f: ",".join(
    f"{k}={v}" for k, v in f.items()) or "defaults")
def test_ffn_flags_resolve_and_route_as_the_jax_setups(family, flags, tmp_path):
    """Every combination of fused_ffn, fused_ffn_ln and fused_ffn_block
    (absent, true, false), alone and with each block variant (_dw, _fc2,
    _dg off their defaults): the port resolves them as the JAX setup, takes
    the route the JAX model takes (``ffn_route`` against the JAX model's call
    into ``ffn_pallas``), and on the LayerNorm-folded block, the only route
    where the JAX model reads the variant flags, passes ``ffn_ln_block`` the
    variant keywords the JAX model passes, with their values."""
    for variant in ({}, *VARIANTS):
        config = _config(family, {**flags, **variant}, tmp_path)
        want = jax_load_model_setup(DictConfig(config)).model_config
        got = load_model_setup(config, device="cpu").model_config
        resolved = tuple(getattr(want, k) for k in FLAGS + VARIANT_FLAGS)
        assert tuple(getattr(got, k) for k in FLAGS + VARIANT_FLAGS) == resolved
        jax_fn, variant_keywords = _jax_route(family, resolved)
        assert got.ffn_route == (jax_fn or "unfused")
        reads_variants = bool(variant_keywords)
        assert reads_variants == (got.ffn_route == "ffn_ln_block")
        if reads_variants:
            assert got.ffn_block_flags == dict(variant_keywords)
            assert got.ffn_variant == ffn.block_variant(**got.ffn_block_flags)
        else:
            assert got.ffn_variant is None


@pytest.mark.parametrize("family", ["wav2vec2", "whisper"])
@pytest.mark.parametrize("flags", [{}, {"fused_ffn_ln": False}, {"fused_ffn_block": False},
                                   {"fused_ffn": False}],
                         ids=["defaults", "ln_false", "block_false", "unfused"])
def test_save_ctx_act_warnings_follow_the_jax_setup(family, flags, tmp_path, caplog):
    """The JAX setup warns that save_ctx_act degrades without fused_ffn, and
    again with fused_ffn_block (whatever fused_ffn says); the port's
    wav2vec2 setup gives the same warnings, and Whisper's none (its
    policies have no save_ctx_act)."""
    config = _config(family, {**flags, "remat_policy": "save_ctx_act"}, tmp_path)
    counts = []
    for load in (lambda: jax_load_model_setup(DictConfig(config)),
                 lambda: load_model_setup(config, device="cpu")):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            load()
        counts.append(sorted(r.getMessage() for r in caplog.records
                             if "save_ctx_act" in r.getMessage() and "degrades" in r.getMessage()))
    assert counts[0] == counts[1]


def test_kernel_widths_name_the_route():
    """The fc1 routes need the FFN kernels' widths; Whisper's "ffn_fc1" needs
    no LayerNorm backward kernel, its LayerNorm-folded routes do."""
    from coral_tpu_torch.models import wav2vec2
    from coral_tpu_torch.training.model_setup import check_kernel_widths

    for pair in PAIRS.values():
        flags = {**PORT_FLAGS, **pair}
        names = [w[0] for w in wav2vec2.kernel_widths(Wav2Vec2Config(**flags))]
        assert any(Wav2Vec2Config(**flags).ffn_route in n for n in names)
        check_kernel_widths(Wav2Vec2Config.xls_r_2b(**flags))
    names = [w[0] for w in PW.kernel_widths(
        PW.WhisperConfig.large_v3(**{**SETUP_FLAGS, **PAIRS["both_false"]}))]
    assert not any("LayerNorm" in n for n in names)
    names = [w[0] for w in PW.kernel_widths(
        PW.WhisperConfig.large_v3(**{**SETUP_FLAGS, "fused_ffn_block": False}))]
    assert any("LayerNorm" in n for n in names)
    with pytest.raises(NotImplementedError, match="Queue 2 item 3"):
        check_kernel_widths(Wav2Vec2Config(hidden_size=640, num_attention_heads=10,
                                           intermediate_size=2560,
                                           **{**PORT_FLAGS, **PAIRS["both_false"]}))
    assert dataclasses.replace(PW.WhisperConfig(), fused_ffn=False).ffn_route == "unfused"
