"""coral_tpu_torch's Whisper beam search, timestamp grammar and predictor against coral_tpu's.

The JAX side runs as its own tests run it on the CPU (the decode-attention
kernels through their off-TPU composition). The model is the JAX ``tiny_test``
at vocab 300 with the JAX Whisper setup's kernel flags, its weights drawn by
numpy from a seed (``tests/test_torch_whisper.py``'s ``_seeded_params``) and
bridged into the port by ``whisper_state_dict_from_jax``; the mel features
come from a seeded numpy draw with a per-row offset, so the rows decode
differently. EOS is id 201, a token the seeded model emits, so beams finish
at different lengths and the finished store, the length penalty and the
early-stopping rules all act; ids 202-259 are specials, 259 is
``<|notimestamps|>`` and 260-299 are timestamps. ``max_length`` 16 (one cache
phase), 80 where two phases (64, 80) must run.

Tolerances: generated ids and transcripts exactly equal (fp32 on both sides;
the logits agree within 1e-4 of their max, ``tests/test_torch_whisper.py``);
``apply_timestamp_rules``' masks exactly, its other values at rtol 1e-6
(log-softmax sums in another order); ``_top_k`` values and indices exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coral_tpu.models import whisper as JW
from coral_tpu_torch.models import whisper as PW
from coral_tpu_torch.models.convert import whisper_state_dict_from_jax
from test_torch_whisper import SETUP_FLAGS, _seeded_params

torch.set_num_threads(1)

VOCAB, EOS, TS_BEGIN = 300, 201, 260
NO_TS = TS_BEGIN - 1
FORCED = [251, 252, 253]
MAX_LEN = 16
B, T_MEL = 3, 200


def _case(positions):
    """tiny_test's widths (d 32, 2 + 2 layers, 2 heads, FFN 64) with
    ``positions`` decoder positions."""
    arch = dict(vocab_size=VOCAB, d_model=32, encoder_layers=2, decoder_layers=2,
                encoder_attention_heads=2, decoder_attention_heads=2, ffn_dim=64,
                max_target_positions=positions, **SETUP_FLAGS)
    jc, pc = JW.WhisperConfig(**arch), PW.WhisperConfig(**arch)
    params = _seeded_params(jc, seed=1)
    model = PW.WhisperForConditionalGeneration(pc).eval()
    model.load_state_dict(whisper_state_dict_from_jax(params, pc))
    rng = np.random.default_rng(2)
    feats = (rng.standard_normal((B, T_MEL, 80))
             + 3.0 * rng.standard_normal((B, 1, 80))).astype(np.float32)
    return jc, params, model, feats


@pytest.fixture(scope="module")
def case():
    return _case(64)  # tiny_test


def _both(case, generate, max_length=MAX_LEN, eos=EOS, **kw):
    """The JAX and the port's ``generate`` (a function name) on the same
    features and keywords; asserts the ids equal and returns them."""
    jc, params, model, feats = case
    jkw = {k: (jnp.asarray(v) if k == "suppress_ids" else v) for k, v in kw.items()}
    want = np.asarray(getattr(JW, generate)(params, jc, jnp.asarray(feats),
                                            jnp.asarray(FORCED), max_length, eos, **jkw))
    got = getattr(PW, generate)(model, torch.from_numpy(feats), FORCED, max_length, eos,
                                **kw).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (B, max_length)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("num_beams,length_penalty", [(2, 1.0), (3, 0.0), (5, 1.0), (5, 2.0)])
def test_beam_generate_matches_jax(case, num_beams, length_penalty):
    ids = _both(case, "beam_generate", num_beams=num_beams, length_penalty=length_penalty)
    assert (ids[:, :3] == FORCED).all()


@pytest.mark.parametrize("early_stopping", [True, "never"])
def test_beam_early_stopping_matches_jax(case, early_stopping):
    ids = _both(case, "beam_generate", num_beams=5, early_stopping=early_stopping)
    if early_stopping is True:
        # The finished store acts: with EOS 201 some rows end early and others
        # run to max_length, and stopping early changes a row.
        _, _, model, feats = case
        late = PW.beam_generate(model, torch.from_numpy(feats), FORCED, MAX_LEN, EOS,
                                num_beams=5).numpy()
        ended = (ids == EOS).any(axis=1)
        assert ended.any() and not ended.all() and (ids != late).any()


def test_beam_with_timestamps_matches_jax(case):
    ids = _both(case, "beam_generate", num_beams=3, timestamps=True, timestamp_begin=TS_BEGIN)
    assert (ids[:, 3] >= TS_BEGIN).all() and not (ids == NO_TS).any()


def test_beam_with_suppress_ids_matches_jax(case):
    """Suppressing the tokens the unsuppressed search picks moves it."""
    free = _both(case, "beam_generate", num_beams=4)
    banned = sorted({int(t) for t in free[:, 3:].ravel()} - {EOS})[:3]
    ids = _both(case, "beam_generate", num_beams=4, suppress_ids=np.asarray(banned, np.int32))
    assert not np.isin(ids[:, 3:], banned).any()


def test_beam_over_two_cache_phases_matches_jax():
    """max_length 80 (96 decoder positions): the phases 64 and 80, the slot
    mask re-sized between them; EOS 250, which the model never emits, so every
    beam reaches 80."""
    assert PW._decode_phases(80) == [64, 80]
    ids = _both(_case(96), "beam_generate", max_length=80, eos=250, num_beams=3)
    assert (ids[:, 64:] != 250).all()


def test_num_beams_one_is_greedy(case):
    jc, params, model, feats = case
    got = PW.beam_generate(model, torch.from_numpy(feats), FORCED, MAX_LEN, EOS, num_beams=1)
    want = PW.greedy_generate(model, torch.from_numpy(feats), FORCED, MAX_LEN, EOS)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    _both(case, "beam_generate", num_beams=1)


@pytest.mark.parametrize("suppress", [False, True])
def test_greedy_with_timestamps_matches_jax(case, suppress):
    kw = dict(timestamps=True, timestamp_begin=TS_BEGIN)
    if suppress:
        kw["suppress_ids"] = np.asarray([TS_BEGIN, TS_BEGIN + 1, 5, 56], np.int32)
    ids = _both(case, "greedy_generate", **kw)
    assert (ids[:, 3] >= TS_BEGIN).all() and (ids[:, 3] <= TS_BEGIN + 50).all()
    assert not (ids == NO_TS).any()
    if suppress:
        assert not np.isin(ids[:, 3:], kw["suppress_ids"]).any()


def test_greedy_with_suppress_ids_matches_jax(case):
    free = _both(case, "greedy_generate")
    ids = _both(case, "greedy_generate", suppress_ids=np.unique(free[:, 3:5]).astype(np.int32))
    assert (ids != free).any()


def _grammar_prefix(rng, gen_len):
    """A generated suffix that keeps the timestamp grammar: it opens with a
    timestamp of at most TS_BEGIN + 50, timestamps come in non-decreasing
    pairs (or a lone one awaiting its pair), text between them."""
    toks, last = [], TS_BEGIN
    for i in range(gen_len):
        prev = toks[-1] if toks else None
        prev2 = toks[-2] if len(toks) > 1 else None
        if i == 0:
            t = int(rng.integers(TS_BEGIN, VOCAB))
        elif prev >= TS_BEGIN and (prev2 is None or prev2 < TS_BEGIN):
            # a lone timestamp: its pair (>= it) or text
            t = int(rng.integers(prev, VOCAB)) if rng.random() < 0.5 else int(rng.integers(EOS))
        elif prev >= TS_BEGIN:
            t = int(rng.integers(EOS))  # a completed pair: text
        else:
            t = int(rng.integers(last, VOCAB)) if rng.random() < 0.3 else int(rng.integers(EOS))
        if t >= TS_BEGIN:
            last = t
        toks.append(t)
    return FORCED + toks


def _random_prefix(rng, gen_len):
    """Any mix of text, specials and timestamps (the HF parity test's draw)."""
    draw = [int(rng.integers(0, EOS)) if r < 0.45 else int(rng.integers(EOS, TS_BEGIN))
            if r < 0.55 else int(rng.integers(TS_BEGIN, VOCAB)) for r in rng.random(gen_len)]
    return FORCED + draw


@pytest.mark.parametrize("kind", ["grammar", "random"])
@pytest.mark.parametrize("gen_len", [0, 1, 2, 3, 4, 5, 6])
def test_timestamp_rules_match_jax(gen_len, kind):
    rng = np.random.default_rng(31 + gen_len)
    n_forced, N, L = len(FORCED), 16, 12
    pos = n_forced + gen_len - 1
    draw = _grammar_prefix if kind == "grammar" else _random_prefix
    buffer = np.full((N, L), EOS, np.int32)
    buffer[:, : pos + 1] = [draw(rng, gen_len) for _ in range(N)]
    # Log-probs with a timestamp block that sometimes outweighs the text.
    logits = (rng.standard_normal((N, VOCAB)) * 3).astype(np.float32)
    logits[: N // 2, TS_BEGIN:] += 2.0
    want = np.asarray(JW.apply_timestamp_rules(jnp.asarray(logits), jnp.asarray(buffer),
                                               jnp.asarray(pos, jnp.int32), n_forced,
                                               TS_BEGIN, EOS))
    got = PW.apply_timestamp_rules(torch.from_numpy(logits), torch.from_numpy(buffer), pos,
                                   n_forced, TS_BEGIN, EOS).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_array_equal(got == -1e30, want == -1e30)
    keep = want > -1e29
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_top_k_breaks_ties_toward_the_lower_index(k):
    """Rows with many exact ties (small integers, -1e9 folds at ulp 64, -inf,
    both zeros): values and indices as ``jax.lax.top_k``'s, ties in index
    order."""
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 3, size=(6, 40)).astype(np.float32)
    x[1] = -1e9 + rng.integers(0, 2, size=40).astype(np.float32) * 64
    x[2, ::3] = -np.inf
    x[3] = rng.standard_normal(40).astype(np.float32) + np.float32(-1e9)
    x[4] = 0.0
    x[5, :20] = -1e30
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = PW._top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert (got_i.numpy()[4] == np.arange(k)).all()


def test_beam_slot_mask_follows_the_ancestor_chains():
    """Slot j at position t is open to beam k iff anc[b, k, t] == j and
    t <= pos: exactly one slot a position up to pos, none after."""
    rng = np.random.default_rng(0)
    anc = torch.from_numpy(rng.integers(0, 4, size=(2, 4, 20)).astype(np.int32))
    mask = PW.beam_slot_mask(anc, 9, 16)
    assert mask.dtype == torch.float32 and mask.shape == (2, 4, 4 * 16) and mask.is_contiguous()
    m = mask.view(2, 4, 4, 16)
    assert (m.sum(2)[..., :10] == 1).all() and not m[..., 10:].any()
    onehot = torch.nn.functional.one_hot(anc[..., :10].long(), 4).permute(0, 1, 3, 2)
    assert torch.equal(m[..., :10], onehot.float())


@pytest.mark.parametrize("model_keys", [
    {"generation_num_beams": 5},
    {"return_timestamps": True},
    {"generation_num_beams": 3, "return_timestamps": True, "generation_length_penalty": 0.0},
], ids=["beams5", "timestamps", "beams3_timestamps"])
def test_make_predictor_matches_jax(model_keys, tmp_path):
    """The whole serving slice through both setups (``tiny_test``, vocab 1864,
    max_length 16, fp32): the JAX predictor on its params, the port's on the
    bridged weights, the same strings."""
    from coral_tpu.config import DictConfig
    from coral_tpu.parallel import create_mesh, replicated
    from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
    from coral_tpu_torch.training.model_setup import load_model_setup

    model_cfg = {"type": "whisper", "architecture": "tiny_test",
                 "pretrained_model_id": "example/whisper-tiny_test-random",
                 "sampling_rate": 16_000, "language": "danish", "max_length": 16,
                 **model_keys}
    config = {"model": model_cfg, "bf16_allowed": False, "max_seconds_per_example": 2,
              "model_dir": str(tmp_path / "model")}
    jax_setup = jax_load_model_setup(DictConfig(config))
    setup = load_model_setup(config, device="cpu")
    params = _seeded_params(dataclasses.replace(jax_setup.model_config), seed=3)
    mesh = create_mesh((1, 1))
    param_sh = jax.tree.map(lambda _: replicated(mesh), params)
    jax_predict = jax_setup.make_predictor(mesh, param_sh)
    model = setup.init_params(seed=0)
    model.load_state_dict(whisper_state_dict_from_jax(params, setup.model_config))
    predict = setup.make_predictor(model)

    rng = np.random.default_rng(4)
    audio = np.zeros((2, 32_000), np.float32)
    audio[0] = rng.standard_normal(32_000) * 0.1
    audio[1, :20_000] = rng.standard_normal(20_000) * 0.3
    batch = {"input_values": audio, "input_lengths": np.array([32_000, 20_000], np.int32)}
    want = jax_predict(jax.device_put(params, param_sh), batch)
    got = predict(batch)
    assert got == want and len(got) == 2 and all(isinstance(t, str) for t in got)
    ids = predict.generate(model, batch).numpy()
    if model_keys.get("return_timestamps"):
        tok = setup.tokenizer
        assert (ids[:, 3] >= tok.timestamp_begin).all()
        assert not (ids == tok.notimestamps_token_id).any()
