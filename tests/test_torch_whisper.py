"""coral_tpu_torch's Whisper serving slice against coral_tpu's, on bridged weights.

The JAX side runs as on the CPU, with the JAX Whisper setup's kernel flags
(the FFN as ``ffn_ln_block``): its decode-attention kernels take their off-TPU
composition and its encoder attention ``jax.nn.dot_product_attention`` (the
flash kernel is TPU-only). Weights are drawn by numpy from a seed into the
tree of ``init_whisper_params``, with non-zero biases, and bridged into the
port by ``whisper_state_dict_from_jax``. Two configs: the JAX ``tiny_test``
(d 32: the JAX FFN block falls back to its XLA reference), and a narrow one
(d 128, 2 x 64 heads, FFN 256, 2 + 2 layers) at which JAX runs ``ffn_ln_block``
in interpret mode; and ``tiny_test`` with ``fused_ffn: false`` (the FFN's
LayerNorm, fc1, exact erf GELU and fc2 apart). Inputs: 80 mels, T_mel 200.

Tolerances (fp32 on both sides, reductions in another order): the log-mel
features within 1e-4 absolute (values of order 1 after log10 of sums of up to
201 bins); the encoder output and the decode step's logits within 1e-4 of
max |JAX|, the JAX package's model-parity bound (tests/test_whisper.py); the
updated cache within 1e-5 absolute; greedy ids and transcripts exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coral_tpu.audio.mel import log_mel_spectrogram as jax_log_mel
from coral_tpu.models import whisper as JW
from coral_tpu_torch.audio.mel import log_mel_spectrogram
from coral_tpu_torch.models import whisper as PW
from coral_tpu_torch.models.convert import whisper_state_dict_from_jax

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

REL_TOL = 1e-4
# coral_tpu/training/model_setup.py WhisperSetup's FFN flags (serving defaults).
SETUP_FLAGS = dict(fused_ffn=True, fused_ffn_ln=True, fused_ffn_block=True,
                   fused_ffn_block_dg=True)
NARROW = dict(vocab_size=300, d_model=128, encoder_layers=2, decoder_layers=2,
              encoder_attention_heads=2, decoder_attention_heads=2, ffn_dim=256,
              max_target_positions=64)
# coral_tpu/training/model_setup.py's resolution of `fused_ffn: false`: the
# LayerNorm, fc1, exact erf GELU (GELU+dropout in training) and fc2 apart.
UNFUSED_FLAGS = dict(fused_ffn=False, fused_ffn_ln=False, fused_ffn_block=True,
                     fused_ffn_block_dg=True)
ARCHS = ("tiny_test", "narrow", "tiny_test_unfused")
B, T_MEL, N_MELS = 3, 200, 80
FORCED = [290, 291, 292, 293]


def _configs(name):
    if name == "tiny_test_unfused":
        return (JW.WhisperConfig.tiny_test(vocab_size=300, **UNFUSED_FLAGS),
                PW.WhisperConfig.tiny_test(vocab_size=300, **UNFUSED_FLAGS))
    if name == "tiny_test":
        return (JW.WhisperConfig.tiny_test(vocab_size=300, **SETUP_FLAGS),
                PW.WhisperConfig.tiny_test(vocab_size=300, **SETUP_FLAGS))
    return JW.WhisperConfig(**NARROW, **SETUP_FLAGS), PW.WhisperConfig(**NARROW, **SETUP_FLAGS)


def _seeded_params(config, seed):
    """``init_whisper_params``' tree filled by numpy: LayerNorm scales near 1,
    biases small and non-zero, embeddings N(0, 1), kernels scaled by their
    fan-in; the encoder's sinusoid table kept."""
    tree = jax.tree.map(np.asarray, JW.init_whisper_params(jax.random.PRNGKey(0), config))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "encoder" in name and "embed_positions" in name:
            return leaf
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * a
        if "embed" in name:
            return a  # unit scale: the decoder's ids and positions move its logits
        if leaf.ndim == 1:
            return 0.1 * a
        return a / np.sqrt(np.prod(leaf.shape[-3:-1]) if "conv" in name else leaf.shape[-2])

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    jc, pc = _configs(request.param)
    params = _seeded_params(jc, seed=1)
    model = PW.WhisperForConditionalGeneration(pc).eval()
    model.load_state_dict(whisper_state_dict_from_jax(params, pc))
    rng = np.random.default_rng(2)
    # A per-row offset of the mel bins, so the rows' greedy ids differ.
    feats = (rng.standard_normal((B, T_MEL, N_MELS))
             + 3.0 * rng.standard_normal((B, 1, N_MELS))).astype(np.float32)
    return jc, params, model, feats


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels):
    audio = (np.random.default_rng(0).standard_normal((2, 3 * 16_000)) * 0.1).astype(np.float32)
    audio[1, :8000] = 0.0  # a silent stretch: the max - 8 floor binds
    want = np.asarray(jax_log_mel(jnp.asarray(audio), n_mels=n_mels))
    got = log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert got.shape == want.shape == (2, 300, n_mels)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def test_encode_matches_jax(case):
    jc, params, model, feats = case
    want = np.asarray(JW.encode(params, jc, jnp.asarray(feats)))
    with torch.no_grad():
        got = PW.encode(model, torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (B, T_MEL // 2, jc.d_model)
    assert _rel(got, want) <= REL_TOL


def test_decode_step_matches_jax(case):
    """Three decode positions from the same encoder states: the logits and the
    cache rows each step writes."""
    jc, params, model, feats = case
    enc = np.asarray(JW.encode(params, jc, jnp.asarray(feats)))
    jkv = JW.precompute_cross_kv(params, jc, jnp.asarray(enc))
    with torch.no_grad():
        pkv = PW.precompute_cross_kv(model, torch.from_numpy(enc.copy()))
    assert _rel(pkv[0].numpy(), jkv[0]) <= REL_TOL and _rel(pkv[1].numpy(), jkv[1]) <= REL_TOL
    jcache = JW.init_self_cache(jc, B, 16)
    pcache = PW.init_self_cache(model.config, B, 16, "cpu")
    tokens = np.array([5, 7, 9])
    for pos in range(3):
        jlogits, jcache = JW.decode_step(params, jc, jnp.asarray(tokens),
                                         jnp.asarray(pos, jnp.int32), jcache, jkv)
        with torch.no_grad():
            plogits, pcache = PW.decode_step(model, torch.from_numpy(tokens), pos, pcache, pkv)
        assert plogits.dtype == torch.float32
        assert _rel(plogits.numpy(), jlogits) <= REL_TOL
        for got, want in zip(pcache, jcache):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        tokens = np.asarray(jlogits).argmax(-1)


def test_greedy_generate_matches_jax(case):
    """Exactly the same ids over max_length 16, and the same EOS handling: with
    EOS set to an id that one row emits mid-sequence, that row is EOS from
    there on while the others run on."""
    jc, params, model, feats = case

    def both(eos):
        want = np.asarray(JW.greedy_generate(params, jc, jnp.asarray(feats),
                                             jnp.asarray(FORCED), 16, eos))
        got = PW.greedy_generate(model, torch.from_numpy(feats), FORCED, 16, eos).numpy()
        np.testing.assert_array_equal(got, want)
        return got

    ids = both(eos=299)
    assert (ids[:, :4] == FORCED).all()
    row, col = next((r, c) for c in range(5, 16) for r in range(B)
                    if ids[r, c] not in ids[r, 4:c] and ids[r, c] not in FORCED)
    eos = int(ids[row, col])
    ids = both(eos=eos)
    first = int(np.argmax(ids[row] == eos))
    assert 4 <= first <= col and (ids[row, first:] == eos).all()
    assert not all((ids[r, 4:] == eos).all() for r in range(B)), "every row finished"


def test_decode_phases_and_pad_cache_match_jax():
    for n in (16, 64, 65, 225, 448):
        assert PW._decode_phases(n) == JW._decode_phases(n)
    cache = PW.init_self_cache(PW.WhisperConfig.tiny_test(), 2, 64, "cpu")
    cache[0][:] = 1.0
    k, v = PW._pad_cache(cache, 128)
    assert k.shape == (2, 2, 128, 32) and bool((k[:, :, :64] == 1).all())
    assert not k[:, :, 64:].any() and not v.any()


def test_serving_slice_matches_jax_make_predictor(config_path, tmp_path):
    """The whole slice through both packages' setups: ``load_model_setup`` with
    ``type: whisper`` and ``architecture: tiny_test``, the JAX predictor on its
    params, the port's on the bridged weights, fp32: the same strings."""
    from coral_tpu.config import DictConfig
    from coral_tpu.parallel import create_mesh, replicated
    from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
    from coral_tpu_torch.training.model_setup import load_model_setup

    model_cfg = {"type": "whisper", "architecture": "tiny_test",
                 "pretrained_model_id": "example/whisper-tiny_test-random",
                 "sampling_rate": 16_000, "language": "danish", "max_length": 16}
    config = {"model": model_cfg, "bf16_allowed": False, "max_seconds_per_example": 2,
              "model_dir": str(tmp_path / "model")}
    jax_setup = jax_load_model_setup(DictConfig(config))
    setup = load_model_setup(config, device="cpu")
    assert setup.model_config.vocab_size == jax_setup.model_config.vocab_size == 1864
    assert setup.audio_pad_seconds == jax_setup.audio_pad_seconds == 30
    jc = dataclasses.replace(jax_setup.model_config)
    params = _seeded_params(jc, seed=3)
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


@pytest.mark.parametrize("model_id,arch,layers", [
    ("openai/whisper-large-v3", "large_v3", 32), ("openai/whisper-large-v3-turbo",
                                                  "large_v3_turbo", 4)])
def test_setup_builds_the_v3_configs_the_jax_setup_cannot(model_id, arch, layers, tmp_path,
                                                          monkeypatch):
    """The JAX v3 factories fix vocab_size and raise on the setup's own
    ``vocab_size=`` (a fault of the reference); the port's take it: the
    published widths with the byte-fallback vocabulary."""
    from coral_tpu_torch.training.model_setup import load_model_setup

    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(TypeError, match="vocab_size"):
        getattr(JW.WhisperConfig, arch)(vocab_size=1864)
    setup = load_model_setup({"model": {"type": "whisper", "pretrained_model_id": model_id}},
                             device="cpu")
    cfg = setup.model_config
    assert (cfg.vocab_size, cfg.num_mel_bins, cfg.d_model, cfg.encoder_layers,
            cfg.decoder_layers, cfg.encoder_attention_heads, cfg.ffn_dim, cfg.dtype) == (
        1864, 128, 1280, 32, layers, 20, 5120, torch.bfloat16)
    assert setup.generation_max_length == 225 and setup.audio_pad_seconds == 30
