"""coral_tpu_torch's serving path: predictor, ASRPipeline, rejections, imports.

The port's ``make_predictor`` is held against the JAX ``make_predictor`` on
bridged weights: the same transcripts (greedy argmax + CTC collapse), a
partial batch included, and logits within max-normalised 1e-4 (the JAX
package's model-parity bound; fp32 on both sides).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from coral_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC
from coral_tpu_torch.training import model_setup as port_setup

REPO = Path(__file__).resolve().parent.parent
CHARS = "abcdefghijklmnopqrstuvwxyzæøå0123456789éü"


def _clips(n, seed=0, max_len=4000):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(rng.integers(1500, max_len))) * 0.1).astype(np.float32)
            for _ in range(n)]


def _batch(clips, batch_size, T=4000):
    audio = np.zeros((batch_size, T), np.float32)
    lengths = np.ones((batch_size,), np.int32)  # filler rows, as transcribe_batch
    for j, clip in enumerate(clips):
        audio[j, : len(clip)] = clip
        lengths[j] = len(clip)
    return {"input_values": audio, "input_lengths": lengths}


def test_predictor_matches_jax_make_predictor(config_path, tmp_path):
    from coral_tpu.config import compose
    from coral_tpu.parallel import create_mesh, replicated
    from coral_tpu.training.model_setup import Wav2Vec2Setup

    config = compose(
        "asr_finetuning",
        overrides=["model=test-wav2vec2", "datasets=[synthetic]",
                   "+model.architecture=tiny", "bf16_allowed=false",
                   f"model_dir={tmp_path / 'model'}"],
        config_path=config_path,
    )
    jax_setup = Wav2Vec2Setup(config)
    params = jax_setup.init_params(jax.random.PRNGKey(0))
    mesh = create_mesh((4, 1))
    param_sh = jax.tree.map(lambda _: replicated(mesh), params)
    jax_predict = jax_setup.make_predictor(mesh, param_sh)

    setup = port_setup.Wav2Vec2Setup(
        {"model": {"type": "wav2vec2", "architecture": "tiny", "characters_to_keep": CHARS},
         "max_seconds_per_example": 5.0, "bf16_allowed": False}
    )
    model = Wav2Vec2ForCTC(setup.model_config).eval()
    model.load_state_dict(wav2vec2_state_dict_from_jax(
        jax.tree.map(np.asarray, params), setup.model_config))
    predict = setup.make_predictor(model)

    batch = _batch(_clips(3), batch_size=4)  # a partial batch: one filler row
    assert predict(batch) == jax_predict(jax.device_put(params, param_sh), batch)

    logits, frames = predict.logits(batch)
    jax_logits, jax_frames = jax_setup.model.apply(
        {"params": params}, _jax_znorm(batch), batch["input_lengths"],
        deterministic=True,
    )
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jax_frames))
    scale = np.abs(np.asarray(jax_logits)).max()
    np.testing.assert_allclose(logits.numpy() / scale, np.asarray(jax_logits) / scale,
                               atol=1e-4)


def _jax_znorm(batch):
    from coral_tpu.audio.features import znorm

    return znorm(batch["input_values"], batch["input_lengths"])


def test_init_params_is_seeded():
    setup = port_setup.Wav2Vec2Setup(
        {"model": {"architecture": "tiny", "characters_to_keep": CHARS},
         "max_seconds_per_example": 5.0}
    )
    first, again, other = (setup.init_params(seed).state_dict() for seed in (0, 0, 1))
    assert all(torch.equal(first[k], again[k]) for k in first)
    weight = "wav2vec2.encoder.layers.0.attention.q_proj.weight"
    assert not torch.equal(first[weight], other[weight])
    # flax's init: unit LayerNorm scales, zero biases.
    assert torch.equal(first["wav2vec2.encoder.layer_norm.weight"], torch.ones(32))
    assert not any(first[k].any() for k in first if k.endswith("bias"))


@pytest.fixture
def offline_hub(tmp_path, monkeypatch):
    """An empty Hugging Face cache, so no pretrained id resolves to a file."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    return tmp_path


def test_asr_pipeline_end_to_end_tiny(offline_hub):
    from coral_tpu_torch import ASRPipeline

    asr = ASRPipeline("example/wav2vec2-tiny-random", batch_size=2)
    assert asr.predictor.model.config.hidden_size == 32  # the id picked the tiny config
    assert asr.predictor.model.config.dtype == torch.bfloat16
    clips = _clips(3, max_len=48_000)

    batch = asr.transcribe_batch(clips)  # two device batches, the second partial
    assert len(batch) == 3 and all(isinstance(t, str) for t in batch)
    assert asr.transcribe(clips[0]) == batch[0]
    assert list(asr.transcribe_stream(clips)) == batch
    assert isinstance(asr.transcribe({"array": clips[1], "sampling_rate": 8_000}), str)

    long_clip = np.tile(clips[0], 45 * 16_000 // len(clips[0]) + 1)  # > 30 s window
    assert isinstance(asr.transcribe(long_clip), str)


def test_saved_model_directory_is_rejected(tmp_path):
    from coral_tpu_torch.evaluation.evaluate import load_saved_predictor

    (tmp_path / "config.yaml").write_text("model: {}\n")
    with pytest.raises(NotImplementedError, match="ROADMAP.*saved model"):
        load_saved_predictor({"model_id": str(tmp_path)})


def test_ngram_decoder_is_rejected_unless_no_lm(offline_hub):
    from coral_tpu_torch import ASRPipeline

    model_dir = offline_hub / "wav2vec2-tiny-lm"
    model_dir.mkdir()
    (model_dir / "3gram.arpa").write_text("\\data\\\n")
    with pytest.raises(NotImplementedError, match="ROADMAP.*beam search"):
        ASRPipeline(model_dir)
    assert ASRPipeline(model_dir, no_lm=True).predictor.model.config.hidden_size == 32


def test_local_checkpoint_is_rejected_not_replaced_by_random_weights(offline_hub):
    from coral_tpu_torch import ASRPipeline

    ckpt_dir = offline_hub / "wav2vec2-tiny-ckpt"
    ckpt_dir.mkdir()
    (ckpt_dir / "model.safetensors").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP.*HF checkpoints"):
        ASRPipeline(ckpt_dir)


def test_whisper_and_beam_search_are_rejected(offline_hub):
    from coral_tpu_torch import ASRPipeline

    with pytest.raises(NotImplementedError, match="ROADMAP.*Whisper"):
        ASRPipeline("openai/whisper-tiny")
    setup = port_setup.Wav2Vec2Setup(
        {"model": {"architecture": "tiny", "characters_to_keep": CHARS},
         "max_seconds_per_example": 5.0}
    )
    with pytest.raises(NotImplementedError, match="ROADMAP.*beam search"):
        setup.make_beam_predictor()


@pytest.mark.parametrize("flag,value", [
    ("attention_save_stats", "v2"), ("fused_qkv_ln", True),
    ("fused_ffn_block_fc2", True), ("attention_impl", "xla"), ("fused_fe_conv", False),
])
def test_off_default_kernel_flags_are_rejected(flag, value):
    with pytest.raises(NotImplementedError, match="ROADMAP.*kernel flags"):
        port_setup.Wav2Vec2Setup(
            {"model": {"architecture": "tiny", "characters_to_keep": CHARS, flag: value},
             "max_seconds_per_example": 5.0}
        )


def test_every_module_imports_with_jax_blocked():
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml"):
    sys.modules[name] = None
import coral_tpu_torch
names = [m.name for m in pkgutil.walk_packages(coral_tpu_torch.__path__, "coral_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from coral_tpu_torch import ASRPipeline
from coral_tpu.evaluation.longform import chunk_waveform
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "coral_tpu")
assert all(m.startswith(("coral_tpu.text", "coral_tpu.evaluation")) or m == "coral_tpu"
           for m in loaded), loaded
print(len(names))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 13
