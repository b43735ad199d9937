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

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

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
         "max_seconds_per_example": 5.0, "bf16_allowed": False}, device="cpu"
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
         "max_seconds_per_example": 5.0}, device="cpu"
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

    asr = ASRPipeline("example/wav2vec2-tiny-random", batch_size=2, device="cpu")
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


def test_asr_pipeline_serves_whisper(offline_hub):
    """A Whisper id builds the Whisper setup (whisper-tiny's widths, the
    byte-fallback vocabulary) and transcribes through greedy generation."""
    from coral_tpu_torch import ASRPipeline
    from coral_tpu_torch.training.model_setup import WhisperPredictor

    asr = ASRPipeline("openai/whisper-tiny", batch_size=2, device="cpu")
    assert isinstance(asr.predictor, WhisperPredictor)
    cfg = asr.predictor.model.config
    assert (cfg.d_model, cfg.decoder_layers, cfg.vocab_size, cfg.dtype) == (
        384, 4, 1864, torch.bfloat16)
    assert asr.window_seconds == 30
    texts = asr.transcribe_batch(_clips(3, max_len=16_000))  # the second batch partial
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)


def test_entry_points_default_to_the_card():
    """Every entry point builds on ``cuda`` unless asked for the CPU; without a
    card that raises, as torch does, with no CPU fallback."""
    import inspect

    from coral_tpu_torch import ASRPipeline
    from coral_tpu_torch.evaluation.evaluate import evaluate, load_saved_predictor
    from coral_tpu_torch.training.finetune import finetune

    for fn in (ASRPipeline, load_saved_predictor, evaluate, finetune, port_setup.Wav2Vec2Setup,
               port_setup.WhisperSetup, port_setup.load_model_setup):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # whisper-tiny: a width the kernels take (on the card the setup refuses
    # tiny_test's 32 before it builds anything).
    setup = port_setup.load_model_setup(
        {"model": {"type": "whisper", "architecture": "tiny"}})
    assert setup.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            setup.init_params(seed=0)


def test_saved_model_directory_is_rejected(tmp_path):
    """A saved directory without the port's params (the JAX package's orbax
    tree) is refused, naming the converter that writes them."""
    from coral_tpu_torch.evaluation.evaluate import load_saved_predictor

    (tmp_path / "config.yaml").write_text("model: {}\n")
    with pytest.raises(ValueError, match="tools/convert_coral_tpu_model.py"):
        load_saved_predictor({"model_id": str(tmp_path)}, device="cpu")


@pytest.mark.parametrize("flag,value", [("encoder_ln_impl", "xla"), ("fused_fe_conv", False)])
def test_off_default_kernel_flags_take_their_routes(flag, value):
    """The flags reach the model's routes: the encoder LayerNorms as plain
    LayerNorms, or every feature-encoder block as the conv + K1."""
    setup = port_setup.Wav2Vec2Setup(
        {"model": {"architecture": "tiny", "characters_to_keep": CHARS, flag: value},
         "max_seconds_per_example": 5.0}, device="cpu")
    assert getattr(setup.model_config, flag) == value
    model = setup.init_params(seed=0)
    if flag == "encoder_ln_impl":
        assert all(layer.ln_impl == "xla" for layer in model.wav2vec2.encoder.layers)
    else:
        assert not any(c.fused for c in model.wav2vec2.feature_extractor.conv_layers)


@pytest.mark.parametrize("flags", [
    {"fused_ffn_block_dw": True}, {"fused_ffn_block_dg": False},
    {"fused_ffn_block_fc2": True},
])
def test_whisper_off_default_kernel_flags_are_rejected(flags, tmp_path):
    """The FFN block's variants, refused until their kernels were ported (dW
    inside the block's backward, dg outside it, fc2 inside the forward
    kernel), now build: the setup resolves the three flags as the JAX setup
    does and takes the variant of the JAX precedence (dw > fc2 > dg)."""
    from coral_tpu.config import DictConfig
    from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup

    config = {"model": {"type": "whisper", "architecture": "tiny_test", "sampling_rate": 16_000,
                        **flags}, "max_seconds_per_example": 1.0, "model_dir": str(tmp_path)}
    got = port_setup.load_model_setup(config, device="cpu").model_config
    want = jax_load_model_setup(DictConfig(config)).model_config
    keys = ("fused_ffn_block_dw", "fused_ffn_block_fc2", "fused_ffn_block_dg")
    assert {k: getattr(got, k) for k in keys} == {k: getattr(want, k) for k in keys}
    variant = {"fused_ffn_block_dw": "dw", "fused_ffn_block_fc2": "fc2",
               "fused_ffn_block_dg": "dg_out"}[next(iter(flags))]
    assert got.ffn_route == "ffn_ln_block" and got.ffn_variant == variant


def test_every_module_imports_with_jax_blocked():
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "safetensors", "transformers"):
    sys.modules[name] = None
import coral_tpu_torch
names = [m.name for m in pkgutil.walk_packages(coral_tpu_torch.__path__, "coral_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from coral_tpu_torch import ASRPipeline
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "coral_tpu")
assert not loaded, loaded
new = {"coral_tpu_torch.ops.ctc", "coral_tpu_torch.ops.philox",
       "coral_tpu_torch.training.optimizer", "coral_tpu_torch.training.train_state",
       "coral_tpu_torch.ops.flash_attention", "coral_tpu_torch.ops.decode_attention",
       "coral_tpu_torch.models.whisper", "coral_tpu_torch.audio.mel",
       "coral_tpu_torch.text.whisper_tokenizer", "coral_tpu_torch.evaluation.longform",
       "coral_tpu_torch.ops.gelu_dropout", "coral_tpu_torch.tools",
       "coral_tpu_torch.tools.probe_fe_bwd", "coral_tpu_torch.tools.probe_gelu_cost",
       "coral_tpu_torch.tools.probe_lane_reduce", "coral_tpu_torch.decoding",
       "coral_tpu_torch.models.safetensors_io", "coral_tpu_torch.text.normalization",
       "coral_tpu_torch.text.numerals", "coral_tpu_torch.evaluation.metrics",
       "coral_tpu_torch.evaluation.eval_loop", "coral_tpu_torch.config",
       "coral_tpu_torch.data", "coral_tpu_torch.data.synthetic",
       "coral_tpu_torch.data.interleave", "coral_tpu_torch.data.processing",
       "coral_tpu_torch.data.loading", "coral_tpu_torch.data.batching",
       "coral_tpu_torch.tracking", "coral_tpu_torch.utils",
       "coral_tpu_torch.utils.logging_utils", "coral_tpu_torch.utils.hub",
       "coral_tpu_torch.training.checkpoint", "coral_tpu_torch.training.finetune",
       "coral_tpu_torch.evaluation.evaluate", "coral_tpu_torch.data.validation",
       "coral_tpu_torch.decoding.ngram_pipeline", "coral_tpu_torch.cli",
       "coral_tpu_torch.__main__"}
assert new <= set(names), new - set(names)
print(len(names))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 31
