"""Tiny Hugging Face checkpoints written by ``transformers``, for the port's tests.

Each model is built at the dims of the JAX package's tiny test configs
(``Wav2Vec2Config.tiny``, ``WhisperConfig.tiny_test``), its every tensor drawn
by numpy from a seed (LayerNorm scales near 1, small non-zero biases,
weights scaled by their fan-in, a positive weight-norm g), then written with
``save_pretrained``, whole or in shards. Options rewrite a whole file: the
legacy ``weight_g`` / ``weight_v`` keys of the positional conv, or F16 / BF16
storage.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

CHARS = "abcdefghijklmnopqrstuvwxyzæøå0123456789éü"
W2V2_VOCAB = 46  # CtcTokenizer.from_characters(CHARS).vocab_size
WHISPER_VOCAB = 1864  # the byte-fallback WhisperTokenizer's
POS_CONV = "wav2vec2.encoder.pos_conv_embed.conv"


def w2v2_config(vocab_size: int = W2V2_VOCAB):
    from transformers import Wav2Vec2Config

    return Wav2Vec2Config(
        vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=(16,) * 4, conv_stride=(5, 4, 4, 4),
        conv_kernel=(10, 3, 3, 3), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=2, do_stable_layer_norm=True,
        feat_extract_norm="layer", conv_bias=True)


def whisper_config():
    from transformers import WhisperConfig

    eos = 256  # the byte-fallback tokenizer's <|endoftext|>
    return WhisperConfig(
        vocab_size=WHISPER_VOCAB, num_mel_bins=80, d_model=32, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=1500,
        max_target_positions=64, pad_token_id=eos, bos_token_id=eos, eos_token_id=eos,
        decoder_start_token_id=eos + 1)


@torch.no_grad()
def fill(model, seed: int):
    """Every tensor of ``model`` drawn by numpy from ``seed``, in key order."""
    rng = np.random.default_rng(seed)
    for name, t in sorted(model.state_dict().items()):
        a = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        if name.endswith(("original0", "weight_g")):
            a = np.abs(a) + 0.5
        elif "norm" in name and name.endswith("weight"):
            a = 1.0 + 0.1 * a
        elif t.ndim == 1:
            a = 0.1 * a
        elif "embed" not in name:
            a = a / np.sqrt(np.prod(t.shape[1:]))
        t.copy_(torch.from_numpy(a))
    return model


def _rewrite(path: Path, fmt: str, weight_norm: str, dtype: torch.dtype | None) -> None:
    """Rewrite the checkpoint at ``path`` with the legacy weight-norm keys
    and/or every floating tensor in ``dtype``."""
    import safetensors.torch

    sd = (safetensors.torch.load_file(str(path)) if fmt == "safetensors"
          else torch.load(path, weights_only=True))
    if weight_norm == "weight_g":
        sd[f"{POS_CONV}.weight_g"] = sd.pop(f"{POS_CONV}.parametrizations.weight.original0")
        sd[f"{POS_CONV}.weight_v"] = sd.pop(f"{POS_CONV}.parametrizations.weight.original1")
    if dtype is not None:
        sd = {k: v.to(dtype) for k, v in sd.items()}
    sd = {k: v.contiguous() for k, v in sd.items()}
    if fmt == "safetensors":
        safetensors.torch.save_file(sd, str(path), metadata={"format": "pt"})
    else:
        torch.save(sd, path)


def save(model, directory: Path, fmt: str = "safetensors", weight_norm: str = "parametrizations",
         dtype: torch.dtype | None = None, shard_bytes: int | None = None) -> Path:
    """``model.save_pretrained(directory)`` as ``model.safetensors`` or
    ``pytorch_model.bin``, rewritten as the options ask; returns the file.
    With ``shard_bytes`` it writes shards of at most that size (a tensor
    larger than that alone) and returns their index."""
    name = "model.safetensors" if fmt == "safetensors" else "pytorch_model.bin"
    if shard_bytes is not None:
        model.save_pretrained(directory, safe_serialization=fmt == "safetensors",
                              max_shard_size=shard_bytes)
        return Path(directory) / f"{name}.index.json"
    model.save_pretrained(directory, safe_serialization=fmt == "safetensors")
    path = Path(directory) / name
    if weight_norm != "parametrizations" or dtype is not None:
        _rewrite(path, fmt, weight_norm, dtype)
    return path


def w2v2_checkpoint(directory: Path, seed: int = 0, pretraining: bool = False,
                    vocab_size: int = W2V2_VOCAB, **options) -> Path:
    """A tiny ``Wav2Vec2ForCTC`` (or ``Wav2Vec2ForPreTraining``) checkpoint."""
    from transformers import Wav2Vec2ForCTC, Wav2Vec2ForPreTraining

    cls = Wav2Vec2ForPreTraining if pretraining else Wav2Vec2ForCTC
    torch.manual_seed(seed)
    return save(fill(cls(w2v2_config(vocab_size)).eval(), seed), directory, **options)


def whisper_checkpoint(directory: Path, seed: int = 0, **options) -> Path:
    """A tiny ``WhisperForConditionalGeneration`` checkpoint beside the port's
    byte-fallback tokenizer files (``vocab.json``, ``merges.txt``)."""
    from transformers import WhisperForConditionalGeneration

    from coral_tpu_torch.text.whisper_tokenizer import WhisperTokenizer

    torch.manual_seed(seed)
    model = fill(WhisperForConditionalGeneration(whisper_config()).eval(), seed)
    WhisperTokenizer.byte_fallback().save_pretrained(directory)
    return save(model, directory, **options)


def corpus_lines(seed: int, n: int = 300) -> list[str]:
    """Sentences of words over CHARS' letters, drawn by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyzæøå")
    words = ["".join(rng.choice(letters, size=int(rng.integers(2, 7)))) for _ in range(60)]
    return [" ".join(rng.choice(words, size=int(rng.integers(2, 8)))) for _ in range(n)]
