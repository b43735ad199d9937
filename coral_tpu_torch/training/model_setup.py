"""Model setup for serving: config -> tokenizer + seeded model + greedy predictor.

Port of the serving half of ``coral_tpu/training/model_setup.py``
(``Wav2Vec2Setup``: the tokenizer, ``_infer_arch``, ``init_params`` and
``make_predictor``). Training (``make_train_step``), beam search with an
n-gram LM, Whisper and loading a checkpoint are not ported yet; each raises
``NotImplementedError`` naming its ROADMAP item rather than serving something
else in silence.

Configs are plain mappings with the keys of the JAX package's config surface
(``config["model"]["pretrained_model_id"]`` and so on).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from coral_tpu.text.tokenizer import CtcTokenizer

from ..audio.features import znorm
from ..models.wav2vec2 import NOT_PORTED, Wav2Vec2Config, Wav2Vec2ForCTC, build_model

logger = logging.getLogger(__package__)

_W2V2_ARCHS: dict[str, Callable[..., Wav2Vec2Config]] = {
    "tiny": Wav2Vec2Config.tiny,
    "300m": Wav2Vec2Config.xls_r_300m,
    "1b": Wav2Vec2Config.xls_r_1b,
    "2b": Wav2Vec2Config.xls_r_2b,
}

# The JAX model's kernel and layout flags at their production defaults
# (coral_tpu/training/model_setup.py); the port implements exactly these.
# Any other value raises, as the JAX package's own trap rule asks
# (tests/test_model_setup_traps.py): it must not run a path other than the one
# configured. pos_conv_fold is absent because both of its values are the same
# math, which the port computes as a plain grouped conv.
_KERNEL_FLAG_DEFAULTS: dict[str, Any] = {
    "attention_impl": "pallas",
    "attention_save_stats": "v3",
    "attention_o_residual": False,
    "attention_fused_qkv_bias": True,
    "fused_fe_conv": True,
    "encoder_ln_impl": "pallas",
    "fused_ffn": True,
    "fused_ffn_ln": True,
    "fused_ffn_block": True,
    "fused_ffn_block_dw": False,
    "fused_ffn_block_fc2": False,
    "fused_ffn_block_dg": True,
    "fused_qkv_ln": False,
    "do_stable_layer_norm": True,
}


def _find_local_checkpoint(pretrained_model_id: str | None) -> Path | None:
    """Resolve a local safetensors/pytorch checkpoint for a pretrained id.

    Checks the id as a filesystem path and the HF cache layout; returns None
    when nothing is on disk.
    """
    if not pretrained_model_id:
        return None
    candidates = [Path(pretrained_model_id)]
    hf_home = Path(os.environ.get("HF_HOME", Path.home() / ".cache/huggingface"))
    repo_dir = hf_home / "hub" / f"models--{pretrained_model_id.replace('/', '--')}"
    if repo_dir.exists():
        candidates.extend(sorted((repo_dir / "snapshots").glob("*")))
    for cand in candidates:
        if cand.is_file():
            return cand
        if cand.is_dir():
            for name in ("model.safetensors", "pytorch_model.bin"):
                if (cand / name).exists():
                    return cand / name
    return None


class GreedyCtcPredictor:
    """Host batch -> transcripts: z-norm, the model, greedy argmax and the CTC
    collapse of ``CtcTokenizer.decode`` (the JAX ``make_ctc_eval_step`` plus
    ``make_predictor``'s decoding)."""

    def __init__(self, model: Wav2Vec2ForCTC, tokenizer: CtcTokenizer) -> None:
        self.model = model
        self.tokenizer = tokenizer
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def logits(self, batch: Mapping[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, T', V), frame_lengths (B,)) on the model's device."""
        audio = torch.as_tensor(np.asarray(batch["input_values"])).to(self.device)
        if audio.dtype == torch.int16:  # PCM16 infeed
            audio = audio.float() / 32768.0
        lengths = torch.as_tensor(np.asarray(batch["input_lengths"])).to(self.device)
        return self.model(znorm(audio.float(), lengths), lengths)

    def __call__(self, batch: Mapping[str, Any]) -> list[str]:
        logits, frame_lengths = self.logits(batch)
        pred_ids = logits.argmax(dim=-1).cpu().numpy()
        frame_lengths = frame_lengths.cpu().numpy()
        return [
            self.tokenizer.decode(pred_ids[i, : frame_lengths[i]])
            for i in range(pred_ids.shape[0])
        ]


class Wav2Vec2Setup:
    """wav2vec2-CTC family, serving only."""

    def __init__(self, config: Mapping[str, Any], is_main: bool = True,
                 device: str | torch.device = "cpu") -> None:
        model_cfg = config["model"]
        for key, default in _KERNEL_FLAG_DEFAULTS.items():
            if key in model_cfg and model_cfg[key] != default:
                raise NotImplementedError(
                    f"model.{key}={model_cfg[key]!r} (the port implements "
                    f"{default!r}): " + NOT_PORTED.format("9 (off-default kernel flags)")
                )
        self.device = torch.device(device)
        self.tokenizer = CtcTokenizer.from_characters(model_cfg["characters_to_keep"])
        use_bf16 = bool(config.get("bf16_allowed", True))
        self.model_config = self._infer_arch(model_cfg)(
            vocab_size=self.tokenizer.vocab_size,
            dtype=torch.bfloat16 if use_bf16 else torch.float32,
        )
        self.audio_pad_seconds = float(config["max_seconds_per_example"])
        pretrained = model_cfg.get("pretrained_model_id")
        ckpt = _find_local_checkpoint(pretrained)
        if ckpt is not None:
            raise NotImplementedError(
                f"found checkpoint {ckpt}; loading it is "
                + NOT_PORTED.format("2 (HF checkpoints)")
                + ", and the port does not serve random weights in its place"
            )
        if is_main and pretrained:
            logger.warning(
                f"Pretrained checkpoint {pretrained!r} not found locally; "
                "initialising from scratch."
            )

    @staticmethod
    def _infer_arch(model_cfg: Mapping[str, Any]) -> Callable[..., Wav2Vec2Config]:
        explicit = model_cfg.get("architecture")
        if explicit is not None:
            if explicit not in _W2V2_ARCHS:
                raise ValueError(f"Unknown wav2vec2 architecture {explicit!r}")
            return _W2V2_ARCHS[explicit]
        pretrained = (model_cfg.get("pretrained_model_id") or "").lower()
        for key, factory in _W2V2_ARCHS.items():
            if key in pretrained:
                return factory
        return Wav2Vec2Config.xls_r_300m

    def init_params(self, seed: int = 0) -> Wav2Vec2ForCTC:
        """A randomly initialised model on the setup's device, from ``seed``."""
        return build_model(self.model_config, self.device, seed=seed)

    def make_predictor(self, model: Wav2Vec2ForCTC) -> GreedyCtcPredictor:
        """Greedy CTC decode: host batch -> list of transcript strings."""
        return GreedyCtcPredictor(model, self.tokenizer)

    def make_beam_predictor(self, *args, **kwargs):
        raise NotImplementedError(
            "CTC beam search with an n-gram LM: "
            + NOT_PORTED.format("4 (beam search + n-gram LM)")
        )


def load_model_setup(config: Mapping[str, Any], is_main: bool = True,
                     device: str | torch.device = "cpu") -> Wav2Vec2Setup:
    """Dispatch on ``config["model"]["type"]``."""
    model_type = config["model"]["type"]
    if model_type == "wav2vec2":
        return Wav2Vec2Setup(config, is_main=is_main, device=device)
    if model_type == "whisper":
        raise NotImplementedError("Whisper: " + NOT_PORTED.format("6 (Whisper)"))
    raise ValueError(f"Unsupported model type: {model_type!r}")
