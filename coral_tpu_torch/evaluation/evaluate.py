"""Building a transcriber for a model id.

Port of ``load_saved_predictor`` from ``coral_tpu/evaluation/evaluate.py``:
the pretrained-id branch (:169-212), which builds the family the id names
(wav2vec2, or Whisper when the id contains "whisper") with the checkpoint on
disk where there is one (a directory holding ``model.safetensors`` or
``pytorch_model.bin``, whole or sharded, or the Hugging Face cache) and seeded random weights
otherwise. A wav2vec2 directory that also holds ``*gram.arpa`` serves by CTC
beam search with that n-gram LM unless ``no_lm``; Whisper ignores an LM. A
saved coral-tpu model directory (orbax params, JAX-only) raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Callable, Mapping

import torch

from ..models.wav2vec2 import NOT_PORTED
from ..training.model_setup import Wav2Vec2Setup, load_model_setup

logger = logging.getLogger(__package__)


def load_saved_predictor(
    config: Mapping[str, Any], device: str | torch.device = "cuda"
) -> tuple[Callable[[Mapping[str, Any]], list[str]], dict]:
    """Build a transcriber for ``config["model_id"]`` on ``device``.

    ``config`` has these keys of the JAX package's evaluation surface:
    ``model_id``, ``sampling_rate``, ``characters_to_keep``,
    ``max_seconds_per_example`` and optionally ``lower_case`` (default true)
    and ``no_lm``.

    Returns:
        ``(predict(batch) -> list[str], batch_geometry_kwargs)``.
    """
    model_id = str(config["model_id"])
    model_dir = Path(model_id)
    if (model_dir / "config.yaml").exists():
        raise NotImplementedError(
            f"{model_dir} is a saved coral-tpu model (orbax params): "
            + NOT_PORTED.format("3 (saved model directories)")
        )
    # A pretrained checkpoint id: the training-config surface the JAX branch
    # builds (its model_dir, where the JAX setup writes vocab.json, aside).
    train_cfg = {
        "model": {
            "type": "whisper" if "whisper" in model_id.lower() else "wav2vec2",
            "pretrained_model_id": model_id,
            "sampling_rate": config["sampling_rate"],
            "characters_to_keep": config["characters_to_keep"],
            "lower_case": config.get("lower_case", True),
            "language": "danish",
        },
        "max_seconds_per_example": config["max_seconds_per_example"],
        "bf16_allowed": True,
        "gradient_checkpointing": False,
    }
    setup = load_model_setup(train_cfg, is_main=True, device=device)
    model = setup.init_params(seed=0)
    # Beam search with the n-gram LM stored beside a wav2vec2 model, unless
    # no_lm; the last by name, as the JAX branch picks it.
    arpa_files = sorted(model_dir.glob("*gram.arpa")) if model_dir.is_dir() else []
    if arpa_files and not config.get("no_lm", False) and isinstance(setup, Wav2Vec2Setup):
        logger.info(f"Decoding with the n-gram LM at {arpa_files[-1]}")
        predict = setup.make_beam_predictor(model, arpa_files[-1])
    else:
        predict = setup.make_predictor(model)
    geometry = {
        "max_seconds": setup.audio_pad_seconds,
        "sample_rate": int(config["sampling_rate"]),
    }
    return predict, geometry
