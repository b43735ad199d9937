"""Building a transcriber for a model id.

Port of ``load_saved_predictor`` from ``coral_tpu/evaluation/evaluate.py``.
The saved-directory branch (:145-166) serves the port's own saved model
(``training/finetune.py`` ``save_model``): a directory with ``config.yaml``
and ``model/params.pt`` builds the setup from the saved config, with the
eval-time overrides ``generation_num_beams``, ``generation_length_penalty``,
``return_timestamps`` and ``generation_max_length`` (-> ``model.max_length``)
applied as JAX applies them, and loads the fp32 masters into it. A
``config.yaml`` beside any other ``model/`` (the JAX package's orbax tree)
raises ``NotImplementedError`` naming its ROADMAP item. The pretrained-id
branch (:169-212) builds the family the id names (wav2vec2, or Whisper when
the id contains "whisper") with the checkpoint on disk where there is one (a
directory holding ``model.safetensors`` or ``pytorch_model.bin``, whole or
sharded, or the Hugging Face cache) and seeded random weights otherwise.
Either way a wav2vec2 model whose directory also holds ``*gram.arpa`` serves
by CTC beam search with that n-gram LM unless ``no_lm``; Whisper ignores an
LM.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Callable, Mapping

import torch

from ..models.wav2vec2 import NOT_PORTED
from ..training.finetune import SAVED_PARAMS, load_saved_params
from ..training.model_setup import Wav2Vec2Setup, load_model_setup

# Eval-time generation overrides -> the saved model config's keys (the
# reference's evaluation surface re-decides the decoding strategy per run).
EVAL_OVERRIDES = (
    ("generation_num_beams", "generation_num_beams"),
    ("generation_length_penalty", "generation_length_penalty"),
    ("return_timestamps", "return_timestamps"),
    ("generation_max_length", "max_length"),
)

logger = logging.getLogger(__package__)


def load_saved_predictor(
    config: Mapping[str, Any], device: str | torch.device = "cuda"
) -> tuple[Callable[[Mapping[str, Any]], list[str]], dict]:
    """Build a transcriber for ``config["model_id"]`` on ``device``.

    ``config`` has these keys of the JAX package's evaluation surface:
    ``model_id``, ``sampling_rate``, and optionally ``no_lm`` and (for a
    saved directory) the eval-time overrides ``EVAL_OVERRIDES``; a
    pretrained id also needs ``characters_to_keep``,
    ``max_seconds_per_example`` and optionally ``lower_case`` (default true).

    Returns:
        ``(predict(batch) -> list[str], batch_geometry_kwargs)``.
    """
    model_id = str(config["model_id"])
    model_dir = Path(model_id)
    if (model_dir / "config.yaml").exists():
        if not (model_dir / SAVED_PARAMS).exists():
            raise NotImplementedError(
                f"{model_dir} is a saved coral-tpu model without {SAVED_PARAMS} (orbax "
                "params of the JAX package): " + NOT_PORTED.format("3 (saved model directories)")
            )
        import yaml

        from ..config import DictConfig

        saved = DictConfig(yaml.safe_load((model_dir / "config.yaml").read_text("utf-8")))
        saved.model_dir = str(model_dir)
        for key, model_key in EVAL_OVERRIDES:
            if config.get(key) is not None:
                saved.model[model_key] = config.get(key)
        setup = load_model_setup(saved, is_main=True, device=device)
        model = setup.init_params(seed=0, pretrained=False)
        load_saved_params(model, model_dir / SAVED_PARAMS)
    else:
        # A pretrained checkpoint id: the training-config surface the JAX
        # branch builds (its model_dir, where the JAX setup writes vocab.json,
        # aside).
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

