"""Building a transcriber for a model id.

Port of ``load_saved_predictor`` from ``coral_tpu/evaluation/evaluate.py``:
the pretrained-id branch, which runs the architecture the id names (wav2vec2,
or Whisper when the id contains "whisper") with seeded random weights while no
checkpoint is on disk. A saved coral-tpu model
directory (orbax params, JAX-only) and beam search with a stored n-gram LM
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Mapping

import torch

from ..models.wav2vec2 import NOT_PORTED
from ..training.model_setup import load_model_setup


def load_saved_predictor(
    config: Mapping[str, Any], device: str | torch.device = "cuda"
) -> tuple[Callable[[Mapping[str, Any]], list[str]], dict]:
    """Build a transcriber for ``config["model_id"]`` on ``device``.

    ``config`` has these keys of the JAX package's evaluation surface:
    ``model_id``, ``sampling_rate``, ``characters_to_keep``,
    ``max_seconds_per_example`` and optionally ``no_lm``.

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
    arpa_files = sorted(model_dir.glob("*gram.arpa")) if model_dir.is_dir() else []
    if arpa_files and not config.get("no_lm", False):
        raise NotImplementedError(
            f"n-gram LM {arpa_files[-1]}: beam search is "
            + NOT_PORTED.format("4 (beam search + n-gram LM)")
            + "; pass no_lm=True for greedy decoding"
        )
    # A pretrained checkpoint id: the minimal training-config surface the
    # setup layer needs.
    train_cfg = {
        "model": {
            "type": "whisper" if "whisper" in model_id.lower() else "wav2vec2",
            "pretrained_model_id": model_id,
            "characters_to_keep": config["characters_to_keep"],
        },
        "max_seconds_per_example": config["max_seconds_per_example"],
        "bf16_allowed": True,
    }
    setup = load_model_setup(train_cfg, is_main=True, device=device)
    predict = setup.make_predictor(setup.init_params(seed=0))
    geometry = {
        "max_seconds": setup.audio_pad_seconds,
        "sample_rate": int(config["sampling_rate"]),
    }
    return predict, geometry
