"""Per-example filtering and processing.

A copy of ``coral_tpu/data/processing.py`` on the port's own
``audio/resample.py`` and ``text/normalization.py``.

Host-side work is deliberately minimal — text cleaning and tokenisation only.
The reference additionally runs waveform normalisation, augmentation DSP, and
feature extraction on CPU dataloader workers (reference:
``src/coral/data.py:616-759``); here those run on the device inside the train
step (``coral_tpu_torch/audio``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..audio.resample import resample
from ..text.normalization import clean_transcription


def filter_example(
    sample: dict[str, Any],
    audio_column: str,
    text_column: str,
    min_seconds_per_example: float,
    max_seconds_per_example: float,
) -> bool:
    """Keep samples with valid duration, non-empty text, not marked rejected.

    Mirrors the reference's ``filter_example`` (src/coral/data.py:490-529),
    including the strict inequalities on duration bounds.
    """
    audio = sample[audio_column]
    n = np.asarray(audio["array"]).shape[0]
    sr = audio["sampling_rate"]
    if n <= sr * min_seconds_per_example:
        return False
    if n >= sr * max_seconds_per_example:
        return False
    if len(sample[text_column].strip()) == 0:
        return False
    if "validated" in sample and sample["validated"] == "rejected":
        return False
    return True


def process_example(
    example: dict[str, Any],
    characters_to_keep: str | None,
    text_column: str,
    audio_column: str | None,
    lower_case: bool,
    convert_numerals: bool,
    tokenizer=None,
    target_sample_rate: int = 16_000,
) -> dict[str, Any]:
    """Clean the transcription, resample audio, and tokenise labels.

    Returns a dict with keys ``text``, and when audio/tokenizer are present,
    ``audio`` (float32 ndarray), ``num_seconds``, ``labels``, ``input_length``.
    """
    text = clean_transcription(
        example[text_column],
        characters_to_keep=characters_to_keep,
        lower_case=lower_case,
        convert_numerals=convert_numerals,
    )
    out = dict(example)
    out[text_column] = text

    if audio_column is None:
        return out

    audio = example[audio_column]
    array = np.asarray(audio["array"], dtype=np.float32)
    sr = int(audio["sampling_rate"])
    if sr != target_sample_rate:
        array = resample(array, sr, target_sample_rate)
    out["audio_array"] = array
    out["num_seconds"] = len(array) / target_sample_rate

    if tokenizer is not None:
        labels = tokenizer.encode(text, truncation=True)
        out["labels"] = np.asarray(labels, dtype=np.int32)
        out["input_length"] = len(labels)

    return out
