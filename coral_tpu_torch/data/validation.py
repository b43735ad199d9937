"""ASR-based dataset QA: transcribe every row, score it, drop the bad ones.

Port of ``coral_tpu/data/validation.py`` (the reference's
``src/coral/validation.py:24-170``): every row of a raw dataset within
0.25 s - 1 h is transcribed by a validation model's predictor in fixed-shape
batches, gets the columns ``asr_prediction``, ``asr_label``,
``asr_validation_model``, ``asr_cer`` and ``asr_wer``, and is dropped where
its CER reaches ``max_cer``.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Iterator

from ..evaluation.eval_loop import batch_for_eval
from ..evaluation.metrics import cer, wer
from .processing import filter_example, process_example

logger = logging.getLogger(__package__)


def add_validations(
    examples: Iterable[dict],
    predictor: Callable[[dict], list[str]],
    model_id: str,
    text_column: str = "text",
    audio_column: str = "audio",
    lower_case: bool = True,
    sampling_rate: int = 16_000,
    characters_to_keep: str | None = None,
    batch_size: int = 16,
    max_cer: float = 0.6,
    max_pad_seconds: float = 10.0,
) -> Iterator[dict]:
    """Validate a stream of raw rows; yields the kept rows with the QA columns.

    Args:
        examples: Raw dataset rows (shaped as Hugging Face audio datasets').
        predictor: A batched transcriber ``(batch) -> list[str]`` over
            ``input_values`` / ``input_lengths`` host arrays
            (``evaluation.evaluate.load_saved_predictor``'s).
        model_id: The ``asr_validation_model`` column's value.
        max_cer: Rows whose CER is at least this are dropped.
        max_pad_seconds: The batches' padded length in seconds.
    """

    def processed() -> Iterator[dict]:
        for example in examples:
            if not filter_example(example, audio_column=audio_column, text_column=text_column,
                                  min_seconds_per_example=0.25,
                                  max_seconds_per_example=60 * 60):
                continue
            yield process_example(example, characters_to_keep=characters_to_keep,
                                  text_column=text_column, audio_column=audio_column,
                                  lower_case=lower_case, convert_numerals=False,
                                  target_sample_rate=sampling_rate)

    kept = 0
    dropped = 0
    for batch, texts in batch_for_eval(_with_text_alias(processed(), text_column),
                                       batch_size=batch_size, max_seconds=max_pad_seconds,
                                       sample_rate=sampling_rate):
        predictions = predictor(batch)
        for (example, label), prediction in zip(texts, predictions):
            prediction = prediction.lower().strip()
            out = dict(example)
            out["asr_prediction"] = prediction
            out["asr_label"] = label
            out["asr_validation_model"] = model_id
            out["asr_cer"] = cer(predictions=[prediction], labels=[label])
            out["asr_wer"] = wer(predictions=[prediction], labels=[label])
            if out["asr_cer"] >= max_cer:
                dropped += 1
                continue
            kept += 1
            yield out
    logger.info(f"Validation kept {kept:,} samples, dropped {dropped:,} (CER >= {max_cer}).")


def _with_text_alias(stream: Iterator[dict], text_column: str) -> Iterator[dict]:
    """Rows shaped for ``batch_for_eval``: the audio, and as the "text" the
    pair (the processed row, its label)."""
    for example in stream:
        yield {"audio_array": example["audio_array"],
               "text": (example, example.get(text_column, ""))}
