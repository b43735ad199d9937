"""Validation: fixed-shape batches through a predictor, to corpus WER/CER.

Port of ``coral_tpu/evaluation/eval_loop.py``. The reference computes its
eval metrics in ``compute_error_rate_metrics`` (reference:
``src/coral/compute_metrics.py:18-93``): transcripts against the label texts,
both lower-cased and stripped, aggregated into corpus WER/CER. The predictor
is either family's (``make_predictor``: greedy CTC, the CTC beam search with
an LM, or Whisper generation); only the transcripts come back to the host.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Iterator, Mapping

import numpy as np

from .metrics import cer, wer

logger = logging.getLogger(__package__)


def batch_for_eval(
    samples: Iterable[dict],
    batch_size: int,
    max_seconds: float,
    sample_rate: int,
    bucket_lengths: list[int] | None = None,
) -> Iterator[tuple[dict[str, np.ndarray], list[str]]]:
    """Assemble fixed-shape eval batches plus their reference texts.

    The final ragged batch is zero-padded with dummy rows; the paired text list
    carries only the valid rows, so padding never skews the metrics.
    """
    max_len = int(max_seconds * sample_rate)
    if bucket_lengths is None:
        bucket_lengths = [max_len]

    def assemble(chunk: list[dict]) -> tuple[dict[str, np.ndarray], list[str]]:
        longest = max(len(s["audio_array"]) for s in chunk)
        T = next((b for b in bucket_lengths if longest <= b), bucket_lengths[-1])
        audio = np.zeros((batch_size, T), dtype=np.float32)
        # dummy rows keep length 1 (not 0) so the conv stack stays in range
        lengths = np.ones((batch_size,), dtype=np.int32)
        for i, s in enumerate(chunk):
            arr = s["audio_array"][:T]
            audio[i, : len(arr)] = arr
            lengths[i] = max(1, len(arr))
        texts = [s["text"] for s in chunk]
        return {"input_values": audio, "input_lengths": lengths}, texts

    chunk: list[dict] = []
    for s in samples:
        chunk.append(s)
        if len(chunk) == batch_size:
            yield assemble(chunk)
            chunk = []
    if chunk:
        yield assemble(chunk)


def run_validation(
    predictor: Callable[[Mapping[str, np.ndarray]], list[str]],
    source_factory: Callable[[], Iterable[dict]],
    batch_size: int,
    max_seconds: float,
    sample_rate: int,
    bucket_lengths: list[int] | None = None,
    max_samples: int | None = None,
    log_example: bool = True,
) -> dict[str, float]:
    """Transcribe one validation split and return ``{"cer": ..., "wer": ...}``.

    The one difference from the JAX ``run_validation``: the port's predictors
    carry their model, so this takes ``predictor(batch)`` and no ``params``.

    Args:
        predictor: The family's transcriber ``(batch) -> list[str]`` from
            ``make_predictor`` (or ``make_beam_predictor``).
        source_factory: Restartable processed-example stream for the split
            (dicts with ``audio_array`` and ``text``).
        batch_size: Eval batch size.
        max_seconds / sample_rate / bucket_lengths: Audio padding geometry.
        max_samples: Optional cap on evaluated samples.
        log_example: Log one prediction/label pair (reference:
            ``compute_metrics.py:84-88``).
    """
    predictions: list[str] = []
    references: list[str] = []

    def capped(it: Iterable[dict]) -> Iterator[dict]:
        for i, s in enumerate(it):
            if max_samples is not None and i >= max_samples:
                return
            yield s

    for batch, texts in batch_for_eval(
        capped(source_factory()), batch_size, max_seconds, sample_rate, bucket_lengths,
    ):
        for text, pred in zip(texts, predictor(batch)):
            predictions.append(pred.lower().strip())
            references.append(text.lower().strip())

    if log_example and predictions:
        idx = np.random.default_rng(4242).integers(len(predictions))
        logger.info(f"Sample document: {references[idx]!r}")
        logger.info(f"Predicted: {predictions[idx]!r}")

    return {
        "cer": cer(predictions=predictions, labels=references),
        "wer": wer(predictions=predictions, labels=references),
    }
