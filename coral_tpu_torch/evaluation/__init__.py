"""Evaluation: error-rate metrics, the validation loop, long-form
transcription, and loading a predictor for evaluation and serving."""

from .metrics import cer, levenshtein_counts, wer

__all__ = ["cer", "wer", "levenshtein_counts"]
