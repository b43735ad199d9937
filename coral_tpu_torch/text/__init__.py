"""Tokenisers: the character CTC tokeniser and Whisper's byte-level BPE
(copies of ``coral_tpu.text``'s, which the port does not import)."""

from .tokenizer import CtcTokenizer
from .whisper_tokenizer import WhisperTokenizer

__all__ = ["CtcTokenizer", "WhisperTokenizer"]
