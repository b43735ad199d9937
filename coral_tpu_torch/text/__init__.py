"""Text: normalisation, Danish numerals, and the tokenisers (the character CTC
tokeniser and Whisper's byte-level BPE), copies of ``coral_tpu.text``'s, which
the port does not import."""

from .normalization import DEFAULT_CONVERSION_DICT, FILLER_WORDS_PATTERN, clean_transcription
from .numerals import NUMERAL_REGEX, convert_numeral_to_words, convert_numerals_in_text
from .tokenizer import CtcTokenizer
from .whisper_tokenizer import WhisperTokenizer

__all__ = [
    "DEFAULT_CONVERSION_DICT",
    "FILLER_WORDS_PATTERN",
    "clean_transcription",
    "NUMERAL_REGEX",
    "convert_numeral_to_words",
    "convert_numerals_in_text",
    "CtcTokenizer",
    "WhisperTokenizer",
]
