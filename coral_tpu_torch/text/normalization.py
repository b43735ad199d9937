"""Transcription normalisation.

A copy of ``coral_tpu/text/normalization.py``: the port imports nothing of
``coral_tpu``.

Implements the text half of the reference's ``process_example``
(reference: ``src/coral/data.py:616-696``): optional numeral verbalisation, optional
lower-casing, filler-word removal, NFKC normalisation, ordered character conversion,
character whitelisting, and whitespace clean-up. The exact semantics are pinned by the
reference's 12-case ``tests/test_data.py`` grid (``tests/test_text.py`` for
the JAX package); ``tests/test_torch_eval.py`` holds this copy against it.
"""

from __future__ import annotations

import re
from collections.abc import Iterable
from unicodedata import normalize

from .numerals import convert_numerals_in_text

# Characters converted (key -> value), in insertion order. Values with surrounding
# spaces are later collapsed by the whitespace clean-up.
# (reference: src/coral/data.py:47-85)
DEFAULT_CONVERSION_DICT = {
    "aa": "å",
    "ğ": "g",
    "ñ": "n",
    "ń": "n",
    "è": "e",
    "kg": " kilo ",
    "μg": " mikrogram ",
    "hhv": "henholdsvis",
    "fx": "for eksempel",
    "f.eks.": "for eksempel",
    "-": " minus ",
    "+": " plus ",
    "μ": " mikro ",
    "§": " paragraf ",
    "%": " procent ",
    "‰": " promille ",
    "ú": "u",
    "ş": "s",
    "ê": "e",
    "ã": "a",
    "ë": "e",
    "ć": "c",
    "ä": "æ",
    "í": "i",
    "š": "s",
    "î": "i",
    "ě": "e",
    "ð": "d",
    "á": "a",
    "ó": "o",
    "þ": "th",
    "ı": "i",
    "ö": "ø",
    "ç": "c",
    "ș": "s",
    "́": " ",  # combining acute accent -> whitespace
    "​": " ",  # zero-width space -> whitespace
}

# Danish hesitation/filler words removed from transcriptions
# (reference: src/coral/data.py:88-90).
FILLER_WORDS_PATTERN = re.compile(
    pattern=r"\b(eh+m*|øh+m*|h+m+|m+h+)\b", flags=re.IGNORECASE
)


def clean_transcription(
    text: str,
    characters_to_keep: Iterable[str] | None,
    conversion_dict: dict[str, str] | None = None,
    lower_case: bool = True,
    convert_numerals: bool = False,
) -> str:
    """Normalise one transcription.

    Args:
        text: The raw transcription.
        characters_to_keep: Whitelist of characters to keep (plus space, newline and
            '|'); None keeps everything.
        conversion_dict: Ordered character conversions; defaults to
            ``DEFAULT_CONVERSION_DICT``.
        lower_case: Whether to lower-case before cleaning.
        convert_numerals: Whether to verbalise numerals (eval path only).

    Returns:
        The cleaned transcription.

    Example:
        >>> clean_transcription("Hej, Verden!", characters_to_keep="abcdefghijklmnopqrstuvwxyzæøå")
        'hej verden'
        >>> clean_transcription("øhm ja", characters_to_keep=None)
        'ja'
    """
    if conversion_dict is None:
        conversion_dict = DEFAULT_CONVERSION_DICT

    if convert_numerals:
        text = convert_numerals_in_text(text)

    if lower_case:
        text = text.lower()

    text = FILLER_WORDS_PATTERN.sub(repl="", string=text)

    # Uniformise unicode forms (e.g. full-width dash -> '-') before conversions.
    text = normalize("NFKC", text)

    for key, value in conversion_dict.items():
        text = text.replace(key, value)

    if characters_to_keep is not None:
        keep = "".join(characters_to_keep)
        non_standard_re = re.compile(
            f"[^{re.escape(keep + ' |')}]", flags=re.IGNORECASE
        )
        text = non_standard_re.sub(" ", text.strip())

    text = re.sub(r" +", " ", text)

    # Strip each line, then surrounding newlines.
    text = "\n".join(line.strip() for line in text.split("\n")).strip("\n")

    return text
