"""Danish numeral-to-words conversion.

A copy of ``coral_tpu/text/numerals.py``: the port imports nothing of
``coral_tpu``.

Reproduces the numeral verbalisation used by the reference evaluation pipeline
(reference: ``src/coral/utils.py:303-472``), which is pinned by ~60 test vectors in
the reference's ``tests/test_utils.py``. Numbers up to 999,999,999 (plus decimal
commas and thousands separators) are verbalised in Danish; anything else is returned
unchanged.
"""

from __future__ import annotations

import logging
import re

logger = logging.getLogger(__package__)

# Matches integers with optional '.'-grouped thousands and an optional ','-decimal
# part, as whole words (reference: src/coral/utils.py:31).
NUMERAL_REGEX = re.compile(r"\b(0|[1-9]\d{0,2}(?:(?:\.\d{3})*|\d*)(?:,\d+)?)\b")

_UNITS = {
    "0": "nul", "1": "en", "2": "to", "3": "tre", "4": "fire",
    "5": "fem", "6": "seks", "7": "syv", "8": "otte", "9": "ni",
}
_TENS_AND_TEENS = {
    "10": "ti", "11": "elleve", "12": "tolv", "13": "tretten", "14": "fjorten",
    "15": "femten", "16": "seksten", "17": "sytten", "18": "atten", "19": "nitten",
    "20": "tyve", "30": "tredive", "40": "fyrre", "50": "halvtreds",
    "60": "tres", "70": "halvfjerds", "80": "firs", "90": "halvfems",
}


def _squeeze(text: str) -> str:
    return re.sub(r" +", " ", text).strip()


def convert_numeral_to_words(numeral: str, inside_larger_numeral: bool = False) -> str:
    """Verbalise one Danish numeral, or return the input unchanged if not a numeral.

    Args:
        numeral: The candidate numeral string.
        inside_larger_numeral: True when this call verbalises a sub-group of a larger
            numeral ("100" inside "1.100"), which suppresses the standalone forms
            "hundrede"/"tusind" in favour of "et hundrede"/"et tusind".

    Returns:
        The Danish words, or the input unchanged if it is not a valid numeral.

    Example:
        >>> convert_numeral_to_words("21")
        'enogtyve'
        >>> convert_numeral_to_words("1.100")
        'et tusind et hundrede'
        >>> convert_numeral_to_words("ikke-et-tal")
        'ikke-et-tal'
    """
    if re.fullmatch(NUMERAL_REGEX, numeral) is None:
        return numeral

    digits = numeral.replace(".", "")

    if "," in digits:
        assert digits.count(",") == 1, f"Too many commas in {numeral!r}"
        whole, decimals = digits.split(",")
        whole_words = convert_numeral_to_words(whole)
        decimal_words = " ".join(convert_numeral_to_words(d) for d in decimals)
        # The decimal digits use the neuter form ("et", not "en").
        return f"{whole_words} komma {decimal_words.replace('en', 'et')}"

    n = len(digits)

    if n == 1:
        return _UNITS[digits]

    if n == 2:
        if digits in _TENS_AND_TEENS:
            return _TENS_AND_TEENS[digits]
        unit = convert_numeral_to_words(digits[1], inside_larger_numeral=True)
        tens = convert_numeral_to_words(digits[0] + "0", inside_larger_numeral=True)
        return _squeeze(f"{unit}og{tens}")

    def group(
        head: str,
        rest: str,
        unit_word: str,
        neuter_head: bool,
        og_always: bool = False,
    ) -> str:
        """Compose '<head> <unit_word>[ og] <rest>' with the Danish 'og' rule.

        'og' joins the remainder only when the remainder is below one hundred
        (or always, for the hundreds group).
        """
        head_words = convert_numeral_to_words(head, inside_larger_numeral=True)
        if neuter_head:
            head_words = head_words.replace("en", "et")
        rest_stripped = rest.lstrip("0")
        rest_words = convert_numeral_to_words(
            rest_stripped, inside_larger_numeral=True
        )
        infix = unit_word
        if rest_words and (og_always or int(rest) < 100):
            infix += " og"
        return _squeeze(f"{head_words} {infix} {rest_words}")

    if n == 3:
        if not inside_larger_numeral and digits == "100":
            return "hundrede"
        return group(digits[0], digits[1:], "hundrede", neuter_head=True,
                     og_always=True)

    if n == 4:
        if not inside_larger_numeral and digits == "1000":
            return "tusind"
        return group(digits[0], digits[1:], "tusind", neuter_head=True)
    if n == 5:
        return group(digits[:2], digits[2:], "tusind", neuter_head=False)
    if n == 6:
        return group(digits[:3], digits[3:], "tusind", neuter_head=False)

    if n == 7:
        word = "million" if digits[0] == "1" else "millioner"
        return group(digits[0], digits[1:], word, neuter_head=False)
    if n == 8:
        return group(digits[:2], digits[2:], "millioner", neuter_head=False)
    if n == 9:
        return group(digits[:3], digits[3:], "millioner", neuter_head=False)

    logger.warning(
        f"Cannot convert numerals greater than 999,999,999 to words: {numeral!r}"
    )
    return numeral


def convert_numerals_in_text(text: str) -> str:
    """Verbalise every numeral occurring in ``text``.

    Mirrors the eval-path behaviour of the reference's ``process_example``
    (reference: ``src/coral/data.py:660-665``).

    Example:
        >>> convert_numerals_in_text("han er 2 år")
        'han er to år'
    """
    if re.search(NUMERAL_REGEX, text) is None:
        return text
    return "".join(
        convert_numeral_to_words(part)
        for part in re.split(NUMERAL_REGEX, text)
        if part is not None
    )
