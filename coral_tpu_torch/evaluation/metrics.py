"""Corpus-level WER/CER metrics.

A copy of ``coral_tpu/evaluation/metrics.py``: the port imports nothing of
``coral_tpu``.

Equivalent to the reference's jiwer-based metrics (reference:
``src/coral/metrics.py:8-61``): error counts are aggregated over the whole corpus
(not averaged per sentence), and the ``normalise`` flag adds insertions to the
denominator so the error rate is bounded by 100%.

jiwer is not available in this environment, so the Levenshtein edit-operation
counting is implemented natively. Word tokenisation mirrors jiwer's default
transform (collapse runs of spaces, strip, split on space); character tokenisation
mirrors jiwer's CER default (strip only — internal spaces count as characters).
"""

from __future__ import annotations

import collections.abc as c
import re
from typing import NamedTuple


class EditCounts(NamedTuple):
    """Minimal-alignment edit-operation counts between a reference and hypothesis."""

    hits: int
    substitutions: int
    deletions: int
    insertions: int


def levenshtein_counts(reference: c.Sequence, hypothesis: c.Sequence) -> EditCounts:
    """Count hits/substitutions/deletions/insertions of a minimal alignment.

    Standard Wagner-Fischer dynamic programme over the reference (rows) and
    hypothesis (columns), with a diagonal-first backtrace (match/substitute
    preferred over delete over insert) matching the alignment jiwer reports.
    """
    n, m = len(reference), len(hypothesis)
    if n == 0:
        return EditCounts(0, 0, 0, m)
    if m == 0:
        return EditCounts(0, 0, n, 0)

    # dist[i][j] = edit distance between reference[:i] and hypothesis[:j]
    prev = list(range(m + 1))
    rows = [prev]
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = reference[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ri != hypothesis[j - 1])
            cur[j] = min(sub, prev[j] + 1, cur[j - 1] + 1)
        rows.append(cur)
        prev = cur

    hits = subs = dels = ins = 0
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            diag = rows[i - 1][j - 1]
            if reference[i - 1] == hypothesis[j - 1] and rows[i][j] == diag:
                hits += 1
                i, j = i - 1, j - 1
                continue
            if rows[i][j] == diag + 1:
                subs += 1
                i, j = i - 1, j - 1
                continue
        if i > 0 and rows[i][j] == rows[i - 1][j] + 1:
            dels += 1
            i -= 1
            continue
        ins += 1
        j -= 1
    return EditCounts(hits, subs, dels, ins)


def _words(text: str) -> list[str]:
    """jiwer's default word transform: collapse spaces, strip, split."""
    return [w for w in re.sub(r" +", " ", text).strip().split(" ") if w]


def _chars(text: str) -> list[str]:
    """jiwer's default character transform: strip only."""
    return list(text.strip())


def _aggregate(
    pairs: c.Iterable[tuple[list, list]], normalise: bool
) -> float:
    incorrect = 0
    total = 0
    for ref_tokens, hyp_tokens in pairs:
        counts = levenshtein_counts(ref_tokens, hyp_tokens)
        incorrect += counts.substitutions + counts.deletions + counts.insertions
        total += counts.substitutions + counts.deletions + counts.hits
        if normalise:
            total += counts.insertions
    return incorrect / total


def cer(
    predictions: c.Iterable[str], labels: c.Iterable[str], normalise: bool = True
) -> float:
    """Corpus-aggregated character error rate.

    Args:
        predictions: Model predictions.
        labels: Ground-truth transcriptions.
        normalise: Add insertions to the denominator, bounding the rate at 100%.

    Returns:
        The aggregated character error rate.
    """
    return _aggregate(
        ((_chars(label), _chars(pred)) for pred, label in zip(predictions, labels)),
        normalise=normalise,
    )


def wer(
    predictions: c.Iterable[str], labels: c.Iterable[str], normalise: bool = True
) -> float:
    """Corpus-aggregated word error rate.

    Args:
        predictions: Model predictions.
        labels: Ground-truth transcriptions.
        normalise: Add insertions to the denominator, bounding the rate at 100%.

    Returns:
        The aggregated word error rate.
    """
    return _aggregate(
        ((_words(label), _words(pred)) for pred, label in zip(predictions, labels)),
        normalise=normalise,
    )
