"""Byte-level BPE tokeniser (GPT-2 style), self-contained.

A copy of ``coral_tpu/text/bpe.py``: the port imports nothing of ``coral_tpu``.

The reference relies on HF's ``WhisperTokenizer`` pulled from the Hub with each
checkpoint (reference: ``src/coral/whisper.py:49-65``). This is a native
implementation of the same byte-level BPE scheme that reads the standard
``vocab.json`` + ``merges.txt`` files from a local checkpoint directory — no
network, no tokenizers-library dependency. A degenerate byte-only mode (256
byte units, no merges) backs offline tests.
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from pathlib import Path

# GPT-2's pre-tokenisation pattern ('s/'t/... contractions, letter runs, number
# runs, punctuation runs, whitespace).
_PRETOKEN_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ByteLevelBPE:
    """Byte-level BPE encoder/decoder.

    Args:
        vocab: token-string -> id.
        merges: Ordered list of merge pairs ``(left, right)``.
    """

    def __init__(
        self, vocab: dict[str, int], merges: list[tuple[str, str]]
    ) -> None:
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_files(
        cls, vocab_file: str | Path, merges_file: str | Path | None
    ) -> "ByteLevelBPE":
        with Path(vocab_file).open("r", encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        if merges_file is not None and Path(merges_file).exists():
            with Path(merges_file).open("r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    left, _, right = line.partition(" ")
                    merges.append((left, right))
        return cls(vocab, merges)

    @classmethod
    def byte_fallback(cls) -> "ByteLevelBPE":
        """A merge-free vocabulary of the 256 byte units (offline tests)."""
        units = [bytes_to_unicode()[b] for b in range(256)]
        return cls({u: i for i, u in enumerate(sorted(set(units)))}, [])

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if best not in self.bpe_ranks:
                break
            merged: list[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == best[0]
                    and word[i + 1] == best[1]
                ):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        """Encode text to BPE ids (no special tokens)."""
        ids: list[int] = []
        for token in _PRETOKEN_RE.findall(text):
            mapped = "".join(
                self.byte_encoder[b] for b in token.encode("utf-8")
            )
            for piece in self._bpe(mapped):
                ids.append(self.vocab[piece])
        return ids

    def decode(self, ids: list[int]) -> str:
        """Decode BPE ids back to text (unknown ids are skipped)."""
        text = "".join(
            self.ids_to_tokens[i] for i in ids if i in self.ids_to_tokens
        )
        data = bytes(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace")

    def __len__(self) -> int:
        return len(self.vocab)
