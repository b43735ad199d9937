"""Character-level CTC tokeniser.

A copy of ``coral_tpu/text/tokenizer.py``: the port imports nothing of ``coral_tpu``.

Vocabulary-compatible with the reference's ``Wav2Vec2CTCTokenizer`` setup
(reference: ``src/coral/wav2vec2.py:49-102,308-329``): the vocabulary is the sorted
set of ``characters_to_keep`` + ``"|"`` (the word delimiter), followed by the added
special tokens ``<s>``, ``</s>``, ``<unk>``, ``<pad>`` in that order. The pad token
doubles as the CTC blank.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class CtcTokenizer:
    """Character tokeniser for CTC models.

    Args:
        vocab: Mapping from character to id (excluding special tokens unless present).
        word_delimiter_token: In-vocab token standing in for spaces.
    """

    def __init__(
        self, vocab: dict[str, int], word_delimiter_token: str = "|"
    ) -> None:
        self.word_delimiter_token = word_delimiter_token
        self.vocab = dict(vocab)
        # Append special tokens not already in the vocab, in the order the HF
        # tokeniser adds them (bos, eos, unk, pad).
        for token in ("<s>", "</s>", "<unk>", "<pad>"):
            if token not in self.vocab:
                self.vocab[token] = len(self.vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.pad_token_id = self.vocab["<pad>"]
        self.unk_token_id = self.vocab["<unk>"]
        self.bos_token_id = self.vocab["<s>"]
        self.eos_token_id = self.vocab["</s>"]
        self.blank_id = self.pad_token_id
        self.model_max_length = 512

    # -- constructors -------------------------------------------------------------
    @classmethod
    def from_characters(cls, characters_to_keep: str) -> "CtcTokenizer":
        """Build the tokeniser from the config's character whitelist."""
        chars = sorted(set(characters_to_keep + "|"))
        return cls({c: i for i, c in enumerate(chars)})

    @classmethod
    def from_pretrained(cls, model_dir: str | Path) -> "CtcTokenizer":
        """Load from a ``vocab.json`` in ``model_dir``."""
        with (Path(model_dir) / "vocab.json").open("r", encoding="utf-8") as f:
            return cls(json.load(f))

    def save_pretrained(self, model_dir: str | Path) -> None:
        """Write ``vocab.json`` (special tokens included) to ``model_dir``."""
        path = Path(model_dir)
        path.mkdir(parents=True, exist_ok=True)
        with (path / "vocab.json").open("w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)

    # -- encoding / decoding ------------------------------------------------------
    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str, truncation: bool = False) -> list[int]:
        """Encode text to label ids; spaces map to the word delimiter."""
        delim_id = self.vocab[self.word_delimiter_token]
        ids = [
            delim_id if ch == " " else self.vocab.get(ch, self.unk_token_id)
            for ch in text
        ]
        if truncation:
            ids = ids[: self.model_max_length]
        return ids

    def decode(self, ids, group_tokens: bool = True) -> str:
        """Decode ids to text.

        With ``group_tokens=True`` this performs the CTC collapse: consecutive
        duplicates merge, then blanks are dropped — matching HF's
        ``Wav2Vec2CTCTokenizer.decode``.
        """
        ids = np.asarray(ids).reshape(-1)
        if group_tokens:
            keep = np.ones(len(ids), dtype=bool)
            keep[1:] = ids[1:] != ids[:-1]
            ids = ids[keep]
        chars = []
        for i in ids:
            i = int(i)
            if i == self.pad_token_id:
                continue
            token = self.ids_to_tokens.get(i, "")
            if token in ("<s>", "</s>", "<unk>"):
                continue
            chars.append(" " if token == self.word_delimiter_token else token)
        return "".join(chars).strip()

    def batch_decode(self, batch_ids, group_tokens: bool = True) -> list[str]:
        """Decode a batch of id sequences."""
        return [self.decode(ids, group_tokens=group_tokens) for ids in batch_ids]


def dump_vocabulary(characters_to_keep: str, model_dir: str | Path) -> Path:
    """Write the char vocabulary (without special tokens) to ``model_dir/vocab.json``.

    Matches the file the reference dumps for the HF tokeniser
    (reference: ``src/coral/wav2vec2.py:308-329``), so checkpoints stay
    interoperable. Only call this on process 0; other processes read it.
    """
    chars = sorted(set(characters_to_keep + "|"))
    vocab = {c: i for i, c in enumerate(chars)}
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    vocab_path = model_dir / "vocab.json"
    with vocab_path.open("w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    return vocab_path
