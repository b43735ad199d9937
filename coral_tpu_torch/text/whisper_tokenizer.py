"""Whisper tokeniser: byte-level BPE + the Whisper special-token layout.

A copy of ``coral_tpu/text/whisper_tokenizer.py``: the port imports nothing of ``coral_tpu``.

Replaces the reference's Hub-loaded ``WhisperProcessor`` tokeniser (reference:
``src/coral/whisper.py:49-65``, configured language="Danish", task="transcribe").
Vocabulary files (``vocab.json``/``merges.txt``) are read from a local checkpoint
directory; the special-token id layout is computed from the canonical language
list, exactly matching published multilingual checkpoints:

    <|endoftext|> = n_bpe, <|startoftranscript|> = n_bpe + 1,
    languages, <|translate|>, <|transcribe|>, <|startoflm|>, <|startofprev|>,
    <|nospeech|>, <|notimestamps|>, then 1501 timestamp tokens.

With no checkpoint on disk (offline tests) a 256-byte-unit fallback vocabulary
keeps the full pipeline runnable end-to-end.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .bpe import ByteLevelBPE

# Whisper's language order (defines the special-token ids). "yue" is appended for
# large-v3-generation checkpoints (vocab_size 51866).
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs "
    "ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk "
    "br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be tg sd gu "
    "am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha ba jw su"
).split()

LANGUAGE_NAMES = {"danish": "da", "english": "en"}  # config-surface conveniences

N_TIMESTAMPS = 1501  # <|0.00|> .. <|30.00|> in 0.02 s steps


class WhisperTokenizer:
    """Whisper text tokeniser with prompt construction and special-token ids.

    Args:
        bpe: The byte-level BPE backend.
        language: ISO code or name (e.g. "da" / "danish").
        task: "transcribe" or "translate".
        multilingual_v3: Adds the "yue" language token (large-v3 family).
    """

    def __init__(
        self,
        bpe: ByteLevelBPE,
        language: str = "da",
        task: str = "transcribe",
        multilingual_v3: bool = False,
    ) -> None:
        self.bpe = bpe
        self.language = LANGUAGE_NAMES.get(language.lower(), language.lower())
        self.task = task
        languages = list(WHISPER_LANGUAGES) + (["yue"] if multilingual_v3 else [])
        if self.language not in languages:
            raise ValueError(f"Unknown Whisper language: {language!r}")

        n_bpe = len(bpe)
        self.eos_token_id = n_bpe  # <|endoftext|>
        self.sot_token_id = n_bpe + 1  # <|startoftranscript|>
        self._lang_base = n_bpe + 2
        self.language_token_id = self._lang_base + languages.index(self.language)
        base = self._lang_base + len(languages)
        self.translate_token_id = base
        self.transcribe_token_id = base + 1
        self.startoflm_token_id = base + 2
        self.startofprev_token_id = base + 3
        self.nospeech_token_id = base + 4
        self.notimestamps_token_id = base + 5
        self.timestamp_begin = base + 6
        self.vocab_size = self.timestamp_begin + N_TIMESTAMPS
        self.pad_token_id = self.eos_token_id
        self.model_max_length = 448
        self.first_special_id = self.eos_token_id

        self.task_token_id = (
            self.transcribe_token_id if task == "transcribe"
            else self.translate_token_id
        )

    # -- constructors -----------------------------------------------------------
    @classmethod
    def from_pretrained(
        cls, model_dir: str | Path, language: str = "da",
        task: str = "transcribe", multilingual_v3: bool = False,
    ) -> "WhisperTokenizer":
        """Load vocab/merges from a local checkpoint directory.

        Args:
            multilingual_v3: Pass True for the large-v3 family (its vocabulary
                adds the "yue" language token; cannot be inferred from the files).
        """
        model_dir = Path(model_dir)
        bpe = ByteLevelBPE.from_files(
            model_dir / "vocab.json", model_dir / "merges.txt"
        )
        # vocab.json of published checkpoints may include special `<|...|>`
        # entries; strip them so the id arithmetic starts at the BPE boundary.
        specials = [
            t for t in bpe.vocab if t.startswith("<|") and t.endswith("|>")
        ]
        if specials:
            bpe.vocab = {t: i for t, i in bpe.vocab.items() if t not in specials}
            bpe.ids_to_tokens = {i: t for t, i in bpe.vocab.items()}
        return cls(bpe, language=language, task=task,
                   multilingual_v3=multilingual_v3)

    @classmethod
    def byte_fallback(
        cls, language: str = "da", task: str = "transcribe"
    ) -> "WhisperTokenizer":
        """Offline tokeniser over raw bytes (tests, no checkpoint present)."""
        return cls(ByteLevelBPE.byte_fallback(), language=language, task=task)

    def save_pretrained(self, model_dir) -> None:
        """Write ``vocab.json`` + ``merges.txt`` + tokenizer config."""
        import json
        from pathlib import Path as _Path

        path = _Path(model_dir)
        path.mkdir(parents=True, exist_ok=True)
        with (path / "vocab.json").open("w", encoding="utf-8") as f:
            json.dump(self.bpe.vocab, f, ensure_ascii=False)
        merges = sorted(self.bpe.bpe_ranks.items(), key=lambda kv: kv[1])
        (path / "merges.txt").write_text(
            "\n".join(f"{a} {b}" for (a, b), _ in merges), encoding="utf-8"
        )
        (path / "tokenizer_config.json").write_text(
            json.dumps({"language": self.language, "task": self.task}),
            encoding="utf-8",
        )

    # -- encode / decode ---------------------------------------------------------
    @property
    def forced_decoder_ids(self) -> list[int]:
        """The decoding prompt: ``[sot, lang, task, notimestamps]``."""
        return [
            self.sot_token_id,
            self.language_token_id,
            self.task_token_id,
            self.notimestamps_token_id,
        ]

    @property
    def forced_decoder_ids_timestamps(self) -> list[int]:
        """The prompt for timestamped decoding: ``[sot, lang, task]`` (the
        ``<|notimestamps|>`` token is omitted so the timestamp grammar runs)."""
        return [
            self.sot_token_id,
            self.language_token_id,
            self.task_token_id,
        ]

    def decode_segments(
        self, ids, time_precision: float = 0.02
    ) -> list[tuple[float, float, str]]:
        """Decode a timestamped generation into (start_s, end_s, text) tuples."""
        from ..models.whisper import segments_from_tokens

        out = []
        for start, end, toks in segments_from_tokens(
            ids, self.timestamp_begin, self.eos_token_id, time_precision
        ):
            text = self.decode(toks)
            if text:
                out.append((start, end, text))
        return out

    def encode(self, text: str, truncation: bool = True) -> list[int]:
        """Label ids for training: ``[lang, task, notimestamps, ...bpe, eot]``.

        The leading ``sot`` is omitted — it is re-introduced by the shift-right
        in the train step, matching the reference collator's BOS strip
        (reference: ``src/coral/data_collators.py:182-183``).
        """
        ids = (
            self.forced_decoder_ids[1:]
            + self.bpe.encode(" " + text.strip())
            + [self.eos_token_id]
        )
        if truncation:
            ids = ids[: self.model_max_length]
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        if skip_special_tokens:
            ids = [i for i in ids if i < self.first_special_id]
        return self.bpe.decode(ids).strip()

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]

    def __len__(self) -> int:
        return self.vocab_size
