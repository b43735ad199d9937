"""Synthetic audio datasets for tests and offline development.

A copy of ``coral_tpu/data/synthetic.py``: the port imports nothing of
``coral_tpu``.

The reference's test suite streams a tiny real dataset from the HF Hub
(``alexandrainst/audio_test_dataset``, reference: ``tests/conftest.py:66-84``).
Offline, tests and development use synthetic speech-shaped audio (harmonic
tones + noise) with Danish transcripts instead.
"""

from __future__ import annotations

import numpy as np

DANISH_SENTENCES = [
    "min fortræffelige lille nattergal",
    "jeg venter grumme meget af den",
    "men hendes vilje var fast som hendes tillid til vorherre",
    "her er kommet gode klæder at slide for de fire børn",
    "hver rose på træet i haven havde sin historie",
    "det var en dejlig dag i skoven",
    "solen skinnede over den lille by",
    "børnene legede på den grønne eng",
]


def synth_audio(rng: np.random.Generator, seconds: float, sr: int = 16_000):
    """Generate a speech-shaped waveform: a few gliding harmonics + pink-ish noise."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(90, 250)
    audio = np.zeros_like(t, dtype=np.float32)
    for h in range(1, 4):
        glide = 1.0 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t)
        audio += (0.5 / h) * np.sin(2 * np.pi * f0 * h * glide * t).astype(np.float32)
    audio += 0.05 * rng.standard_normal(len(t)).astype(np.float32)
    envelope = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1, 3) * t)).astype(np.float32)
    return (audio * envelope * 0.3).astype(np.float32)


_SPELL_ALPHABET = " abcdefghijklmnopqrstuvwxyzæøåé0123456789ü"


def synth_spelled_audio(
    rng: np.random.Generator, text: str, sr: int = 16_000,
    char_seconds: float = 0.08,
) -> np.ndarray:
    """Audio that *spells* the transcript: one distinct tone per character.

    Unlike :func:`synth_audio` (whose waveform carries no per-character
    structure, so an acoustic model can only memorise whole utterances —
    which converges far too slowly for an offline quality rehearsal), this
    signal has a learnable frame-to-character alignment: each character maps
    to a fixed frequency on a semitone ladder, held for ``char_seconds``
    (~4 encoder frames at the 320x conv downsampling). A small CTC model
    learns the tone->letter mapping within a few hundred steps.
    """
    n = int(char_seconds * sr)
    t = np.arange(n) / sr
    envelope = np.hanning(n).astype(np.float32)
    pieces = []
    for ch in text:
        idx = _SPELL_ALPHABET.find(ch)
        if idx < 0:
            idx = 0
        freq = 180.0 * 2.0 ** (idx / 12.0)
        tone = np.sin(2 * np.pi * freq * t).astype(np.float32)
        pieces.append(tone * envelope)
    audio = np.concatenate(pieces) if pieces else np.zeros(n, np.float32)
    audio = audio + 0.01 * rng.standard_normal(len(audio)).astype(np.float32)
    return (audio * 0.3).astype(np.float32)


def make_synthetic_examples(
    n: int = 8, seed: int = 0, sr: int = 16_000,
    min_seconds: float = 1.5, max_seconds: float = 5.0,
    text_column: str = "text",
    spelled: bool = False,
) -> list[dict]:
    """Build raw examples shaped like HF audio datasets rows."""
    rng = np.random.default_rng(seed)
    dialects = ["vestjysk", "østjysk", "sjællandsk", "fynsk"]
    examples = []
    for i in range(n):
        seconds = float(rng.uniform(min_seconds, max_seconds))
        text = DANISH_SENTENCES[i % len(DANISH_SENTENCES)]
        audio = (
            synth_spelled_audio(rng, text, sr) if spelled
            else synth_audio(rng, seconds, sr)
        )
        examples.append(
            {
                "audio": {
                    "array": audio,
                    "sampling_rate": sr,
                },
                text_column: text,
                # demographic metadata shaped like coral-v3 rows, so the
                # evaluation breakdown path is testable offline
                "age": int(rng.integers(18, 80)),
                "gender": ["female", "male"][i % 2],
                "dialect": dialects[i % len(dialects)],
                "country_birth": "DK" if i % 4 else None,
            }
        )
    return examples
