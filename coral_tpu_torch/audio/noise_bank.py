"""Audio file decoding (``_read_wav`` from ``coral_tpu/audio/noise_bank.py``).

The noise bank itself belongs to training-time augmentation and is not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _read_wav(path: Path, target_sr: int) -> np.ndarray | None:
    """Decode one audio file to mono float32 at ``target_sr`` (best effort)."""
    try:
        import soundfile as sf

        audio, sr = sf.read(path, dtype="float32", always_2d=True)
        audio = audio.mean(axis=1)
    except ImportError:
        import wave

        with wave.open(str(path), "rb") as w:
            sr = w.getframerate()
            raw = np.frombuffer(
                w.readframes(w.getnframes()), dtype=np.int16
            ).astype(np.float32) / 32768.0
            audio = raw.reshape(-1, w.getnchannels()).mean(axis=1)
    except Exception:
        return None
    if sr != target_sr:
        from .resample import resample

        audio = resample(audio, sr, target_sr)
    return audio.astype(np.float32)
