"""Background-noise bank for train-time augmentation, and audio file decoding.

Copies of ``coral_tpu/audio/noise_bank.py`` (``download_background_noises``,
``_read_wav``, ``load_noise_bank``): that package's ``audio/__init__`` imports
jax. The bank is a fixed-shape (N, T) float32 array, built once from a .npy
file or a directory of audio clips; the train step moves it to the device
once, and ``audio/augment.py`` mixes slices of it into the batch.
"""

from __future__ import annotations

import logging
import zipfile
from pathlib import Path

import numpy as np

logger = logging.getLogger(__package__)

ESC50_URL = "https://github.com/karoldvl/ESC-50/archive/master.zip"


def download_background_noises(data_dir: str | Path) -> Path | None:
    """Fetch ESC-50 if absent (reference: ``data.py:762``); None when offline."""
    data_dir = Path(data_dir)
    target = data_dir / "background-noise"
    if target.exists() and any(target.rglob("*.wav")):
        return target
    try:
        import httpx

        data_dir.mkdir(parents=True, exist_ok=True)
        zip_path = data_dir / "esc50.zip"
        logger.info(f"Downloading ESC-50 background noises to {zip_path}...")
        with httpx.stream("GET", ESC50_URL, follow_redirects=True) as resp:
            resp.raise_for_status()
            with zip_path.open("wb") as f:
                for chunk in resp.iter_bytes():
                    f.write(chunk)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(target)
        zip_path.unlink()
        return target
    except Exception as error:
        logger.warning(
            f"Could not download background noises ({error}); augmentation "
            "falls back to colored noise only."
        )
        return None


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


def load_noise_bank(
    path: str | Path | None,
    sample_rate: int = 16_000,
    clip_seconds: float = 5.0,
    max_clips: int = 512,
) -> np.ndarray | None:
    """Build the (N, T) noise bank from a .npy file or a directory of audio.

    Returns None when nothing usable is found (augmentation then uses colored
    noise only).
    """
    if path is None:
        return None
    path = Path(path)
    if not path.exists():
        logger.warning(f"Background-noise path {path} does not exist.")
        return None

    if path.is_file() and path.suffix == ".npy":
        bank = np.load(path).astype(np.float32)
        return bank if bank.ndim == 2 and bank.size else None

    T = int(clip_seconds * sample_rate)
    clips: list[np.ndarray] = []
    for file in sorted(path.rglob("*")):
        if file.suffix.lower() not in (".wav", ".flac", ".ogg"):
            continue
        audio = _read_wav(file, sample_rate)
        if audio is None or len(audio) < sample_rate // 2:
            continue
        if len(audio) < T:
            audio = np.tile(audio, -(-T // len(audio)))[:T]
        clips.append(audio[:T])
        if len(clips) >= max_clips:
            break
    if not clips:
        logger.warning(f"No usable noise clips under {path}.")
        return None
    logger.info(f"Loaded {len(clips)} background-noise clips from {path}.")
    return np.stack(clips)
