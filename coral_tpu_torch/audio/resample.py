"""Host-side audio resampling (copy of ``coral_tpu/audio/resample.py``).

A polyphase resampler (Kaiser-windowed sinc); resampling happens once per input
on the host, off the device path.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import resample_poly


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample a waveform to ``target_sr`` (no-op when rates match)."""
    if orig_sr == target_sr:
        return np.asarray(audio, dtype=np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    out = resample_poly(np.asarray(audio, dtype=np.float32), up, down)
    return np.asarray(out, dtype=np.float32)
