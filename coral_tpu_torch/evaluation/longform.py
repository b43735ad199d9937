"""Long-form audio: the overlapping windows ``ASRPipeline.transcribe`` cuts.

A copy of ``chunk_waveform`` from ``coral_tpu/evaluation/longform.py``: the
port imports nothing of ``coral_tpu``.
"""

from __future__ import annotations

import numpy as np


def chunk_waveform(
    audio: np.ndarray, chunk_length: int, stride: int
) -> list[tuple[int, np.ndarray]]:
    """Split a 1-D waveform into overlapping windows.

    Args:
        audio: (T,) waveform.
        chunk_length: Window size in samples (e.g. 30 s).
        stride: Overlap on each side, in samples (HF default: chunk / 6).

    Returns:
        List of (start_offset, window) pairs; the last window may be short.
    """
    if len(audio) <= chunk_length:
        return [(0, audio)]
    step = chunk_length - 2 * stride
    if step <= 0:
        raise ValueError("stride too large for the chunk length")
    out = []
    start = 0
    while start < len(audio):
        out.append((start, audio[start : start + chunk_length]))
        if start + chunk_length >= len(audio):
            break
        start += step
    return out
