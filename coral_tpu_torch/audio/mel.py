"""Whisper log-mel spectrogram frontend on the model's device.

Port of ``coral_tpu/audio/mel.py``: OpenAI Whisper's transform, a 400-point
periodic-Hann STFT with hop 160 (center-padded by reflection), the power
spectrum, a slaney-normalised mel filterbank (80 bins; 128 for large-v3),
``log10`` with a floor 8 below each item's maximum, then ``(x + 4) / 4``. The
DFT is two fp32 products against the same windowed cos/sin bases as the JAX
package's (not ``torch.stft``), so both packages round alike. The constants,
``mel_filterbank`` and ``_dft_basis`` are numpy copies of the JAX module's.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3_000


def mel_filterbank(
    n_mels: int = 80, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE
) -> np.ndarray:
    """Slaney-style mel filterbank, matching ``librosa.filters.mel`` defaults.

    Returns:
        (n_freqs, n_mels) float32 projection matrix, n_freqs = n_fft // 2 + 1.
    """

    def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
        f = np.asarray(f, dtype=np.float64)
        # Slaney scale: linear below 1 kHz, logarithmic above.
        mel = f / (200.0 / 3)
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / (200.0 / 3)
        logstep = np.log(6.4) / 27.0
        with np.errstate(divide="ignore"):  # f=0 branch is discarded by the where
            return np.where(
                f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mel
            )

    def mel_to_hz(m: np.ndarray) -> np.ndarray:
        m = np.asarray(m, dtype=np.float64)
        min_log_mel = 1000.0 / (200.0 / 3)
        logstep = np.log(6.4) / 27.0
        return np.where(
            m >= min_log_mel,
            1000.0 * np.exp(logstep * (m - min_log_mel)),
            m * (200.0 / 3),
        )

    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalisation: each filter integrates to ~1.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)  # (n_freqs, n_mels)


@lru_cache(maxsize=4)
def _dft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin bases, Hann-windowed: two (n_fft, n_freqs) matrices."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    window = np.hanning(n_fft + 1)[:-1][:, None]  # periodic Hann (torch.hann_window)
    return (
        (np.cos(angle) * window).astype(np.float32),
        (np.sin(angle) * window).astype(np.float32),
    )


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_fft) centered frames with reflect padding."""
    pad = n_fft // 2
    audio = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    return audio.unfold(-1, n_fft, hop)


def log_mel_spectrogram(
    audio: torch.Tensor,
    n_mels: int = 80,
    n_fft: int = N_FFT,
    hop: int = HOP_LENGTH,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Whisper-compatible log-mel features.

    Args:
        audio: (B, T) float waveforms at 16 kHz, already padded/trimmed to a
            fixed T (30 s for parity with Whisper checkpoints).

    Returns:
        (B, T // hop, n_mels) log-mel features in [-1, ~1], in ``dtype``.
    """
    cos_b, sin_b = _dft_basis(n_fft)
    mel_w = mel_filterbank(n_mels, n_fft)
    dev = audio.device

    frames = frame_signal(audio.float(), n_fft, hop)
    # torch.stft keeps 1 + T/hop frames; Whisper drops the final one.
    frames = frames[:, : audio.shape[-1] // hop, :]
    real = frames @ torch.from_numpy(cos_b).to(dev)
    imag = frames @ torch.from_numpy(sin_b).to(dev)
    power = real * real + imag * imag  # (B, F, n_freqs)

    mel = power @ torch.from_numpy(mel_w).to(dev)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    return ((log_spec + 4.0) / 4.0).to(dtype)
