"""wav2vec2 input features: per-sample zero-mean / unit-variance.

Port of ``coral_tpu/audio/features.py`` ``znorm``.
"""

from __future__ import annotations

import torch


def znorm(audio: torch.Tensor, lengths: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Zero-mean / unit-variance normalise each sample over its valid region.

    Matches HF's ``Wav2Vec2FeatureExtractor.zero_mean_unit_var_norm`` (variance
    with denominator N, eps=1e-7 added to the variance); padded positions come
    out 0.

    Args:
        audio: (B, T) waveforms, zero-padded.
        lengths: (B,) valid sample counts.

    Returns:
        (B, T) normalised waveforms with zeros in the padding.
    """
    T = audio.shape[-1]
    mask = (torch.arange(T, device=audio.device)[None, :] < lengths[:, None]).to(audio.dtype)
    n = torch.clamp(lengths.to(audio.dtype), min=1.0)[:, None]
    mean = torch.sum(audio * mask, dim=-1, keepdim=True) / n
    centred = (audio - mean) * mask
    var = torch.sum(centred**2, dim=-1, keepdim=True) / n
    out = centred / torch.sqrt(var + eps)
    return out * mask
