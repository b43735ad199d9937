"""On-device waveform augmentation for the train step.

Port of ``coral_tpu/audio/augment.py``: peak normalisation, random gain,
background noise from a device-resident (N, T) noise bank (p = 0.7), colored
noise (p = 0.2) and one of band-pass, band-stop, high-pass or low-pass as a
smooth frequency-domain mask over an rFFT (p = 0.2), batched on the device.
As in the JAX chain, each optional step computes both branches for every row
and selects per row, with no data-dependent control flow. The FFTs are
``torch.fft`` (the JAX chain is XLA FFT, with no Pallas kernel).

Randomness is split from its use: ``draw_augmentation`` takes every draw from
an explicit ``torch.Generator`` into ``AugmentDraws``, in the order of the JAX
``augment_batch``'s keys, and ``apply_augmentation`` is a pure function of
(audio, lengths, draws, bank, cfg). The torch generator gives other numbers
than ``jax.random`` from any seed, so the two chains agree when fed the same
draws, not the same seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AugmentConfig(NamedTuple):
    """Probabilities and ranges mirroring the reference's augmentation chain."""

    gain_db_min: float = -18.0
    gain_db_max: float = 6.0
    background_noise_p: float = 0.7
    background_snr_db_min: float = 3.0
    background_snr_db_max: float = 30.0
    colored_noise_p: float = 0.2
    colored_snr_db_min: float = 3.0
    colored_snr_db_max: float = 30.0
    colored_f_decay_min: float = -2.0
    colored_f_decay_max: float = 2.0
    filter_p: float = 0.2
    low_pass_hz: tuple[float, float] = (150.0, 7500.0)
    high_pass_hz: tuple[float, float] = (20.0, 2400.0)
    band_center_hz: tuple[float, float] = (200.0, 4000.0)
    band_width_fraction: tuple[float, float] = (0.5, 1.99)
    sample_rate: int = 16_000


class AugmentDraws(NamedTuple):
    """Every random number of one batch's chain, (B,) each unless stated.

    An ``*_apply`` field is None when that step is off (its probability is 0,
    or no bank for the background noise); its other fields are then None too.
    """

    gain_db: torch.Tensor
    background_apply: torch.Tensor | None
    background_idx: torch.Tensor | None  # int64 in [0, N)
    background_off: torch.Tensor | None  # int64 in [0, max(NT - T, 1))
    background_snr_db: torch.Tensor | None
    colored_apply: torch.Tensor | None
    colored_white: torch.Tensor | None  # (B, T) standard normal
    colored_decay: torch.Tensor | None
    colored_snr_db: torch.Tensor | None
    filter_apply: torch.Tensor | None
    filter_kind: torch.Tensor | None  # int64: 0 band-pass, 1 band-stop, 2 high, 3 low
    filter_low_pass: torch.Tensor | None  # cut-offs in Hz
    filter_high_pass: torch.Tensor | None
    filter_center: torch.Tensor | None
    filter_width: torch.Tensor | None


def peak_normalize(audio: torch.Tensor) -> torch.Tensor:
    """Scale each sample so its absolute peak is 1 (skip near-silent samples)."""
    peak = audio.abs().amax(dim=-1, keepdim=True)
    return torch.where(peak > 1e-8, audio / peak.clamp_min(1e-8), audio)


def _rms(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return torch.sqrt(((x * mask) ** 2).sum(dim=-1, keepdim=True) / n)


def _mix_at_snr(audio, noise, snr_db, mask):
    """Mix noise into audio at the given per-sample SNR (dB)."""
    signal_rms = _rms(audio, mask)
    noise_rms = _rms(noise, mask).clamp_min(1e-8)
    target_noise_rms = signal_rms / (10.0 ** (snr_db[:, None] / 20.0))
    return audio + noise * (target_noise_rms / noise_rms) * mask


def add_colored_noise(audio, mask, white, decay, snr_db):
    """Add the white noise shaped to a spectrum ~ f^(-decay/2), at snr_db."""
    T = audio.shape[-1]
    freqs = torch.fft.rfftfreq(T, d=1.0, device=audio.device)  # normalised
    spec = torch.fft.rfft(white, dim=-1)
    shaping = torch.where(freqs[None, :] > 0, freqs[None, :] ** (decay[:, None] / 2.0), 1.0)
    colored = torch.fft.irfft(spec * shaping, n=T, dim=-1).to(audio.dtype)
    return _mix_at_snr(audio, colored, snr_db, mask)


def add_background_noise(audio, mask, noise_bank, idx, off, snr_db):
    """Mix slice ``[off, off + T)`` of bank row ``idx`` into each sample
    (short bank rows are tiled), at snr_db."""
    T = audio.shape[-1]
    NT = noise_bank.shape[1]
    cols = off[:, None] + torch.arange(min(T, NT), device=audio.device)[None, :]
    noise = noise_bank[idx[:, None], cols]
    if NT < T:  # tile short noise clips
        noise = noise.repeat(1, -(-T // NT))[:, :T]
    return _mix_at_snr(audio, noise.to(audio.dtype), snr_db, mask)


def random_filter(audio, kind, low_pass, high_pass, center, width, sample_rate: int):
    """One of {band-pass, band-stop, high-pass, low-pass} per sample, as a
    raised-cosine frequency mask over the rFFT."""
    T = audio.shape[-1]
    freqs = torch.fft.rfftfreq(T, d=1.0 / sample_rate, device=audio.device)[None, :]
    band_lo = center * (1 - width / 2)
    band_hi = center * (1 + width / 2)

    def smooth_step(cut, rolloff=0.1):
        # 0 below cut*(1-r), 1 above cut*(1+r), raised-cosine in between
        lo, hi = cut * (1 - rolloff), cut * (1 + rolloff)
        x = ((freqs - lo[:, None]) / (hi - lo).clamp_min(1.0)[:, None]).clamp(0, 1)
        return 0.5 - 0.5 * torch.cos(math.pi * x)

    hp_mask = smooth_step(high_pass)
    lp_mask = 1.0 - smooth_step(low_pass)
    bp_mask = smooth_step(band_lo) * (1.0 - smooth_step(band_hi))
    bs_mask = 1.0 - bp_mask
    k = kind[:, None]
    mask = torch.where(k == 0, bp_mask,
                       torch.where(k == 1, bs_mask, torch.where(k == 2, hp_mask, lp_mask)))
    spec = torch.fft.rfft(audio, dim=-1)
    return torch.fft.irfft(spec * mask, n=T, dim=-1).to(audio.dtype)


def draw_augmentation(batch: int, T: int, generator: torch.Generator, device,
                      bank_shape: tuple[int, int] | None = None,
                      cfg: AugmentConfig = AugmentConfig()) -> AugmentDraws:
    """Every draw of one batch's chain, in ``augment_batch``'s key order: gain;
    background (apply, row, offset, SNR); colored (apply, white noise, decay,
    SNR); filter (apply, kind, low/high cut-offs, band centre, width)."""

    def uniform(lo, hi, shape=(batch,)):
        return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo

    def log_uniform(lo, hi):
        return torch.exp(uniform(math.log(lo), math.log(hi)))

    def bernoulli(p):
        return torch.rand((batch,), generator=generator, device=device) < p

    def randint(hi):
        return torch.randint(0, hi, (batch,), generator=generator, device=device)

    gain_db = uniform(cfg.gain_db_min, cfg.gain_db_max)
    bg = (None,) * 4
    if bank_shape is not None and cfg.background_noise_p > 0:
        N, NT = bank_shape
        bg = (bernoulli(cfg.background_noise_p), randint(N), randint(max(NT - T, 1)),
              uniform(cfg.background_snr_db_min, cfg.background_snr_db_max))
    colored = (None,) * 4
    if cfg.colored_noise_p > 0:
        colored = (bernoulli(cfg.colored_noise_p),
                   torch.randn((batch, T), generator=generator, device=device),
                   uniform(cfg.colored_f_decay_min, cfg.colored_f_decay_max),
                   uniform(cfg.colored_snr_db_min, cfg.colored_snr_db_max))
    filt = (None,) * 6
    if cfg.filter_p > 0:
        filt = (bernoulli(cfg.filter_p), randint(4), log_uniform(*cfg.low_pass_hz),
                log_uniform(*cfg.high_pass_hz), log_uniform(*cfg.band_center_hz),
                uniform(*cfg.band_width_fraction))
    return AugmentDraws(gain_db, *bg, *colored, *filt)


def apply_augmentation(audio: torch.Tensor, lengths: torch.Tensor, draws: AugmentDraws,
                       noise_bank: torch.Tensor | None = None,
                       cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """The chain on a padded (B, T) batch, given its draws: peak-norm ->
    gain -> background noise (p) -> colored noise (p) -> filter (p), as
    ``augment_batch`` orders it; samples past each length come out 0."""
    T = audio.shape[-1]
    mask = (torch.arange(T, device=audio.device)[None, :] < lengths[:, None]).to(audio.dtype)
    x = peak_normalize(audio * mask)
    x = x * (10.0 ** (draws.gain_db[:, None] / 20.0))
    if draws.background_apply is not None and noise_bank is not None:
        with_noise = add_background_noise(x, mask, noise_bank, draws.background_idx,
                                          draws.background_off, draws.background_snr_db)
        x = torch.where(draws.background_apply[:, None], with_noise, x)
    if draws.colored_apply is not None:
        with_noise = add_colored_noise(x, mask, draws.colored_white, draws.colored_decay,
                                       draws.colored_snr_db)
        x = torch.where(draws.colored_apply[:, None], with_noise, x)
    if draws.filter_apply is not None:
        filtered = random_filter(x, draws.filter_kind, draws.filter_low_pass,
                                 draws.filter_high_pass, draws.filter_center,
                                 draws.filter_width, cfg.sample_rate)
        x = torch.where(draws.filter_apply[:, None], filtered, x)
    return x * mask


def augment_batch(audio: torch.Tensor, lengths: torch.Tensor, generator: torch.Generator,
                  noise_bank: torch.Tensor | None = None,
                  cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """Draw, then apply, the full train-time chain on a padded (B, T) batch."""
    B, T = audio.shape
    bank_shape = None if noise_bank is None else tuple(noise_bank.shape)
    draws = draw_augmentation(B, T, generator, audio.device, bank_shape, cfg)
    return apply_augmentation(audio, lengths, draws, noise_bank, cfg)
