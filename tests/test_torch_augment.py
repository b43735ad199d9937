"""coral_tpu_torch's augmentation chain and noise bank against coral_tpu's.

``jax.random`` and ``torch.Generator`` give other numbers from any seed, so the
chain is compared with its randomness fixed: the test re-derives JAX's own
draws from the key, in ``augment_batch``'s key order, hands them to the port's
``apply_augmentation`` and holds the result against ``augment_batch`` on the
same key. Tolerance: 2e-5 of the largest output value, fp32 rFFTs of another
library (pocketfft in both, summed in another order) and the same elementwise
chain. The port's own torch draws are checked by their laws.
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coral_tpu.audio import augment as jaug
from coral_tpu.audio import noise_bank as jbank
from coral_tpu.config import DictConfig
from coral_tpu.training import model_setup as jsetup
from coral_tpu_torch.audio import augment, noise_bank
from coral_tpu_torch.training import model_setup

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

# Every optional step at p = 0.5, so that 16 rows see both branches of each.
HALF = dict(background_noise_p=0.5, colored_noise_p=0.5, filter_p=0.5)


def _jax_draws(key, B, T, bank_shape, cfg):
    """``augment_batch``'s draws from ``key``, as ``AugmentDraws``."""
    keys = jax.random.split(key, 8)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731

    def log_uniform(k, lo, hi):
        return jnp.exp(jax.random.uniform(k, (B,), minval=jnp.log(lo), maxval=jnp.log(hi)))

    gain = jax.random.uniform(keys[0], (B,), minval=cfg.gain_db_min, maxval=cfg.gain_db_max)
    bg = (None,) * 4
    if bank_shape is not None:
        N, NT = bank_shape
        k_idx, k_off, k_snr = jax.random.split(keys[2], 3)
        bg = (jax.random.bernoulli(keys[1], cfg.background_noise_p, (B,)),
              jax.random.randint(k_idx, (B,), 0, N),
              jax.random.randint(k_off, (B,), 0, max(NT - T, 1)),
              jax.random.uniform(k_snr, (B,), minval=cfg.background_snr_db_min,
                                 maxval=cfg.background_snr_db_max))
    k_white, k_snr, k_decay = jax.random.split(keys[4], 3)
    colored = (jax.random.bernoulli(keys[3], cfg.colored_noise_p, (B,)),
               jax.random.normal(k_white, (B, T)),
               jax.random.uniform(k_decay, (B,), minval=cfg.colored_f_decay_min,
                                  maxval=cfg.colored_f_decay_max),
               jax.random.uniform(k_snr, (B,), minval=cfg.colored_snr_db_min,
                                  maxval=cfg.colored_snr_db_max))
    k_kind, k_lo, k_hi, k_c, k_w = jax.random.split(keys[6], 5)
    filt = (jax.random.bernoulli(keys[5], cfg.filter_p, (B,)),
            jax.random.randint(k_kind, (B,), 0, 4),
            log_uniform(k_lo, *cfg.low_pass_hz), log_uniform(k_hi, *cfg.high_pass_hz),
            log_uniform(k_c, *cfg.band_center_hz),
            jax.random.uniform(k_w, (B,), minval=cfg.band_width_fraction[0],
                               maxval=cfg.band_width_fraction[1]))
    return augment.AugmentDraws(*(None if a is None else t(a)
                                  for a in (gain, *bg, *colored, *filt)))


@pytest.mark.parametrize("bank_len", [None, 4000, 1000], ids=["no_bank", "long_bank",
                                                                "short_bank"])
def test_apply_matches_jax_augment_batch_given_its_draws(bank_len):
    """Peak-norm, gain, background noise (a slice of a longer bank row, or a
    short row tiled), colored noise and the four filters, each on some rows
    and not on others, with a zero tail past each length."""
    B, T = 16, 2400
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((B, T)).astype(np.float32) * rng.uniform(0.01, 1.0, (B, 1))
    audio = audio.astype(np.float32)
    lengths = rng.integers(T // 3, T + 1, B).astype(np.int32)
    lengths[0] = T
    bank = None if bank_len is None else rng.standard_normal((5, bank_len)).astype(np.float32)
    cfg = jaug.AugmentConfig(**HALF)
    key = jax.random.PRNGKey(1)
    want = np.asarray(jaug.augment_batch(key, jnp.asarray(audio), jnp.asarray(lengths),
                                         None if bank is None else jnp.asarray(bank), cfg))
    draws = _jax_draws(key, B, T, None if bank is None else bank.shape, cfg)
    for flag in (draws.colored_apply, draws.filter_apply) + (
            () if bank is None else (draws.background_apply,)):
        assert 0 < int(flag.sum()) < B  # both branches are taken
    assert set(draws.filter_kind[draws.filter_apply].tolist()) == {0, 1, 2, 3}
    got = augment.apply_augmentation(torch.from_numpy(audio), torch.from_numpy(lengths), draws,
                                     None if bank is None else torch.from_numpy(bank),
                                     augment.AugmentConfig(**HALF))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
    for i, n in enumerate(lengths):
        assert not got[i, n:].any()


def test_torch_draws_follow_the_chains_laws():
    """Apply rates, ranges and the seeding of ``draw_augmentation``; the whole
    chain leaves samples past each length at exactly 0."""
    cfg = augment.AugmentConfig()
    B, T, N, NT = 20000, 8, 7, 40
    gen = torch.Generator().manual_seed(0)
    d = augment.draw_augmentation(B, T, gen, "cpu", (N, NT), cfg)
    for flag, p in ((d.background_apply, 0.7), (d.colored_apply, 0.2), (d.filter_apply, 0.2)):
        assert flag.dtype == torch.bool
        assert abs(flag.float().mean().item() - p) < 5 * (p * (1 - p) / B) ** 0.5
    assert cfg.gain_db_min <= d.gain_db.min() and d.gain_db.max() < cfg.gain_db_max
    assert abs(d.gain_db.mean().item() - (cfg.gain_db_min + cfg.gain_db_max) / 2) < 0.2
    assert set(d.background_idx.unique().tolist()) == set(range(N))
    assert set(d.background_off.unique().tolist()) == set(range(NT - T))
    for snr in (d.background_snr_db, d.colored_snr_db):
        assert 3.0 <= snr.min() and snr.max() < 30.0
    assert -2.0 <= d.colored_decay.min() and d.colored_decay.max() < 2.0
    assert d.colored_white.shape == (B, T) and abs(d.colored_white.std().item() - 1) < 0.01
    assert set(d.filter_kind.unique().tolist()) == {0, 1, 2, 3}
    for cut, (lo, hi) in ((d.filter_low_pass, cfg.low_pass_hz),
                          (d.filter_high_pass, cfg.high_pass_hz),
                          (d.filter_center, cfg.band_center_hz)):
        assert lo <= cut.min() and cut.max() <= hi
        # log-uniform: the log of the cut-off is uniform, its median the
        # geometric mean of the range
        assert abs(cut.log().median().item() - (np.log(lo) + np.log(hi)) / 2) < 0.05
    assert 0.5 <= d.filter_width.min() and d.filter_width.max() < 1.99
    # No bank: the background draws are absent; the same seed, the same draws.
    a = augment.draw_augmentation(4, T, torch.Generator().manual_seed(1), "cpu")
    b = augment.draw_augmentation(4, T, torch.Generator().manual_seed(1), "cpu")
    assert a.background_apply is None and a.background_idx is None
    assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(a, b))

    audio = torch.randn(64, 3000, generator=gen)
    lengths = torch.randint(1, 3001, (64,), generator=gen)
    bank = torch.randn(3, 5000, generator=gen)
    out = augment.augment_batch(audio, lengths, gen, bank)
    assert out.shape == audio.shape and torch.isfinite(out).all()
    for i, n in enumerate(lengths.tolist()):
        assert not out[i, n:].any()


def _write_wav(path, audio, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())


def test_load_noise_bank_matches_jax(tmp_path):
    """From a .npy file and from a directory of wavs: a 1 s clip tiled to 5 s,
    an 8 s clip cut, an 8 kHz clip resampled; a 0.2 s clip and a text file are
    skipped; a missing path or no path gives None."""
    rng = np.random.default_rng(0)
    bank = rng.standard_normal((4, 8000)).astype(np.float32)
    np.save(tmp_path / "bank.npy", bank)
    np.testing.assert_array_equal(noise_bank.load_noise_bank(tmp_path / "bank.npy"), bank)
    wavs = tmp_path / "noise"
    (wavs / "sub").mkdir(parents=True)
    _write_wav(wavs / "a.wav", rng.uniform(-0.5, 0.5, 16000), 16000)
    _write_wav(wavs / "sub" / "b.wav", rng.uniform(-0.5, 0.5, 8 * 16000), 16000)
    _write_wav(wavs / "c.wav", rng.uniform(-0.5, 0.5, 3 * 8000), 8000)
    _write_wav(wavs / "d.wav", rng.uniform(-0.5, 0.5, 3200), 16000)
    (wavs / "notes.txt").write_text("not audio")
    got = noise_bank.load_noise_bank(wavs, sample_rate=16000)
    want = jbank.load_noise_bank(wavs, sample_rate=16000)
    assert got.shape == want.shape == (3, 5 * 16000) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 16000:32000], got[0, :16000])  # tiled
    assert noise_bank.load_noise_bank(None) is None
    assert noise_bank.load_noise_bank(tmp_path / "missing.npy") is None


@pytest.mark.parametrize("over", [{}, {"augment_audio": False}, {"background_noise_path": "bank"},
                                  {"augment_audio": False, "background_noise_path": "bank"},
                                  {"background_noise_path": "missing.npy"}])
def test_augmentation_settings_match_jax(tmp_path, over):
    np.save(tmp_path / "bank.npy", np.ones((2, 100), np.float32))
    cfg = {"model": {"sampling_rate": 16000}, **over}
    if "background_noise_path" in cfg:
        cfg["background_noise_path"] = str(tmp_path / cfg["background_noise_path"])
        if cfg["background_noise_path"].endswith("bank"):
            cfg["background_noise_path"] += ".npy"
    got = model_setup._augmentation_settings(cfg, True)
    want = jsetup._augmentation_settings(DictConfig(cfg), True)
    assert got[0] == want[0] == over.get("augment_audio", True)
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        np.testing.assert_array_equal(got[1], want[1])
