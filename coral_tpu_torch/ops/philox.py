"""Dropout bits: Philox4x32-10 on (seed, row, column), in torch integer ops.

The TPU kernels seed their hardware PRNG per (batch row, row tile)
(``pltpu.prng_seed(seed[b], t)``, ``coral_tpu/ops/ffn_pallas.py:171-175``), so
their bits depend on the tiling and no other machine can reproduce them. The
port makes every dropout bit a pure function of ``(seed[b], t, f)`` instead:
the counter-based Philox4x32-10 of Salmon et al. (SC'11) with key
``(seed[b], 0)`` and counter ``(f // 4, t, 0, 0)``, whose four output words
are the bits of columns ``4 (f // 4) .. + 3``. ``csrc/philox.cuh`` is the same
function in CUDA, so a kernel and its plain version drop the same elements,
and a backward kernel that regenerates the mask gets the forward's bit for
bit.

torch has no unsigned 32-bit multiply-high, and an int64 product of two
32-bit words overflows, so ``_mulhilo`` splits one factor into 16-bit halves.

The drop rule is the TPU kernels': ``threshold = round(rate * 2**32)``,
``keep = bits >= threshold`` and kept values scaled by ``1 / (1 - rate)``
(``ffn_pallas.py:726-727, :98-100``).
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_ROUNDS = 10


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * b`` for a constant ``a`` and int64 ``b``
    holding values in [0, 2**32)."""
    p1 = a * (b & 0xFFFF)  # < 2**48
    mid = a * (b >> 16) + (p1 >> 16)  # a*b = mid * 2**16 + (p1 & 0xFFFF)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p1 & 0xFFFF)


def philox4x32(c0, c1, k0) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of counter ``(c0, c1, 0, 0)`` and key ``(k0, 0)``; int64
    tensors holding uint32 values, broadcast together. Returns four words."""
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k1 = 0
    for _ in range(_ROUNDS):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def dropout_bits(seeds: torch.Tensor, T: int, F: int) -> torch.Tensor:
    """(B, T, F) int64 holding the uint32 bits of element (b, t, f).

    Args:
        seeds: (B,) int32 (read as uint32).
        T, F: rows per batch element and columns; F a multiple of 4.
    """
    if F % 4:
        raise ValueError(f"dropout_bits: F must be a multiple of 4, got {F}")
    dev = seeds.device
    key = (seeds.to(torch.int64) & _MASK32)[:, None, None]
    groups = torch.arange(F // 4, device=dev, dtype=torch.int64)[None, None, :]
    rows = torch.arange(T, device=dev, dtype=torch.int64)[None, :, None]
    c0, c1 = torch.broadcast_tensors(groups, rows)
    words = philox4x32(c0.expand(len(seeds), -1, -1), c1, key)
    return torch.stack(words, dim=-1).reshape(len(seeds), T, F)


def threshold(rate: float) -> int:
    """The uint32 drop threshold: ``bits < threshold`` is dropped."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(round(rate * 2**32))


def keep_mask(seeds: torch.Tensor, T: int, F: int, rate: float) -> torch.Tensor:
    """(B, T, F) bool: True where the element is kept."""
    return dropout_bits(seeds, T, F) >= threshold(rate)


def dropout(x: torch.Tensor, rate: float, seeds: torch.Tensor | None) -> torch.Tensor:
    """``nn.Dropout`` on (B, T, C) with the mask of ``keep_mask``: a pure
    function of the seeds, so a checkpoint replay drops the same elements.
    Rate 0 returns ``x`` itself, as flax's ``nn.Dropout(0.0)`` does."""
    if rate == 0.0:
        return x
    B, T, C = x.shape
    C4 = -(-C // 4) * 4
    keep = keep_mask(seeds, T, C4, rate)[..., :C]
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
