"""What a polynomial epilogue, or a dropout mask, costs inside the FFN tile.

Port of ``tools/probe_gelu_cost.py`` (``run`` :54 -> ``_kernel`` :37) to the
H100: out = bf16(epilogue(x @ w)) for x (STEPS, 256, 1024) and w (1024,
4096), bf16 with fp32 sums, the epilogue one of the probe's cases: nothing,
``acc * poly_n(acc)`` for n = 13, 13 then 17, 7 then 9 (the probe's synthetic
coefficients, ``poly``), or the dropout mask alone (elements whose 32 random
bits are below 2**28 zeroed: 15/16 kept, no rescale). The kernel
(``csrc/probe_gelu_cost.cu``) is the FFN's fc1 panel product with its
epilogue swapped, so the differences between the cases price each epilogue
inside the port's own FFN tile. The mask's bits are ``ops/philox.py``'s for
(seed, row, column); the TPU probe draws its hardware PRNG per grid step.

The weight is taken in the ``nn.Linear`` layout, (4096, 1024) (the JAX
tool's (1024, 4096) transposed), as the port's FFN kernels take W1.

Run on the card:

    python -m coral_tpu_torch.tools.probe_gelu_cost
"""

from __future__ import annotations

import argparse

import torch

from ..ops import _build, philox
from . import card, emit, event_ms, floor_ms

TB = 256
D = 1024
F = 4096
STEPS = 256
# The probe's cases: (name, polynomial coefficient counts, dropout mask).
CASES = (
    ("matmul only", (), False),
    ("poly13", (13,), False),
    ("poly13+17 (block bwd pair)", (13, 17), False),
    ("poly7+9 (short pair)", (7, 9), False),
    ("prng only", (), True),
)
DROP_BELOW = 1 << 28  # bits below this drop: 1/16 of them


def poly(x, n: int):
    """``_poly(x, n)`` of the JAX probe: with x clipped to +-5 and t = 0.08
    x^2 - 1, 0.5 + x p(t) for p of degree n - 1 by Horner, its leading
    coefficient 1e-3 and the others 1e-3 (i + 2)."""
    xc = x.clamp(-5.0, 5.0)
    t = 0.08 * (xc * xc) - 1.0
    acc = torch.full_like(t, 1.0e-3)
    for i in range(n - 1):
        acc = acc * t + 1.0e-3 * (i + 2)
    return 0.5 + xc * acc


def _check_case(polys: tuple, prng: bool) -> None:
    if (tuple(polys), bool(prng)) not in {(c[1], c[2]) for c in CASES}:
        raise ValueError(f"probe_gelu_cost: ({polys}, prng={prng}) is not one of the "
                         f"probe's cases {[(c[1], c[2]) for c in CASES]}")


def kernel_name(polys: tuple, prng: bool) -> str:
    """The launch counter's name of a case."""
    if prng:
        return "probe_gelu_cost_prng"
    return "probe_gelu_cost_" + ("_".join(f"poly{n}" for n in polys) or "mm")


def gelu_cost_plain(x, w, polys: tuple, prng: bool, seed: int = 0):
    """The case in plain ops: x (S, TB, D), w (F, D); returns (S, TB, F) in
    x.dtype, the fp32 epilogue rounded once."""
    _check_case(polys, prng)
    S, tb, d = x.shape
    acc = x.reshape(S * tb, d).float() @ w.float().t()
    if prng:
        seeds = torch.tensor([seed], dtype=torch.int32, device=x.device)
        bits = philox.dropout_bits(seeds, S * tb, w.shape[0])[0]
        acc = torch.where(bits >= DROP_BELOW, acc, 0.0)
    for n in polys:
        acc = acc * poly(acc, n)
    return acc.to(x.dtype).reshape(S, tb, -1)


def gelu_cost(x, w, polys: tuple, prng: bool, seed: int = 0):
    """The case's kernel on a CUDA tensor (bf16 x (S, TB, 1024) and w (F,
    1024), F a multiple of 256, both contiguous), its plain version on a CPU
    tensor; arguments and result as ``gelu_cost_plain``."""
    name = "coral_probe_gelu_cost"
    _check_case(polys, prng)
    if not _build.require_cuda(name, x):
        return gelu_cost_plain(x, w, polys, prng, seed)
    _build.check_cuda(name, torch.bfloat16, x, w)
    S, tb, d = x.shape
    if d != D or w.dim() != 2 or w.shape[1] != D or w.shape[0] % 256:
        raise ValueError(f"{name}: the kernel takes x (S, TB, {D}) and w (F, {D}) with F a "
                         f"multiple of 256, got {tuple(x.shape)} and {tuple(w.shape)}")
    out = torch.empty((S, tb, w.shape[0]), dtype=x.dtype, device=x.device)
    n1, n2 = (tuple(polys) + (0, 0))[:2]
    _build.launch(name, kernel_name(polys, prng), x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  S * tb, D, w.shape[0], n1, n2, int(prng), seed & 0xFFFFFFFF)
    return out


def case_work(steps: int) -> tuple[float, float]:
    """(flops, bytes) of a case at ``steps``: the product's 2 D flops per
    output element, x and w read once, out written once. The epilogues' fp32
    operations (2 (n - 1) + 7 an element and polynomial: 0.28 ms for 13 + 17
    at 256 steps at the fp32 peak, under the product's 0.56 at the bf16
    peak) do not set the bound."""
    M = steps * TB
    return 2.0 * M * D * F, 2.0 * (M * D + D * F + M * F)


def make_inputs(steps: int, device, seed: int = 0):
    """x normal (steps, TB, D) and w normal * 0.02 (F, D), bf16, as the JAX
    tool scales them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((steps, TB, D), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((F, D), generator=gen, device=device) * 0.02).to(torch.bfloat16)
    return x, w


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    device_card = card()
    x, w = make_inputs(STEPS, torch.device("cuda"))
    base = None
    for name, polys, prng in CASES:
        ms, _ = event_ms(lambda: gelu_cost(x, w, polys, prng), args.reps)
        base = ms if base is None else base
        floor = floor_ms(*case_work(STEPS))
        emit({"probe": "gelu_cost", "case": name, "ms": ms, "floor_ms": floor,
              "pct_of_floor": 100 * floor / ms, "us_per_step_over_matmul":
              (ms - base) / STEPS * 1e3, "steps": STEPS, "card": device_card})


if __name__ == "__main__":
    main()
