"""A LayerNorm's row means by lane sums or by a ones-matrix product.

Port of ``tools/probe_lane_reduce.py`` (``run`` :69 -> ``_kernel`` :51) to
the H100: acc = x @ w for x (STEPS, 256, 1024) and w (1024, 1024), bf16 with
fp32 sums, then ``nred`` row normalisations acc = (acc - mu) rsqrt(var +
1e-5), and one bf16 store. ``mode`` picks how mu and var, row means, are
taken: ``vpu`` sums each row's values (in the kernel, per-lane partials and
warp shuffles, the port's LayerNorm idiom); ``mxu`` takes column 0 of the
product of the rows, rounded to bf16, with a (1024, 128) bf16 ones tile (in
the kernel on the tensor cores; the TPU's MXU rounds its fp32 operand to bf16
at default precision). The kernel (``csrc/probe_lane_reduce.cu``) holds 32
whole rows a block.

The weight is taken in the ``nn.Linear`` layout, (F, D) = the JAX tool's
(1024, 1024) transposed.

Run on the card:

    python -m coral_tpu_torch.tools.probe_lane_reduce
"""

from __future__ import annotations

import argparse

import torch

from ..ops import _build
from . import card, emit, event_ms, floor_ms

TB = 256
D = 1024
STEPS = 2048
ONES_N = 128
MODES = ("vpu", "mxu")
CASES = tuple((nred, mode) for nred in (1, 2, 4) for mode in MODES)
EPS = 1e-5


def kernel_name(mode: str, nred: int) -> str:
    """The launch counter's name of a case."""
    return f"probe_lane_reduce_{mode}_{nred}"


def _check_case(mode: str, nred: int) -> None:
    if mode not in MODES or nred < 0:
        raise ValueError(f"probe_lane_reduce: mode in {MODES} and nred >= 0, got {mode!r}, "
                         f"{nred}")


def _means(a, ones, mode: str):
    """Row means of a (M, D) fp32: fp32 sums (vpu), or column 0 of bf16(a)
    @ ones (mxu), over D."""
    if mode == "vpu":
        return a.mean(dim=-1, keepdim=True)
    s = a.to(torch.bfloat16).float() @ ones.float()
    return s[:, :1] * (1.0 / a.shape[-1])


def lane_reduce_plain(x, w, ones, mode: str, nred: int):
    """The case in plain ops: x (S, TB, D), w (D, D) stored (F, D), ones (D,
    128); returns (S, TB, D) in x.dtype."""
    _check_case(mode, nred)
    S, tb, d = x.shape
    acc = x.reshape(S * tb, d).float() @ w.float().t()
    for _ in range(nred):
        cen = acc - _means(acc, ones, mode)
        var = _means(cen * cen, ones, mode)
        acc = cen * torch.rsqrt(var + EPS)
    return acc.to(x.dtype).reshape(S, tb, -1)


def lane_reduce(x, w, ones, mode: str, nred: int):
    """The case's kernel on a CUDA tensor (bf16 x (S, TB, 1024), w (1024,
    1024), ones (1024, 128), contiguous), its plain version on a CPU tensor;
    arguments and result as ``lane_reduce_plain``."""
    name = "coral_probe_lane_reduce"
    _check_case(mode, nred)
    if not _build.require_cuda(name, x):
        return lane_reduce_plain(x, w, ones, mode, nred)
    _build.check_cuda(name, torch.bfloat16, x, w, ones)
    S, tb, d = x.shape
    if d != D or w.shape != (D, D) or ones.shape != (D, ONES_N):
        raise ValueError(f"{name}: the kernel takes x (S, TB, {D}), w ({D}, {D}) and ones "
                         f"({D}, {ONES_N}), got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(ones.shape)}")
    out = torch.empty_like(x)
    _build.launch(name, kernel_name(mode, nred), x.data_ptr(), w.data_ptr(), ones.data_ptr(),
                  out.data_ptr(), S * tb, D, int(mode == "mxu"), nred)
    return out


def case_work(steps: int, mode: str, nred: int) -> tuple[float, float]:
    """(flops, bytes) of a case: the product's 2 D flops per output element,
    with mxu the ones products' 2 * 128 per element, two a normalisation (the
    lane sums' fp32 adds are not counted); x and w read once, out written
    once."""
    M = steps * TB
    flops = 2.0 * M * D * D + (2 * nred * 2.0 * M * D * ONES_N if mode == "mxu" else 0.0)
    return flops, 2.0 * (2 * M * D + D * D)


def make_inputs(steps: int, device, seed: int = 0):
    """x normal (steps, TB, D), w normal * 0.02 (D, D) and the ones tile,
    bf16, as the JAX tool makes them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((steps, TB, D), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((D, D), generator=gen, device=device) * 0.02).to(torch.bfloat16)
    ones = torch.ones((D, ONES_N), dtype=torch.bfloat16, device=device)
    return x, w, ones


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    device_card = card()
    x, w, ones = make_inputs(STEPS, torch.device("cuda"))
    for nred, mode in CASES:
        ms, _ = event_ms(lambda: lane_reduce(x, w, ones, mode, nred), args.reps)
        floor = floor_ms(*case_work(STEPS, mode, nred))
        emit({"probe": "lane_reduce", "nred": nred, "mode": mode, "ms": ms,
              "us_per_step": ms / STEPS * 1e3, "floor_ms": floor,
              "pct_of_floor": 100 * floor / ms, "steps": STEPS, "card": device_card})


if __name__ == "__main__":
    main()
