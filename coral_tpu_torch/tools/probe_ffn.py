"""The FFN mainloop's kernels at the main paths' shapes, by kernel.

``ffn_ln_fc1_fwd`` (K5's forward), ``ffn_bwd`` (K5's backward: the first
kernel, dl = dh W1 and the LayerNorm backward), ``ffn_fc1_fwd`` (N1),
``ffn_fc1_bwd`` (N2) and ``ffn_ln_g_bwd`` (N5), all on
``csrc/ffn_gemm.cuh``; ``ffn_ln_fc2_fwd`` (N7, ``csrc/ffn_ln_fc2.cu``'s
cluster kernel) and ``ffn_ln_dw_bwd`` (N6: N5's pass, then the dW kernel on
``gemm::atb``). For each case this probe gives the wrapper's CUDA-event ms
(median of ``--reps`` single calls), its device ms (the profiler's kernels
over ``--reps`` calls) and that device time split by kernel name, the bound
(the case's products at the bf16 peak), and cuBLAS's fc1 product alone on the
same x and W1 (``torch.matmul``, device ms) as a yardstick the port never
calls; N7's and N6's rows add their own yardsticks (``yardstick_device_ms``:
K5's forward and cuBLAS's fc2 product; cuBLAS's two dW products). Run on the
card:

    python -m coral_tpu_torch.tools.probe_ffn [--reps 10] [--only ffn_ln_fc2_fwd ...]

To time a variant of the kernels, copy ``coral_tpu_torch/`` to another
directory, edit its ``csrc/``, and run the same command from that directory:
each copy builds its own library, so a parent and its variants can be timed
in turn in one session on one card. One JSON line per case, with the card's
name and power limit. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import torch

from ..ops import _build, ffn
from . import BF16_FLOPS, card, emit, event_ms
from .probe_ln_host import device_us

# (wrapper, D, rows a batch row of 8, dropout rate): the serving and
# training rows of XLS-R-300M (1024), Whisper large-v3's encoder and XLS-R-1B
# (1280), XLS-R-2B (1920), as chip_smoke.py times them.
CASES = (("ffn_ln_fc1_fwd", 1024, 1499, 0.0), ("ffn_ln_fc1_fwd", 1280, 1500, 0.0),
         ("ffn_ln_fc1_fwd", 1280, 1500, 0.1), ("ffn_ln_fc1_fwd", 1920, 1499, 0.0),
         ("ffn_ln_fc1_fwd", 1024, 499, 0.1), ("ffn_bwd", 1280, 1500, 0.1),
         ("ffn_bwd", 1920, 499, 0.1), ("ffn_bwd", 1024, 499, 0.1),
         ("ffn_fc1_fwd", 1024, 1499, 0.0), ("ffn_fc1_bwd", 1024, 499, 0.1),
         ("ffn_ln_g_bwd", 1280, 1500, 0.1),
         ("ffn_ln_fc2_fwd", 1024, 1499, 0.0), ("ffn_ln_fc2_fwd", 1024, 499, 0.1),
         ("ffn_ln_fc2_fwd", 1280, 1500, 0.0), ("ffn_ln_fc2_fwd", 1280, 1500, 0.1),
         ("ffn_ln_dw_bwd", 1024, 499, 0.1), ("ffn_ln_dw_bwd", 1280, 1500, 0.1))
# Products of 2 M D F a call: the forwards one, the backwards with dg read in
# two (h again, dl), K5's three (h, dg, dl), N7 two (fc1, fc2), N6 four (h
# again, dl, dW1, dW2).
PRODUCTS = {"ffn_ln_fc1_fwd": 1, "ffn_fc1_fwd": 1, "ffn_bwd": 3, "ffn_fc1_bwd": 2,
            "ffn_ln_g_bwd": 2, "ffn_ln_fc2_fwd": 2, "ffn_ln_dw_bwd": 4}
KERNELS = ("ffn_fwd_kernel", "ffn_bwd_kernel", "dl_kernel", "ln_bwd", "ffn_ln_fc2_kernel",
           "ffn_dw_kernel", "ffn_dw_finish_kernel")


def device_ms_by_kernel(fn, reps: int, kernels=KERNELS) -> dict:
    """Device ms a call of ``fn`` by kernel name under the profiler: the
    names in ``kernels`` (by default the FFN mainloop's kernels and the
    LayerNorm backward), the rest summed as "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = next((k for k in kernels if k in e.name), "other")
            out[name] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    return dict(out)


def call(wrapper: str, D: int, T: int, rate: float, gen, dev):
    """The case's zero-argument call, its x and W1, and its yardstick (a
    zero-argument call of library products, or None)."""
    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    bf16, F = torch.bfloat16, 4 * D
    x = randn(8, T, D, offset=0.2, dtype=bf16)
    w1 = randn(F, D, scale=D**-0.5, dtype=bf16)
    w2 = randn(D, F, scale=F**-0.5, dtype=bf16)
    b1, g, b = randn(F, scale=0.1), randn(D, scale=0.1, offset=1.0), randn(D, scale=0.1)
    dy, dg = randn(8, T, D, dtype=bf16), randn(8, T, F, dtype=bf16)
    seeds = torch.randint(-(2**31), 2**31, (8,), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32) if rate else None
    fn = {"ffn_ln_fc1_fwd": lambda: ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=rate, seeds=seeds),
          "ffn_bwd": lambda: ffn.ffn_bwd(x, w1, b1, g, b, dy, w2, rate=rate, seeds=seeds),
          "ffn_fc1_fwd": lambda: ffn.ffn_fc1_fwd(x, w1, b1, rate, seeds),
          "ffn_fc1_bwd": lambda: ffn.ffn_fc1_bwd(x, w1, b1, dg, rate, seeds),
          "ffn_ln_g_bwd": lambda: ffn.ffn_ln_g_bwd(x, w1, b1, g, b, dg, rate=rate,
                                                   seeds=seeds),
          "ffn_ln_fc2_fwd": lambda: ffn.ffn_ln_fc2_fwd(x, w1, b1, g, b, w2, b, rate=rate,
                                                       seeds=seeds),
          "ffn_ln_dw_bwd": lambda: ffn.ffn_ln_dw_bwd(x, w1, b1, g, b, dy, dg, rate=rate,
                                                     seeds=seeds)}[wrapper]
    M = 8 * T
    yardstick = {
        "ffn_ln_fc2_fwd": lambda: torch.matmul(
            ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=rate, seeds=seeds), w2.t()),
        "ffn_ln_dw_bwd": lambda: (torch.matmul(dg.view(M, F).t(), x.view(M, D)),
                                  torch.matmul(dy.view(M, D).t(), dg.view(M, F))),
    }.get(wrapper)
    return fn, x, w1, yardstick


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--only", nargs="*", default=None, help="the wrappers to time (default: all)")
    args = p.parse_args(argv)
    device_card = card()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for wrapper, D, T, rate in CASES:
        if args.only and wrapper not in args.only:
            continue
        fn, x, w1, yardstick = call(wrapper, D, T, rate, gen, dev)
        x2 = x.view(-1, D)
        bound = PRODUCTS[wrapper] * 2 * x2.shape[0] * D * w1.shape[0] / BF16_FLOPS * 1e3
        row = {"probe": "ffn", "wrapper": wrapper, "D": D, "rows": [8, T], "rate": rate,
               "events_ms": event_ms(fn, args.reps)[0],
               "device_ms": device_us(fn, args.reps) / 1e3,
               "device_ms_by_kernel": device_ms_by_kernel(fn, args.reps),
               "bound_ms": bound,
               "cublas_fc1_device_ms": device_us(lambda: torch.matmul(x2, w1.t()),
                                                 args.reps) / 1e3}
        if yardstick is not None:
            row["yardstick_device_ms"] = device_us(yardstick, args.reps) / 1e3
        emit({**row, "package": ffn.__file__, "card": device_card})
        del fn, x, w1, x2, yardstick
        torch.cuda.empty_cache()
    _build.reset_launch_counts()


if __name__ == "__main__":
    main()
