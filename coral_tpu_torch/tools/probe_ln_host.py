"""The LayerNorm wrappers' host path, piece by piece.

A single call of ``ln_fused`` or ``ln_bwd`` on the card takes longer on the
host, in Python and the CUDA runtime, than its kernel takes on the device.
This probe times each piece of each wrapper's host path on its own: the
autograd ``Function.apply``, the checks, the allocations, the stream lookup,
``_build.library()``, the ctypes call (which launches), the launch counter,
the occupancy query, the torch sum after the backward kernel and the casts
of bf16 gamma and beta around it, as far as the probed tree runs them; then
each whole call. On a tree whose wrappers no longer run a piece of the
parent's path (the casts, the sum, the ``Stream`` object), that piece runs
as the parent ran it, under a name that starts with "gone:". Every piece runs ``--calls`` times under
``time.perf_counter``, with one synchronise before the loop and one after it
and none between calls, at 8 x 8 rows (a piece's host time does not depend
on the rows; a small launch keeps the device ahead of the host, so that no
launch waits for room in the queue).

The pieces are those the probed tree's wrappers run, told apart by its C
signatures, so the file also probes a parent commit's tree: copy it into
that checkout's ``coral_tpu_torch/tools/`` and run it there. Run on the card:

    python -m coral_tpu_torch.tools.probe_ln_host [--calls 1000] [--rows]

``--rows`` also times the LN rows of ``chip_smoke.py`` at their shapes
through the public wrappers (fp32 weights, as the rows take them): events
microseconds (median of 10 single calls) and device microseconds (the
profiler's kernels, over 10 calls), for two trees in turns in one call.

One JSON line per wrapper and piece: microseconds per call, the card's name
and power limit. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ops import _build, ln_gelu
from . import card, emit

C = 1024
ROWS = (8, 8)
EPS = 1e-5


def per_call_us(fn, calls: int) -> float:
    """Microseconds of host time per call of ``fn`` over ``calls`` calls, the
    device synchronised before and after the loop only."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


class _Identity(torch.autograd.Function):
    """y = x, with a backward that returns dy as it is."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy


def _inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(*ROWS, C, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(*ROWS, C, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(C, generator=gen, device=dev) * 0.1 + 1.0
    b = torch.randn(C, generator=gen, device=dev) * 0.1
    return x, dy, g, b


def pieces(ln, build) -> dict:
    """{wrapper: {piece: callable}} for the probed tree's wrappers."""
    dev = torch.device("cuda")
    x, dy, g, b = _inputs(dev)
    gb, bb = g.to(torch.bfloat16), b.to(torch.bfloat16)
    rows = x.numel() // C
    lib = build.library()
    old = "coral_ln_bwd_blocks" in build._SIGNATURES and len(
        build._SIGNATURES["coral_ln_bwd"]) == 14
    y = torch.empty_like(x)
    xr = x.clone().requires_grad_(True)
    gr, br = gb.clone().requires_grad_(True), bb.clone().requires_grad_(True)
    out = ln.ln_fused(xr, gr, br)
    counts = build.launch_counts
    fwd = {
        "Function.apply (saved: no launch)": lambda: ln._LayerNorm.apply(
            xr, gr, br, EPS, False, False, y),
        "require_cuda": lambda: build.require_cuda("coral_ln_gelu", x),
        "checks": lambda: ln._check_row_op("coral_ln_gelu", x, g, b, ln.KERNEL_C),
        "allocation of y": lambda: torch.empty_like(x),
        "library()": build.library,
        "launch counter": lambda: counts.update(probe=1),
        "gamma and beta cast to fp32": lambda: (gb.float(), bb.float()),
    }
    bwd = {
        "require_cuda": lambda: build.require_cuda("coral_ln_bwd", x),
        "checks": lambda: (ln._check_row_op("coral_ln_bwd", x, g, b, ln.KERNEL_C_BWD),
                           build.check_cuda("coral_ln_bwd", dy.dtype, dy)),
        "allocation of dx": lambda: torch.empty_like(x),
    }
    if old:
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        fwd["stream: torch.cuda.current_stream()"] = stream
        bwd["stream: torch.cuda.current_stream()"] = stream
        flags = (1, 1, 0)
        blocks = lib.coral_ln_bwd_blocks(rows, C, *flags)
        part = torch.empty((blocks, 2, C), device=dev)
        fwd["ctypes call (launch)"] = lambda: lib.coral_ln_gelu(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, C, 1, 0, EPS,
            stream())
        bwd["occupancy query (coral_ln_bwd_blocks)"] = lambda: lib.coral_ln_bwd_blocks(
            rows, C, *flags)
        bwd["allocation of the partials"] = lambda: torch.empty((blocks, 2, C), device=dev)
        bwd["ctypes call (launch)"] = lambda: lib.coral_ln_bwd(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), dy.data_ptr(), y.data_ptr(),
            part.data_ptr(), rows, C, blocks, *flags, EPS, stream())
        bwd["sum of the partials (torch)"] = lambda: part.sum(0)
        bwd["dgamma and dbeta cast to bf16"] = lambda: (g.to(torch.bfloat16),
                                                        b.to(torch.bfloat16))
    else:
        fwd["stream: raw current stream"] = build.current_stream
        bwd["stream: raw current stream"] = build.current_stream
        scratch, dvec = ln._bwd_buffers(x, C, 1, 1, 0, g.dtype)
        fwd["ctypes call (launch)"] = lambda: lib.coral_ln_gelu(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, C, 1, 0, 0, EPS,
            build.current_stream())
        bwd["allocation of the partials and of dgamma and dbeta"] = lambda: ln._bwd_buffers(
            x, C, 1, 1, 0, g.dtype)
        bwd["ctypes call (two launches)"] = lambda: lib.coral_ln_bwd(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), dy.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), scratch.shape[0], dvec.data_ptr(), rows, C, 1, 1, 0, 0, EPS,
            build.current_stream())
        # What the parent tree's wrappers ran and these no longer do, run as
        # they ran it, for the split before and after in one run.
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        fwd["gone: stream by torch.cuda.current_stream()"] = stream
        fwd["gone: gamma and beta cast to fp32"] = fwd.pop("gamma and beta cast to fp32")
        bwd["gone: stream by torch.cuda.current_stream()"] = stream
        bwd["gone: gamma and beta cast to fp32"] = fwd["gone: gamma and beta cast to fp32"]
        bwd["gone: sum of the partials (torch)"] = lambda: scratch.sum(0)
        bwd["gone: dgamma and dbeta cast to bf16"] = lambda: (g.to(torch.bfloat16),
                                                              b.to(torch.bfloat16))
    fwd["whole call, no gradient, fp32 gamma"] = lambda: ln.ln_fused(x, g, b)
    fwd["whole call, x requires grad, bf16 gamma"] = lambda: ln.ln_fused(xr, gr, br)
    bwd["whole call, fp32 gamma"] = lambda: ln.ln_bwd(x, g, b, dy, apply_gelu=False)
    bwd["autograd backward, bf16 gamma"] = lambda: torch.autograd.grad(
        out, (xr, gr, br), dy, retain_graph=True)
    # Yardsticks of the autograd engine: the library's LayerNorm backward (a
    # C++ node) and a Python Function whose backward runs nothing.
    library_out = torch.nn.functional.layer_norm(xr, (C,), gr, br, EPS)
    bwd["yardstick: autograd backward of F.layer_norm, bf16 gamma"] = (
        lambda: torch.autograd.grad(library_out, (xr, gr, br), dy, retain_graph=True))
    identity_out = _Identity.apply(xr)
    bwd["yardstick: autograd backward of a Python Function that runs nothing"] = (
        lambda: torch.autograd.grad(identity_out, (xr,), dy, retain_graph=True))
    return {"ln_fused": fwd, "ln_bwd": bwd}


def run(ln, build, calls: int, device_card: str) -> dict:
    """Times every piece; emits one JSON line each and returns {wrapper:
    {piece: us}}."""
    table = {}
    for wrapper, fns in pieces(ln, build).items():
        table[wrapper] = {}
        for piece, fn in fns.items():
            us = per_call_us(fn, calls)
            table[wrapper][piece] = us
            emit({"probe": "ln_host", "wrapper": wrapper, "piece": piece,
                  "us_per_call": us, "calls": calls, "rows": ROWS[0] * ROWS[1], "C": C,
                  "card": device_card})
    return table


# The LN rows of chip_smoke.py: (wrapper, rows, C, dy dtype), fp32 weights.
ROW_SHAPES = (("ln_fused", (8, 1499), 1024, None), ("ln_fused", (8, 1499), 1280, None),
              ("ln_fused", (8, 1499), 1920, None),
              ("ln_bwd", (8, 499), 1024, torch.bfloat16), ("ln_bwd", (8, 499), 1280, torch.bfloat16),
              ("ln_bwd", (8, 499), 1920, torch.bfloat16), ("ln_bwd", (8, 1500), 384, torch.float32),
              ("ln_bwd", (8, 1500), 768, torch.float32), ("ln_bwd", (8, 1500), 1280, torch.float32))


def device_us(fn, reps: int = 10) -> float:
    """Microseconds of device kernels a call, by ``torch.profiler`` over
    ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps


def rows(device_card: str, reps: int = 10) -> None:
    """Each LN row of chip_smoke.py: events us (median of ``reps`` single
    calls, the host path in it) and device us, through the public wrappers."""
    from . import event_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for wrapper, shape, C_, dyd in ROW_SHAPES:
        x = torch.randn(*shape, C_, generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(C_, generator=gen, device=dev) * 0.1 + 1.0
        b = torch.randn(C_, generator=gen, device=dev) * 0.1
        if wrapper == "ln_fused":
            fn = lambda: ln_gelu.ln_fused(x, g, b)  # noqa: E731
        else:
            dy = torch.randn(*shape, C_, generator=gen, device=dev).to(dyd)
            fn = lambda: ln_gelu.ln_bwd(x, g, b, dy, apply_gelu=False)  # noqa: E731
        emit({"probe": "ln_rows", "wrapper": wrapper, "rows": shape[0] * shape[1], "C": C_,
              "dy": None if dyd is None else str(dyd).replace("torch.", ""),
              "events_us": event_ms(fn, reps)[0] * 1e3, "device_us": device_us(fn, reps),
              "card": device_card})


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--calls", type=int, default=1000)
    p.add_argument("--rows", action="store_true",
                   help="also time chip_smoke.py's LN rows: events and device us")
    args = p.parse_args(argv)
    device_card = card()
    run(ln_gelu, _build, args.calls, device_card)
    if args.rows:
        rows(device_card)


if __name__ == "__main__":
    main()
