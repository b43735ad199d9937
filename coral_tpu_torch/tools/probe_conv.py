"""K3, the feature encoder's conv block, at the main paths' shapes, by kernel.

``conv_ln_gelu_fwd`` (the serving launch and the training launch, which
also writes xhat and rstd) and ``conv_ln_gelu_bwd`` (the row kernel, dx, dW's
partials and the finish) on ``csrc/conv_ln_gelu.cu``, at FE block 1 (k = 3)
and block 5 (k = 2) of a batch of 8 clips (30 s windows serving, 10 s
training). For each case: the wrapper's CUDA-event ms (median of ``--reps``
single calls), its device ms (the profiler's kernels over ``--reps`` calls)
and that device time split by kernel name, the bound (the case's products
at the bf16 peak), and cuDNN's convolution alone on the same x and w as a
yardstick the port never calls: ``F.conv1d(x.transpose(1, 2), w,
stride=2)`` for a forward, its backward (``aten.convolution_backward``: dx
and dW) for the backward. Run on the card:

    python -m coral_tpu_torch.tools.probe_conv [--reps 10]

To time a variant of the kernels, copy ``coral_tpu_torch/`` to another
directory, edit its ``csrc/``, and run the same command from that directory:
each copy builds its own library, so a parent and its variants can be timed
in turn in one run on one card. One JSON line per case, with the card's
name and power limit. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..ops import _build, conv_ln_gelu
from . import BF16_FLOPS, card, emit, event_ms
from .probe_fe_bwd import layer_shape
from .probe_ffn import device_ms_by_kernel
from .probe_ln_host import device_us

C = conv_ln_gelu.KERNEL_C
# (wrapper, FE block, clip seconds): chip_smoke.py's K3 rows.
CASES = (("fwd", 1, 30.0), ("train_fwd", 1, 10.0), ("bwd", 1, 10.0), ("fwd", 5, 30.0),
         ("train_fwd", 5, 10.0), ("bwd", 5, 10.0))
KERNELS = ("conv_ln_gelu_kernel", "conv_bwd_rows_kernel", "conv_bwd_dx_kernel",
           "conv_bwd_dw_kernel", "conv_bwd_finish_kernel")


def inputs(B: int, T_in: int, k: int, gen, dev):
    """chip_smoke.py's K3 inputs: x, w (Conv1d layout), b, gamma, beta."""
    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    return (randn(B, T_in, C, dtype=torch.bfloat16),
            randn(C, C, k, scale=math.sqrt(2.0 / (C * k)), dtype=torch.bfloat16),
            randn(C, scale=0.1), randn(C, scale=0.1, offset=1.0), randn(C, scale=0.1))


def cudnn_forward(x, w):
    """cuDNN's stride-2 convolution alone (no bias, LayerNorm or GELU)."""
    return lambda: torch.nn.functional.conv1d(x.transpose(1, 2), w, stride=2)


def cudnn_backward(x, w, dy):
    """cuDNN's backward of that convolution alone: dgrad and wgrad in one call
    (no LayerNorm or GELU backward)."""
    xt, dyt = x.transpose(1, 2), dy.transpose(1, 2)
    return lambda: torch.ops.aten.convolution_backward(
        dyt, xt, w, None, [2], [0], [1], False, [0], 1, [True, True, False])


def case(wrapper: str, layer: int, seconds: float, gen, dev):
    """The case's zero-argument call, its cuDNN yardstick and its products'
    flops."""
    B, T_in, T_out, k = layer_shape(layer, seconds, 8)
    x, w, b, g, beta = inputs(B, T_in, k, gen, dev)
    flops = 2.0 * B * T_out * C * C * k
    if wrapper == "bwd":
        _, xhat, rstd = conv_ln_gelu.conv_ln_gelu_fwd(x, w, b, g, beta)
        dy = torch.randn(xhat.shape, generator=gen, device=dev).to(torch.bfloat16)
        return (lambda: conv_ln_gelu.conv_ln_gelu_bwd(x, w, g, beta, xhat, rstd, dy),
                cudnn_backward(x, w, dy), 2 * flops, (B, T_in, T_out, k))
    train = wrapper == "train_fwd"
    return (lambda: conv_ln_gelu.conv_ln_gelu_fwd(x, w, b, g, beta, residuals=train),
            cudnn_forward(x, w), flops, (B, T_in, T_out, k))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    device_card = card()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for wrapper, layer, seconds in CASES:
        fn, yardstick, flops, (B, T_in, T_out, k) = case(wrapper, layer, seconds, gen, dev)
        emit({"probe": "conv", "wrapper": wrapper, "layer": layer, "B": B, "T_in": T_in,
              "T_out": T_out, "k": k, "events_ms": event_ms(fn, args.reps)[0],
              "device_ms": device_us(fn, args.reps) / 1e3,
              "device_ms_by_kernel": device_ms_by_kernel(fn, args.reps, KERNELS),
              "bound_ms": flops / BF16_FLOPS * 1e3,
              "cudnn_device_ms": device_us(yardstick, args.reps) / 1e3,
              "package": conv_ln_gelu.__file__, "card": device_card})
        del fn, yardstick
        torch.cuda.empty_cache()
    _build.reset_launch_counts()


if __name__ == "__main__":
    main()
