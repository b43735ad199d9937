"""K6, the CTC recursions, at the training shape: the kernels beside their
latency floor and ``F.ctc_loss``.

``ctc_alpha`` and ``ctc_beta`` (``csrc/ctc.cu``) at T' 499, B 8, L 128 (S
257) over a vocabulary of 46, the lengths ``chip_smoke.py`` times them at.
For each recursion: the wrapper's CUDA-event ms (median of ``--reps`` single
calls) and device ms (the profiler's, over ``--reps`` calls); the kernel's
device ms alone (its masks converted once, outside the call) at the
kernel's own choice of states a thread R and at R = 1, 2, 4
(``coral_ctc_probe`` mode 0);
its latency floor (mode 1: the same recursion, the state in registers, no
emission ring and no stores: T' times the step's dependent chain); the byte
bound (emissions and masks in, outputs out, at 3.35 TB/s); and
``torch.nn.functional.ctc_loss`` forward, and forward and backward, on the
same log-probs and labels: a yardstick that computes more (the loss and its
gradient too), which the port never calls. Run on the card:

    python -m coral_tpu_torch.tools.probe_ctc [--reps 10]

To time a variant of the kernel, copy ``coral_tpu_torch/`` to another
directory, edit its ``csrc/ctc.cu`` and run the same command from there:
each copy builds its own library. One JSON line per case, with the card's
name and power limit. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import _build, ctc
from . import HBM_BYTES_PER_S, card, emit, event_ms
from .probe_ln_host import device_us

# The training batch's frames and label lengths (row 7 infeasible), as
# chip_smoke.py's CTC rows.
IN_LEN = (499, 450, 400, 350, 300, 499, 499, 100)
LAB_LEN = (128, 100, 64, 128, 32, 1, 0, 128)


def case(gen, dev, T: int = 499, L: int = 128, V: int = 46):
    """log-probs (T, 8, V), labels (8, L), the lengths, and the alpha and
    beta wrappers' arguments on ``_emissions``'s view."""
    B = len(IN_LEN)
    log_probs = torch.log_softmax(3.0 * torch.randn(T, B, V, generator=gen, device=dev), dim=-1)
    labels = torch.randint(1, V, (B, L), generator=gen, device=dev)
    in_len = torch.tensor(IN_LEN, device=dev)
    lab_len = torch.tensor(LAB_LEN, device=dev)
    ext = ctc._extended_labels(labels, 0)
    skip, skip_fwd, valid, terminal = ctc._state_masks(ext, lab_len, 0)
    emit_ = ctc._emissions(log_probs, ext)
    return (log_probs, labels, in_len, lab_len, (emit_, skip, valid, in_len),
            (emit_, skip_fwd, valid, in_len, terminal))


def launcher(args: tuple, beta: bool, mode: int, R: int = 0):
    """A zero-argument call that launches ``coral_ctc_probe`` once on the
    wrapper's arguments ``args`` (their masks and lengths converted once,
    outside the call): mode 0 the kernel at R states a thread (0: the
    kernel's own choice), mode 1 its latency floor (which writes only the
    last state, into the output's first time step)."""
    emit_, lengths = args[0], args[3]
    masks = (args[1], args[2], args[4]) if beta else (args[1], args[2])
    T, B, S = emit_.shape
    rows, ld = ctc._rows("coral_ctc_probe", emit_)
    m = [t.to(torch.uint8).contiguous() for t in masks]
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.zeros((T, B, ld), dtype=torch.float32, device=emit_.device)
    last = m[2].data_ptr() if beta else None

    def call():
        _build.launch("coral_ctc_probe", "probe_ctc", mode, R, int(beta), rows.data_ptr(),
                      m[0].data_ptr(), m[1].data_ptr(), lengths.data_ptr(), last,
                      out.data_ptr(), T, B, S, ld)
        return out[..., :S]

    return call


def floor_device_ms(args: tuple, beta: bool, reps: int = 10) -> float:
    """The latency floor's device ms a call (mode 1, the kernel's R)."""
    return device_us(launcher(args, beta, 1), reps) / 1e3


def moved_bytes(args: tuple) -> int:
    """The recursion's bytes: the emissions and masks read once, the (T, B,
    S) fp32 output written once."""
    emit_ = args[0]
    return (2 * emit_.numel() * 4 + sum(t.numel() for t in args[1:] if t.dtype == torch.bool)
            + args[3].numel() * 8)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    device_card = card()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    log_probs, labels, in_len, lab_len, a_args, b_args = case(gen, dev)
    T, B, S = a_args[0].shape
    for name, fn, beta, wargs in (("ctc_alpha", ctc.ctc_alpha, False, a_args),
                                  ("ctc_beta", ctc.ctc_beta, True, b_args)):
        floor = floor_device_ms(wargs, beta, args.reps)
        row = {"probe": "ctc", "kernel": name, "shape": [T, B, S],
               "events_ms": event_ms(lambda: fn(*wargs), args.reps)[0],
               "device_ms": device_us(lambda: fn(*wargs), args.reps) / 1e3,
               "kernel_device_ms_by_R": {
                   R: device_us(launcher(wargs, beta, 0, R), args.reps) / 1e3
                   for R in (0, 1, 2, 4)},
               "floor_device_ms": floor, "floor_ns_a_step": floor * 1e6 / T,
               "bound_ms": moved_bytes(wargs) / HBM_BYTES_PER_S * 1e3}
        emit({**row, "package": ctc.__file__, "card": device_card})
    lp = log_probs.detach().clone().requires_grad_(True)

    def loss():
        return torch.nn.functional.ctc_loss(lp, labels, in_len, lab_len, blank=0,
                                            reduction="sum", zero_infinity=True)

    def loss_and_grad():
        lp.grad = None
        loss().backward()

    emit({"probe": "ctc", "kernel": "F.ctc_loss (loss and gradient: more than K6)",
          "shape": [T, B, S], "forward_device_ms": device_us(loss, args.reps) / 1e3,
          "forward_backward_device_ms": device_us(loss_and_grad, args.reps) / 1e3,
          "forward_events_ms": event_ms(loss, args.reps)[0],
          "forward_backward_events_ms": event_ms(loss_and_grad, args.reps)[0],
          "package": ctc.__file__, "card": device_card})
    _build.reset_launch_counts()


if __name__ == "__main__":
    main()
