"""The feature encoder's conv+LN+GELU backward with one phase taken out.

Port of ``tools/probe_fe_bwd.py`` (``_bwd_variant`` :138 -> ``_variant_kernel``
:50) to the H100: each mode runs the port's K3 backward
(``csrc/conv_ln_gelu.cu``: the row kernel, the dx kernel, the dW kernel and
its finish) with one phase removed, so that the difference to ``full`` is
that phase's cost; each launch is timed on its own too (dW with the finish). The modes, as the kernels' source
describes them:

  full      the production kernels (``conv_ln_gelu_bwd``'s, bit for bit)
  no_vpu    da := dy (no dGELU, LayerNorm backward or dvec)
  no_dvec   the row kernel without its three dvec partial sums
  no_dw     the dW launch skipped (dw = 0)
  no_dx     the dx launch skipped; dx rows t < T_out hold da, the rest 0
  no_inter  each 256-pair slab's even dx rows to its first 256 rows, the
            odd ones to its last 256, instead of interleaved
  mm_only   da := dy without the row mask; the kernels' loaders zero rows
            past T_out anyway, so this is ``no_vpu`` here

A mode returns zeros where it computes nothing (dvec of no_vpu, no_dvec and
mm_only; dw of no_dw). The floor is the JAX tool's, ``2 * 2k * B * T_out *
C**2`` operations (its 2k products of T_out x C x C), at the H100's bf16
peak.

Run on the card:

    python -m coral_tpu_torch.tools.probe_fe_bwd --layer 1 --batch 48 --seconds 10 --reps 30
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from ..ops import _build
from ..ops import conv_ln_gelu as _conv
from ..ops.gelu_poly import _dgelu
from . import BF16_FLOPS, card, emit, event_ms

MODES = ("full", "no_vpu", "no_dvec", "no_dw", "no_dx", "no_inter", "mm_only")
C = _conv.KERNEL_C
# Input-row pairs of one slab of the no_inter layout: the TPU kernel's 256
# output rows a grid step.
SLAB_PAIRS = 256
# The feature encoder's kernels (16 kHz: conv 0 is k = 10, stride 5; then 1-6).
KS = (3, 3, 3, 3, 2, 2)


def layer_shape(layer: int, seconds: float, batch: int) -> tuple[int, int, int, int]:
    """(B, T_in, T_out, k) of FE block ``layer`` (1-6) for clips of
    ``seconds``, as the JAX tool's ``main`` computes them."""
    T = int(seconds * 16000)
    T = (T - 10) // 5 + 1
    for i in range(layer - 1):
        T = (T - KS[i]) // 2 + 1
    k = KS[layer - 1]
    return batch, T, (T - k) // 2 + 1, k


def floor_flops(B: int, T_out: int, k: int) -> float:
    """The JAX tool's all-matmul count: 2k products of T_out x C x C a row."""
    return 2.0 * 2 * k * B * T_out * C * C


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"probe_fe_bwd: mode must be one of {MODES}, got {mode!r}")


def _place(even, odd, T_in: int, split: bool):
    """dx from the pairs' even and odd rows (B, pairs, C): interleaved, or
    (split) each slab's even rows first and its odd rows after; rows at or
    past T_in are dropped, rows no pair writes are 0."""
    B, pairs, _ = even.shape
    s = torch.arange(pairs, device=even.device)
    if split:
        base = 2 * SLAB_PAIRS * (s // SLAB_PAIRS) + s % SLAB_PAIRS
        rows = (base, base + SLAB_PAIRS)
    else:
        rows = (2 * s, 2 * s + 1)
    dx = torch.zeros((B, T_in, even.shape[-1]), dtype=torch.float32, device=even.device)
    for r, v in zip(rows, (even, odd)):
        keep = r < T_in
        dx[:, r[keep]] = v[:, keep]
    return dx


def bwd_variant_plain(x, w, gamma, beta, xhat, rstd, dy, mode: str):
    """Mode ``mode`` of the backward in plain ops, the formula of
    ``conv_ln_gelu_bwd_plain`` with the mode's phase taken out.

    Args:
        x: (B, T_in, C); w: (C_out, C_in, k), PyTorch's ``Conv1d`` layout;
            gamma, beta: (C,); xhat, dy: (B, T_out, C); rstd: (B, T_out).

    Returns:
        (dx in x.dtype, dw (C_out, C_in, k) fp32, dvec (3, C_out) fp32:
        dgamma, dbeta, dbias).
    """
    _check_mode(mode)
    dt = x.dtype
    B, T_in, C_in = x.shape
    C_out, _, k = w.shape
    T_out = dy.shape[1]
    dvec = torch.zeros((3, C_out), dtype=torch.float32, device=x.device)
    if mode in ("no_vpu", "mm_only"):
        da = dy.float()
    else:
        xh = xhat.float()
        g = gamma.float()
        dh = dy.float() * _dgelu(xh * g + beta.float())
        dn = dh * g
        da = (dn - dn.mean(dim=-1, keepdim=True)
              - xh * (dn * xh).mean(dim=-1, keepdim=True)) * rstd.float()[..., None]
        if mode != "no_dvec":
            dvec = torch.stack([(dh * xh).sum(dim=(0, 1)), dh.sum(dim=(0, 1)),
                                da.sum(dim=(0, 1))])
    dab = da.to(dt).float()
    wf = w.to(dt).float()
    if mode == "no_dx":
        dx = torch.zeros((B, T_in, C_in), dtype=torch.float32, device=x.device)
        dx[:, :T_out] = dab
    else:
        # Pair s: input rows 2s (da[s] W0^T + da[s-1] W2^T) and 2s+1 (da[s]
        # W1^T); da rows outside [0, T_out) are 0.
        pairs = (T_in + 1) // 2
        dap = torch.zeros((B, pairs + 1, C_out), dtype=torch.float32, device=x.device)
        dap[:, 1:T_out + 1] = dab
        even = dap[:, 1:] @ wf[:, :, 0]
        if k == 3:
            even = even + dap[:, :-1] @ wf[:, :, 2]
        odd = dap[:, 1:] @ wf[:, :, 1]
        dx = _place(even, odd, T_in, split=mode == "no_inter")
    if mode == "no_dw":
        dw = torch.zeros((C_out, C_in, k), dtype=torch.float32, device=x.device)
    else:
        xf = x.float()
        dw = torch.stack([torch.einsum("btc,btd->cd", dab, xf[:, j:j + 2 * T_out - 1:2])
                          for j in range(k)], dim=-1)
    return dx.to(dt), dw, dvec


def bwd_variant(x, w, gamma, beta, xhat, rstd, dy, mode: str, events=None):
    """Mode ``mode`` of the K3 backward's kernels; arguments and results as
    ``bwd_variant_plain`` (on CUDA: bf16 x, xhat, dy, C = 512, k 2 or 3, fp32
    gamma, beta, rstd).

    Args:
        events: None, or 4 ``torch.cuda.Event`` (already recorded once, so
            that they exist) that the kernels record before the row kernel
            and after the row kernel, dx, and dW with the finish, a skipped
            one included.
    """
    name = "coral_conv_ln_gelu_bwd_probe"
    _check_mode(mode)
    _conv._k(name, w)
    if not _build.require_cuda(name, x):
        return bwd_variant_plain(x, w, gamma, beta, xhat, rstd, dy, mode)
    B, T_in, T_out, k, wp = _conv._check(name, x, w, gamma, beta)
    _build.check_cuda(name, torch.bfloat16, xhat, dy)
    _build.check_cuda(name, torch.float32, rstd)
    if xhat.shape != (B, T_out, C) or dy.shape != (B, T_out, C) or rstd.shape != (B, T_out):
        raise ValueError(f"{name}: xhat and dy must be ({B}, {T_out}, {C}), rstd ({B}, {T_out})")
    if events is not None and len(events) != 4:
        raise ValueError(f"{name}: events must be 4 CUDA events")
    row_blocks, R = _conv.bwd_partials(B, T_out, k)
    da = torch.empty_like(dy)
    # The modes that leave rows of dx, dW or dvec unwritten get zeros there.
    dx = torch.zeros_like(x) if mode in ("no_dx", "no_inter") else torch.empty_like(x)
    new = {True: torch.zeros, False: torch.empty}
    dw = new[mode == "no_dw"]((C, C, k), dtype=torch.float32, device=x.device)
    dvec = new[mode in ("no_vpu", "no_dvec", "mm_only")]((3, C), dtype=torch.float32,
                                                          device=x.device)
    dw_part = torch.empty((R, k, C, C), dtype=torch.float32, device=x.device)
    dvec_part = torch.empty((row_blocks, 3, C), dtype=torch.float32, device=x.device)
    handles = None if events is None else (ctypes.c_void_p * 4)(*(e.cuda_event for e in events))
    _build.launch(name, f"probe_fe_bwd_{mode}", MODES.index(mode), x.data_ptr(), wp.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), xhat.data_ptr(), rstd.data_ptr(),
                  dy.data_ptr(), da.data_ptr(), dx.data_ptr(), dw_part.data_ptr(),
                  dvec_part.data_ptr(), dw.data_ptr(), dvec.data_ptr(), B, T_in, T_out, C, k,
                  row_blocks, R, None if handles is None else ctypes.addressof(handles))
    return dx, dw, dvec


def make_inputs(B: int, T_in: int, k: int, device, seed: int = 0):
    """The JAX tool's inputs, drawn on ``device``: x, dy, xhat, w, gamma,
    beta normal * 0.05 in bf16 (gamma, beta then fp32, as the kernels take
    them), rstd |normal| in fp32; w in the ``Conv1d`` layout."""
    gen = torch.Generator(device=device).manual_seed(seed)
    T_out = (T_in - k) // 2 + 1

    def f(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.05).to(torch.bfloat16)

    x, dy, xhat = f(B, T_in, C), f(B, T_out, C), f(B, T_out, C)
    rstd = torch.randn((B, T_out), generator=gen, device=device).abs()
    w = f(C, C, k)
    gamma, beta = f(C).float(), f(C).float()
    return x, w, gamma, beta, xhat, rstd, dy


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--layer", type=int, default=1, help="FE layer index (1-4: k=3, 5-6: k=2)")
    p.add_argument("--reps", type=int, default=30)
    args = p.parse_args(argv)
    device_card = card()
    B, T_in, T_out, k = layer_shape(args.layer, args.seconds, args.batch)
    inputs = make_inputs(B, T_in, k, torch.device("cuda"))
    flops = floor_flops(B, T_out, k)
    floor = flops / BF16_FLOPS * 1e3
    results = {}
    for mode in MODES:
        ms, launches = event_ms(lambda ev, m=mode: bwd_variant(*inputs, m, events=ev),
                                args.reps, n_events=4)
        results[mode] = ms
        emit({"probe": "fe_bwd", "mode": mode, "ms": ms,
              "launch_ms": dict(zip(("rows", "dx", "dw"), launches)), "layer": args.layer,
              "batch": B, "T_in": T_in, "T_out": T_out, "k": k, "floor_ms": floor,
              "pct_of_floor": 100 * floor / ms, "card": device_card})
    full = results["full"]
    emit({"summary": {"floor_ms": floor, "full_ms": full,
                      "vpu_epilogue_ms": full - results["no_vpu"],
                      "dvec_ms": full - results["no_dvec"], "dw_ms": full - results["no_dw"],
                      "dx_ms": full - results["no_dx"],
                      "interleave_ms": full - results["no_inter"],
                      "mm_only_ms": results["mm_only"]}, "card": device_card})


if __name__ == "__main__":
    main()
