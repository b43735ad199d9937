"""The decode attention kernels at Whisper large-v3's decode shapes.

``decode_self_attention`` (K8) and ``decode_cross_attention`` (K9) run 64
times a greedy decode step, so a call's host path counts as much as its
device time. For each shape this probe times the public wrapper by CUDA
events (median of ``--reps`` single calls, the host path in it), by device
time (the profiler's kernels over ``--reps`` calls), by host microseconds a
call (``--calls`` calls, no synchronise between them), counts its device
kernels a call, and gives its bound (each input read once at 3.35 TB/s) and
``scaled_dot_product_attention``'s events and device ms on the same inputs.
With ``--clusters`` it also times the kernel's C entry at every cluster size
the kernel takes (1, 2, 4, 8, at most the 64-key tiles) beside the one the
wrapper picks (``decode_attention.cluster_size``, from the blocks a call may
launch, ``wave_blocks``). Run on the card:

    python -m coral_tpu_torch.tools.probe_decode [--clusters] [--reps 10] [--calls 1000]

The shapes: 20 heads of 64, batch 8, layer 17 of 32; the self-attention
over each greedy cache phase (64, 128, 225, 256, 448 slots, position 2T/3)
at K = 1 and over 225 slots at K = 5 beams of 2 items (``chip_smoke.py``'s),
the cross-attention over 1500 encoder rows. One JSON line per case, with the
card's name and power limit. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import functools

import torch

from ..ops import _build, decode_attention
from . import HBM_BYTES_PER_S, card, emit, event_ms
from .probe_ln_host import device_us, per_call_us

H, D, L, LAYER, BATCH = 20, 64, 32, 17, 8
SELF_SHAPES = ((1, BATCH, 64), (1, BATCH, 128), (1, BATCH, 225), (1, BATCH, 256),
               (1, BATCH, 448), (5, 2, 225))  # (K, items, slots)
CROSS_S = 1500


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cases(dev) -> list[dict]:
    """Each shape's wrapper call, its C entry's inputs and its SDPA call."""
    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    out = []
    for K, B, T in SELF_SHAPES:
        q = randn(B * K, H * D)
        ck, cv = randn(L, B * K, T, H * D), randn(L, B * K, T, H * D)
        pos = 2 * T // 3
        slots = torch.randint(0, K, (B, K, pos + 1), generator=gen, device=dev) * T
        onehot = torch.zeros(B, K, K * T, device=dev)
        onehot.scatter_(2, slots + torch.arange(pos + 1, device=dev), 1.0)
        kh, vh = (t[LAYER].view(B, K * T, H, D).transpose(1, 2) for t in (ck, cv))
        qh = q.view(B, K, H, D).transpose(1, 2)
        bias = torch.where(onehot > 0, 0.0, -1e30).to(torch.bfloat16)[:, None]
        out.append({
            "kernel": "decode_self_attention", "K": K, "items": B, "n_keys": K * T,
            "call": functools.partial(decode_attention.decode_self_attention, q, ck, cv, onehot,
                                      H, LAYER),
            "entry": (q, ck, cv, onehot, B, K, K * T),
            "sdpa": functools.partial(sdpa, qh, kh, vh, attn_mask=bias),
            "bytes": 2 * _nbytes(q) + 2 * _nbytes(ck[LAYER]) + _nbytes(onehot)})
    q = randn(BATCH, H * D)
    k, v = randn(L, BATCH, CROSS_S, H * D), randn(L, BATCH, CROSS_S, H * D)
    kh, vh = (t[LAYER].view(BATCH, CROSS_S, H, D).transpose(1, 2) for t in (k, v))
    qh = q.view(BATCH, 1, H, D).transpose(1, 2)
    out.append({
        "kernel": "decode_cross_attention", "K": 1, "items": BATCH, "n_keys": CROSS_S,
        "call": functools.partial(decode_attention.decode_cross_attention, q, k, v, H, LAYER),
        "entry": (q, k, v, None, BATCH, 1, CROSS_S),
        "sdpa": functools.partial(sdpa, qh, kh, vh),
        "bytes": 2 * _nbytes(q) + 2 * _nbytes(k[LAYER])})
    return out


def device_kernels(fn) -> list[str]:
    """The names of the device kernels one call of ``fn`` launches, by
    ``torch.profiler`` (after one call outside it), as ``chip_smoke.py``
    counts them: a window that caught no kernel is profiled again, up to
    three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            return names
    return names


def entry_call(inputs, C: int):
    """The kernel's C entry at cluster size ``C`` (the wrapper's checks and
    counter left out)."""
    q, k, v, mask, B, K, n_keys = inputs
    out = torch.empty_like(q)
    lib = _build.library()

    def call():
        err = lib.coral_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if mask is None else mask.data_ptr(),
            out.data_ptr(), B, K, n_keys, H, L, LAYER, C, D**-0.5, _build.current_stream())
        if err != 0:
            raise RuntimeError(f"coral_decode_attention failed with {err}")
    return call


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clusters", action="store_true",
                   help="also time the C entry at every cluster size the kernel takes")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--calls", type=int, default=1000)
    args = p.parse_args(argv)
    device_card = card()
    for case in cases(torch.device("cuda")):
        fn = case["call"]
        record = {"probe": "decode", "kernel": case["kernel"], "K": case["K"],
                  "items": case["items"], "n_keys": case["n_keys"],
                  "wave_blocks": decode_attention.wave_blocks(case["K"], 0),
                  "cluster": decode_attention.cluster_size(
                      case["n_keys"], case["items"] * H * -(-case["K"] // decode_attention.GROUP),
                      decode_attention.wave_blocks(case["K"], 0)),
                  "events_ms": event_ms(fn, args.reps)[0],
                  "device_ms": device_us(fn, args.reps) / 1e3,
                  "host_us_per_call": per_call_us(fn, args.calls),
                  "device_kernels_per_call": len(device_kernels(fn)),
                  "bound_ms": case["bytes"] / HBM_BYTES_PER_S * 1e3,
                  "sdpa_events_ms": event_ms(case["sdpa"], args.reps)[0],
                  "sdpa_device_ms": device_us(case["sdpa"], args.reps) / 1e3}
        if args.clusters:
            tiles = -(-case["n_keys"] // decode_attention.TILE)
            record["device_ms_by_cluster"] = {
                C: device_us(entry_call(case["entry"], C), args.reps) / 1e3
                for C in (1, 2, 4, 8) if C <= tiles}
        record["card"] = device_card
        emit(record)
    _build.reset_launch_counts()


if __name__ == "__main__":
    main()
