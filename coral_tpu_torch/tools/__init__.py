"""H100 probes: the ports of the JAX package's TPU microbenchmarks.

Each module holds a plain PyTorch version of every case of its probe and a
wrapper that launches the case's hand-written kernel for a CUDA tensor (and
raises where it cannot), as ``coral_tpu_torch/ops`` does, and a command line
that times every case on the card:

    python -m coral_tpu_torch.tools.probe_fe_bwd --layer 1 --batch 48 --seconds 10 --reps 30
    python -m coral_tpu_torch.tools.probe_gelu_cost
    python -m coral_tpu_torch.tools.probe_lane_reduce

- ``probe_fe_bwd``: the feature encoder's conv+LN+GELU backward with one
  phase taken out (``tools/probe_fe_bwd.py``);
- ``probe_gelu_cost``: polynomial epilogues and a dropout mask in the FFN's
  up-projection tile (``tools/probe_gelu_cost.py``);
- ``probe_lane_reduce``: a LayerNorm's row means by lane sums or by a
  ones-matrix product (``tools/probe_lane_reduce.py``).

Beside them, ``fwd_variants`` (no TPU counterpart) times the attention
forwards against builds with one of their design choices undone
(``python -m coral_tpu_torch.tools.fwd_variants``), ``probe_ln_host`` the
LayerNorm wrappers' host path piece by piece, ``probe_decode`` the decode
attention wrappers at Whisper large-v3's decode shapes, at every cluster
size (``python -m coral_tpu_torch.tools.probe_decode --clusters``),
``probe_ffn`` the FFN mainloop's wrappers at the main paths' shapes, by
kernel, beside cuBLAS's fc1 product (``python -m
coral_tpu_torch.tools.probe_ffn``; run from a copy of the package with an
edited ``csrc/`` to time a variant), ``probe_conv`` K3's wrappers at FE
blocks 1 and 5, by kernel, beside cuDNN's convolution alone (``python -m
coral_tpu_torch.tools.probe_conv``, likewise), and ``probe_ctc`` K6 at the
training shape beside its latency floor and ``F.ctc_loss`` (``python -m
coral_tpu_torch.tools.probe_ctc``, likewise).

Each prints one JSON line per case: the median of CUDA-event times, the
floor (the larger of the case's operations at the H100's dense bf16 peak and
its bytes at its memory rate), and the card's name and power limit. Without a
card the command lines exit non-zero; on the CPU the wrappers run the plain
versions, which the tests hold against the JAX tools.
"""

from __future__ import annotations

import json
import shutil
import subprocess

# One H100 SXM (NVIDIA's data sheet, dense): bf16 tensor cores and device
# memory, the rates chip_smoke.py counts bounds with.
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def floor_ms(flops: float, moved: float) -> float:
    """The least time in ms the card could take: ``flops`` at the bf16 peak
    or ``moved`` bytes at the memory rate, the larger."""
    return max(flops / BF16_FLOPS, moved / HBM_BYTES_PER_S) * 1e3


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes time the card and have no CPU fallback")
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}, power limit not read"


def event_ms(fn, reps: int, n_events: int = 0) -> tuple[float, list[float]]:
    """Median CUDA-event ms of ``fn()`` over ``reps`` calls after two warm-ups;
    with ``n_events``, ``fn(events)`` also records that many events around its
    own launches, and the medians of the gaps between consecutive ones come
    back too."""
    import numpy as np
    import torch

    def call():
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n_events)]
        for e in events:
            e.record()  # creates the event, so its handle exists
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if n_events:
            fn(events)
        else:
            fn()
        end.record()
        end.synchronize()
        gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        return start.elapsed_time(end), gaps

    call()
    call()
    runs = [call() for _ in range(reps)]
    total = float(np.median([r[0] for r in runs]))
    gaps = [float(np.median([r[1][i] for r in runs])) for i in range(max(n_events - 1, 0))]
    return total, gaps


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
