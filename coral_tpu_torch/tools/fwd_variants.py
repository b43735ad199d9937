"""The attention forwards' design choices, measured against their alternatives.

The forward kernels (``attention_fwd_kernel`` and ``flash_fwd_kernel``, the
Hopper mainloop of ``csrc/attention.cuh``) carry three choices that a first
version of the mainloop did without. Each variant rebuilds ``attention.cu``
and ``flash_attention.cu`` from a copy of ``csrc/`` with one choice undone, by
the text substitutions in ``VARIANTS``:

- ``no_pingpong``: the consumer warpgroups issue their products without
  taking turns at the named barriers;
- ``two_consumers``: two consumer warpgroups (128 query rows a block) at
  head_dim 64 too, in place of three (192 rows);
- ``row_at_a_time``: the bias pass beside two consumers loads one row before
  it stores it, in place of four.

The built library (A) and the variant (B) run every forward at the serving
shapes in turns A B B A, each the median of CUDA-event times, and must write
the same bits (the choices move no arithmetic). Run on the card:

    python -m coral_tpu_torch.tools.fwd_variants [--variant no_pingpong ...]

One JSON line per variant and kernel: A's and B's ms (two runs each), B over
A, and the card's name and power limit. Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import tempfile
from pathlib import Path

import torch

from ..ops import _build
from . import card, emit, event_ms

# name -> the (text, replacement) pairs that undo the choice in attention.cuh.
VARIANTS = {
    "no_pingpong": (
        ("auto my_turn = [&]() { hopper::named_barrier(1 + kWG + wg, 256); };",
         "auto my_turn = [&]() {};"),
        ("if (!(last && wg == kWG - 1)) hopper::named_barrier_arrive(1 + kWG + (wg + 1) % kWG, "
         "256);", "(void)last;"),
        ("if (wg == kWG - 1) hopper::named_barrier_arrive(1 + kWG, 256);", ""),
    ),
    "two_consumers": (
        ("constexpr int consumers(int D) { return D == 64 ? 3 : 2; }",
         "constexpr int consumers(int) { return 2; }"),
    ),
    "row_at_a_time": (
        ("constexpr int pass_group(int wg) { return wg == 3 ? 1 : 4; }",
         "constexpr int pass_group(int) { return 1; }"),
    ),
}
SOURCES = ("attention.cu", "flash_attention.cu")
B = 8
SERVE_T = 1499  # wav2vec2's 30 s window
WHISPER = (1500, 20, 64)  # the encoder's T, heads, head_dim
LENGTHS = (1499, 1200, 900, 600, 300, 1499, 50, 1)


def variant_source(text: str, name: str) -> str:
    """``attention.cuh``'s text with variant ``name``'s choice undone; raises
    unless each substituted text occurs exactly once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"fwd_variants: {name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build_variant(name: str, directory: Path) -> ctypes.CDLL:
    """The forward entry points built from ``csrc/`` with variant ``name``."""
    src = directory / "csrc"
    shutil.copytree(_build.CSRC, src)
    header = src / "attention.cuh"
    header.write_text(variant_source(header.read_text(), name))
    objs = [directory / f"{Path(s).stem}.o" for s in SOURCES]
    steps = [_build._run_all([[_build._nvcc(), *_build._flags(), "-c", "-o", str(o), str(src / s)]
                              for s, o in zip(SOURCES, objs)])]
    if all(p.returncode == 0 for p in steps[0]):
        steps.append(_build._run_all([[_build._nvcc(), "-shared", "-o",
                                       str(directory / "lib.so"), *map(str, objs)]]))
    for proc in (p for step in steps for p in step):
        if proc.returncode != 0:
            raise RuntimeError(f"fwd_variants: nvcc failed for {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(directory / "lib.so"))
    for fn in ("coral_attention_fwd", "coral_flash_attention_fwd"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def cases(dev):
    """(label, launch(lib) -> thunk) of every forward at the serving shapes."""
    bf16 = torch.bfloat16
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    lengths = torch.tensor(LENGTHS, device=dev)
    mask = torch.arange(SERVE_T, device=dev)[None] < lengths[:, None]
    key_bias = torch.where(mask, 0.0, -1e30).float()
    seg = torch.nn.functional.pad(mask.int(), (0, 1536 - SERVE_T))
    out = []
    for d in (64, 80, 120):
        q, k, v = (torch.randn(B, SERVE_T, 16 * d, device=dev).to(bf16) for _ in range(3))
        bias = [(torch.randn(16 * d, device=dev) * 0.1).to(bf16) for _ in range(3)]
        o = torch.empty_like(q)
        lse = torch.empty(B, 16, SERVE_T, device=dev)
        scale = float(torch.tensor(d**-0.5, dtype=bf16))
        for label, biases, stats in (("bias", bias, lse), ("nb", [None] * 3, lse),
                                     ("ns", [None] * 3, None)):
            ptrs = [None if t is None else t.data_ptr() for t in (q, k, v, *biases, key_bias, o,
                                                                   stats)]

            def launch(lib, ptrs=ptrs, q=q, d=d, scale=scale):
                return lambda: lib.coral_attention_fwd(*ptrs, B, SERVE_T, 16, d, q.stride(0),
                                                       q.stride(1), scale, 0, stream())
            out.append((f"attention_{label} d{d}", launch, o))
        o7 = torch.empty_like(q)

        def launch7(lib, q=q, k=k, v=v, o7=o7, d=d):
            return lambda: lib.coral_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o7.data_ptr(), None, None,
                seg.data_ptr(), B, SERVE_T, 1536, 16, d, q.stride(0), q.stride(1),
                float(d) ** -0.5, stream())
        out.append((f"flash_attention_seg d{d}", launch7, o7))
    T, H, d = WHISPER
    q, k, v = (torch.randn(B, T, H * d, device=dev).to(bf16) for _ in range(3))
    ow = torch.empty_like(q)

    def launch_w(lib):
        return lambda: lib.coral_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ow.data_ptr(), None, None, None, B, T, T,
            H, d, q.stride(0), q.stride(1), float(d) ** -0.5, stream())
    out.append(("flash_attention (Whisper)", launch_w, ow))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variant", action="append", choices=sorted(VARIANTS))
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    device_card = card()
    built = _build.library()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for name in args.variant or sorted(VARIANTS):
            variant = build_variant(name, Path(tmp) / name)
            for label, launch, o in cases(dev):
                outs = []
                for lib in (built, variant):
                    if launch(lib)() != 0:
                        raise RuntimeError(f"fwd_variants: {label} failed to launch")
                    torch.cuda.synchronize()
                    outs.append(o.clone())
                a1, b1, b2, a2 = (event_ms(launch(lib), args.reps)[0]
                                  for lib in (built, variant, variant, built))
                emit({"tool": "fwd_variants", "variant": name, "kernel": label, "a_ms": [a1, a2],
                      "b_ms": [b1, b2], "b_over_a": (b1 + b2) / (a1 + a2),
                      "same_bits": bool(torch.equal(*outs)), "card": device_card})


if __name__ == "__main__":
    main()
