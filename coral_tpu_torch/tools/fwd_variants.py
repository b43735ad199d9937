"""The attention forwards' design choices, measured against their alternatives.

The forward kernels (``attention_fwd_kernel``, ``attention_fwd_v1_kernel``
and ``flash_fwd_kernel``, the Hopper mainloop of ``csrc/attention.cuh``) carry
choices that a first version of the mainloop did without. Each variant
rebuilds ``attention.cu`` and ``flash_attention.cu`` from a copy of ``csrc/``
with one choice undone, by the text substitutions in ``VARIANTS``:

- ``no_pingpong``: the consumer warpgroups issue their products without
  taking turns at the named barriers;
- ``two_consumers``: two consumer warpgroups (128 query rows a block) at
  head_dim 64 too, in place of three (192 rows);
- ``row_at_a_time``: the bias pass beside two consumers loads one row before
  it stores it, in place of four;
- ``v_in_first_sweep``: v1's first sweep copies V beside K, as a producer
  shared with its second sweep would;
- ``divide``: v1's p = e / l by an IEEE divide a score (``__fdiv_rn``), in
  place of e times the row's reciprocal.

The built library (A) and the variant (B) run every forward at the serving
shapes in turns A B B A, each the median of CUDA-event times, and write the
same bits (the choices move no arithmetic; ``divide`` moves v1's rounding of
p, and ``same_bits`` says whether its o changed). v1 runs at the serving
shape and at the training batch's 8 x 499 rows. ``--against DIR`` builds B
from another ``csrc/`` directory as it is (a parent commit's checkout), to
time this tree's forwards against it in the same call. Run on the card:

    python -m coral_tpu_torch.tools.fwd_variants [--variant no_pingpong ...] [--against DIR]

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
    "v_in_first_sweep": (
        ("const bool with_v = !P::kTwoSweep || i >= n_tiles;", "const bool with_v = true;"),
    ),
    "divide": (
        ("  return e * r;\n", "  return __fdiv_rn(e, l);\n"),
    ),
}
SOURCES = ("attention.cu", "flash_attention.cu")
B = 8
SERVE_T = 1499  # wav2vec2's 30 s window
TRAIN_T = 499  # wav2vec2's 10 s training clips
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


def build_variant(name: str, directory: Path, csrc: Path | None = None) -> ctypes.CDLL:
    """The forward entry points built from ``csrc`` (default this tree's
    ``csrc/``) with variant ``name`` (as it is for a name not in
    ``VARIANTS``)."""
    src = directory / "csrc"
    shutil.copytree(csrc or _build.CSRC, src)
    if name in VARIANTS:
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
    """(label, launch(lib) -> thunk, output) of every forward at the serving
    shapes, and of v1 at the training batch's rows."""
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
        for label, biases, stats, v1 in (("bias", bias, lse, 0), ("nb", [None] * 3, lse, 0),
                                         ("ns", [None] * 3, None, 0), ("v1", [None] * 3, lse, 1)):
            ptrs = [None if t is None else t.data_ptr() for t in (q, k, v, *biases, key_bias, o,
                                                                   stats)]

            def launch(lib, ptrs=ptrs, q=q, d=d, scale=scale, v1=v1):
                return lambda: lib.coral_attention_fwd(*ptrs, B, SERVE_T, 16, d, q.stride(0),
                                                       q.stride(1), scale, v1, stream())
            out.append((f"attention_{label} d{d}", launch, o))
        o7 = torch.empty_like(q)

        def launch7(lib, q=q, k=k, v=v, o7=o7, d=d):
            return lambda: lib.coral_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o7.data_ptr(), None, None,
                seg.data_ptr(), B, SERVE_T, 1536, 16, d, q.stride(0), q.stride(1),
                float(d) ** -0.5, stream())
        out.append((f"flash_attention_seg d{d}", launch7, o7))
        # v1 at the training batch's rows.
        qt, kt, vt = (t[:, :TRAIN_T].contiguous() for t in (q, k, v))
        ot, lse_t = torch.empty_like(qt), torch.empty(B, 16, TRAIN_T, device=dev)
        train_bias = torch.where(torch.arange(TRAIN_T, device=dev)[None] < (lengths[:, None] // 3),
                                 0.0, -1e30).float()

        def launch_t(lib, args=(qt, kt, vt, None, None, None, train_bias, ot, lse_t), d=d,
                     scale=scale):
            ptrs = [None if t is None else t.data_ptr() for t in args]
            return lambda: lib.coral_attention_fwd(*ptrs, B, TRAIN_T, 16, d, args[0].stride(0),
                                                   args[0].stride(1), scale, 1, stream())
        out.append((f"attention_v1 d{d} T{TRAIN_T}", launch_t, ot))
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
    p.add_argument("--against", type=Path, help="a csrc/ directory to build B from as it is")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    names = args.variant or ([] if args.against else sorted(VARIANTS))
    if args.against:
        names.append(f"against {args.against}")
    device_card = card()
    built = _build.library()
    dev = torch.device("cuda")
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for i, name in enumerate(names):
            variant = build_variant(name, Path(tmp) / str(i),
                                    None if name in VARIANTS else args.against)
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
