#!/usr/bin/env python3
"""The quickest proof that coral_tpu_torch runs on an NVIDIA GPU (one H100).

Run from the root of the repository:

    python3 chip_smoke.py

It drives the port's serving path, ``ASRPipeline`` with XLS-R-300M at full
width (24 layers, 30 s window, batch 8, bf16, seeded random weights), through
the hand-written CUDA kernels, in phases; any failing phase exits non-zero
before the result line is printed:

1. a CUDA card is required (no CPU fallback); the card's name and power limit
   (nvidia-smi), torch, CUDA and nvcc versions are printed;
2. the kernels are built from ``coral_tpu_torch/csrc`` and the build time is
   printed;
3. each kernel runs at the slice's own shapes in bf16 against its plain
   PyTorch version: errors against a stated tolerance, and both times (CUDA
   events, median of 10);
4. ``transcribe_batch`` on 12 clips of 3-30 s (the second device batch is
   partial, with fully masked filler rows) and ``transcribe`` on a 45 s clip
   (long-form windows), with the kernels' launch counts over that run; then
   finite logits, the kernel path's logits against the plain path's on the
   same weights and batch, audio-seconds per second, latency per batch and
   peak device memory;
5. a JSON line with every kernel, then the last line
   ``{"ok": true, "device": {...}}``.

Numbers are measured in this run and printed beside the card's name and power
limit. It imports nothing of JAX, and fails if the port did.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SR = 16_000
BATCH = 8
REPS = 10
# |kernel - plain| <= atol + rtol |plain|, elementwise, outputs in bf16. Both
# sides compute in fp32 and round once to bf16; a reordered fp32 sum may move
# that rounding by one ulp, so rtol is two bf16 ulps (2**-6). Attention rounds
# its bf16 probabilities against the running row max of the online softmax,
# the plain version against the final max; the largest error this gave at
# these inputs on an H100 was 2**-8 = 0.0039, and its atol is twice that.
TOLERANCE = {
    "ln_gelu": (1e-2, 2.0**-6),
    "ln_fused": (1e-2, 2.0**-6),
    "conv_ln_gelu": (1e-2, 2.0**-6),
    "attention": (8e-3, 2.0**-6),
    "ffn_ln": (1e-2, 2.0**-6),
}
LSE_ATOL = 1e-3  # lse is fp32 on both sides; sums in another order
# Kernel path vs plain path logits over the whole model: max |diff| / max |plain|.
# Both paths round the bf16 residual stream after each of the 24 layers at
# slightly different values, so the bound is loose; the argmax agreement over
# valid frames is reported beside it.
LOGITS_TOL = 5e-2
SOURCES = {
    "ln_gelu": ("coral_tpu_torch/csrc/ln_gelu.cu", "coral_tpu/ops/ln_gelu_pallas.py:49"),
    "ln_fused": ("coral_tpu_torch/csrc/ln_gelu.cu", "coral_tpu/ops/ln_gelu_pallas.py:49"),
    "conv_ln_gelu": ("coral_tpu_torch/csrc/conv_ln_gelu.cu",
                     "coral_tpu/ops/conv_ln_gelu_pallas.py:133"),
    "attention": ("coral_tpu_torch/csrc/attention.cu",
                  "coral_tpu/ops/attention_pallas.py:237"),
    "ffn_ln": ("coral_tpu_torch/csrc/ffn.cu", "coral_tpu/ops/ffn_pallas.py:163"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"{' '.join(cmd)} exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip()


def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` calls after two warm-ups."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    torch.cuda.synchronize()
    atol, rtol = TOLERANCE[name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= atol + rtol * want.abs()).all())
    result = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max() / want.abs().max()),
        "ok": ok,
    }
    print(f"  {name}: max_abs_err {result['max_abs_err']:.6g} max_rel_err "
          f"{result['max_rel_err']:.6g} tolerance atol {atol} + rtol {rtol:.6g}|plain|: "
          f"{'ok' if ok else 'EXCEEDED'}", flush=True)
    return result


def kernel_checks(card: str) -> dict:
    """Each kernel against its plain version at the serving slice's shapes."""
    from coral_tpu_torch.ops import attention, conv_ln_gelu, ffn, ln_gelu

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale + offset).to(dtype)

    bf16 = torch.bfloat16
    results = {}

    def measure(name, kernel, plain, check):
        res = check()
        res["ms"] = median_ms(kernel)
        res["plain_ms"] = median_ms(plain)
        print(f"  {name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms "
              f"(median of {REPS}; {card})", flush=True)
        results[name] = res

    # FE conv 0's output: (8, 95999, 512), LN + GELU.
    x = randn(BATCH, 95999, 512, scale=2.0, offset=0.3, dtype=bf16)
    g, b = randn(512, scale=0.1, offset=1.0), randn(512, scale=0.1)
    measure("ln_gelu", lambda: ln_gelu.ln_gelu(x, g, b),
            lambda: ln_gelu.ln_gelu_plain(x, g, b),
            lambda: compare("ln_gelu", ln_gelu.ln_gelu(x, g, b), ln_gelu.ln_gelu_plain(x, g, b)))

    # The pre-attention LN: (8, 1499, 1024).
    x = randn(BATCH, 1499, 1024, dtype=bf16)
    g, b = randn(1024, scale=0.1, offset=1.0), randn(1024, scale=0.1)
    measure("ln_fused", lambda: ln_gelu.ln_fused(x, g, b),
            lambda: ln_gelu.ln_gelu_plain(x, g, b, apply_gelu=False),
            lambda: compare("ln_fused", ln_gelu.ln_fused(x, g, b),
                            ln_gelu.ln_gelu_plain(x, g, b, apply_gelu=False)))

    # FE conv 1 (k=3, 95999 -> 47999 rows) timed; conv 5 (k=2) checked too.
    def conv_args(k, T_in):
        return (randn(BATCH, T_in, 512, dtype=bf16),
                randn(512, 512, k, scale=math.sqrt(2.0 / (512 * k)), dtype=bf16),
                randn(512, scale=0.1), randn(512, scale=0.1, offset=1.0),
                randn(512, scale=0.1))

    a2 = conv_args(2, 5999)
    res2 = compare("conv_ln_gelu", conv_ln_gelu.conv_ln_gelu(*a2),
                   conv_ln_gelu.conv_ln_gelu_plain(*a2))
    del a2
    a3 = conv_args(3, 95999)

    def conv_check():
        res = compare("conv_ln_gelu", conv_ln_gelu.conv_ln_gelu(*a3),
                      conv_ln_gelu.conv_ln_gelu_plain(*a3))
        res["ok"] = res["ok"] and res2["ok"]
        res["max_abs_err"] = max(res["max_abs_err"], res2["max_abs_err"])
        return res

    measure("conv_ln_gelu", lambda: conv_ln_gelu.conv_ln_gelu(*a3),
            lambda: conv_ln_gelu.conv_ln_gelu_plain(*a3), conv_check)
    del a3

    # Attention: (8, 1499, 16 x 64), padded rows and one fully masked row.
    T = 1499
    q, k, v = (randn(BATCH, T, 1024, dtype=bf16) for _ in range(3))
    bias = tuple(randn(1024, scale=0.1) for _ in range(3))
    lengths = torch.tensor([1499, 1200, 900, 600, 300, 1499, 50, -1], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]

    def attn_check():
        o, lse = attention.short_t_attention_flat(q, k, v, mask, 64, bias)
        want_o, want_lse = attention.attention_plain(q, k, v, mask, 64, bias)
        res = compare("attention", o, want_o)
        lse_err = float((lse - want_lse).abs().max())
        print(f"  attention lse: max_abs_err {lse_err:.6g} (tolerance {LSE_ATOL}); "
              f"masked row clamped: {bool((lse[-1] == -1e25).all())}", flush=True)
        res["ok"] = res["ok"] and lse_err <= LSE_ATOL and bool((lse[-1] == -1e25).all())
        return res

    measure("attention", lambda: attention.short_t_attention_flat(q, k, v, mask, 64, bias),
            lambda: attention.attention_plain(q, k, v, mask, 64, bias), attn_check)
    del q, k, v

    # FFN up-projection block: (8, 1499, 1024) -> (8, 1499, 4096).
    x = randn(BATCH, T, 1024, dtype=bf16)
    w1 = randn(4096, 1024, scale=1.0 / 32, dtype=bf16)
    b1, g, b = randn(4096, scale=0.1), randn(1024, scale=0.1, offset=1.0), randn(1024, scale=0.1)
    measure("ffn_ln", lambda: ffn.ffn_ln_fc1(x, w1, b1, g, b),
            lambda: ffn.ffn_ln_fc1_plain(x, w1, b1, g, b),
            lambda: compare("ffn_ln", ffn.ffn_ln_fc1(x, w1, b1, g, b),
                            ffn.ffn_ln_fc1_plain(x, w1, b1, g, b)))
    return results


def serving_run(card: str) -> tuple[dict, dict]:
    """The main path through ASRPipeline; returns (launch counts, metrics)."""
    from coral_tpu_torch import ASRPipeline
    from coral_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC
    from coral_tpu_torch.ops import _build
    from coral_tpu_torch.training.model_setup import GreedyCtcPredictor

    t0 = time.perf_counter()
    asr = ASRPipeline("facebook/wav2vec2-xls-r-300m", batch_size=BATCH, device="cuda")
    predictor = asr.predictor
    cfg = predictor.model.config
    print(f"model: hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, {cfg.dtype}, "
          f"window {asr.window_seconds} s, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if (cfg.hidden_size, cfg.num_hidden_layers, cfg.dtype) != (1024, 24, torch.bfloat16):
        fail("the pipeline did not build XLS-R-300M in bf16")

    rng = np.random.default_rng(0)
    seconds = np.linspace(3.0, 30.0, 12)
    clips = [(rng.standard_normal(int(s * SR)) * 0.1).astype(np.float32) for s in seconds]
    long_clip = (rng.standard_normal(45 * SR) * 0.1).astype(np.float32)
    T = int(asr.window_seconds * SR)
    step = T - 2 * (T // 6)  # ASRPipeline.transcribe's windows overlap by T // 6 a side
    n_windows = 1 + math.ceil((len(long_clip) - T) / step)
    forwards = math.ceil(len(clips) / BATCH) + math.ceil(n_windows / BATCH)

    # The main path, counted.
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    texts = asr.transcribe_batch(clips)
    long_text = asr.transcribe(long_clip)
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"main path: {forwards} forwards, launch counts {counts}", flush=True)
    per_forward = {"ln_gelu": 1, "ln_fused": 24, "conv_ln_gelu": 6, "attention": 24,
                   "ffn_ln": 24}
    for name, n in per_forward.items():
        if counts.get(name, 0) < n * forwards:
            fail(f"{name} launched {counts.get(name, 0)} times, expected >= {n * forwards}")
    if len(texts) != len(clips) or not all(isinstance(t, str) for t in texts):
        fail("transcribe_batch returned the wrong transcripts")
    if not isinstance(long_text, str):
        fail("transcribe returned no transcript for the long clip")
    print(f"transcripts: {len(texts)} clips, first {texts[0][:40]!r}; 45 s clip in "
          f"{n_windows} windows, {len(long_text)} characters", flush=True)

    # Kernel path vs plain path on the second, partial batch.
    batch_audio = np.zeros((BATCH, T), np.float32)
    lengths = np.ones((BATCH,), np.int32)
    for j, clip in enumerate(clips[BATCH:]):
        batch_audio[j, : len(clip)] = clip
        lengths[j] = len(clip)
    batch = {"input_values": batch_audio, "input_lengths": lengths}
    logits, frames = predictor.logits(batch)
    with torch.device("meta"):
        plain_model = Wav2Vec2ForCTC(cfg, plain=True)
    plain_model = plain_model.to_empty(device="cuda").eval()
    plain_model.load_state_dict(predictor.model.state_dict())
    plain = GreedyCtcPredictor(plain_model, predictor.tokenizer)
    plain_logits, plain_frames = plain.logits(batch)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()):
        fail("the kernel path's logits are not finite")
    if logits.shape != (BATCH, 1499, cfg.vocab_size) or not torch.equal(frames, plain_frames):
        fail(f"unexpected logits {tuple(logits.shape)} or frame lengths")
    diff = float((logits.float() - plain_logits.float()).abs().max()
                 / plain_logits.float().abs().max())
    agree, total = 0, 0
    for i in range(BATCH):
        n = int(frames[i])
        if n > 0:
            agree += int((logits[i, :n].argmax(-1) == plain_logits[i, :n].argmax(-1)).sum())
            total += n
    print(f"logits kernel vs plain: max|diff|/max|plain| {diff:.6g} (tolerance {LOGITS_TOL}); "
          f"argmax agreement over {total} valid frames {agree / total:.6f}; filler rows "
          f"frame lengths {frames[len(clips) - BATCH:].tolist()}", flush=True)
    if diff > LOGITS_TOL:
        fail("kernel path and plain path disagree")

    full = {"input_values": np.stack([np.resize(c, T) for c in clips[-BATCH:]]),
            "input_lengths": np.full((BATCH,), T, np.int32)}

    def timed(fn, reps):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
        return float(np.median(walls))

    latency = timed(lambda: predictor(full), 5)
    plain_latency = timed(lambda: plain(full), 3)
    del plain, plain_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wall = timed(lambda: asr.transcribe_batch(clips), 3)
    peak = torch.cuda.max_memory_allocated()
    metrics = {
        "audio_s_per_s": float(seconds.sum() / wall),
        "latency_ms_per_batch": latency * 1e3,
        "plain_latency_ms_per_batch": plain_latency * 1e3,
        "peak_memory_gib": peak / 2**30,
        "logits_max_rel_diff": diff,
        "argmax_agreement": agree / total,
    }
    print(f"serving ({card}): {metrics['audio_s_per_s']:.3f} audio-s/s over "
          f"{seconds.sum():.1f} s of audio in 12 clips (median of 3); latency "
          f"{metrics['latency_ms_per_batch']:.3f} ms per batch of {BATCH} x 30 s "
          f"(plain path {metrics['plain_latency_ms_per_batch']:.3f} ms); peak memory "
          f"{metrics['peak_memory_gib']:.3f} GiB", flush=True)
    return counts, metrics


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on an NVIDIA GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, allow_tf32 matmul/cudnn False/False", flush=True)

    from coral_tpu_torch.ops import _build

    print(run([_build._nvcc(), "--version"]).splitlines()[-1], flush=True)
    start = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - start:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)",
          flush=True)
    for path in sorted(_build.BUILD_DIR.glob("*.ptxas.txt")):
        lines = path.read_text().splitlines()
        used = [line.split(":", 1)[1].strip() for line in lines if "Used" in line]
        spills = [line.strip() for line in lines if "spill" in line and " 0 bytes spill" not in line]
        print(f"  ptxas, {len(used)} kernels: {'; '.join(used)}; spills: {spills or 'none'}",
              flush=True)

    print(f"kernel checks at slice shapes (bf16, batch {BATCH}):", flush=True)
    checks = kernel_checks(card)
    bad = [name for name, res in checks.items() if not res["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    counts, _ = serving_run(card)
    if "jax" in sys.modules:
        fail("the port imported jax")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": counts[name],
         "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"]}
        for name, res in checks.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
