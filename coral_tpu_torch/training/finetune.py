"""The fine-tuning loop: config -> trained, checkpointed model, on one device.

Port of ``coral_tpu/training/finetune.py``: ``compute_accumulation_steps``
(:45), ``finetune`` (:58-467) and ``save_model`` (:470-503), in the JAX
loop's order of work and with its logged keys. The HF Trainer's roles
(reference: ``src/coral/finetune.py:21-95``, ``src/coral/wav2vec2.py:156-250``)
are:

- the hot loop is the setup's train step (the accumulation over A
  microbatches, then AdamW on the fp32 masters, ``training/train_state.py``);
- the dataloader workers become the bucketed batcher with a prefetch thread
  that copies each batch to the device on a side stream
  (``data/batching.py``), so batch N + 1 travels while step N runs;
- checkpoint/resume, best-model selection and early stopping run on the host
  around the loop (``training/checkpoint.py``, async writes).

Where the JAX loop does what has no counterpart on one card:

- each step's draws come from a ``torch.Generator`` on the device seeded by
  a fixed function of (``seed``, step) (``step_generator``), where JAX folds
  the step into its key: a resumed run draws what the straight run drew, and
  the draws differ from JAX's by design (ROADMAP Queue 3);
- ``prng_impl`` names a JAX PRNG and is not read; ``shard_params`` and
  ``shard_optimizer_state`` shard nothing on one device, in JAX too;
- a ``mesh`` of more than one device, or ``distributed``, raises before any
  work (ROADMAP Queue 1 item 7(d));
- ``profile_step`` traces ``profile_num_steps`` steps with ``torch.profiler``
  into ``model_dir/profile`` (a Chrome trace), in place of ``jax.profiler``;
- before each eval pass the model's parameters are pointed at the current
  fp32 masters (the train step leaves the work copies of the step before the
  update in them) and the model runs in ``eval()`` mode.

With ``model.use_decoder`` rank 0 trains the n-gram decoder into the model's
directory after the final save (``decoding/ngram_pipeline.py``); a failure
there is logged as a warning and the loop still returns.

Gradient accumulation matches the reference's arithmetic: ``accumulation =
total_batch_size // (num_devices * per_device_batch_size)`` (reference:
``src/coral/wav2vec2.py:158-181``).
"""

from __future__ import annotations

import collections
import logging
import math
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..config import to_yaml
from ..data.batching import BucketBatcher, device_put_fn, prefetch_to_device
from ..data.loading import is_main_process, load_data_for_finetuning
from ..evaluation.eval_loop import run_validation
from ..tracking import load_tracking_setup
from .checkpoint import Checkpointer
from .model_setup import _refuse_devices, load_model_setup
from .optimizer import create_optimizer
from .train_state import TrainState, _load_work_params

logger = logging.getLogger(__package__)

# The saved model's parameters under its directory (``save_model``).
SAVED_PARAMS = Path("model") / "params.pt"


def compute_accumulation_steps(config: Any, num_devices: int) -> int:
    """Reference arithmetic: total batch = devices x per-device x accumulation."""
    per_device = int(config.per_device_batch_size)
    total = int(config.total_batch_size)
    accum = total // (num_devices * per_device)
    if accum < 1:
        logger.warning(
            f"total_batch_size={total} is smaller than one microbatch "
            f"({num_devices} devices x {per_device}); using accumulation=1."
        )
    return max(1, accum)


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of every draw of step ``step`` (0-based), seeded by a
    fixed function of (``seed``, ``step``)."""
    key = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key))


def finetune(config: Any, device: str | torch.device = "cuda") -> dict[str, float]:
    """Fine-tune an ASR model according to the composed config (a
    ``DictConfig`` from ``config.compose``), on ``device`` (the card unless
    the caller asks for the CPU).

    Returns:
        The final metrics (last logged train metrics + last validation scores).
    """
    _refuse_devices(config)
    device = torch.device(device)

    is_main = is_main_process()
    setup = load_model_setup(config, is_main=is_main, device=device)
    tracking = load_tracking_setup(config) if is_main else None
    if tracking is not None:
        tracking.run_initialization()

    # ---- batch geometry: one device ---------------------------------------------
    accum = compute_accumulation_steps(config, 1)
    micro_batch = int(config.per_device_batch_size)
    max_steps = int(config.max_steps)
    num_buckets = (
        int(config.get("num_length_buckets", 4))
        if config.get("padding", "longest") == "longest"
        and not setup.force_single_bucket
        else 1
    )
    sample_rate = int(config.model.sampling_rate)
    # Audio padding geometry is family-specific: CTC buckets up to the clip
    # bound; Whisper pads to the checkpoint's 30 s chunk.
    max_seconds = setup.audio_pad_seconds

    # ---- model + optimizer state ------------------------------------------------
    tx, schedule = create_optimizer(
        learning_rate=setup.learning_rate,
        warmup_steps=int(config.warmup_steps),
        max_steps=max_steps,
        adam_beta1=float(config.adam_first_momentum),
        adam_beta2=float(config.adam_second_momentum),
        max_grad_norm=float(config.max_grad_norm),
        # bf16 first moment; adam_mu_dtype=float32 opts out.
        mu_dtype=config.get("adam_mu_dtype", "bfloat16"),
    )
    seed = int(config.seed)
    state = TrainState.create(setup.init_params(seed=seed), tx)
    train_step = setup.make_train_step(tx, schedule)
    predictor = setup.make_predictor(state.model)

    # ---- data -------------------------------------------------------------------
    splits = load_data_for_finetuning(config, setup.tokenizer)
    val_names = [name for name in splits if name != "train"]
    metric_key = f"{val_names[0]}_cer" if val_names else None

    batcher = BucketBatcher(
        batch_size=micro_batch,
        accum_steps=accum,
        max_seconds=max_seconds,
        sample_rate=sample_rate,
        num_buckets=num_buckets,
        # CTC cost scales with T x L: a tighter label cap is a large win when
        # transcripts are short (config key; defaults to the family cap).
        max_label_length=int(config.get("max_label_length") or setup.max_label_length),
        # PCM16 infeed halves host->device bytes (lossless for 16-bit-sourced
        # corpora); the train step converts it on the device.
        audio_transfer_dtype=str(config.get("audio_transfer_dtype", "int16")),
    )

    def batch_stream():
        """Endless stream over epochs; each pass re-draws the interleaved order."""
        epoch = 0
        while True:
            yield from batcher(splits["train"](epoch))
            epoch += 1

    # ---- checkpointing / resume -------------------------------------------------
    model_dir = Path(config.model_dir)
    checkpointer = Checkpointer(
        model_dir / "checkpoints",
        save_total_limit=int(config.get("save_total_limit", 0)),
        metric_name=metric_key,
    )
    start_step = 0
    if config.get("resume_from_checkpoint"):
        latest = checkpointer.latest_step()
        if latest is not None:
            checkpointer.restore(state, step=latest)
            start_step = latest
            if is_main:
                logger.info(f"Resumed from checkpoint at step {latest}.")
        elif is_main:
            logger.info("resume_from_checkpoint set, but no checkpoint found.")

    # ---- loop -------------------------------------------------------------------
    eval_steps = int(config.eval_steps)
    save_steps = int(config.save_steps)
    logging_steps = int(config.logging_steps)
    early_stopping = bool(config.get("early_stopping", False))
    patience = int(config.get("early_stopping_patience", 50))
    eval_max_samples = config.get("eval_max_samples")

    stream = batch_stream()
    if start_step and not config.get("ignore_data_skip", False):
        if is_main:
            logger.info(f"Skipping {start_step} consumed batches to resume in place.")
        for _ in range(start_step):
            next(stream)
    # The background thread assembles host (numpy) batches AND issues their
    # copies to the device on its own stream, so batch N+1 travels while the
    # device runs step N; the queue bounds the batches in flight.
    put = device_put_fn(device)

    def _put(b):
        return (
            float(np.sum(b["input_lengths"])) / sample_rate,
            sum(int(v.nbytes) for v in b.values()),
            put(b),
        )

    batches = prefetch_to_device(
        stream,
        put_fn=_put,
        prefetch_size=int(config.get("prefetch_size", 2)),
    )

    best_metric = math.inf
    evals_without_improvement = 0
    history: dict[str, float] = {}
    window_start = time.perf_counter()
    window_audio_seconds = 0.0
    window_infeed_bytes = 0
    window_steps = 0
    metrics = None

    def run_validation_pass(step: int) -> None:
        nonlocal best_metric, evals_without_improvement
        # The model holds the work copies the last step differentiated (the
        # masters before its update): evaluate the masters, as JAX does.
        _load_work_params(state.model, state.params, None)
        state.model.eval()
        val_metrics: dict[str, float] = {}
        try:
            for name in val_names:
                scores = run_validation(
                    predictor,
                    splits[name],
                    batch_size=micro_batch,
                    max_seconds=max_seconds,
                    sample_rate=sample_rate,
                    bucket_lengths=batcher.bucket_lengths,
                    max_samples=eval_max_samples,
                    log_example=is_main,
                )
                val_metrics.update({f"{name}_{k}": v for k, v in scores.items()})
        finally:
            state.model.train()
        history.update(val_metrics)
        if is_main:
            logger.info(f"Step {step}: {val_metrics}")
            if tracking is not None:
                tracking.log_metrics(val_metrics, step=step)
        if metric_key and metric_key in val_metrics:
            current = val_metrics[metric_key]
            if current < best_metric:
                best_metric = current
                evals_without_improvement = 0
            else:
                evals_without_improvement += 1

    if is_main:
        logger.info(
            f"Training on {device}: {config.per_device_batch_size} per-device batch x "
            f"{accum} accumulation = {micro_batch * accum} effective batch size."
        )

    # `profile_step` traces `profile_num_steps` steps from that step into a
    # Chrome trace under model_dir/profile.
    profile_step = config.get("profile_step")
    profile_num_steps = int(config.get("profile_num_steps", 3))
    profile_dir = model_dir / "profile"
    profiler = None

    def stop_profiler() -> None:
        nonlocal profiler
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        profiler.stop()
        profile_dir.mkdir(parents=True, exist_ok=True)
        path = profile_dir / f"trace_steps_{int(profile_step)}-{step}.json"
        profiler.export_chrome_trace(str(path))
        profiler = None
        if is_main:
            logger.info(f"Wrote profiler trace to {path}")

    # Batches whose copies may still be running: their pinned host memory
    # stays referenced until their event has fired.
    in_flight: collections.deque = collections.deque()
    step = start_step
    for batch_seconds, batch_bytes, streamed in batches:
        if step >= max_steps:
            break
        if profile_step is not None and step == int(profile_step):
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        batch = streamed.wait()
        in_flight.append(streamed)
        while in_flight and in_flight[0].copied():
            in_flight.popleft()
        state, metrics = train_step(state, batch, step_generator(seed, step, device))
        step += 1
        if profiler is not None and step == int(profile_step) + profile_num_steps:
            stop_profiler()
        window_audio_seconds += batch_seconds
        window_infeed_bytes += batch_bytes
        window_steps += 1

        if step % logging_steps == 0 or step == max_steps:
            # The loss fetch is the window's sync point: wall time must be
            # taken after the step's results are on the host.
            loss_val = float(metrics["loss"])
            elapsed = time.perf_counter() - window_start
            logged = {
                "loss": loss_val,
                "grad_norm": float(metrics["grad_norm"]),
                "learning_rate": float(metrics["learning_rate"]),
                "audio_seconds_per_second": window_audio_seconds / max(elapsed, 1e-9),
                "infeed_mb_per_step": (
                    window_infeed_bytes / max(window_steps, 1) / 1e6
                ),
                "infeed_mb_per_second": window_infeed_bytes / max(elapsed, 1e-9) / 1e6,
            }
            history.update(logged)
            if is_main:
                logger.info(f"Step {step}/{max_steps}: {logged}")
                if tracking is not None:
                    tracking.log_metrics(logged, step=step)
            window_start = time.perf_counter()
            window_audio_seconds = 0.0
            window_infeed_bytes = 0
            window_steps = 0

        if step % eval_steps == 0 and val_names:
            run_validation_pass(step)
            if early_stopping and evals_without_improvement >= patience:
                if is_main:
                    logger.info(
                        f"Early stopping: no {metric_key} improvement in "
                        f"{patience} evaluations."
                    )
                break

        if step % save_steps == 0:
            checkpointer.save(
                step,
                state,
                metrics={
                    k: v for k, v in history.items() if k.startswith("val_")
                } or None,
            )
    if profiler is not None:
        stop_profiler()

    # ---- final eval + save ------------------------------------------------------
    if val_names and step % eval_steps != 0:
        run_validation_pass(step)
    if checkpointer.latest_step() != step:
        checkpointer.save(step, state, metrics={
            k: v for k, v in history.items() if k.startswith("val_")
        } or None)
    checkpointer.wait()

    # Load-best-at-end semantics (reference: load_best_model_at_end=True).
    best = checkpointer.best_step()
    if metric_key and best is not None and best != step:
        checkpointer.restore(state, step=best)
        if is_main:
            logger.info(f"Loaded best checkpoint (step {best}) for the final save.")

    save_model(config, setup, state)
    if is_main:
        logger.info(f"Saved final model to {model_dir}.")
    checkpointer.close()

    if tracking is not None:
        tracking.run_finalization()

    # The n-gram decoder (reference: src/coral/finetune.py:86-87).
    if config.model.get("use_decoder", False) and is_main:
        from ..decoding.ngram_pipeline import train_and_store_ngram_model

        try:
            train_and_store_ngram_model(config)
        except Exception as error:
            logger.warning(f"n-gram decoder training failed: {error}")

    if config.get("push_to_hub", False) and is_main:
        from ..utils.hub import push_model_to_hub

        push_model_to_hub(config)
    return history


def save_model(config: Any, setup: Any, state: Any) -> None:
    """Write the deployable model artefact: params + tokenizer + config.

    The reference saves an HF ``save_pretrained`` directory (reference:
    ``src/coral/finetune.py:84``); the port's is ``model/params.pt``
    (``torch.save`` of the fp32 masters by parameter name) beside the
    tokenizer's files and the resolved ``config.yaml``, which
    ``evaluation/evaluate.py`` ``load_saved_predictor`` serves.
    """
    if not is_main_process():
        return
    model_dir = Path(config.model_dir).resolve()
    model_dir.mkdir(parents=True, exist_ok=True)
    path = model_dir / SAVED_PARAMS
    if path.parent.exists():
        shutil.rmtree(path.parent)
    path.parent.mkdir()
    torch.save({name: p.detach().to("cpu") for name, p in state.params.items()}, path)
    setup.tokenizer.save_pretrained(model_dir)
    (model_dir / "config.yaml").write_text(to_yaml(config), encoding="utf-8")


def load_saved_params(model: torch.nn.Module, path: Path) -> None:
    """Copy the fp32 masters that ``save_model`` wrote into ``model``'s
    parameters; another set of names, or a shape that differs, raises
    ``ValueError``."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    params = dict(model.named_parameters())
    if set(saved) != set(params):
        raise ValueError(f"{path}: missing {sorted(set(params) - set(saved))[:5]}, unexpected "
                         f"{sorted(set(saved) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if saved[name].shape != p.shape:
                raise ValueError(f"{path}: {name} is {tuple(saved[name].shape)}, the model's "
                                 f"{tuple(p.shape)}")
            p.copy_(saved[name])
