"""Train state, the CTC and seq2seq train steps on one device, and Whisper's generate step.

Port of ``coral_tpu/training/train_state.py`` (``_device_audio`` :28,
``TrainState`` :35, ``make_ctc_train_step`` :51-183,
``make_seq2seq_train_step`` :203-326, and ``make_whisper_generate_step``
:329-374) for one device. Per microbatch of
the CTC step: the augmentation chain (``augment=True``, ``audio/augment.py``,
with the background-noise bank when one is given), z-norm, the model in
training mode, fp32 log-softmax, the CTC loss (sum divided by the microbatch
size). Per microbatch of the seq2seq (Whisper) step: the ``% 320`` length
check, the augmentation chain or else ``peak_normalize``, the log-mel
frontend, the labels shifted right behind ``sot_id`` with -100 replaced by
``pad_id``, the model in training mode, fp32 log-softmax and the mean negative
log-likelihood over the tokens that are not -100. Both: gradients accumulate
in fp32 over the A microbatches and are divided by A; then the optimizer step,
and the metrics ``loss``, ``grad_norm`` (of the unclipped gradients) and
``learning_rate`` (``schedule(state.step)`` before the increment). The step's
augmentation draws come from its generator first, for all A microbatches,
before the model runs.

``grad_dtype="bfloat16"`` differentiates with respect to bf16 copies of the
fp32 master parameters, as the JAX step does: the model's own parameters are
those work copies, refreshed from the masters before each step, and every
gradient buffer is bf16; the masters live in ``state.params`` and the update
runs on them in fp32. With ``grad_dtype=None`` the model's parameters are the
masters themselves. Parameters without a gradient (the frozen feature
encoder) count as zeros, as the JAX ``stop_gradient`` gives them.

The step updates ``state`` in place and returns it (the JAX step returns a new
pytree; in place saves a copy of every parameter).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio.augment import apply_augmentation, draw_augmentation, peak_normalize
from ..audio.features import znorm
from ..audio.mel import log_mel_spectrogram
from ..ops.ctc import ctc_loss
from .optimizer import AdamW, AdamWState, global_norm


def _device_audio(audio: torch.Tensor) -> torch.Tensor:
    """Accept PCM16 infeed (half the host->device bytes) or float32."""
    if audio.dtype == torch.int16:
        return audio.float() / 32768.0
    return audio


@dataclasses.dataclass
class TrainState:
    """Step count, fp32 master parameters (by name), optimizer state, and the
    model whose parameters the step differentiates."""

    step: int
    params: dict[str, torch.Tensor]
    opt_state: AdamWState
    model: nn.Module

    @classmethod
    def create(cls, model: nn.Module, tx: AdamW) -> "TrainState":
        params = {n: p.detach().to(torch.float32, copy=True)
                  for n, p in model.named_parameters()}
        return cls(step=0, params=params, opt_state=tx.init(params), model=model)


def _load_work_params(model: nn.Module, masters: Mapping[str, torch.Tensor],
                      grad_dtype: torch.dtype | None) -> None:
    """Point the model's parameters at the masters, or at ``grad_dtype``
    copies of them."""
    for name, p in model.named_parameters():
        master = masters[name]
        if grad_dtype is None or master.dtype != torch.float32:
            p.data = master
        elif p.dtype == grad_dtype and p.data_ptr() != master.data_ptr():
            p.data.copy_(master)
        else:
            p.data = master.to(grad_dtype)


def _accumulate(model: nn.Module, num_micro: int, microbatch_loss: Callable[[int], torch.Tensor]):
    """Runs ``microbatch_loss(a)`` and its backward for each microbatch;
    returns (the mean loss, fp32 gradients by parameter name summed and
    divided by ``num_micro``, zeros where a parameter got none)."""
    named = dict(model.named_parameters())
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named.items()}
    loss_sum = 0.0
    for a in range(num_micro):
        for p in named.values():
            p.grad = None
        loss = microbatch_loss(a)
        loss.backward()
        loss_sum = loss_sum + loss.detach().float()
        for n, p in named.items():
            if p.grad is not None:
                grads[n] += p.grad.float()
                p.grad = None
    if num_micro > 1:
        for g in grads.values():
            g /= num_micro
    return loss_sum / num_micro, grads


def _augmentation_draws(batch: Mapping[str, torch.Tensor], generator: torch.Generator,
                        noise_bank: torch.Tensor | None) -> list:
    """Every microbatch's augmentation draws, in microbatch order."""
    num_micro, B, T = batch["input_values"].shape
    bank_shape = None if noise_bank is None else tuple(noise_bank.shape)
    return [draw_augmentation(B, T, generator, batch["input_values"].device, bank_shape)
            for _ in range(num_micro)]


def ctc_loss_and_grads(model: nn.Module, batch: Mapping[str, torch.Tensor],
                       generator: torch.Generator, blank_id: int,
                       ctc_loss_reduction: str = "sum",
                       freeze_feature_encoder: bool = False, augment: bool = False,
                       noise_bank: torch.Tensor | None = None):
    """The accumulated loss and gradients of one optimizer step.

    ``batch`` holds (A, ...) tensors on the model's device; ``noise_bank`` an
    (N, T) tensor there, or None. Returns (the mean of the A microbatch
    losses, fp32 gradients by parameter name divided by A, zeros where a
    parameter got none).
    """
    draws = _augmentation_draws(batch, generator, noise_bank) if augment else None

    def microbatch_loss(a):
        mb = {k: v[a] for k, v in batch.items()}
        audio = _device_audio(mb["input_values"])
        lengths = mb["input_lengths"]
        if augment:
            audio = apply_augmentation(audio.float(), lengths, draws[a], noise_bank)
        # On-device z-norm, then the model in training mode.
        logits, frame_lengths = model(
            znorm(audio.float(), lengths), lengths, deterministic=False,
            freeze_feature_encoder=freeze_feature_encoder, generator=generator,
        )
        log_probs = F.log_softmax(logits.float(), dim=-1)
        loss = ctc_loss(
            log_probs.transpose(0, 1), mb["labels"], frame_lengths, mb["label_lengths"],
            blank_id=blank_id, reduction=ctc_loss_reduction, zero_infinity=True,
            plain=model.plain,
        )
        if ctc_loss_reduction == "sum":
            # The JAX step's per-sample scale: the sum over the microbatch
            # divided by its size.
            loss = loss / mb["labels"].shape[0]
        return loss

    return _accumulate(model, batch["input_values"].shape[0], microbatch_loss)


def _make_step(tx: AdamW, schedule: Callable[[int], float], grad_dtype: str | None,
               noise_bank, loss_and_grads: Callable) -> Callable:
    """The step ``(state, batch, generator) -> (state, metrics)`` around
    ``loss_and_grads(model, batch, generator, bank)``: the batch and (once)
    the noise bank to the device, the work copies, the update, the metrics."""
    work_dtype = getattr(torch, grad_dtype) if grad_dtype else None
    bank = None

    def train_step(state: TrainState, batch: Mapping[str, Any], generator: torch.Generator):
        nonlocal bank
        device = next(iter(state.params.values())).device
        batch = {k: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v)).to(device)
                 for k, v in batch.items()}
        if noise_bank is not None and bank is None:
            bank = torch.as_tensor(noise_bank, dtype=torch.float32).to(device)
        _load_work_params(state.model, state.params, work_dtype)
        loss, grads = loss_and_grads(state.model, batch, generator, bank)
        metrics = {
            "loss": loss,
            "grad_norm": global_norm(list(grads.values())),
            "learning_rate": torch.tensor(schedule(state.step), dtype=torch.float32),
        }
        tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, metrics

    return train_step


def make_ctc_train_step(
    tx: AdamW,
    schedule: Callable[[int], float],
    blank_id: int,
    ctc_loss_reduction: str = "sum",
    freeze_feature_encoder: bool = False,
    augment: bool = False,
    noise_bank: np.ndarray | torch.Tensor | None = None,
    grad_dtype: str | None = None,
) -> Callable:
    """The train step ``(state, batch, generator) -> (state, metrics)``.

    ``batch`` holds ``input_values (A, B, T)`` float32 or int16 PCM,
    ``input_lengths (A, B)``, ``labels (A, B, L)`` and ``label_lengths
    (A, B)`` (numpy arrays or tensors), with A the accumulation microbatches.
    ``generator`` (a ``torch.Generator`` on the model's device) is the source
    of every augmentation draw, dropout mask and SpecAugment span of the step.
    ``noise_bank`` (N, T) goes to the device at the first step and stays.
    """
    def loss_and_grads(model, batch, generator, bank):
        return ctc_loss_and_grads(model, batch, generator, blank_id, ctc_loss_reduction,
                                  freeze_feature_encoder, augment, bank)

    return _make_step(tx, schedule, grad_dtype, noise_bank if augment else None, loss_and_grads)


def seq2seq_loss_and_grads(model: nn.Module, batch: Mapping[str, torch.Tensor],
                           generator: torch.Generator, sot_id: int, pad_id: int,
                           gradient_checkpointing: bool = False, augment: bool = False,
                           noise_bank: torch.Tensor | None = None):
    """The accumulated loss and gradients of one Whisper optimizer step, as
    ``ctc_loss_and_grads``; ``batch`` holds ``input_values (A, B, T)``,
    ``input_lengths (A, B)`` and ``labels (A, B, L)`` with -100 padding."""
    from ..models import whisper as W

    cfg = model.config
    T = batch["input_values"].shape[-1]
    # 160 = the mel hop, x2 for the encoder's stride-2 conv.
    if T % 320:
        raise ValueError(f"whisper audio length must be a multiple of 320, got {T}")
    draws = _augmentation_draws(batch, generator, noise_bank) if augment else None

    def microbatch_loss(a):
        mb = {k: v[a] for k, v in batch.items()}
        audio = _device_audio(mb["input_values"]).float()
        if augment:  # the chain peak-normalises before its gain
            audio = apply_augmentation(audio, mb["input_lengths"], draws[a], noise_bank)
        else:
            audio = peak_normalize(audio)
        feats = log_mel_spectrogram(audio, n_mels=cfg.num_mel_bins, dtype=cfg.dtype)
        labels = mb["labels"].long()
        # Shift right: decoder input t sees label t-1; -100 padding -> pad id.
        safe = torch.where(labels == -100, pad_id, labels)
        decoder_input_ids = torch.cat([torch.full_like(safe[:, :1], sot_id), safe[:, :-1]], 1)
        logits = W.forward(model, feats, decoder_input_ids, deterministic=False,
                           generator=generator, gradient_checkpointing=gradient_checkpointing)
        mask = labels != -100
        token_ll = F.log_softmax(logits.float(), dim=-1).gather(-1, safe[..., None])[..., 0]
        # Mean over the valid tokens (CrossEntropyLoss(ignore_index=-100)).
        return -(token_ll * mask).sum() / mask.sum().clamp_min(1)

    return _accumulate(model, batch["input_values"].shape[0], microbatch_loss)


def make_seq2seq_train_step(
    tx: AdamW,
    schedule: Callable[[int], float],
    sot_id: int,
    pad_id: int,
    gradient_checkpointing: bool = False,
    augment: bool = False,
    noise_bank: np.ndarray | torch.Tensor | None = None,
    grad_dtype: str | None = None,
) -> Callable:
    """The Whisper train step ``(state, batch, generator) -> (state,
    metrics)``: the on-device log-mel frontend, the encoder-decoder in
    training mode (the model config's ``remat_policy`` under
    ``gradient_checkpointing``), the cross-entropy. The batch is as
    ``seq2seq_loss_and_grads`` takes it; its T is the setup's
    ``chunk_length`` (30 s for checkpoint parity) and must be a multiple of
    320. Unlike the JAX step it takes no model config and no chunk length:
    the model carries its config, and T is the batch's."""

    def loss_and_grads(model, batch, generator, bank):
        return seq2seq_loss_and_grads(model, batch, generator, sot_id, pad_id,
                                      gradient_checkpointing, augment, bank)

    return _make_step(tx, schedule, grad_dtype, noise_bank if augment else None, loss_and_grads)


def make_whisper_generate_step(
    model_config,
    forced_ids,
    max_length: int,
    eos_id: int,
    num_beams: int = 1,
    length_penalty: float = 1.0,
    timestamps: bool = False,
    timestamp_begin: int | None = None,
) -> Callable:
    """The eval forward ``(model, batch) -> (B, max_length) ids``: generation
    from raw waveforms (peak normalisation, the log-mel frontend, then
    decoding). ``num_beams=1`` runs the greedy loop, ``num_beams > 1`` the
    beam search with ``length_penalty`` (reference surface: HF
    ``predict_with_generate`` / ``generation_max_length``,
    src/coral/whisper.py:214-230). ``timestamps`` holds either to the Whisper
    timestamp grammar from ``timestamp_begin`` (pass the prompt without
    ``<|notimestamps|>``)."""
    from ..audio.augment import peak_normalize
    from ..audio.mel import log_mel_spectrogram
    from ..models import whisper as W

    forced = [int(t) for t in np.asarray(forced_ids)]

    @torch.inference_mode()
    def generate_step(model: nn.Module, batch: Mapping[str, Any]) -> torch.Tensor:
        device = next(model.parameters()).device
        audio = torch.as_tensor(np.asarray(batch["input_values"])).to(device)
        feats = log_mel_spectrogram(peak_normalize(_device_audio(audio).float()),
                                    n_mels=model_config.num_mel_bins, dtype=model_config.dtype)
        if num_beams > 1:
            return W.beam_generate(model, feats, forced, max_length=max_length, eos_id=eos_id,
                                   num_beams=num_beams, length_penalty=length_penalty,
                                   timestamps=timestamps, timestamp_begin=timestamp_begin)
        return W.greedy_generate(model, feats, forced, max_length=max_length, eos_id=eos_id,
                                 timestamps=timestamps, timestamp_begin=timestamp_begin)

    return generate_step
