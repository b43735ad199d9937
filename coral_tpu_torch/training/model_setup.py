"""Model setup: config -> tokenizer + seeded model + greedy predictor + train step.

Port of ``coral_tpu/training/model_setup.py``. ``Wav2Vec2Setup``: the
tokenizer, ``_infer_arch``, the training fields of the config (:125-293) with
the remat policy and its warnings, ``_augmentation_settings`` (:78-98),
``init_params``, ``make_predictor`` and ``make_train_step`` (:326-341), the
wav2vec2-CTC step with the feature encoder trained or frozen, the named remat
policies and the augmentation chain. Both setups resolve the kernel flags as
the JAX setups do (wav2vec2 :127-205, Whisper :495-516): ``fused_ffn`` is
``fused_ffn or fused_ffn_ln``, ``fused_ffn_ln`` defaults to ``fused_ffn``
and ``fused_ffn_block`` to true, so ``fused_ffn: false`` alone gives the
unfused FFN; the models take the FFN route those flags select
(``ffn_route``), and on the LayerNorm-folded block's route, the only one
where the JAX models read them, the block's variant flags
(``fused_ffn_block_dw``, ``_fc2``, ``_dg``: ``ffn_variant``); wav2vec2's
``attention_impl`` takes ``pallas``, ``flash`` or ``xla``; on ``pallas``
``attention_save_stats`` (default ``v3``; false, true, ``v2``) and
``attention_o_residual`` pick the attention kernels' route,
``fused_qkv_ln`` folds the pre-attention LayerNorm into the packed QKV
projection on any of them, and ``attention_fused_qkv_bias`` defaults to true
only for ``pallas`` with the v3 stats and no ``fused_qkv_ln``; false runs the
v3 attention without in-kernel biases. ``WhisperSetup`` (:440-628):
``_infer_arch``, the tokenizer, the model config from the YAML surface with
the JAX setup's kernel flags and its remat policy by width, the training
fields, ``init_params``, ``make_predictor`` (greedy or beam generation, with
or without timestamps) and
``make_train_step`` (the seq2seq step). ``init_params`` loads the published
checkpoint that ``pretrained_model_id`` names where one is on disk (a path,
or the Hugging Face cache; ``model.safetensors`` or ``pytorch_model.bin``),
as the JAX setups do (wav2vec2 :308-324, Whisper :446-470 and :552-566),
and seeds the weights otherwise; Whisper's tokenizer comes from the
``vocab.json`` beside the checkpoint. ``Wav2Vec2Setup.make_beam_predictor``
is the CTC beam search with an n-gram LM (:373-438). What is not ported
raises ``NotImplementedError`` naming its ROADMAP item rather than running
something else in silence: training on more than one device. The wav2vec2
setup also resolves ``fused_fe_conv``, ``encoder_ln_impl`` and
``do_stable_layer_norm`` (:152-153, :200-217) and reads the top-level
``remat_feature_encoder`` (:273-274); every named remat policy,
``dots_saveable`` included, runs. A setup on the card also refuses, before it
builds anything, a model width that no kernel on its path was built for
(``check_kernel_widths``, ROADMAP.md Queue 2 item 3); every config in
``config/model/`` passes on every route, ``attention_impl`` pallas, flash
and xla included (the flash kernels are built at head_dim 64, 80 and 120).

Every setup builds its model on ``device``, the card unless the caller asks
for the CPU; without a card that raises, as torch does.

Configs are plain mappings with the keys of the JAX package's config surface
(``config["model"]["pretrained_model_id"]`` and so on).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..audio.features import znorm
from ..audio.noise_bank import download_background_noises, load_noise_bank
from ..decoding import BeamSearchDecoder, NGramModel
from ..models import wav2vec2
from ..models import whisper as W
from ..models.convert import (LM_HEAD, load_torch_state_dict, wav2vec2_state_dict_from_hf,
                              whisper_state_dict_from_hf)
from ..models.wav2vec2 import (NOT_PORTED, Wav2Vec2Config, Wav2Vec2ForCTC, build_model,
                               remat_names)
from ..text.tokenizer import CtcTokenizer
from ..text.whisper_tokenizer import WhisperTokenizer

logger = logging.getLogger(__package__)

_W2V2_ARCHS: dict[str, Callable[..., Wav2Vec2Config]] = {
    "tiny": Wav2Vec2Config.tiny,
    "300m": Wav2Vec2Config.xls_r_300m,
    "1b": Wav2Vec2Config.xls_r_1b,
    "2b": Wav2Vec2Config.xls_r_2b,
}

def _find_local_checkpoint(pretrained_model_id: str | None) -> Path | None:
    """Resolve a local safetensors/pytorch checkpoint for a pretrained id:
    the file, or the index of a sharded one.

    Checks the id as a filesystem path and the HF cache layout; returns None
    when nothing is on disk.
    """
    if not pretrained_model_id:
        return None
    candidates = [Path(pretrained_model_id)]
    hf_home = Path(os.environ.get("HF_HOME", Path.home() / ".cache/huggingface"))
    repo_dir = hf_home / "hub" / f"models--{pretrained_model_id.replace('/', '--')}"
    if repo_dir.exists():
        candidates.extend(sorted((repo_dir / "snapshots").glob("*")))
    for cand in candidates:
        if cand.is_file():
            return cand
        if cand.is_dir():
            for name in ("model.safetensors", "model.safetensors.index.json",
                         "pytorch_model.bin", "pytorch_model.bin.index.json"):
                if (cand / name).exists():
                    return cand / name
    return None


def _fused_ffn_flags(model_cfg: Mapping[str, Any]) -> dict[str, bool]:
    """fused_ffn, fused_ffn_ln, fused_ffn_block and the block's variants
    (fused_ffn_block_dw, _fc2, _dg) as both JAX setups resolve them
    (coral_tpu/training/model_setup.py:159-198, :504-520)."""
    return dict(
        fused_ffn=bool(model_cfg.get("fused_ffn", True))
        or bool(model_cfg.get("fused_ffn_ln", False)),
        fused_ffn_ln=bool(model_cfg.get("fused_ffn_ln", model_cfg.get("fused_ffn", True))),
        fused_ffn_block=bool(model_cfg.get("fused_ffn_block", True)),
        fused_ffn_block_dw=bool(model_cfg.get("fused_ffn_block_dw", False)),
        fused_ffn_block_fc2=bool(model_cfg.get("fused_ffn_block_fc2", False)),
        fused_ffn_block_dg=bool(model_cfg.get("fused_ffn_block_dg", True)),
    )


def _w2v2_kernel_flags(model_cfg: Mapping[str, Any]) -> dict[str, Any]:
    """The wav2vec2 model's routes (attention_impl, the attention's stats and
    o residual, fused_qkv_ln, the q/k/v biases, the FFN's flags,
    fused_fe_conv, encoder_ln_impl and do_stable_layer_norm) as the JAX
    setup resolves them (coral_tpu/training/model_setup.py:127-217); raises
    as the JAX setup does for a LayerNorm fold (fused_ffn_ln, which defaults
    to fused_ffn, or fused_qkv_ln) with the post-LN encoder, and as the JAX
    model does (coral_tpu/models/wav2vec2.py:494-530) for in-kernel q/k/v
    biases with fused_qkv_ln, off the pallas route or with stats other than
    "v3" (``Wav2Vec2Config``)."""
    qkv_ln = bool(model_cfg.get("fused_qkv_ln", False))
    ffn = _fused_ffn_flags(model_cfg)
    stable = bool(model_cfg.get("do_stable_layer_norm", True))
    if not stable and (ffn["fused_ffn_ln"] or qkv_ln):
        raise ValueError(
            "fused_ffn_ln / fused_qkv_ln require do_stable_layer_norm "
            "(pre-LN, the XLS-R architecture); set fused_ffn_ln=false "
            "and fused_qkv_ln=false for post-LN configs.")
    impl = model_cfg.get("attention_impl", "pallas")
    stats = model_cfg.get("attention_save_stats", "v3")
    # Unset, the in-kernel biases are on where their prerequisites hold.
    qkv_bias = model_cfg.get("attention_fused_qkv_bias",
                             impl == "pallas" and stats == "v3" and not qkv_ln)
    return dict(attention_impl=impl, attention_save_stats=stats,
                attention_o_residual=bool(model_cfg.get("attention_o_residual", False)),
                fused_qkv_ln=qkv_ln, attention_fused_qkv_bias=bool(qkv_bias),
                fused_fe_conv=bool(model_cfg.get("fused_fe_conv", True)),
                encoder_ln_impl=model_cfg.get("encoder_ln_impl", "pallas"),
                do_stable_layer_norm=stable, **ffn)


def check_kernel_widths(model_config: Wav2Vec2Config | W.WhisperConfig) -> None:
    """Raise ``NotImplementedError`` for a width of ``model_config`` that a
    kernel on its path was not built for (ROADMAP.md Queue 2 item 3), so that
    a setup on the card fails before it builds a model, not at the first
    launch. Each model module lists its own routes' widths
    (``kernel_widths``); the plain versions on the CPU take every width.
    Every config of ``config/model/`` passes on every route; a width no
    config uses (head_dim 96, hidden 896) raises."""
    model_module = wav2vec2 if isinstance(model_config, Wav2Vec2Config) else W
    for what, value, takes in model_module.kernel_widths(model_config):
        if value not in takes:
            raise NotImplementedError(
                f"model {what} = {value:g}: the port's kernels take {takes}, "
                "not ported yet (ROADMAP.md, Queue 2 item 3)")


def _augmentation_settings(config: Mapping[str, Any],
                           is_main: bool) -> tuple[bool, np.ndarray | None]:
    """Resolve train-time augmentation (the reference trains with the
    augmentation chain on; ``src/coral/data.py:246-258``) and the optional
    noise bank."""
    augment = bool(config.get("augment_audio", True))
    noise_bank = None
    noise_path = config.get("background_noise_path")
    if augment and noise_path is None and config.get("download_noise", False):
        noise_path = download_background_noises(
            Path(config.get("cache_dir") or Path.home() / ".cache/coral_tpu")
        )
    if augment and noise_path:
        noise_bank = load_noise_bank(
            noise_path, sample_rate=int(config["model"]["sampling_rate"])
        )
        if noise_bank is not None and is_main:
            logger.info(f"Background-noise bank: {noise_bank.shape}")
    return augment, noise_bank


class GreedyCtcPredictor:
    """Host batch -> transcripts: z-norm, the model, greedy argmax and the CTC
    collapse of ``CtcTokenizer.decode`` (the JAX ``make_ctc_eval_step`` plus
    ``make_predictor``'s decoding)."""

    def __init__(self, model: Wav2Vec2ForCTC, tokenizer: CtcTokenizer) -> None:
        self.model = model
        self.tokenizer = tokenizer
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def logits(self, batch: Mapping[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits (B, T', V), frame_lengths (B,)) on the model's device."""
        audio = torch.as_tensor(np.asarray(batch["input_values"])).to(self.device)
        if audio.dtype == torch.int16:  # PCM16 infeed
            audio = audio.float() / 32768.0
        lengths = torch.as_tensor(np.asarray(batch["input_lengths"])).to(self.device)
        return self.model(znorm(audio.float(), lengths), lengths)

    def __call__(self, batch: Mapping[str, Any]) -> list[str]:
        logits, frame_lengths = self.logits(batch)
        pred_ids = logits.argmax(dim=-1).cpu().numpy()
        frame_lengths = frame_lengths.cpu().numpy()
        return [
            self.tokenizer.decode(pred_ids[i, : frame_lengths[i]])
            for i in range(pred_ids.shape[0])
        ]


class BeamCtcPredictor(GreedyCtcPredictor):
    """Host batch -> transcripts by CTC beam search with n-gram shallow
    fusion (the JAX ``make_beam_predictor``'s ``predict``): the model's
    forward, an fp32 log-softmax on its device, one copy of the (B, T', V)
    log-probs and the frame lengths to the host a batch, then the native
    decoder row by row. A row with no valid frame (a filler row of a partial
    batch, whose frame length is below 1) decodes no frame; the JAX predictor
    slices such a row with its negative length."""

    def __init__(self, model: Wav2Vec2ForCTC, tokenizer: CtcTokenizer,
                 decoder: BeamSearchDecoder) -> None:
        super().__init__(model, tokenizer)
        self.decoder = decoder

    @torch.inference_mode()
    def log_probs(self, batch: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
        """(log-probs (B, T', V) fp32, frame lengths (B,)) on the host."""
        logits, frame_lengths = self.logits(batch)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        return log_probs.cpu().numpy(), frame_lengths.cpu().numpy()

    def decode(self, log_probs: np.ndarray, frame_lengths: np.ndarray) -> list[str]:
        """The beam search over each row's valid frames."""
        return self.decoder.decode_batch(log_probs, np.maximum(frame_lengths, 0))

    def __call__(self, batch: Mapping[str, Any]) -> list[str]:
        return self.decode(*self.log_probs(batch))


class Wav2Vec2Setup:
    """wav2vec2-CTC family: serving and the train step."""

    def __init__(self, config: Mapping[str, Any], is_main: bool = True,
                 device: str | torch.device = "cuda") -> None:
        model_cfg = config["model"]
        flags = _w2v2_kernel_flags(model_cfg)
        self.device = torch.device(device)
        self.tokenizer = CtcTokenizer.from_characters(model_cfg["characters_to_keep"])
        use_bf16 = bool(config.get("bf16_allowed", True))
        self.model_config = self._infer_arch(model_cfg)(
            vocab_size=self.tokenizer.vocab_size,
            dtype=torch.bfloat16 if use_bf16 else torch.float32,
            hidden_dropout=model_cfg.get("hidden_dropout", 0.0),
            activation_dropout=model_cfg.get("activation_dropout", 0.1),
            attention_dropout=model_cfg.get("attention_dropout", 0.0),
            feat_proj_dropout=model_cfg.get("feat_proj_dropout", 0.0),
            final_dropout=model_cfg.get("final_dropout", 0.0),
            layerdrop=model_cfg.get("layerdrop", 0.0),
            mask_time_prob=model_cfg.get("mask_time_prob", 0.5),
            mask_time_length=model_cfg.get("mask_time_length", 10),
            mask_feature_prob=model_cfg.get("mask_feature_prob", 0.5),
            mask_feature_length=model_cfg.get("mask_feature_length", 64),
            **flags,
        )
        if self.device.type == "cuda":
            check_kernel_widths(self.model_config)
        self.config = config
        self.is_main = is_main
        self.blank_id = self.tokenizer.pad_token_id
        self.ctc_loss_reduction = model_cfg.get("ctc_loss_reduction", "sum")
        self.freeze_feature_encoder = bool(model_cfg.get("freeze_feature_encoder", False))
        self.learning_rate = float(model_cfg.get("learning_rate", 1e-4))
        self.grad_dtype = config.get("grad_dtype", "bfloat16")
        self.gradient_checkpointing = bool(config.get("gradient_checkpointing", True))
        # A top-level key, as the JAX setup reads it.
        self.remat_feature_encoder = bool(config.get("remat_feature_encoder", False))
        # As the JAX setup: model.remat_policy wins over the top-level key,
        # and the default is save_qk_ctx.
        self.remat_policy = model_cfg.get(
            "remat_policy", config.get("remat_policy", "save_qk_ctx")
        )
        # As the JAX setup, each warning on its own flag: "ffn_act" is emitted
        # only by fc1's kernels, never by the unfused FFN or the FFN block
        # (whose residuals are its inputs).
        if self.remat_policy == "save_ctx_act" and not self.model_config.fused_ffn:
            logger.warning(
                "remat_policy=save_ctx_act without fused_ffn degrades to "
                "save_attn_ctx (no 'ffn_act' checkpoint is emitted)."
            )
        if self.remat_policy == "save_ctx_act" and self.model_config.fused_ffn_block:
            logger.warning(
                "remat_policy=save_ctx_act with fused_ffn_block degrades to "
                "save_attn_ctx (the FFN block emits no 'ffn_act' checkpoint)."
            )
        if (self.remat_policy in ("save_attn_ctx", "save_ctx_act")
                and self.model_config.attention_save_stats
                and self.model_config.attention_impl == "pallas"):
            # The stats routes' backward reads their lse, which these policies
            # do not save, so the replay runs the attention forward again.
            logger.warning(
                f"remat_policy={self.remat_policy} with attention_save_stats "
                "forces an attention forward replay to rebuild the unsaved "
                "lse residual; use remat_policy=save_attn_ctx_lse (default) "
                "or nothing_saveable with the stats variants."
            )
        self.audio_pad_seconds = float(config["max_seconds_per_example"])
        # The batcher's geometry, as the JAX setup gives it (finetune.py).
        self.force_single_bucket = False
        self.max_label_length = self.tokenizer.model_max_length
        self._ckpt = _find_local_checkpoint(model_cfg.get("pretrained_model_id"))
        if self._ckpt is None and is_main and model_cfg.get("pretrained_model_id"):
            logger.warning(
                f"Pretrained checkpoint {model_cfg['pretrained_model_id']!r} not "
                "found locally; initialising from scratch."
            )

    @staticmethod
    def _infer_arch(model_cfg: Mapping[str, Any]) -> Callable[..., Wav2Vec2Config]:
        explicit = model_cfg.get("architecture")
        if explicit is not None:
            if explicit not in _W2V2_ARCHS:
                raise ValueError(f"Unknown wav2vec2 architecture {explicit!r}")
            return _W2V2_ARCHS[explicit]
        pretrained = (model_cfg.get("pretrained_model_id") or "").lower()
        for key, factory in _W2V2_ARCHS.items():
            if key in pretrained:
                return factory
        return Wav2Vec2Config.xls_r_300m

    def init_params(self, seed: int = 0, pretrained: bool = True) -> Wav2Vec2ForCTC:
        """The model on the setup's device, seeded from ``seed``, with the
        checkpoint's weights loaded where one was found (unless
        ``pretrained`` is false: a saved model's weights replace them). A
        checkpoint without ``lm_head`` (a pretraining checkpoint) keeps the
        seeded CTC head, as ``Wav2Vec2ForCTC.from_pretrained`` initialises
        it; one whose head has another row count than the tokenizer's
        vocabulary raises ``ValueError``. The parameters stay fp32."""
        model = build_model(self.model_config, self.device, seed=seed)
        model.wav2vec2.encoder.gradient_checkpointing = self.gradient_checkpointing
        model.wav2vec2.encoder.remat_policy = self.remat_policy
        model.wav2vec2.feature_extractor.remat = self.remat_feature_encoder
        if self._ckpt is not None and pretrained:
            if self.is_main:
                logger.info(f"Loading pretrained weights from {self._ckpt}")
            sd = load_torch_state_dict(self._ckpt)
            head = sd.get(LM_HEAD[0])
            if head is not None and head.shape[0] != self.tokenizer.vocab_size:
                raise ValueError(
                    f"{self._ckpt}: lm_head has {head.shape[0]} rows, but the tokenizer "
                    f"of characters_to_keep has {self.tokenizer.vocab_size} ids")
            sd = wav2vec2_state_dict_from_hf(sd, model)
            if LM_HEAD[0] not in sd:
                logger.warning(f"{self._ckpt} holds no lm_head (a pretraining checkpoint); "
                               "the CTC head keeps its seeded weights")
            # Each tensor copied once, from the file's view to the device, cast
            # to the parameter's dtype; the key sets were matched above.
            model.load_state_dict(sd, strict=False)
        return model

    def make_train_step(self, tx, schedule) -> Callable:
        """The CTC train step ``(state, batch, generator) -> (state, metrics)``
        (``training/train_state.py``), after refusing more than one device; an
        unknown remat policy raises ``ValueError``."""
        from .train_state import make_ctc_train_step

        cfg = self.config
        if self.gradient_checkpointing:
            remat_names(self.remat_policy, self.model_config)
        _refuse_devices(cfg)
        augment, noise_bank = _augmentation_settings(cfg, self.is_main)
        return make_ctc_train_step(
            tx, schedule, blank_id=self.blank_id,
            ctc_loss_reduction=self.ctc_loss_reduction,
            freeze_feature_encoder=self.freeze_feature_encoder,
            augment=augment,
            noise_bank=noise_bank,
            # bf16 gradient buffers over fp32 masters, the JAX default;
            # `grad_dtype: float32` opts out.
            grad_dtype=self.grad_dtype,
        )

    def make_predictor(self, model: Wav2Vec2ForCTC) -> GreedyCtcPredictor:
        """Greedy CTC decode: host batch -> list of transcript strings."""
        return GreedyCtcPredictor(model, self.tokenizer)

    def make_beam_predictor(self, model: Wav2Vec2ForCTC, arpa_path: str | Path,
                            alpha: float = 0.5, beta: float = 1.5,
                            beam_width: int = 100) -> BeamCtcPredictor:
        """CTC beam search with n-gram shallow fusion: the device gives
        log-probs, the native decoder (``coral_tpu_torch/decoding``) fuses
        the LM at ``arpa_path`` on the host."""
        vocab = [self.tokenizer.ids_to_tokens[i] for i in range(self.tokenizer.vocab_size)]
        decoder = BeamSearchDecoder(
            vocab, blank_id=self.blank_id,
            word_sep_id=vocab.index(self.tokenizer.word_delimiter_token),
            lm=NGramModel(arpa_path), alpha=alpha, beta=beta, beam_width=beam_width,
        )
        return BeamCtcPredictor(model, self.tokenizer, decoder)


# Ordered: the first key found in the architecture or checkpoint id wins
# (coral_tpu/training/model_setup.py _WHISPER_ARCHS).
_WHISPER_ARCHS: list[tuple[str, Callable[..., W.WhisperConfig]]] = [
    ("tiny_test", W.WhisperConfig.tiny_test),
    ("turbo", W.WhisperConfig.large_v3_turbo),
    ("large-v3", W.WhisperConfig.large_v3),
    ("large", W.WhisperConfig.large_v2),
    ("medium", W.WhisperConfig.medium),
    ("small", W.WhisperConfig.small),
    ("base", W.WhisperConfig.base),
    ("tiny", W.WhisperConfig.tiny),
]

class WhisperPredictor:
    """Host batch -> transcripts: the generate step, then
    ``WhisperTokenizer.batch_decode`` (the JAX ``make_predictor``'s
    ``predict``)."""

    def __init__(self, model: W.WhisperForConditionalGeneration, tokenizer: WhisperTokenizer,
                 generate: Callable) -> None:
        self.model = model
        self.tokenizer = tokenizer
        self.generate = generate

    def __call__(self, batch: Mapping[str, Any]) -> list[str]:
        return self.tokenizer.batch_decode(self.generate(self.model, batch).cpu().numpy())


def _refuse_devices(config: Mapping[str, Any]) -> None:
    """Raise for training on more than one device (a mesh or distributed)."""
    mesh = config.get("mesh")
    if bool(config.get("distributed", False)) or (
        mesh is not None and int(np.prod(list(mesh))) > 1
    ):
        raise NotImplementedError(
            "training on more than one device: " + NOT_PORTED.format("7")
        )


class WhisperSetup:
    """Whisper seq2seq family: serving (greedy or beam generation, with or
    without timestamps) and the train step."""

    CHUNK_SECONDS = 30  # published checkpoints expect 30 s / 3000 mel frames

    def __init__(self, config: Mapping[str, Any], is_main: bool = True,
                 device: str | torch.device = "cuda") -> None:
        model_cfg = config["model"]
        self.config = config
        self.device = torch.device(device)
        self._is_main = is_main
        arch, is_v3 = self._infer_arch(model_cfg)
        pretrained = model_cfg.get("pretrained_model_id")
        self._ckpt = _find_local_checkpoint(pretrained)
        language = model_cfg.get("language", "danish")
        task = model_cfg.get("task", "transcribe")
        if self._ckpt is not None and (self._ckpt.parent / "vocab.json").exists():
            self.tokenizer = WhisperTokenizer.from_pretrained(
                self._ckpt.parent, language=language, task=task, multilingual_v3=is_v3)
        else:
            # As the JAX setup: a checkpoint without its vocabulary is not used.
            if is_main and pretrained:
                logger.warning(
                    f"Pretrained checkpoint {pretrained!r} not found locally; using a "
                    "byte-fallback tokenizer and random init.")
            self.tokenizer = WhisperTokenizer.byte_fallback(language=language, task=task)
            self._ckpt = None
        use_bf16 = bool(config.get("bf16_allowed", True))
        self.model_config = arch(
            vocab_size=self.tokenizer.vocab_size,
            dtype=torch.bfloat16 if use_bf16 else torch.float32,
            dropout=model_cfg.get("dropout", 0.0),
            activation_dropout=model_cfg.get("activation_dropout", 0.1),
            attention_dropout=model_cfg.get("attention_dropout", 0.0),
            mask_time_prob=model_cfg.get("mask_time_prob", 0.5),
            mask_time_length=model_cfg.get("mask_time_length", 10),
            mask_feature_prob=model_cfg.get("mask_feature_prob", 0.5),
            mask_feature_length=model_cfg.get("mask_feature_length", 64),
            ln_impl=model_cfg.get("ln_impl", "xla"),
            **_fused_ffn_flags(model_cfg),
        )
        if self.device.type == "cuda":
            check_kernel_widths(self.model_config)
        # As the JAX setup: save_flash_ctx for the 1280-wide large family,
        # save_matmul_inputs below; model.remat_policy wins.
        default_policy = ("save_flash_ctx" if self.model_config.d_model >= 1280
                          else "save_matmul_inputs")
        self.model_config = dataclasses.replace(
            self.model_config, remat_policy=model_cfg.get("remat_policy", default_policy))
        self.learning_rate = float(model_cfg.get("learning_rate", 1e-5))
        self.generation_max_length = int(model_cfg.get("max_length", 225))
        self.gradient_checkpointing = bool(config.get("gradient_checkpointing", True))
        self.grad_dtype = config.get("grad_dtype", "bfloat16")
        self.audio_pad_seconds = float(model_cfg.get("chunk_seconds", self.CHUNK_SECONDS))
        self.force_single_bucket = True
        self.chunk_length = int(self.audio_pad_seconds * int(model_cfg.get("sampling_rate",
                                                                           16_000)))
        # Label padding must stay within the decoder's position table.
        self.max_label_length = min(self.tokenizer.model_max_length,
                                    self.model_config.max_target_positions)

    @staticmethod
    def _infer_arch(model_cfg: Mapping[str, Any]) -> tuple[Callable[..., W.WhisperConfig],
                                                           bool]:
        """(the architecture's factory, whether its vocabulary is large-v3's,
        with the "yue" language token)."""
        explicit = model_cfg.get("architecture")
        pretrained = (model_cfg.get("pretrained_model_id") or "").lower()
        key_source = explicit if explicit is not None else pretrained
        for key, factory in _WHISPER_ARCHS:
            if key in key_source:
                return factory, key in ("turbo", "large-v3")
        if explicit is not None:
            raise ValueError(f"Unknown whisper architecture {explicit!r}")
        return W.WhisperConfig.small, False

    def init_params(self, seed: int = 0,
                    pretrained: bool = True) -> W.WhisperForConditionalGeneration:
        """The model on the setup's device, seeded from ``seed``, with the
        checkpoint's weights loaded where one was found, unless
        ``pretrained`` is false (the parameters stay fp32)."""
        model = W.build_model(self.model_config, self.device, seed=seed)
        if self._ckpt is not None and pretrained:
            if self._is_main:
                logger.info(f"Loading pretrained weights from {self._ckpt}")
            model.load_state_dict(whisper_state_dict_from_hf(
                load_torch_state_dict(self._ckpt), model))
        return model

    def make_train_step(self, tx, schedule) -> Callable:
        """The seq2seq train step ``(state, batch, generator) -> (state,
        metrics)`` (``training/train_state.py``), after refusing what is not
        ported; an unknown remat policy raises ``ValueError``."""
        from .train_state import make_seq2seq_train_step

        if self.gradient_checkpointing:
            W.remat_names(self.model_config.remat_policy)
        _refuse_devices(self.config)
        augment, noise_bank = _augmentation_settings(self.config, self._is_main)
        return make_seq2seq_train_step(
            tx, schedule,
            sot_id=self.tokenizer.sot_token_id,
            pad_id=self.tokenizer.pad_token_id,
            gradient_checkpointing=self.gradient_checkpointing,
            augment=augment,
            noise_bank=noise_bank,
            # bf16 gradient buffers over fp32 masters, the JAX default;
            # `grad_dtype: float32` opts out.
            grad_dtype=self.grad_dtype,
        )

    def make_predictor(self, model: W.WhisperForConditionalGeneration) -> WhisperPredictor:
        """Generation: host batch -> list of transcript strings.
        ``generation_num_beams`` > 1 in the model config takes the beam search
        (with ``generation_length_penalty``; the reference's
        ``predict_with_generate`` beam surface, src/coral/whisper.py:214-230),
        1 greedy; ``return_timestamps`` the timestamp grammar, on the prompt
        without ``<|notimestamps|>``."""
        from .train_state import make_whisper_generate_step

        model_cfg = self.config["model"]
        timestamps = bool(model_cfg.get("return_timestamps", False))
        generate = make_whisper_generate_step(
            self.model_config,
            forced_ids=(self.tokenizer.forced_decoder_ids_timestamps if timestamps
                        else self.tokenizer.forced_decoder_ids),
            max_length=self.generation_max_length,
            eos_id=self.tokenizer.eos_token_id,
            num_beams=int(model_cfg.get("generation_num_beams", 1)),
            length_penalty=float(model_cfg.get("generation_length_penalty", 1.0)),
            timestamps=timestamps,
            timestamp_begin=self.tokenizer.timestamp_begin,
        )
        return WhisperPredictor(model, self.tokenizer, generate)


def load_model_setup(config: Mapping[str, Any], is_main: bool = True,
                     device: str | torch.device = "cuda") -> Wav2Vec2Setup | WhisperSetup:
    """Dispatch on ``config["model"]["type"]``."""
    model_type = config["model"]["type"]
    if model_type == "wav2vec2":
        return Wav2Vec2Setup(config, is_main=is_main, device=device)
    if model_type == "whisper":
        return WhisperSetup(config, is_main=is_main, device=device)
    raise ValueError(f"Unsupported model type: {model_type!r}")
