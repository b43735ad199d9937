"""Whisper encoder-decoder in PyTorch: the serving half, greedy generation.

Port of ``coral_tpu/models/whisper.py``: ``WhisperConfig`` (every checkpoint
family and ``tiny_test``), ``sinusoidal_positions``, ``encode``,
``precompute_cross_kv``, ``init_self_cache``, ``decode_step``,
``_decode_phases``/``_pad_cache``, ``greedy_generate`` and
``segments_from_tokens``. Beam search and the timestamp rules (ROADMAP.md,
Queue 1 item 6b) and the training forward (item 6c) are not ported.

Routes follow the JAX model at the JAX setup's serving defaults. The encoder
convs run as ``F.conv1d`` with exact erf GELU. Encoder self-attention takes
the flash kernel (``ops/flash_attention.py``) where JAX takes its flash
kernel: ``encoder_attention_impl="flash"`` and T >= 1024, no mask, not causal;
otherwise plain matmul + fp32 softmax, the math of
``jax.nn.dot_product_attention``. The encoder FFN is ``ffn_ln_block`` (the JAX
``fused_ffn_block`` route: LayerNorm folded into fc1, the polynomial GELU
tables, fc2 outside the kernel). Encoder LayerNorms are plain fp32
(``ln_impl="xla"``) or the ``ln_fused`` kernel (``"pallas"``, at widths that
are a multiple of 128, as JAX). The decode step's LayerNorms and FFN are
plain (fp32 LayerNorm, exact erf GELU), its attention the decode kernels
(``ops/decode_attention.py``) over the stacked (L, B, T, H*d) caches, and the
LM head an fp32 product with the tied token embedding.

Parameters use PyTorch's layouts and Hugging Face's names
(``model.encoder.layers.3.self_attn.q_proj.weight`` is (out, in); ``k_proj``
has no bias), one module per layer, fp32, cast to ``config.dtype`` where they
are used, as the JAX ``_dense`` casts. ``models/convert.py`` maps the JAX
package's weights onto them. ``WhisperForConditionalGeneration(plain=True)``
builds the same model on the kernels' plain PyTorch versions, the reference
the kernel path is held against on the card.

Generation runs eagerly: a host loop over positions that updates the caches
in place (JAX carries them functionally through a ``while_loop``), with the
same prompt forcing, EOS fill of finished rows, early exit and phase buckets.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode_attention import (decode_cross_attention, decode_cross_attention_plain,
                                    decode_self_attention, decode_self_attention_plain)
from ..ops.ffn import ffn_ln_block
from ..ops.flash_attention import flash_self_attention, flash_self_attention_plain
from ..ops.ln_gelu import ln_fused
from .wav2vec2 import _trunc_normal

_LN_EPS = 1e-5
# The JAX model takes its flash kernel from this sequence length on.
_FLASH_MIN_T = 1024


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Architecture hyperparameters (defaults = whisper-tiny)."""

    vocab_size: int = 51_865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    # Dropouts and SpecAugment: the config surface of the training slice;
    # serving applies none of them.
    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.1
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.5
    mask_time_length: int = 10
    mask_feature_prob: float = 0.5
    mask_feature_length: int = 64
    dtype: torch.dtype = torch.float32  # compute dtype; bfloat16 on the card
    # Encoder self-attention: "flash" (the kernel at T >= 1024) or "xla".
    encoder_attention_impl: str = "flash"
    # Encoder LayerNorms: "xla" (plain fp32) or "pallas" (the ln_fused kernel).
    ln_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    # Checkpoint families (HF config.json values for openai/whisper-*)
    @classmethod
    def tiny(cls, **kw) -> "WhisperConfig":
        return cls(**kw)

    @classmethod
    def base(cls, **kw) -> "WhisperConfig":
        return cls(d_model=512, encoder_layers=6, decoder_layers=6,
                   encoder_attention_heads=8, decoder_attention_heads=8, ffn_dim=2048, **kw)

    @classmethod
    def small(cls, **kw) -> "WhisperConfig":
        return cls(d_model=768, encoder_layers=12, decoder_layers=12,
                   encoder_attention_heads=12, decoder_attention_heads=12, ffn_dim=3072, **kw)

    @classmethod
    def medium(cls, **kw) -> "WhisperConfig":
        return cls(d_model=1024, encoder_layers=24, decoder_layers=24,
                   encoder_attention_heads=16, decoder_attention_heads=16, ffn_dim=4096, **kw)

    @classmethod
    def large_v2(cls, **kw) -> "WhisperConfig":
        return cls(d_model=1280, encoder_layers=32, decoder_layers=32,
                   encoder_attention_heads=20, decoder_attention_heads=20, ffn_dim=5120, **kw)

    # The v3 factories take vocab_size as a parameter (the JAX ones fix it and
    # then raise on the setup's own vocab_size=...: ROADMAP.md Queue 3).
    @classmethod
    def large_v3(cls, vocab_size: int = 51_866, **kw) -> "WhisperConfig":
        return cls(vocab_size=vocab_size, num_mel_bins=128, d_model=1280, encoder_layers=32,
                   decoder_layers=32, encoder_attention_heads=20, decoder_attention_heads=20,
                   ffn_dim=5120, **kw)

    @classmethod
    def large_v3_turbo(cls, vocab_size: int = 51_866, **kw) -> "WhisperConfig":
        return cls(vocab_size=vocab_size, num_mel_bins=128, d_model=1280, encoder_layers=32,
                   decoder_layers=4, encoder_attention_heads=20, decoder_attention_heads=20,
                   ffn_dim=5120, **kw)

    @classmethod
    def tiny_test(cls, vocab_size: int = 300, **kw) -> "WhisperConfig":
        """A tiny config for tests."""
        return cls(vocab_size=vocab_size, d_model=32, encoder_layers=2, decoder_layers=2,
                   encoder_attention_heads=2, decoder_attention_heads=2, ffn_dim=64,
                   max_target_positions=64, **kw)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Whisper's sinusoid table: [sin | cos] concatenated along features."""
    log_timescale = np.log(10_000.0) / (dim // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# --------------------------------------------------------------------------------
# Modules (Hugging Face names)
# --------------------------------------------------------------------------------


class WhisperAttention(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class WhisperEncoderLayer(nn.Module):
    def __init__(self, config: WhisperConfig) -> None:
        super().__init__()
        d = config.d_model
        self.self_attn = WhisperAttention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=_LN_EPS)
        self.fc1 = nn.Linear(d, config.ffn_dim)
        self.fc2 = nn.Linear(config.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=_LN_EPS)


class WhisperDecoderLayer(WhisperEncoderLayer):
    def __init__(self, config: WhisperConfig) -> None:
        super().__init__(config)
        self.encoder_attn = WhisperAttention(config.d_model)
        self.encoder_attn_layer_norm = nn.LayerNorm(config.d_model, eps=_LN_EPS)


class WhisperEncoder(nn.Module):
    def __init__(self, config: WhisperConfig) -> None:
        super().__init__()
        d = config.d_model
        self.conv1 = nn.Conv1d(config.num_mel_bins, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(config.max_source_positions, d)
        self.layers = nn.ModuleList(
            WhisperEncoderLayer(config) for _ in range(config.encoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=_LN_EPS)


class WhisperDecoder(nn.Module):
    def __init__(self, config: WhisperConfig) -> None:
        super().__init__()
        d = config.d_model
        self.embed_tokens = nn.Embedding(config.vocab_size, d)
        self.embed_positions = nn.Embedding(config.max_target_positions, d)
        self.layers = nn.ModuleList(
            WhisperDecoderLayer(config) for _ in range(config.decoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=_LN_EPS)


class WhisperModel(nn.Module):
    def __init__(self, config: WhisperConfig) -> None:
        super().__init__()
        self.encoder = WhisperEncoder(config)
        self.decoder = WhisperDecoder(config)


class _Ops(NamedTuple):
    """The kernel entry points the model calls, or their plain versions."""

    flash_self_attention: Callable
    decode_self_attention: Callable
    decode_cross_attention: Callable
    ffn_ln_block: Callable
    ln_fused: Callable


_KERNELS = _Ops(flash_self_attention, decode_self_attention, decode_cross_attention,
                ffn_ln_block, ln_fused)
_PLAIN = _Ops(flash_self_attention_plain, decode_self_attention_plain,
              decode_cross_attention_plain, functools.partial(ffn_ln_block, plain=True),
              functools.partial(ln_fused, plain=True))


class WhisperForConditionalGeneration(nn.Module):
    """The encoder-decoder with the LM head tied to the token embedding.

    Args:
        config: the architecture.
        plain: run every kernel's plain PyTorch version instead of the kernel
            (the reference the kernel path is compared with).
    """

    def __init__(self, config: WhisperConfig, plain: bool = False) -> None:
        super().__init__()
        self.config = config
        self.plain = plain
        self.ops = _PLAIN if plain else _KERNELS
        self.model = WhisperModel(config)


@torch.no_grad()
def init_weights(model: WhisperForConditionalGeneration, generator: torch.Generator) -> None:
    """Random init with ``init_whisper_params``' distributions: lecun-normal
    dense and conv kernels, zero biases, unit LayerNorm scales, token and
    decoder position embeddings N(0, 0.02), the sinusoid table for the
    encoder positions."""
    cfg = model.config
    for module in model.modules():
        if isinstance(module, nn.Conv1d):
            w = module.weight
            _trunc_normal(w, w.shape[1] * w.shape[2], 1.0, generator)
        elif isinstance(module, nn.Linear):
            _trunc_normal(module.weight, module.in_features, 1.0, generator)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
        else:
            continue
        if module.bias is not None:
            module.bias.zero_()
    enc, dec = model.model.encoder, model.model.decoder
    enc.embed_positions.weight.copy_(torch.from_numpy(
        sinusoidal_positions(cfg.max_source_positions, cfg.d_model)))
    for emb in (dec.embed_tokens, dec.embed_positions):
        emb.weight.normal_(0.0, 0.02, generator=generator)


def build_model(config: WhisperConfig, device: Any, seed: int = 0,
                plain: bool = False) -> WhisperForConditionalGeneration:
    """A seeded, randomly initialised model on ``device`` in eval mode (the
    weights are drawn on the device itself from ``torch.Generator``)."""
    with torch.device("meta"):
        model = WhisperForConditionalGeneration(config, plain=plain)
    model = model.to_empty(device=device)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()


# --------------------------------------------------------------------------------
# Primitive ops
# --------------------------------------------------------------------------------


def _linears(module: nn.Module, dtype: torch.dtype) -> dict[str, tuple]:
    """Every ``nn.Linear`` under ``module`` as (weight, bias) in ``dtype``
    (the same tensors in their own dtype), by its dotted name."""
    return {name: (m.weight.to(dtype), None if m.bias is None else m.bias.to(dtype))
            for name, m in module.named_modules() if isinstance(m, nn.Linear)}


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32, output in x.dtype (``_layer_norm``)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps).to(x.dtype)


def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.dot_product_attention`` on (B, T, H, d) without a mask: fp32
    scores times d**-0.5, fp32 softmax, probabilities in the working dtype."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = (qh.float() @ kh.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p @ vh).transpose(1, 2)


# --------------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------------


def _encoder_layer_norm(model, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``_train_layer_norm``: the ln_fused kernel under ``ln_impl="pallas"`` at
    widths that are a multiple of 128, else plain."""
    if model.config.ln_impl == "pallas" and x.shape[-1] % 128 == 0:
        return model.ops.ln_fused(x, ln.weight.float(), ln.bias.float()).to(x.dtype)
    return _layer_norm(ln, x)


def encode(model: WhisperForConditionalGeneration, input_features: torch.Tensor) -> torch.Tensor:
    """Run the audio encoder.

    Args:
        input_features: (B, T_mel, n_mels) log-mel features (T_mel = 3000 for
            30 s, as published checkpoints expect; any even T_mel runs).

    Returns:
        (B, T_mel // 2, d_model) encoder states in ``config.dtype``.
    """
    cfg, ops = model.config, model.ops
    enc = model.model.encoder
    dt = cfg.dtype
    x = input_features.to(dt).transpose(1, 2)  # (B, n_mels, T_mel)
    x = F.gelu(F.conv1d(x, enc.conv1.weight.to(dt), enc.conv1.bias.to(dt), padding=1))
    x = F.gelu(F.conv1d(x, enc.conv2.weight.to(dt), enc.conv2.bias.to(dt), stride=2,
                        padding=1))
    x = x.transpose(1, 2).contiguous()  # (B, T, D) rows, as the kernels read them
    B, T, D = x.shape
    x = x + enc.embed_positions.weight[:T].to(dt)

    H = cfg.encoder_attention_heads
    flash = cfg.encoder_attention_impl == "flash" and T >= _FLASH_MIN_T
    for layer in enc.layers:
        w = _linears(layer, dt)
        h = _encoder_layer_norm(model, layer.self_attn_layer_norm, x)
        q, k, v = (F.linear(h, *w[f"self_attn.{n}_proj"]).view(B, T, H, D // H)
                   for n in ("q", "k", "v"))
        o = (ops.flash_self_attention if flash else _attention_plain)(q, k, v)
        x = x + F.linear(o.reshape(B, T, D), *w["self_attn.out_proj"])
        fln = layer.final_layer_norm
        x = x + ops.ffn_ln_block(x, layer.fc1.weight, layer.fc1.bias, fln.weight, fln.bias,
                                 layer.fc2.weight, layer.fc2.bias, fln.eps)
    return _layer_norm(enc.layer_norm, x)


# --------------------------------------------------------------------------------
# Generation
# --------------------------------------------------------------------------------


def precompute_cross_kv(model: WhisperForConditionalGeneration,
                        encoder_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V for every decoder layer: (L, B, S, H*d) each, heads
    flat on the last axis, in ``config.dtype``."""
    dt = model.config.dtype
    layers = model.model.decoder.layers
    B, S, HD = encoder_out.shape
    k = torch.empty((len(layers), B, S, HD), dtype=dt, device=encoder_out.device)
    v = torch.empty_like(k)
    for i, layer in enumerate(layers):
        attn = layer.encoder_attn
        k[i] = F.linear(encoder_out.to(dt), attn.k_proj.weight.to(dt))
        v[i] = F.linear(encoder_out.to(dt), attn.v_proj.weight.to(dt), attn.v_proj.bias.to(dt))
    return k, v


def init_self_cache(config: WhisperConfig, batch: int, max_len: int,
                    device: Any) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed self-attention KV cache: (L, B, max_len, H*d) x 2."""
    shape = (config.decoder_layers, batch, max_len,
             config.decoder_attention_heads * config.head_dim)
    return (torch.zeros(shape, dtype=config.dtype, device=device),
            torch.zeros(shape, dtype=config.dtype, device=device))


def decoder_linears(model: WhisperForConditionalGeneration) -> list[dict[str, tuple]]:
    """Each decoder layer's products in ``config.dtype``, cast once for a whole
    generation instead of at every step."""
    return [_linears(layer, model.config.dtype) for layer in model.model.decoder.layers]


def decode_step(
    model: WhisperForConditionalGeneration,
    tokens: torch.Tensor,
    pos: int,
    self_cache: tuple[torch.Tensor, torch.Tensor],
    cross_kv: tuple[torch.Tensor, torch.Tensor],
    onehot: torch.Tensor | None = None,
    linears: Sequence[dict[str, tuple]] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One decode position for the whole batch (all beams, when beamed).

    Args:
        tokens: (B*K,) current input token ids (K = 1 for greedy).
        pos: the position.
        self_cache: (L, B*K, T, H*d) keys and values (filled to ``pos``); row
            ``pos`` of every layer is written in place.
        cross_kv: (L, B, S, H*d) from ``precompute_cross_kv``, shared by the K
            beams of an item.
        onehot: optional (B, K, K*T) slot mask for beam search; None builds
            the causal mask of greedy decoding.
        linears: ``decoder_linears(model)``, computed here when not given.

    Returns:
        ((B*K, vocab) fp32 logits for the next token, the updated cache).
    """
    cfg, ops = model.config, model.ops
    dec = model.model.decoder
    dt = cfg.dtype
    H = cfg.decoder_attention_heads
    cache_k, cache_v = self_cache
    cross_k, cross_v = cross_kv
    _, BK, T, _ = cache_k.shape
    if linears is None:
        linears = decoder_linears(model)
    if onehot is None:
        causal = torch.arange(T, device=tokens.device) <= pos
        onehot = causal.float()[None, None, :].expand(BK, 1, T).contiguous()

    x = dec.embed_tokens.weight[tokens].to(dt)[:, None, :]  # (B*K, 1, D)
    x = x + dec.embed_positions.weight[pos].to(dt)
    for i, (layer, w) in enumerate(zip(dec.layers, linears)):
        h = _layer_norm(layer.self_attn_layer_norm, x)
        q = F.linear(h[:, 0], *w["self_attn.q_proj"])
        cache_k[i, :, pos] = F.linear(h[:, 0], *w["self_attn.k_proj"])
        cache_v[i, :, pos] = F.linear(h[:, 0], *w["self_attn.v_proj"])
        attn = ops.decode_self_attention(q, cache_k, cache_v, onehot, H, i)
        x = x + F.linear(attn, *w["self_attn.out_proj"])[:, None, :]

        h = _layer_norm(layer.encoder_attn_layer_norm, x)
        qc = F.linear(h[:, 0], *w["encoder_attn.q_proj"])
        a = ops.decode_cross_attention(qc, cross_k, cross_v, H, i)
        x = x + F.linear(a, *w["encoder_attn.out_proj"])[:, None, :]

        h = _layer_norm(layer.final_layer_norm, x)
        h = F.gelu(F.linear(h, *w["fc1"]))
        x = x + F.linear(h, *w["fc2"])
    x = _layer_norm(dec.layer_norm, x)
    logits = x[:, 0, :].float() @ dec.embed_tokens.weight.float().t()
    return logits, (cache_k, cache_v)


def _decode_phases(max_length: int) -> list[int]:
    """Cache-length buckets of the phased decode loop: [64, 128, ...,
    max_length]. The decode kernels read the whole cache every step, so the
    cache grows by phases instead of being allocated at ``max_length``."""
    if max_length <= 64:
        return [max_length]
    phases, t = [], 64
    while t < max_length:
        phases.append(t)
        t *= 2
    phases.append(max_length)
    return phases


def _pad_cache(cache: tuple[torch.Tensor, torch.Tensor], new_len: int):
    k, v = cache
    extra = new_len - k.shape[2]
    if extra == 0:
        return cache
    return F.pad(k, (0, 0, 0, extra)), F.pad(v, (0, 0, 0, extra))


@torch.inference_mode()
def greedy_generate(
    model: WhisperForConditionalGeneration,
    input_features: torch.Tensor,
    forced_ids: Sequence[int],
    max_length: int,
    eos_id: int,
) -> torch.Tensor:
    """Greedy decoding.

    Args:
        input_features: (B, T_mel, mels).
        forced_ids: the decoder prompt, ``[sot, lang, task, notimestamps]``,
            teacher-forced before free decoding starts.
        max_length: total output length including the prompt.
        eos_id: end-of-text id; finished rows keep emitting it.

    Returns:
        (B, max_length) int32 ids, prompt included, EOS-padded, on the
        features' device.
    """
    cfg = model.config
    dev = input_features.device
    B = input_features.shape[0]
    forced = [int(t) for t in forced_ids]
    n_forced = len(forced)
    encoder_out = encode(model, input_features)
    cross_kv = precompute_cross_kv(model, encoder_out)
    del encoder_out
    linears = decoder_linears(model)
    phases = _decode_phases(max_length)
    cache = init_self_cache(cfg, B, phases[0], dev)

    tokens = torch.full((B,), forced[0], dtype=torch.int64, device=dev)
    # Output buffer pre-filled with EOS; positions past an early exit stay EOS.
    buffer = torch.full((B, max_length), eos_id, dtype=torch.int32, device=dev)
    buffer[:, 0] = tokens
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    pos = 0
    for t_b in phases:
        cache = _pad_cache(cache, t_b)
        # Early exit once every row emitted EOS; t_b bounds this phase's cache.
        while pos < min(t_b, max_length - 1) and not bool(finished.all()):
            logits, cache = decode_step(model, tokens, pos, cache, cross_kv, linears=linears)
            if pos + 1 < n_forced:  # inside the prompt the next id is forced
                next_token = torch.full_like(tokens, forced[pos + 1])
            else:
                next_token = logits.argmax(dim=-1)
            next_token = torch.where(finished, eos_id, next_token)
            finished |= next_token == eos_id
            buffer[:, pos + 1] = next_token.to(torch.int32)
            tokens = next_token
            pos += 1
    return buffer


def segments_from_tokens(
    ids, timestamp_begin: int, eos_id: int, time_precision: float = 0.02
) -> list[tuple[float, float, list[int]]]:
    """Split a generated id sequence into timed segments.

    Args:
        ids: iterable of token ids (one utterance, prompt may be included).
        timestamp_begin: id of ``<|0.00|>``.
        eos_id: generation stops here.
        time_precision: seconds per timestamp step (Whisper: 0.02).

    Returns:
        List of (start_seconds, end_seconds, text_token_ids) tuples.
    """
    segments = []
    start = None
    current: list[int] = []
    for raw in ids:
        t = int(raw)
        if t == eos_id:
            break
        if t >= timestamp_begin:
            seconds = (t - timestamp_begin) * time_precision
            if start is None:
                start = seconds
            elif current:
                segments.append((start, seconds, current))
                current = []
                start = None
            else:
                start = seconds  # consecutive timestamps: new segment start
        elif start is not None:
            current.append(t)
    if current and start is not None:
        segments.append((start, start, current))
    return segments
