"""Whisper encoder-decoder in PyTorch: greedy generation and the training forward.

Port of ``coral_tpu/models/whisper.py``: ``WhisperConfig`` (every checkpoint
family and ``tiny_test``), ``REMAT_POLICIES``, ``sinusoidal_positions``,
``encode`` (with ``_spec_augment``), ``decode_train``, ``forward``,
``precompute_cross_kv``, ``init_self_cache``, ``decode_step``,
``_decode_phases``/``_pad_cache``, ``greedy_generate`` and
``segments_from_tokens``. Beam search and the timestamp rules (ROADMAP.md,
Queue 1 item 6b) are not ported.

Routes follow the JAX model at the JAX setup's serving defaults. The encoder
convs run as ``F.conv1d`` with exact erf GELU. Encoder self-attention takes
the flash kernel (``ops/flash_attention.py``) where JAX takes its flash
kernel: ``encoder_attention_impl="flash"`` and T >= 1024, no mask, not causal;
otherwise plain matmul + fp32 softmax, the math of
``jax.nn.dot_product_attention``. The encoder FFN takes the route of
``WhisperConfig.ffn_route``, as the JAX ``_ffn_full``: ``ffn_ln_block`` (the
JAX ``fused_ffn_block`` route: LayerNorm folded into fc1, the polynomial
GELU tables, fc2 outside the kernel, or the variant of ``ffn_variant``,
as the wav2vec2 model's); with ``fused_ffn_block=False`` fc1
alone, ``ffn_ln_fc1`` (the LayerNorm folded in) or, with
``fused_ffn_ln=False``, the LayerNorm then ``ffn_fc1``, and fc2 as a
product; with ``fused_ffn=False`` the JAX ``_ffn_block`` -> ``_ffn_up`` ->
``_ffn_activation`` chain: the LayerNorm, fc1, the GELU+dropout kernel
(``ops/gelu_dropout.py``) in training at activation dropout > 0, else exact
erf GELU, then fc2; the same FFN in the decoder's training forward. Encoder
LayerNorms are plain fp32 (``ln_impl="xla"``) or the ``ln_fused`` kernel
(``"pallas"``, at widths that are a multiple of 128, as JAX). The decode step's LayerNorms and FFN are
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

Training (``forward(..., deterministic=False, generator=...)``) is the JAX
model's ``deterministic=False``: SpecAugment on the mel features, the FFN's
activation dropout through ``ffn_ln_block`` (rate and Philox seeds), the
decoder's embedding dropout when ``dropout > 0``, and the encoder's flash
attention through its differentiable form (``flash_attention``: the training
forward writes o and the row stats l, m; the backward kernels read them).
With gradients off the encoder takes the serving launch, o only. The decoder's
causal self-attention and its cross-attention are plain PyTorch math under
autograd, as the JAX package runs them through XLA
(``jax.nn.dot_product_attention``), not a Pallas kernel. As in the JAX model,
``attention_dropout`` and ``layerdrop`` are never applied. All randomness is
drawn from the step's generator before the layer stacks (``draw_randomness``),
so a checkpoint replay draws nothing. ``gradient_checkpointing`` runs each
layer under ``torch.utils.checkpoint`` with the named policy's explicit save
and replay (``_Remat``, shared with ``models/wav2vec2.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops import decode_attention as _decode_attention
from ..ops import ffn as _ffn
from ..ops import flash_attention as _flash_attention
from ..ops import gelu_dropout as _gelu_dropout
from ..ops import ln_gelu as _ln_gelu
from ..ops.decode_attention import (decode_cross_attention, decode_cross_attention_plain,
                                    decode_self_attention, decode_self_attention_plain)
from ..ops.ffn import ffn_fc1, ffn_ln_block, ffn_ln_fc1
from ..ops.flash_attention import (flash_attention, flash_self_attention,
                                   flash_self_attention_plain)
from ..ops.gelu_dropout import gelu_dropout
from ..ops.ln_gelu import ln_fused
from ..ops.philox import dropout
from .wav2vec2 import (_NO_REMAT, FFNBlockVariant, _Remat, _linear, _project, _seeds,
                       _trunc_normal, span_dilate)

_LN_EPS = 1e-5
# The JAX model takes its flash kernel from this sequence length on.
_FLASH_MIN_T = 1024

# The JAX package's remat policies for the layer stacks
# (coral_tpu/models/whisper.py:44-64) by the names each saves. A layer emits
# "attn_in" and "cross_in" (the LayerNorm outputs), "q", "k", "v" and
# "cross_q" (the projections), "attn_ctx" and "cross_attn_ctx" (the attention
# outputs), "flash_o", "flash_l" and "flash_m" (the encoder flash attention's
# residuals) and "ffn_in" (the residual stream into the FFN's kernels where
# they fold the LayerNorm in; on the "ffn_fc1" and unfused routes the
# LayerNorm's output, which keeps nothing apart, as "attn_in"). The port skips
# in the replay what a kept name lets it skip: a projection, the flash forward
# (o, l and m kept together) and, where the LayerNorm is folded, the out
# projection under "ffn_in". No Whisper policy names the fc1 output, so off
# the block's route the fc1 forward runs again in every replay.
# The LayerNorms and the decoder's attention are autograd ops whose own
# residuals the replay packs again, so it recomputes them, and in the encoder
# "attn_ctx" is the kept flash o itself: those four names keep nothing apart.
REMAT_POLICIES: dict[str, tuple[str, ...]] = {
    "nothing_saveable": (),
    "save_matmul_inputs": ("attn_in", "q", "k", "v", "attn_ctx", "cross_in", "cross_q",
                           "cross_attn_ctx", "ffn_in", "flash_o", "flash_l", "flash_m"),
    "save_flash_ctx": ("attn_ctx", "cross_attn_ctx", "flash_o", "flash_l", "flash_m"),
}
_NOT_APART = frozenset({"attn_in", "cross_in", "attn_ctx", "cross_attn_ctx"})
_FLASH_RESIDUALS = (frozenset({"flash_o", "flash_l", "flash_m"}),)


def remat_names(policy: str) -> frozenset[str]:
    """The names ``policy`` keeps apart; raises for a policy it does not know."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat_policy {policy!r}; choose from {sorted(REMAT_POLICIES)}")
    return frozenset(REMAT_POLICIES[policy]) - _NOT_APART


@dataclasses.dataclass(frozen=True)
class WhisperConfig(FFNBlockVariant):
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
    # Layer-stack remat policy under gradient checkpointing (REMAT_POLICIES).
    remat_policy: str = "save_matmul_inputs"
    # The FFN (``ffn_route``): its fused kernels (True) or LayerNorm, fc1,
    # GELU (+ dropout) and fc2 apart (False); with the kernels, the whole FFN
    # as the LN-folded block (fused_ffn_block) or fc1 alone, with the
    # LayerNorm folded in (fused_ffn_ln) or apart, and fc2 a product. The
    # JAX dataclass's defaults (coral_tpu/models/whisper.py:100-113); the
    # setup passes the JAX setup's (all true but the block's dw and fc2).
    fused_ffn: bool = False
    fused_ffn_ln: bool = False
    fused_ffn_block: bool = False
    # The block's variant (``ffn_variant``).
    fused_ffn_block_dw: bool = False
    fused_ffn_block_fc2: bool = False
    fused_ffn_block_dg: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def ffn_route(self) -> str:
        """The FFN's route, as the JAX ``_ffn_full`` picks it
        (coral_tpu/models/whisper.py:345-403): "ffn_ln_block" (the block
        folds the LayerNorm in whatever fused_ffn_ln says), "ffn_ln_fc1",
        "ffn_fc1" (the LayerNorm apart) or "unfused"."""
        if not self.fused_ffn:
            return "unfused"
        if self.fused_ffn_block:
            return "ffn_ln_block"
        return "ffn_ln_fc1" if self.fused_ffn_ln else "ffn_fc1"

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
    flash_attention: Callable
    decode_self_attention: Callable
    decode_cross_attention: Callable
    ffn_ln_block: Callable
    ffn_ln_fc1: Callable
    ffn_fc1: Callable
    ln_fused: Callable
    gelu_dropout: Callable


_KERNELS = _Ops(flash_self_attention, flash_attention, decode_self_attention,
                decode_cross_attention, ffn_ln_block, ffn_ln_fc1, ffn_fc1, ln_fused,
                gelu_dropout)
_PLAIN = _Ops(flash_self_attention_plain, functools.partial(flash_attention, plain=True),
              decode_self_attention_plain, decode_cross_attention_plain,
              functools.partial(ffn_ln_block, plain=True),
              functools.partial(ffn_ln_fc1, plain=True),
              functools.partial(ffn_fc1, plain=True),
              functools.partial(ln_fused, plain=True),
              functools.partial(gelu_dropout, plain=True))


class WhisperForConditionalGeneration(nn.Module):
    """The encoder-decoder with the LM head tied to the token embedding.

    Args:
        config: the architecture.
        plain: run every kernel's plain PyTorch version instead of the kernel,
            forward and backward (the reference the kernel path is compared
            with).
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


def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = False) -> torch.Tensor:
    """``jax.nn.dot_product_attention`` on (B, T, H, d), unmasked or causal:
    fp32 scores times d**-0.5, masked scores set to its large negative
    (-0.7 times the fp32 maximum), fp32 softmax, probabilities in the working
    dtype."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = (qh.float() @ kh.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if causal:
        Tq, Tk = s.shape[-2:]
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -0.7 * torch.finfo(torch.float32).max)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return (p @ vh).transpose(1, 2)


# --------------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------------


def _kernel_layer_norm(config: WhisperConfig, width: int) -> bool:
    """Whether the encoder's LayerNorms take the ln_fused kernel: under
    ``ln_impl="pallas"`` at widths that are a multiple of 128."""
    return config.ln_impl == "pallas" and width % 128 == 0


def kernel_widths(config: WhisperConfig) -> list[tuple[str, float, tuple]]:
    """(what, its value, the values the kernel takes) for each width that a
    kernel on this model's path depends on."""
    D = config.d_model
    if config.fused_ffn:
        needs = [
            (f"d_model (the FFN kernels, {config.ffn_route}"
             + (f" {config.ffn_variant})" if config.ffn_variant else ")"), D, _ffn.KERNEL_D),
            ("ffn_dim's remainder by the FFN's F tile", config.ffn_dim % _ffn.KERNEL_F_TILE,
             (0,)),
        ]
        if config.ffn_route != "ffn_fc1":
            needs.append(("d_model (the FFN backward's LayerNorm)", D,
                          _ln_gelu.KERNEL_C_BWD[torch.bfloat16]))
    else:
        needs = [("ffn_dim's remainder by the GELU+dropout's vector",
                  config.ffn_dim % _gelu_dropout.KERNEL_F_MULTIPLE, (0,))]
    needs += [
        ("encoder head_dim (flash attention)", D / config.encoder_attention_heads,
         _flash_attention.KERNEL_HEAD_DIMS),
        ("decoder head_dim (decode attention)", D / config.decoder_attention_heads,
         (_decode_attention.KERNEL_HEAD_DIM,)),
    ]
    if _kernel_layer_norm(config, D):
        needs.append(("d_model (the encoder LayerNorm)", D, _ln_gelu.KERNEL_C[torch.bfloat16]))
        needs.append(("d_model (the LayerNorm backward)", D,
                      _ln_gelu.KERNEL_C_BWD[torch.bfloat16]))
    return needs


def _train_layer_norm(model, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``_train_layer_norm``: the ln_fused kernel where ``_kernel_layer_norm``
    says so, else plain."""
    if _kernel_layer_norm(model.config, x.shape[-1]):
        return model.ops.ln_fused(x, ln.weight, ln.bias).to(x.dtype)
    return _layer_norm(ln, x)


class Randomness(NamedTuple):
    """Everything random in one training forward, drawn before the layer stacks.

    time_starts (B, T_mel) and feature_starts (B, n_mels) are SpecAugment's
    Bernoulli span starts on the mel features (None when that mask is off);
    encoder (L_enc, B) and decoder (L_dec, B) are the int32 Philox seeds of
    each layer's FFN activation dropout (None at rate 0), embed (B,) those of
    the decoder's embedding dropout (None at ``dropout == 0``).
    """

    time_starts: torch.Tensor | None
    feature_starts: torch.Tensor | None
    encoder: torch.Tensor | None
    embed: torch.Tensor | None
    decoder: torch.Tensor | None


def draw_randomness(config: WhisperConfig, batch: int, frames: int,
                    generator: torch.Generator, device) -> Randomness:
    """Draws one training forward's SpecAugment starts and dropout seeds, in a
    fixed order, for ``batch`` items of ``frames`` mel frames."""
    def starts(n, prob, span):
        if not (config.apply_spec_augment and prob > 0):
            return None
        return torch.rand((batch, n), generator=generator, device=device) < prob / span

    def seeds(*shape, rate):
        return _seeds(generator, *shape, device=device) if rate > 0 else None

    return Randomness(
        starts(frames, config.mask_time_prob, config.mask_time_length),
        starts(config.num_mel_bins, config.mask_feature_prob, config.mask_feature_length),
        seeds(config.encoder_layers, batch, rate=config.activation_dropout),
        seeds(batch, rate=config.dropout),
        seeds(config.decoder_layers, batch, rate=config.activation_dropout),
    )


def _spec_augment(feats: torch.Tensor, rnd: Randomness, config: WhisperConfig) -> torch.Tensor:
    """``_spec_augment``: the time mask over all mel frames and the feature
    mask over the mel bins, the span starts dilated by ``span_dilate``; masked
    values are 0."""
    zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
    if rnd.time_starts is not None:
        tmask = span_dilate(rnd.time_starts, config.mask_time_length)
        feats = torch.where(tmask[..., None], zero, feats)
    if rnd.feature_starts is not None:
        fmask = span_dilate(rnd.feature_starts, config.mask_feature_length)
        feats = torch.where(fmask[:, None, :], zero, feats)
    return feats


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, D = t.shape
    return t.view(B, T, n_heads, D // n_heads)


def _projections(model, attn: WhisperAttention, h: torch.Tensor, names: str, prefix: str,
                 remat: _Remat, H: int) -> list[torch.Tensor]:
    """The (B, T, H, d) projections ``names`` (of "qkv") of h, each kept and
    skipped in a replay under the name ``prefix + n``."""
    dt = model.config.dtype
    out = []
    for n in names:
        key = prefix + n
        t = _project(h, getattr(attn, f"{n}_proj"), dt, remat, key, bias=n != "k",
                     saved=remat.saved(key))
        out.append(_heads(remat.keep(key, t), H))
    return out


def _ffn_apart(model, layer, x: torch.Tensor, seeds) -> torch.Tensor:
    """The JAX ``_ffn_block`` -> ``_ffn_up`` chain, then fc2, with the
    LayerNorm apart (coral_tpu/models/whisper.py:330-377, :402-403): the
    LayerNorm (its output the JAX "ffn_in"), then on the "ffn_fc1" route the
    fc1 kernel (its forward runs again in every replay: fc2's weight gradient
    reads g, which no Whisper policy keeps), else fc1, the GELU+dropout kernel
    for dropout in training or exact erf GELU; fc2."""
    dt = model.config.dtype
    rate = model.config.activation_dropout if seeds is not None else 0.0
    h = _train_layer_norm(model, layer.final_layer_norm, x)
    fc1 = layer.fc1
    if model.config.ffn_route == "ffn_fc1":
        h = model.ops.ffn_fc1(h, fc1.weight, fc1.bias, rate, seeds)
    else:
        h = _linear(h, fc1, dt)
        h = model.ops.gelu_dropout(h, rate, seeds) if rate > 0.0 else F.gelu(h)
    return _linear(h, layer.fc2, dt)


def _ffn_residual(model, layer, x: torch.Tensor, a_in: torch.Tensor, out_proj: nn.Linear,
                  seeds, remat: _Remat) -> torch.Tensor:
    """``x + out_proj(a_in)``, then that plus the FFN of it: the end of
    every layer. Where the FFN's kernels fold the LayerNorm in, a kept
    "ffn_in" is the replay's residual stream, which reads no output of the
    out projection (a stand-in); the block's forward never runs in the replay
    (its residuals are its inputs), the LN-folded fc1's does (fc2's weight
    gradient reads its output)."""
    dt = model.config.dtype
    route = model.config.ffn_route
    if route in ("unfused", "ffn_fc1"):
        x = x + _linear(a_in, out_proj, dt)
        out = x + _ffn_apart(model, layer, x, seeds)
        remat.replaying = remat is not _NO_REMAT
        return out
    unread = None if remat.saved("ffn_in") is None else torch.empty_like(x)
    a = _project(a_in, out_proj, dt, remat, "ffn_in", saved=unread)
    ffn_in = remat.saved("ffn_in")
    if ffn_in is None:
        ffn_in = remat.keep("ffn_in", x + a)
    fln, fc1, fc2 = layer.final_layer_norm, layer.fc1, layer.fc2
    rate = model.config.activation_dropout if seeds is not None else 0.0
    if route == "ffn_ln_block":
        ffn = model.ops.ffn_ln_block(
            ffn_in, fc1.weight, fc1.bias, fln.weight, fln.bias, fc2.weight, fc2.bias, fln.eps,
            rate, seeds, saved=torch.empty_like(ffn_in) if remat.replaying else None,
            **model.config.ffn_block_flags)
    else:
        g = model.ops.ffn_ln_fc1(ffn_in, fc1.weight, fc1.bias, fln.weight, fln.bias, fln.eps,
                                 rate, seeds)
        ffn = _linear(g, fc2, dt)
    out = ffn_in + ffn
    remat.replaying = remat is not _NO_REMAT
    return out


def _encoder_layer(model, layer: WhisperEncoderLayer, x: torch.Tensor, seeds=None,
                   remat: _Remat = _NO_REMAT) -> torch.Tensor:
    """One encoder layer; seeds: (B,) FFN dropout seeds (None: rate 0);
    remat: this layer's checkpoint record."""
    cfg, ops = model.config, model.ops
    B, T, D = x.shape
    h = _train_layer_norm(model, layer.self_attn_layer_norm, x)
    q, k, v = _projections(model, layer.self_attn, h, "qkv", "", remat,
                           cfg.encoder_attention_heads)
    if cfg.encoder_attention_impl == "flash" and T >= _FLASH_MIN_T:
        if torch.is_grad_enabled():
            saved = remat.saved("flash_o")
            o, l, m = ops.flash_attention(q, k, v, saved=None if saved is None else (
                saved, remat.saved("flash_l"), remat.saved("flash_m")))
            for name, t in (("flash_o", o), ("flash_l", l), ("flash_m", m)):
                remat.keep(name, t)
        else:
            o = ops.flash_self_attention(q, k, v)
    else:
        o = _attention_plain(q, k, v)
    return _ffn_residual(model, layer, x, o.reshape(B, T, D), layer.self_attn.out_proj, seeds,
                         remat)


def _layer_stack(layers, run, x, seeds, checkpointing: bool, policy: str, *args):
    """``run(layer, x, *args, seeds[i], remat)`` over the layers, each under
    ``torch.utils.checkpoint`` with the policy's save and replay when
    ``checkpointing`` (the JAX ``jax.checkpoint`` of the scanned layer)."""
    names = remat_names(policy) if checkpointing and torch.is_grad_enabled() else None
    for i, layer in enumerate(layers):
        s = None if seeds is None else seeds[i]
        if names is None:
            x = run(layer, x, *args, s)
        else:
            x = torch.utils.checkpoint.checkpoint(run, layer, x, *args, s,
                                                  _Remat(names, _FLASH_RESIDUALS),
                                                  use_reentrant=False)
    return x


def encode(model: WhisperForConditionalGeneration, input_features: torch.Tensor,
           deterministic: bool = True, rnd: Randomness | None = None,
           gradient_checkpointing: bool = False) -> torch.Tensor:
    """Run the audio encoder.

    Args:
        input_features: (B, T_mel, n_mels) log-mel features (T_mel = 3000 for
            30 s, as published checkpoints expect; any even T_mel runs).
        deterministic: no SpecAugment and no dropout (serving).
        rnd: the training forward's randomness (``draw_randomness``), needed
            when not deterministic.
        gradient_checkpointing: replay each layer in the backward under
            ``config.remat_policy``.

    Returns:
        (B, T_mel // 2, d_model) encoder states in ``config.dtype``.
    """
    cfg = model.config
    enc = model.model.encoder
    dt = cfg.dtype
    x = input_features
    if not deterministic:
        if rnd is None:
            raise ValueError("a training forward (deterministic=False) needs its randomness")
        x = _spec_augment(x, rnd, cfg)
    x = x.to(dt).transpose(1, 2)  # (B, n_mels, T_mel)
    x = F.gelu(F.conv1d(x, enc.conv1.weight.to(dt), enc.conv1.bias.to(dt), padding=1))
    x = F.gelu(F.conv1d(x, enc.conv2.weight.to(dt), enc.conv2.bias.to(dt), stride=2,
                        padding=1))
    x = x.transpose(1, 2).contiguous()  # (B, T, D) rows, as the kernels read them
    x = x + enc.embed_positions.weight[: x.shape[1]].to(dt)
    seeds = None if deterministic else rnd.encoder
    x = _layer_stack(enc.layers, functools.partial(_encoder_layer, model), x, seeds,
                     gradient_checkpointing, cfg.remat_policy)
    return _layer_norm(enc.layer_norm, x)


# --------------------------------------------------------------------------------
# Decoder (teacher-forced training forward)
# --------------------------------------------------------------------------------


def _decoder_layer(model, layer: WhisperDecoderLayer, x: torch.Tensor,
                   encoder_out: torch.Tensor, seeds=None,
                   remat: _Remat = _NO_REMAT) -> torch.Tensor:
    """One decoder layer of ``decode_train``: causal self-attention,
    cross-attention over ``encoder_out``, the FFN block."""
    dt = model.config.dtype
    B, L, D = x.shape
    H = model.config.decoder_attention_heads
    h = _train_layer_norm(model, layer.self_attn_layer_norm, x)
    q, k, v = _projections(model, layer.self_attn, h, "qkv", "", remat, H)
    o = _attention_plain(q, k, v, causal=True)
    x = x + _linear(o.reshape(B, L, D), layer.self_attn.out_proj, dt)
    attn = layer.encoder_attn
    h = _train_layer_norm(model, layer.encoder_attn_layer_norm, x)
    (qc,) = _projections(model, attn, h, "q", "cross_", remat, H)
    kc = _heads(_linear(encoder_out, attn.k_proj, dt, bias=False), H)
    vc = _heads(_linear(encoder_out, attn.v_proj, dt), H)
    o = _attention_plain(qc, kc, vc)
    return _ffn_residual(model, layer, x, o.reshape(B, L, D), attn.out_proj, seeds, remat)


def decode_train(model: WhisperForConditionalGeneration, encoder_out: torch.Tensor,
                 decoder_input_ids: torch.Tensor, deterministic: bool = True,
                 rnd: Randomness | None = None,
                 gradient_checkpointing: bool = False) -> torch.Tensor:
    """Teacher-forced decoder forward.

    Args:
        encoder_out: (B, S, D) encoder states.
        decoder_input_ids: (B, L) token ids (already shifted right).
        deterministic, rnd, gradient_checkpointing: as ``encode``.

    Returns:
        (B, L, vocab) fp32 logits (the tied LM head in fp32).
    """
    cfg = model.config
    dec = model.model.decoder
    dt = cfg.dtype
    if not deterministic and rnd is None:
        raise ValueError("a training forward (deterministic=False) needs its randomness")
    L = decoder_input_ids.shape[1]
    x = dec.embed_tokens.weight[decoder_input_ids].to(dt)
    x = x + dec.embed_positions.weight[:L].to(dt)
    if not deterministic and rnd.embed is not None:
        x = dropout(x, cfg.dropout, rnd.embed)
    seeds = None if deterministic else rnd.decoder
    x = _layer_stack(dec.layers, functools.partial(_decoder_layer, model), x, seeds,
                     gradient_checkpointing, cfg.remat_policy, encoder_out)
    x = _layer_norm(dec.layer_norm, x)
    return x.float() @ dec.embed_tokens.weight.float().t()


def forward(model: WhisperForConditionalGeneration, input_features: torch.Tensor,
            decoder_input_ids: torch.Tensor, deterministic: bool = True,
            generator: torch.Generator | None = None,
            gradient_checkpointing: bool = False) -> torch.Tensor:
    """Full training forward: (B, T_mel, mels) + (B, L) -> (B, L, vocab) fp32.

    Args:
        deterministic: no SpecAugment and no dropout.
        generator: the source of all randomness when not deterministic;
            everything is drawn from it here, before the model runs.
        gradient_checkpointing: as ``encode``.
    """
    rnd = None
    if not deterministic:
        if generator is None:
            raise ValueError("a training forward (deterministic=False) needs a generator")
        B, T_mel, _ = input_features.shape
        rnd = draw_randomness(model.config, B, T_mel, generator, input_features.device)
    encoder_out = encode(model, input_features, deterministic, rnd, gradient_checkpointing)
    return decode_train(model, encoder_out, decoder_input_ids, deterministic, rnd,
                        gradient_checkpointing)


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
