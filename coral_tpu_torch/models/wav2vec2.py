"""wav2vec2 encoder + CTC head in PyTorch, eval mode (serving).

Port of ``coral_tpu/models/wav2vec2.py`` with the JAX package's production
defaults (``coral_tpu/training/model_setup.py``): pre-LN encoder layers, the
fused feature-encoder conv blocks, the ``ln_fused`` pre-attention LayerNorm,
the v3-stats attention with in-kernel q/k/v biases and the LN-folded FFN block.
There is no SpecAugment, dropout or layerdrop: those belong to training.

Parameters use PyTorch's layouts and Hugging Face's names
(``wav2vec2.encoder.layers.3.attention.q_proj.weight`` is (out, in)), one
module per layer instead of the flax scan's stacked (L, ...) arrays; they stay
fp32 and are cast to ``config.dtype`` where they are used, as the flax modules
do. ``models/convert.py`` maps the JAX package's weights onto them.

Routes follow the JAX model: a conv block takes the fused kernel only for
stride 2, k in {2, 3}, C_in == C_out and C % 128 == 0 (else the conv as one
product + ``ln_gelu``), so CPU parity at small widths covers the same routes.
The FFN always calls ``ffn_ln_block``: on the CPU that is its plain version at
any width, and on the card the kernel, which raises for widths it does not
take. ``Wav2Vec2ForCTC(plain=True)`` builds the same model on the kernels'
plain PyTorch versions: the reference that the kernel path is held against on
the card.

The positional conv, FE conv 0 and the q/k/v/out/fc2/lm_head products run
outside any Pallas kernel in the JAX package and are library calls here. The
positional conv is the plain grouped ``F.conv1d`` (the JAX ``pos_conv_fold``
is a TPU layout of the same math) with exact erf GELU, unlike the kernels'
polynomial GELU.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_plain, short_t_attention_flat
from ..ops.conv_ln_gelu import conv_ln_gelu, conv_ln_gelu_plain
from ..ops.ffn import ffn_ln_block, ffn_ln_block_plain
from ..ops.ln_gelu import ln_fused, ln_gelu, ln_gelu_plain

# Message tail of every NotImplementedError for what the port does not cover.
NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1 item {})"


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture hyperparameters (defaults = XLS-R 300m)."""

    vocab_size: int = 46
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple[int, ...] = (512,) * 7
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = True
    feat_extract_norm: str = "layer"
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32  # compute dtype; bfloat16 when serving

    def __post_init__(self) -> None:
        if self.feat_extract_norm != "layer":
            raise NotImplementedError(
                f"feat_extract_norm={self.feat_extract_norm!r}: "
                + NOT_PORTED.format("8 (wav2vec2 base models)")
            )
        if not self.do_stable_layer_norm:
            raise NotImplementedError(
                "post-LN encoder layers (do_stable_layer_norm=False): "
                + NOT_PORTED.format("8 (wav2vec2 base models)")
            )

    @classmethod
    def xls_r_300m(cls, vocab_size: int = 46, **kw) -> "Wav2Vec2Config":
        return cls(vocab_size=vocab_size, **kw)

    @classmethod
    def xls_r_1b(cls, vocab_size: int = 46, **kw) -> "Wav2Vec2Config":
        return cls(
            vocab_size=vocab_size, hidden_size=1280, num_hidden_layers=48,
            num_attention_heads=16, intermediate_size=5120, **kw,
        )

    @classmethod
    def xls_r_2b(cls, vocab_size: int = 46, **kw) -> "Wav2Vec2Config":
        return cls(
            vocab_size=vocab_size, hidden_size=1920, num_hidden_layers=48,
            num_attention_heads=16, intermediate_size=7680, **kw,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 46, **kw) -> "Wav2Vec2Config":
        """The JAX package's tiny test config (production 320x downsampling)."""
        return cls(
            vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            conv_dim=(16, 16, 16, 16), conv_stride=(5, 4, 4, 4),
            conv_kernel=(10, 3, 3, 3),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2, **kw,
        )

    def feat_extract_output_lengths(self, input_lengths):
        """Raw-audio lengths -> feature-frame lengths through the conv stack
        (floor division: a length-1 filler row maps below zero, as in JAX)."""
        lengths = input_lengths
        for kernel, stride in zip(self.conv_kernel, self.conv_stride):
            lengths = (lengths - kernel) // stride + 1
        return lengths


class _Ops(NamedTuple):
    """The kernel entry points the model calls, or their plain versions."""

    ln_gelu: Callable
    ln_fused: Callable
    conv_ln_gelu: Callable
    attention: Callable
    ffn_ln_block: Callable


_KERNELS = _Ops(ln_gelu, ln_fused, conv_ln_gelu, short_t_attention_flat, ffn_ln_block)
_PLAIN = _Ops(
    functools.partial(ln_gelu_plain, apply_gelu=True),
    functools.partial(ln_gelu_plain, apply_gelu=False),
    conv_ln_gelu_plain,
    attention_plain,
    ffn_ln_block_plain,
)


def _linear(x, layer: nn.Linear, dtype, bias: bool = True):
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype) if bias else None)


def _conv1d(x, weight, bias, stride: int, dtype):
    """Strided conv on (B, T, C_in) as one product over the unfolded windows;
    the output comes out in (B, T', C_out) without a layout copy."""
    C_out, C_in, K = weight.shape
    patches = x.to(dtype).unfold(1, K, stride)  # (B, T', C_in, K)
    out = patches.reshape(*patches.shape[:2], C_in * K) @ weight.to(dtype).reshape(
        C_out, C_in * K
    ).t()
    if bias is not None:
        out = out + bias.to(dtype)
    return out


class ConvLayer(nn.Module):
    """One feature-encoder block: conv -> LayerNorm -> GELU."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int, stride: int,
                 config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        self.conv = nn.Conv1d(in_dim, out_dim, kernel, stride, bias=config.conv_bias)
        self.layer_norm = nn.LayerNorm(out_dim, eps=config.layer_norm_eps)
        self.fused = (
            stride == 2 and kernel in (2, 3) and in_dim == out_dim and in_dim % 128 == 0
        )
        self.dtype = config.dtype
        self.ops = ops

    def forward(self, x):
        ln = self.layer_norm
        if self.fused:
            bias = self.conv.bias
            if bias is None:
                bias = torch.zeros_like(ln.bias)
            return self.ops.conv_ln_gelu(
                x.to(self.dtype), self.conv.weight, bias, ln.weight, ln.bias, ln.eps
            )
        x = _conv1d(x, self.conv.weight, self.conv.bias, self.conv.stride[0], self.dtype)
        return self.ops.ln_gelu(x, ln.weight, ln.bias, ln.eps)


class FeatureEncoder(nn.Module):
    """Raw waveform (B, T) -> conv features (B, T', C)."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        dims = (1, *config.conv_dim)
        self.conv_layers = nn.ModuleList(
            ConvLayer(dims[i], dims[i + 1], k, s, config, ops)
            for i, (k, s) in enumerate(zip(config.conv_kernel, config.conv_stride))
        )

    def forward(self, x):
        x = x[..., None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


def _layer_norm(x, ln: nn.LayerNorm, dtype):
    """LayerNorm in fp32, output in ``dtype`` (flax ``nn.LayerNorm`` with a
    compute dtype); the JAX package runs these two outside its kernels."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


class FeatureProjection(nn.Module):
    def __init__(self, config: Wav2Vec2Config) -> None:
        super().__init__()
        self.layer_norm = nn.LayerNorm(config.conv_dim[-1], eps=config.layer_norm_eps)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size)
        self.dtype = config.dtype

    def forward(self, x):
        return _linear(_layer_norm(x, self.layer_norm, self.dtype), self.projection, self.dtype)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding (weight norm folded into the weight)."""

    def __init__(self, config: Wav2Vec2Config) -> None:
        super().__init__()
        k = config.num_conv_pos_embeddings
        self.conv = nn.Conv1d(
            config.hidden_size, config.hidden_size, k, padding=k // 2,
            groups=config.num_conv_pos_embedding_groups,
        )
        self.dtype = config.dtype

    def forward(self, x):
        c = self.conv
        out = F.conv1d(
            x.transpose(1, 2), c.weight.to(self.dtype), c.bias.to(self.dtype),
            padding=c.padding, groups=c.groups,
        )
        if c.kernel_size[0] % 2 == 0:  # HF drops the last frame for even k
            out = out[:, :, :-1]
        return F.gelu(out.transpose(1, 2))


class Attention(nn.Module):
    """Self-attention whose q/k/v projection biases are added in the kernel."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        D = config.hidden_size
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.head_dim = D // config.num_attention_heads
        self.dtype = config.dtype
        self.ops = ops

    def forward(self, x, pad_mask):
        dt = self.dtype
        q, k, v = (_linear(x, p, dt, bias=False) for p in (self.q_proj, self.k_proj, self.v_proj))
        o, _ = self.ops.attention(
            q, k, v, pad_mask, self.head_dim,
            (self.q_proj.bias, self.k_proj.bias, self.v_proj.bias),
        )
        return _linear(o, self.out_proj, dt)


class FeedForward(nn.Module):
    """The pre-LN FFN with its LayerNorm folded in (``ffn_ln_block``)."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        D, Fi = config.hidden_size, config.intermediate_size
        self.intermediate_dense = nn.Linear(D, Fi)
        self.output_dense = nn.Linear(Fi, D)
        self.block = ops.ffn_ln_block

    def forward(self, x, ln: nn.LayerNorm):
        fc1, fc2 = self.intermediate_dense, self.output_dense
        return self.block(
            x, fc1.weight, fc1.bias, ln.weight, ln.bias, fc2.weight, fc2.bias, ln.eps
        )


class EncoderLayer(nn.Module):
    """Pre-LN transformer layer (XLS-R)."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        self.attention = Attention(config, ops)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.feed_forward = FeedForward(config, ops)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.ops = ops

    def forward(self, x, pad_mask):
        ln = self.layer_norm
        x = x + self.attention(self.ops.ln_fused(x, ln.weight, ln.bias, ln.eps), pad_mask)
        return x + self.feed_forward(x, self.final_layer_norm)


class Encoder(nn.Module):
    """Positional conv + the transformer layers + the final LayerNorm."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(config)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(config, ops) for _ in range(config.num_hidden_layers)
        )
        self.dtype = config.dtype

    def forward(self, x, pad_mask):
        # Zero padded frames first so padding cannot smear into valid frames
        # through the positional conv window.
        x = x * pad_mask[..., None].to(x.dtype)
        x = x + self.pos_conv_embed(x)
        for layer in self.layers:
            x = layer(x, pad_mask)
        return _layer_norm(x, self.layer_norm, self.dtype)


class Wav2Vec2Model(nn.Module):
    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        self.config = config
        self.feature_extractor = FeatureEncoder(config, ops)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config, ops)

    def forward(self, input_values, input_lengths):
        """(B, T) z-normalised waveforms, (B,) valid sample counts ->
        (hidden (B, T', D), frame_lengths (B,))."""
        feats = self.feature_extractor(input_values)
        frame_lengths = self.config.feat_extract_output_lengths(input_lengths)
        T_out = feats.shape[1]
        pad_mask = torch.arange(T_out, device=feats.device)[None, :] < frame_lengths[:, None]
        hidden = self.feature_projection(feats)
        return self.encoder(hidden, pad_mask), frame_lengths


class Wav2Vec2ForCTC(nn.Module):
    """wav2vec2 encoder + linear CTC head producing per-frame vocab logits.

    Args:
        config: the architecture.
        plain: run every kernel's plain PyTorch version instead of the kernel
            (the reference the kernel path is compared with).
    """

    def __init__(self, config: Wav2Vec2Config, plain: bool = False) -> None:
        super().__init__()
        self.config = config
        ops = _PLAIN if plain else _KERNELS
        self.wav2vec2 = Wav2Vec2Model(config, ops)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size)

    def forward(self, input_values, input_lengths):
        hidden, frame_lengths = self.wav2vec2(input_values, input_lengths)
        return _linear(hidden, self.lm_head, self.config.dtype), frame_lengths


def _trunc_normal(w: torch.Tensor, fan_in: int, scale: float, generator) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with the flax model's distributions: he-normal convs,
    lecun-normal dense layers, zero biases, unit LayerNorm scales."""
    for module in model.modules():
        if isinstance(module, nn.Conv1d):
            w = module.weight
            _trunc_normal(w, w.shape[1] * w.shape[2], 2.0, generator)
        elif isinstance(module, nn.Linear):
            _trunc_normal(module.weight, module.in_features, 1.0, generator)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
        else:
            continue
        if module.bias is not None:
            module.bias.zero_()


def build_model(config: Wav2Vec2Config, device: Any, seed: int = 0) -> Wav2Vec2ForCTC:
    """A seeded, randomly initialised model on ``device`` in eval mode (the
    weights are drawn on the device itself from ``torch.Generator``)."""
    with torch.device("meta"):
        model = Wav2Vec2ForCTC(config)
    model = model.to_empty(device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    init_weights(model, generator)
    return model.eval()
