"""wav2vec2 encoder + CTC head in PyTorch, for serving and for training.

Port of ``coral_tpu/models/wav2vec2.py``: the encoder layers pre-LN (XLS-R,
``do_stable_layer_norm``) or post-LN (the base models), the feature
encoder's blocks (the fused conv blocks, or the conv + ``ln_gelu``, or the
base models' conv + GroupNorm + GELU) and the ``ln_fused`` encoder
LayerNorms (or a plain fp32 LayerNorm, ``encoder_ln_impl="xla"``). The
config dataclass has the JAX dataclass's defaults (the short-T attention
without stats, the unfused FFN); the setups pass the JAX setups' production
flags (``coral_tpu/training/model_setup.py``): the v3-stats attention with
in-kernel q/k/v biases and the LN-folded FFN block. The routes are taken by
flag, as in the JAX model (:494-598, :624-697, :735-765): on the pallas
attention, ``attention_save_stats`` and ``attention_o_residual`` pick the
kernels' route (``attention_route``, ``ops/attention.py``: v3, v2, v1, the
o-residual or the recomputing backward); ``fused_qkv_ln`` folds the pre-attention
LayerNorm into one packed (3D, D) QKV projection (``ops.ffn.ln_dense``; the
parameters keep their ``q_proj``/``k_proj``/``v_proj`` and ``layer_norm``
names) whose lane thirds are q, k and v; ``attention_fused_qkv_bias=False``
adds the q/k/v biases in the projections and runs the v3-stats attention
without them (the resolved default under ``fused_qkv_ln``, where the packed
projection adds them); ``attention_impl="flash"`` (q/k/v with their
biases, the flash kernel with segment ids over T padded to 128 rows,
``ops/flash_attention.py``) or ``"xla"`` (``jax.nn.dot_product_attention``
with the -1e30 key bias, plain math under autograd); the FFN by
``Wav2Vec2Config.ffn_route``: ``fused_ffn_ln=False`` normalises outside the
FFN (``ln_fused``) and runs ``ffn_block`` without a LayerNorm;
``fused_ffn_block=False`` runs fc1 alone (``ffn_ln_fc1``, or ``ffn_fc1``
after ``ln_fused``) and fc2 as a product; ``fused_ffn=False`` the unfused FFN
(the LayerNorm through ``ln_fused``, fc1, then the GELU+dropout kernel in
training at activation dropout > 0, ``ops/gelu_dropout.py``, else exact erf
GELU with no kernel, then fc2). The LayerNorm-folded block runs the variant
its flags select (``ffn_variant``: dg in or out of the backward kernel, fc2
in the forward kernel, or the weight gradients in the backward's kernels).

``forward(..., deterministic=False, generator=...)`` is the training mode of
the JAX model's ``deterministic=False``: SpecAugment (``_span_mask``, the time
mask ANDed with the padding mask, the feature mask over all frames), every
``nn.Dropout`` site, the FFN's activation dropout, the feature encoder with
its gradients (FE conv 0 as a product + the ``ln_gelu`` kernel, blocks 1-6
through the ``conv_ln_gelu`` kernels forward and backward on XLS-R's route)
or frozen (``freeze_feature_encoder``: the conv stack runs under ``torch.no_grad()``,
the JAX ``stop_gradient``), and ``gradient_checkpointing`` of each encoder
layer under the JAX package's named remat policies (``REMAT_POLICIES``). All
randomness is drawn from the generator before the layer stack and passed in
as tensors (the SpecAugment masks, and Philox seeds per dropout site,
``ops/philox.py``): ``torch.utils.checkpoint`` restores only the global
generators, so a layer that drew from an explicit generator would replay with
another mask. As in the JAX model, ``layerdrop`` is never applied, and the
kernel attention applies no ``attention_dropout``
(``coral_tpu/models/wav2vec2.py:555-583``).

The remat policies keep the outputs they name, as ``save_only_these_names``
does. The kernels are launched through ctypes and are no ATen ops, so
``torch.utils.checkpoint``'s selective mode cannot see them; each layer writes
its save and its replay instead (``_Remat``): under the non-reentrant
checkpoint the backward runs the autograd nodes of the first forward on the
tensors that the replay packs, so in the replay an op whose output was kept
returns it, packs the same residuals and launches nothing. The FFN block's
residuals are its inputs, so the pre-LN replay never runs its forward, under
every policy, as the JAX replay drops it; post-LN the final LayerNorm packs
the block's output, so the replay runs it (and that LayerNorm's forward
not).

Parameters use PyTorch's layouts and Hugging Face's names
(``wav2vec2.encoder.layers.3.attention.q_proj.weight`` is (out, in)), one
module per layer instead of the flax scan's stacked (L, ...) arrays; they stay
fp32 and are cast to ``config.dtype`` where they are used, as the flax modules
do. ``models/convert.py`` maps the JAX package's weights onto them.

Routes follow the JAX model: a conv block takes the fused kernel only under
``fused_fe_conv`` and layer norm, for stride 2, k in {2, 3}, C_in == C_out
and C % 128 == 0 (else the conv as one product + ``ln_gelu``), so CPU parity
at small widths covers the same routes. Under group norm (the base models)
no block takes a kernel: the conv, on block 0 a GroupNorm of one channel a
group over every frame, padded ones included, as flax's ``nn.GroupNorm``
does, then exact GELU. ``remat_feature_encoder`` replays the feature
encoder in the backward keeping each conv's output ("conv_raw", the JAX
``save_only_these_names("conv_raw")``): the fused blocks name none, so
their training forward runs again; elsewhere only ``ln_gelu`` does.
Every other route is taken by flag, never by width: the FFN block always
calls ``ffn_ln_block``, the flash route the flash kernel: on the CPU their
plain versions at any width, and on the card the kernels, which raise for
widths they do not take. ``Wav2Vec2ForCTC(plain=True)`` builds the same model on the kernels'
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
import torch.utils.checkpoint
from torch import nn

from ..ops import attention as _attention
from ..ops import conv_ln_gelu as _conv_ln_gelu
from ..ops import ffn as _ffn
from ..ops import flash_attention as _flash
from ..ops import gelu_dropout as _gelu_dropout
from ..ops import ln_gelu as _ln_gelu
from ..ops.attention import short_t_attention_flat, short_t_attention_packed
from ..ops.conv_ln_gelu import conv_ln_gelu
from ..ops.ffn import ffn_block, ffn_fc1, ffn_ln_block, ffn_ln_fc1, ln_dense
from ..ops.flash_attention import flash_attention, flash_self_attention
from ..ops.gelu_dropout import gelu_dropout
from ..ops.ln_gelu import ln_fused, ln_gelu
from ..ops.philox import dropout

# Message tail of every NotImplementedError for what the port does not cover.
NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1 item {})"


class FFNBlockVariant:
    """The LayerNorm-folded FFN block's variant of a model config with the
    fields ``fused_ffn_block_dw``, ``_fc2``, ``_dg`` and an ``ffn_route``."""

    @property
    def ffn_variant(self) -> str | None:
        """``ops.ffn.block_variant`` of the flags, None off the block's route,
        where the JAX models never read them."""
        if self.ffn_route != "ffn_ln_block":
            return None
        return _ffn.block_variant(self.fused_ffn_block_dw, self.fused_ffn_block_fc2,
                                  self.fused_ffn_block_dg)

    @property
    def ffn_block_flags(self) -> dict[str, bool]:
        """``ffn_ln_block``'s variant keywords, as the JAX models pass them."""
        return dict(dw_in_kernel=self.fused_ffn_block_dw,
                    fc2_in_kernel=self.fused_ffn_block_fc2,
                    dg_in_kernel=self.fused_ffn_block_dg)


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config(FFNBlockVariant):
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
    # Dropouts (coral_tpu/models/wav2vec2.py:52-58). layerdrop is carried for
    # the config surface and, as in the JAX model, never applied.
    hidden_dropout: float = 0.0
    activation_dropout: float = 0.1
    attention_dropout: float = 0.0
    feat_proj_dropout: float = 0.0
    final_dropout: float = 0.0
    layerdrop: float = 0.0
    # SpecAugment
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.5
    mask_time_length: int = 10
    mask_feature_prob: float = 0.5
    mask_feature_length: int = 64
    dtype: torch.dtype = torch.float32  # compute dtype; bfloat16 on the card
    # Kernel routes (coral_tpu/models/wav2vec2.py:64-143), with the JAX
    # dataclass's defaults; the setups pass every flag at the JAX setups'
    # values. attention_impl: "pallas" (the short-T kernels), "flash" or
    # "xla" (the q/k/v biases in the projections). On pallas,
    # attention_save_stats (False, True, "v2", "v3") and attention_o_residual
    # pick the kernels' route (``attention_route``), and
    # attention_fused_qkv_bias adds the q/k/v biases inside the v3 kernels.
    # fused_qkv_ln folds the pre-attention LayerNorm into the packed QKV
    # projection. fused_ffn: the FFN's fused kernels, False: the unfused FFN;
    # with it fused_ffn_ln folds the LayerNorm into them, and fused_ffn_block
    # runs the whole FFN as one block (``ffn_route``). On the
    # LayerNorm-folded block, fused_ffn_block_dw, _fc2 and _dg pick its
    # variant (``ffn_variant``). fused_fe_conv: the feature encoder's fused
    # conv blocks (False: each conv as a product + ``ln_gelu``);
    # encoder_ln_impl: the encoder LayerNorms through ``ln_fused`` ("pallas")
    # or a plain fp32 LayerNorm ("xla", flax ``nn.LayerNorm``). The post-LN
    # encoder folds no LayerNorm (the JAX model reads fused_ffn_ln and
    # fused_qkv_ln only pre-LN; the setup refuses them with it).
    attention_impl: str = "pallas"
    attention_save_stats: bool | str = False
    attention_o_residual: bool = False
    fused_qkv_ln: bool = False
    attention_fused_qkv_bias: bool = False
    fused_ffn: bool = False
    fused_ffn_ln: bool = False
    fused_ffn_block: bool = False
    fused_ffn_block_dw: bool = False
    fused_ffn_block_fc2: bool = False
    fused_ffn_block_dg: bool = False
    fused_fe_conv: bool = True
    encoder_ln_impl: str = "pallas"

    def __post_init__(self) -> None:
        if self.feat_extract_norm not in ("layer", "group"):
            raise ValueError(f"feat_extract_norm={self.feat_extract_norm!r}: expected 'layer' "
                             "or 'group'")
        if self.encoder_ln_impl not in ("pallas", "xla"):
            raise ValueError(f"encoder_ln_impl={self.encoder_ln_impl!r}: expected 'pallas' or "
                             "'xla'")
        if self.attention_impl not in ("pallas", "flash", "xla"):
            raise ValueError(f"attention_impl={self.attention_impl!r}: expected 'pallas', "
                             "'flash' or 'xla'")
        # The JAX model's two refusals (coral_tpu/models/wav2vec2.py:494-530).
        if self.qkv_ln and self.attention_fused_qkv_bias:
            raise ValueError("attention_fused_qkv_bias is mutually exclusive with fused_qkv_ln "
                             "(the LN fold already owns the q/k/v biases)")
        if self.attention_fused_qkv_bias and (self.attention_impl != "pallas"
                                              or self.attention_save_stats != "v3"):
            raise ValueError("attention_fused_qkv_bias requires attention_impl='pallas' and "
                             f"attention_save_stats='v3' (got {self.attention_impl!r} / "
                             f"{self.attention_save_stats!r})")

    @property
    def qkv_ln(self) -> bool:
        """The pre-attention LayerNorm folded into the packed QKV projection:
        ``fused_qkv_ln`` on the pre-LN encoder, the only one where the JAX
        model reads it."""
        return self.fused_qkv_ln and self.do_stable_layer_norm

    @property
    def attention_route(self) -> str | None:
        """The pallas attention's route (``ops.attention.route``: "stats_v3",
        "stats_v2", "stats", "ctx" or "attention"), None off the pallas
        route, where the JAX model never reads the two flags."""
        if self.attention_impl != "pallas":
            return None
        return _attention.route(self.attention_save_stats, self.attention_o_residual)

    @property
    def ffn_route(self) -> str:
        """The FFN's route, as the JAX model picks it
        (coral_tpu/models/wav2vec2.py:624-697, :751-765): "ffn_ln_block",
        "ffn_block" (LN2 outside), "ffn_ln_fc1", "ffn_fc1" (LN2 outside),
        each with fc2 outside the kernels, or "unfused". The post-LN encoder
        takes no LayerNorm-folded route."""
        if not self.fused_ffn:
            return "unfused"
        return (("ffn_ln_" if self.fused_ffn_ln and self.do_stable_layer_norm else "ffn_")
                + ("block" if self.fused_ffn_block else "fc1"))

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
    def base(cls, vocab_size: int = 46, **kw) -> "Wav2Vec2Config":
        """facebook/wav2vec2-base's published architecture: hidden 768, 12
        layers of 12 heads, FFN 3072, the feature encoder's 7 x 512 convs
        without biases under group norm, the post-LN encoder. The JAX setup
        has no base architecture; the JAX model takes the same fields."""
        return cls(
            vocab_size=vocab_size, hidden_size=768, num_hidden_layers=12,
            num_attention_heads=12, intermediate_size=3072, conv_bias=False,
            feat_extract_norm="group", do_stable_layer_norm=False, **kw,
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

    def fe_fused(self, i: int) -> bool:
        """Whether feature-encoder block i takes the fused conv block (K3),
        the JAX ``ConvLayer``'s condition (coral_tpu/models/wav2vec2.py:282-286)."""
        c_in = (1, *self.conv_dim)[i]
        return (self.fused_fe_conv and self.feat_extract_norm == "layer"
                and self.conv_stride[i] == 2 and self.conv_kernel[i] in (2, 3)
                and c_in == self.conv_dim[i] and c_in % 128 == 0)

    @property
    def ln_fused_runs(self) -> bool:
        """Whether an encoder LayerNorm goes through ``ln_fused``: under
        ``encoder_ln_impl="pallas"``, post-LN, or pre-LN where LN1 or LN2 is
        not folded into a kernel."""
        folded = self.qkv_ln and self.ffn_route in ("ffn_ln_block", "ffn_ln_fc1")
        return self.encoder_ln_impl == "pallas" and not folded

    def feat_extract_output_lengths(self, input_lengths):
        """Raw-audio lengths -> feature-frame lengths through the conv stack
        (floor division: a length-1 filler row maps below zero, as in JAX)."""
        lengths = input_lengths
        for kernel, stride in zip(self.conv_kernel, self.conv_stride):
            lengths = (lengths - kernel) // stride + 1
        return lengths


def kernel_widths(config: Wav2Vec2Config) -> list[tuple[str, float, tuple]]:
    """(what, its value, the values the kernel takes) for each width that a
    kernel on this model's path depends on: every route below is taken by
    flag, never by width, so an untaken width would fail at its launch."""
    bf16 = torch.bfloat16
    D = config.hidden_size
    head_dim = D / config.num_attention_heads
    if config.fused_ffn:
        route = config.ffn_route + (f" {config.ffn_variant}" if config.ffn_variant else "")
        ffn = [(f"hidden_size (the FFN kernels, {route})", D, _ffn.KERNEL_D),
               ("intermediate_size's remainder by the FFN's F tile",
                config.intermediate_size % _ffn.KERNEL_F_TILE, (0,))]
    else:
        ffn = [("intermediate_size's remainder by the GELU+dropout's vector",
                config.intermediate_size % _gelu_dropout.KERNEL_F_MULTIPLE, (0,))]
    attention = {
        "pallas": [(f"head_dim (the attention, {config.attention_route})", head_dim,
                    _attention.KERNEL_HEAD_DIMS)],
        "flash": [("head_dim (the flash attention)", head_dim, _flash.KERNEL_HEAD_DIMS)],
        "xla": [],
    }[config.attention_impl]
    if config.qkv_ln:
        attention.append(("hidden_size (the LayerNorm-folded packed QKV projection)", D,
                          _ffn.KERNEL_QKV_D))
    ln = ([("hidden_size (the encoder LayerNorm)", D, _ln_gelu.KERNEL_C[bf16])]
          if config.ln_fused_runs else [])
    # Under group norm no feature-encoder block takes a kernel.
    fe = [(f"conv_dim[{i}] (the conv block)", c, (_conv_ln_gelu.KERNEL_C,))
          if config.fe_fused(i) else
          (f"conv_dim[{i}] (LayerNorm + GELU)", c, _ln_gelu.KERNEL_C[bf16])
          for i, c in enumerate(config.conv_dim) if config.feat_extract_norm == "layer"]
    return [
        *ffn,
        *ln,
        ("hidden_size (the LayerNorm backward)", D, _ln_gelu.KERNEL_C_BWD[bf16]),
        *attention,
        *fe,
    ]


class _Ops(NamedTuple):
    """The kernel entry points the model calls, or their plain versions."""

    ln_gelu: Callable
    ln_fused: Callable
    conv_ln_gelu: Callable
    attention: Callable
    attention_packed: Callable
    ln_dense: Callable
    ffn_ln_block: Callable
    ffn_block: Callable
    ffn_ln_fc1: Callable
    ffn_fc1: Callable
    flash_attention: Callable
    flash_self_attention: Callable
    gelu_dropout: Callable


_KERNELS = _Ops(ln_gelu, ln_fused, conv_ln_gelu, short_t_attention_flat,
                short_t_attention_packed, ln_dense, ffn_ln_block, ffn_block, ffn_ln_fc1,
                ffn_fc1, flash_attention, flash_self_attention, gelu_dropout)
_PLAIN = _Ops(
    functools.partial(ln_gelu, plain=True),
    functools.partial(ln_fused, plain=True),
    functools.partial(conv_ln_gelu, plain=True),
    functools.partial(short_t_attention_flat, plain=True),
    functools.partial(short_t_attention_packed, plain=True),
    functools.partial(ln_dense, plain=True),
    functools.partial(ffn_ln_block, plain=True),
    functools.partial(ffn_block, plain=True),
    functools.partial(ffn_ln_fc1, plain=True),
    functools.partial(ffn_fc1, plain=True),
    functools.partial(flash_attention, plain=True),
    _flash.flash_self_attention_plain,
    functools.partial(gelu_dropout, plain=True),
)

# Dropout sites inside an encoder layer, in the order of their seed rows.
_ATTN_OUT, _FFN_ACT, _FFN_OUT = range(3)

# The JAX package's remat policies (coral_tpu/models/wav2vec2.py:774-843) by
# the names each saves. At the production kernel flags a layer emits "attn_in"
# (the LN1 output), "q", "k", "v" (the projections before their biases),
# "attn_ctx" and "attn_lse" (the attention's o and lse) and "ffn_in" (the
# residual stream into the FFN block). The pallas attention's other routes
# emit "attn_ctx" alone (no stats, with or without the o residual; the replay
# skips the forward when it is kept) or, on v1, nothing that the replay can
# use (its lse has no name). On the flash and xla routes "q", "k",
# "v" are the projections with their biases, and "attn_ctx" keeps nothing
# apart: the flash forward's residuals o, l, m have no name, so its replay
# runs the forward (with its stats) again, as the JAX replay does, and the
# plain attention packs its own residuals. "ffn_in" names the residual
# stream where the LayerNorm is folded into the FFN's kernels and the LN2
# output elsewhere (coral_tpu/models/wav2vec2.py:751-765). On the fc1 routes
# ("ffn_ln_fc1", "ffn_fc1") "ffn_act" is fc1's output g: kept, the replay
# skips the fc1 kernel; else it runs it again, since fc2's weight gradient
# reads g. The blocks emit no "ffn_act" (their replay launches nothing), and
# the unfused FFN names its fc1 output "ffn_hidden". Under fused_qkv_ln "q",
# "k" and "v" name the lane thirds of the one packed projection (the JAX
# model's checkpoint names on its slices) and "attn_in" the residual stream
# (the layer's input, which the checkpoint holds anyway): the packed output
# is kept only with all three names (save_qkv_ctx, save_matmul_inputs[_ffn]),
# and else the replay runs the projection's forward again for all of it, as
# the JAX replay runs the custom VJP's forward for a v it does not keep.
# The post-LN encoder names no "attn_in" or "ffn_in" (:766-770).
# dots_saveable is ``dots_with_no_batch_dims_saveable``: it keeps the outputs
# of the XLA products with no batch dimension that the backward reads, and no
# Pallas kernel's output or batched attention product. By
# ``jax.ad_checkpoint.print_saved_residuals`` on the JAX layer at width 128
# (the kernels' route; PERF.md) those are the q, k and v projections (not
# under fused_qkv_ln, where they are lane thirds of a kernel's output), the
# out projection's output ("attn_out"), fc1's output on the unfused FFN
# ("ffn_hidden") and, post-LN, fc2's output where it is a product
# ("ffn_out": the final LayerNorm reads it); ``product_names`` picks those of
# a route, so its entry here is None. (Below width 128 the JAX FFN runs in XLA
# and keeps fc1's output too; the port's FFN takes its kernels at every
# width.)
REMAT_POLICIES: dict[str, tuple[str, ...] | None] = {
    "nothing_saveable": (),
    "dots_saveable": None,
    "save_matmul_inputs": ("attn_in", "q", "k", "v", "attn_ctx", "ffn_in"),
    "save_attn_ctx": ("attn_ctx",),
    "save_ctx_act": ("attn_ctx", "ffn_act"),
    "save_attn_ctx_lse": ("attn_ctx", "attn_lse"),
    "save_qkv_ctx": ("q", "k", "v", "attn_ctx", "attn_lse"),
    "save_qk_ctx": ("q", "k", "attn_ctx", "attn_lse"),
    "save_matmul_inputs_ffn": ("attn_in", "q", "k", "v", "attn_ctx", "ffn_in", "ffn_hidden",
                               "ffn_act"),
}


def remat_names(policy: str, config: Wav2Vec2Config) -> frozenset[str]:
    """The names ``policy`` keeps on ``config``'s route; raises for a policy
    the port does not have."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat_policy {policy!r}; choose from "
                         f"{sorted(REMAT_POLICIES)}")
    names = REMAT_POLICIES[policy]
    return product_names(config) if names is None else frozenset(names)


def product_names(config: Wav2Vec2Config) -> frozenset[str]:
    """The products' outputs that ``dots_saveable`` keeps on ``config``'s
    route (the comment above ``REMAT_POLICIES``)."""
    names = {"attn_out"}
    if not config.qkv_ln:
        names |= {"q", "k", "v"}
    if config.ffn_route == "unfused":
        names.add("ffn_hidden")
    if not config.do_stable_layer_norm and config.ffn_route in ("unfused", "ffn_fc1"):
        names.add("ffn_out")
    return frozenset(names)


class _Remat:
    """One layer's checkpoint under a named policy.

    The layer runs twice under ``torch.utils.checkpoint``: the forward, where
    ``keep`` holds on to the outputs the policy names, and the replay in the
    backward, where ``saved`` hands each kept output back to the op that made
    it, which then packs its residuals and launches nothing. The outputs of
    one op in ``groups`` are kept only all together: the attention's o and
    lse on the v3 and v2 routes, whose backward reads the lse, so with one of
    them missing the forward kernel runs in the replay anyway (the JAX
    setup's warning for ``save_attn_ctx``).
    """

    def __init__(self, names: frozenset[str], groups: tuple[frozenset[str], ...] = ()) -> None:
        for group in groups:
            if not group <= names:
                names = names - group
        if {"q", "k", "v"} <= names:
            names = names | {"qkv"}  # the packed projection of fused_qkv_ln
        self.names = names
        self.kept: dict[str, torch.Tensor] = {}
        self.replaying = False

    def keep(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if not self.replaying and name in self.names:
            self.kept[name] = t.detach()
        return t

    def saved(self, name: str) -> torch.Tensor | None:
        return self.kept.get(name) if self.replaying else None


_NO_REMAT = _Remat(frozenset())  # no checkpoint: nothing kept, nothing replayed
_CTX_LSE = frozenset({"attn_ctx", "attn_lse"})


class Randomness(NamedTuple):
    """Everything random in one training forward, drawn before the layer stack.

    time_starts (B, T') and feature_starts (B, D) are SpecAugment's Bernoulli
    span starts (None when that mask is off); the seeds are (B,) int32 per
    dropout site: feat_proj, encoder (after the positional conv), layers
    (L, 3, B: attention output, FFN activation, FFN output) and final.
    """

    time_starts: torch.Tensor | None
    feature_starts: torch.Tensor | None
    feat_proj: torch.Tensor
    encoder: torch.Tensor
    layers: torch.Tensor
    final: torch.Tensor


def _seeds(generator, *shape, device):
    return torch.randint(-(2**31), 2**31, shape, generator=generator, device=device,
                         dtype=torch.int64).to(torch.int32)


def draw_randomness(config: Wav2Vec2Config, batch: int, frames: int,
                    generator: torch.Generator, device) -> Randomness:
    """Draws one forward's SpecAugment starts and dropout seeds, in a fixed order."""
    def starts(n, prob, span):
        if not (config.apply_spec_augment and prob > 0):
            return None
        return torch.rand((batch, n), generator=generator, device=device) < prob / span

    return Randomness(
        starts(frames, config.mask_time_prob, config.mask_time_length),
        starts(config.hidden_size, config.mask_feature_prob, config.mask_feature_length),
        _seeds(generator, batch, device=device),
        _seeds(generator, batch, device=device),
        _seeds(generator, config.num_hidden_layers, 3, batch, device=device),
        _seeds(generator, batch, device=device),
    )


def span_dilate(starts: torch.Tensor, span: int) -> torch.Tensor:
    """(B, N) bool span starts -> (B, N) bool mask: position t is masked if a
    start lies in (t - span, t], the ``jnp.convolve(..., mode="full")[:N]`` of
    ``_span_mask``."""
    padded = F.pad(starts.float()[:, None, :], (span - 1, 0))
    return F.max_pool1d(padded, span, stride=1)[:, 0, :] > 0


def _dropout(x, rate: float, seeds):
    """``nn.Dropout(rate)``; identity when deterministic (no seeds)."""
    return x if seeds is None else dropout(x, rate, seeds)


def _linear(x, layer: nn.Linear, dtype, bias: bool = True):
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype) if bias else None)


class _Projection(torch.autograd.Function):
    """``F.linear(x, w, b)`` whose product a checkpoint replay can skip: given
    ``saved`` (a kept output, or a stand-in the replay never reads) it returns
    that and packs the same residuals (x, w). The backward is the product's:
    ``dx = dy w``, ``dw = dy^T x``, ``db`` the column sums of dy. Only a
    product whose output the policy keeps goes through it: elsewhere
    ``F.linear`` keeps autograd's own node, with no Python in the backward."""

    @staticmethod
    def forward(ctx, x, w, b, saved):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return F.linear(x, w, b) if saved is None else saved.detach()

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = torch.matmul(dy, w) if ctx.needs_input_grad[0] else None
        dw = torch.matmul(dy2.t(), x.reshape(-1, x.shape[-1]))
        return dx, dw, dy2.sum(0) if ctx.has_bias else None, None


def _project(x, layer: nn.Linear, dtype, remat: _Remat, name: str, bias: bool = True,
             saved=None):
    """The projection ``layer`` of x, skippable in a replay when ``remat``
    keeps ``name``."""
    if name not in remat.names:
        return _linear(x, layer, dtype, bias)
    return _Projection.apply(x, layer.weight.to(dtype),
                             layer.bias.to(dtype) if bias else None, saved)


def _conv1d(x, weight, bias, stride: int, dtype, remat: _Remat = _NO_REMAT, name: str = ""):
    """Strided conv on (B, T, C_in) as one product over the unfolded windows;
    the output comes out in (B, T', C_out) without a layout copy. Where
    ``remat`` keeps ``name``, the product (before the bias) is kept and a
    replay skips it (``_Projection``)."""
    C_out, C_in, K = weight.shape
    patches = x.to(dtype).unfold(1, K, stride)  # (B, T', C_in, K)
    patches = patches.reshape(*patches.shape[:2], C_in * K)
    w = weight.to(dtype).reshape(C_out, C_in * K)
    if name in remat.names:
        out = remat.keep(name, _Projection.apply(patches, w, None, remat.saved(name)))
    else:
        out = patches @ w.t()
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def _group_norm(x, gn: nn.GroupNorm, dtype):
    """flax ``nn.GroupNorm`` on (B, T, C) in fp32, output in ``dtype``: each
    group's statistics over every frame, padded ones included."""
    y = F.group_norm(x.float().transpose(1, 2), gn.num_groups, gn.weight.float(),
                     gn.bias.float(), gn.eps)
    return y.transpose(1, 2).to(dtype)


class ConvLayer(nn.Module):
    """One feature-encoder block, routed as the JAX ``ConvLayer``
    (coral_tpu/models/wav2vec2.py:257-318): under layer norm the fused conv
    block (K3) where ``Wav2Vec2Config.fe_fused`` says so, else conv -> K1
    (LayerNorm + GELU); under group norm conv -> GroupNorm (block 0 only) ->
    exact GELU. The norm keeps HF's name, ``layer_norm``, in both. The conv
    output outside K3 is JAX's "conv_raw"."""

    def __init__(self, i: int, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        in_dim, out_dim = (1, *config.conv_dim)[i], config.conv_dim[i]
        self.conv = nn.Conv1d(in_dim, out_dim, config.conv_kernel[i], config.conv_stride[i],
                              bias=config.conv_bias)
        self.norm = (config.feat_extract_norm
                     if config.feat_extract_norm == "layer" or i == 0 else None)
        if self.norm == "layer":
            self.layer_norm = nn.LayerNorm(out_dim, eps=config.layer_norm_eps)
        elif self.norm == "group":
            self.layer_norm = nn.GroupNorm(out_dim, out_dim, eps=config.layer_norm_eps)
        self.fused = config.fe_fused(i)
        self.raw_name = f"conv_raw{i}"
        self.last = i == len(config.conv_dim) - 1
        self.dtype = config.dtype
        self.ops = ops

    def forward(self, x, remat: _Remat = _NO_REMAT):
        if self.fused:
            ln = self.layer_norm
            bias = self.conv.bias
            if bias is None:
                bias = torch.zeros_like(ln.bias)
            return self.ops.conv_ln_gelu(
                x.to(self.dtype), self.conv.weight, bias.float(), ln.weight.float(),
                ln.bias.float(), ln.eps
            )
        x = _conv1d(x, self.conv.weight, self.conv.bias, self.conv.stride[0], self.dtype,
                    remat, self.raw_name)
        if self.norm == "layer":
            ln = self.layer_norm
            # A replay reads no output of the last block: K1 packs its
            # residuals there and launches nothing.
            unread = torch.empty_like(x) if remat.replaying and self.last else None
            return self.ops.ln_gelu(x, ln.weight, ln.bias, ln.eps, saved=unread)
        if self.norm == "group":
            x = _group_norm(x, self.layer_norm, self.dtype)
        return F.gelu(x)


class FeatureEncoder(nn.Module):
    """Raw waveform (B, T) -> conv features (B, T', C)."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        self.conv_layers = nn.ModuleList(
            ConvLayer(i, config, ops) for i in range(len(config.conv_dim)))
        # Replay the blocks in the backward, keeping only each conv's output
        # (the JAX ``remat_feature_encoder``); set by the train setup.
        self.remat = False

    def forward(self, x):
        if self.remat and torch.is_grad_enabled():
            names = frozenset(layer.raw_name for layer in self.conv_layers)
            return torch.utils.checkpoint.checkpoint(self._blocks, x, _Remat(names),
                                                     use_reentrant=False)
        return self._blocks(x)

    def _blocks(self, x, remat: _Remat = _NO_REMAT):
        x = x[..., None]
        for layer in self.conv_layers:
            x = layer(x, remat)
        remat.replaying = remat is not _NO_REMAT
        return x


def _layer_norm(x, ln: nn.LayerNorm, dtype):
    """LayerNorm in fp32, output in ``dtype`` (flax ``nn.LayerNorm`` with a
    compute dtype); the JAX package runs these two outside its kernels."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps).to(dtype)


class FeatureProjection(nn.Module):
    def __init__(self, config: Wav2Vec2Config) -> None:
        super().__init__()
        self.layer_norm = nn.LayerNorm(config.conv_dim[-1], eps=config.layer_norm_eps)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size)
        self.dtype = config.dtype

        self.rate = config.feat_proj_dropout

    def forward(self, x, seeds=None):
        x = _linear(_layer_norm(x, self.layer_norm, self.dtype), self.projection, self.dtype)
        return _dropout(x, self.rate, seeds)


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


def _attention_xla(q, k, v, pad_mask):
    """``jax.nn.dot_product_attention`` with the wav2vec2 key bias, on (B, T,
    H, d): fp32 scores times d**-0.5 plus ``where(pad_mask, 0, -1e30)`` in
    the working dtype, an fp32 softmax, the probabilities in the working dtype
    for the product with v. A row with no valid key averages every key."""
    dt = q.dtype
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = (qh.float() @ kh.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    bias = torch.where(pad_mask, 0.0, -1e30).to(dt).float()[:, None, None, :]
    p = torch.softmax(s + bias, dim=-1).to(dt)
    return (p @ vh).transpose(1, 2)


class Attention(nn.Module):
    """Self-attention: on the pallas route with ``attention_fused_qkv_bias``
    the q/k/v projection biases are added in the kernel; elsewhere in the
    projections, or, given the pre-attention LayerNorm (``fused_qkv_ln``), in
    the one packed projection ``ln_dense`` whose lane thirds are q, k, v."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        D = config.hidden_size
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.num_heads = config.num_attention_heads
        self.head_dim = D // config.num_attention_heads
        self.impl = config.attention_impl
        self.route = config.attention_route
        self.flags = dict(save_stats=config.attention_save_stats,
                          o_residual=config.attention_o_residual)
        self.qkv_bias = config.attention_fused_qkv_bias
        self.dtype = config.dtype
        self.rate = config.hidden_dropout
        self.ops = ops

    def forward(self, x, pad_mask, seeds=None, remat: _Remat = _NO_REMAT,
                skip_out: bool = False, ln: nn.LayerNorm | None = None):
        """skip_out: a kept "ffn_in" is the replay's residual stream (the
        LayerNorm-folded FFN's routes), so the replay reads no output of the
        out projection, which then only packs its residuals; elsewhere its
        output is "attn_out". ln: the pre-attention LayerNorm
        to fold into the packed projection (x is then the residual stream)."""
        dt = self.dtype
        projections = (self.q_proj, self.k_proj, self.v_proj)
        qkv = None
        if ln is not None:
            w = torch.cat([p.weight.to(dt) for p in projections])
            b = torch.cat([p.bias for p in projections])
            qkv = remat.keep("qkv", self.ops.ln_dense(x, w, b, ln.weight, ln.bias, ln.eps,
                                                       saved=remat.saved("qkv")))
            q, k, v = qkv.chunk(3, dim=-1)
        else:
            bias = self.impl != "pallas" or not self.qkv_bias
            q, k, v = (remat.keep(n, _project(x, p, dt, remat, n, bias=bias,
                                              saved=remat.saved(n)))
                       for n, p in zip(("q", "k", "v"), projections))
        if self.impl == "pallas":
            # A replay skips the forward where the policy kept what it made
            # and its backward reads: o ("attn_ctx"), and the lse
            # ("attn_lse") on v3 and v2, whose group in ``_Remat`` keeps both
            # or neither. v1's lse has no name (coral_tpu/models/wav2vec2.py:
            # 556-578), so its forward runs again under every policy.
            saved = None
            if self.route != "stats" and remat.saved("attn_ctx") is not None:
                saved = (remat.saved("attn_ctx"), remat.saved("attn_lse"))
            if qkv is not None:
                o, lse = self.ops.attention_packed(qkv, pad_mask, self.head_dim, saved=saved,
                                                   **self.flags)
            else:
                biases = ((self.q_proj.bias, self.k_proj.bias, self.v_proj.bias)
                          if self.qkv_bias else None)
                o, lse = self.ops.attention(q, k, v, pad_mask, self.head_dim, biases,
                                            saved=saved, **self.flags)
            if self.route != "stats":
                remat.keep("attn_ctx", o)
                if lse is not None:
                    remat.keep("attn_lse", lse)
        else:
            B, T, D = q.shape
            q4, k4, v4 = (t.view(B, T, self.num_heads, self.head_dim) for t in (q, k, v))
            if self.impl == "xla":
                o = _attention_xla(q4, k4, v4, pad_mask)
            else:
                ids = _flash.segment_ids(pad_mask)
                o = (self.ops.flash_attention(q4, k4, v4, segment_ids=ids)[0]
                     if torch.is_grad_enabled()
                     else self.ops.flash_self_attention(q4, k4, v4, segment_ids=ids))
            o = o.reshape(B, T, D)
        if skip_out and "ffn_in" in remat.names:
            unread = None if remat.saved("ffn_in") is None else torch.empty_like(o)
            out = _project(o, self.out_proj, dt, remat, "ffn_in", saved=unread)
        else:
            out = remat.keep("attn_out", _project(o, self.out_proj, dt, remat, "attn_out",
                                                  saved=remat.saved("attn_out")))
        return _dropout(out, self.rate, seeds)


class FeedForward(nn.Module):
    """The FFN on the route of ``config.ffn_route``: one of the fused
    entry points of ``ops/ffn.py`` (the blocks take fc2 in, the fc1 routes
    leave it to a product), else fc1, GELU (+ dropout) and fc2."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        D, Fi = config.hidden_size, config.intermediate_size
        self.intermediate_dense = nn.Linear(D, Fi)
        self.output_dense = nn.Linear(Fi, D)
        self.route = config.ffn_route
        self.block_flags = config.ffn_block_flags
        # Post-LN, the final LayerNorm packs the FFN's output, so a replay
        # runs the block's forward.
        self.replay_reads_out = not config.do_stable_layer_norm
        self.ops = ops
        self.activation_rate = config.activation_dropout
        self.rate = config.hidden_dropout
        self.dtype = config.dtype

    def forward(self, x, ln: nn.LayerNorm, act_seeds=None, out_seeds=None,
                remat: _Remat = _NO_REMAT):
        """x: the residual stream on the routes that fold ``ln`` in, else
        the LN2 output; act_seeds: (B,) seeds of the activation dropout
        (None: rate 0, the deterministic forward); out_seeds: those of the
        hidden dropout; remat: the layer's checkpoint record (a pre-LN
        block's replay reads no output of it; a kept "ffn_act" skips the fc1
        kernel, a kept "ffn_hidden" the unfused fc1, a kept "ffn_out" fc2)."""
        fc1, fc2 = self.intermediate_dense, self.output_dense
        rate = self.activation_rate if act_seeds is not None else 0.0
        seeds = act_seeds if rate > 0.0 else None
        dt, ops = self.dtype, self.ops
        if self.route in ("ffn_ln_block", "ffn_block"):
            stand_in = (torch.empty_like(x) if remat.replaying and not self.replay_reads_out
                        else None)
            if self.route == "ffn_ln_block":
                x = ops.ffn_ln_block(x, fc1.weight, fc1.bias, ln.weight, ln.bias, fc2.weight,
                                     fc2.bias, ln.eps, rate, seeds, saved=stand_in,
                                     **self.block_flags)
            else:
                x = ops.ffn_block(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias, rate, seeds,
                                  saved=stand_in)
        elif self.route in ("ffn_ln_fc1", "ffn_fc1"):
            saved = remat.saved("ffn_act")
            if self.route == "ffn_ln_fc1":
                g = ops.ffn_ln_fc1(x, fc1.weight, fc1.bias, ln.weight, ln.bias, ln.eps, rate,
                                   seeds, saved=saved)
            else:
                g = ops.ffn_fc1(x, fc1.weight, fc1.bias, rate, seeds, saved=saved)
            x = self._fc2(remat.keep("ffn_act", g), remat)
        else:
            h = remat.keep("ffn_hidden", _project(x, fc1, dt, remat, "ffn_hidden",
                                                  saved=remat.saved("ffn_hidden")))
            # The JAX model: the kernel only for dropout in training, else
            # exact erf GELU (coral_tpu/models/wav2vec2.py:684-695).
            h = ops.gelu_dropout(h, rate, act_seeds) if rate > 0.0 else F.gelu(h)
            x = self._fc2(h, remat)
        return _dropout(x, self.rate, out_seeds)

    def _fc2(self, g, remat: _Remat):
        return remat.keep("ffn_out", _project(g, self.output_dense, self.dtype, remat, "ffn_out",
                                              saved=remat.saved("ffn_out")))


class EncoderLayer(nn.Module):
    """Transformer layer: pre-LN (XLS-R) under ``do_stable_layer_norm``, else
    post-LN (the base models)."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        self.attention = Attention(config, ops)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.feed_forward = FeedForward(config, ops)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.pre_ln = config.do_stable_layer_norm
        # The FFN's kernels take the residual stream and fold LN2 in.
        self.ln_folded = config.ffn_route in ("ffn_ln_block", "ffn_ln_fc1")
        self.qkv_ln = config.qkv_ln
        self.ln_impl = config.encoder_ln_impl
        self.dtype = config.dtype
        self.ops = ops

    def norm(self, x, ln: nn.LayerNorm, remat: _Remat = _NO_REMAT, name: str = "",
             saved=None):
        """The encoder LayerNorm: ``ln_fused`` under ``encoder_ln_impl`` pallas,
        its output kept as ``name`` and skipped in a replay where ``remat``
        keeps it (or ``saved``, a stand-in the replay never reads, given); a
        plain fp32 LayerNorm under xla (flax ``nn.LayerNorm``,
        coral_tpu/models/wav2vec2.py:726-729), which a replay runs again."""
        if self.ln_impl == "xla":
            return _layer_norm(x, ln, self.dtype)
        if saved is None:
            saved = remat.saved(name)
        return remat.keep(name, self.ops.ln_fused(x, ln.weight, ln.bias, ln.eps, saved=saved))

    def forward(self, x, pad_mask, seeds=None, remat: _Remat = _NO_REMAT):
        """seeds: (3, B) int32, this layer's dropout seeds (None: deterministic);
        remat: this layer's checkpoint record (``_Remat``)."""
        ln, fln = self.layer_norm, self.final_layer_norm
        s = [None] * 3 if seeds is None else seeds
        if not self.pre_ln:
            # coral_tpu/models/wav2vec2.py:766-770; names no "attn_in" or
            # "ffn_in". A replay reads no output of the final LayerNorm.
            x = self.norm(x + self.attention(x, pad_mask, s[_ATTN_OUT], remat), ln)
            h = self.feed_forward(x, fln, s[_FFN_ACT], s[_FFN_OUT], remat)
            out = self.norm(x + h, fln, saved=torch.empty_like(x) if remat.replaying else None)
            remat.replaying = remat is not _NO_REMAT
            return out
        if self.qkv_ln:
            # LN1 folded into the packed QKV projection; "attn_in" names x.
            h = self.attention(x, pad_mask, s[_ATTN_OUT], remat, skip_out=self.ln_folded, ln=ln)
        else:
            h = self.attention(self.norm(x, ln, remat, "attn_in"), pad_mask, s[_ATTN_OUT],
                               remat, skip_out=self.ln_folded)
        if self.ln_folded:
            # "ffn_in" names the residual stream, the FFN kernels' input.
            ffn_in = remat.saved("ffn_in")
            if ffn_in is None:
                ffn_in = remat.keep("ffn_in", x + h)
            x = ffn_in
        else:
            # "ffn_in" names the LN2 output (coral_tpu/models/wav2vec2.py:762-765).
            x = x + h
            ffn_in = self.norm(x, fln, remat, "ffn_in")
        out = x + self.feed_forward(ffn_in, fln, s[_FFN_ACT], s[_FFN_OUT], remat)
        remat.replaying = remat is not _NO_REMAT
        return out


class Encoder(nn.Module):
    """Positional conv + the transformer layers, the plain LayerNorm after
    them (pre-LN) or before them (post-LN, coral_tpu/models/wav2vec2.py:861-863)."""

    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(config)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(
            EncoderLayer(config, ops) for _ in range(config.num_hidden_layers)
        )
        self.dtype = config.dtype
        self.rate = config.hidden_dropout
        self.pre_ln = config.do_stable_layer_norm
        self.attention_route = config.attention_route
        self.config = config
        # Replay each layer's forward in the backward, keeping what the
        # policy names (the JAX ``nn.remat(..., policy=...)``); both are set
        # by the train setup.
        self.gradient_checkpointing = False
        self.remat_policy = "nothing_saveable"

    def forward(self, x, pad_mask, rnd: Randomness | None = None):
        # Zero padded frames first so padding cannot smear into valid frames
        # through the positional conv window.
        x = x * pad_mask[..., None].to(x.dtype)
        x = x + self.pos_conv_embed(x)
        if not self.pre_ln:
            x = _layer_norm(x, self.layer_norm, self.dtype)
        x = _dropout(x, self.rate, None if rnd is None else rnd.encoder)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        names = remat_names(self.remat_policy, self.config) if remat else frozenset()
        # o and lse go together only where the attention's backward reads lse.
        groups = (_CTX_LSE,) if self.attention_route in ("stats_v3", "stats_v2") else ()
        for i, layer in enumerate(self.layers):
            seeds = None if rnd is None else rnd.layers[i]
            if remat:
                x = torch.utils.checkpoint.checkpoint(layer, x, pad_mask, seeds,
                                                      _Remat(names, groups), use_reentrant=False)
            else:
                x = layer(x, pad_mask, seeds)
        return _layer_norm(x, self.layer_norm, self.dtype) if self.pre_ln else x


class Wav2Vec2Model(nn.Module):
    def __init__(self, config: Wav2Vec2Config, ops: _Ops) -> None:
        super().__init__()
        self.config = config
        self.feature_extractor = FeatureEncoder(config, ops)
        self.feature_projection = FeatureProjection(config)
        self.encoder = Encoder(config, ops)
        if config.apply_spec_augment:
            self.masked_spec_embed = nn.Parameter(torch.empty(config.hidden_size))

    def forward(self, input_values, input_lengths, rnd: Randomness | None = None,
                freeze_feature_encoder: bool = False):
        """(B, T) z-normalised waveforms, (B,) valid sample counts ->
        (hidden (B, T', D), frame_lengths (B,)).

        Args:
            rnd: the training forward's randomness (None: deterministic, no
                dropout and no SpecAugment).
            freeze_feature_encoder: run the conv stack without gradients.
        """
        if freeze_feature_encoder:
            with torch.no_grad():
                feats = self.feature_extractor(input_values)
        else:
            feats = self.feature_extractor(input_values)
        frame_lengths = self.config.feat_extract_output_lengths(input_lengths)
        T_out = feats.shape[1]
        pad_mask = torch.arange(T_out, device=feats.device)[None, :] < frame_lengths[:, None]
        hidden = self.feature_projection(feats, None if rnd is None else rnd.feat_proj)
        if rnd is not None:
            hidden = self.spec_augment(hidden, pad_mask, rnd)
        return self.encoder(hidden, pad_mask, rnd), frame_lengths

    def spec_augment(self, hidden, pad_mask, rnd: Randomness):
        """The JAX model's SpecAugment (``coral_tpu/models/wav2vec2.py:974-990``)."""
        cfg = self.config
        if rnd.time_starts is not None:
            tmask = span_dilate(rnd.time_starts, cfg.mask_time_length) & pad_mask
            hidden = torch.where(tmask[..., None], self.masked_spec_embed.to(hidden.dtype),
                                 hidden)
        if rnd.feature_starts is not None:
            fmask = span_dilate(rnd.feature_starts, cfg.mask_feature_length)
            hidden = torch.where(fmask[:, None, :], torch.zeros((), dtype=hidden.dtype,
                                                                device=hidden.device), hidden)
        return hidden


class Wav2Vec2ForCTC(nn.Module):
    """wav2vec2 encoder + linear CTC head producing per-frame vocab logits.

    Args:
        config: the architecture.
        plain: run every kernel's plain PyTorch version instead of the kernel,
            forward and backward, and the train step's CTC recursions too (the
            reference the kernel path is compared with).
    """

    def __init__(self, config: Wav2Vec2Config, plain: bool = False) -> None:
        super().__init__()
        self.config = config
        self.plain = plain
        ops = _PLAIN if plain else _KERNELS
        self.wav2vec2 = Wav2Vec2Model(config, ops)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size)

    def forward(self, input_values, input_lengths, deterministic: bool = True,
                freeze_feature_encoder: bool = False, generator=None):
        """(logits (B, T', V) in ``config.dtype``, frame_lengths (B,)).

        Args:
            deterministic: no dropout and no SpecAugment (serving).
            freeze_feature_encoder: run the conv stack without gradients.
            generator: the source of all randomness when not deterministic;
                everything is drawn from it here, before the model runs.
        """
        rnd = None
        if not deterministic:
            if generator is None:
                raise ValueError("a training forward (deterministic=False) needs a generator")
            B, T = input_values.shape
            frames = int(self.config.feat_extract_output_lengths(T))
            rnd = draw_randomness(self.config, B, frames, generator, input_values.device)
        hidden, frame_lengths = self.wav2vec2(
            input_values, input_lengths, rnd, freeze_feature_encoder
        )
        if rnd is not None:
            hidden = _dropout(hidden, self.config.final_dropout, rnd.final)
        return _linear(hidden, self.lm_head, self.config.dtype), frame_lengths


def _trunc_normal(w: torch.Tensor, fan_in: int, scale: float, generator) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with the flax model's distributions: he-normal convs,
    lecun-normal dense layers, zero biases, unit LayerNorm and GroupNorm scales, and
    ``masked_spec_embed`` uniform in [0, 1) (drawn last)."""
    for module in model.modules():
        if isinstance(module, nn.Conv1d):
            w = module.weight
            _trunc_normal(w, w.shape[1] * w.shape[2], 2.0, generator)
        elif isinstance(module, nn.Linear):
            _trunc_normal(module.weight, module.in_features, 1.0, generator)
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            module.weight.fill_(1.0)
        else:
            continue
        if module.bias is not None:
            module.bias.zero_()
    for module in model.modules():
        if isinstance(module, Wav2Vec2Model) and hasattr(module, "masked_spec_embed"):
            module.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)


def build_model(config: Wav2Vec2Config, device: Any, seed: int = 0) -> Wav2Vec2ForCTC:
    """A seeded, randomly initialised model on ``device`` in eval mode (the
    weights are drawn on the device itself from ``torch.Generator``)."""
    with torch.device("meta"):
        model = Wav2Vec2ForCTC(config)
    model = model.to_empty(device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    init_weights(model, generator)
    return model.eval()
