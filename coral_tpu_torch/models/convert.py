"""The JAX package's wav2vec2 and Whisper weights -> this package's ``state_dict``.

The reverse of ``coral_tpu/models/convert.py``'s maps: the flax tree of
``coral_tpu.models.Wav2Vec2ForCTC`` (as numpy arrays) becomes the ``state_dict``
of ``coral_tpu_torch.models.Wav2Vec2ForCTC``, and the stacked tree of
``init_whisper_params`` that of ``WhisperForConditionalGeneration``. Flax stacks the scanned encoder
layers on a leading (L,) axis, keeps dense kernels as (in, out) and conv
kernels as (K, C_in/groups, C_out); the bridge unstacks the layers and
transposes to PyTorch's (out, in) and (C_out, C_in/groups, K). The q/k/v
biases stay separate vectors (the attention kernel adds them).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .wav2vec2 import Wav2Vec2Config
from .whisper import WhisperConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _dense(tree: Mapping[str, Any], prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _layer_norm(tree: Mapping[str, Any], prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _conv(tree: Mapping[str, Any], prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["conv_kernel"]).transpose(2, 1, 0))
    if "conv_bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["conv_bias"])


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a tree whose leaves are stacked on a leading axis."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def wav2vec2_state_dict_from_jax(
    params: Mapping[str, Any], config: Wav2Vec2Config
) -> dict[str, torch.Tensor]:
    """Convert ``coral_tpu`` ``Wav2Vec2ForCTC`` params to this package's
    ``state_dict`` (fp32 CPU tensors), ``masked_spec_embed`` (SpecAugment's
    fill vector) included where the tree has one."""
    sd: dict[str, torch.Tensor] = {}
    w2v = params["wav2vec2"]
    if "masked_spec_embed" in w2v:
        sd["wav2vec2.masked_spec_embed"] = _t(w2v["masked_spec_embed"])

    fe = w2v["feature_extractor"]
    for i in range(len(config.conv_dim)):
        layer = fe[f"conv_layers_{i}"]
        p = f"wav2vec2.feature_extractor.conv_layers.{i}"
        _conv(layer, f"{p}.conv", sd)
        _layer_norm(layer["layer_norm"], f"{p}.layer_norm", sd)

    proj = w2v["feature_projection"]
    _layer_norm(proj["layer_norm"], "wav2vec2.feature_projection.layer_norm", sd)
    _dense(proj["projection"], "wav2vec2.feature_projection.projection", sd)

    enc = w2v["encoder"]
    _conv(enc["pos_conv_embed"], "wav2vec2.encoder.pos_conv_embed.conv", sd)
    _layer_norm(enc["layer_norm"], "wav2vec2.encoder.layer_norm", sd)
    for i in range(config.num_hidden_layers):
        layer = _layer(enc["layers"], i)
        p = f"wav2vec2.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(layer["attention"][name], f"{p}.attention.{name}", sd)
        _layer_norm(layer["layer_norm"], f"{p}.layer_norm", sd)
        _layer_norm(layer["final_layer_norm"], f"{p}.final_layer_norm", sd)
        for name in ("intermediate_dense", "output_dense"):
            _dense(layer["feed_forward"][name], f"{p}.feed_forward.{name}", sd)

    _dense(params["lm_head"], "lm_head", sd)
    return sd


def whisper_state_dict_from_jax(
    params: Mapping[str, Any], config: WhisperConfig
) -> dict[str, torch.Tensor]:
    """Convert ``coral_tpu`` ``init_whisper_params``' tree (stacked layers) to
    this package's ``WhisperForConditionalGeneration`` ``state_dict`` (fp32
    CPU tensors): layers unstacked, dense kernels (in, out) -> (out, in), conv
    kernels (K, C_in, C_out) -> (C_out, C_in, K), ``k_proj`` without a bias."""
    sd: dict[str, torch.Tensor] = {}
    enc, dec = params["encoder"], params["decoder"]
    for name in ("conv1", "conv2"):
        sd[f"model.encoder.{name}.weight"] = _t(
            np.asarray(enc[name]["kernel"]).transpose(2, 1, 0))
        sd[f"model.encoder.{name}.bias"] = _t(enc[name]["bias"])
    sd["model.encoder.embed_positions.weight"] = _t(enc["embed_positions"])
    sd["model.decoder.embed_tokens.weight"] = _t(dec["embed_tokens"])
    sd["model.decoder.embed_positions.weight"] = _t(dec["embed_positions"])
    for side, tree, n_layers, attns in (
        ("encoder", enc, config.encoder_layers, ("self_attn",)),
        ("decoder", dec, config.decoder_layers, ("self_attn", "encoder_attn")),
    ):
        _layer_norm(tree["layer_norm"], f"model.{side}.layer_norm", sd)
        for i in range(n_layers):
            layer = _layer(tree["layers"], i)
            p = f"model.{side}.layers.{i}"
            for attn in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    _dense(layer[attn][proj], f"{p}.{attn}.{proj}", sd)
                _layer_norm(layer[f"{attn}_layer_norm"], f"{p}.{attn}_layer_norm", sd)
            for fc in ("fc1", "fc2"):
                _dense(layer[fc], f"{p}.{fc}", sd)
            _layer_norm(layer["final_layer_norm"], f"{p}.final_layer_norm", sd)
    return sd
