"""Published Hugging Face checkpoints, and the JAX package's weights -> this package's ``state_dict``.

The port's parameters have Hugging Face's names and layouts, so a checkpoint
of ``Wav2Vec2ForCTC`` (or ``Wav2Vec2ForPreTraining``) or
``WhisperForConditionalGeneration`` maps onto them key for key
(``wav2vec2_state_dict_from_hf``, ``whisper_state_dict_from_hf``, the
counterparts of ``coral_tpu/models/convert.py``'s ``*_params_from_torch``):
the pretraining heads are dropped, the positional conv's weight norm is
folded, Whisper's tied ``proj_out`` is checked against the token embedding
and not loaded twice, and the key set and shapes must be the model's own
exactly. ``load_torch_state_dict`` reads ``.safetensors`` (mapped, with
``safetensors_io``) or torch ``.bin`` files, whole or sharded.

The JAX bridge is the reverse of ``coral_tpu/models/convert.py``'s maps: the flax tree of
``coral_tpu.models.Wav2Vec2ForCTC`` (as numpy arrays) becomes the ``state_dict``
of ``coral_tpu_torch.models.Wav2Vec2ForCTC`` (a base model's ``group_norm``
under HF's ``conv_layers.0.layer_norm``), and the stacked tree of
``init_whisper_params`` that of ``WhisperForConditionalGeneration``. Flax stacks the scanned encoder
layers on a leading (L,) axis, keeps dense kernels as (in, out) and conv
kernels as (K, C_in/groups, C_out); the bridge unstacks the layers and
transposes to PyTorch's (out, in) and (C_out, C_in/groups, K). The q/k/v
biases stay separate vectors (the attention kernel adds them).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .safetensors_io import read_safetensors
from .wav2vec2 import Wav2Vec2Config
from .whisper import WhisperConfig

# Wav2Vec2ForPreTraining's heads, which a CTC model does not have.
_PRETRAINING_HEADS = ("quantizer.", "project_q.", "project_hid.")
_POS_CONV = "wav2vec2.encoder.pos_conv_embed.conv"
LM_HEAD = ("lm_head.weight", "lm_head.bias")


def load_torch_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A checkpoint's tensors on the CPU in the file's dtype: views of the
    mapped file for ``.safetensors``, ``torch.load(..., weights_only=True)``
    for anything else (``.bin``). A sharded checkpoint is named by its index
    (``*.index.json``, as ``save_pretrained`` writes one above its shard
    size): each shard is read once, and every key is taken from the shard
    the index's ``weight_map`` names; a key missing there raises."""
    path = Path(path)
    if path.name.endswith(".index.json"):
        weight_map: dict[str, str] = json.loads(path.read_text())["weight_map"]
        out = {}
        for shard in sorted(set(weight_map.values())):
            tensors = load_torch_state_dict(path.parent / shard)
            for key in (k for k, v in weight_map.items() if v == shard):
                if key not in tensors:
                    raise ValueError(f"{path}: {key!r} is not in its shard {shard}")
                out[key] = tensors[key]
        return out
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    return torch.load(str(path), map_location="cpu", weights_only=True)


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch's ``weight_norm(dim=2)`` folded into one conv weight in fp32:
    g v / ||v||, the norm over dims (0, 1), broadcast over the kernel axis."""
    v = v.float()
    return g.float() * v / v.square().sum(dim=(0, 1), keepdim=True).sqrt()


def _check_keys(sd: Mapping[str, torch.Tensor], model: nn.Module,
                optional: tuple[str, ...] = ()) -> None:
    """Raise ``ValueError`` naming the keys of ``sd`` that ``model`` lacks,
    the keys of ``model`` that ``sd`` lacks (``optional`` aside) and the
    shapes that differ."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd) - set(optional))
    unexpected = sorted(set(sd) - set(own))
    shapes = [f"{k}: {tuple(sd[k].shape)} for {tuple(own[k].shape)}"
              for k in sorted(set(sd) & set(own)) if sd[k].shape != own[k].shape]
    if missing or unexpected or shapes:
        raise ValueError("the checkpoint does not fit the model: "
                         f"missing {missing}, unexpected {unexpected}, shapes {shapes}")


def wav2vec2_state_dict_from_hf(state_dict: Mapping[str, torch.Tensor],
                                model: nn.Module) -> dict[str, torch.Tensor]:
    """An HF ``Wav2Vec2ForCTC`` or ``Wav2Vec2ForPreTraining`` state dict as
    ``model``'s: the pretraining heads (``quantizer``, ``project_q``,
    ``project_hid``) dropped, the positional conv's weight norm
    (``parametrizations.weight.original0/1`` or the legacy ``weight_g/v``)
    folded in fp32 on the model's device. Raises ``ValueError`` for any
    other key the model lacks or lacks from it; ``lm_head`` may be absent
    (a pretraining checkpoint), both of its tensors or neither."""
    sd = {k: v for k, v in state_dict.items() if not k.startswith(_PRETRAINING_HEADS)}
    for g_key, v_key in ((f"{_POS_CONV}.parametrizations.weight.original0",
                          f"{_POS_CONV}.parametrizations.weight.original1"),
                         (f"{_POS_CONV}.weight_g", f"{_POS_CONV}.weight_v")):
        if g_key in sd and v_key in sd:
            device = next(model.parameters()).device
            sd[f"{_POS_CONV}.weight"] = fold_weight_norm(sd.pop(g_key).to(device),
                                                         sd.pop(v_key).to(device))
            break
    if sum(k in sd for k in LM_HEAD) == 1:
        raise ValueError(f"the checkpoint holds one of {LM_HEAD} without the other")
    _check_keys(sd, model, optional=LM_HEAD)
    return sd


def whisper_state_dict_from_hf(state_dict: Mapping[str, torch.Tensor],
                               model: nn.Module) -> dict[str, torch.Tensor]:
    """An HF ``WhisperForConditionalGeneration`` state dict as ``model``'s:
    ``proj_out.weight``, where present, must equal the token embedding it is
    tied to and is not loaded twice. Raises ``ValueError`` for any other key
    the model lacks or lacks from it."""
    sd = dict(state_dict)
    proj_out = sd.pop("proj_out.weight", None)
    embed = sd.get("model.decoder.embed_tokens.weight")
    if proj_out is not None and embed is not None and not torch.equal(proj_out, embed):
        raise ValueError("proj_out.weight differs from model.decoder.embed_tokens.weight; "
                         "the model ties its LM head to the token embedding")
    _check_keys(sd, model)
    return sd


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
        # The base models' GroupNorm (block 0 only) keeps HF's name too.
        for norm in ("layer_norm", "group_norm"):
            if norm in layer:
                _layer_norm(layer[norm], f"{p}.layer_norm", sd)

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
