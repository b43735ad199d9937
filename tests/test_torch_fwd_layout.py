"""The attention forwards' layout rule and design variants, on the CPU.

The forward kernels (``attention_fwd_kernel`` and ``flash_fwd_kernel``) read
q, k and v through TMA tensor maps, which see a (B, T, H*d) bf16 tensor as the
4-D tensor (d, H, T, B). Their wrappers hold every launch to the maps' rule,
``attention.tma_layout_error``: a 16-byte aligned base, and 2 head_dim, 2
stride_t and 2 stride_b positive multiples of 16 bytes. Here every config of
``config/model/`` passes it at its head_dim, on separate q, k, v and on the
lane thirds of one packed projection, and views the maps cannot take are
refused by both wrappers' checks (which need no card: they run before the
launch). Each design variant of ``coral_tpu_torch.tools.fwd_variants`` still
applies to the mainloop's source, so that the card tool measures what it
names.
"""

from pathlib import Path

import pytest
import torch
import yaml

from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from coral_tpu_torch.ops import _build, attention, flash_attention
from coral_tpu_torch.tools import fwd_variants
from coral_tpu_torch.training import model_setup as port_setup

torch.set_num_threads(1)

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "config" / "model").glob("*.yaml"))
B, T = 2, 37  # T is no multiple of the kernels' tiles


def _width_and_heads(path: Path) -> tuple[int, int]:
    """The attention width and head count of the architecture the setup
    infers for a config (wav2vec2's encoder, Whisper's encoder)."""
    config = {"model": yaml.safe_load(path.read_text()), "max_seconds_per_example": 10.0}
    model = port_setup.load_model_setup(config, device="cpu").model_config
    if isinstance(model, Wav2Vec2Config):
        return model.hidden_size, model.num_attention_heads
    return model.d_model, model.encoder_attention_heads


def _qkv(width: int, packed: bool):
    """bf16 (B, T, width) q, k, v: three tensors, or the lane thirds of one
    (B, T, 3 width) projection."""
    if packed:
        return torch.empty(B, T, 3 * width, dtype=torch.bfloat16).split(width, dim=-1)
    return tuple(torch.empty(B, T, width, dtype=torch.bfloat16) for _ in range(3))


def _rule(q, k, v, head_dim):
    stride_b, stride_t, _ = q.stride()
    return attention.tma_layout_error(head_dim, stride_b, stride_t,
                                      [t.data_ptr() for t in (q, k, v)])


def test_every_model_config_is_here():
    assert len(CONFIGS) == 11


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_every_config_passes_the_layout_rule(path, packed):
    width, heads = _width_and_heads(path)
    head_dim = width // heads
    assert head_dim in attention.KERNEL_HEAD_DIMS
    q, k, v = _qkv(width, packed)
    assert _rule(q, k, v, head_dim) is None
    key_bias = torch.zeros(B, T)
    assert attention._check("fwd", q, k, v, None, None, None, key_bias, head_dim)[:3] == (
        B, T, heads)
    view = lambda t: t.view(B, T, heads, head_dim)  # noqa: E731
    assert flash_attention._check("fwd", view(q), view(k), view(v))[:3] == (B, T, heads)


@pytest.mark.parametrize("head_dim", attention.KERNEL_HEAD_DIMS)
def test_views_the_tensor_maps_cannot_take_are_refused(head_dim):
    """A view one element off a 16-byte boundary, rows one element longer
    than a multiple of 8, and a broadcast batch (stride 0) are refused, by
    the rule and by both wrappers' checks; the aligned views beside them
    pass."""
    width = 2 * head_dim
    base = torch.empty(B, T, 3 * width + 8, dtype=torch.bfloat16)
    aligned = base[..., 8:8 + width]
    assert _rule(aligned, aligned, aligned, head_dim) is None
    off = base[..., 1:1 + width]
    assert "16-byte aligned" in _rule(off, off, off, head_dim)
    long_rows = torch.empty(B, T, width + 1, dtype=torch.bfloat16)[..., :width]
    assert "row stride is" in _rule(long_rows, long_rows, long_rows, head_dim)
    broadcast = torch.empty(1, T, width, dtype=torch.bfloat16).expand(B, T, width)
    assert "batch stride is 0 bytes" in _rule(broadcast, broadcast, broadcast, head_dim)
    key_bias = torch.zeros(B, T)
    for bad in (off, long_rows, broadcast):
        with pytest.raises(ValueError, match="tensor maps|16-byte aligned"):
            attention._check("fwd", bad, bad, bad, None, None, None, key_bias, head_dim)
        heads = bad.as_strided((B, T, 2, head_dim), (*bad.stride()[:2], head_dim, 1))
        with pytest.raises(ValueError, match="tensor maps|16-byte aligned"):
            flash_attention._check("fwd", heads, heads, heads)


def test_a_head_dim_the_maps_cannot_stride_is_refused():
    """head_dim 4 (8 bytes) is no multiple of 16 bytes: the rule says so
    whatever the row strides."""
    q = torch.empty(B, T, 64, dtype=torch.bfloat16)
    assert "head_dim is 8 bytes" in _rule(q, q, q, 4)


@pytest.mark.parametrize("name", sorted(fwd_variants.VARIANTS))
def test_each_design_variant_applies_to_the_mainloop(name):
    """Every text a variant substitutes occurs once in ``attention.cuh``, and
    the variant changes it; a text that is not there raises."""
    text = (_build.CSRC / "attention.cuh").read_text()
    assert fwd_variants.variant_source(text, name) != text
    with pytest.raises(ValueError, match="occurs 0 times"):
        fwd_variants.variant_source(text.replace("consumers", "renamed"), "two_consumers")
