"""The flash backward's layout rule, its row stats and its launch order, on the CPU.

The backward kernels (``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``,
the backward mainloop of ``csrc/attention.cuh``) read q, k, v and do through
TMA tensor maps, as the forwards read q, k and v: their wrapper's check
(``flash_attention._check_bwd``, which needs no card) holds every launch to
``attention.tma_layout_error``. Here every config of ``config/model/`` passes
it at its head_dim, on separate q, k, v and on the lane thirds of one packed
projection, and views the maps cannot take are refused.

The per-row stats (m, l and the dq kernel's di, (B, H, T) fp32) are no
tensor-map operand: at T = 499 a (b, h) row is 1,996 bytes, no multiple of
16, so the dkv kernel's producer stages them with plain loads beside each
query tile, and the maps are the four operands' alone.

``flash_attention_bwd`` launches the dq wrapper first, which returns di =
rowsum(o do) as the scratch the dkv wrapper takes; on the CPU both wrappers
run their plain versions, and the pair gives the stock backward's dq, dk and
dv over the padded rows (``flash_attention_bwd_plain``) bit for bit,
unmasked and with segment ids, at every kernel head dim.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from coral_tpu_torch.ops import _build, attention, flash_attention
from coral_tpu_torch.training import model_setup as port_setup

torch.set_num_threads(1)

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "config" / "model").glob("*.yaml"))
B, T = 2, 37  # T is no multiple of the kernels' tiles


def _heads_of(path: Path) -> tuple[int, int]:
    """The attention width and head count of the architecture the setup
    infers for a config (wav2vec2's encoder, Whisper's encoder)."""
    config = {"model": yaml.safe_load(path.read_text()), "max_seconds_per_example": 10.0}
    model = port_setup.load_model_setup(config, device="cpu").model_config
    if isinstance(model, Wav2Vec2Config):
        return model.hidden_size, model.num_attention_heads
    return model.d_model, model.encoder_attention_heads


def _operands(heads: int, head_dim: int, packed: bool):
    """bf16 (B, T, heads, head_dim) q, k, v (three tensors, or the lane
    thirds of one packed projection), o and do; fp32 (B, heads, T) l, m, di."""
    width = heads * head_dim
    if packed:
        qkv = torch.empty(B, T, 3 * width, dtype=torch.bfloat16).split(width, dim=-1)
    else:
        qkv = tuple(torch.empty(B, T, width, dtype=torch.bfloat16) for _ in range(3))
    q, k, v = (t.view(B, T, heads, head_dim) for t in qkv)
    o, do = (torch.empty(B, T, heads, head_dim, dtype=torch.bfloat16) for _ in range(2))
    l, m, di = (torch.empty(B, heads, T) for _ in range(3))
    return q, k, v, o, do, l, m, di


def test_every_model_config_is_here():
    assert len(CONFIGS) == 11


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_every_config_passes_the_backward_layout_rule(path, packed):
    width, heads = _heads_of(path)
    head_dim = width // heads
    assert head_dim in attention.KERNEL_HEAD_DIMS
    q, k, v, o, do, l, m, di = _operands(heads, head_dim, packed)
    stride_b, stride_t = q.stride()[:2]
    assert attention.tma_layout_error(head_dim, stride_b, stride_t,
                                      [t.data_ptr() for t in (q, k, v)]) is None
    assert attention.tma_layout_error(head_dim, *do.stride()[:2], [do.data_ptr()]) is None
    dq_launch = flash_attention._check_bwd("bwd", q, k, v, l, m, do, None, o=o)
    dkv_launch = flash_attention._check_bwd("bwd", q, k, v, l, m, do, None, di=di)
    assert dq_launch == dkv_launch == (B, T, T, heads, stride_b, stride_t, None)


@pytest.mark.parametrize("head_dim", attention.KERNEL_HEAD_DIMS)
def test_views_the_backward_maps_cannot_take_are_refused(head_dim):
    """q, k, v one element off a 16-byte boundary, with rows one element
    longer than a multiple of 8, or a broadcast batch (stride 0), and a do
    off a 16-byte boundary, are refused by the backward's check before any
    launch; the aligned packed views beside them pass."""
    heads = 2
    q, k, v, o, do, l, m, di = _operands(heads, head_dim, False)
    width = heads * head_dim
    shape = (B, T, heads, head_dim)

    def as_heads(t):
        return t.as_strided(shape, (*t.stride()[:2], head_dim, 1))

    base = torch.empty(B, T, 3 * width + 8, dtype=torch.bfloat16)
    aligned = as_heads(base[..., 8:8 + width])
    assert flash_attention._check_bwd("bwd", aligned, aligned, aligned, l, m, do, None, o=o)
    off = as_heads(base[..., 1:1 + width])
    long_rows = as_heads(torch.empty(B, T, width + 1, dtype=torch.bfloat16)[..., :width])
    broadcast = as_heads(torch.empty(1, T, width, dtype=torch.bfloat16).expand(B, T, width))
    for bad in (off, long_rows, broadcast):
        with pytest.raises(ValueError, match="tensor maps|16-byte aligned"):
            flash_attention._check_bwd("bwd", bad, bad, bad, l, m, do, None, o=o)
        with pytest.raises(ValueError, match="tensor maps|16-byte aligned"):
            flash_attention._check_bwd("bwd", bad, bad, bad, l, m, do, None, di=di)
    do_off = torch.empty(B * T * width + 1, dtype=torch.bfloat16)[1:].view(shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention._check_bwd("bwd", q, k, v, l, m, do_off, None, di=di)
    with pytest.raises(ValueError, match=r"l, m and di must be"):
        flash_attention._check_bwd("bwd", q, k, v, l, m, do, None, di=di[:, :, 1:].contiguous())


def test_the_row_stats_at_the_training_length_are_staged_by_plain_loads():
    """At T = 499 a (b, h) row of m, l or di is 1,996 bytes: the maps' rule
    refuses it as a row stride (as bf16 columns, its 998-element width), so
    the backward encodes maps of the four operands alone and its dkv
    producer stages c = m log2 e + log2 l and di by plain loads, rows past T
    at c = +inf (p = 0) and di = 0. The short-T policies' dkv producer (K4,
    K15) stages theirs the same way: c (the lse in log2 units, or the dq
    kernel's swept m), 1 / l with m and l swept, and delta."""
    row_bytes = 499 * 4
    assert row_bytes % 16
    assert "row stride" in attention.tma_layout_error(64, 8 * row_bytes // 2, row_bytes // 2,
                                                      [0])
    text = (_build.CSRC / "attention.cuh").read_text()
    bwd = text[text.index("namespace bwd {"):text.index("}  // namespace bwd")]
    maps = re.search(r"struct Maps \{(.*?)\};", bwd, re.S)[1]
    assert re.findall(r"CUtensorMap (.*?);", maps) == ["res[2][2], str[2][2]"]
    assert "w[0] = __float_as_uint(row_c(a, b, h, q));" in bwd
    assert "w[1] = __float_as_uint(in ? a.di[stat + q] : 0.0f);" in bwd
    assert "if (t >= a.T) return INFINITY;" in bwd
    assert ("w[0] = __float_as_uint(P::kML ? (in ? a.row_m[stat + q] : INFINITY)\n"
            "                                          : row_lse(a, b, h, q));") in bwd
    assert ("if constexpr (P::kML) w[1] = __float_as_uint(in ? 1.0f / a.row_l[stat + q] : "
            "1.0f);") in bwd
    assert "w[kVecs - 1] = __float_as_uint(in ? a.di[stat + q] : 0.0f);" in bwd
    assert "return a.lse[((long long)b * a.H + h) * a.T + t] * fwd::kLog2e;" in bwd


@pytest.mark.parametrize("segments", [False, True], ids=["unmasked", "segment_ids"])
@pytest.mark.parametrize("d", attention.KERNEL_HEAD_DIMS)
def test_the_reordered_backward_is_the_plain_backward(monkeypatch, d, segments):
    """``flash_attention_bwd`` calls the dq wrapper, then the dkv wrapper
    with the dq wrapper's di (rowsum(o do), fp32 (B, H, T)); on the CPU the
    pair gives the stock backward's dq, dk and dv over the padded rows bit
    for bit, with segment ids over the padded call's 128-row grid too."""
    rng = np.random.default_rng(d + segments)
    Tn, H = 70, 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, Tn, H, d)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    ids = None
    if segments:
        ids = flash_attention.segment_ids(torch.arange(Tn)[None, :] < torch.tensor([Tn, 1])[:, None])
        assert ids.shape == (B, 128)
    o, l, m = flash_attention.flash_attention_fwd(q, k, v, ids)
    calls = []
    dq_wrapper, dkv_wrapper = flash_attention.flash_attention_bwd_dq, \
        flash_attention.flash_attention_bwd_dkv

    def dq_spy(*args):
        calls.append("dq")
        out = dq_wrapper(*args)
        calls.append(out[1])
        return out

    def dkv_spy(q_, k_, v_, l_, m_, do_, di, ids_):
        calls.append("dkv")
        assert di is calls[1]
        return dkv_wrapper(q_, k_, v_, l_, m_, do_, di, ids_)

    monkeypatch.setattr(flash_attention, "flash_attention_bwd_dq", dq_spy)
    monkeypatch.setattr(flash_attention, "flash_attention_bwd_dkv", dkv_spy)
    got = flash_attention.flash_attention_bwd(q, k, v, o, l, m, do, ids)
    assert [c for c in calls if isinstance(c, str)] == ["dq", "dkv"]
    di = calls[1]
    assert di.shape == (B, H, Tn) and di.dtype == torch.float32
    assert torch.equal(di, (o.transpose(1, 2).float() * do.transpose(1, 2).float()).sum(-1))
    # The stock call on the padded rows (do = 0, l = 1, m = +inf there),
    # sliced: the di the pair slices and pads again changes no bit.
    Tp = Tn if ids is None else ids.shape[1]
    pad = lambda t, value=0.0: torch.nn.functional.pad(t, (0, Tp - Tn), value=value)  # noqa: E731
    rows = lambda t: flash_attention._pad_rows(t, Tp)  # noqa: E731
    want = [g[:, :Tn] for g in flash_attention.flash_attention_bwd_plain(
        rows(q), rows(k), rows(v), rows(o), pad(l, 1.0), pad(m, float("inf")), rows(do), ids)]
    for g, w in zip(got, want):
        assert g.shape == (B, Tn, H, d) and g.dtype == torch.bfloat16
        assert torch.equal(g, w)
