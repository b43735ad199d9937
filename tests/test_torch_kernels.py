"""coral_tpu_torch's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
without one. The file imports neither JAX nor the JAX package, so that it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Inputs are made by numpy from a seed, at the real widths (C = 512/1024,
head_dim 64, D = 1024) and short lengths, in bf16: the point is the kernel.
Tolerance: |kernel - plain| <= atol + rtol |plain| with rtol = 2**-6, two bf16
ulps of the output: both sides compute in fp32 and round once to bf16, and a
reordered fp32 sum can move that rounding by one ulp. atol covers values near
zero (1e-2; attention 8e-3, twice the largest error measured at the serving
shapes, 2**-8, which its bf16 probabilities rounded against the running rather
than the final row max cause).
"""

import numpy as np
import pytest
import torch

from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import _build, attention, conv_ln_gelu, ffn, ln_gelu

pytestmark = pytest.mark.cuda
RTOL_BF16 = 2.0**-6


def _np(*shape, seed, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(
        np.float32
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on(cuda, a, dtype=torch.float32):
    return torch.from_numpy(a).to(cuda, dtype)


def _close(got, want, atol):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = atol + RTOL_BF16 * want.float().abs()
    assert torch.isfinite(got.float()).all()
    assert (err <= bound).all(), f"max err {err.max().item()}"


@pytest.mark.parametrize("C", [512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("apply_gelu", [True, False])
def test_ln_kernel_matches_plain(cuda, C, dtype, apply_gelu):
    x = _on(cuda, _np(3, 333, C, seed=0, scale=2.0), dtype)
    gamma = _on(cuda, _np(C, seed=1, scale=0.1, offset=1.0))
    beta = _on(cuda, _np(C, seed=2, scale=0.1))
    fn = ln_gelu.ln_gelu if apply_gelu else ln_gelu.ln_fused
    _close(fn(x, gamma, beta), ln_gelu.ln_gelu_plain(x, gamma, beta, apply_gelu=apply_gelu),
           1e-2)


@pytest.mark.parametrize("k,T_in", [(3, 1001), (2, 258), (3, 3)])
def test_conv_kernel_matches_plain(cuda, k, T_in):
    C = 512
    x = _on(cuda, _np(2, T_in, C, seed=0), torch.bfloat16)
    w = _on(cuda, _np(C, C, k, seed=1, scale=0.05), torch.bfloat16)
    b, gamma, beta = (_on(cuda, _np(C, seed=s, scale=0.1, offset=o))
                      for s, o in ((2, 0.0), (3, 1.0), (4, 0.0)))
    y = conv_ln_gelu.conv_ln_gelu(x, w, b, gamma, beta)
    assert y.shape == (2, (T_in - k) // 2 + 1, C)
    _close(y, conv_ln_gelu.conv_ln_gelu_plain(x, w, b, gamma, beta), 1e-2)


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
def test_attention_kernel_matches_plain(cuda, packed):
    B, T, H, d = 3, 150, 2, 64
    q, k, v = (_np(B, T, H * d, seed=i) for i in range(3))
    if packed:  # slices of one (B, T, 3HD) tensor: strided rows
        qkv = _on(cuda, np.concatenate([q, k, v], axis=-1), torch.bfloat16)
        q, k, v = qkv.split(H * d, dim=-1)
    else:
        q, k, v = (_on(cuda, a, torch.bfloat16) for a in (q, k, v))
    qkv_bias = tuple(_on(cuda, _np(H * d, seed=3 + i, scale=0.5)) for i in range(3))
    mask = np.ones((B, T), bool)
    mask[1, 80:] = False
    mask[2, :] = False  # a fully padded row
    mask = torch.from_numpy(mask).to(cuda)
    o, lse = attention.short_t_attention_flat(q, k, v, mask, d, qkv_bias)
    want_o, want_lse = attention.attention_plain(q, k, v, mask, d, qkv_bias)
    _close(o, want_o, 8e-3)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    assert (lse[2] == -1e25).all()


def test_ffn_kernel_matches_plain(cuda):
    D, F = 1024, 512
    x = _on(cuda, _np(2, 75, D, seed=0), torch.bfloat16)
    w1 = _on(cuda, _np(F, D, seed=1, scale=0.03), torch.bfloat16)
    b1 = _on(cuda, _np(F, seed=2, scale=0.1))
    gamma = _on(cuda, _np(D, seed=3, scale=0.1, offset=1.0))
    beta = _on(cuda, _np(D, seed=4, scale=0.1))
    _close(ffn.ffn_ln_fc1(x, w1, b1, gamma, beta),
           ffn.ffn_ln_fc1_plain(x, w1, b1, gamma, beta), 1e-2)


def test_launches_are_counted(cuda):
    _build.reset_launch_counts()
    x = torch.zeros(1, 4, 512, device=cuda)
    ln_gelu.ln_gelu(x, torch.ones(512, device=cuda), torch.zeros(512, device=cuda))
    ln_gelu.ln_fused(x, torch.ones(512, device=cuda), torch.zeros(512, device=cuda))
    assert _build.launch_counts == {"ln_gelu": 1, "ln_fused": 1}


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(2, 10, 256, device=cuda)
    with pytest.raises(ValueError, match="C in"):
        ln_gelu.ln_gelu(x, torch.ones(256, device=cuda), torch.zeros(256, device=cuda))
    x = torch.zeros(2, 10, 512, device=cuda)  # fp32: the conv kernel takes bf16
    with pytest.raises(TypeError):
        conv_ln_gelu.conv_ln_gelu(x, torch.zeros(512, 512, 3, device=cuda),
                                  *(torch.zeros(512, device=cuda),) * 3)


def test_ffn_of_a_width_the_kernel_does_not_take_raises_on_the_card(cuda):
    """The tiny config's 32-wide FFN: the model calls the kernel's wrapper,
    which raises on the card rather than running the plain version."""
    model = Wav2Vec2ForCTC(Wav2Vec2Config.tiny()).to(cuda).eval()
    layer = model.wav2vec2.encoder.layers[0]
    x = torch.zeros(1, 4, 32, device=cuda, dtype=torch.bfloat16)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="the kernel takes D"):
        layer.feed_forward(x, layer.final_layer_norm)
    assert not _build.launch_counts
