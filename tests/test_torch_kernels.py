"""coral_tpu_torch's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
without one. The file imports neither JAX nor the JAX package, so that it runs
where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Inputs are made by numpy from a seed, at the real widths (every width of the
repository's configs: C and D = 384 to 1920, head_dim 64, 80 and 120) and
short lengths whose rows are not a multiple of the kernels' row tiles, in
bf16: the point is the kernel.
Tolerance: |kernel - plain| <= atol + rtol |plain| with rtol = 2**-6, two bf16
ulps of the output: both sides compute in fp32 and round once to bf16, and a
reordered fp32 sum can move that rounding by one ulp. atol covers values near
zero (1e-2; attention 8e-3, twice the largest error measured at the serving
shapes, 2**-8, which its bf16 probabilities rounded against the running rather
than the final row max cause).

The backward kernels and the dropout variants: gradients that are sums over
many rows are held at ``atol = 2e-2 max|plain|`` on top of the two-ulp rtol
(bf16 operands whose rounding may move by one ulp between the kernel's and
torch's fp32 products, summed over up to 4096 terms); fp32 partial sums
(dgamma, dbeta, db1, the bias gradients) at 1e-2 of their largest value; the
CTC recursions, fp32 end to end, at rtol 1e-5 and atol 1e-3 (log-probs of
order 100, summed in the same order). Dropout masks are compared exactly:
kernel and plain draw the same Philox bits.

Whisper's attention kernels: the encoder's flash attention at 8e-3 as the
wav2vec2 attention (bf16 probabilities rounded against the running max), its
row stats m and l (fp32 on both sides, sums in another order) at rtol 1e-5,
its backward's dq, dk and dv as the other gradients; the decode kernels at
4e-3, which keep the probabilities in fp32 where the plain version (the JAX
composition) rounds them to bf16 before p @ v: at most 2**-9 of each term,
summed over keys whose weights add to 1. At every Whisper head count and
cache phase (``-k decode``) the decode kernels are held to 2**-9 max|v| plus
two bf16 ulps against the plain version, and to one bf16 ulp plus 1e-5
against the same arithmetic with p in fp32; two calls give the same bits,
the profiler sees one device kernel a call, and a CUDA graph that captured
both wrappers replays their bits.

The attention's other routes (``save_stats`` false, with ``o_residual``,
true and "v2") at head_dim 64, 80 and 120 as the v3 kernels, on separate and
packed q, k, v; the fully padded row gets no gradient on the stats routes and
the uniform average's on the others; the forward without stats writes the v2
forward's o bit for bit.

The unfused routes: the flash kernels with segment ids as the unmasked ones,
against the plain versions through the padded call, at head_dim 64, 80 and
120; the GELU+dropout kernel at rtol 2**-6 and atol 1e-2 as the other row
kernels, its masks exact.

K3, the feature encoder's conv block (``-k "conv or fe_bwd"``): the serving
and training forwards and the backward at T_out 63 to 129 around the
forward's 128-row tiles and dW's 64-row chunks, from odd and even T_in, with
B = 3 where one batch row's last tile meets the next one's rows, at the
tolerances above; input rows no output reads get dx = 0; one launch a call;
dx, dW and dvec the same bits over two calls (dW's row ranges and dvec's
partials summed in a fixed order), the forwards too.

The probes (``coral_tpu_torch/tools``): the K3 backward's modes as the
production backward's gradients (``full`` bit for bit its kernels' output);
the gelu_cost and lane_reduce kernels' bf16 outputs as the other rounded
outputs, the mask exact.

The packed QKV projection of ``fused_qkv_ln`` (``ln_dense``, D 1024, 1280 and
1920, F = 3 D, at 1920 a 128-column tail): y and ln_out as the other rounded
outputs, dx as the other gradients, db, dgamma and dbeta as fp32 partial
sums; the backward's ln_out is the forward's product operand bit for bit
(through three stacked identities and b = 0, y is that operand); the
forward one device kernel a call, the FFN mainloop's.

K6, the CTC recursions (``-k ctc``), at the training shape (T' 499, B 8, S
257), at S on each side of a warp's 32 and 64 states, at 1,025 (two states
a thread) and at 6,143 (six): alpha and beta at rtol 1e-5 and atol 1e-3 as
above, one launch and one device kernel a call, the same bits on two calls
and from a contiguous copy of the emissions. The attention without in-kernel biases at head_dim 64, 80 and 120 as
the biased one, and bit for bit the biased kernels' output at zero biases.

The forwards' Hopper mainloop (``attention.cuh``): every instantiation of
``attention_fwd_kernel`` and ``flash_fwd_kernel`` at head_dim 64, 80 and 120
and T around its 128-row and 128-key tiles (1 to 1500), separate and packed,
against the plain versions at the tolerances above. The backward mainloop:
``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel`` likewise, at T around
their 32-, 64- and 128-row tiles, with and without segment ids; the dq
launch's di against the plain rowsum at 1e-5 of its max; two launches give
the same bits. Run them with ``-k flash``. The short-T backwards on the same
mainloop (``attention_bwd_dq_kernel`` and ``attention_bwd_dkv_kernel``, every
route, with and without the q/k/v biases) likewise, separate and packed, the
packed gradient bit for bit the separate one's: ``-k mainloop``.

The FFN mainloop (``csrc/ffn_gemm.cuh``: K5's forward and backward, N1-N5
and dl) at every width on 3 x 131 rows (a ragged last 128-row tile), at the
FFN bounds above, masks exact and the backwards' g the forward's bit for
bit; Whisper large-v3's encoder rows, where a block takes several column
tiles; the same bits on two calls of each backward, db1 included; the
device kernels a call (in a process of its own); nothing written past row
M; and F not a multiple of 256 or an unbuilt width refused: ``-k ffn``.
N7 (``csrc/ffn_ln_fc2.cu``, a thread-block cluster a 128-row tile) and N6's
dW kernel (``gemm::atb``) at every width and both rates on ragged rows (M <
128, not a multiple of 128), y as the other rounded outputs and dW1, dW2 on
N5's own operands at 1e-3 of their max, the same bits on a second call, the
cluster size and its occupancy, N7 one device kernel a call: ``-k
"ffn_ln_fc2 or ffn_ln_dw"``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import (_build, attention, conv_ln_gelu, ctc, decode_attention, ffn,
                                 flash_attention, gelu_dropout, ln_gelu, philox)
from coral_tpu_torch.tools import probe_fe_bwd, probe_gelu_cost, probe_lane_reduce

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
RTOL_BF16 = 2.0**-6
# The kernel flags the setups resolve by default (the model config's own
# defaults are the JAX dataclass's).
SETUP_FLAGS = dict(attention_save_stats="v3", attention_fused_qkv_bias=True, fused_ffn=True,
                   fused_ffn_ln=True, fused_ffn_block=True, fused_ffn_block_dg=True)


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


# K3's (k, T_in, B): T_out (T_in - k) // 2 + 1 around the forward's 128-row
# tiles and the dW chunks' 64 (63, 64, 65, 127, 128, 129), from odd and even
# T_in, B > 1 where one batch row's last tile meets the next one's rows.
CONV_EDGES = [(3, 127, 2), (3, 130, 3), (3, 131, 2), (3, 256, 2), (3, 257, 3), (3, 260, 2),
              (2, 126, 3), (2, 129, 2), (2, 130, 2), (2, 255, 2), (2, 256, 3), (2, 258, 2)]


@pytest.mark.parametrize("k,T_in,B", [(3, 1001, 2), (2, 258, 2), (3, 3, 2), *CONV_EDGES])
def test_conv_kernel_matches_plain(cuda, k, T_in, B):
    C = 512
    x = _on(cuda, _np(B, T_in, C, seed=0), torch.bfloat16)
    w = _on(cuda, _np(C, C, k, seed=1, scale=0.05), torch.bfloat16)
    b, gamma, beta = (_on(cuda, _np(C, seed=s, scale=0.1, offset=o))
                      for s, o in ((2, 0.0), (3, 1.0), (4, 0.0)))
    y = conv_ln_gelu.conv_ln_gelu(x, w, b, gamma, beta)
    assert y.shape == (B, (T_in - k) // 2 + 1, C)
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


ALL_D = [384, 512, 768, 1024, 1280, 1920]


@pytest.mark.parametrize("D", ALL_D)
def test_ffn_kernel_matches_plain(cuda, D):
    F = 512
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
    model = Wav2Vec2ForCTC(Wav2Vec2Config.tiny(**SETUP_FLAGS)).to(cuda).eval()
    layer = model.wav2vec2.encoder.layers[0]
    x = torch.zeros(1, 4, 32, device=cuda, dtype=torch.bfloat16)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="the kernel takes D"):
        layer.feed_forward(x, layer.final_layer_norm)
    assert not _build.launch_counts


@pytest.mark.parametrize("flags", [{"fused_ffn_ln": False}, {"fused_ffn_block": False},
                                   {"fused_ffn_ln": False, "fused_ffn_block": False}],
                         ids=["ffn_block", "ffn_ln_fc1", "ffn_fc1"])
def test_ffn_routes_of_a_width_the_kernels_do_not_take_raise_on_the_card(cuda, flags):
    """The tiny config's 32-wide FFN on the routes without the block or the
    folded LayerNorm: the wrappers raise on the card, nothing launches."""
    model = Wav2Vec2ForCTC(Wav2Vec2Config.tiny(**{**SETUP_FLAGS, **flags})).to(cuda).eval()
    layer = model.wav2vec2.encoder.layers[0]
    x = torch.zeros(1, 4, 32, device=cuda, dtype=torch.bfloat16)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="the kernel takes D"):
        layer.feed_forward(x, layer.final_layer_norm)
    assert not _build.launch_counts


def _close_rel(got, want, frac=2e-2):
    """|got - want| <= frac max|want| + rtol |want|: gradients summed over rows."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    bound = frac * want.abs().max() + RTOL_BF16 * want.abs()
    assert (err <= bound).all(), f"max err {err.max().item()} vs max {want.abs().max().item()}"


@pytest.mark.parametrize("C", [512, 1024, 1280])
@pytest.mark.parametrize("dtypes", ["bf16/bf16", "bf16/fp32", "fp32/fp32"])
@pytest.mark.parametrize("apply_gelu", [True, False])
def test_ln_bwd_kernel_matches_plain(cuda, C, dtypes, apply_gelu):
    xd, dyd = (torch.bfloat16 if d == "bf16" else torch.float32 for d in dtypes.split("/"))
    x = _on(cuda, _np(3, 333, C, seed=0, scale=2.0, offset=0.3), xd)
    dy = _on(cuda, _np(3, 333, C, seed=1), dyd)
    gamma = _on(cuda, _np(C, seed=2, scale=0.1, offset=1.0))
    beta = _on(cuda, _np(C, seed=3, scale=0.1))
    _build.reset_launch_counts()
    got = ln_gelu.ln_bwd(x, gamma, beta, dy, apply_gelu=apply_gelu)
    assert _build.launch_counts == {"ln_bwd_1280" if C == 1280 else "ln_bwd": 1}
    want = ln_gelu.ln_bwd_plain(x, gamma, beta, dy, apply_gelu=apply_gelu)
    assert got[0].dtype == xd
    _close(got[0], want[0], 1e-2)
    for g, w in zip(got[1:], want[1:]):
        _close_rel(g, w, 1e-2)


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
def test_attention_bwd_kernel_matches_plain(cuda, packed):
    B, T, H, d = 3, 150, 2, 64
    q, k, v = (_np(B, T, H * d, seed=i) for i in range(3))
    if packed:
        qkv = _on(cuda, np.concatenate([q, k, v], axis=-1), torch.bfloat16)
        q, k, v = qkv.split(H * d, dim=-1)
    else:
        q, k, v = (_on(cuda, a, torch.bfloat16) for a in (q, k, v))
    bq, bk, bv = (_on(cuda, _np(H * d, seed=3 + i, scale=0.5), torch.bfloat16) for i in range(3))
    mask = np.ones((B, T), bool)
    mask[1, 80:] = False
    mask[2, :] = False  # a fully padded row: p = 0 in the backward
    key_bias = torch.where(torch.from_numpy(mask).to(cuda), 0.0, -1e30).float()
    o, lse = attention._fwd(q, k, v, bq, bk, bv, key_bias, d, 0.125)
    do = _on(cuda, _np(B, T, H * d, seed=7), torch.bfloat16)
    _build.reset_launch_counts()
    got = attention.attention_bwd(q, k, v, bq, bk, bv, key_bias, do, lse, o, d, 0.125)
    assert _build.launch_counts == {"attention_bwd": 1}
    want = attention.attention_bwd_plain(q, k, v, bq, bk, bv, key_bias, do, lse, o, d, 0.125)
    for g, w in zip(got[:3], want[:3]):
        _close_rel(g, w)
        assert not g[2].any()  # the fully masked row gets no gradient
    _close_rel(got[3], want[3], 1e-2)


def _ffn_inputs(cuda, F=512, T=75, D=1024):
    x = _on(cuda, _np(2, T, D, seed=0, offset=0.2), torch.bfloat16)
    w1 = _on(cuda, _np(F, D, seed=1, scale=0.03), torch.bfloat16)
    b1 = _on(cuda, _np(F, seed=2, scale=0.1))
    gamma = _on(cuda, _np(D, seed=3, scale=0.1, offset=1.0))
    beta = _on(cuda, _np(D, seed=4, scale=0.1))
    w2 = _on(cuda, _np(D, F, seed=5, scale=0.03), torch.bfloat16)
    dy = _on(cuda, _np(2, T, D, seed=6), torch.bfloat16)
    seeds = torch.tensor([12345, -7], dtype=torch.int32, device=cuda)
    return x, w1, b1, gamma, beta, w2, dy, seeds


@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_dropout_kernel_matches_plain(cuda, rate, D):
    x, w1, b1, gamma, beta, _, _, seeds = _ffn_inputs(cuda, D=D)
    _build.reset_launch_counts()
    g = ffn.ffn_ln_fc1(x, w1, b1, gamma, beta, rate=rate, seeds=seeds)
    name = "ffn_ln_drop" if rate else "ffn_ln"
    assert _build.launch_counts == {name if D == 1024 else f"{name}_{D}": 1}
    want = ffn.ffn_ln_fc1_plain(x, w1, b1, gamma, beta, rate=rate, seeds=seeds)
    _close(g, want, 1e-2)
    if rate:
        keep = philox.keep_mask(seeds, x.shape[1], w1.shape[0], rate)
        assert torch.equal(g != 0, keep)  # the same Philox bits in CUDA and torch
        frac = keep.float().mean().item()
        assert abs(frac - (1 - rate)) < 0.01


@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_bwd_kernel_matches_plain(cuda, rate, D):
    """150 rows: a ragged last tile of 64 rows (of 32 at D = 1920)."""
    x, w1, b1, gamma, beta, w2, dy, seeds = _ffn_inputs(cuda, D=D)
    _build.reset_launch_counts()
    got = ffn.ffn_bwd(x, w1, b1, gamma, beta, dy, w2, rate=rate, seeds=seeds)
    tail = "" if D == 1024 else f"_{D}"
    ln_tail = "" if D in (512, 1024) else f"_{D}"
    assert _build.launch_counts == {f"ffn_bwd{tail}": 1, f"ln_bwd{ln_tail}": 1}
    want = ffn.ffn_bwd_plain(x, w1, b1, gamma, beta, dy, w2, rate=rate, seeds=seeds)
    g_fwd = ffn.ffn_ln_fc1(x, w1, b1, gamma, beta, rate=rate, seeds=seeds)
    assert torch.equal(got[0], g_fwd)  # the backward regenerates the forward's g
    if rate:  # dh is zero exactly where the forward dropped g
        keep = philox.keep_mask(seeds, x.shape[1], w1.shape[0], rate)
        assert not got[1][~keep].any()
    _close(got[0], want[0], 1e-2)
    _close(got[2], want[2], 1e-2)
    for g, w in zip(got[1:2] + got[3:4], want[1:2] + want[3:4]):
        _close_rel(g, w)
    for g, w in zip(got[4:], want[4:]):
        _close_rel(g, w, 1e-2)


@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_fc1_kernel_matches_plain(cuda, rate, D):
    """fc1 without the LayerNorm (N1), 150 rows: a ragged last row tile."""
    x, w1, b1, _, _, _, _, seeds = _ffn_inputs(cuda, D=D)
    _build.reset_launch_counts()
    g = ffn.ffn_fc1_fwd(x, w1, b1, rate=rate, seeds=seeds)
    assert _build.launch_counts == {ffn._name("ffn_fc1_drop" if rate else "ffn_fc1", D): 1}
    _close(g, ffn.ffn_fc1_plain(x, w1, b1, rate=rate, seeds=seeds), 1e-2)
    if rate:
        keep = philox.keep_mask(seeds, x.shape[1], w1.shape[0], rate)
        assert torch.equal(g != 0, keep)


@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kernel", ["ffn_fc1_bwd", "ffn_block_bwd", "ffn_ln_fc1_bwd"])
def test_ffn_fc1_bwd_kernels_match_plain(cuda, kernel, rate, D):
    """The backwards with dg read in (N2, N3, N4), 150 rows: dh zero where
    the forward dropped, N3's g the forward's bits, the rest as K5's."""
    x, w1, b1, gamma, beta, _, _, seeds = _ffn_inputs(cuda, D=D)
    dg = _on(cuda, _np(2, x.shape[1], w1.shape[0], seed=7), torch.bfloat16)
    _build.reset_launch_counts()
    if kernel == "ffn_ln_fc1_bwd":
        got = ffn.ffn_ln_fc1_bwd(x, w1, b1, gamma, beta, dg, rate=rate, seeds=seeds)
        want = ffn.ffn_ln_fc1_bwd_plain(x, w1, b1, gamma, beta, dg, rate=rate, seeds=seeds)
        assert _build.launch_counts == {ffn._name(kernel, D): 1, ln_gelu._name("ln_bwd", D): 1}
        _close(got[2], want[2], 1e-2)  # ln_out
        pairs = [(got[0], want[0], 2e-2), (got[1], want[1], 2e-2)]
        vectors = zip(got[3:], want[3:])
    else:
        emit_g = kernel == "ffn_block_bwd"
        got = ffn.ffn_fc1_bwd(x, w1, b1, dg, rate=rate, seeds=seeds, emit_g=emit_g)
        want = ffn.ffn_fc1_bwd_plain(x, w1, b1, dg, rate=rate, seeds=seeds, emit_g=emit_g)
        assert _build.launch_counts == {ffn._name(kernel, D): 1}
        if emit_g:
            assert torch.equal(got[1], ffn.ffn_fc1_fwd(x, w1, b1, rate=rate, seeds=seeds))
            _close(got[1], want[1], 1e-2)
        pairs = [(got[0], want[0], 2e-2), (got[-2], want[-2], 2.0**-8)]
        vectors = [(got[-1], want[-1])]
    if rate:
        keep = philox.keep_mask(seeds, x.shape[1], w1.shape[0], rate)
        assert not got[0][~keep].any()
    for g, w, frac in pairs:
        _close_rel(g, w, frac)
    for g, w in vectors:
        _close_rel(g, w, 5e-3)


def _selections(D, F, cuda):
    """W2 matrices (D, F) of ones at (d, s D + d): with b2 = 0, fc2 copies g
    column s D + d to y column d, exactly (one product, fp32 sum of zeros)."""
    out = []
    for s in range(-(-F // D)):
        cols = min(D, F - s * D)
        w2 = torch.zeros(D, F, device=cuda, dtype=torch.bfloat16)
        w2[torch.arange(cols), s * D + torch.arange(cols)] = 1.0
        out.append((w2, slice(s * D, s * D + cols), cols))
    return out


@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_ln_g_bwd_kernel_matches_plain(cuda, rate, D):
    """N5 (dg read in, g written), 150 rows: a ragged last row tile; g the
    forward's bits, dh zero where the forward dropped, the rest as K5's."""
    x, w1, b1, gamma, beta, _, _, seeds = _ffn_inputs(cuda, D=D)
    dg = _on(cuda, _np(2, x.shape[1], w1.shape[0], seed=7), torch.bfloat16)
    _build.reset_launch_counts()
    got = ffn.ffn_ln_g_bwd(x, w1, b1, gamma, beta, dg, rate=rate, seeds=seeds)
    assert _build.launch_counts == {ffn._name("ffn_ln_g_bwd", D): 1,
                                    ln_gelu._name("ln_bwd", D): 1}
    want = ffn.ffn_ln_g_bwd_plain(x, w1, b1, gamma, beta, dg, rate=rate, seeds=seeds)
    assert torch.equal(got[0], ffn.ffn_ln_fc1(x, w1, b1, gamma, beta, rate=rate, seeds=seeds))
    if rate:
        keep = philox.keep_mask(seeds, x.shape[1], w1.shape[0], rate)
        assert not got[1][~keep].any()
    _close(got[0], want[0], 1e-2)  # g
    _close(got[2], want[2], 1e-2)  # ln_out
    for g, w in ((got[1], want[1]), (got[3], want[3])):  # dh, dx
        _close_rel(g, w)
    for g, w in zip(got[4:], want[4:]):
        _close_rel(g, w, 5e-3)


@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_ln_dw_bwd_kernels_match_plain(cuda, rate, D):
    """N6 (N5's pass, dl and the dW kernel), 150 rows: dW1 and dW2 sum
    bf16 products over every row in fp32, in another order than torch's, of
    operands (dh, g) that may round one ulp apart: within 1e-2 of their max
    (ragged rows add nothing); dx and the vectors as N5's."""
    x, w1, b1, gamma, beta, _, dy, seeds = _ffn_inputs(cuda, D=D)
    dg = _on(cuda, _np(2, x.shape[1], w1.shape[0], seed=7), torch.bfloat16)
    _build.reset_launch_counts()
    got = ffn.ffn_ln_dw_bwd(x, w1, b1, gamma, beta, dy, dg, rate=rate, seeds=seeds)
    assert _build.launch_counts == {ffn._name("ffn_ln_dw_bwd", D): 1,
                                    ln_gelu._name("ln_bwd", D): 1}
    want = ffn.ffn_ln_dw_bwd_plain(x, w1, b1, gamma, beta, dy, dg, rate=rate, seeds=seeds)
    assert got[1].shape == (w1.shape[0], D) and got[2].shape == (D, w1.shape[0])
    _close_rel(got[0], want[0])  # dx
    for g, w in zip(got[1:3], want[1:3]):  # dW1, dW2
        _close_rel(g, w, 1e-2)
    for g, w in zip(got[3:], want[3:]):
        _close_rel(g, w, 5e-3)
    # The dW kernel against the plain products on the kernel's own dh, g, ln_out.
    g, dh, ln_out, *_ = ffn.ffn_ln_g_bwd(x, w1, b1, gamma, beta, dg, rate=rate, seeds=seeds)
    for a, w in zip(got[1:3], ffn.ffn_dw_plain(dh, ln_out, dy, g)):
        _close_rel(a, w, 1e-3)


@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_ln_fc2_kernel_matches_plain(cuda, rate, D):
    """N7 (fc2 in the kernel), 150 rows: y as the plain version; with
    selection weights y holds g's columns bit for bit, N5's regenerated g, so
    the mask is N5's."""
    x, w1, b1, gamma, beta, w2, _, seeds = _ffn_inputs(cuda, D=D)
    F = w1.shape[0]
    b2 = _on(cuda, _np(D, seed=8, scale=0.1))
    _build.reset_launch_counts()
    y = ffn.ffn_ln_fc2_fwd(x, w1, b1, gamma, beta, w2, b2, rate=rate, seeds=seeds)
    assert _build.launch_counts == {ffn._name("ffn_ln_fc2_drop" if rate else "ffn_ln_fc2", D): 1}
    _close(y, ffn.ffn_ln_fc2_fwd_plain(x, w1, b1, gamma, beta, w2, b2, rate=rate, seeds=seeds),
           1e-2)
    dg = torch.zeros(*x.shape[:-1], F, device=cuda, dtype=torch.bfloat16)
    g = ffn.ffn_ln_g_bwd(x, w1, b1, gamma, beta, dg, rate=rate, seeds=seeds)[0]
    zero = torch.zeros(D, device=cuda)
    for w2_sel, cols, n in _selections(D, F, cuda):
        y_sel = ffn.ffn_ln_fc2_fwd(x, w1, b1, gamma, beta, w2_sel, zero, rate=rate, seeds=seeds)
        assert torch.equal(y_sel[..., :n], g[..., cols])


# Rows around the 128-row tile of N7's clusters and N6's 64-row dW chunks: M
# < 128, a multiple of neither, and two batch rows meeting inside a tile.
N67_ROWS = [(1, 37), (1, 127), (1, 131), (2, 129)]


@pytest.mark.parametrize("B,T", N67_ROWS)
@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_ln_fc2_kernel_at_ragged_rows_gives_the_same_bits_twice(cuda, rate, D, B, T):
    """N7's cluster kernel at every built width and both rates on ragged
    rows, F = 4 D (every round of the cluster whole, 7.5 rounds at 1920):
    y as the plain version at the bounds above, the same bits on a second
    call (y's sum in a fixed order: rounds, then peers in rank order)."""
    x, w1, b1, gamma, beta, w2, _, _ = _ffn_inputs(cuda, F=4 * D, T=T, D=D)
    x = _on(cuda, _np(B, T, D, seed=11, offset=0.2), torch.bfloat16)
    b2 = _on(cuda, _np(D, seed=8, scale=0.1))
    seeds = torch.tensor([12345, -7][:B], dtype=torch.int32, device=cuda) if rate else None
    y = ffn.ffn_ln_fc2_fwd(x, w1, b1, gamma, beta, w2, b2, rate=rate, seeds=seeds)
    _close(y, ffn.ffn_ln_fc2_fwd_plain(x, w1, b1, gamma, beta, w2, b2, rate=rate, seeds=seeds),
           1e-2)
    assert torch.equal(y, ffn.ffn_ln_fc2_fwd(x, w1, b1, gamma, beta, w2, b2, rate=rate,
                                              seeds=seeds))


@pytest.mark.parametrize("B,T", N67_ROWS + [(8, 499)])
@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_ln_dw_bwd_kernel_at_ragged_rows_gives_the_same_bits_twice(cuda, rate, D, B, T):
    """N6 at every built width and both rates on ragged rows, F = 4 D: dW1
    and dW2 against the plain products on N5's own dh, g and ln_out (1e-3 of
    their max), over ``ffn_dw_ranges`` row ranges (R > 1 at 384 and 512 on
    more than one 64-row chunk, partials finished in range order; 1
    elsewhere), and the same bits on a second call."""
    F = 4 * D
    _, w1, b1, gamma, beta, _, _, _ = _ffn_inputs(cuda, F=F, T=T, D=D)
    x = _on(cuda, _np(B, T, D, seed=11, offset=0.2), torch.bfloat16)
    dy = _on(cuda, _np(B, T, D, seed=12), torch.bfloat16)
    dg = _on(cuda, _np(B, T, F, seed=13), torch.bfloat16)
    seeds = torch.tensor(list(range(1, B + 1)), dtype=torch.int32, device=cuda) if rate else None
    got = ffn.ffn_ln_dw_bwd(x, w1, b1, gamma, beta, dy, dg, rate=rate, seeds=seeds)
    g, dh, ln_out, *_ = ffn.ffn_ln_g_bwd(x, w1, b1, gamma, beta, dg, rate=rate, seeds=seeds)
    for a, w in zip(got[1:3], ffn.ffn_dw_plain(dh, ln_out, dy, g)):
        _close_rel(a, w, 1e-3)
    again = ffn.ffn_ln_dw_bwd(x, w1, b1, gamma, beta, dy, dg, rate=rate, seeds=seeds)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_ffn_ln_fc2_clusters_schedule_at_every_width(cuda):
    """N7's C entry gives each width's cluster size as ``ffn_fc2_cluster``
    and a cluster the card can hold (``cudaOccupancyMaxActiveClusters``)."""
    import ctypes

    lib = _build.library()
    for D in ALL_D:
        c = ctypes.c_int(0)
        assert lib.coral_ffn_ln_fc2_clusters(D, ctypes.byref(c)) >= 1
        assert c.value == ffn.ffn_fc2_cluster(D)
    assert lib.coral_ffn_ln_fc2_clusters(640, ctypes.byref(ctypes.c_int(0))) == -1


def _n7_kernels_a_call():
    """The device kernels of one N7 call at D 1280 and 384, by the profiler."""
    cuda = torch.device("cuda")
    out = {}
    for D, T in ((1280, 131), (384, 499)):
        x, w1, b1, gamma, beta, w2, _, _ = _ffn_inputs(cuda, F=4 * D, T=T, D=D)
        b2 = _on(cuda, _np(D, seed=8, scale=0.1))

        def fn():
            return ffn.ffn_ln_fc2_fwd(x, w1, b1, gamma, beta, w2, b2)

        fn()
        out[D] = _device_kernels(fn)
    return out


def test_ffn_ln_fc2_is_one_device_kernel_a_call(cuda):
    """By the profiler, in a process of its own (as the mainloop's count
    above): N7 launches one device kernel a call, its cluster kernel."""
    tests = Path(__file__).resolve().parent
    script = (f"import sys; sys.path[:0] = [{str(tests.parent)!r}, {str(tests)!r}]; "
              f"import test_torch_kernels as t; print(t._n7_kernels_a_call())")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    names = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    for D in (1280, 384):
        assert len(names[D]) == 1 and "ffn_ln_fc2_kernel" in names[D][0], names[D]


@pytest.mark.parametrize("variant", ["dg_in", "dg_out", "fc2", "dw"])
def test_ffn_block_variants_launch_their_kernels(cuda, variant):
    """``ffn_ln_block``'s variants at D 1024, forward and backward: each
    launches its own kernels once, and its gradients agree with the plain
    path's."""
    x, w1, b1, gamma, beta, w2, dy, seeds = _ffn_inputs(cuda)
    b2 = _on(cuda, _np(1024, seed=8, scale=0.1))
    flags = {"dg_in": {}, "dg_out": {"dg_in_kernel": False}, "fc2": {"fc2_in_kernel": True},
             "dw": {"dw_in_kernel": True}}[variant]
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, gamma, beta, w2, b2)]
        _build.reset_launch_counts()
        y = ffn.ffn_ln_block(*leaves, rate=0.1, seeds=seeds, plain=plain, **flags)
        y.backward(dy)
        if not plain:
            counts = dict(_build.launch_counts)
        grads.append([leaf.grad for leaf in leaves])
    fwd = "ffn_ln_fc2_drop" if variant == "fc2" else "ffn_ln_drop"
    bwd = {"dg_in": "ffn_bwd", "dg_out": "ffn_ln_g_bwd", "fc2": "ffn_ln_g_bwd",
           "dw": "ffn_ln_dw_bwd"}[variant]
    assert counts == {fwd: 1, bwd: 1, "ln_bwd": 1}
    for got, want in zip(*grads):
        _close_rel(got, want, 2e-2)


# The FFN mainloop (csrc/ffn_gemm.cuh): 128-row tiles at every width.
FFN_ROW_TILE = 128


def _ffn_mainloop_calls(x, w1, b1, gamma, beta, w2, dy, dg, rate, seeds, plain=False):
    """Every wrapper on the FFN mainloop (K5 forward and backward, N1-N5),
    or their plain versions, in one dict of output tuples."""
    s = seeds if rate else None
    sfx = "_plain" if plain else ""

    def f(name):
        return getattr(ffn, name + sfx)

    return {
        "ffn_ln": (f("ffn_ln_fc1" if plain else "ffn_ln_fc1_fwd")(x, w1, b1, gamma, beta,
                                                                  rate=rate, seeds=s),),
        "ffn_bwd": f("ffn_bwd")(x, w1, b1, gamma, beta, dy, w2, rate=rate, seeds=s),
        "ffn_fc1": (f("ffn_fc1" if plain else "ffn_fc1_fwd")(x, w1, b1, rate=rate, seeds=s),),
        "ffn_fc1_bwd": f("ffn_fc1_bwd")(x, w1, b1, dg, rate=rate, seeds=s),
        "ffn_block_bwd": f("ffn_fc1_bwd")(x, w1, b1, dg, rate=rate, seeds=s, emit_g=True),
        "ffn_ln_fc1_bwd": f("ffn_ln_fc1_bwd")(x, w1, b1, gamma, beta, dg, rate=rate, seeds=s),
        "ffn_ln_g_bwd": f("ffn_ln_g_bwd")(x, w1, b1, gamma, beta, dg, rate=rate, seeds=s),
    }


# Which outputs of each wrapper are rounded outputs (o: atol 1e-2),
# gradients (g: 2e-2 of their max; X, N2/N3's dx: 2**-8) and fp32 row-partial
# sums (s: 5e-3 of their max; S, K5's: 1e-2), as the tests above hold them.
_FFN_KINDS = {
    "ffn_ln": "o", "ffn_bwd": "ogogSSS", "ffn_fc1": "o", "ffn_fc1_bwd": "gXs",
    "ffn_block_bwd": "goXs", "ffn_ln_fc1_bwd": "ggosss", "ffn_ln_g_bwd": "ogogsss",
}


_FFN_FRAC = {"g": 2e-2, "X": 2.0**-8, "s": 5e-3, "S": 1e-2}


@pytest.mark.parametrize("D", ALL_D)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_mainloop_kernels_at_rows_ragged_at_128_match_plain(cuda, rate, D):
    """K5's forward and backward and N1-N5 at 3 x 131 rows (a last row tile
    of 9 of the mainloop's 128) and F = 1024 (4 forward column tiles of 256,
    8 backward of 128), against their plain versions at the bounds of the
    tests above (dx of N2/N3 at 2**-8 of its max, as there)."""
    _, w1, b1, gamma, beta, w2, _, _ = _ffn_inputs(cuda, F=1024, T=131, D=D)
    x = _on(cuda, _np(3, 131, D, seed=10, offset=0.2), torch.bfloat16)
    dy = _on(cuda, _np(3, 131, D, seed=6), torch.bfloat16)
    seeds = torch.tensor([12345, -7, 99], dtype=torch.int32, device=cuda)
    dg = _on(cuda, _np(3, 131, 1024, seed=7), torch.bfloat16)
    got = _ffn_mainloop_calls(x, w1, b1, gamma, beta, w2, dy, dg, rate, seeds)
    want = _ffn_mainloop_calls(x, w1, b1, gamma, beta, w2, dy, dg, rate, seeds, plain=True)
    for name, kinds in _FFN_KINDS.items():
        assert len(got[name]) == len(kinds) == len(want[name]), name
        for kind, g, w in zip(kinds, got[name], want[name]):
            if kind == "o":
                _close(g, w, 1e-2)
            elif kind == "g":
                _close_rel(g, w)
            else:
                _close_rel(g, w, _FFN_FRAC[kind])
    if rate:
        keep = philox.keep_mask(seeds, 131, 1024, rate)
        assert torch.equal(got["ffn_ln"][0] != 0, keep)
        for name in ("ffn_bwd", "ffn_ln_g_bwd"):
            assert torch.equal(got[name][0], got["ffn_ln"][0])  # g regenerated bit for bit
            assert not got[name][1][~keep].any()
        assert torch.equal(got["ffn_block_bwd"][1], got["ffn_fc1"][0])


def test_ffn_mainloop_takes_several_column_tiles_a_block(cuda):
    """Whisper large-v3's encoder rows (8 x 1500, D 1280, F 5120), where a
    block takes several column tiles in turn: the forward and K5's backward
    against their plain versions, g regenerated bit for bit."""
    x, w1, b1, gamma, beta, w2, dy, _ = _ffn_inputs(cuda, F=5120, T=1500, D=1280)
    x, dy = x.repeat(4, 1, 1), dy.repeat(4, 1, 1)
    seeds = torch.arange(8, dtype=torch.int32, device=cuda) * 7919 - 3
    g = ffn.ffn_ln_fc1_fwd(x, w1, b1, gamma, beta, rate=0.1, seeds=seeds)
    _close(g, ffn.ffn_ln_fc1_plain(x, w1, b1, gamma, beta, rate=0.1, seeds=seeds), 1e-2)
    got = ffn.ffn_bwd(x, w1, b1, gamma, beta, dy, w2, rate=0.1, seeds=seeds)
    want = ffn.ffn_bwd_plain(x, w1, b1, gamma, beta, dy, w2, rate=0.1, seeds=seeds)
    assert torch.equal(got[0], g)
    for kind, a, w in zip(_FFN_KINDS["ffn_bwd"], got, want):
        if kind == "o":
            _close(a, w, 1e-2)
        else:
            _close_rel(a, w, _FFN_FRAC[kind])


@pytest.mark.parametrize("D", [384, 1280, 1920])
def test_ffn_backwards_give_the_same_bits_twice(cuda, D):
    """Two calls of each backward on the mainloop give the same bits, db1's
    fixed-order sums included (no atomics)."""
    x, w1, b1, gamma, beta, w2, dy, seeds = _ffn_inputs(cuda, F=1024, T=131, D=D)
    dg = _on(cuda, _np(2, 131, 1024, seed=7), torch.bfloat16)
    first = _ffn_mainloop_calls(x, w1, b1, gamma, beta, w2, dy, dg, 0.1, seeds)
    second = _ffn_mainloop_calls(x, w1, b1, gamma, beta, w2, dy, dg, 0.1, seeds)
    for name in first:
        for a, b in zip(first[name], second[name]):
            assert torch.equal(a, b), name


# Each wrapper's device kernels a call: its own kernels (once each), the
# LayerNorm backward's row and column kernels and the sum of the db1
# partials; the mainloop's wrappers launch no more than before it.
_FFN_DEVICE_KERNELS = {
    "ffn_ln": (["ffn_fwd_kernel"], 1), "ffn_fc1": (["ffn_fwd_kernel"], 1),
    "ffn_bwd": (["ffn_bwd_kernel", "dl_kernel"], 5),
    "ffn_fc1_bwd": (["ffn_bwd_kernel", "dl_kernel"], 3),
    "ffn_block_bwd": (["ffn_bwd_kernel", "dl_kernel"], 3),
    "ffn_ln_fc1_bwd": (["ffn_bwd_kernel", "dl_kernel"], 5),
    "ffn_ln_g_bwd": (["ffn_bwd_kernel", "dl_kernel"], 5),
}


def _ffn_kernels_a_call():
    """For each wrapper on the FFN mainloop: how many of the profiler's device
    kernels of one call are ffn_fwd_kernel, ffn_bwd_kernel and dl_kernel,
    and how many it launched in all."""
    cuda = torch.device("cuda")
    x, w1, b1, gamma, beta, w2, dy, seeds = _ffn_inputs(cuda, F=1024, T=131, D=1280)
    dg = _on(cuda, _np(2, 131, 1024, seed=7), torch.bfloat16)
    counts = {}
    for name, call in _FFN_ONE.items():
        def fn(call=call):
            return call(x, w1, b1, gamma, beta, w2, dy, dg, seeds)

        fn()  # the library is built and the weights' maps kept
        names = _device_kernels(fn)
        counts[name] = [sum(k in n for n in names)
                        for k in ("ffn_fwd_kernel", "ffn_bwd_kernel", "dl_kernel")] + [len(names)]
    return counts


def test_ffn_wrappers_launch_their_device_kernels_once_a_call(cuda):
    """By the profiler, as ``chip_smoke.device_kernels`` counts them: the
    forwards one device kernel a call, the backwards their first kernel and
    dl once each and at most the kernels they launched before the mainloop
    (``_FFN_DEVICE_KERNELS``). Counted in a process of its own, as the
    decode kernels' count below: in one pytest process the profiler can
    stop recording once another test has profiled."""
    tests = Path(__file__).resolve().parent
    script = (f"import sys; sys.path[:0] = [{str(tests.parent)!r}, {str(tests)!r}]; "
              f"import test_torch_kernels as t; print(t._ffn_kernels_a_call())")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    counts = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    kinds = ("ffn_fwd_kernel", "ffn_bwd_kernel", "dl_kernel")
    for name, (own, most) in _FFN_DEVICE_KERNELS.items():
        assert counts[name][:3] == [int(k in own) for k in kinds], (name, counts[name])
        assert counts[name][3] <= most, (name, counts[name])


_FFN_ONE = {
    "ffn_ln": lambda x, w1, b1, g, b, w2, dy, dg, s: ffn.ffn_ln_fc1_fwd(x, w1, b1, g, b, rate=0.1,
                                                                        seeds=s),
    "ffn_fc1": lambda x, w1, b1, g, b, w2, dy, dg, s: ffn.ffn_fc1_fwd(x, w1, b1, 0.1, s),
    "ffn_bwd": lambda x, w1, b1, g, b, w2, dy, dg, s: ffn.ffn_bwd(x, w1, b1, g, b, dy, w2,
                                                                  rate=0.1, seeds=s),
    "ffn_fc1_bwd": lambda x, w1, b1, g, b, w2, dy, dg, s: ffn.ffn_fc1_bwd(x, w1, b1, dg, 0.1, s),
    "ffn_block_bwd": lambda x, w1, b1, g, b, w2, dy, dg, s: ffn.ffn_fc1_bwd(x, w1, b1, dg, 0.1, s,
                                                                            emit_g=True),
    "ffn_ln_fc1_bwd": lambda x, w1, b1, g, b, w2, dy, dg, s: ffn.ffn_ln_fc1_bwd(
        x, w1, b1, g, b, dg, rate=0.1, seeds=s),
    "ffn_ln_g_bwd": lambda x, w1, b1, g, b, w2, dy, dg, s: ffn.ffn_ln_g_bwd(
        x, w1, b1, g, b, dg, rate=0.1, seeds=s),
}


@pytest.mark.parametrize("D", [384, 1920])
def test_ffn_kernels_write_nothing_past_row_m(cuda, D):
    """The C entries on buffers with 128 sentinel rows past M = 131: g, dh,
    ln_out, dl and the db1 partials' rows past ceil(M / 128) keep them."""
    lib, bf16 = _build.library(), torch.bfloat16
    F, M = 512, 131
    x, w1, b1, gamma, beta, w2, dy, _ = _ffn_inputs(cuda, F=F, T=M, D=D)
    x, dy = x[0], dy[0]
    sentinel = -3.0

    def buf(cols, dtype):
        return torch.full((M + FFN_ROW_TILE, cols), sentinel, device=cuda, dtype=dtype)

    g, dh, ln_out, dl = buf(F, bf16), buf(F, bf16), buf(D, bf16), buf(D, torch.float32)
    part = torch.full((3, F), sentinel, device=cuda)
    stream = _build.current_stream()
    assert lib.coral_ffn_ln_fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), gamma.data_ptr(),
                                beta.data_ptr(), None, g.data_ptr(), M, D, F, 1, 0, 1.0, 1e-5,
                                stream) == 0
    torch.cuda.synchronize()
    assert (g[M:] == sentinel).all()
    assert lib.coral_ffn_bwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), gamma.data_ptr(),
                             beta.data_ptr(), dy.data_ptr(), w2.data_ptr(), None, g.data_ptr(),
                             dh.data_ptr(), ln_out.data_ptr(), part.data_ptr(), dl.data_ptr(),
                             M, D, F, 1, 0, 1.0, 1e-5, stream) == 0
    torch.cuda.synchronize()
    for t in (g, dh, ln_out, dl):
        assert (t[M:] == sentinel).all()
        assert (t[:M] != sentinel).any()
    assert (part[2] == sentinel).all() and (part[:2] != sentinel).any()


def test_ffn_kernels_reject_what_they_do_not_take(cuda):
    """F not a multiple of 256 and a width no config uses: the wrappers raise
    before launching, the C entries return -1 and launch nothing."""
    lib = _build.library()
    x, w1, b1, gamma, beta, w2, dy, _ = _ffn_inputs(cuda, F=384, T=9, D=1024)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 256"):
        ffn.ffn_ln_fc1_fwd(x, w1, b1, gamma, beta)
    with pytest.raises(ValueError, match="multiple of 256"):
        ffn.ffn_bwd(x, w1, b1, gamma, beta, dy, w2)
    with pytest.raises(ValueError, match="multiple of 256"):
        ffn.ffn_fc1_fwd(x, w1, b1)
    assert not _build.launch_counts
    stream = _build.current_stream()
    for D, F in ((1024, 384), (640, 512)):
        assert lib.coral_ffn_ln_fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                    gamma.data_ptr(), beta.data_ptr(), None, None, 18, D, F, 1,
                                    0, 1.0, 1e-5, stream) == -1
        assert lib.coral_ffn_fc1_fwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), None, None, 18,
                                     D, F, 1, 0, 1.0, stream) == -1
        assert lib.coral_ffn_fc1_bwd(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), None, None, None,
                                     None, None, None, 18, D, F, 1, 0, 1.0, stream) == -1


def _conv_inputs(cuda, k, T_in, B=2):
    C = 512
    x = _on(cuda, _np(B, T_in, C, seed=0), torch.bfloat16)
    w = _on(cuda, _np(C, C, k, seed=1, scale=0.05), torch.bfloat16)
    b, gamma, beta = (_on(cuda, _np(C, seed=s, scale=0.1, offset=o))
                      for s, o in ((2, 0.0), (3, 1.0), (4, 0.0)))
    return x, w, b, gamma, beta


@pytest.mark.parametrize("k,T_in,B", [(3, 1001, 2), (2, 258, 2), (3, 1025, 2), *CONV_EDGES])
def test_conv_train_forward_kernel_matches_plain(cuda, k, T_in, B):
    """The training launch: y as the serving launch, plus xhat (bf16) and
    rstd (fp32)."""
    args = _conv_inputs(cuda, k, T_in, B)
    _build.reset_launch_counts()
    y, xhat, rstd = conv_ln_gelu.conv_ln_gelu_fwd(*args)
    assert _build.launch_counts == {"conv_ln_gelu_train": 1}
    want = conv_ln_gelu.conv_ln_gelu_fwd_plain(*args)
    assert xhat.dtype == torch.bfloat16 and rstd.dtype == torch.float32
    _close(y, want[0], 1e-2)
    _close(xhat, want[1], 1e-2)
    torch.testing.assert_close(rstd, want[2], rtol=1e-4, atol=0.0)
    assert torch.equal(y, conv_ln_gelu.conv_ln_gelu_fwd(*args, residuals=False)[0])


@pytest.mark.parametrize("k,T_in,B", [(3, 1101, 2), (3, 1102, 2), (2, 999, 2), (3, 1025, 2),
                                     (2, 5, 2), *CONV_EDGES])
def test_conv_bwd_kernel_matches_plain(cuda, k, T_in, B):
    """dx, dW and (dgamma, dbeta, dbias) against the plain formula; ragged
    tiles of rows, of dx's 128 row pairs (the k = 3 halo row at a tile edge)
    and of dW's 64-row chunks, batch rows meeting inside a tile, and input
    rows that no output reads (past 2 (T_out - 1) + k - 1) come out exactly 0
    even where the allocator hands back memory full of NaN."""
    x, w, b, gamma, beta = _conv_inputs(cuda, k, T_in, B)
    _, xhat, rstd = conv_ln_gelu.conv_ln_gelu_fwd(x, w, b, gamma, beta)
    dy = _on(cuda, _np(*xhat.shape, seed=5), torch.bfloat16)
    torch.full((4 * x.numel(),), float("nan"), device=cuda)  # freed: dirty memory
    _build.reset_launch_counts()
    got = conv_ln_gelu.conv_ln_gelu_bwd(x, w, gamma, beta, xhat, rstd, dy)
    assert _build.launch_counts == {"conv_ln_gelu_bwd": 1}
    want = conv_ln_gelu.conv_ln_gelu_bwd_plain(x, w, gamma, beta, xhat, rstd, dy)
    assert got[0].shape == x.shape and got[1].shape == w.shape and got[2].shape == (3, 512)
    _close_rel(got[0], want[0])
    _close_rel(got[1], want[1])
    _close_rel(got[2], want[2], 1e-2)
    read = 2 * (xhat.shape[1] - 1) + k
    assert not got[0][:, read:].any() and not want[0][:, read:].any()


@pytest.mark.parametrize("k,T_in,B", [(3, 31999, 2), (2, 1999, 8), (3, 259, 3)])
def test_conv_bwd_gives_the_same_bits_twice(cuda, k, T_in, B):
    """dW's row ranges and dvec's block partials are summed in a fixed order
    (no atomics): two calls give the same bits, dx too; at FE block 1's and
    5's row counts and at a ragged one."""
    x, w, b, gamma, beta = _conv_inputs(cuda, k, T_in, B)
    _, xhat, rstd = conv_ln_gelu.conv_ln_gelu_fwd(x, w, b, gamma, beta)
    dy = _on(cuda, _np(*xhat.shape, seed=5), torch.bfloat16)
    first = conv_ln_gelu.conv_ln_gelu_bwd(x, w, gamma, beta, xhat, rstd, dy)
    second = conv_ln_gelu.conv_ln_gelu_bwd(x, w, gamma, beta, xhat, rstd, dy)
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    y1 = conv_ln_gelu.conv_ln_gelu_fwd(x, w, b, gamma, beta)
    for a, c in zip(y1, conv_ln_gelu.conv_ln_gelu_fwd(x, w, b, gamma, beta)):
        assert torch.equal(a, c)


def test_conv_autograd_kernel_path_matches_plain(cuda):
    """The Function around the kernels: every input gets its gradient, in its
    own dtype."""
    args = _conv_inputs(cuda, 3, 777)
    dy = _on(cuda, _np(2, 388, 512, seed=6), torch.bfloat16)
    grads = []
    for plain in (False, True):
        leaves = [a.clone().requires_grad_(True) for a in args]
        conv_ln_gelu.conv_ln_gelu(*leaves, plain=plain).backward(dy)
        grads.append([t.grad for t in leaves])
    for i, (g, w) in enumerate(zip(*grads)):
        assert g.dtype == args[i].dtype
        _close_rel(g, w, 1e-2 if i >= 2 else 2e-2)


def test_conv_bwd_rejects_what_it_does_not_take(cuda):
    x, w, b, gamma, beta = _conv_inputs(cuda, 3, 101)
    _, xhat, rstd = conv_ln_gelu.conv_ln_gelu_fwd(x, w, b, gamma, beta)
    with pytest.raises(ValueError, match="C_in = C_out = 512"):
        conv_ln_gelu.conv_ln_gelu_bwd(x[..., :256].contiguous(), w[:256, :256].contiguous(),
                                      gamma[:256], beta[:256], xhat[..., :256].contiguous(),
                                      rstd, xhat[..., :256].contiguous())
    with pytest.raises(TypeError):  # fp32 dy: the kernel takes bf16
        conv_ln_gelu.conv_ln_gelu_bwd(x, w, gamma, beta, xhat, rstd, xhat.float())
    with pytest.raises(ValueError, match="k=5"):
        conv_ln_gelu.conv_ln_gelu_bwd(x, torch.zeros(512, 512, 5, device=cuda), gamma, beta,
                                      xhat, rstd, xhat)
    with pytest.raises(ValueError, match="xhat and dy"):
        conv_ln_gelu.conv_ln_gelu_bwd(x, w, gamma, beta, xhat[:, 1:].contiguous(), rstd,
                                      xhat[:, 1:].contiguous())


def _ctc_inputs(cuda, T=100, B=4, L=20, V=30):
    rng = np.random.default_rng(0)
    log_probs = torch.log_softmax(_on(cuda, _np(T, B, V, seed=1) * 3), dim=-1)
    labels = torch.from_numpy(rng.integers(1, V, size=(B, L))).to(cuda)
    labels[1, 12:] = -100
    in_len = torch.tensor([100, 80, 10, 64], device=cuda)  # row 2 is infeasible
    lab_len = torch.tensor([20, 12, 20, 0], device=cuda)
    return log_probs, labels, in_len, lab_len


def test_ctc_kernels_match_plain(cuda):
    log_probs, labels, in_len, lab_len = _ctc_inputs(cuda)
    ext = ctc._extended_labels(torch.where(labels < 0, 0, labels), 0)
    skip, skip_fwd, valid, terminal = ctc._state_masks(ext, lab_len, 0)
    emit = ctc._emissions(log_probs, ext).contiguous()
    _build.reset_launch_counts()
    alpha = ctc.ctc_alpha(emit, skip, valid, in_len)
    beta = ctc.ctc_beta(emit, skip_fwd, valid, in_len, terminal)
    assert _build.launch_counts == {"ctc_alpha": 1, "ctc_beta": 1}
    torch.testing.assert_close(alpha, ctc.ctc_alpha_plain(emit, skip, valid, in_len),
                               rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(beta, ctc.ctc_beta_plain(emit, skip_fwd, valid, in_len, terminal),
                               rtol=1e-5, atol=1e-3)


def test_ctc_loss_kernel_path_matches_plain(cuda):
    log_probs, labels, in_len, lab_len = _ctc_inputs(cuda)
    grads = []
    for plain in (False, True):
        lp = log_probs.clone().requires_grad_(True)
        loss = ctc.ctc_loss(lp, labels, in_len, lab_len, reduction="none", plain=plain)
        loss.sum().backward()
        grads.append((loss.detach(), lp.grad))
    assert grads[0][0][2] == 0 and not grads[0][1][:, 2].any()  # zero_infinity
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-4, atol=1e-5)


# K6 at the training shape (T' 499, B 8, L 128: S 257, R = 1 state a thread,
# 9 warps) and around its layout: S 31 / 33 on each side of a warp's 32
# states, 63 / 65 of two warps', 1025 (R = 2) and 6143 (R = 6, the last
# states of the 6144 limit).
CTC_SHAPES = [(499, 8, 128), (150, 3, 15), (150, 3, 16), (130, 3, 31), (130, 3, 32),
              (70, 2, 512), (9, 2, 3071)]


def _ctc_case(cuda, T, B, L, V=46):
    """log-probs (T, B, V) and labels with repeats (skip false there); the
    rows' lengths: T, 1, under one 64-step chunk, T - 1, an infeasible row
    (more labels than frames), and L = 0."""
    rng = np.random.default_rng(T * 1000 + L)
    log_probs = torch.log_softmax(_on(cuda, _np(T, B, V, seed=L, scale=3.0)), dim=-1)
    labels = rng.integers(1, V, size=(B, L))
    labels[:, 1::7] = labels[:, 0::7][:, :labels[:, 1::7].shape[1]]  # repeated labels
    labels = torch.from_numpy(labels).to(cuda)
    in_len = torch.tensor([T, 1, min(T, 40), T - 1, max(1, L // 2), T, T, T][:B], device=cuda)
    lab_len = torch.tensor([L, 0, min(L, 15), L, L, 0, L // 2, L][:B], device=cuda)
    ext = ctc._extended_labels(labels, 0)
    skip, skip_fwd, valid, terminal = ctc._state_masks(ext, lab_len, 0)
    emit = ctc._emissions(log_probs, ext)
    return (emit, skip, valid, in_len), (emit, skip_fwd, valid, in_len, terminal)


@pytest.mark.parametrize("T,B,L", CTC_SHAPES)
def test_ctc_kernels_match_plain_at_every_layout(cuda, T, B, L):
    """Alpha and beta against their plain versions at atol 1e-3 and rtol
    1e-5, one launch a call; two calls give the same bits; a contiguous copy
    of the emissions (copied into 16-byte rows by the wrapper) gives the bits
    of the gathered view."""
    a_args, b_args = _ctc_case(cuda, T, B, L)
    for name, kernel, plain, args in (("ctc_alpha", ctc.ctc_alpha, ctc.ctc_alpha_plain, a_args),
                                      ("ctc_beta", ctc.ctc_beta, ctc.ctc_beta_plain, b_args)):
        _build.reset_launch_counts()
        got = kernel(*args)
        assert _build.launch_counts == {name: 1}
        torch.testing.assert_close(got, plain(*args), rtol=1e-5, atol=1e-3)
        assert torch.equal(got, kernel(*args))
        assert torch.equal(got, kernel(args[0].contiguous(), *args[1:]))


def _ctc_kernels_a_call():
    """The profiler's device kernels of one call of each K6 wrapper on the
    gathered emissions, and of one ``ln_dense_fwd`` call at D 1024 and 1920."""
    cuda = torch.device("cuda")
    (emit, skip, valid, in_len), (_, skip_fwd, _, _, terminal) = _ctc_case(cuda, 499, 8, 128)
    # Masks in uint8 and lengths in int32, as the kernels take them: the
    # wrappers convert nothing.
    skip, skip_fwd, valid, terminal = (m.to(torch.uint8) for m in (skip, skip_fwd, valid,
                                                                    terminal))
    in_len = in_len.to(torch.int32)
    out = {"ctc_alpha": _device_kernels(lambda: ctc.ctc_alpha(emit, skip, valid, in_len)),
           "ctc_beta": _device_kernels(lambda: ctc.ctc_beta(emit, skip_fwd, valid, in_len,
                                                            terminal))}
    for D in (1024, 1920):
        x, w, b, gamma, beta, _ = _ln_dense_args(cuda, D)
        ffn.ln_dense_fwd(x, w, b, gamma, beta)
        out[f"ln_dense {D}"] = _device_kernels(lambda: ffn.ln_dense_fwd(x, w, b, gamma, beta))
    return out


def test_ctc_and_ln_dense_are_one_device_kernel_a_call(cuda):
    """By the profiler, in a process of its own (as the FFN mainloop's count):
    each K6 wrapper launches its one kernel, ``ln_dense``'s forward the
    mainloop's forward kernel alone."""
    tests = Path(__file__).resolve().parent
    script = (f"import sys; sys.path[:0] = [{str(tests.parent)!r}, {str(tests)!r}]; "
              f"import test_torch_kernels as t; print(t._ctc_kernels_a_call())")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    names = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    for key, want in (("ctc_alpha", "ctc_kernel"), ("ctc_beta", "ctc_kernel"),
                      ("ln_dense 1024", "ffn_fwd_kernel"), ("ln_dense 1920", "ffn_fwd_kernel")):
        assert len(names[key]) == 1 and want in names[key][0], (key, names[key])


def test_backward_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(2, 10, 256, device=cuda)
    with pytest.raises(ValueError, match="C in"):
        ln_gelu.ln_bwd(x, torch.ones(256, device=cuda), torch.zeros(256, device=cuda), x)
    q = torch.zeros(1, 8, 64, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(64, device=cuda, dtype=torch.bfloat16)
    kb = torch.zeros(1, 8, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attention.attention_bwd(q, q, q, b, b, b, kb, q, lse, q, 32, 0.17)
    x, w1, b1, gamma, beta, w2, dy, seeds = _ffn_inputs(cuda)
    with pytest.raises(ValueError, match="the kernel takes D"):  # 256: no config's width
        ffn.ffn_bwd(x[..., :256].contiguous(), w1[:, :256].contiguous(), b1, gamma[:256],
                    beta[:256], dy[..., :256].contiguous(), w2[:256].contiguous(), rate=0.0)
    with pytest.raises(ValueError, match="seeds"):
        ffn.ffn_ln_fc1(x, w1, b1, gamma, beta, rate=0.1, seeds=None)
    emit = torch.zeros(4, 1, 7000, device=cuda)
    m = torch.ones(1, 7000, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="S <="):
        ctc.ctc_alpha(emit, m, m, torch.ones(1, device=cuda, dtype=torch.int32))


# -- Whisper serving: encoder flash attention, decode attention ----------------------


@pytest.mark.parametrize("T", [1500, 1000])
@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
def test_flash_attention_kernel_matches_plain(cuda, T, packed):
    """T = 1500 (Whisper's encoder, not a multiple of the 64-key tile) and
    T = 1000; q, k, v as separate tensors or as views of one packed
    projection (strided rows)."""
    B, H, d = 2, 3, 64
    q, k, v = (_np(B, T, H * d, seed=i) for i in range(3))
    if packed:
        qkv = _on(cuda, np.concatenate([q, k, v], axis=-1), torch.bfloat16)
        q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
    else:
        q, k, v = (_on(cuda, a, torch.bfloat16).view(B, T, H, d) for a in (q, k, v))
    _build.reset_launch_counts()
    got = flash_attention.flash_self_attention(q, k, v)
    assert _build.launch_counts == {"flash_attention": 1}
    _close(got, flash_attention.flash_self_attention_plain(q, k, v), 8e-3)


@pytest.mark.parametrize("T", [1500, 1000])
@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
def test_flash_attention_train_and_bwd_kernels_match_plain(cuda, T, packed):
    """The training forward (o and the fp32 row stats l, m) and the two
    backward kernels against their plain versions, at a T that is not a
    multiple of the 64-key tile; then the autograd Function."""
    B, H, d = 2, 3, 64
    q, k, v = (_np(B, T, H * d, seed=i) for i in range(3))
    if packed:
        qkv = _on(cuda, np.concatenate([q, k, v], axis=-1), torch.bfloat16)
        q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
    else:
        q, k, v = (_on(cuda, a, torch.bfloat16).view(B, T, H, d) for a in (q, k, v))
    _build.reset_launch_counts()
    o, l, m = flash_attention.flash_attention_fwd(q, k, v)
    assert _build.launch_counts == {"flash_attention_train": 1}
    want = flash_attention.flash_attention_fwd_plain(q, k, v)
    _close(o, want[0], 8e-3)
    assert torch.equal(o, flash_attention.flash_self_attention(q, k, v))
    torch.testing.assert_close(l, want[1], rtol=1e-5, atol=0.0)
    torch.testing.assert_close(m, want[2], rtol=1e-5, atol=1e-6)
    do = _on(cuda, _np(B, T, H, d, seed=7), torch.bfloat16)
    _build.reset_launch_counts()
    got = flash_attention.flash_attention_bwd(q, k, v, o, l, m, do)
    assert _build.launch_counts == {"flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1}
    want = flash_attention.flash_attention_bwd_plain(q, k, v, o, l, m, do)
    for g, w in zip(got, want):
        assert g.shape == (B, T, H, d) and g.is_contiguous()
        _close_rel(g, w)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention.flash_attention(*leaves)[0].backward(do)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def _beam_onehot(B, K, T, pos, seed):
    """Query beam k of item b attends, at each position t <= pos, the slot of
    a random ancestor beam (K = 1: the causal mask)."""
    rng = np.random.default_rng(seed)
    onehot = np.zeros((B, K, K * T), np.float32)
    for b in range(B):
        for k in range(K):
            for t in range(pos + 1):
                onehot[b, k, rng.integers(K) * T + t] = 1.0
    return onehot


@pytest.mark.parametrize("K", [1, 5])
def test_decode_self_kernel_matches_plain(cuda, K):
    """Layer 1 of a 3-layer cache at Whisper large-v3's width (20 heads x 64),
    T = 70 slots a beam (K * T spans several 128-key chunks at K = 5)."""
    B, T, L, HD, pos = 3, 70, 3, 1280, 40
    q = _on(cuda, _np(B * K, HD, seed=0), torch.bfloat16)
    ck = _on(cuda, _np(L, B * K, T, HD, seed=1), torch.bfloat16)
    cv = _on(cuda, _np(L, B * K, T, HD, seed=2), torch.bfloat16)
    onehot = _on(cuda, _beam_onehot(B, K, T, pos, seed=3))
    _build.reset_launch_counts()
    got = decode_attention.decode_self_attention(q, ck, cv, onehot, 20, 1)
    assert _build.launch_counts == {"decode_self_attention": 1}
    _close(got, decode_attention.decode_self_attention_plain(q, ck, cv, onehot, 20, 1), 4e-3)


@pytest.mark.parametrize("K", [1, 2])
def test_decode_cross_kernel_matches_plain(cuda, K):
    """Layer 2 of a 3-layer store of S = 1500 encoder rows, shared by K beams."""
    B, S, L, HD = 2, 1500, 3, 1280
    q = _on(cuda, _np(B * K, HD, seed=0), torch.bfloat16)
    k = _on(cuda, _np(L, B, S, HD, seed=1), torch.bfloat16)
    v = _on(cuda, _np(L, B, S, HD, seed=2), torch.bfloat16)
    _build.reset_launch_counts()
    got = decode_attention.decode_cross_attention(q, k, v, 20, 2)
    assert _build.launch_counts == {"decode_cross_attention": 1}
    _close(got, decode_attention.decode_cross_attention_plain(q, k, v, 20, 2), 4e-3)


def test_whisper_kernels_reject_what_they_do_not_take(cuda):
    """A CUDA tensor the kernels do not take raises and is never sent to the
    plain version: the FFN's dropout at D = 640 (no config's width), head_dim
    32, > 64 beams."""
    _build.reset_launch_counts()
    x = torch.zeros(1, 8, 640, device=cuda, dtype=torch.bfloat16)
    w1 = torch.zeros(512, 640, device=cuda, dtype=torch.bfloat16)
    b1, g = torch.zeros(512, device=cuda), torch.ones(640, device=cuda)
    with pytest.raises(ValueError, match="the kernel takes D"):
        ffn.ffn_ln_fc1(x, w1, b1, g, g, rate=0.1,
                       seeds=torch.zeros(1, dtype=torch.int32, device=cuda))
    q = torch.zeros(1, 64, 4, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_self_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(q, q, q)
    cache = torch.zeros(2, 1, 8, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention.decode_cross_attention(cache[0, :, 0], cache, cache, 4, 0)
    many = torch.zeros(2, 65, 8, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="beams"):
        decode_attention.decode_self_attention(many[0, :, 0], many, many,
                                               torch.ones(1, 65, 65 * 8, device=cuda), 2, 0)
    assert not _build.launch_counts


# The decode kernel keeps p in fp32; the plain version (the JAX composition)
# rounds p to bf16 before p @ v, each p within 2**-9 of itself over weights
# that sum to 1: |kernel - plain| <= 2**-9 max|v| plus two bf16 ulps. Against
# the same arithmetic with p in fp32 (``_decode_fp32``) only the sums' order
# differs: one bf16 ulp of the output (2**-8 relative) and 1e-5.
P_ROUNDING = 2.0**-9
WHISPER_HEADS = [6, 8, 12, 16, 20]  # tiny, base, small, medium, large-v3 (head_dim 64)


def _decode_fp32(q, k, v, mask, n_heads, layer):
    """fp32 decode attention of q (B*K, HD) over layer ``layer`` of the (L, B,
    N, HD) store k, v (the self cache read as (L, B, K*T, HD)); mask (B, K,
    N) or None; p never rounded."""
    _, B, N, HD = k.shape
    K, d = q.shape[0] // B, HD // n_heads
    qh = q.float().view(B, K, n_heads, d)
    kh, vh = (t[layer].float().view(B, N, n_heads, d) for t in (k, v))
    s = torch.einsum("bkhd,bnhd->bkhn", qh, kh) * d**-0.5
    if mask is not None:
        s = torch.where(mask[:, :, None, :] > 0, s, -1e30)
    return torch.einsum("bkhn,bnhd->bkhd", torch.softmax(s, dim=-1), vh).reshape(B * K, HD)


def _decode_close(got, want_plain, want_fp32, v):
    torch.cuda.synchronize()
    _close(got, want_plain, P_ROUNDING * float(v.float().abs().max()))
    err = (got.float() - want_fp32).abs()
    assert (err <= 1e-5 + 2.0**-8 * want_fp32.abs()).all(), f"max err {err.max().item()}"


def _decode_self_inputs(cuda, B, K, T, H, pos, L=2):
    q = _on(cuda, _np(B * K, H * 64, seed=0), torch.bfloat16)
    ck = _on(cuda, _np(L, B * K, T, H * 64, seed=1), torch.bfloat16)
    cv = _on(cuda, _np(L, B * K, T, H * 64, seed=2), torch.bfloat16)
    return q, ck, cv, _on(cuda, _beam_onehot(B, K, T, pos, seed=3))


@pytest.mark.parametrize("K", [1, 5, 64])
@pytest.mark.parametrize("T", [64, 128, 225, 448])
@pytest.mark.parametrize("H", WHISPER_HEADS)
def test_decode_self_kernel_at_whisper_shapes_matches_plain(cuda, H, T, K):
    """Layer 1 of a 2-layer cache at every Whisper head count, over the
    greedy decode's cache phases (64, 128, 256 slots; 225 is large-v3's last,
    448 its longest), with K = 1, 5 and 64 beams (64: eight beam groups) and
    the causal or ancestor mask at position 2T/3 (at 448 slots the last of
    four ranks holds only masked keys)."""
    B = 1 if K == 64 else 2
    q, ck, cv, onehot = _decode_self_inputs(cuda, B, K, T, H, 2 * T // 3)
    _build.reset_launch_counts()
    got = decode_attention.decode_self_attention(q, ck, cv, onehot, H, 1)
    assert _build.launch_counts == {"decode_self_attention": 1}
    B_, KT = onehot.shape[0], onehot.shape[2]
    _decode_close(got, decode_attention.decode_self_attention_plain(q, ck, cv, onehot, H, 1),
                  _decode_fp32(q, ck.view(2, B_, KT, -1), cv.view(2, B_, KT, -1), onehot, H, 1),
                  cv[1])


@pytest.mark.parametrize("K", [1, 2, 5])
@pytest.mark.parametrize("S", [1, 100, 1500])
@pytest.mark.parametrize("H", WHISPER_HEADS)
def test_decode_cross_kernel_at_whisper_shapes_matches_plain(cuda, H, S, K):
    """Layer 0 of a 2-layer store of S encoder rows (1: a single tile cut at
    one key; 100; Whisper's 1500) at every Whisper head count, shared by K
    beams."""
    B = 2
    q = _on(cuda, _np(B * K, H * 64, seed=0), torch.bfloat16)
    k = _on(cuda, _np(2, B, S, H * 64, seed=1), torch.bfloat16)
    v = _on(cuda, _np(2, B, S, H * 64, seed=2), torch.bfloat16)
    _build.reset_launch_counts()
    got = decode_attention.decode_cross_attention(q, k, v, H, 0)
    assert _build.launch_counts == {"decode_cross_attention": 1}
    _decode_close(got, decode_attention.decode_cross_attention_plain(q, k, v, H, 0),
                  _decode_fp32(q, k, v, None, H, 0), v[0])


@pytest.mark.parametrize("K", [2, 8, 9, 17])
def test_decode_self_kernel_at_partial_beam_groups_matches_plain(cuda, K):
    """K beams around the kernel's groups of 8 (9 and 17: a last group of one
    beam), with one fully masked row, which averages its K*T slots."""
    B, T, H = 2, 64, 20
    q, ck, cv, onehot = _decode_self_inputs(cuda, B, K, T, H, 40)
    onehot[1, K - 1] = 0.0
    got = decode_attention.decode_self_attention(q, ck, cv, onehot, H, 0)
    _decode_close(got, decode_attention.decode_self_attention_plain(q, ck, cv, onehot, H, 0),
                  _decode_fp32(q, ck.view(2, B, K * T, -1), cv.view(2, B, K * T, -1), onehot,
                               H, 0), cv[0])
    mean = cv[0].view(B, K * T, -1)[1].float().mean(0)
    assert (got[-1].float() - mean).abs().max() <= 1e-5 + 2.0**-8 * mean.abs().max()


def test_decode_self_kernel_over_branched_ancestor_chains_matches_plain(cuda):
    """K = 5 beams of 3 items whose ancestries branch as a beam search's do
    (each step every beam takes a seeded parent, then writes its own slot),
    the mask from ``beam_slot_mask`` at two cache phases: 64 slots at position
    40, then the cache padded to 128 and the chains run on to position 100."""
    from coral_tpu_torch.models.whisper import _pad_cache, beam_slot_mask

    B, K, H, L, layer = 3, 5, 20, 2, 1
    rng = np.random.default_rng(11)
    anc = torch.arange(K, dtype=torch.int32)[None, :, None].repeat(B, 1, 225)
    cache = (_on(cuda, _np(L, B * K, 64, H * 64, seed=1), torch.bfloat16),
             _on(cuda, _np(L, B * K, 64, H * 64, seed=2), torch.bfloat16))
    torch.manual_seed(0)
    pos = 0
    for t_b, until in ((64, 40), (128, 100)):
        if t_b > cache[0].shape[2]:
            cache = _pad_cache(cache, t_b)
            cache[0][:, :, 64:].normal_()  # the rows the second phase writes
            cache[1][:, :, 64:].normal_()
        while pos < until:
            parent = torch.from_numpy(rng.integers(0, K, size=(B, K)))
            anc = anc.gather(1, parent[:, :, None].expand(B, K, 225))
            anc[:, :, pos + 1] = torch.arange(K, dtype=torch.int32)
            pos += 1
        assert len({tuple(a) for a in anc[0, :, : pos + 1].tolist()}) > 1, "no branching"
        onehot = beam_slot_mask(anc.to(cuda), pos, t_b)
        assert onehot.shape == (B, K, K * t_b) and onehot.is_contiguous()
        q = _on(cuda, _np(B * K, H * 64, seed=pos), torch.bfloat16)
        ck, cv = cache
        _build.reset_launch_counts()
        got = decode_attention.decode_self_attention(q, ck, cv, onehot, H, layer)
        assert _build.launch_counts == {"decode_self_attention": 1}
        _decode_close(got, decode_attention.decode_self_attention_plain(q, ck, cv, onehot, H,
                                                                        layer),
                      _decode_fp32(q, ck.view(L, B, K * t_b, -1), cv.view(L, B, K * t_b, -1),
                                   onehot, H, layer), cv[layer])


def test_decode_wave_is_two_blocks_an_sm(cuda):
    """Both instantiations hold at least two blocks an SM (the K > 1 one at
    its registers), so a call may launch two an SM: the wave that
    ``cluster_size`` keeps a grid within, and that
    ``tests/test_torch_decode_design.py`` takes for an H100."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    dev = cuda.index or 0
    assert decode_attention.wave_blocks(1, dev) == decode_attention.wave_blocks(5, dev) == 2 * sms


# -- the widths of every config: XLS-R-1B and -2B, Whisper tiny, base, small --------


@pytest.mark.parametrize("C", [1280, 1920])
def test_ln_forward_kernel_at_xls_r_widths_matches_plain(cuda, C):
    """The encoder's ``ln_fused`` at XLS-R-1B's and -2B's widths (1920: lane
    vectors of 4), 999 rows: a ragged last block of 8."""
    x = _on(cuda, _np(3, 333, C, seed=0, scale=2.0, offset=0.3), torch.bfloat16)
    gamma = _on(cuda, _np(C, seed=1, scale=0.1, offset=1.0))
    beta = _on(cuda, _np(C, seed=2, scale=0.1))
    _build.reset_launch_counts()
    got = ln_gelu.ln_fused(x, gamma, beta)
    assert _build.launch_counts == {f"ln_fused_{C}": 1}
    _close(got, ln_gelu.ln_gelu_plain(x, gamma, beta, apply_gelu=False), 1e-2)


@pytest.mark.parametrize("apply_gelu", [False, True])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [(3, 333), (1, 5), (2, 1499)])
def test_ln_forward_kernel_at_the_base_width_matches_plain(cuda, apply_gelu, gdtype, rows):
    """The LayerNorm forward at wav2vec2-base's 768 (bf16 x; lane vectors of
    8, three chunks a lane): with and without the GELU, gamma and beta in
    fp32 and bf16, row counts that leave the last block of 8 rows part
    empty (999, 5) and the serving shape's 11,992."""
    C = 768
    x = _on(cuda, _np(*rows, C, seed=0, scale=2.0, offset=0.3), torch.bfloat16)
    gamma = _on(cuda, _np(C, seed=1, scale=0.1, offset=1.0), gdtype)
    beta = _on(cuda, _np(C, seed=2, scale=0.1), gdtype)
    fn = ln_gelu.ln_gelu if apply_gelu else ln_gelu.ln_fused
    _build.reset_launch_counts()
    got = fn(x, gamma, beta)
    assert _build.launch_counts == {f"{'ln_gelu' if apply_gelu else 'ln_fused'}_768": 1}
    _close(got, ln_gelu.ln_gelu_plain(x, gamma, beta, apply_gelu=apply_gelu), 1e-2)


@pytest.mark.parametrize("C", [384, 768, 1920])
@pytest.mark.parametrize("dtypes", ["bf16/bf16", "bf16/fp32"])
@pytest.mark.parametrize("apply_gelu", [True, False])
def test_ln_bwd_kernel_at_new_widths_matches_plain(cuda, C, dtypes, apply_gelu):
    """The LN backward at Whisper tiny's and small's and XLS-R-2B's widths:
    the encoder LN's gradient (bf16 dy) and the FFN backward's LN step (fp32
    dy); 384 and 1920 take lane vectors of 4."""
    dyd = torch.bfloat16 if dtypes.endswith("bf16") else torch.float32
    x = _on(cuda, _np(3, 333, C, seed=0, scale=2.0, offset=0.3), torch.bfloat16)
    dy = _on(cuda, _np(3, 333, C, seed=1), dyd)
    gamma = _on(cuda, _np(C, seed=2, scale=0.1, offset=1.0))
    beta = _on(cuda, _np(C, seed=3, scale=0.1))
    _build.reset_launch_counts()
    got = ln_gelu.ln_bwd(x, gamma, beta, dy, apply_gelu=apply_gelu)
    assert _build.launch_counts == {f"ln_bwd_{C}": 1}
    want = ln_gelu.ln_bwd_plain(x, gamma, beta, dy, apply_gelu=apply_gelu)
    _close(got[0], want[0], 1e-2)
    for g, w in zip(got[1:], want[1:]):
        _close_rel(g, w, 1e-2)


def _attention_args(cuda, B, T, H, d, packed=False):
    q, k, v = (_np(B, T, H * d, seed=i) for i in range(3))
    if packed:
        qkv = _on(cuda, np.concatenate([q, k, v], axis=-1), torch.bfloat16)
        q, k, v = qkv.split(H * d, dim=-1)
    else:
        q, k, v = (_on(cuda, a, torch.bfloat16) for a in (q, k, v))
    bq, bk, bv = (_on(cuda, _np(H * d, seed=3 + i, scale=0.5), torch.bfloat16) for i in range(3))
    mask = np.ones((B, T), bool)
    mask[1 % B, 80:] = False
    mask[B - 1, :] = False  # a fully padded row
    mask = torch.from_numpy(mask).to(cuda)
    return q, k, v, (bq, bk, bv), mask


@pytest.mark.parametrize("d", [80, 120])
@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
def test_attention_kernels_at_xls_r_head_dims_match_plain(cuda, d, packed):
    """Forward and backward at XLS-R-1B's head_dim 80 (5 WMMA k-steps) and
    -2B's 120 (padded to 128 in shared memory), T = 150, a fully padded row;
    sm_scale d**-0.5 is not exact in bf16."""
    B, T, H = 3, 150, 2
    q, k, v, bias, mask = _attention_args(cuda, B, T, H, d, packed)
    _build.reset_launch_counts()
    o, lse = attention.short_t_attention_flat(q, k, v, mask, d, bias)
    assert _build.launch_counts == {f"attention_fwd_hd{d}": 1}
    want_o, want_lse = attention.attention_plain(q, k, v, mask, d, bias)
    _close(o, want_o, 8e-3)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    assert (lse[2] == -1e25).all()
    key_bias = attention._key_bias(mask)
    do = _on(cuda, _np(B, T, H * d, seed=7), torch.bfloat16)
    args = (q, k, v, *bias, key_bias, do, lse, o, d, d**-0.5)
    _build.reset_launch_counts()
    got = attention.attention_bwd(*args)
    assert _build.launch_counts == {f"attention_bwd_hd{d}": 1}
    want = attention.attention_bwd_plain(*args)
    for g, w in zip(got[:3], want[:3]):
        _close_rel(g, w)
        assert not g[2].any()  # the fully masked row gets no gradient
    _close_rel(got[3], want[3], 1e-2)


@pytest.mark.parametrize("d", [64, 80, 120])
def test_attention_kernels_write_nothing_past_a_head(cuda, d):
    """The padding columns d .. DP-1 (120 .. 127 at d = 120) are never written:
    o, dq, dk and dv go to buffers one row longer than the output, filled with
    a sentinel, so that the last head of the last row, if it wrote past its d
    columns, would overwrite the sentinel; H = 2, so a head's spill would land
    in the next head's columns, which the values' match checks. The same for
    the v1 forward and the recomputing backward (its dq kernel's two sweeps
    and its dkv kernel)."""
    B, T, H = 2, 70, 2
    q, k, v, bias, mask = _attention_args(cuda, B, T, H, d)
    key_bias = attention._key_bias(mask)
    n = B * T * H * d
    sentinel = 7.0

    def buffer():
        return torch.full((n + H * d,), sentinel, dtype=torch.bfloat16, device=cuda)

    stride_b, stride_t, _ = q.stride()
    scale = float(torch.tensor(d**-0.5, dtype=torch.bfloat16))
    ptrs = [t.data_ptr() for t in (q, k, v, *bias, key_bias)]
    o_buf, lse = buffer(), torch.empty(B, H, T, device=cuda)
    _build.launch("coral_attention_fwd", "sentinel", *ptrs, o_buf.data_ptr(), lse.data_ptr(),
                  B, T, H, d, stride_b, stride_t, scale, 0)
    torch.cuda.synchronize()
    assert (o_buf[n:] == sentinel).all()
    o, _ = attention._fwd(q, k, v, *bias, key_bias, d, d**-0.5)
    assert torch.equal(o_buf[:n].view(B, T, H * d), o)
    do = _on(cuda, _np(B, T, H * d, seed=7), torch.bfloat16)
    grads = [buffer() for _ in range(3)]
    db_part = torch.empty(B, -(-T // attention._TILE), 3, H * d, device=cuda)
    delta = torch.empty(B, H, T, device=cuda)
    _build.launch("coral_attention_bwd", "sentinel", *ptrs, do.data_ptr(), lse.data_ptr(),
                  o.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
                  db_part.data_ptr(), B, T, H, d, stride_b, stride_t, H * d, scale, d**-0.5)
    torch.cuda.synchronize()
    want = attention.attention_bwd(q, k, v, *bias, key_bias, do, lse, o, d, d**-0.5)
    for g, w in zip(grads, want[:3]):
        assert (g[n:] == sentinel).all()
        assert torch.equal(g[:n].view(B, T, H * d), w)
    assert torch.equal(db_part.sum(dim=(0, 1)), want[3])
    # The v1 forward and a backward whose dq kernel sweeps twice, without biases.
    ptrs = [t.data_ptr() for t in (q, k, v)]
    o_buf = buffer()
    _build.launch("coral_attention_fwd", "sentinel", *ptrs, None, None, None,
                  key_bias.data_ptr(), o_buf.data_ptr(), lse.data_ptr(), B, T, H, d, stride_b,
                  stride_t, scale, 1)
    torch.cuda.synchronize()
    assert (o_buf[n:] == sentinel).all()
    o, lse = attention._fwd(q, k, v, None, None, None, key_bias, d, d**-0.5, "stats")
    assert torch.equal(o_buf[:n].view(B, T, H * d), o)
    grads = [buffer() for _ in range(3)]
    scratch = torch.empty(3, B, H, T, device=cuda)
    _build.launch("coral_attention_bwd_rows", "sentinel", *ptrs, key_bias.data_ptr(),
                  do.data_ptr(), None, o.data_ptr(), *(t.data_ptr() for t in scratch),
                  *(g.data_ptr() for g in grads), B, T, H, d, stride_b, stride_t, H * d, scale,
                  d**-0.5, 1)
    torch.cuda.synchronize()
    want = attention.attention_bwd(q, k, v, None, None, None, key_bias, do, None, o, d, d**-0.5,
                                   route="attention")
    for g, w in zip(grads, want[:3]):
        assert (g[n:] == sentinel).all()
        assert torch.equal(g[:n].view(B, T, H * d), w)


def test_new_widths_are_counted_apart_and_unbuilt_widths_raise(cuda):
    """Each width launches under its own name; a width no config uses (640,
    896, head_dim 96) raises on the card and launches nothing."""
    bf16 = torch.bfloat16
    _build.reset_launch_counts()
    for C in (384, 1920):
        x = torch.zeros(2, 9, C, device=cuda, dtype=bf16)
        ln_gelu.ln_bwd(x, torch.ones(C, device=cuda), torch.zeros(C, device=cuda), x.float(),
                       apply_gelu=False)
    assert _build.launch_counts == {"ln_bwd_384": 1, "ln_bwd_1920": 1}
    _build.reset_launch_counts()
    x = torch.zeros(2, 9, 896, device=cuda, dtype=bf16)
    with pytest.raises(ValueError, match="Queue 2 item 3"):
        ln_gelu.ln_fused(x, torch.ones(896, device=cuda), torch.zeros(896, device=cuda))
    x = torch.zeros(2, 9, 640, device=cuda, dtype=bf16)
    w1 = torch.zeros(512, 640, device=cuda, dtype=bf16)
    with pytest.raises(ValueError, match="Queue 2 item 3"):
        ffn.ffn_ln_fc1(x, w1, torch.zeros(512, device=cuda), torch.ones(640, device=cuda),
                       torch.zeros(640, device=cuda))
    q = torch.zeros(1, 8, 192, device=cuda, dtype=bf16)
    b = torch.zeros(192, device=cuda, dtype=bf16)
    with pytest.raises(ValueError, match="Queue 2 item 3"):
        attention.short_t_attention_flat(q, q, q, torch.ones(1, 8, dtype=torch.bool,
                                                             device=cuda), 96, (b, b, b))
    assert not _build.launch_counts
    assert _build.library().coral_ffn_row_tile(640) == -1
    assert [_build.library().coral_ffn_row_tile(D) for D in ALL_D] == [128] * 6


def test_ln_bwd_block_count_comes_from_the_card(cuda):
    """The LN backward's grid is the library's, found once per card: a
    grid-filling count (at most 4 blocks an SM), the same on every call, and
    -1 for a combination not built (a width, fp32 x with bf16 dy)."""
    lib = _build.library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for C in (384, 512, 768, 1024, 1280, 1920):
        for dy_bf16 in (0, 1):
            for gelu in (0, 1):
                many = lib.coral_ln_bwd_blocks(C, 1, dy_bf16, gelu)
                assert 1 <= many <= 4 * sms and many % sms == 0, (C, dy_bf16, gelu, many)
                assert lib.coral_ln_bwd_blocks(C, 1, dy_bf16, gelu) == many
    assert lib.coral_ln_bwd_blocks(640, 1, 1, 0) == -1
    assert lib.coral_ln_bwd_blocks(1024, 0, 1, 0) == -1
    assert lib.coral_ln_bwd_blocks(1920, 0, 0, 0) == -1


# -- the LayerNorm pair's Hopper design: one C call each way, gamma in its own dtype --


def _ln_bwd_built():
    """Every built (x, dy, C) of the LN backward."""
    bf16, fp32 = torch.bfloat16, torch.float32
    return ([(bf16, dy, C) for dy in (bf16, fp32) for C in ln_gelu.KERNEL_C_BWD[bf16]]
            + [(fp32, fp32, C) for C in ln_gelu.KERNEL_C_BWD[fp32]])


def _ln_bwd_inputs(cuda, rows, C, xd, dyd, gd):
    x = _on(cuda, _np(rows, C, seed=0, scale=2.0, offset=0.3), xd)
    dy = _on(cuda, _np(rows, C, seed=1), dyd)
    gamma = _on(cuda, _np(C, seed=2, scale=0.1, offset=1.0), gd)
    beta = _on(cuda, _np(C, seed=3, scale=0.1), gd)
    return x, gamma, beta, dy


@pytest.mark.parametrize("xd,dyd,C", _ln_bwd_built(),
                         ids=lambda v: str(v).replace("torch.", "") if not isinstance(v, int)
                         else str(v))
@pytest.mark.parametrize("gd", [torch.bfloat16, torch.float32], ids=["g_bf16", "g_fp32"])
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 3992, 12000, "grid"])
def test_ln_bwd_at_every_built_combination_matches_plain(cuda, xd, dyd, C, gd, rows):
    """dx, dgamma and dbeta of every built (x, dy, gamma dtype, C) against the
    plain version, at row counts about the teams, the blocks and the grid
    ("grid": one more than the cached grid x 8 rows); dgamma and dbeta in
    gamma's dtype; one launch count."""
    gelu = bool(C % 3) if rows == "grid" else rows % 2 == 1
    flags = (int(xd == torch.bfloat16), int(dyd == torch.bfloat16), int(gelu))
    if rows == "grid":
        rows = _build.library().coral_ln_bwd_blocks(C, *flags) * 8 + 1
    x, gamma, beta, dy = _ln_bwd_inputs(cuda, rows, C, xd, dyd, gd)
    _build.reset_launch_counts()
    got = ln_gelu.ln_bwd(x, gamma, beta, dy, apply_gelu=gelu)
    assert _build.launch_counts == {ln_gelu._name("ln_bwd", C): 1}
    want = ln_gelu.ln_bwd_plain(x, gamma, beta, dy, apply_gelu=gelu)
    assert got[0].dtype == xd and got[1].dtype == gd and got[2].dtype == gd
    _close(got[0], want[0], 1e-2)
    for g, w in zip(got[1:], want[1:]):
        _close_rel(g, w, 1e-2)


@pytest.mark.parametrize("C", [384, 1024, 1920])
def test_ln_bwd_gives_the_same_bits_twice(cuda, C):
    """The column sums run in a fixed order over a fixed grid: two calls, the
    same bits."""
    x, gamma, beta, dy = _ln_bwd_inputs(cuda, 3992, C, torch.bfloat16, torch.bfloat16,
                                        torch.bfloat16)
    first = ln_gelu.ln_bwd(x, gamma, beta, dy, apply_gelu=False)
    second = ln_gelu.ln_bwd(x, gamma, beta, dy, apply_gelu=False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("C", [512, 768, 1024, 1280, 1920])
@pytest.mark.parametrize("apply_gelu", [False, True])
def test_ln_with_bf16_gamma_is_the_fp32_gamma_kernel_bit_for_bit(cuda, C, apply_gelu):
    """bf16 gamma and beta, widened in registers, give the kernels' own results
    for the same values in fp32: y and dx exactly, dgamma and dbeta the fp32
    sums rounded once to bf16."""
    bf16 = torch.bfloat16
    x, g16, b16, dy = _ln_bwd_inputs(cuda, 3992, C, bf16, bf16, bf16)
    g32, b32 = g16.float(), b16.float()
    fwd = ln_gelu.ln_gelu if apply_gelu else ln_gelu.ln_fused
    if C in ln_gelu.KERNEL_C[bf16]:
        assert torch.equal(fwd(x, g16, b16), fwd(x, g32, b32))
    dx16, dg16, db16 = ln_gelu.ln_bwd(x, g16, b16, dy, apply_gelu=apply_gelu)
    dx32, dg32, db32 = ln_gelu.ln_bwd(x, g32, b32, dy, apply_gelu=apply_gelu)
    assert torch.equal(dx16, dx32)
    assert dg16.dtype == db16.dtype == bf16 and dg32.dtype == db32.dtype == torch.float32
    assert torch.equal(dg16, dg32.to(bf16)) and torch.equal(db16, db32.to(bf16))


def _device_kernels(fn) -> list:
    """The names of the device kernels ``fn`` launched, by the profiler. On
    the card machine the profiler at times records nothing of a whole window,
    so a window with no kernel at all is profiled again, up to three times,
    as ``chip_smoke.py``'s ``device_ms`` does; a call that launches nothing
    still gives none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("Memset", "Memcpy"))]
        if names:
            return names
    return names


@pytest.mark.parametrize("C", [1024, 1280, 1920])
def test_ln_with_bf16_work_copies_launches_one_kernel_forward_two_backward(cuda, C):
    """One LayerNorm under autograd with bf16 gamma and beta that require a
    gradient, as the training step's work copies: the profiler counts one
    device kernel for the forward and at most two for the backward (the row
    and column kernels), no cast and no sum."""
    bf16 = torch.bfloat16
    x, gamma, beta, dy = _ln_bwd_inputs(cuda, 3992, C, bf16, bf16, bf16)
    leaves = [t.requires_grad_(True) for t in (x, gamma, beta)]
    ln_gelu.ln_fused(*leaves)  # the library is built and the grid found
    out = {}
    fwd = _device_kernels(lambda: out.setdefault("y", ln_gelu.ln_fused(*leaves)))
    bwd = _device_kernels(lambda: out.setdefault("g", torch.autograd.grad(out["y"], leaves, dy)))
    assert len(fwd) == 1, fwd
    assert 1 <= len(bwd) <= 2, bwd
    assert [g.dtype for g in out["g"]] == [bf16] * 3


def test_ln_direct_path_gives_the_functions_bits(cuda):
    """Without a gradient to record, ln_fused and ln_gelu call the forward
    wrapper directly: the same bits as through autograd; ``saved`` still
    launches nothing."""
    bf16 = torch.bfloat16
    x, gamma, beta, _ = _ln_bwd_inputs(cuda, 999, 1024, bf16, bf16, bf16)
    for fn in (ln_gelu.ln_fused, ln_gelu.ln_gelu):
        with torch.no_grad():
            direct = fn(x, gamma, beta)
        plain_inputs = fn(x, gamma, beta)
        recorded = fn(x.clone().requires_grad_(True), gamma, beta)
        assert recorded.requires_grad and not direct.requires_grad
        assert torch.equal(direct, recorded) and torch.equal(plain_inputs, recorded)
    _build.reset_launch_counts()
    saved = torch.ones_like(x)
    with torch.no_grad():
        assert torch.equal(ln_gelu.ln_fused(x, gamma, beta, saved=saved), saved)
    assert ln_gelu.ln_fused(x, gamma, beta, saved=saved) is not saved
    assert not _build.launch_counts


# -- the unfused routes: flash attention with segment ids, GELU + dropout ------------


@pytest.mark.parametrize("T,lengths", [(1499, (1499, 1000, 700, 1)), (499, (499, 300, 64, 1))])
def test_flash_attention_segment_kernels_match_plain(cuda, T, lengths):
    """wav2vec2's flash route at the serving (1499 -> 1536) and training (499
    -> 512) frame counts, with a full, two padded and a length-1 filler row:
    the forward (o; o, l, m) and the backward's two kernels against the plain
    versions of the padded call, then the autograd Function."""
    B, H, d = len(lengths), 2, 64
    pad_mask = torch.arange(T, device=cuda)[None, :] < torch.tensor(lengths, device=cuda)[:, None]
    ids = flash_attention.segment_ids(pad_mask)
    q, k, v = (_on(cuda, _np(B, T, H * d, seed=i), torch.bfloat16).view(B, T, H, d)
               for i in range(3))
    _build.reset_launch_counts()
    o_serve = flash_attention.flash_self_attention(q, k, v, segment_ids=ids)
    o, l, m = flash_attention.flash_attention_fwd(q, k, v, segment_ids=ids)
    assert _build.launch_counts == {"flash_attention_seg": 1, "flash_attention_seg_train": 1}
    want = flash_attention._padded_fwd_plain(q, k, v, ids)
    _close(o, want[0], 8e-3)
    assert torch.equal(o, o_serve)
    torch.testing.assert_close(l, want[1], rtol=1e-5, atol=0.0)
    torch.testing.assert_close(m, want[2], rtol=1e-5, atol=1e-6)
    do = _on(cuda, _np(B, T, H, d, seed=7), torch.bfloat16)
    _build.reset_launch_counts()
    got = flash_attention.flash_attention_bwd(q, k, v, o, l, m, do, segment_ids=ids)
    assert _build.launch_counts == {"flash_attention_seg_bwd_dkv": 1,
                                    "flash_attention_seg_bwd_dq": 1}
    for g, w in zip(got, flash_attention._padded_bwd_plain(q, k, v, o, l, m, do, ids)):
        assert g.shape == (B, T, H, d) and g.is_contiguous()
        _close_rel(g, w)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention.flash_attention(*leaves, segment_ids=ids)[0].backward(do)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


@pytest.mark.parametrize("d", [80, 120])
@pytest.mark.parametrize("segments", [False, True], ids=["unmasked", "segment_ids"])
@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
def test_flash_attention_kernels_at_xls_r_head_dims_match_plain(cuda, d, segments, packed):
    """The four flash kernels (the forward, the forward with stats, dkv and
    dq) at XLS-R-1B's head_dim 80 and -2B's 120 (padded to 128 in the
    tiles), with segment ids (the training frames 499 -> 512: a full, two
    padded and a length-1 filler row) and without, on separate tensors and on
    views of one packed projection; each launch counted under its head dim."""
    B, T, H = 4, 499, 2
    tail = f"_hd{d}"
    ids = None
    if segments:
        lengths = torch.tensor((499, 300, 64, 1), device=cuda)
        ids = flash_attention.segment_ids(torch.arange(T, device=cuda)[None, :] < lengths[:, None])
    q, k, v = (_np(B, T, H * d, seed=i) for i in range(3))
    if packed:
        qkv = _on(cuda, np.concatenate([q, k, v], axis=-1), torch.bfloat16)
        q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
    else:
        q, k, v = (_on(cuda, a, torch.bfloat16).view(B, T, H, d) for a in (q, k, v))
    base = "flash_attention_seg" if segments else "flash_attention"
    _build.reset_launch_counts()
    o_serve = flash_attention.flash_self_attention(q, k, v, segment_ids=ids)
    o, l, m = flash_attention.flash_attention_fwd(q, k, v, segment_ids=ids)
    assert _build.launch_counts == {base + tail: 1, f"{base}_train{tail}": 1}
    want = flash_attention._padded_fwd_plain(q, k, v, ids)
    _close(o, want[0], 8e-3)
    assert torch.equal(o, o_serve)
    torch.testing.assert_close(l, want[1], rtol=1e-5, atol=0.0)
    torch.testing.assert_close(m, want[2], rtol=1e-5, atol=1e-6)
    do = _on(cuda, _np(B, T, H, d, seed=7), torch.bfloat16)
    _build.reset_launch_counts()
    got = flash_attention.flash_attention_bwd(q, k, v, o, l, m, do, segment_ids=ids)
    assert _build.launch_counts == {f"{base}_bwd_dkv{tail}": 1, f"{base}_bwd_dq{tail}": 1}
    for g, w in zip(got, flash_attention._padded_bwd_plain(q, k, v, o, l, m, do, ids)):
        assert g.shape == (B, T, H, d) and g.is_contiguous()
        _close_rel(g, w)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention.flash_attention(*leaves, segment_ids=ids)[0].backward(do)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


@pytest.mark.parametrize("d", [64, 80, 120])
def test_flash_attention_kernels_write_nothing_past_a_head(cuda, d):
    """o, dq, dk and dv of the segment-id kernels go to buffers one head
    longer than the output, filled with a sentinel: the last head of the last
    row, if it wrote past its d columns (120 .. 127 of the padded tile at d =
    120), would overwrite it; with H = 2 a spill of the first head would land
    in the second's columns, which the values' match checks. The dq launch's
    di scratch goes to a buffer one (b, h) row longer, which the dkv launch
    reads."""
    B, T, H = 2, 130, 2
    ids = flash_attention.segment_ids(torch.arange(T, device=cuda)[None, :]
                                      < torch.tensor((130, 70), device=cuda)[:, None])
    q, k, v, do = (_on(cuda, _np(B, T, H, d, seed=i), torch.bfloat16) for i in range(4))
    n, sentinel = B * T * H * d, 7.0

    def buffer():
        return torch.full((n + H * d,), sentinel, dtype=torch.bfloat16, device=cuda)

    stride_b, stride_t = q.stride()[:2]
    ptrs = [t.data_ptr() for t in (q, k, v)]
    o_buf, l, m = buffer(), torch.empty(B, H, T, device=cuda), torch.empty(B, H, T, device=cuda)
    _build.launch("coral_flash_attention_fwd", "sentinel", *ptrs, o_buf.data_ptr(), m.data_ptr(),
                  l.data_ptr(), ids.data_ptr(), B, T, ids.shape[1], H, d, stride_b, stride_t,
                  float(d) ** -0.5)
    torch.cuda.synchronize()
    assert (o_buf[n:] == sentinel).all()
    o, l2, m2 = flash_attention.flash_attention_fwd(q, k, v, segment_ids=ids)
    assert torch.equal(o_buf[:n].view(B, T, H, d), o)
    assert torch.equal(l, l2) and torch.equal(m, m2)
    grads = [buffer() for _ in range(3)]
    di = torch.full((B * H * T + T,), sentinel, device=cuda)  # one (b, h) row longer
    for dq, dk, dv in ((grads[0], None, None), (None, grads[1], grads[2])):  # dq first
        _build.launch("coral_flash_attention_bwd", "sentinel", *ptrs, o.data_ptr(),
                      do.data_ptr(), m.data_ptr(), l.data_ptr(), ids.data_ptr(), di.data_ptr(),
                      *(None if g is None else g.data_ptr() for g in (dq, dk, dv)), B, T,
                      ids.shape[1], H, d, stride_b, stride_t, float(d) ** -0.5)
    torch.cuda.synchronize()
    assert (di[B * H * T:] == sentinel).all()
    assert torch.equal(di[:B * H * T].view(B, H, T),
                       flash_attention.flash_attention_bwd_dq(q, k, v, o, l, m, do, ids)[1])
    want = flash_attention.flash_attention_bwd(q, k, v, o, l, m, do, segment_ids=ids)
    for g, w in zip(grads, want):
        assert (g[n:] == sentinel).all()
        assert torch.equal(g[:n].view(B, T, H, d), w)


def test_flash_attention_of_an_unbuilt_head_dim_raises_on_the_card(cuda):
    """head_dim 96 (no config's) raises, naming the built head dims and Queue
    2 item 3, and launches nothing; the C entry refuses it too."""
    _build.reset_launch_counts()
    q = torch.zeros(1, 130, 2, 96, device=cuda, dtype=torch.bfloat16)
    ids = torch.ones(1, 256, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(64, 80, 120\).*Queue 2 item 3"):
        flash_attention.flash_self_attention(q, q, q, segment_ids=ids)
    assert not _build.launch_counts
    o = torch.empty_like(q)
    lib = _build.library()
    assert lib.coral_flash_attention_fwd(q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(),
                                         None, None, ids.data_ptr(), 1, 130, 256, 2, 96, 192,
                                         192, 96**-0.5, None) == -1


# -- the probes: tools/probe_fe_bwd.py, probe_gelu_cost.py, probe_lane_reduce.py -----


@pytest.mark.parametrize("k,T_in", [(3, 1101), (2, 999)])
@pytest.mark.parametrize("mode", probe_fe_bwd.MODES)
def test_fe_bwd_probe_kernels_match_plain(cuda, mode, k, T_in):
    """Each mode of the K3 backward against its plain version (the
    production backward's tolerances), ``full`` bit for bit the production
    kernels' outputs, each launch recorded by the events; T_in 1101 makes
    three 256-pair slabs, the last partial, for no_inter's layout."""
    x, w, b, gamma, beta = _conv_inputs(cuda, k, T_in)
    _, xhat, rstd = conv_ln_gelu.conv_ln_gelu_fwd(x, w, b, gamma, beta)
    dy = _on(cuda, _np(*xhat.shape, seed=5), torch.bfloat16)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for e in events:
        e.record()
    _build.reset_launch_counts()
    got = probe_fe_bwd.bwd_variant(x, w, gamma, beta, xhat, rstd, dy, mode, events=events)
    assert _build.launch_counts == {f"probe_fe_bwd_{mode}": 1}
    torch.cuda.synchronize()
    assert all(a.elapsed_time(b) >= 0 for a, b in zip(events, events[1:]))
    want = probe_fe_bwd.bwd_variant_plain(x, w, gamma, beta, xhat, rstd, dy, mode)
    _close_rel(got[0], want[0])
    _close_rel(got[1], want[1])
    _close_rel(got[2], want[2], 1e-2)
    if mode == "full":
        prod = conv_ln_gelu.conv_ln_gelu_bwd(x, w, gamma, beta, xhat, rstd, dy)
        for g, p in zip(got, prod):
            assert torch.equal(g, p)


@pytest.mark.parametrize("name,polys,prng", probe_gelu_cost.CASES,
                         ids=[c[0].split()[0] for c in probe_gelu_cost.CASES])
def test_gelu_cost_probe_kernel_matches_plain(cuda, name, polys, prng):
    """Each case at 3 steps (768 rows) of the probe's widths; the mask drops
    exactly the plain version's elements."""
    x, w = probe_gelu_cost.make_inputs(3, cuda)
    _build.reset_launch_counts()
    got = probe_gelu_cost.gelu_cost(x, w, polys, prng, seed=11)
    assert _build.launch_counts == {probe_gelu_cost.kernel_name(polys, prng): 1}
    want = probe_gelu_cost.gelu_cost_plain(x, w, polys, prng, seed=11)
    _close(got, want, 1e-2)
    if prng:
        assert torch.equal(got == 0, want == 0)


@pytest.mark.parametrize("nred,mode", probe_lane_reduce.CASES,
                         ids=[f"{m}-{n}" for n, m in probe_lane_reduce.CASES])
def test_lane_reduce_probe_kernel_matches_plain(cuda, nred, mode):
    """Each case at 3 steps (768 rows) of the probe's widths."""
    x, w, ones = probe_lane_reduce.make_inputs(3, cuda)
    _build.reset_launch_counts()
    got = probe_lane_reduce.lane_reduce(x, w, ones, mode, nred)
    assert _build.launch_counts == {probe_lane_reduce.kernel_name(mode, nred): 1}
    _close(got, probe_lane_reduce.lane_reduce_plain(x, w, ones, mode, nred), 1e-2)


@pytest.mark.parametrize("shape", [(2, 499, 4096), (2, 130, 5120), (3, 7, 1536)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_gelu_dropout_kernels_match_plain(cuda, shape, rate):
    """The forward and backward at XLS-R-300M's and Whisper large-v3's F, and
    at a few rows of Whisper tiny's; rate 0 keeps all, rate 0.1 drops exactly
    the plain version's elements (the same Philox bits)."""
    B, T, F = shape
    x = _on(cuda, _np(*shape, seed=0, scale=2.0), torch.bfloat16)
    dy = _on(cuda, _np(*shape, seed=1), torch.bfloat16)
    seeds = (torch.tensor([5, -9, 2**31 - 1], dtype=torch.int32, device=cuda)[:B]
             if rate else None)
    _build.reset_launch_counts()
    out = gelu_dropout.gelu_dropout_fwd(x, rate, seeds)
    dx = gelu_dropout.gelu_dropout_bwd(x, dy, rate, seeds)
    assert _build.launch_counts == {f"gelu_dropout_{F}": 1, f"gelu_dropout_bwd_{F}": 1}
    _close(out, gelu_dropout.gelu_dropout_plain(x, rate, seeds), 1e-2)
    _close(dx, gelu_dropout.gelu_dropout_bwd_plain(x, dy, rate, seeds), 1e-2)
    if rate:
        keep = philox.keep_mask(seeds, T, F, rate)
        assert not out[~keep].any() and not dx[~keep].any()
        assert (out[keep] != 0).float().mean() > 0.99
    leaf = x.detach().clone().requires_grad_(True)
    gelu_dropout.gelu_dropout(leaf, rate, seeds).backward(dy)
    assert torch.equal(leaf.grad, dx)


def test_unfused_kernels_reject_what_they_do_not_take(cuda):
    """A CUDA tensor the kernels do not take raises and is never sent to the
    plain version: F not a multiple of 8, fp32, dropout without seeds, segment
    ids shorter than T or not int32."""
    _build.reset_launch_counts()
    x = torch.zeros(1, 4, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        gelu_dropout.gelu_dropout_fwd(x, 0.0)
    with pytest.raises(TypeError, match="bfloat16"):
        gelu_dropout.gelu_dropout_fwd(torch.zeros(1, 4, 16, device=cuda), 0.0)
    with pytest.raises(ValueError, match="seeds"):
        gelu_dropout.gelu_dropout_fwd(x.new_zeros(1, 4, 8), 0.1)
    q = torch.zeros(1, 130, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="segment ids"):
        flash_attention.flash_self_attention(q, q, q, segment_ids=torch.ones(
            1, 128, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="segment ids"):
        flash_attention.flash_self_attention(q, q, q, segment_ids=torch.ones(1, 256, device=cuda))
    assert not _build.launch_counts


# -- the packed QKV projection and the attention without biases ---------------------

QKV_D = [1024, 1280, 1920]


def _ln_dense_args(cuda, D, T=75):
    F = 3 * D
    x = _on(cuda, _np(2, T, D, seed=0, offset=0.2), torch.bfloat16)
    w = _on(cuda, _np(F, D, seed=1, scale=D**-0.5), torch.bfloat16)
    b = _on(cuda, _np(F, seed=2, scale=0.1))
    gamma = _on(cuda, _np(D, seed=3, scale=0.1, offset=1.0))
    beta = _on(cuda, _np(D, seed=4, scale=0.1))
    dy = _on(cuda, _np(2, T, F, seed=5), torch.bfloat16)
    return x, w, b, gamma, beta, dy


@pytest.mark.parametrize("D", QKV_D)
def test_ln_dense_kernels_match_plain(cuda, D):
    """The forward and the backward (its kernels, then the LayerNorm
    backward) at F = 3 D, 150 rows: a ragged last row tile (64 rows, 32 at D
    1920) and, at D 1920, F = 5760 ending in a 128-column tail."""
    x, w, b, gamma, beta, dy = _ln_dense_args(cuda, D)
    tail = "" if D == 1024 else f"_{D}"
    _build.reset_launch_counts()
    y = ffn.ln_dense_fwd(x, w, b, gamma, beta)
    assert _build.launch_counts == {f"ln_dense{tail}": 1}
    _close(y, ffn.ln_dense_plain(x, w, b, gamma, beta), 1e-2)
    _build.reset_launch_counts()
    got = ffn.ln_dense_bwd(x, w, gamma, beta, dy)
    assert _build.launch_counts == {f"ln_dense_bwd{tail}": 1, f"ln_bwd{tail}": 1}
    want = ffn.ln_dense_bwd_plain(x, w, gamma, beta, dy)
    _close_rel(got[0], want[0])
    _close(got[1], want[1], 1e-2)
    for g, wnt in zip(got[2:], want[2:]):
        _close_rel(g, wnt, 1e-2)


def test_ln_dense_writes_nothing_past_its_columns(cuda):
    """D 1920: the last column tile covers 5632 .. 5887 of F = 5760; y goes to
    a buffer one row longer than the output, filled with a sentinel, which
    the last row, if it wrote past F, would overwrite."""
    D, M = 1920, 2 * 75
    x, w, b, gamma, beta, _ = _ln_dense_args(cuda, D)
    F = 3 * D
    buf = torch.full((M * F + F,), 7.0, dtype=torch.bfloat16, device=cuda)
    _build.launch("coral_ln_dense_fwd", "sentinel", x.data_ptr(), w.data_ptr(), b.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), buf.data_ptr(), M, D, F, 1e-5)
    torch.cuda.synchronize()
    assert (buf[M * F:] == 7.0).all()
    assert torch.equal(buf[:M * F].view(2, 75, F), ffn.ln_dense_fwd(x, w, b, gamma, beta))


@pytest.mark.parametrize("D", QKV_D)
def test_ln_dense_rows_kernel_writes_the_forward_operand(cuda, D):
    """The backward's rows kernel recomputes the LayerNorm with the forward
    mainloop's arithmetic: through W = three stacked identities and b = 0
    the forward's y is its bf16 operand itself (one product term a column,
    accumulated in fp32 with zeros), so each third of y equals the
    backward's ln_out bit for bit, the 1920 tail tile included."""
    x, _, _, gamma, beta, dy = _ln_dense_args(cuda, D)
    eye = torch.eye(D, device=cuda, dtype=torch.bfloat16)
    w = torch.cat([eye, eye, eye])
    y = ffn.ln_dense_fwd(x, w, torch.zeros(3 * D, device=cuda), gamma, beta)
    ln_out = ffn.ln_dense_bwd(x, w, gamma, beta, dy)[1]
    for third in y.chunk(3, dim=-1):
        assert torch.equal(third, ln_out)


def test_ln_dense_autograd_launches_its_kernels(cuda):
    """``ln_dense`` on the card: the forward kernel, then in the backward its
    kernels and the LayerNorm backward, dW a product outside; its gradients
    as the plain Function's."""
    x, w, b, gamma, beta, dy = _ln_dense_args(cuda, 1024)
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b, gamma, beta)]
        _build.reset_launch_counts()
        ffn.ln_dense(*leaves, plain=plain).backward(dy)
        assert _build.launch_counts == ({} if plain else {"ln_dense": 1, "ln_dense_bwd": 1,
                                                          "ln_bwd": 1})
        grads.append([leaf.grad for leaf in leaves])
    for g, wnt in zip(*grads):
        _close_rel(g, wnt, 2e-2)


@pytest.mark.parametrize("d", [64, 80, 120])
@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
def test_attention_kernels_without_biases_match_plain(cuda, d, packed):
    """Forward and backward without in-kernel biases at each head dim, T =
    150, padded keys and a fully padded row, counted apart from the biased
    kernels; bit for bit the biased kernels' output at zero biases (bf16 q +
    0 = q); on packed q, k, v the backward writes one packed gradient."""
    B, T, H = 3, 150, 2
    q, k, v, _, mask = _attention_args(cuda, B, T, H, d, packed)
    fwd, bwd = attention._name("fwd", d, bias=False), attention._name("bwd", d, bias=False)
    _build.reset_launch_counts()
    o, lse = attention.short_t_attention_flat(q, k, v, mask, d)
    assert _build.launch_counts == {fwd: 1}
    want_o, want_lse = attention.attention_plain(q, k, v, mask, d)
    _close(o, want_o, 8e-3)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    assert (lse[2] == -1e25).all()
    key_bias = attention._key_bias(mask)
    zero = torch.zeros(H * d, dtype=torch.bfloat16, device=cuda)
    o_b, lse_b = attention._fwd(q, k, v, zero, zero, zero, key_bias, d, d**-0.5)
    assert torch.equal(o, o_b) and torch.equal(lse, lse_b)
    do = _on(cuda, _np(B, T, H * d, seed=7), torch.bfloat16)
    args = (q, k, v, None, None, None, key_bias, do, lse, o, d, d**-0.5)
    _build.reset_launch_counts()
    got = attention.attention_bwd(*args)
    assert _build.launch_counts == {bwd: 1} and got[3] is None
    want = attention.attention_bwd_plain(*args)
    got_b = attention.attention_bwd(q, k, v, zero, zero, zero, *args[6:])
    for g, wnt, gb in zip(got[:3], want[:3], got_b[:3]):
        _close_rel(g, wnt)
        assert not g[2].any()  # the fully masked row gets no gradient
        assert torch.equal(g, gb)
    if packed:
        out = torch.full((B, T, 3 * H * d), 7.0, dtype=torch.bfloat16, device=cuda)
        attention.attention_bwd(*args, out=out)
        assert torch.equal(out, torch.cat(got[:3], dim=-1))


def test_packed_attention_autograd_launches_its_kernels(cuda):
    """``short_t_attention_packed`` on the card: one forward and one backward
    launch without biases, the packed gradient as the plain Function's."""
    B, T, H, d = 3, 150, 2, 64
    q, k, v, _, mask = _attention_args(cuda, B, T, H, d)
    qkv = torch.cat([q, k, v], dim=-1)
    do = _on(cuda, _np(B, T, H * d, seed=7), torch.bfloat16)
    grads = []
    for plain in (False, True):
        leaf = qkv.clone().requires_grad_(True)
        _build.reset_launch_counts()
        o, _ = attention.short_t_attention_packed(leaf, mask, d, plain=plain)
        o.backward(do)
        assert _build.launch_counts == ({} if plain else {"attention_nb": 1,
                                                          "attention_nb_bwd": 1})
        grads.append(leaf.grad)
    _close_rel(*grads)


# The other routes of short_t_attention_flat, by the JAX keywords.
VARIANT_FLAGS = {"attention": dict(save_stats=False),
                 "ctx": dict(save_stats=False, o_residual=True),
                 "stats": dict(save_stats=True), "stats_v2": dict(save_stats="v2")}


@pytest.mark.parametrize("d", [64, 80, 120])
@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
@pytest.mark.parametrize("route", VARIANT_FLAGS)
def test_attention_variant_kernels_match_plain(cuda, route, d, packed):
    """Each route's forward and backward kernels (the backward's dq kernel
    sweeping twice) against the plain versions at each head dim, T = 150,
    padded keys and a fully padded row: the stats routes clamp its lse at
    -1e25 and give it no gradient; the routes without stats give it the
    uniform average's nonzero gradients, as the plain version; on packed q, k,
    v the backward writes one packed gradient."""
    B, T, H = 3, 150, 2
    q, k, v, _, mask = _attention_args(cuda, B, T, H, d, packed)
    fwd, bwd = attention._name("fwd", d, False, route), attention._name("bwd", d, False, route)
    _build.reset_launch_counts()
    o, lse = attention.short_t_attention_flat(q, k, v, mask, d, **VARIANT_FLAGS[route])
    assert _build.launch_counts == {fwd: 1}
    want_o, want_lse = attention.attention_plain(q, k, v, mask, d, route=route)
    _close(o, want_o, 8e-3)
    if route in attention.LSE_ROUTES:
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        assert (lse[2] == -1e25).all()
    else:
        assert lse is None and want_lse is None
    key_bias = attention._key_bias(mask)
    do = _on(cuda, _np(B, T, H * d, seed=7), torch.bfloat16)
    args = (q, k, v, None, None, None, key_bias, do, lse, o, d, d**-0.5)
    _build.reset_launch_counts()
    got = attention.attention_bwd(*args, route=route)
    assert _build.launch_counts == {bwd: 1} and got[3] is None
    want = attention.attention_bwd_plain(*args, route=route)
    for g, wnt in zip(got[:3], want[:3]):
        _close_rel(g, wnt)
        if route in attention.LSE_ROUTES:
            assert not g[2].any()
        else:
            assert g[2].float().abs().max() > 0.1 * wnt[2].float().abs().max() > 0
    if packed:
        out = torch.full((B, T, 3 * H * d), 7.0, dtype=torch.bfloat16, device=cuda)
        attention.attention_bwd(*args, out=out, route=route)
        assert torch.equal(out, torch.cat(got[:3], dim=-1))


@pytest.mark.parametrize("d", [64, 80, 120])
def test_forward_without_stats_is_the_v2_forward_bit_for_bit(cuda, d):
    """The stats-free forward (`_fwd_kernel` :48) is the v2 forward minus the
    lse store: o bit for bit ``attention_nb``'s."""
    q, k, v, _, mask = _attention_args(cuda, 3, 150, 2, d)
    key_bias = attention._key_bias(mask)
    o, lse = attention._fwd(q, k, v, None, None, None, key_bias, d, d**-0.5, "attention")
    o_nb, lse_nb = attention._fwd(q, k, v, None, None, None, key_bias, d, d**-0.5, "stats_v2")
    assert lse is None and lse_nb is not None
    assert torch.equal(o, o_nb)


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
@pytest.mark.parametrize("route", VARIANT_FLAGS)
def test_attention_variant_autograd_launches_its_kernels(cuda, route, packed):
    """Each route's autograd Function on the card: one forward and one
    backward launch, the gradients as the plain Function's."""
    B, T, H, d = 3, 150, 2, 64
    q, k, v, _, mask = _attention_args(cuda, B, T, H, d)
    do = _on(cuda, _np(B, T, H * d, seed=7), torch.bfloat16)
    grads = []
    for plain in (False, True):
        _build.reset_launch_counts()
        if packed:
            leaves = [torch.cat([q, k, v], dim=-1).requires_grad_(True)]
            o, _ = attention.short_t_attention_packed(*leaves, mask, d, plain=plain,
                                                      **VARIANT_FLAGS[route])
        else:
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o, _ = attention.short_t_attention_flat(*leaves, mask, d, plain=plain,
                                                    **VARIANT_FLAGS[route])
        o.backward(do)
        assert _build.launch_counts == ({} if plain else {
            attention._name(way, d, False, route): 1 for way in ("fwd", "bwd")})
        grads.append([leaf.grad for leaf in leaves])
    for g, wnt in zip(*grads):
        _close_rel(g, wnt)


@pytest.mark.parametrize("flags", [{"fused_qkv_ln": True}, {"attention_fused_qkv_bias": False}],
                         ids=["fused_qkv_ln", "qkv_bias_off"])
def test_qkv_routes_of_a_width_the_kernels_do_not_take_raise_on_the_card(cuda, flags):
    """The tiny config's 32-wide layer on the card: the bias-free attention's
    wrapper raises for head_dim 16; with ``fused_qkv_ln`` the projection takes
    the JAX package's XLA route at width 32 (no kernel in either package)
    before the attention raises. Nothing launches."""
    flags = {**SETUP_FLAGS, "attention_fused_qkv_bias": False, **flags}
    model = Wav2Vec2ForCTC(Wav2Vec2Config.tiny(dtype=torch.bfloat16, **flags)).to(cuda).eval()
    layer = model.wav2vec2.encoder.layers[0]
    x = torch.zeros(1, 4, 32, device=cuda, dtype=torch.bfloat16)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim"):
        layer.attention(x, torch.ones(1, 4, dtype=torch.bool, device=cuda),
                        ln=layer.layer_norm if flags.get("fused_qkv_ln") else None)
    assert not _build.launch_counts



# -- the forwards' Hopper mainloop: every instantiation at the tile edges -------------

MAINLOOP_T = [1, 127, 128, 129, 499, 1499, 1500]


def _mainloop_qkv(cuda, B, T, H, d, packed):
    """bf16 (B, T, H*d) q, k, v: separate, or the lane thirds of one packed
    projection (strided rows)."""
    q, k, v = (_np(B, T, H * d, seed=11 + i) for i in range(3))
    if packed:
        qkv = _on(cuda, np.concatenate([q, k, v], axis=-1), torch.bfloat16)
        return qkv.split(H * d, dim=-1)
    return tuple(_on(cuda, a, torch.bfloat16) for a in (q, k, v))


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
@pytest.mark.parametrize("T", MAINLOOP_T)
@pytest.mark.parametrize("d", [64, 80, 120])
def test_attention_forward_mainloop_matches_plain(cuda, d, T, packed):
    """The three K4 instantiations (with biases and lse, without biases, without
    stats) and v1's two sweeps at T around the 128-row and 128-key tiles, with
    a full row, a half-length row, a length-1 row and a fully padded row; o at
    8e-3, lse at 1e-4; the fully padded row's lse clamped."""
    H = 2
    q, k, v = _mainloop_qkv(cuda, 4, T, H, d, packed)
    bias = tuple(_on(cuda, _np(H * d, seed=20 + i, scale=0.5), torch.bfloat16) for i in range(3))
    lengths = torch.tensor([T, max(1, T // 2), 1, 0], device=cuda)
    mask = torch.arange(T, device=cuda)[None, :] < lengths[:, None]
    key_bias = attention._key_bias(mask)
    for biases, route in ((bias, "stats_v3"), ((None,) * 3, "stats_v2"), ((None,) * 3, "attention"),
                          ((None,) * 3, "stats")):
        o, lse = attention._fwd(q, k, v, *biases, key_bias, d, d**-0.5, route)
        want_o, want_lse = attention._fwd_plain(q, k, v, *biases, key_bias, d, d**-0.5, route)
        assert o.shape == (4, T, H * d) and o.is_contiguous()
        _close(o, want_o, 8e-3)
        if route == "attention":
            assert lse is None
        else:
            torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
            assert (lse[3] == -1e25).all()


@pytest.mark.parametrize("T", [1, 129, 1499])
@pytest.mark.parametrize("d", [64, 80, 120])
def test_v1_lse_is_the_v2_forwards_bit_for_bit(cuda, d, T):
    """v1's first sweep runs the bias-free forward's scores and softmax in the
    same order, so its lse is the ``"stats_v2"`` forward's bit for bit, the
    fully padded row's -1e25 included; its o is the plain v1's within 8e-3."""
    q, k, v = _mainloop_qkv(cuda, 4, T, 2, d, False)
    lengths = torch.tensor([T, max(1, T // 2), 1, 0], device=cuda)
    key_bias = attention._key_bias(torch.arange(T, device=cuda)[None, :] < lengths[:, None])
    o, lse = attention._fwd(q, k, v, None, None, None, key_bias, d, d**-0.5, "stats")
    _, lse_v2 = attention._fwd(q, k, v, None, None, None, key_bias, d, d**-0.5, "stats_v2")
    assert torch.equal(lse, lse_v2)
    assert (lse[3] == -1e25).all()
    want_o, _ = attention._fwd_plain(q, k, v, None, None, None, key_bias, d, d**-0.5, "stats")
    _close(o, want_o, 8e-3)


def _mainloop_segments(cuda, B, T):
    """Segment ids of the padded call (B, Tp) whose first key tile holds no
    key of some rows' segments: rows 0-2 from pad masks (a full, a 200-frame
    and a length-1 row: the padded queries of row 1 see only valid keys in
    keys 0..127 when T > 200), row 3 ids (t // 200) % 3 + 1, so its queries
    past 199 find no key of their segment among the first 128 keys."""
    lengths = torch.tensor([T, min(T, 200), 1], device=cuda)
    ids = flash_attention.segment_ids(torch.arange(T, device=cuda)[None, :] < lengths[:, None])
    Tp = ids.shape[1]
    custom = (torch.arange(Tp, device=cuda) // 200) % 3 + 1
    custom[T:] = 0
    return torch.cat([ids, custom[None].to(torch.int32)])[:B].contiguous()


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
@pytest.mark.parametrize("T", MAINLOOP_T)
@pytest.mark.parametrize("d", [64, 80, 120])
def test_flash_forward_mainloop_matches_plain(cuda, d, T, packed):
    """The four K7 instantiations (unmasked and with segment ids, each with
    and without m and l) at T around the tiles, against the plain versions
    of the padded call: o at 8e-3, m and l at rtol 1e-5; the serving o is the
    training o bit for bit."""
    B, H = 4, 2
    q, k, v = (t.view(B, T, H, d) for t in _mainloop_qkv(cuda, B, T, H, d, packed))
    for ids in (None, _mainloop_segments(cuda, B, T)):
        o_serve = flash_attention.flash_self_attention(q, k, v, segment_ids=ids)
        o, l, m = flash_attention.flash_attention_fwd(q, k, v, segment_ids=ids)
        want = flash_attention._padded_fwd_plain(q, k, v, ids)
        assert o.shape == (B, T, H, d) and o.is_contiguous()
        _close(o, want[0], 8e-3)
        assert torch.equal(o, o_serve)
        torch.testing.assert_close(l, want[1], rtol=1e-5, atol=0.0)
        torch.testing.assert_close(m, want[2], rtol=1e-5, atol=1e-6)


BWD_MAINLOOP_T = (1, 63, 64, 65, 127, 128, 129, 499, 1500)


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
@pytest.mark.parametrize("T", BWD_MAINLOOP_T)
@pytest.mark.parametrize("d", [64, 80, 120])
def test_flash_backward_mainloop_matches_plain(cuda, d, T, packed):
    """The backward mainloop's four instantiations at each head dim (dq and
    dkv, unmasked and with segment ids: a full, a 200-frame and a length-1
    row, and a row whose queries find no key of their segment in the first
    tiles) at T around its tiles (64 and 128 rows, 32 queries at d = 120),
    against the plain versions of the padded call: dq, dk and dv as the other
    gradients, di at 1e-5 of its max; two launches give the same bits. At T =
    1 every query sees one key, p = 1 and dp = di but for the fp32 rounding of
    two sums of the same products, so dq and dk are that rounding, on both
    sides: each is held under 2**-20 d**0.5 max|do| max|v| max|k| (max|q|),
    about 1e-3 of their size at any other T."""
    B, H = 4, 2
    q, k, v = (t.view(B, T, H, d) for t in _mainloop_qkv(cuda, B, T, H, d, packed))
    do = _on(cuda, _np(B, T, H, d, seed=7), torch.bfloat16)
    for ids in (None, _mainloop_segments(cuda, B, T)):
        o, l, m = flash_attention.flash_attention_fwd(q, k, v, segment_ids=ids)
        base = flash_attention._counter("flash_attention_bwd", ids, d)
        _build.reset_launch_counts()
        got = flash_attention.flash_attention_bwd(q, k, v, o, l, m, do, segment_ids=ids)
        assert _build.launch_counts == {base.replace("bwd", "bwd_dq"): 1,
                                        base.replace("bwd", "bwd_dkv"): 1}
        want = flash_attention._padded_bwd_plain(q, k, v, o, l, m, do, ids)
        for g, w, other in zip(got, want, (k, q, None)):
            assert g.shape == (B, T, H, d) and g.is_contiguous()
            if T == 1 and other is not None:
                cancelled = 2.0**-20 * d**0.5 * float(do.abs().max() * v.abs().max()
                                                       * other.abs().max())
                torch.cuda.synchronize()
                assert float(g.float().abs().max()) <= cancelled
                assert float(w.float().abs().max()) <= cancelled
            else:
                _close_rel(g, w)
        di = flash_attention.flash_attention_bwd_dq(q, k, v, o, l, m, do, ids)[1]
        _close_rel(di, flash_attention._padded_dq_plain(q, k, v, o, l, m, do, ids)[1], 1e-5)
        again = flash_attention.flash_attention_bwd(q, k, v, o, l, m, do, segment_ids=ids)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


# The short-T backwards on the backward mainloop: every route, by the policy
# of its pair (bwd::K4 with and without biases, Stats, Recompute, Ctx).
BWD_ROUTES = {"stats_v3_qb": ("stats_v3", True), "stats_v3": ("stats_v3", False),
              "stats_v2": ("stats_v2", False), "stats": ("stats", False), "ctx": ("ctx", False),
              "attention": ("attention", False)}


@pytest.mark.parametrize("packed", [False, True], ids=["separate", "packed_qkv"])
@pytest.mark.parametrize("T", BWD_MAINLOOP_T)
@pytest.mark.parametrize("d", [64, 80, 120])
@pytest.mark.parametrize("case", BWD_ROUTES)
def test_attention_backward_mainloop_matches_plain(cuda, case, d, T, packed):
    """Each short-T backward's pair (``attention_bwd_dq_kernel``, then
    ``attention_bwd_dkv_kernel``) at each head dim and T around its tiles (128
    rows a block, 128- or 64-key dq tiles, 64- or 32-query dkv tiles), with a
    full row, a half-length row, a length-1 row and a fully padded row, on
    separate q, k, v and on the lane thirds of one packed projection (with the
    biases too: the kernels take any row stride): dq, dk and dv against
    ``attention_bwd_plain`` as the other gradients, db at 1e-2 of its largest
    value. The fully padded row: no gradient where p comes from the lse (its
    -1e25 clamp), and on Recompute and Ctx p = 1/T, every key's dv the mean
    of do. Two launches give the same bits; the packed gradient is the
    separate one's bit for bit. At T = 1 dq and dk are fp32 rounding on both
    sides (p = 1, dp = delta but for the order of two sums of the same
    products), held under the flash test's bound."""
    route, bias = BWD_ROUTES[case]
    B, H = 4, 2
    q, k, v = _mainloop_qkv(cuda, B, T, H, d, packed)
    biases = (tuple(_on(cuda, _np(H * d, seed=20 + i, scale=0.5), torch.bfloat16)
                    for i in range(3)) if bias else (None,) * 3)
    lengths = torch.tensor([T, max(1, T // 2), 1, 0], device=cuda)
    key_bias = attention._key_bias(torch.arange(T, device=cuda)[None, :] < lengths[:, None])
    do = _on(cuda, _np(B, T, H * d, seed=7), torch.bfloat16)
    fwd_route = "stats_v2" if route == "stats" else route
    o, lse = attention._fwd(q, k, v, *biases, key_bias, d, d**-0.5, fwd_route)
    args = (q, k, v, *biases, key_bias, do, lse, o, d, d**-0.5)
    out = torch.empty(B, T, 3 * H * d, dtype=torch.bfloat16, device=cuda) if packed else None
    _build.reset_launch_counts()
    got = attention.attention_bwd(*args, out=out, route=route)
    assert _build.launch_counts == {attention._name("bwd", d, bias, route): 1}
    want = attention.attention_bwd_plain(*args, route=route)
    qb, kb, vb = (t if b is None else t + b for t, b in zip((q, k, v), biases))
    for g, w, other in zip(got[:3], want[:3], (kb, qb, None)):
        assert g.shape == (B, T, H * d)
        if T == 1 and other is not None:
            cancelled = 2.0**-20 * d**0.5 * float(do.abs().max() * vb.abs().max()
                                                   * other.abs().max())
            torch.cuda.synchronize()
            assert float(g.float().abs().max()) <= cancelled
            assert float(w.float().abs().max()) <= cancelled
        else:
            _close_rel(g, w)
    if bias:
        _close_rel(got[3], want[3], 1e-2)
    else:
        assert got[3] is None
    if route in attention.LSE_ROUTES:
        assert not any(g[3].any() for g in got[:3])
    else:
        mean = do[3].float().mean(dim=0)
        _close_rel(got[2][3], mean.expand(T, -1), 2e-2)
    again = attention.attention_bwd(*args, route=route)
    assert all(torch.equal(a, g) for a, g in zip(again[:3], got[:3]))
    if bias:
        assert torch.equal(again[3], got[3])
    if packed:
        apart = attention.attention_bwd(*(t.contiguous() for t in (q, k, v)), *args[3:],
                                        route=route)
        assert all(torch.equal(a, g) for a, g in zip(apart[:3], got[:3]))
        assert torch.equal(torch.cat(apart[:3], dim=-1), out)


# -- the decode wrappers' launch path ------------------------------------------------


def _decode_calls(cuda, K):
    """Both decode wrappers at Whisper large-v3's width (20 heads), as
    zero-argument calls: the self-attention over a 225-slot cache, the
    cross-attention over 1500 encoder rows, B = 2 items of K beams."""
    B, H = 2, 20
    q, ck, cv, onehot = _decode_self_inputs(cuda, B, K, 225, H, 150)
    k = _on(cuda, _np(2, B, 1500, H * 64, seed=4), torch.bfloat16)
    v = _on(cuda, _np(2, B, 1500, H * 64, seed=5), torch.bfloat16)
    return q, {"self": lambda: decode_attention.decode_self_attention(q, ck, cv, onehot, H, 1),
               "cross": lambda: decode_attention.decode_cross_attention(q, k, v, H, 1)}


@pytest.mark.parametrize("K", [1, 5])
def test_decode_kernels_give_the_same_bits_twice(cuda, K):
    """The cluster combines its blocks in rank order: no atomics, no order
    that changes between calls."""
    _, calls = _decode_calls(cuda, K)
    for fn in calls.values():
        assert torch.equal(fn(), fn())


def _decode_kernels_a_call(K):
    """The profiler's device kernels of one call of each decode wrapper."""
    _, calls = _decode_calls(torch.device("cuda"), K)
    counts = {}
    for name, fn in calls.items():
        fn()  # the library is built and the tensor maps encoded
        counts[name] = len(_device_kernels(fn))
    return counts


@pytest.mark.parametrize("K", [1, 5, 64])
def test_decode_kernels_launch_one_device_kernel_a_call(cuda, K):
    """One device kernel a call by the profiler, as ``chip_smoke.py`` counts
    them: the key split is combined inside the cluster, with no second
    kernel and no scratch to clear. Counted in a process of its own: in this
    one the profiler recorded no kernel at all once another test here had
    profiled (the LayerNorm test below, or this one for that test)."""
    tests = Path(__file__).resolve().parent
    script = (f"import sys; sys.path[:0] = [{str(tests.parent)!r}, {str(tests)!r}]; "
              f"import test_torch_kernels as t; print(t._decode_kernels_a_call({K}))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    counts = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert counts == {"self": 1, "cross": 1}, counts


@pytest.mark.parametrize("K", [1, 5])
def test_decode_kernels_replay_in_a_cuda_graph(cuda, K):
    """Both decode wrappers captured in one ``torch.cuda.CUDAGraph``: a replay
    gives the eager calls' bits, and again after q is overwritten in place
    (the graph reads the buffers, nothing of the call is baked in)."""
    q, calls = _decode_calls(cuda, K)
    eager = {name: fn() for name, fn in calls.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls.values():
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = {name: fn() for name, fn in calls.items()}
    graph.replay()
    torch.cuda.synchronize()
    for name in calls:
        assert torch.equal(captured[name], eager[name]), name
    q.copy_(torch.flip(q, dims=[0]))
    eager = {name: fn() for name, fn in calls.items()}
    graph.replay()
    torch.cuda.synchronize()
    for name in calls:
        assert torch.equal(captured[name], eager[name]), name
