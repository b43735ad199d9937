"""coral_tpu_torch's unfused kernel routes against coral_tpu's, on the CPU.

The routes behind ``attention_impl: flash | xla`` and ``fused_ffn: false``:
the flash attention with segment ids (K7 with a (B, Tp) segment vector), the
GELU+dropout kernel (K10), the wav2vec2 model on those routes, and the
setups' flag resolution. The JAX side runs as its own tests run it on the
CPU. JAX's wav2vec2 flash route lowers only on a TPU, so the port's plain
K7-seg is held against the installed JAX's stock reference
(``mha_reference_no_custom_vjp`` with ``SegmentIds``) on the padded tensors,
every row, and the port's flash model against JAX's ``xla`` route on the
valid frames, where the two routes agree. K10's plain version is held against
JAX ``gelu_dropout`` at rate 0 (its off-TPU path, the same polynomial GELU);
at rate 0.1 the two draw from other generators, so its laws are checked.

Tolerances, fp32 on both sides with sums in another order: K7-seg's o, l, m
and gradients within 1e-5 of max |JAX| (softmax sums over up to 256 keys, as
tests/test_torch_whisper_train.py holds the unmasked kernel); K10 within
1e-5; the model's logits within 1e-4 of max |JAX| (tests/test_torch_wav2vec2.py);
the train step as tests/test_torch_train.py holds it.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (SegmentIds,
                                                             mha_reference_no_custom_vjp)

import coral_tpu.ops.gelu_dropout_pallas as jgd
from coral_tpu.config import DictConfig
from coral_tpu.models import whisper as JW
from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
from coral_tpu_torch.models import whisper as PW
from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax, whisper_state_dict_from_jax
from coral_tpu_torch.models.wav2vec2 import REMAT_POLICIES, Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import flash_attention, gelu_dropout, gelu_poly, ln_gelu, philox
from coral_tpu_torch.training.model_setup import load_model_setup
from coral_tpu_torch.training.train_state import ctc_loss_and_grads
from test_torch_train import BLANK, CHARS, FE_ARCH, QUIET, VOCAB, _batch, _steps_match_jax
from test_torch_wav2vec2 import (ARCHS, LENGTHS, N_SAMPLES, PORT_FLAGS, PRODUCTION_FLAGS,
                                 _seeded_params)
from test_torch_whisper import NARROW, UNFUSED_FLAGS as WHISPER_UNFUSED
from test_torch_whisper import _seeded_params as whisper_params
from test_torch_whisper_train import FLASH_FORWARDS

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


# -- K7 with segment ids ---------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 80, 120])
def test_segment_flash_plain_matches_the_stock_reference(d):
    """The plain forward (o, l, m) and backward on the padded call, T = 200 (not
    a multiple of 128) padded to 256, a full row, a padded row and a length-1
    filler row, every row compared; then the wrappers at T rows against it. At
    each head dim the kernels are built for: XLS-R-300M's 64, -1B's 80 and
    -2B's 120 (scale d**-0.5)."""
    B, T, H = 3, 200, 2
    pad_mask = torch.arange(T)[None, :] < torch.tensor([200, 130, 1])[:, None]
    ids = flash_attention.segment_ids(pad_mask)
    Tp = ids.shape[1]
    assert Tp == 256 and ids.dtype == torch.int32
    assert (ids[:, :T] == pad_mask).all() and not ids[:, T:].any()
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(3))
    qp, kp, vp = (np.pad(a, ((0, 0), (0, Tp - T), (0, 0), (0, 0))) for a in (q, k, v))
    do = rng.standard_normal((B, Tp, H, d)).astype(np.float32)
    scale = d**-0.5
    seg = SegmentIds(q=jnp.asarray(ids.numpy()), kv=jnp.asarray(ids.numpy()))
    bht = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    o_j, l_j, m_j = mha_reference_no_custom_vjp(bht(qp), bht(kp), bht(vp), segment_ids=seg,
                                                sm_scale=scale, save_residuals=True)
    _, vjp = jax.vjp(lambda *a: mha_reference_no_custom_vjp(*a, segment_ids=seg,
                                                            sm_scale=scale),
                     bht(qp), bht(kp), bht(vp))
    grads_j = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(bht(do))]

    tq, tk, tv = (torch.from_numpy(a) for a in (qp, kp, vp))
    o, l, m = flash_attention.flash_attention_fwd_plain(tq, tk, tv, ids)
    assert o.shape == (B, Tp, H, d) and l.shape == m.shape == (B, H, Tp)
    assert _rel(o.numpy(), np.asarray(o_j).transpose(0, 2, 1, 3)) <= 1e-5
    assert _rel(l.numpy(), l_j) <= 1e-5 and _rel(m.numpy(), m_j) <= 1e-5
    got = flash_attention.flash_attention_bwd_plain(tq, tk, tv, o, l, m, torch.from_numpy(do),
                                                    ids)
    for g, w in zip(got, grads_j):
        assert _rel(g.numpy(), w) <= 1e-5
    # The filler row's queries average its keys (the grid's zero rows too):
    # not a key mask's uniform average over the T keys alone.
    assert not torch.allclose(o[2, 0], tv[2, :T].mean(0))

    # The wrappers take T rows and give T rows: the padded call's, and the
    # gradient of the sliced output (do = 0 on the grid's rows).
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o2, l2, m2 = flash_attention.flash_attention(*leaves, segment_ids=ids)
    assert torch.equal(o2.detach(), o[:, :T]) and torch.equal(l2, l[..., :T])
    assert torch.equal(m2, m[..., :T])
    assert torch.equal(flash_attention.flash_self_attention(*(t.detach() for t in leaves),
                                                            segment_ids=ids), o[:, :T])
    do_t = torch.from_numpy(do[:, :T].copy())
    o2.backward(do_t)
    want = flash_attention.flash_attention_bwd_plain(
        tq, tk, tv, o, l, m, torch.nn.functional.pad(do_t, (0, 0, 0, 0, 0, Tp - T)), ids)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w[:, :T], rtol=1e-6, atol=1e-6)


# -- K10: GELU + dropout ---------------------------------------------------------------


def test_gelu_dropout_plain_matches_jax_at_rate_0():
    """Forward and gradient against JAX ``gelu_dropout(x, 0.0, key)``: the
    polynomial GELU and its own derivative fit, fp32."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 37, 64)) * 3).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jgd.gelu_dropout(a, 0.0, jax.random.PRNGKey(0)),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = gelu_dropout.gelu_dropout(tx, 0.0)
    out.backward(torch.from_numpy(dy))
    assert _rel(out.detach().numpy(), want) <= 1e-5
    assert _rel(tx.grad.numpy(), want_dx) <= 1e-5


def test_gelu_dropout_laws_at_rate_0_1():
    """Keep fraction 0.9, kept values scaled by 1/0.9 and rounded once, the
    backward on the forward's mask (regenerated from the seeds), the mask
    philox's bits per (seed[b], row, column), other seeds other masks."""
    rate, scale = 0.1, 1.0 / 0.9
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 300, 512)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    seeds = torch.tensor([3, -7, 11, 2**30], dtype=torch.int32)
    leaf = x.clone().requires_grad_(True)
    out = gelu_dropout.gelu_dropout(leaf, rate, seeds)
    out.backward(dy)
    keep = philox.keep_mask(seeds, 300, 512, rate)
    assert abs(keep.float().mean().item() - 0.9) < 0.003
    g = gelu_poly.gelu_poly(x)
    assert torch.equal(out.detach(), torch.where(keep, g * scale, 0.0))
    assert torch.equal(leaf.grad, torch.where(keep, dy * scale * gelu_poly._dgelu(x), 0.0))
    assert torch.equal(leaf.grad, gelu_dropout.gelu_dropout_bwd_plain(x, dy, rate, seeds))
    # bf16: one rounding of the fp32 result.
    xb = x.to(torch.bfloat16)
    assert torch.equal(gelu_dropout.gelu_dropout_plain(xb, rate, seeds),
                       torch.where(keep, gelu_poly.gelu_poly(xb.float()) * scale,
                                   0.0).to(torch.bfloat16))
    other = gelu_dropout.gelu_dropout_plain(x, rate, seeds + 1)
    assert not torch.equal(other != 0, out.detach() != 0)
    with pytest.raises(ValueError, match="seeds"):
        gelu_dropout.gelu_dropout(x, rate)


# -- wav2vec2 on the flash, xla and unfused routes -------------------------------------

# coral_tpu/training/model_setup.py's resolution of `attention_impl: xla` and
# `fused_ffn: false` (the q/k/v biases in the projections, the FFN unfused).
UNFUSED_FLAGS = {**PRODUCTION_FLAGS, "attention_impl": "xla", "attention_fused_qkv_bias": False,
                 "fused_ffn": False, "fused_ffn_ln": False}
# The same flags on the port's config (attention_impl given apart).
PORT_UNFUSED = {k: v for k, v in UNFUSED_FLAGS.items() if k in PORT_FLAGS and k != "attention_impl"}


@pytest.fixture(scope="module")
def unfused_case():
    """The JAX model on the xla route with the unfused FFN at the narrow
    config (2 heads of 64, FFN 256), its logits on a full, a padded and a
    filler row."""
    jax_model = JaxModel(JaxConfig(**ARCHS["narrow"], **UNFUSED_FLAGS))
    params = _seeded_params(jax_model, seed=0)
    audio = np.random.default_rng(1).standard_normal((3, N_SAMPLES)).astype(np.float32)
    logits, frames = jax_model.apply({"params": params}, jnp.asarray(audio),
                                     jnp.asarray(LENGTHS), deterministic=True)
    return params, audio, np.asarray(logits), np.asarray(frames)


def _port(params, impl, **kw):
    model = Wav2Vec2ForCTC(Wav2Vec2Config(**ARCHS["narrow"], attention_impl=impl,
                                          **PORT_UNFUSED, **kw)).eval()
    sd = wav2vec2_state_dict_from_jax(params, model.config)
    assert sd.keys() == model.state_dict().keys()  # the fused routes' tree
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_unfused_model_matches_jax(unfused_case, impl):
    """``attention_impl="xla"`` on every frame; ``"flash"`` (segment ids)
    against JAX's xla route on the valid frames, where the two agree (padded
    frames attend to padded keys on the flash route, to valid keys on xla).
    Both with ``fused_ffn=False`` and its exact erf GELU."""
    params, audio, want, want_frames = unfused_case
    model = _port(params, impl)
    args = torch.from_numpy(audio), torch.from_numpy(LENGTHS).long()
    with torch.inference_mode():
        logits, frames = model(*args)
    np.testing.assert_array_equal(frames.numpy(), want_frames)
    got, scale = logits.numpy(), np.abs(want).max()
    if impl == "flash":
        valid = np.arange(got.shape[1])[None, :] < want_frames[:, None]
        assert valid.sum() < valid.size and want_frames[-1] <= 0
        got, want = got[valid], want[valid]
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_unfused_plain_model_is_the_same_function(unfused_case, impl):
    params, audio, *_ = unfused_case
    model = _port(params, impl)
    plain = Wav2Vec2ForCTC(model.config, plain=True).eval()
    plain.load_state_dict(model.state_dict())
    args = torch.from_numpy(audio), torch.from_numpy(LENGTHS).long()
    with torch.inference_mode():
        torch.testing.assert_close(plain(*args), model(*args), rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_unfused_train_step_matches_jax(impl):
    """Three steps of both packages' CTC train step (the tiny config, fp32,
    activation dropout 0, SpecAugment off, checkpointing under
    nothing_saveable): the JAX step on its xla route with the unfused FFN, the
    port's on the xla and the flash route (the same valid frames, and padded
    frames have no gradient under the CTC loss)."""
    jax_model = JaxModel(JaxConfig.tiny(vocab_size=VOCAB, **UNFUSED_FLAGS, **QUIET),
                         gradient_checkpointing=True, remat_policy="nothing_saveable")
    params = _seeded_params(jax_model, seed=0)
    model = Wav2Vec2ForCTC(Wav2Vec2Config.tiny(vocab_size=VOCAB, attention_impl=impl,
                                               **PORT_UNFUSED, **QUIET))
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    model.wav2vec2.encoder.gradient_checkpointing = True
    _steps_match_jax(jax_model, params, model, True)


# Forward runs per layer and microbatch on the flash route with the unfused FFN:
# the flash forward (with its stats) and the GELU+dropout forward run again in
# every replay (their outputs and residuals have no kept name, and fc2's
# weight gradient reads the activation), LN1 unless "attn_in" is kept, LN2
# unless "ffn_in" (its output) is kept; no checkpointing runs each once.
UNFUSED_FORWARDS = {policy: (2, 2, 2, 2) for policy in REMAT_POLICIES}
UNFUSED_FORWARDS.update({"save_matmul_inputs": (2, 1, 1, 2),
                         "save_matmul_inputs_ffn": (2, 1, 1, 2), None: (1, 1, 1, 1)})


@pytest.mark.parametrize("policy", sorted(REMAT_POLICIES) + [None])
def test_unfused_policies_replay_what_they_do_not_keep(policy, monkeypatch):
    """Dropout 0.1, SpecAugment on and the feature encoder training on the
    flash route with the unfused FFN: the gradients with checkpointing under
    each named policy are the bits of those without, and spies on the plain
    forwards (the kernels' stand-ins on the CPU) count what each replays."""
    calls = collections.Counter()

    def spy(module, name, key):
        fn = getattr(module, name)

        def counted(*args, **kw):
            calls[key(*args)] += 1
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, counted)

    spy(flash_attention, "_padded_fwd_plain", lambda *a: "flash")
    spy(gelu_dropout, "gelu_dropout_plain", lambda *a: "gelu_dropout")
    spy(ln_gelu, "ln_gelu_plain", lambda *a: "ln_gelu" if a[4] else "ln_fused")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads, counts = [], []
    for remat in (policy is not None, False):
        torch.manual_seed(0)  # the same initial weights each time
        model = Wav2Vec2ForCTC(Wav2Vec2Config(
            vocab_size=VOCAB, **FE_ARCH, attention_impl="flash", **PORT_UNFUSED,
            activation_dropout=0.1, hidden_dropout=0.1, mask_feature_length=8))
        torch.nn.init.uniform_(model.wav2vec2.masked_spec_embed)
        model.wav2vec2.encoder.gradient_checkpointing = remat
        model.wav2vec2.encoder.remat_policy = policy or "nothing_saveable"
        calls.clear()
        grads.append(ctc_loss_and_grads(model, batch, torch.Generator().manual_seed(5), BLANK,
                                        "sum", False))
        counts.append(dict(calls))
    A, L = 2, FE_ARCH["num_hidden_layers"]
    flash, ln1, ln2, gelu = UNFUSED_FORWARDS[policy]
    assert counts[0] == {"flash": flash * L * A, "ln_fused": (ln1 + ln2) * L * A,
                         "gelu_dropout": gelu * L * A, "ln_gelu": A}, counts[0]
    assert torch.equal(grads[0][0], grads[1][0])
    for k in grads[0][1]:
        assert torch.equal(grads[0][1][k], grads[1][1][k]), k
    assert grads[0][1]["wav2vec2.encoder.layers.0.feed_forward.intermediate_dense.weight"].any()


# -- the setups' flag resolution -------------------------------------------------------

W2V2_RESOLVED = ("attention_impl", "fused_ffn", "fused_ffn_ln", "fused_ffn_block",
                 "fused_ffn_block_dw", "fused_ffn_block_fc2", "fused_ffn_block_dg",
                 "fused_fe_conv", "encoder_ln_impl", "do_stable_layer_norm")


@pytest.mark.parametrize("flags", [
    {}, {"attention_impl": "flash"}, {"attention_impl": "xla"}, {"fused_ffn": False},
    {"fused_ffn": False, "fused_ffn_ln": True}, {"fused_ffn_ln": True},
    {"attention_impl": "flash", "fused_ffn": False},
    {"attention_impl": "xla", "fused_ffn": False, "fused_ffn_block": False},
    {"attention_impl": "flash", "attention_fused_qkv_bias": False},
    {"fused_ffn_block_dw": True}, {"fused_ffn_block_fc2": True}, {"fused_ffn_block_dg": False},
    {"fused_ffn_block_dw": True, "fused_ffn_block_fc2": True, "fused_ffn_block_dg": False},
    {"fused_ffn": False, "fused_ffn_block_dw": True},
    {"fused_fe_conv": False}, {"encoder_ln_impl": "xla"},
    {"do_stable_layer_norm": False, "fused_ffn_ln": False},
], ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()) or "defaults")
def test_wav2vec2_flags_resolve_as_the_jax_setup(flags, tmp_path):
    config = {"model": {"type": "wav2vec2", "architecture": "tiny", "characters_to_keep": CHARS,
                        **flags},
              "max_seconds_per_example": 1.0, "model_dir": str(tmp_path)}
    want = jax_load_model_setup(DictConfig(config)).model_config
    got = load_model_setup(config, device="cpu").model_config
    assert {k: getattr(got, k) for k in W2V2_RESOLVED} == {
        k: getattr(want, k) for k in W2V2_RESOLVED}


@pytest.mark.parametrize("flags,error,match", [
    ({"attention_impl": "flash", "attention_fused_qkv_bias": True}, ValueError, "requires"),
    ({"attention_impl": "xla", "attention_fused_qkv_bias": True}, ValueError, "requires"),
    ({"do_stable_layer_norm": False}, ValueError, "do_stable_layer_norm"),
    ({"attention_impl": "softmax"}, ValueError, "attention_impl"),
    ({"encoder_ln_impl": "rms"}, ValueError, "encoder_ln_impl"),
])
def test_wav2vec2_flags_without_a_route_raise(flags, error, match):
    """The explicit in-kernel biases off the pallas route raise as the JAX
    model does; the post-LN encoder with the LayerNorm folded into the FFN
    (fused_ffn_ln defaults to fused_ffn) raises as the JAX setup does; an
    attention or encoder LayerNorm the package has no route for raises. The
    attention variants resolve as the JAX setup's
    (tests/test_torch_attention_variants.py)."""
    config = {"model": {"architecture": "tiny", "characters_to_keep": CHARS, **flags},
              "max_seconds_per_example": 1.0}
    with pytest.raises(error, match=match):
        load_model_setup({**config, "model": {**config["model"], "type": "wav2vec2"}},
                         device="cpu")


@pytest.mark.parametrize("flags,fused", [
    ({}, True), ({"fused_ffn": False}, False), ({"fused_ffn": False, "fused_ffn_ln": True}, True),
    ({"fused_ffn": False, "fused_ffn_block": False}, False),
])
def test_whisper_flags_resolve_as_the_jax_setup(flags, fused, tmp_path):
    config = {"model": {"type": "whisper", "architecture": "tiny_test", "sampling_rate": 16_000,
                        **flags},
              "max_seconds_per_example": 2, "model_dir": str(tmp_path)}
    want = jax_load_model_setup(DictConfig(config)).model_config
    got = load_model_setup(config, device="cpu").model_config
    assert got.fused_ffn == want.fused_ffn == fused


def test_kernel_widths_follow_the_routes():
    """The flash route's kernels take head_dim 64, 80 and 120: XLS-R-300M,
    -1B and -2B pass with ``attention_impl: flash`` (and xla); a head_dim no
    config uses (96: 20 heads of 1920) is refused on the card before anything
    is built, naming Queue 2 item 3; the unfused FFN needs only F % 8 == 0."""
    from coral_tpu_torch.models import wav2vec2
    from coral_tpu_torch.training.model_setup import check_kernel_widths

    for arch in (Wav2Vec2Config.xls_r_300m, Wav2Vec2Config.xls_r_1b, Wav2Vec2Config.xls_r_2b):
        check_kernel_widths(arch(attention_impl="flash", **PORT_UNFUSED))
        check_kernel_widths(arch(attention_impl="xla", **PORT_UNFUSED))
    with pytest.raises(NotImplementedError,
                       match=r"head_dim \(the flash attention\) = 96.*Queue 2 item 3"):
        check_kernel_widths(dataclasses.replace(
            Wav2Vec2Config.xls_r_2b(attention_impl="flash", **PORT_UNFUSED), num_attention_heads=20))
    names = [w[0] for w in wav2vec2.kernel_widths(Wav2Vec2Config(**PORT_UNFUSED,
                                                                 attention_impl="flash"))]
    assert any("flash" in n for n in names) and not any("FFN block" in n for n in names)


# -- Whisper's unfused FFN under its remat policies ------------------------------------


@pytest.mark.parametrize("policy", ["save_matmul_inputs"])
def test_whisper_unfused_policies_keep_what_they_kept(policy, monkeypatch):
    """``fused_ffn=False`` at the narrow config, T_mel 2048 (the flash route),
    activation and embedding dropout 0.1, SpecAugment on: the gradients with
    checkpointing are the bits of those without; the flash forward replays as
    on the block's route (o, l, m kept by save_matmul_inputs and
    save_flash_ctx), the GELU+dropout forward in every replay ("ffn_in", now
    the LayerNorm's output, keeps nothing apart), in both stacks."""
    calls = collections.Counter()
    for module, name, key in ((flash_attention, "flash_attention_fwd_plain", "flash"),
                              (gelu_dropout, "gelu_dropout_plain", "gelu_dropout")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _key=key, **kw: (
            calls.update([_key]), _fn(*a, **kw))[1])
    params = whisper_params(JW.WhisperConfig(**NARROW, **WHISPER_UNFUSED), seed=0)
    pc = PW.WhisperConfig(**NARROW, **WHISPER_UNFUSED, dropout=0.1, mask_feature_length=8,
                          remat_policy=policy)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((1, 2048, 80)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 300, size=(1, 12)))
    grads, counts = [], []
    for remat in (True, False):
        model = PW.WhisperForConditionalGeneration(pc)
        model.load_state_dict(whisper_state_dict_from_jax(params, pc))
        calls.clear()
        logits = PW.forward(model, feats, ids, deterministic=False,
                            generator=torch.Generator().manual_seed(5),
                            gradient_checkpointing=remat)
        torch.log_softmax(logits, -1)[..., 7].sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        counts.append(dict(calls))
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
    L = NARROW["encoder_layers"] + NARROW["decoder_layers"]
    assert counts[0] == {"flash": FLASH_FORWARDS[policy] * NARROW["encoder_layers"],
                         "gelu_dropout": 2 * L}, counts[0]
    assert counts[1] == {"flash": NARROW["encoder_layers"], "gelu_dropout": L}
    assert grads[0]["model.decoder.layers.0.fc1.weight"].any()
