"""coral_tpu_torch's Whisper training slice against coral_tpu's, on the CPU.

The JAX side runs as on the CPU, with the JAX Whisper setup's FFN flags (the
FFN as ``ffn_ln_block``): at the JAX ``tiny_test`` config (d 32) its FFN
block takes its XLA reference, at the narrow config of
tests/test_torch_whisper.py (d 128, 2 x 64 heads, FFN 256) the block in
interpret mode. The JAX model reaches its flash kernel only on a TPU
(``coral_tpu/models/whisper.py:434-437``), so the port's flash forward with
row stats and its backward are held against the installed JAX's stock
reference (``mha_reference_no_custom_vjp(..., save_residuals=True)`` and its
``jax.vjp``). Weights are drawn by numpy from a seed into the tree of
``init_whisper_params`` and bridged by ``whisper_state_dict_from_jax``.

Tolerances, fp32 on both sides with reductions in another order: the training
forward's logits within 1e-4 of max |JAX| (the encoder and decode-step bound
of tests/test_torch_whisper.py); the flash forward's o, l and m and its
gradients within 1e-5 of max |JAX| (softmax sums over up to 200 keys); the
FFN block at D = 1280 within 2e-5 absolute for the output and dx, 1e-4 for
the gradients that sum over rows (tests/test_torch_ops.py's bounds). The
whole step over 3 steps as tests/test_torch_train.py holds the CTC step: the
loss 1e-4 and the gradient norm 5e-4 relative, the learning rate 1e-6, and
the parameters' |port - JAX| median <= 1e-5, 99th percentile <= 5e-5 and max
<= 3e-3 (Adam turns fp32 noise in a near-zero gradient into an update of up to
the learning rate). SpecAugment's masks and the gradients with and without
checkpointing are compared exactly.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coral_tpu.ops.ffn_pallas as jffn
from coral_tpu.models import whisper as JW
from coral_tpu.training import TrainState as JaxTrainState
from coral_tpu.training import create_optimizer as jax_create_optimizer
from coral_tpu.training.train_state import make_seq2seq_train_step as jax_make_seq2seq_train_step
from coral_tpu_torch.models import whisper as PW
from coral_tpu_torch.models.convert import whisper_state_dict_from_jax
from coral_tpu_torch.ops import ffn, flash_attention
from coral_tpu_torch.training import TrainState, create_optimizer, make_seq2seq_train_step
from coral_tpu_torch.training.model_setup import load_model_setup
from test_torch_whisper import NARROW, SETUP_FLAGS, UNFUSED_FLAGS, _seeded_params

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

REL_TOL = 1e-4
QUIET = dict(activation_dropout=0.0, mask_time_prob=0.0, mask_feature_prob=0.0)
SOT, PAD = 290, 299


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def _configs(name, **over):
    if name == "tiny_test_unfused":
        return (JW.WhisperConfig.tiny_test(vocab_size=300, **UNFUSED_FLAGS, **over),
                PW.WhisperConfig.tiny_test(vocab_size=300, **UNFUSED_FLAGS, **over))
    if name == "tiny_test":
        return (JW.WhisperConfig.tiny_test(vocab_size=300, **SETUP_FLAGS, **over),
                PW.WhisperConfig.tiny_test(vocab_size=300, **SETUP_FLAGS, **over))
    return (JW.WhisperConfig(**NARROW, **SETUP_FLAGS, **over),
            PW.WhisperConfig(**NARROW, **SETUP_FLAGS, **over))


def _port_model(params, config):
    model = PW.WhisperForConditionalGeneration(config)
    model.load_state_dict(whisper_state_dict_from_jax(params, config))
    return model


@pytest.mark.parametrize("arch", ["tiny_test", "narrow"])
def test_training_forward_matches_jax(arch):
    """``forward`` with gradients on (the differentiable ops) and
    checkpointing, against JAX ``W.forward`` with ``deterministic=True``."""
    jc, pc = _configs(arch)
    params = _seeded_params(jc, seed=1)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 200, 80)).astype(np.float32)
    ids = rng.integers(0, 300, size=(2, 12))
    want = np.asarray(JW.forward(params, jc, jnp.asarray(feats), jnp.asarray(ids)))
    logits = PW.forward(_port_model(params, pc), torch.from_numpy(feats), torch.from_numpy(ids),
                        gradient_checkpointing=True)
    assert logits.requires_grad and logits.dtype == torch.float32
    assert logits.shape == want.shape == (2, 12, 300)
    assert _rel(logits.detach().numpy(), want) <= REL_TOL


def _batch(seed=3, A=2, B=3, T=16_000, L=10):
    rng = np.random.default_rng(seed)
    batch = {
        "input_values": (rng.standard_normal((A, B, T)) * 0.1).astype(np.float32),
        "input_lengths": np.full((A, B), T, np.int32),
        "labels": rng.integers(0, 256, size=(A, B, L)).astype(np.int32),
    }
    batch["input_values"][1, 2, T // 2:] = 0.0
    batch["labels"][0, 1, 6:] = -100
    return batch


def _steps_match_jax(jc, pc, grad_dtype=None):
    """Three steps of both packages' ``make_seq2seq_train_step`` (A = 2,
    checkpointing under the configs' policy) from the same weights and
    batch; returns (the port's state, the initial weights, the JAX weights
    after the steps) as state dicts."""
    params = _seeded_params(jc, seed=0)
    batch = _batch()
    tx, schedule = jax_create_optimizer(1e-3, warmup_steps=2, max_steps=20,
                                        mu_dtype="bfloat16")
    state = JaxTrainState.create(params, tx)
    step = jax.jit(jax_make_seq2seq_train_step(jc, tx, schedule, SOT, PAD, 16_000,
                                               gradient_checkpointing=True,
                                               grad_dtype=grad_dtype))
    want = []
    for i in range(3):
        state, m = step(state, batch, jax.random.PRNGKey(i))
        want.append({k: float(v) for k, v in m.items()})

    model = _port_model(params, pc)
    ptx, pschedule = create_optimizer(1e-3, warmup_steps=2, max_steps=20, mu_dtype="bfloat16")
    pstate = TrainState.create(model, ptx)
    pstep = make_seq2seq_train_step(ptx, pschedule, SOT, PAD, gradient_checkpointing=True,
                                    grad_dtype=grad_dtype)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        pstate, m = pstep(pstate, batch, gen)
        got = {k: float(v) for k, v in m.items()}
        np.testing.assert_allclose(got["loss"], want[i]["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want[i]["grad_norm"], rtol=5e-4)
        np.testing.assert_allclose(got["learning_rate"], want[i]["learning_rate"], rtol=1e-6)
    assert pstate.step == 3
    initial = whisper_state_dict_from_jax(params, pc)
    final = whisper_state_dict_from_jax(jax.device_get(state.params), pc)
    assert all(pstate.params[k].dtype == torch.float32 for k in final)
    diff = torch.cat([(pstate.params[k] - final[k]).abs().flatten() for k in final])
    assert diff.median() <= 1e-5
    assert torch.quantile(diff, 0.99) <= 5e-5
    assert diff.max() <= 3e-3
    return pstate, initial, final


@pytest.mark.parametrize("arch,grad_dtype", [("tiny_test", None), ("tiny_test", "bfloat16"),
                                             ("narrow", None), ("tiny_test_unfused", None)],
                         ids=["fp32_grads", "bf16_grads", "narrow_fp32_grads",
                              "unfused_fp32_grads"])
def test_train_step_matches_jax(arch, grad_dtype):
    """Three steps of both packages' ``make_seq2seq_train_step`` (A = 2, fp32,
    checkpointing under save_matmul_inputs, SpecAugment and dropout off) from
    the same weights and batch; at the narrow config the JAX FFN block runs
    forward and backward in interpret mode."""
    jc, pc = _configs(arch, **QUIET)
    pstate, initial, _ = _steps_match_jax(jc, pc, grad_dtype)
    assert not torch.equal(pstate.params["model.decoder.layers.1.fc2.weight"],
                           initial["model.decoder.layers.1.fc2.weight"])


def test_spec_augment_matches_jax_given_its_span_starts(monkeypatch):
    """The time mask over all mel frames and the feature mask over the mel
    bins, from JAX's own Bernoulli starts: the same masked features."""
    jc, pc = _configs("tiny_test", mask_feature_length=8)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 200, 80)).astype(np.float32)
    starts = {(3, 200): rng.random((3, 200)) < 0.05, (3, 80): rng.random((3, 80)) < 0.06}
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(starts[tuple(shape)]))
    want = np.asarray(JW._spec_augment(jax.random.PRNGKey(0), jnp.asarray(feats), jc))
    rnd = PW.Randomness(torch.from_numpy(starts[(3, 200)]), torch.from_numpy(starts[(3, 80)]),
                        None, None, None)
    got = PW._spec_augment(torch.from_numpy(feats), rnd, pc).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(got, want)
    assert 0.2 < (got == 0).mean() < 0.9


def test_flash_forward_with_stats_and_backward_match_the_stock_reference():
    """The plain forward (o, l, m) and backward (dq, dk, dv) at a ragged T =
    200, against ``mha_reference_no_custom_vjp(..., save_residuals=True)`` and
    ``jax.vjp`` of it; and the autograd Function on the CPU."""
    from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

    B, T, H, d = 2, 200, 3, 64
    q, k, v, do = (np.random.default_rng(i).standard_normal((B, T, H, d)).astype(np.float32)
                   for i in range(4))
    scale = d**-0.5
    bht = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    o_j, l_j, m_j = mha_reference_no_custom_vjp(bht(q), bht(k), bht(v), sm_scale=scale,
                                                save_residuals=True)
    _, vjp = jax.vjp(lambda *a: mha_reference_no_custom_vjp(*a, sm_scale=scale),
                     bht(q), bht(k), bht(v))
    grads_j = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(bht(do))]

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, l, m = flash_attention.flash_attention_fwd_plain(tq, tk, tv)
    assert o.shape == (B, T, H, d) and l.shape == m.shape == (B, H, T)
    assert _rel(o.numpy(), np.asarray(o_j).transpose(0, 2, 1, 3)) <= 1e-5
    assert _rel(l.numpy(), l_j) <= 1e-5 and _rel(m.numpy(), m_j) <= 1e-5
    got = flash_attention.flash_attention_bwd_plain(tq, tk, tv, o, l, m, tdo)
    for g, w in zip(got, grads_j):
        assert _rel(g.numpy(), w) <= 1e-5

    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o2, l2, m2 = flash_attention.flash_attention(*leaves)
    assert torch.equal(o2.detach(), o) and torch.equal(l2, l) and torch.equal(m2, m)
    o2.backward(tdo)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def test_ffn_block_matches_jax_interpret_at_whisper_large_width():
    """The FFN block's plain forward and backward at D = 1280, F = 5120,
    rate 0: the widths its dropout forward and backward kernels gained for
    Whisper training, against ``jax.vjp`` of the JAX block in interpret mode."""
    D, F = 1280, 5120
    rng = np.random.default_rng(0)
    jx = [rng.standard_normal((1, 16, D)) + 0.3, rng.standard_normal((D, F)) * D**-0.5,
          rng.standard_normal(F) * 0.1, rng.standard_normal(D) * 0.1 + 1.0,
          rng.standard_normal(D) * 0.1, rng.standard_normal((F, D)) * F**-0.5,
          rng.standard_normal(D) * 0.1]
    jx = [a.astype(np.float32) for a in jx]
    dy = rng.standard_normal((1, 16, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jffn.ffn_ln_block(*a, interpret=True, dg_in_kernel=True),
                        *map(jnp.asarray, jx))
    want_grads = vjp(jnp.asarray(dy))
    transposed = (1, 5)  # W1, W2: JAX (in, out), the port (out, in)
    args = [torch.from_numpy(a.T.copy() if i in transposed else a).requires_grad_(True)
            for i, a in enumerate(jx)]
    out = ffn.ffn_ln_block(*args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5, rtol=0)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(args[0].grad.numpy(), np.asarray(want_grads[0]), atol=2e-5,
                               rtol=0)
    for i in range(1, 7):
        got = args[i].grad.T if i in transposed else args[i].grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want_grads[i]), atol=1e-4, rtol=0)


# Forward runs per layer and microbatch at T_mel 2048 (the flash route): the
# flash forward runs again in the replay unless its o, l and m are kept; the
# FFN block's forward never (its residuals are its inputs).
FLASH_FORWARDS = {"nothing_saveable": 2, "save_matmul_inputs": 1, "save_flash_ctx": 1}


@pytest.mark.parametrize("policy", sorted(PW.REMAT_POLICIES))
def test_gradient_checkpointing_gives_identical_gradients(policy, monkeypatch):
    """Activation dropout 0.1, embedding dropout 0.1 and SpecAugment on: the
    replay draws nothing and hands back what the forward kept, so the
    gradients with checkpointing under each policy and without it are the
    same bits; spies on the plain forwards count what each policy replays."""
    calls = collections.Counter()

    def spy(module, name, key):
        fn = getattr(module, name)

        def counted(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, counted)

    spy(flash_attention, "flash_attention_fwd_plain", "flash")
    spy(ffn, "ffn_ln_fc1_plain", "ffn")
    jc, pc = _configs("narrow", dropout=0.1, mask_feature_length=8, remat_policy=policy)
    params = _seeded_params(jc, seed=0)
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(rng.standard_normal((1, 2048, 80)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 300, size=(1, 12)))
    grads, counts = [], []
    for remat in (True, False):
        model = _port_model(params, pc)
        calls.clear()
        logits = PW.forward(model, feats, ids, deterministic=False,
                            generator=torch.Generator().manual_seed(5),
                            gradient_checkpointing=remat)
        torch.log_softmax(logits, -1)[..., 7].sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        counts.append(dict(calls))
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
    L = NARROW["encoder_layers"]
    assert counts[0] == {"flash": FLASH_FORWARDS[policy] * L, "ffn": 2 * L}, counts[0]
    assert counts[1] == {"flash": L, "ffn": 2 * L}
    assert grads[0]["model.encoder.layers.0.fc1.weight"].any()


def _setup_config(**model):
    return {"model": {"type": "whisper", "architecture": "tiny_test", "sampling_rate": 16_000,
                      "learning_rate": 1e-3, **model},
            "bf16_allowed": False, "augment_audio": False, "gradient_checkpointing": True}


def test_setup_picks_the_remat_policy_by_width_and_refuses_what_is_not_ported(tmp_path,
                                                                             monkeypatch):
    """save_matmul_inputs below d 1280, save_flash_ctx for large-v3, a
    model.remat_policy wins; more than one device and an unknown policy
    raise; ``fused_ffn_block_dw: true`` (dW inside the block's backward)
    builds its train step on that variant."""
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert load_model_setup(_setup_config(), device="cpu").model_config.remat_policy == (
        "save_matmul_inputs")
    large = load_model_setup({"model": {"type": "whisper",
                                        "pretrained_model_id": "openai/whisper-large-v3"}},
                             device="cpu")
    assert large.model_config.remat_policy == "save_flash_ctx"
    assert large.learning_rate == 1e-5 and large.chunk_length == 480_000
    assert large.max_label_length == 448 and large.grad_dtype == "bfloat16"
    setup = load_model_setup(_setup_config(remat_policy="nothing_saveable"), device="cpu")
    assert setup.model_config.remat_policy == "nothing_saveable"
    tx, schedule = create_optimizer(1e-3, 1, 10)
    assert callable(setup.make_train_step(tx, schedule))
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        load_model_setup({**_setup_config(), "mesh": [2, 1]}, device="cpu").make_train_step(
            tx, schedule)
    with pytest.raises(ValueError, match="remat_policy"):
        load_model_setup(_setup_config(remat_policy="save_everything"),
                         device="cpu").make_train_step(tx, schedule)
    dw = load_model_setup(_setup_config(fused_ffn_block_dw=True), device="cpu")
    assert dw.model_config.ffn_variant == "dw"
    assert callable(dw.make_train_step(tx, schedule))


def test_loss_decreases_through_the_setup(tmp_path):
    """The production settings at the tiny size through the entry points:
    augmentation with a noise bank, activation dropout, SpecAugment and
    checkpointing on; four steps, the loss finite and falling."""
    np.save(tmp_path / "bank.npy",
            np.random.default_rng(0).standard_normal((3, 8000)).astype(np.float32))
    cfg = {**_setup_config(mask_feature_length=8), "augment_audio": True,
           "background_noise_path": str(tmp_path / "bank.npy")}
    setup = load_model_setup(cfg, device="cpu")
    model = setup.init_params(seed=0)
    tx, schedule = create_optimizer(setup.learning_rate, warmup_steps=1, max_steps=100,
                                    mu_dtype="bfloat16")
    state = TrainState.create(model, tx)
    step = setup.make_train_step(tx, schedule)
    batch = _batch(seed=0)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert state.step == 5 and float(metrics["grad_norm"]) > 0
    with pytest.raises(ValueError, match="multiple of 320"):
        step(state, {k: v[..., :1000] if k == "input_values" else v for k, v in batch.items()},
             gen)


def test_randomness_is_drawn_before_the_model_runs():
    """Every draw happens in draw_randomness, in a fixed order; rates of 0
    draw no seeds."""
    cfg = PW.WhisperConfig.tiny_test(dropout=0.1)
    a = PW.draw_randomness(cfg, 3, 40, torch.Generator().manual_seed(1), "cpu")
    b = PW.draw_randomness(cfg, 3, 40, torch.Generator().manual_seed(1), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.time_starts.shape == (3, 40) and a.feature_starts.shape == (3, 80)
    assert a.encoder.shape == (2, 3) and a.decoder.shape == (2, 3) and a.embed.shape == (3,)
    quiet = PW.draw_randomness(dataclasses.replace(cfg, **QUIET, dropout=0.0), 3, 40,
                               torch.Generator().manual_seed(1), "cpu")
    assert quiet == PW.Randomness(None, None, None, None, None)
