"""wav2vec2's flash route at XLS-R-1B's and -2B's head dims (80, 120), on the CPU.

The flash kernels with segment ids are built at head_dim 64, 80 and 120, so
``attention_impl: flash`` runs at every width of ``config/model/``. JAX's
flash route lowers only on a TPU, so, as in tests/test_torch_unfused.py, the
port's plain K7-seg is held against the stock reference
(``mha_reference_no_custom_vjp`` with ``SegmentIds``, there, parametrised
over the head dims), and the port's flash-route model and train step against
JAX's ``xla`` route on the valid frames, where the two routes agree, at
narrow configs whose two heads are 80 and 120 wide.

Tolerances, fp32 on both sides with sums in another order: the logits within
1e-4 of max |JAX| (tests/test_torch_unfused.py's); the train step as
tests/test_torch_train.py holds it.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from coral_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from coral_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from coral_tpu_torch.models import wav2vec2
from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from coral_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from coral_tpu_torch.ops import flash_attention
from coral_tpu_torch.training import model_setup as port_setup
from test_torch_train import QUIET, VOCAB, _steps_match_jax
from test_torch_unfused import PORT_UNFUSED, UNFUSED_FLAGS
from test_torch_wav2vec2 import ARCHS, LENGTHS, N_SAMPLES, _seeded_params

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "config" / "model").glob("*.yaml"))
W2V2_CONFIGS = [p for p in CONFIGS if yaml.safe_load(p.read_text())["type"] == "wav2vec2"]


def _narrow(head_dim: int) -> dict:
    """The narrow test architecture with two heads of ``head_dim``."""
    return {**ARCHS["narrow"], "hidden_size": 2 * head_dim, "intermediate_size": 4 * head_dim}


def test_the_kernels_take_every_head_dim_of_the_configs():
    assert flash_attention.KERNEL_HEAD_DIMS == (64, 80, 120)
    archs = (Wav2Vec2Config.xls_r_300m(), Wav2Vec2Config.xls_r_1b(), Wav2Vec2Config.xls_r_2b())
    dims = {a.hidden_size // a.num_attention_heads for a in archs}
    assert dims == set(flash_attention.KERNEL_HEAD_DIMS)


@pytest.mark.parametrize("head_dim", [80, 120])
def test_flash_model_at_xls_r_head_dims_matches_jax(head_dim):
    """The port's flash route (segment ids) against JAX's xla route on the
    valid frames (padded frames attend to padded keys on the flash route, to
    valid keys on xla), with the unfused FFN, a full, a padded and a filler
    row."""
    arch = _narrow(head_dim)
    jax_model = JaxModel(JaxConfig(**arch, **UNFUSED_FLAGS))
    params = _seeded_params(jax_model, seed=0)
    audio = np.random.default_rng(1).standard_normal((3, N_SAMPLES)).astype(np.float32)
    want, want_frames = (np.asarray(a) for a in jax_model.apply(
        {"params": params}, jnp.asarray(audio), jnp.asarray(LENGTHS), deterministic=True))
    model = Wav2Vec2ForCTC(Wav2Vec2Config(**arch, attention_impl="flash", **PORT_UNFUSED)).eval()
    assert model.config.hidden_size // model.config.num_attention_heads == head_dim
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    with torch.inference_mode():
        logits, frames = model(torch.from_numpy(audio), torch.from_numpy(LENGTHS).long())
    np.testing.assert_array_equal(frames.numpy(), want_frames)
    valid = np.arange(logits.shape[1])[None, :] < want_frames[:, None]
    assert valid.sum() < valid.size and want_frames[-1] <= 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(logits.numpy()[valid] / scale, want[valid] / scale, atol=1e-4)


@pytest.mark.parametrize("head_dim", [80, 120])
def test_flash_train_step_at_xls_r_head_dims_matches_jax(head_dim):
    """Three steps of both packages' CTC train step at a tiny config with two
    heads of ``head_dim`` (fp32, activation dropout 0, SpecAugment off,
    checkpointing under nothing_saveable): JAX's on its xla route, the port's
    on the flash route (the same valid frames; padded frames have no gradient
    under the CTC loss)."""
    arch = dict(vocab_size=VOCAB, hidden_size=2 * head_dim, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=4 * head_dim, conv_dim=(16,) * 4,
                conv_stride=(5, 4, 4, 4), conv_kernel=(10, 3, 3, 3),
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2, **QUIET)
    jax_model = JaxModel(JaxConfig(**arch, **UNFUSED_FLAGS), gradient_checkpointing=True,
                         remat_policy="nothing_saveable")
    params = _seeded_params(jax_model, seed=0)
    model = Wav2Vec2ForCTC(Wav2Vec2Config(**arch, attention_impl="flash", **PORT_UNFUSED))
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, model.config))
    model.wav2vec2.encoder.gradient_checkpointing = True
    _steps_match_jax(jax_model, params, model, True)


@pytest.mark.parametrize("impl", ["pallas", "flash", "xla"])
@pytest.mark.parametrize("path", W2V2_CONFIGS, ids=lambda p: p.stem)
def test_every_wav2vec2_config_passes_the_width_check_on_every_attention_impl(path, impl):
    """The setup on ``cuda`` (nothing is built, so no card is needed) takes
    every wav2vec2 config on each ``attention_impl``: XLS-R-1B's head_dim 80
    and -2B's 120 on the flash route too."""
    config = {"model": {**yaml.safe_load(path.read_text()), "attention_impl": impl},
              "max_seconds_per_example": 10.0}
    setup = port_setup.load_model_setup(config, device="cuda")
    assert setup.model_config.attention_impl == impl
    port_setup.check_kernel_widths(setup.model_config)
    if impl == "flash":
        widths = {w[0]: w for w in wav2vec2.kernel_widths(setup.model_config)}
        what, value, takes = widths["head_dim (the flash attention)"]
        assert takes == flash_attention.KERNEL_HEAD_DIMS and value in takes
