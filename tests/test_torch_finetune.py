"""coral_tpu_torch's fine-tuning loop against coral_tpu's, on the CPU.

Both packages' ``finetune`` run the same composed config
(``test-wav2vec2`` at ``+model.architecture=tiny``, one device, fp32,
augmentation, masks and dropouts off, gradient accumulation 2, bucketed
``synthetic://`` data) from the same initial weights: the JAX run's, drawn
under the PRNG impl that its ``finetune`` sets from ``prng_impl`` and carried
over by ``wav2vec2_state_dict_from_jax``. ``run_validation`` is replaced in
both by the same scripted CERs, so that early stopping, best-k retention and
the best step loaded at the end are decided alike; a recording tracker takes
both loops' logs. One JAX run serves the module (about 30 s with its
compiles). Held: every logged ``loss`` and ``grad_norm`` within 1e-3
relative, ``learning_rate`` exactly, the same steps logged and evaluated (the
early stop), the same step restored at the end, the same checkpoint steps left
on disk. The port alone: a run to 2 steps resumed to 4 ends with the straight
run's state bit for bit (its step-4 checkpoint and saved masters), the data
skip included; ``save_model`` then ``load_saved_predictor`` gives the
in-memory predictor's strings for both families (with Whisper's eval-time
overrides), and a JAX-style saved directory (orbax ``model/``) raises naming
the converter (tests/test_torch_convert_jax_dir.py converts and serves one);
more than one device raises before any work;
``profile_step`` writes a trace; the Hub push calls a stub
``huggingface_hub`` with the JAX push's arguments, so no test reaches the
network; the tracking factory degrades as JAX's.
"""

import importlib
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

from coral_tpu.config import compose as jax_compose
from coral_tpu.training.checkpoint import Checkpointer as JaxCheckpointer
from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
from coral_tpu.utils.hub import push_model_to_hub as jax_push
from coral_tpu_torch import tracking
from coral_tpu_torch.config import compose
from coral_tpu_torch.evaluation.evaluate import load_saved_predictor
from coral_tpu_torch.models.convert import wav2vec2_state_dict_from_jax
from coral_tpu_torch.training import TrainState, create_optimizer
from coral_tpu_torch.training.checkpoint import Checkpointer
from coral_tpu_torch.training.model_setup import Wav2Vec2Setup, load_model_setup
from coral_tpu_torch.utils.hub import push_model_to_hub

# The modules, not the `finetune` functions that the packages' `training`
# export under the same name.
jax_ft = importlib.import_module("coral_tpu.training.finetune")
port_ft = importlib.import_module("coral_tpu_torch.training.finetune")

torch.set_num_threads(1)

BASE = [
    "model=test-wav2vec2", "datasets=[synthetic]", "+model.architecture=tiny",
    "evaluation_datasets=[{id: synthetic://4, val_name: val}]", "mesh=[1,1]",
    "total_batch_size=4", "per_device_batch_size=2", "warmup_steps=2", "logging_steps=1",
    "enable_experiment_tracking=false", "bf16_allowed=false", "gradient_checkpointing=false",
    "max_seconds_per_example=5.0", "num_length_buckets=1", "+max_label_length=48",
    "augment_audio=false", "model.activation_dropout=0.0", "model.mask_time_prob=0.0",
    "model.mask_feature_prob=0.0", "datasets.synthetic.id=synthetic://12", "model_id=tiny",
]
# Evaluated every step from a scripted CER: best at step 2, no improvement at
# 3 and 4, so patience 2 stops the loop at step 4 of 6; with two kept, step
# 4's checkpoint is dropped as soon as it is written and step 2 is restored.
EARLY = ["eval_steps=1", "save_steps=1", "save_total_limit=2", "early_stopping=true",
         "early_stopping_patience=2", "max_steps=6"]
SCRIPTED_CER = [0.5, 0.3, 0.4, 0.45, 0.2, 0.1]
LOSS_RTOL = 1e-3


class Recorder(tracking.TrackingSetup):
    """A tracker that keeps every logged metric by step."""

    def __init__(self, config=None):
        super().__init__(config)
        self.logs = {}

    def run_initialization(self):
        pass

    def log_metrics(self, metrics, step):
        self.logs.setdefault(step, {}).update(metrics)

    def run_finalization(self):
        pass


def _scripted(values):
    it = iter(values)

    def run_validation(*args, **kwargs):
        cer = next(it)
        return {"cer": cer, "wer": min(1.0, 2 * cer)}

    return run_validation


def _steps_on_disk(model_dir):
    return sorted(int(p.name) for p in (model_dir / "checkpoints").iterdir() if p.name.isdigit())


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX loop with scripted CERs: its logs, the steps it restored, its
    checkpoint steps, and its initial weights."""
    patch = pytest.MonkeyPatch()
    prev_impl = jax.config.jax_default_prng_impl
    model_dir = tmp_path_factory.mktemp("jax") / "model"
    recorder, restored = Recorder(), []
    restore = JaxCheckpointer.restore
    try:
        patch.setattr(jax_ft, "load_tracking_setup", lambda config: recorder)
        patch.setattr(jax_ft, "run_validation", _scripted(SCRIPTED_CER))
        patch.setattr(JaxCheckpointer, "restore", lambda self, abstract, step=None: (
            restored.append(step), restore(self, abstract, step))[1])
        config = jax_compose("asr_finetuning", overrides=BASE + EARLY + [f"model_dir={model_dir}"])
        jax_ft.finetune(config)
        # The initial weights, drawn as `finetune` drew them: its key split
        # under the PRNG impl it set from prng_impl.
        init_rng, _ = jax.random.split(jax.random.PRNGKey(int(config.seed)))
        params = jax.device_get(jax_load_model_setup(config).init_params(init_rng))
    finally:
        jax.config.update("jax_default_prng_impl", prev_impl)
        patch.undo()
    return {"logs": recorder.logs, "restored": restored, "params": params,
            "steps": _steps_on_disk(model_dir)}


@pytest.fixture
def jax_weights(jax_run, monkeypatch):
    """Every port setup built in the test starts from the JAX run's weights."""
    init_params = Wav2Vec2Setup.init_params

    def from_jax(self, seed=0, pretrained=True):
        model = init_params(self, seed=seed, pretrained=pretrained)
        model.load_state_dict(wav2vec2_state_dict_from_jax(jax_run["params"], self.model_config))
        return model

    monkeypatch.setattr(Wav2Vec2Setup, "init_params", from_jax)


def _port_run(monkeypatch, model_dir, extra=(), cer=None):
    recorder = Recorder()
    monkeypatch.setattr(port_ft, "load_tracking_setup", lambda config: recorder)
    if cer is not None:
        monkeypatch.setattr(port_ft, "run_validation", _scripted(cer))
    config = compose("asr_finetuning", overrides=BASE + list(extra) + [f"model_dir={model_dir}"])
    history = port_ft.finetune(config, device="cpu")
    return history, recorder.logs


def test_finetune_matches_jax(jax_run, jax_weights, monkeypatch, tmp_path):
    restored = []
    restore = Checkpointer.restore
    monkeypatch.setattr(Checkpointer, "restore", lambda self, state, step=None: (
        restored.append(step), restore(self, state, step))[1])
    history, logs = _port_run(monkeypatch, tmp_path / "model", EARLY, SCRIPTED_CER)
    want = jax_run["logs"]
    assert sorted(logs) == sorted(want) == [1, 2, 3, 4]  # stopped early at 4 of 6
    for step in want:
        got_m, want_m = logs[step], want[step]
        assert got_m.keys() == want_m.keys()
        np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got_m["grad_norm"], want_m["grad_norm"], rtol=LOSS_RTOL)
        assert got_m["learning_rate"] == want_m["learning_rate"]
        assert got_m["val_4_cer"] == want_m["val_4_cer"]
        assert got_m["infeed_mb_per_step"] == want_m["infeed_mb_per_step"]
    assert restored == jax_run["restored"] == [2]
    assert _steps_on_disk(tmp_path / "model") == jax_run["steps"] == [2, 3]
    assert history["val_4_cer"] == SCRIPTED_CER[3]
    # The final model is step 2's masters.
    saved = torch.load(tmp_path / "model" / "model" / "params.pt", weights_only=True)
    step2 = torch.load(tmp_path / "model" / "checkpoints" / "2" / "state.pt",
                       weights_only=True)
    assert all(torch.equal(saved[k], step2["params"][k]) for k in saved)
    assert step2["step"] == 2 and step2["opt_state"]["count"] == 2


def test_resume_gives_the_straight_run_bit_for_bit(jax_weights, monkeypatch, tmp_path):
    plan = ["eval_steps=2", "save_steps=2", "save_total_limit=1"]
    _, logs_a = _port_run(monkeypatch, tmp_path / "resumed", plan + ["max_steps=2"])
    _, logs_b = _port_run(monkeypatch, tmp_path / "resumed",
                          plan + ["max_steps=4", "resume_from_checkpoint=true"])
    _, logs_c = _port_run(monkeypatch, tmp_path / "straight", plan + ["max_steps=4"])
    assert sorted(logs_a) == [1, 2] and sorted(logs_b) == [3, 4] and sorted(logs_c) == [1, 2, 3, 4]
    for step in (3, 4):
        assert logs_b[step]["loss"] == logs_c[step]["loss"]
        assert logs_b[step]["grad_norm"] == logs_c[step]["grad_norm"]
    got = torch.load(tmp_path / "resumed" / "checkpoints" / "4" / "state.pt", weights_only=True)
    want = torch.load(tmp_path / "straight" / "checkpoints" / "4" / "state.pt",
                      weights_only=True)
    assert got["step"] == want["step"] == 4
    for part in ("mu", "nu"):
        assert all(torch.equal(got["opt_state"][part][k], want["opt_state"][part][k])
                   for k in want["opt_state"][part])
    assert all(torch.equal(got["params"][k], want["params"][k]) for k in want["params"])
    saved = [torch.load(tmp_path / d / "model" / "params.pt", weights_only=True)
             for d in ("resumed", "straight")]
    assert all(torch.equal(saved[0][k], saved[1][k]) for k in saved[1])
    # A resume that ignores the data skip trains steps 3-4 on batches 1-2.
    shutil.rmtree(tmp_path / "resumed" / "checkpoints" / "4")
    _, logs_d = _port_run(monkeypatch, tmp_path / "resumed",
                          plan + ["max_steps=4", "resume_from_checkpoint=true",
                                  "ignore_data_skip=true"])
    assert logs_d[3]["infeed_mb_per_step"] == logs_c[1]["infeed_mb_per_step"]


def _serving_batch(seconds, n=4, seed=0):
    rng = np.random.default_rng(seed)
    T = int(seconds * 16_000)
    audio = np.zeros((n, T), np.float32)
    lengths = rng.integers(T // 2, T + 1, n).astype(np.int32)
    for i, length in enumerate(lengths):
        audio[i, :length] = rng.standard_normal(length).astype(np.float32) * 0.1
    return {"input_values": audio, "input_lengths": lengths}


@pytest.mark.parametrize("family", ["wav2vec2", "whisper"])
def test_saved_model_serves_the_in_memory_strings(family, tmp_path):
    overrides = (BASE if family == "wav2vec2" else [
        "model=test-whisper", "+model.architecture=tiny_test", "model.max_length=12",
        "bf16_allowed=false", "model_id=tiny"])
    config = compose("asr_finetuning", overrides=overrides + [f"model_dir={tmp_path}"])
    setup = load_model_setup(config, device="cpu")
    model = setup.init_params(seed=3)
    tx, _ = create_optimizer(1e-3, 1, 10)
    state = TrainState.create(model, tx)
    with torch.no_grad():  # masters that differ from the seeded weights
        for p in state.params.values():
            p.mul_(1.5)
    port_ft.save_model(config, setup, state)
    assert (tmp_path / "config.yaml").exists() and (tmp_path / "vocab.json").exists()
    for name, p in model.named_parameters():
        p.data = state.params[name]
    batch = _serving_batch(setup.audio_pad_seconds if family == "whisper" else 3.0)
    want = setup.make_predictor(model)(batch)
    predict, geometry = load_saved_predictor({"model_id": str(tmp_path), "sampling_rate": 16_000},
                                             device="cpu")
    assert predict(batch) == want
    assert geometry == {"max_seconds": setup.audio_pad_seconds, "sample_rate": 16_000}
    if family == "whisper":  # an eval-time override reaches the saved config
        short, _ = load_saved_predictor({"model_id": str(tmp_path), "sampling_rate": 16_000,
                                         "generation_max_length": 5}, device="cpu")
        assert short.generate.__closure__ is not None
        ids = short.generate(short.model, batch)
        assert ids.shape[1] == 5


def test_a_jax_saved_directory_raises_naming_the_converter(tmp_path):
    (tmp_path / "config.yaml").write_text("model:\n  type: wav2vec2\n")
    (tmp_path / "model" / "d").mkdir(parents=True)  # an orbax tree
    with pytest.raises(ValueError, match="tools/convert_coral_tpu_model.py"):
        load_saved_predictor({"model_id": str(tmp_path), "sampling_rate": 16_000},
                             device="cpu")


@pytest.mark.parametrize("override,item", [("mesh=[2,1]", "item 7"),
                                           ("distributed=true", "item 7")])
def test_refusals_come_before_any_work(override, item, monkeypatch, tmp_path):
    monkeypatch.setattr(port_ft, "load_model_setup", lambda *a, **k: pytest.fail("built"))
    config = compose("asr_finetuning", overrides=BASE + [override, f"model_dir={tmp_path}"])
    with pytest.raises(NotImplementedError, match=item):
        port_ft.finetune(config, device="cpu")


def test_profile_step_writes_a_trace(jax_weights, monkeypatch, tmp_path):
    _port_run(monkeypatch, tmp_path, ["eval_steps=5", "save_steps=5", "max_steps=2",
                                      "profile_step=0", "profile_num_steps=1"])
    traces = list((tmp_path / "profile").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


class _HubStub:
    def __init__(self):
        self.calls = []

    def module(self):
        stub = types.ModuleType("huggingface_hub")
        calls = self.calls

        class HfApi:
            def create_repo(self, *args, **kwargs):
                calls.append(("create_repo", args, kwargs))

            def upload_folder(self, *args, **kwargs):
                calls.append(("upload_folder", args, kwargs))

        stub.HfApi = HfApi
        return stub


def test_hub_push_calls_the_stub_as_jax(monkeypatch, tmp_path):
    overrides = ["model=wav2vec2-small", "datasets=[synthetic]", "model_id=my-model",
                 f"model_dir={tmp_path}", "push_to_hub=true", "private=true"]
    got, want = _HubStub(), _HubStub()
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setitem(sys.modules, "huggingface_hub", got.module())
    push_model_to_hub(compose("asr_finetuning", overrides=overrides))
    card = (tmp_path / "README.md").read_text()
    monkeypatch.setitem(sys.modules, "huggingface_hub", want.module())
    jax_push(jax_compose("asr_finetuning", overrides=overrides))
    assert got.calls == want.calls and len(got.calls) == 2
    assert got.calls[0][1] == ("alexandrainst/my-model",)
    assert got.calls[0][2] == {"private": True, "exist_ok": True}
    assert "coral_tpu_torch" in card and "facebook/wav2vec2-xls-r-300m" in card
    # Without huggingface_hub both return after a warning.
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    push_model_to_hub(compose("asr_finetuning", overrides=overrides))


def test_finetune_pushes_when_asked(jax_weights, monkeypatch, tmp_path):
    stub = _HubStub()
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setitem(sys.modules, "huggingface_hub", stub.module())
    _port_run(monkeypatch, tmp_path, ["eval_steps=5", "save_steps=5", "max_steps=1",
                                      "push_to_hub=true"])
    assert [c[0] for c in stub.calls] == ["create_repo", "upload_folder"]
    assert stub.calls[1][2]["folder_path"] == str(tmp_path)


def test_tracking_factory_degrades_as_jax():
    from coral_tpu import tracking as jax_tracking
    from coral_tpu.config import DictConfig as JaxDictConfig
    from coral_tpu_torch.config import DictConfig

    for cfg in ({"enable_experiment_tracking": False},
                {"enable_experiment_tracking": True, "experiment_tracking": {"type": "none"}},
                {"enable_experiment_tracking": True, "experiment_tracking": {"type": "mlflow"}}):
        got = tracking.load_tracking_setup(DictConfig(cfg))
        want = jax_tracking.load_tracking_setup(JaxDictConfig(cfg))
        assert type(got).__name__ == type(want).__name__ == "NoOpSetup"
        got.run_initialization()
        got.log_metrics({"loss": 1.0}, step=1)
        got.run_finalization()
    with pytest.raises(ValueError, match="Unsupported"):
        tracking.load_tracking_setup(DictConfig({"enable_experiment_tracking": True,
                                                 "experiment_tracking": {"type": "x"}}))
