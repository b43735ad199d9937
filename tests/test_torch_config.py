"""coral_tpu_torch's config composer against coral_tpu's, on the CPU.

The port's ``config`` module is a copy of the JAX package's (less its JAX
platform import). Held here: ``to_container(compose(...))`` of both packages
is equal, and ``to_yaml`` gives the same bytes, for every root config in
``config/``, for ``asr_finetuning`` with every ``model=`` option, and over the
override grammar (``key=value``, ``group=option``, ``group=[a,b]``,
``+key``, ``++key``, ``~key``, dotted paths, flow values); the errors of a
bad override or option are the same; ``DictConfig``'s access and
interpolation agree. ``${now:...}`` reads the clock, so both packages'
resolver is pinned to one date for these tests.
"""

from pathlib import Path

import pytest

import coral_tpu.config as jax_config
import coral_tpu_torch.config as port_config

CONFIG = Path(__file__).resolve().parent.parent / "config"
ROOTS = sorted(p.stem for p in CONFIG.glob("*.yaml"))
MODELS = sorted(p.stem for p in (CONFIG / "model").glob("*.yaml"))


@pytest.fixture(autouse=True)
def _fixed_clock(monkeypatch):
    for module in (jax_config, port_config):
        monkeypatch.setitem(module._RESOLVERS, "now",
                            lambda fmt="%Y-%m-%d_%H-%M-%S": "2026-01-02")


def _both(name, overrides=()):
    return (port_config.compose(name, overrides=list(overrides), config_path=CONFIG),
            jax_config.compose(name, overrides=list(overrides), config_path=CONFIG))


def _assert_same(got, want):
    assert port_config.to_container(got) == jax_config.to_container(want)
    assert (port_config.to_container(got, resolve=False)
            == jax_config.to_container(want, resolve=False))
    assert port_config.to_yaml(got) == jax_config.to_yaml(want)
    assert port_config.to_yaml(got).encode("utf-8") == jax_config.to_yaml(want).encode("utf-8")


def test_the_roots_and_models_are_there():
    assert {"asr_finetuning", "evaluation", "dataset_creation"} <= set(ROOTS)
    assert {"wav2vec2-small", "whisper-large", "test-wav2vec2"} <= set(MODELS)


@pytest.mark.parametrize("name", ROOTS)
def test_every_root_config_composes_as_jax(name):
    _assert_same(*_both(name))


@pytest.mark.parametrize("model", MODELS)
def test_every_model_option_composes_as_jax(model):
    got, want = _both("asr_finetuning", [f"model={model}"])
    _assert_same(got, want)
    assert got.model.name == model
    assert got.model_id == f"{model}-2026-01-02"


OVERRIDES = {
    "value": ["total_batch_size=16", "seed=7", "padding=max_length"],
    "float_without_dot": ["model=wav2vec2-small", "model.learning_rate=3e-4"],
    "dotted": ["model=whisper-small", "model.max_length=32", "model.dropout=0.1"],
    "group_list": ["datasets=[synthetic,test_dataset]"],
    "group_null": ["decoder_datasets=null", "experiment_tracking=mlflow"],
    "flow_list_of_maps": ["evaluation_datasets=[{id: synthetic://16, val_name: val}]"],
    "append": ["+max_label_length=48", "+model.architecture=tiny", "++eval_max_samples=8"],
    "delete": ["~cache_dir", "~model.layerdrop"],
    "mesh_and_bools": ["mesh=[1,1]", "push_to_hub=true", "enable_experiment_tracking=false",
                       "background_noise_path=null"],
    "chip_phase": ["model=wav2vec2-small", "datasets=[synthetic]",
                   "evaluation_datasets=[{id: synthetic://16, val_name: val}]",
                   "model.use_decoder=false", "enable_experiment_tracking=false",
                   "per_device_batch_size=8", "total_batch_size=16", "warmup_steps=2",
                   "logging_steps=1", "eval_steps=2", "save_steps=2", "save_total_limit=1",
                   "model_dir=/tmp/run"],
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_the_override_grammar_composes_as_jax(case):
    got, want = _both("asr_finetuning", OVERRIDES[case])
    _assert_same(got, want)


def test_override_values():
    got, _ = _both("asr_finetuning", OVERRIDES["chip_phase"] + OVERRIDES["append"][:2]
                   + ["~model.layerdrop"])
    assert list(got.datasets) == ["synthetic"]
    assert got.datasets.synthetic.id == "synthetic://64"
    assert got.evaluation_datasets[0]["id"] == "synthetic://16"
    assert got.model.use_decoder is False and got.max_label_length == 48
    assert got.model.learning_rate == 1e-4 and isinstance(got.model.learning_rate, float)
    assert got.model_dir == "/tmp/run" and got.model.architecture == "tiny"
    assert "layerdrop" not in got.model


@pytest.mark.parametrize("overrides,error", [
    (["no_such_key=1"], KeyError),
    (["model.no_such_key=1"], KeyError),
    (["model=no-such-model"], FileNotFoundError),
    (["datasets=[synthetic,no_such_set]"], FileNotFoundError),
], ids=["missing_key", "missing_dotted_key", "missing_option", "missing_list_option"])
def test_bad_overrides_raise_as_jax(overrides, error):
    with pytest.raises(error) as got:
        port_config.compose("asr_finetuning", overrides=overrides, config_path=CONFIG)
    with pytest.raises(error) as want:
        jax_config.compose("asr_finetuning", overrides=overrides, config_path=CONFIG)
    assert str(got.value) == str(want.value)


def test_dictconfig_access_and_interpolation_as_jax():
    tree = {"a": {"b": 3, "c": "${a.b}", "d": "x-${a.b}-y"}, "l": [1, "${a.b}", {"e": "${l.0}"}],
            "bad": "${nope}"}
    got, want = port_config.DictConfig(tree), jax_config.DictConfig(tree)
    for cfg in (got, want):
        assert cfg.a.c == 3 and cfg.a.d == "x-3-y" and cfg.l[1] == 3 and cfg.l[2]["e"] == 1
        assert cfg.select("a.b") == 3 and cfg.select("l.2.e") == 1
        assert cfg.select("a.zz", default="z") == "z" and cfg.get("zz", 5) == 5
        cfg.set_dotted("m.n", 4)
        assert cfg.m.n == 4
        with pytest.raises(KeyError):
            cfg.set_dotted("p.q", 1, create=False)
        with pytest.raises(AttributeError):
            cfg.nothing
    with pytest.raises(port_config.InterpolationError):
        got.bad
    assert port_config.to_container(got.copy(), resolve=False) == jax_config.to_container(
        want.copy(), resolve=False)
    base_got, base_want = port_config.DictConfig({"x": {"y": 1, "z": [1]}}), {"x": {"y": 1,
                                                                                    "z": [1]}}
    port_config.merge(base_got, {"x": {"z": [2], "w": 3}})
    jax_config.merge(base_want, {"x": {"z": [2], "w": 3}})
    assert port_config.to_container(base_got) == base_want == {"x": {"y": 1, "z": [2], "w": 3}}


def test_compose_from_outside_the_repository(tmp_path, monkeypatch):
    """Without a config path, from a directory without ``config/``, both
    packages fall back to the tree beside them: the repository's."""
    monkeypatch.chdir(tmp_path)
    got = port_config.compose("asr_finetuning", overrides=["model=test-whisper"])
    want = jax_config.compose("asr_finetuning", overrides=["model=test-whisper"])
    _assert_same(got, want)


def test_initialize_sets_the_search_path(tmp_path, monkeypatch):
    (tmp_path / "model").mkdir()
    (tmp_path / "root.yaml").write_text("defaults:\n  - model: m\n  - _self_\nx: 1e-4\n")
    (tmp_path / "model" / "m.yaml").write_text("name: m\nwidth: 100_000\n")
    monkeypatch.setattr(port_config, "_CONFIG_PATH", None)
    port_config.initialize(tmp_path)
    got = port_config.compose("root")
    assert port_config.to_container(got) == {"model": {"name": "m", "width": 100000},
                                             "x": 1e-4}
    want = jax_config.compose("root", config_path=tmp_path)
    _assert_same(got, want)
