"""``python -m coral_tpu_torch``'s commands against the JAX package's scripts.

Each command runs in-process through ``cli.main([...])`` with ``--device
cpu``, and the script it replaces (``scripts/*.py``, loaded from its file)
through its ``main`` with ``sys.argv`` set to the same overrides, each in a
working directory of its own. Held exactly: ``evaluate``'s CSV (its name
and bytes), ``validate``'s ``validated.jsonl``, ``train-ngram``'s ARPA
file, and the lines ``demo``'s standard-input loop prints for a short
stereo WAV and a long one at another rate, cut into windows. ``finetune``
runs the tiny config for two steps. Both packages' setups are built in fp32
(``test_torch_evaluate.fp32``: the pretrained-id branch's bf16 rounds
differently in the two frameworks on the CPU).
"""

import importlib.util
import io
import json
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import hf_checkpoints as hf
from coral_tpu_torch import cli
from test_torch_evaluate import fp32  # noqa: F401  (fixture)
from test_torch_finetune import BASE
from test_torch_ngram_pipeline import _decoder_overrides, jax_decoding  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    directory = tmp_path_factory.mktemp("models") / "wav2vec2-tiny"
    hf.w2v2_checkpoint(directory, seed=7)
    return directory


def _both(monkeypatch, tmp_path, script: str, command: str, overrides: list[str]) -> None:
    """The script's ``main`` in ``tmp_path/jax``, the command's in
    ``tmp_path/port``."""
    for package in ("jax", "port"):
        (tmp_path / package).mkdir(exist_ok=True)
        monkeypatch.chdir(tmp_path / package)
        if package == "jax":
            monkeypatch.setattr(sys, "argv", [f"{script}.py", *overrides])
            _script(script).main()
        else:
            assert cli.main([command, "--device", "cpu", *overrides]) == 0


@pytest.mark.parametrize("extra", [[], ["no_lm=true"]])
def test_evaluate_writes_the_scripts_csv(extra, model_dir, fp32, monkeypatch,  # noqa: F811
                                         tmp_path):
    overrides = [f"model_id={model_dir}", "dataset=synthetic://8", "batch_size=4",
                 "max_seconds_per_example=5", f"cache_dir={tmp_path / 'cache'}", *extra]
    _both(monkeypatch, tmp_path, "evaluate_model", "evaluate", overrides)
    got = sorted((tmp_path / "port").glob("*.csv"))
    want = sorted((tmp_path / "jax").glob("*.csv"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 1
    assert got[0].name.endswith(("-no-lm.synthetic:----8.csv" if extra
                                 else "-tiny.synthetic:----8.csv"))
    assert got[0].read_bytes() == want[0].read_bytes()
    assert got[0].read_text().splitlines()[0] == "age_group,gender,dialect,cer,wer"


@pytest.mark.parametrize("max_cer", ["0.6", "1e9"])
def test_validate_writes_the_scripts_jsonl(max_cer, model_dir, fp32, monkeypatch,  # noqa: F811
                                          tmp_path):
    overrides = ["dataset=synthetic://8", f"model_id={model_dir}", "batch_size=4",
                 "max_seconds_per_example=5", f"max_cer={max_cer}", "output_path=out"]
    _both(monkeypatch, tmp_path, "validate_coral_asr", "validate", overrides)
    got = (tmp_path / "port" / "out" / "validated.jsonl").read_bytes()
    assert got == (tmp_path / "jax" / "out" / "validated.jsonl").read_bytes()
    rows = [json.loads(line) for line in got.decode().splitlines()]
    if max_cer == "1e9":
        assert len(rows) == 8 and rows[0]["asr_validation_model"] == str(model_dir)
        assert {"asr_prediction", "asr_cer", "asr_wer"} <= set(rows[0])


def test_train_ngram_writes_the_scripts_arpa(jax_decoding, monkeypatch, tmp_path):  # noqa: F811
    for package in ("jax", "port"):
        (tmp_path / package / "model").mkdir(parents=True)
    overrides = {p: _decoder_overrides(tmp_path / p, "synthetic://4") for p in ("jax", "port")}
    monkeypatch.setattr(sys, "argv", ["train_ngram_decoder.py", *overrides["jax"]])
    _script("train_ngram_decoder").main()
    assert cli.main(["train-ngram", "--device", "cpu", *overrides["port"]]) == 0
    got, want = (tmp_path / p / "model" / "3gram.arpa" for p in ("port", "jax"))
    assert got.read_bytes() == want.read_bytes() and b"\\3-grams:" in got.read_bytes()
    assert got.with_suffix(".bin").read_bytes() == want.with_suffix(".bin").read_bytes()


def _write_wav(path: Path, seconds: float, rate: int, channels: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal((int(seconds * rate), channels)) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def test_demo_prints_the_scripts_lines(model_dir, fp32, monkeypatch, tmp_path,  # noqa: F811
                                       capsys):
    """Window 5 s: a 3 s stereo WAV at 16 kHz in one window, a 12 s one at
    8 kHz resampled and cut into windows (stride a sixth of the window)."""
    paths = [tmp_path / "short.wav", tmp_path / "long.wav"]
    _write_wav(paths[0], 3.0, 16_000, 2, seed=1)
    _write_wav(paths[1], 12.0, 8_000, 1, seed=2)
    overrides = [f"model_id={model_dir}", "max_seconds_per_example=5"]
    monkeypatch.chdir(tmp_path)  # the JAX setup writes eval-models/ there
    lines = {}
    for package in ("jax", "port"):
        monkeypatch.setattr(sys, "stdin", io.StringIO(f"{paths[0]}\n\n{paths[1]}\n"))
        capsys.readouterr()
        if package == "jax":
            monkeypatch.setattr(sys, "argv", ["run_asr_demo.py", *overrides])
            _script("run_asr_demo").main()
        else:
            assert cli.main(["demo", "--device", "cpu", *overrides]) == 0
        lines[package] = capsys.readouterr().out.splitlines()
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 2
    config = cli.compose("demo", overrides=overrides, config_path=cli.CONFIG_DIR)
    transcribe = cli.make_transcriber(config, "cpu")
    assert [transcribe(cli.read_wav(str(p))) for p in paths] == lines["port"]
    # The long one's text joins three windows' texts.
    assert len(lines["port"][1]) > len(lines["port"][0])


def test_finetune_runs_two_steps(tmp_path):
    overrides = [*BASE, "max_steps=2", "eval_steps=2", "save_steps=2",
                 f"model_dir={tmp_path / 'model'}"]
    assert cli.main(["finetune", "--device", "cpu", *overrides]) == 0
    assert (tmp_path / "model" / "model" / "params.pt").exists()
    assert (tmp_path / "model" / "checkpoints" / "2").is_dir()


def test_commands_compose_their_configs_on_the_card_by_default(monkeypatch):
    seen = []
    for command, (name, _) in cli.COMMANDS.items():
        monkeypatch.setitem(cli.COMMANDS, command,
                            (name, lambda config, device: seen.append((config, device))))
    assert cli.main(["evaluate", "model_id=some/model", "dataset=synthetic://2"]) == 0
    assert cli.main(["validate", "--device=cpu", "max_cer=0.3"]) == 0
    assert cli.main(["train-ngram", "model=wav2vec2-small", "--device", "cuda:1"]) == 0
    (evaluation, d1), (validation, d2), (finetuning, d3) = seen
    assert (d1, d2, d3) == ("cuda", "cpu", "cuda:1")
    assert evaluation.model_id == "some/model" and evaluation.dataset == "synthetic://2"
    assert validation.max_cer == 0.3 and validation.output_path == "validated-dataset"
    assert finetuning.model.decoder_num_ngrams == 3 and "decoder_datasets" in finetuning
    with pytest.raises(SystemExit):
        cli.main(["transcribe"])


def test_the_module_runs_as_a_program():
    out = subprocess.run([sys.executable, "-m", "coral_tpu_torch", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert all(c in out.stdout for c in cli.COMMANDS) and "--device" in out.stdout
