"""A model directory saved by coral_tpu, converted and served by coral_tpu_torch.

The JAX package's ``save_model`` writes a directory (``config.yaml``, orbax
``model/``, the tokenizer's files) for a tiny wav2vec2 (with an n-gram LM
beside it) and for Whisper ``tiny_test``, from numpy-seeded weights drawn
into the JAX tree. ``tools/convert_coral_tpu_model.py`` turns each into a
directory with ``model/params.pt``; the port's ``load_saved_predictor``
then gives the JAX ``load_saved_predictor``'s strings on the same batch
(both in fp32: the composed configs set ``bf16_allowed=false``), and with
the copied LM the port decodes by its beam search. The
converter writes nothing under SRC, refuses a DST that holds
``model/params.pt`` already, and an unconverted directory raises in the port,
naming the converter's command.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from coral_tpu.config import compose as jax_compose
from coral_tpu.evaluation.evaluate import load_saved_predictor as jax_load_saved_predictor
from coral_tpu.training.finetune import save_model as jax_save_model
from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
from coral_tpu_torch.evaluation.evaluate import load_saved_predictor
from coral_tpu_torch.training.model_setup import BeamCtcPredictor
from test_torch_wav2vec2 import _seeded_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "convert_coral_tpu_model", ROOT / "tools" / "convert_coral_tpu_model.py")
converter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(converter)

OVERRIDES = {
    "wav2vec2": ["model=test-wav2vec2", "+model.architecture=tiny", "bf16_allowed=false",
                 "model_id=tiny"],
    "whisper": ["model=test-whisper", "+model.architecture=tiny_test", "model.max_length=12",
                "bf16_allowed=false", "model_id=tiny"],
}
ARPA = """\\data\\
ngram 1=4

\\1-grams:
-0.60206 </s>
-99 <s> -0.30103
-0.60206 hej -0.30103
-0.60206 med -0.30103

\\end\\
"""


def _batch(seconds, n=3, seed=0):
    rng = np.random.default_rng(seed)
    T = int(seconds * 16_000)
    audio = np.zeros((n, T), np.float32)
    lengths = rng.integers(T // 2, T + 1, n).astype(np.int32)
    for i, length in enumerate(lengths):
        audio[i, :length] = rng.standard_normal(length).astype(np.float32) * 0.1
    return {"input_values": audio, "input_lengths": lengths}


def _jax_saved(family, model_dir):
    """The JAX package's ``save_model`` of seeded weights, as its loop ends."""
    config = jax_compose("asr_finetuning",
                         overrides=OVERRIDES[family] + [f"model_dir={model_dir}"])
    setup = jax_load_model_setup(config)
    if family == "wav2vec2":
        params = _seeded_params(setup.model, seed=0)
    else:
        import jax

        params = setup.init_params(jax.random.PRNGKey(3))
    jax_save_model(config, setup, SimpleNamespace(params=params))
    return config


@pytest.fixture(scope="module", params=["wav2vec2", "whisper"])
def saved(request, tmp_path_factory):
    family = request.param
    src = tmp_path_factory.mktemp(family) / "jax-model"
    config = _jax_saved(family, src)
    if family == "wav2vec2":  # a trained n-gram LM beside the model
        (src / "3gram.arpa").write_text(ARPA, encoding="utf-8")
    before = sorted((p.relative_to(src), p.stat().st_mtime_ns) for p in src.rglob("*"))
    dst = src.parent / "port-model"
    converter.convert(src, dst)
    after = sorted((p.relative_to(src), p.stat().st_mtime_ns) for p in src.rglob("*"))
    return family, config, src, dst, before, after


def test_converted_directory_serves_the_jax_strings(saved):
    family, config, src, dst, *_ = saved
    batch = _batch(config.model.get("chunk_seconds", 30) if family == "whisper" else 2.0)
    common = {"sampling_rate": 16_000, "batch_size": 3}
    from coral_tpu.config import DictConfig

    want_predict, want_geometry = jax_load_saved_predictor(
        DictConfig({"model_id": str(src), "no_lm": True, **common}))
    got_predict, got_geometry = load_saved_predictor({"model_id": str(dst), "no_lm": True,
                                                      **common}, device="cpu")
    want = want_predict(batch)
    assert got_predict(batch) == want and len(want) == 3
    assert got_geometry == want_geometry
    if family == "wav2vec2":  # the copied LM: the port decodes by its beam search
        got_lm, _ = load_saved_predictor({"model_id": str(dst), **common}, device="cpu")
        assert isinstance(got_lm, BeamCtcPredictor) and len(got_lm(batch)) == 3


def test_converter_copies_the_serving_files_and_writes_nothing_under_src(saved):
    family, _, src, dst, before, after = saved
    assert before == after
    names = {p.name for p in dst.iterdir()}
    assert {"config.yaml", "vocab.json", "model"} <= names
    if family == "wav2vec2":
        assert "3gram.arpa" in names
    else:
        assert {"merges.txt", "tokenizer_config.json"} <= names
    params = torch.load(dst / "model" / "params.pt", weights_only=True)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in params.values())


def test_converter_refuses_src_and_an_existing_params_file(saved, tmp_path):
    _, _, src, dst, *_ = saved
    with pytest.raises(ValueError, match="nothing is written under SRC"):
        converter.convert(src, src)
    with pytest.raises(ValueError, match="nothing is written under SRC"):
        converter.convert(src, src / "inside")
    with pytest.raises(FileExistsError, match="params.pt"):
        converter.convert(src, dst)
    with pytest.raises(ValueError, match="not a saved coral_tpu model"):
        converter.convert(tmp_path, tmp_path / "out")


def test_converter_command_line(saved, tmp_path, capsys):
    _, _, src, _, *_ = saved
    assert converter.main([str(src), str(tmp_path / "cli")]) == 0
    assert (tmp_path / "cli" / "model" / "params.pt").is_file()
    assert "params.pt" in capsys.readouterr().out


def test_an_unconverted_directory_raises_naming_the_converter(saved):
    _, _, src, *_ = saved
    with pytest.raises(ValueError, match="tools/convert_coral_tpu_model.py"):
        load_saved_predictor({"model_id": str(src), "sampling_rate": 16_000}, device="cpu")


def test_the_port_imports_no_converter():
    """The converter imports both packages; no module of the port imports it
    (the port's own imports are held by tests/test_torch_pipeline.py)."""
    for path in (ROOT / "coral_tpu_torch").rglob("*.py"):
        text = path.read_text("utf-8")
        assert "convert_coral_tpu_model" not in text.replace(
            "tools/convert_coral_tpu_model.py", ""), path
