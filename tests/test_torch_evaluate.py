"""coral_tpu_torch's evaluate() and dataset QA against coral_tpu's, on the CPU.

Both packages score the same tiny Hugging Face wav2vec2 checkpoint
(``tests/hf_checkpoints.py``, served through ``load_saved_predictor``'s
pretrained-id branch) on ``synthetic://8`` and on a local arrow set with
``age``/``gender``/``dialect``/``country_birth`` columns, saved where
``load_dataset_for_evaluation`` reads its disk cache
(``cache_dir/test-sets/<id>``); greedy, and by the beam search with an
``*gram.arpa`` beside the model, with the LM and with ``no_lm``. That branch
computes in bf16 in both packages, and bf16 products on the CPU round
differently in the two frameworks, flipping near-tied argmaxes of seeded
weights; so both setups are built in fp32 here (``fp32``), as every CPU
parity test of the port is. Held: the same prediction strings, the same
grid (rows, slice columns, order), CER/WER within 1e-12, and with
``bootstrap_samples`` the interval columns equal. The score functions are
held against JAX's on hand-made frames. ``add_validations`` is held against
JAX's with one stub predictor for both and with each package's own
predictor, at ``max_cer`` 0.6 and 1e9: the same rows, columns and values.

The one difference is a repair: JAX's ``AGE_GROUPS`` starts "25-50" at 26,
so age 25 lies in no bin and JAX's ``evaluate`` raises ``StopIteration``;
the port bins it in "25-50". The parity data hold no age 25 only because JAX
gives no result there; ``test_age_25_jax_raises_where_the_port_bins``
pins both behaviours.
"""

import shutil
from pathlib import Path

import jax  # noqa: F401  (the JAX package's setups need it initialised)
import numpy as np
import pandas as pd
import pytest
import torch

import coral_tpu.data.validation as jax_validation
import coral_tpu.evaluation.evaluate as jax_eval
import coral_tpu.training.model_setup as jax_model_setup
import coral_tpu_torch.evaluation.evaluate as port_eval
import hf_checkpoints as hf
from coral_tpu.config import DictConfig as JaxDictConfig
from coral_tpu.config import compose as jax_compose
from coral_tpu_torch.config import compose
from coral_tpu_torch.data import validation as port_validation
from coral_tpu_torch.data.synthetic import DANISH_SENTENCES, make_synthetic_examples
from coral_tpu_torch.decoding import NGramModel
from test_torch_ngram_pipeline import jax_decoding  # noqa: F401  (fixture)

torch.set_num_threads(1)

CONFIG = Path(__file__).resolve().parent.parent / "config"
SCORE_ATOL = 1e-12
CATEGORIES = ["age_group", "gender", "dialect"]
ARROW_ID = "local/demographic-set"
# Every age JAX bins, across each bin's edges (25 is the pinned case).
AGES = [0, 24, 26, 49, 50, 80, 33, 61]


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """A tiny wav2vec2 checkpoint, and a copy of it with a ``3gram.arpa``."""
    root = tmp_path_factory.mktemp("models")
    plain = root / "wav2vec2-tiny"
    hf.w2v2_checkpoint(plain, seed=3)
    lm = root / "lm" / "wav2vec2-tiny"
    shutil.copytree(plain, lm)
    corpus = root / "corpus.txt"
    corpus.write_text("\n".join(hf.corpus_lines(seed=4) + DANISH_SENTENCES), encoding="utf-8")
    NGramModel.train(corpus, lm / "3gram.arpa", order=3)
    return {"plain": plain, "lm": lm}


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """An evaluation cache holding ARROW_ID: processed rows as
    ``load_dataset_for_evaluation`` stores them, with demographic columns."""
    import datasets as hfds

    cache = tmp_path_factory.mktemp("cache")
    rng = np.random.default_rng(5)
    dialects = ["sønderjysk", "nørrejysk", "fynsk", "københavnsk"]
    rows = [{"text": DANISH_SENTENCES[i % len(DANISH_SENTENCES)],
             "audio_array": (rng.standard_normal(int(rng.integers(24_000, 72_000))) * 0.1
                             ).astype(np.float32),
             "age": age, "gender": ["female", "male"][i % 2], "dialect": dialects[i % 4],
             "country_birth": [None, "DK", "SE", "DK"][i % 4]}
            for i, age in enumerate(AGES)]
    hfds.Dataset.from_list(rows).save_to_disk(
        str(cache / "test-sets" / ARROW_ID.replace("/", "--")))
    return cache


@pytest.fixture
def fp32(monkeypatch):
    """Both packages' setups built with ``bf16_allowed`` false."""

    def forcing(load):
        def build(config, *args, **kwargs):
            config["bf16_allowed"] = False
            return load(config, *args, **kwargs)
        return build

    monkeypatch.setattr(jax_model_setup, "load_model_setup",
                        forcing(jax_model_setup.load_model_setup))
    monkeypatch.setattr(port_eval, "load_model_setup", forcing(port_eval.load_model_setup))


@pytest.fixture
def predictions(monkeypatch):
    """Each package's raw prediction strings, by package."""
    seen = {"jax": [], "port": []}
    for key, module in (("jax", jax_eval), ("port", port_eval)):
        def recording(*args, _load=module.load_saved_predictor, _seen=seen[key], **kwargs):
            predict, geometry = _load(*args, **kwargs)

            def recorded(batch):
                out = predict(batch)
                _seen.extend(out)
                return out
            return recorded, geometry

        monkeypatch.setattr(module, "load_saved_predictor", recording)
    return seen


def _overrides(model_dir, cache, dataset, extra=()):
    return [f"model_id={model_dir}", f"dataset={dataset}", "batch_size=4",
            "max_seconds_per_example=5", f"cache_dir={cache}", *extra]


def _both(overrides):
    want = jax_eval.evaluate(jax_compose("evaluation", overrides=overrides, config_path=CONFIG))
    got = port_eval.evaluate(compose("evaluation", overrides=overrides, config_path=CONFIG),
                             device="cpu")
    return got, want


def assert_grids_equal(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got[CATEGORIES], want[CATEGORIES])
    for name in ("cer", "wer"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=SCORE_ATOL)
    for name in got.columns:
        if "_ci_" in name:
            pd.testing.assert_series_equal(got[name], want[name], check_exact=True)


@pytest.mark.parametrize("dataset", ["synthetic://8", ARROW_ID])
def test_evaluate_matches_jax(dataset, model_dirs, cache_dir, fp32, predictions):
    got, want = _both(_overrides(model_dirs["plain"], cache_dir, dataset))
    assert predictions["port"] == predictions["jax"] and len(predictions["port"]) == 8
    assert_grids_equal(got, want)
    overall = got[got[CATEGORIES].isna().all(axis=1)]
    assert len(overall) == 1 and 0 < overall.cer.iloc[0] <= 1
    if dataset == ARROW_ID:  # every bin, the dialect map and the non-native override
        assert set(got.age_group.dropna()) == {"0-25", "25-50", "50+"}
        assert {"Sønderjysk", "Nordjysk", "Non-native"} <= set(got.dialect.dropna())


def test_bootstrap_intervals_match_jax(model_dirs, cache_dir, fp32, predictions):
    got, want = _both(_overrides(model_dirs["plain"], cache_dir, ARROW_ID,
                                 ["bootstrap_samples=50"]))
    assert_grids_equal(got, want)
    overall = got[got[CATEGORIES].isna().all(axis=1)].iloc[0]
    assert overall.cer_ci_low <= overall.cer <= overall.cer_ci_high
    assert got.cer_ci_low.notna().sum() == 1  # the overall row alone


@pytest.mark.parametrize("no_lm", [False, True])
def test_evaluate_with_an_lm_beside_the_model(no_lm, jax_decoding, model_dirs,  # noqa: F811
                                              cache_dir, fp32, predictions):
    got, want = _both(_overrides(model_dirs["lm"], cache_dir, "synthetic://8",
                                 [f"no_lm={str(no_lm).lower()}"]))
    assert predictions["port"] == predictions["jax"]
    assert_grids_equal(got, want)
    port_eval.evaluate(compose("evaluation", config_path=CONFIG, overrides=_overrides(
        model_dirs["plain"], cache_dir, "synthetic://8")), device="cpu")  # greedy
    assert (predictions["port"][8:] == predictions["port"][:8]) == no_lm


def _rows():
    """Hand-made evaluated rows: sub-dialects, a missing and a foreign
    country of birth, a category with one value (vacuous), all ages bins."""
    texts = ["en to tre", "hej med dig", "god dag", "det regner", "solen skinner",
             "vi ses i morgen"]
    preds = ["en to tre", "hej med di", "godag", "det regner ikke", "", "vi ses"]
    rows = []
    for i, age in enumerate([0, 24, 26, 49, 50, 80]):
        rows.append({"text": texts[i], "age": age, "gender": ["female", "male"][i % 2],
                     "dialect": ["sønderjysk", "fynsk", "thybomål"][i % 3],
                     "country_birth": [None, "DK", "NO"][i % 3], "accent": "x"})
    return rows, preds


@pytest.mark.parametrize("drop", [(), ("age",), ("gender",), ("dialect", "country_birth"),
                                  ("country_birth",)])
@pytest.mark.parametrize("categories", [CATEGORIES, ["age_group", "accent"], ["gender"]])
def test_score_functions_match_jax(drop, categories):
    rows, preds = _rows()
    rows = [{k: v for k, v in r.items() if k not in drop} for r in rows]
    mapping = {"sønderjysk": "Sønderjysk", "thybomål": "Vestjysk"}
    got = port_eval.convert_evaluation_rows_to_df(rows, mapping)
    want = jax_eval.convert_evaluation_rows_to_df(rows, mapping)
    pd.testing.assert_frame_equal(got, want)
    got["prediction"] = want["prediction"] = preds
    got_grid = port_eval.get_score_df(got, categories)
    want_grid = jax_eval.get_score_df(want, categories)
    pd.testing.assert_frame_equal(got_grid, want_grid)
    for spec in ({c: None for c in categories}, {"gender": "male"}, {"accent": "x"},
                 {"gender": "female", "age_group": "50+"}):
        spec = {k: v for k, v in spec.items() if k in got.columns}
        g, g_inf = port_eval._narrow_to_slice(got, spec)
        w, w_inf = jax_eval._narrow_to_slice(want, spec)
        assert g_inf == w_inf
        pd.testing.assert_frame_equal(g, w)


def test_bootstrap_interval_matches_jax():
    from coral_tpu.evaluation.metrics import cer as jax_cer
    from coral_tpu_torch.evaluation.metrics import cer

    rows, preds = _rows()
    labels = [r["text"] for r in rows]
    got = port_eval.bootstrap_interval(preds, labels, cer, n_bootstrap=40)
    assert got == jax_eval.bootstrap_interval(preds, labels, jax_cer, n_bootstrap=40)
    assert got[0] <= cer(predictions=preds, labels=labels) <= got[1]


def test_ages_are_binned_as_jax_bins_them():
    ages = [0, 24, 26, 49, 50, 80, 24.5, 26.5]
    got = port_eval.convert_evaluation_rows_to_df([{"age": a} for a in ages], {})
    want = jax_eval.convert_evaluation_rows_to_df([{"age": a} for a in ages], {})
    assert got.age_group.tolist() == want.age_group.tolist() == [
        "0-25", "0-25", "25-50", "25-50", "50+", "50+", "0-25", "25-50"]


def test_age_25_jax_raises_where_the_port_bins():
    """JAX's bins ("25-50" from 26) hold no age 25: its conversion, and so its
    ``evaluate``, raise on any set with a 25-year-old. The port puts 25 in
    "25-50", its label's lower bound (ROADMAP Queue 3, pinned)."""
    rows = [{"age": 25, "text": "a"}, {"age": 30, "text": "b"}]
    with pytest.raises(StopIteration):
        jax_eval.convert_evaluation_rows_to_df(rows, {})
    got = port_eval.convert_evaluation_rows_to_df(rows, {})
    assert got.age_group.tolist() == ["25-50", "25-50"]
    with pytest.raises(ValueError, match="no range"):
        port_eval.age_group(-1)


# -- add_validations --------------------------------------------------------------------------


def _raw_examples():
    """Raw rows: synthetic ones, one at 8 kHz (resampled), one shorter than
    0.25 s and one with an empty text (both filtered out)."""
    rows = make_synthetic_examples(n=6, seed=2)
    rng = np.random.default_rng(6)
    rows.append({"audio": {"array": (rng.standard_normal(20_000) * 0.1).astype(np.float32),
                           "sampling_rate": 8_000}, "text": "Der var 3 små fugle!"})
    rows.append({"audio": {"array": np.zeros(3_000, np.float32), "sampling_rate": 16_000},
                 "text": "for kort"})
    rows.append({"audio": {"array": np.zeros(16_000, np.float32), "sampling_rate": 16_000},
                 "text": "  "})
    return rows


def _stub():
    """A predictor that returns the label of a row of even length, upper-cased
    and padded, and another sentence for the rest (CER 0 or high)."""
    from coral_tpu_torch.data.processing import process_example

    labels = {}
    for ex in _raw_examples():
        out = process_example(ex, characters_to_keep=hf.CHARS, text_column="text",
                              audio_column="audio", lower_case=True, convert_numerals=False)
        labels[len(out["audio_array"])] = out["text"]

    def predict(batch):
        return [f" {labels[int(n)].upper()} " if int(n) % 2 == 0 else DANISH_SENTENCES[0]
                for n in batch["input_lengths"]]
    return predict


def assert_rows_equal(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if key == "audio":
                np.testing.assert_array_equal(g[key]["array"], w[key]["array"])
                assert g[key]["sampling_rate"] == w[key]["sampling_rate"]
            elif isinstance(w[key], np.ndarray):
                np.testing.assert_array_equal(g[key], w[key])
            else:
                assert g[key] == w[key], key


def _validate(module, predictor, max_cer):
    return list(module.add_validations(
        _raw_examples(), predictor=predictor, model_id="tiny", characters_to_keep=hf.CHARS,
        batch_size=4, max_cer=max_cer, max_pad_seconds=5.0))


@pytest.mark.parametrize("max_cer", [0.6, 1e9])
def test_add_validations_with_one_stub_matches_jax(max_cer, caplog):
    caplog.set_level("INFO")
    stub = _stub()
    got = _validate(port_validation, stub, max_cer)
    want = _validate(jax_validation, stub, max_cer)
    assert_rows_equal(got, want)
    assert {"asr_prediction", "asr_label", "asr_validation_model", "asr_cer",
            "asr_wer"} <= set(got[0])
    kept = [r.getMessage() for r in caplog.records if r.getMessage().startswith("Validation")]
    assert kept[0] == kept[1]
    if max_cer == 1e9:
        assert len(got) == 7  # the short row and the empty text filtered out
    else:
        assert 0 < len(got) < 7 and all(r["asr_cer"] < 0.6 for r in got)


@pytest.mark.parametrize("max_cer", [0.6, 1e9])
def test_add_validations_with_each_predictor_matches_jax(max_cer, model_dirs, fp32, tmp_path):
    config = {"model_id": str(model_dirs["plain"]), "sampling_rate": 16_000,
              "characters_to_keep": hf.CHARS, "lower_case": True, "max_seconds_per_example": 5,
              "batch_size": 4, "cache_dir": str(tmp_path), "no_lm": False}
    predict, _ = port_eval.load_saved_predictor(config, device="cpu")
    jax_predict, _ = jax_eval.load_saved_predictor(JaxDictConfig(config))
    got = _validate(port_validation, predict, max_cer)
    want = _validate(jax_validation, jax_predict, max_cer)
    assert_rows_equal(got, want)
    if max_cer == 1e9:
        assert len(got) == 7
