"""coral_tpu_torch's n-gram LM pipeline, and finetune's LM, against coral_tpu's.

Both packages' ``train_and_store_ngram_model`` run one composed config
(``model=wav2vec2-small``, ``synthetic://`` decoder datasets, a stand-in for
a Hub decoder dataset, an excision split) into directories of their own.
Held exactly: the sentence corpus file (its md5 name and bytes), the
``3gram.arpa`` and ``3gram.bin`` bytes. The synthetic source holds 8
distinct sentences, so ``+decoder_excision_dataset=synthetic://8`` cuts every
one of them out and leaves an LM of ``<s>`` and ``<unk>`` alone, in both
packages; ``synthetic://4`` cuts half. The port's ``NGramModel`` against
JAX's: the streamed estimation's ARPA bytes (the same entries as the
in-memory path's, in another order), ``save_binary``'s bytes, ``logprob``
and ``sentence_logprob`` from the ARPA file and the binary. ``finetune``
with ``model.use_decoder=true`` writes JAX's ARPA beside its saved model;
an LM that fails leaves a warning and ``finetune`` returns.

No test reaches the network: a dataset that is not ``synthetic://`` is
served by a stand-in ``datasets.load_dataset`` that records its arguments.
"""

import logging
import shutil
from pathlib import Path

import pytest
import torch

import coral_tpu.decoding.ngram_pipeline as jax_pipeline
import coral_tpu_torch.decoding.ngram_pipeline as port_pipeline
import hf_checkpoints as hf
from coral_tpu.config import compose as jax_compose
from coral_tpu_torch import decoding
from coral_tpu_torch.config import compose
from coral_tpu_torch.decoding import NGramModel
from coral_tpu_torch.training import finetune as port_ft
from test_torch_finetune import BASE

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "config"
HUB_ID = "example/decoder-corpus"
# The stand-in Hub dataset's rows: numerals are not verbalised, fillers and
# characters outside the set go, upper case is lowered, a repeat is dropped.
HUB_TEXTS = [*hf.corpus_lines(seed=9, n=120), "Øhm det var 3 ÆBLER!", "hej med dig",
             "hej med dig", "", "min fortræffelige lille nattergal synger"]


@pytest.fixture(scope="module")
def jax_decoding(tmp_path_factory):
    """``coral_tpu.decoding`` loading a copy of the port's decoder library.

    The port's native sources are byte copies of ``coral_tpu/native``'s
    (``tests/test_torch_decoding.py`` holds it) built with the same g++
    flags, so the JAX binding runs the library its own build gives, without
    a second build and without writing under ``coral_tpu/``. A library the
    process already loaded for the JAX package is kept."""
    import coral_tpu.decoding as jd

    if jd._lib.cache_info().currsize:
        return jd
    native = tmp_path_factory.mktemp("jax-native")
    for src in (REPO / "coral_tpu" / "native").glob("*.cc"):
        shutil.copy(src, native)
    shutil.copy(decoding.build_native_library(), native / jd._LIB_NAME)  # newer: not rebuilt
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "_NATIVE_DIR", native)
        jd._lib()  # kept loaded for the process: it frees the LMs made here
    return jd


@pytest.fixture
def hub(monkeypatch):
    """``datasets.load_dataset`` for the stand-in decoder dataset; its calls."""
    import datasets as hfds

    calls = []

    def load_dataset(**kwargs):
        calls.append(kwargs)
        if kwargs["path"] != HUB_ID:
            raise ConnectionError(f"{kwargs['path']} is not reachable")
        return iter([{"doc": text} for text in HUB_TEXTS])

    monkeypatch.setattr(hfds, "load_dataset", load_dataset)
    return calls


def _decoder_overrides(root: Path, excision: str, datasets=("synthetic://64",)) -> list[str]:
    entries = [f"+decoder_datasets.s{i}={{id: {d}}}" for i, d in enumerate(datasets)]
    return ["model=wav2vec2-small", "decoder_datasets=[]", *entries,
            f"+decoder_excision_dataset={excision}", f"cache_dir={root / 'cache'}",
            f"model_dir={root / 'model'}"]


def _run(package: str, root: Path, overrides: list[str]) -> Path:
    (root / "model").mkdir(parents=True)
    if package == "jax":
        return jax_pipeline.train_and_store_ngram_model(
            jax_compose("asr_finetuning", overrides=overrides, config_path=CONFIG))
    return port_pipeline.train_and_store_ngram_model(
        compose("asr_finetuning", overrides=overrides, config_path=CONFIG))


def _hub_entry() -> str:
    return f"+decoder_datasets.hub={{id: {HUB_ID}, subset: da, text_column: doc}}"


@pytest.mark.parametrize("excision", ["synthetic://8", "synthetic://4", "null"])
def test_pipeline_matches_jax(excision, jax_decoding, hub, tmp_path):
    overrides = {p: _decoder_overrides(tmp_path / p, excision) + [_hub_entry()]
                 for p in ("jax", "port")}
    want = _run("jax", tmp_path / "jax", overrides["jax"])
    got = _run("port", tmp_path / "port", overrides["port"])
    assert got == tmp_path / "port" / "model" / "3gram.arpa" and want.name == got.name
    corpus = {p: list((tmp_path / p / "cache").glob("ngram-sentences-*.txt")) for p in overrides}
    assert [c.name for c in corpus["port"]] == [c.name for c in corpus["jax"]]
    assert corpus["port"][0].read_bytes() == corpus["jax"][0].read_bytes()
    assert got.read_bytes() == want.read_bytes()
    assert got.with_suffix(".bin").read_bytes() == want.with_suffix(".bin").read_bytes()
    assert NGramModel(got.with_suffix(".bin")).order == NGramModel(got).order == 3
    # Both packages asked the Hub stand-in the same, each for its own cache.
    for call, package in zip(hub, ("jax", "port")):
        assert call.pop("cache_dir") == str(tmp_path / package / "cache")
    assert hub[0] == hub[1] and hub[0]["name"] == "da" and hub[0]["streaming"] is True
    sentences = corpus["port"][0].read_text(encoding="utf-8").split("\n")
    assert "øhm" not in sentences and "det var 3 æbler" in sentences
    assert sentences.count("hej med dig") == 1
    synthetic = set(port_pipeline._iter_texts({"id": "synthetic://8"}, tmp_path))
    synthetic_left = [s for s in sentences if s in synthetic]
    assert len(synthetic_left) == {"synthetic://8": 0, "synthetic://4": 4, "null": 8}[excision]


def test_pipeline_of_synthetic_text_alone_matches_jax(jax_decoding, tmp_path):
    """The chip check's corpus: synthetic sentences only, every one excised;
    the LM of <s> and <unk> that leaves loads at order 3 in both packages."""
    overrides = {p: _decoder_overrides(tmp_path / p, "synthetic://16", ("synthetic://256",))
                 for p in ("jax", "port")}
    want = _run("jax", tmp_path / "jax", overrides["jax"])
    got = _run("port", tmp_path / "port", overrides["port"])
    assert got.read_bytes() == want.read_bytes()
    assert got.with_suffix(".bin").read_bytes() == want.with_suffix(".bin").read_bytes()
    assert "ngram 1=2\n" in got.read_text() and NGramModel(got.with_suffix(".bin")).order == 3


def test_an_existing_arpa_and_corpus_are_kept(hub, monkeypatch, tmp_path, caplog):
    overrides = _decoder_overrides(tmp_path, "synthetic://4") + [_hub_entry()]
    arpa = _run("port", tmp_path, overrides)
    stamp = arpa.stat().st_mtime_ns
    trained = []
    monkeypatch.setattr(NGramModel, "train", lambda *a, **k: trained.append(a))
    caplog.set_level(logging.INFO)
    config = compose("asr_finetuning", overrides=overrides, config_path=CONFIG)
    assert port_pipeline.train_and_store_ngram_model(config) == arpa
    assert not trained and arpa.stat().st_mtime_ns == stamp
    assert "already exists" in caplog.text
    corpus = port_pipeline.get_sentence_corpus_path(config)  # cached: the Hub is not asked
    assert len(hub) == 1 and "Loading existing sentence corpus" in caplog.text
    assert corpus.parent == tmp_path / "cache"


def test_a_corpus_over_512_mib_is_counted_on_disk(jax_decoding, hub, monkeypatch, tmp_path):
    """The switch to streamed estimation, moved down to 0 bytes: it trains
    with scratch space in the model directory, and the LM holds the entries
    JAX's in-memory estimation gives."""
    calls = []
    train = NGramModel.train.__func__

    def spy(cls, *args, **kwargs):
        calls.append(kwargs)
        return train(cls, *args, **kwargs)

    monkeypatch.setattr(NGramModel, "train", classmethod(spy))
    monkeypatch.setattr(port_pipeline, "STREAMED_CORPUS_BYTES", 0)
    want = _run("jax", tmp_path / "jax", _decoder_overrides(tmp_path / "jax", "null")
                + [_hub_entry()])
    got = _run("port", tmp_path / "port", _decoder_overrides(tmp_path / "port", "null")
               + [_hub_entry()])
    assert calls[0]["streamed"] is True and calls[0]["scratch_dir"] == tmp_path / "port" / "model"
    assert sorted(got.read_text().splitlines()) == sorted(want.read_text().splitlines())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "corpus.txt"
    path.write_text("\n".join(hf.corpus_lines(seed=1, n=400)), encoding="utf-8")
    return path


@pytest.mark.parametrize("budget", [50, 1_000, 20_000_000])
def test_streamed_training_matches_jax(budget, jax_decoding, corpus, tmp_path):
    for name in ("port", "jax", "memory"):
        (tmp_path / name).mkdir()
    NGramModel.train(corpus, tmp_path / "port.arpa", order=3, streamed=True,
                     budget_entries=budget, scratch_dir=tmp_path / "port")
    jax_decoding.NGramModel.train(corpus, tmp_path / "jax.arpa", order=3, streamed=True,
                                  budget_entries=budget, scratch_dir=tmp_path / "jax")
    NGramModel.train(corpus, tmp_path / "memory.arpa", order=3)
    got = (tmp_path / "port.arpa").read_bytes()
    assert got == (tmp_path / "jax.arpa").read_bytes()
    assert sorted(got.splitlines()) == sorted((tmp_path / "memory.arpa").read_bytes().splitlines())
    assert not any((tmp_path / "port").iterdir())  # the shards are removed


def test_binary_and_scores_match_jax(jax_decoding, corpus, tmp_path):
    port = NGramModel.train(corpus, tmp_path / "lm.arpa", order=3)
    jax_lm = jax_decoding.NGramModel(tmp_path / "lm.arpa")
    assert port.save_binary(tmp_path / "port.bin") == tmp_path / "port.bin"
    jax_lm.save_binary(tmp_path / "jax.bin")
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    words = hf.corpus_lines(seed=1, n=3)[0].split() + ["absent", "</s>"]
    contexts = ["", words[0], " ".join(words[:2]), "absent " + words[1]]
    sentences = [*hf.corpus_lines(seed=1, n=4), "", "absent words here"]
    for lm, ref in ((port, jax_lm), (NGramModel(tmp_path / "port.bin"),
                                     jax_decoding.NGramModel(tmp_path / "jax.bin"))):
        assert lm.order == ref.order == 3
        for w in words:
            for c in contexts:
                assert lm.logprob(w, c) == ref.logprob(w, c), (w, c)
        for s in sentences:
            assert lm.sentence_logprob(s) == ref.sentence_logprob(s), s
    assert port.logprob(words[1], words[0]) > port.logprob("absent", words[0])


def test_only_rank_0_trains(monkeypatch, tmp_path):
    monkeypatch.setenv("RANK", "1")
    config = compose("asr_finetuning", overrides=_decoder_overrides(tmp_path, "null"),
                     config_path=CONFIG)
    assert port_pipeline.train_and_store_ngram_model(config) is None
    assert not (tmp_path / "cache").exists()


def test_an_unloadable_test_split_warns_and_excises_nothing(jax_decoding, hub, tmp_path,
                                                            caplog):
    """An excision split that cannot be loaded (the stand-in refuses it, as
    the Hub does offline): a warning, and the corpus keeps every sentence."""
    for package in ("jax", "port"):
        _run(package, tmp_path / package, _decoder_overrides(
            tmp_path / package, "example/absent-test-split"))
    _run("port", tmp_path / "kept", _decoder_overrides(tmp_path / "kept", "null"))
    texts = {p: next((tmp_path / p / "cache").glob("*.txt")).read_bytes()
             for p in ("jax", "port", "kept")}
    assert texts["port"] == texts["jax"] == texts["kept"]
    warned = [r for r in caplog.records if "Could not load the test split" in r.getMessage()]
    assert len(warned) == 2


# -- finetune with model.use_decoder ----------------------------------------------------------


FINETUNE = ["model.use_decoder=true", "max_steps=1", "eval_steps=5", "save_steps=5"]


def test_finetune_trains_the_lm_beside_the_saved_model(jax_decoding, tmp_path):
    overrides = [*BASE, *FINETUNE, "decoder_datasets=[]",
                 "+decoder_datasets.s={id: synthetic://64}",
                 "+decoder_excision_dataset=synthetic://4"]
    config = compose("asr_finetuning", config_path=CONFIG, overrides=overrides + [
        f"cache_dir={tmp_path / 'port' / 'cache'}", f"model_dir={tmp_path / 'port' / 'model'}"])
    history = port_ft.finetune(config, device="cpu")
    assert "loss" in history
    saved = tmp_path / "port" / "model"
    assert (saved / "model" / "params.pt").exists()
    (tmp_path / "jax" / "model").mkdir(parents=True)
    want = jax_pipeline.train_and_store_ngram_model(jax_compose(
        "asr_finetuning", config_path=CONFIG, overrides=overrides + [
            f"cache_dir={tmp_path / 'jax' / 'cache'}", f"model_dir={tmp_path / 'jax' / 'model'}"]))
    assert (saved / "3gram.arpa").read_bytes() == want.read_bytes()
    assert (saved / "3gram.bin").read_bytes() == want.with_suffix(".bin").read_bytes()


def test_an_lm_failure_warns_and_finetune_returns(hub, tmp_path, caplog):
    """A decoder dataset that cannot be fetched fails the LM: finetune logs
    a warning, as JAX's loop does, and returns with the model saved."""
    overrides = [*BASE, *FINETUNE, "decoder_datasets=[]",
                 "+decoder_datasets.absent={id: example/unreachable}",
                 f"cache_dir={tmp_path / 'cache'}", f"model_dir={tmp_path / 'model'}"]
    history = port_ft.finetune(compose("asr_finetuning", overrides=overrides, config_path=CONFIG),
                               device="cpu")
    assert "loss" in history and (tmp_path / "model" / "model" / "params.pt").exists()
    assert not list((tmp_path / "model").glob("*gram.*"))
    warned = [r for r in caplog.records if r.levelno == logging.WARNING
              and "n-gram decoder training failed" in r.getMessage()]
    assert len(warned) == 1 and "unreachable" in warned[0].getMessage()
