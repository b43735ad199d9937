"""coral_tpu_torch's n-gram LM and CTC beam search against coral_tpu's.

The port builds its own copy of the native decoder into
``coral_tpu_torch/_build/``. The JAX package's decoder is built here from
``coral_tpu/native/``'s sources into a temporary directory (its module's
source directory pointed there), so these tests write nothing under
``coral_tpu/``. Held exactly: the ARPA files' bytes from the same corpus, the
beam search's strings on the same log-probs and LM (and the pure-Python
oracle's, ``tests/oracle_ctc_beam.py``) in ``tests/test_beam_parity.py``'s
cases, and the transcripts of ``make_beam_predictor`` on one tiny HF
checkpoint and one ARPA file, the JAX predictor on a one-device mesh.
"""

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import hf_checkpoints as hf
from coral_tpu_torch import decoding
from coral_tpu_torch.decoding import BeamSearchDecoder, NGramModel
from coral_tpu_torch.training import model_setup as port_setup
from oracle_ctc_beam import oracle_decode
from test_beam_parity import BLANK, SEP, VOCAB, WORDS, synth_logits, synth_logits_trailing_sep
from test_decoding import CORPUS, make_logits

# One intra-op thread: the suite runs in several processes at once, and
# OpenMP threads spinning on shared cores slow these small ops tens of times.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_decoding(tmp_path_factory):
    """``coral_tpu.decoding`` with its library built from a copy of its
    sources in a temporary directory and loaded."""
    import coral_tpu.decoding as jd

    native = tmp_path_factory.mktemp("jax-native")
    for src in (REPO / "coral_tpu" / "native").glob("*.cc"):
        shutil.copy(src, native)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "_NATIVE_DIR", native)
        jd._lib.cache_clear()
        jd._lib()  # kept loaded for the process: it frees the LMs made here
    return jd


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    paths = {"danish": root / "danish.txt", "beam": root / "beam.txt"}
    paths["danish"].write_text("\n".join(CORPUS), encoding="utf-8")
    rng = np.random.default_rng(7)  # tests/test_beam_parity.py's LM corpus
    with paths["beam"].open("w") as f:
        for _ in range(400):
            f.write(" ".join(rng.choice(WORDS, size=rng.integers(2, 6))) + "\n")
    return paths


def test_native_sources_are_copies_and_build_into_the_port():
    """The decoder's sources are byte copies of coral_tpu/native's, and their
    library is built into coral_tpu_torch/_build/ under a name that hashes
    the sources and flags."""
    for name in ("ctc_beam.cc", "ngram.cc"):
        assert ((REPO / "coral_tpu_torch" / "native" / name).read_bytes()
                == (REPO / "coral_tpu" / "native" / name).read_bytes())
    lib = decoding.build_native_library()
    assert lib.parent == REPO / "coral_tpu_torch" / "_build"
    assert lib.name.startswith("libcoral_decoder_") and len(lib.stem) == len(
        "libcoral_decoder_") + 16
    assert decoding.build_native_library() == lib  # built once


@pytest.mark.parametrize("corpus,order,prune", [
    ("danish", 3, None), ("danish", 4, None), ("beam", 3, [0, 0, 0]), ("beam", 3, [0, 1, 1]),
    ("beam", 2, [0, 0]),
])
def test_arpa_bytes_match_jax(jax_decoding, corpora, corpus, order, prune, tmp_path):
    NGramModel.train(corpora[corpus], tmp_path / "port.arpa", order=order, prune=prune)
    jax_decoding.NGramModel.train(corpora[corpus], tmp_path / "jax.arpa", order=order,
                                  prune=prune)
    port, jax_arpa = (tmp_path / "port.arpa").read_bytes(), (tmp_path / "jax.arpa").read_bytes()
    assert port == jax_arpa
    assert b"\\%d-grams:" % order in port


@pytest.fixture(scope="module")
def lms(jax_decoding, corpora, tmp_path_factory):
    """The beam-parity LM (order 3, no pruning), loaded by both packages."""
    root = tmp_path_factory.mktemp("beamlm")
    port = NGramModel.train(corpora["beam"], root / "lm.arpa", order=3, prune=[0, 0, 0])
    return port, jax_decoding.NGramModel(root / "lm.arpa")


BEAM_CASES = {  # tests/test_beam_parity.py's configurations: (LM, utterances, keywords)
    "lm_default": (True, 50, {}),
    "no_lm": (False, 20, {}),
    "narrow_beam": (True, 20, {"beam_width": 4, "seed": 4}),
    "trailing_separator": (True, 30, {"seed": 8}),
    # make_beam_predictor's other settings: alpha, beta, the beam width.
    "lm_weighted": (True, 20, {"alpha": 2.0, "beta": 0.0, "seed": 5}),
    "word_bonus": (True, 20, {"alpha": 0.2, "beta": 4.0, "seed": 6}),
    "beam_of_one": (True, 20, {"beam_width": 1, "seed": 7}),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_strings_match_jax_and_the_oracle(jax_decoding, lms, case):
    use_lm, n, kw = BEAM_CASES[case]
    kw = dict(kw)
    rng = np.random.default_rng(kw.pop("seed", 0))
    port_lm, jax_lm = lms if use_lm else (None, None)
    port = BeamSearchDecoder(VOCAB, blank_id=BLANK, word_sep_id=SEP, lm=port_lm, **kw)
    jax_dec = jax_decoding.BeamSearchDecoder(VOCAB, blank_id=BLANK, word_sep_id=SEP,
                                             lm=jax_lm, **kw)
    for i in range(n):
        logits = synth_logits_trailing_sep(rng) if case == "trailing_separator" else (
            synth_logits(rng))
        got = port.decode(logits)
        assert got == jax_dec.decode(logits), (case, i)
        # The oracle queries the LM through the JAX binding (the same ARPA file).
        assert got == oracle_decode(logits, VOCAB, BLANK, SEP, lm=jax_lm, **kw), (case, i)


def test_lm_rescores_and_batches_as_jax(jax_decoding, corpora, tmp_path):
    """tests/test_decoding.py's cases on the port: the LM picks the word it
    has seen where the acoustics near-tie, and a batch decodes each row to
    its length; the JAX decoder gives the same strings."""
    port_lm = NGramModel.train(corpora["danish"], tmp_path / "3gram.arpa", order=3)
    jax_lm = jax_decoding.NGramModel(tmp_path / "3gram.arpa")
    vocab = [c for c in "abdeghijklmnorstuvyæøå"] + ["|", "<pad>"]
    blank, sep = len(vocab) - 1, vocab.index("|")
    logp = make_logits("jeg gik en tur i skoven", vocab).copy()
    t = len("jeg gik en tur i skove") * 2
    logp[t, :] = np.log(1e-6)
    logp[t, vocab.index("n")], logp[t, vocab.index("s")] = np.log(0.49), np.log(0.51)
    for lm, cls, want in ((port_lm, BeamSearchDecoder, "jeg gik en tur i skoven"),
                          (jax_lm, jax_decoding.BeamSearchDecoder, "jeg gik en tur i skoven"),
                          (None, BeamSearchDecoder, "jeg gik en tur i skoves")):
        dec = cls(vocab, blank_id=blank, word_sep_id=sep, lm=lm, alpha=2.0, beta=0.0,
                  beam_width=50)
        assert dec.decode(logp) == want
    a, b = make_logits("hej du", vocab), make_logits("god dag", vocab)
    batch = np.full((2, max(len(a), len(b)), len(vocab)), np.log(1e-8), np.float32)
    batch[0, : len(a)], batch[1, : len(b)] = a, b
    lengths = np.array([len(a), len(b)])
    got = BeamSearchDecoder(vocab, blank_id=blank, word_sep_id=sep).decode_batch(batch, lengths)
    assert got == ["hej du", "god dag"] == jax_decoding.BeamSearchDecoder(
        vocab, blank_id=blank, word_sep_id=sep).decode_batch(batch, lengths)
    assert BeamSearchDecoder(vocab, blank_id=blank, word_sep_id=sep).decode(batch[0, :0]) == ""


def test_lm_loads_its_arpa_and_refuses_a_missing_file(corpora, tmp_path):
    for order in (2, 3, 4):
        NGramModel.train(corpora["danish"], tmp_path / f"{order}gram.arpa", order=order)
        lm = NGramModel(tmp_path / f"{order}gram.arpa")
        assert lm.order == order and lm.arpa_path == tmp_path / f"{order}gram.arpa"
    with pytest.raises(FileNotFoundError):
        NGramModel(tmp_path / "absent.arpa")


# -- serving with the LM --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_model_dir(tmp_path_factory):
    """A tiny wav2vec2 model served as CoRal ships one: ``model.safetensors``
    and ``3gram.arpa`` side by side."""
    directory = tmp_path_factory.mktemp("served") / "wav2vec2-tiny-lm"
    hf.w2v2_checkpoint(directory, seed=11)
    corpus = directory.parent / "corpus.txt"
    corpus.write_text("\n".join(hf.corpus_lines(seed=12)), encoding="utf-8")
    NGramModel.train(corpus, directory / "3gram.arpa", order=3)
    return directory


def _batch(seed=0, T=6000, lengths=(6000, 4100, 2500)):
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(lengths), T), np.float32)
    for i, n in enumerate(lengths):
        audio[i, :n] = rng.standard_normal(n) * 0.1
    return {"input_values": audio, "input_lengths": np.asarray(lengths, np.int32)}


def test_beam_predictor_matches_jax_make_beam_predictor(jax_decoding, lm_model_dir, tmp_path):
    """The port's make_beam_predictor and the JAX one, on the same checkpoint
    and ARPA file: the same transcripts, and the LM changes some of them from
    the greedy ones."""
    from coral_tpu.config import DictConfig
    from coral_tpu.parallel import create_mesh, replicated
    from coral_tpu.training.model_setup import load_model_setup

    config = {"model": {"type": "wav2vec2", "architecture": "tiny",
                        "pretrained_model_id": str(lm_model_dir),
                        "characters_to_keep": hf.CHARS, "sampling_rate": 16_000},
              "max_seconds_per_example": 5.0, "bf16_allowed": False,
              "model_dir": str(tmp_path / "jax-model")}
    jax_setup = load_model_setup(DictConfig(config))
    params = jax_setup.init_params(jax.random.PRNGKey(0))
    mesh = create_mesh((1, 1))
    param_sh = jax.tree.map(lambda _: replicated(mesh), params)
    jax_predict = jax_setup.make_beam_predictor(mesh, param_sh, lm_model_dir / "3gram.arpa")
    setup = port_setup.load_model_setup(config, device="cpu")
    model = setup.init_params(seed=0)
    predict = setup.make_beam_predictor(model, lm_model_dir / "3gram.arpa")
    batches = [_batch(seed) for seed in range(3)]
    texts = [predict(b) for b in batches]
    assert texts == [jax_predict(jax.device_put(params, param_sh), b) for b in batches]
    greedy = setup.make_predictor(model)
    assert any(t != greedy(b) for t, b in zip(texts, batches))
    assert all(all(t) for t in texts)


def test_asr_pipeline_engages_the_lm_unless_no_lm(lm_model_dir):
    """``ASRPipeline(dir)`` serves a directory holding ``3gram.arpa`` by beam
    search with it; ``no_lm=True`` by greedy decoding, on the same logits."""
    from coral_tpu_torch import ASRPipeline

    clips = [np.random.default_rng(s).standard_normal(n).astype(np.float32) * 0.1
             for s, n in ((1, 9000), (2, 30_000), (3, 5000))]
    asr = ASRPipeline(lm_model_dir, batch_size=2, device="cpu")
    greedy = ASRPipeline(lm_model_dir, batch_size=2, no_lm=True, device="cpu")
    beam, plain = asr.predictor, greedy.predictor
    assert isinstance(beam, port_setup.BeamCtcPredictor)
    assert type(plain) is port_setup.GreedyCtcPredictor
    assert beam.decoder.lm.arpa_path == lm_model_dir / "3gram.arpa"
    assert (beam.decoder.beam_width, beam.decoder.alpha, beam.decoder.beta,
            beam.decoder.TOKEN_MIN_LOGP, beam.decoder.BEAM_PRUNE_LOGP,
            beam.decoder.SCORE_BOUNDARY) == (100, 0.5, 1.5, -5.0, -10.0, True)
    texts = asr.transcribe_batch(clips)
    assert texts == asr.transcribe_batch(clips)  # the same strings twice
    assert greedy.transcribe_batch(clips) != texts

    # no_lm's transcripts are the greedy decode of the beam path's own logits.
    T = int(asr.window_seconds * asr.sampling_rate)
    batch = {"input_values": np.zeros((2, T), np.float32),
             "input_lengths": np.array([len(clips[0]), 1], np.int32)}
    batch["input_values"][0, : len(clips[0])] = clips[0]
    logits, frames = beam.logits(batch)
    ids = logits.argmax(-1).numpy()
    want = [beam.tokenizer.decode(ids[i, : frames[i]]) for i in range(2)]
    assert plain(batch) == want
    # The filler row (frame length below 1) decodes no frame.
    log_probs, frame_lengths = beam.log_probs(batch)
    assert frame_lengths[1] < 1 and beam.decode(log_probs, frame_lengths)[1] == ""


def test_whisper_ignores_an_lm_beside_it(tmp_path):
    from coral_tpu_torch import ASRPipeline

    directory = tmp_path / "whisper-tiny_test"
    hf.whisper_checkpoint(directory, seed=2)
    (directory / "3gram.arpa").write_text("\\data\\\n")
    asr = ASRPipeline(directory, batch_size=2, device="cpu")
    assert isinstance(asr.predictor, port_setup.WhisperPredictor)
    assert asr.predictor.model.config.vocab_size == hf.WHISPER_VOCAB
