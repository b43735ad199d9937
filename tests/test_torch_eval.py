"""coral_tpu_torch's evaluation layer against coral_tpu's: long-form merging,
text normalisation, WER/CER and the validation loop.

Every function here is a copy of a JAX-free module of the JAX package
(``evaluation/longform.py``, ``text/normalization.py``, ``text/numerals.py``,
``evaluation/metrics.py``, ``evaluation/eval_loop.py``), held against it on
the same inputs: randomised token sequences from a seed, a stub
``generate_ids`` that reads each window's absolute time from its samples
(so overlapping windows emit overlapping words, with seeded noise tokens,
specials and timestamp pairs), and a fixed set of Danish strings with
numerals and punctuation. Tolerance: none; ids, strings, segments and
rates exactly equal.
"""

import numpy as np
import pytest
import torch

from coral_tpu.evaluation import eval_loop as jax_eval_loop
from coral_tpu.evaluation import longform as jax_longform
from coral_tpu.evaluation import metrics as jax_metrics
from coral_tpu.text import normalization as jax_normalization
from coral_tpu.text import numerals as jax_numerals
from coral_tpu.text.whisper_tokenizer import WhisperTokenizer as JaxWhisperTokenizer
from coral_tpu_torch.evaluation import eval_loop, longform, metrics
from coral_tpu_torch.text import WhisperTokenizer, normalization, numerals

torch.set_num_threads(1)

CHARS = "abcdefghijklmnopqrstuvwxyzæøå0123456789éü"
DANISH = [
    "Hej, Verden! Jeg er 21 år gammel.",
    "Der kom 1.100 mennesker til mødet kl. 14,5 — øhm, ja.",
    "Prisen er 3.500.000 kr. (ca. 12 % mere end sidste år).",
    "Fx 100 g smør og 1000 g mel; hhv. 2 og 3 æg.",
    "  Årets   bedste aften:   Ærø og Ålborg,  Østerbro ",
    "Hun sagde: »Det er 7,25 grader og -3 om natten«.",
    "Ñandu, café, naïve — aa-bb og 999.999.999 eller 1.000.000.000.",
    "ehm mhm hmm okay 0 1 2 3 4 5 6 7 8 9 10 11 19 20 42 99",
]
PREDICTIONS = [
    "hej verden jeg er tyve år gammel",
    "der kom et tusind et hundrede mennesker til mødet",
    "prisen er tre millioner fem hundrede tusind kroner ca tolv procent mere",
    "",
    "årets bedste aften ærø og ålborg østerbro østerbro",
    "hun sagde det er syv komma to fem grader",
    "nandu cafe naive",
    "okay nul en to tre fire fem seks syv otte ni ti",
]
WORDS = ["hej", "verden", "og", "så", "videre", "æble", "øl", "år", "tak", "ja", "nej",
         "måske", "huset", "bilen", "hunden", "katten", "kommer", "går", "her", "der"]
SR = 16_000


@pytest.mark.parametrize("seed", range(6))
def test_merge_token_sequences_matches_jax(seed):
    """Windows cut from one random stream with overlaps of 0 to 12 tokens,
    each with a few substitutions, insertions and deletions, and windows
    shorter than the overlap."""
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 30, size=200).tolist()
    seqs, start = [], 0
    while start < len(stream):
        n = int(rng.integers(2, 40))
        seq = list(stream[max(0, start - int(rng.integers(0, 13))): start + n])
        for _ in range(int(rng.integers(0, 3))):
            i = int(rng.integers(0, len(seq) + 1))
            op = rng.integers(3)
            if op == 0 and seq:
                seq[min(i, len(seq) - 1)] = int(rng.integers(0, 30))
            elif op == 1:
                seq.insert(i, int(rng.integers(0, 30)))
            elif seq:
                del seq[min(i, len(seq) - 1)]
        seqs.append(seq)
        start += n
    want = jax_longform.merge_token_sequences(seqs)
    assert longform.merge_token_sequences(seqs) == want
    assert longform.merge_token_sequences([]) == jax_longform.merge_token_sequences([]) == []


def _stub_generate(tok, total_seconds, timestamps, as_tensor):
    """A ``generate_ids`` whose windows carry their absolute time in their
    samples (``clip``): each row emits the words whose times (one every 0.7
    s of a seeded list) fall in its window, as BPE ids, with seeded noise
    tokens, specials and, with ``timestamps``, a timestamp pair around each
    group of three words. Filler rows (length 1) emit nothing but EOS."""
    rng = np.random.default_rng(7)
    times = np.arange(0.0, total_seconds, 0.7)
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), size=len(times))]

    def generate(batch):
        rows = []
        for audio, n in zip(batch["input_values"], batch["input_lengths"]):
            ids = [tok.sot_token_id, tok.language_token_id, tok.task_token_id]
            if n > 1:
                start = float(audio[0]) / 1000.0
                inside = [i for i, t in enumerate(times) if start <= t < start + n / SR]
                noise = np.random.default_rng(int(start * 10))
                for g in range(0, len(inside), 3):
                    group = inside[g : g + 3]
                    if timestamps:
                        t0 = min(int((times[group[0]] - start) / 0.02), 1500)
                        ids.append(tok.timestamp_begin + t0)
                    for i in group:
                        ids += tok.bpe.encode(" " + words[i])
                        if noise.random() < 0.2:
                            ids.append(int(noise.integers(0, 256)))
                    if timestamps:
                        t1 = min(int((times[group[-1]] + 0.6 - start) / 0.02), 1500)
                        ids.append(tok.timestamp_begin + t1)
            ids.append(tok.eos_token_id)
            rows.append(ids)
        out = np.full((len(rows), max(map(len, rows))), tok.eos_token_id, np.int32)
        for j, ids in enumerate(rows):
            out[j, : len(ids)] = ids
        return torch.from_numpy(out) if as_tensor else out

    return generate


def _clip(seconds):
    """Samples that hold their own time in ms (read back by ``_stub_generate``)."""
    return (np.arange(int(seconds * SR)) / SR * 1000.0).astype(np.float32)


@pytest.mark.parametrize("seconds,stride,batch_size", [
    (75.0, 5.0, 8), (75.0, 5.0, 2), (95.0, 0.0, 8), (20.0, 5.0, 8)])
def test_transcribe_longform_matches_jax(seconds, stride, batch_size):
    jax_tok, tok = JaxWhisperTokenizer.byte_fallback(), WhisperTokenizer.byte_fallback()
    audio = _clip(seconds)
    want = jax_longform.transcribe_longform(audio, _stub_generate(jax_tok, seconds, False, False),
                                            jax_tok, stride_seconds=stride,
                                            batch_size=batch_size)
    got = longform.transcribe_longform(audio, _stub_generate(tok, seconds, False, True), tok,
                                       stride_seconds=stride, batch_size=batch_size)
    assert got == want and len(got.split()) > 10


@pytest.mark.parametrize("seconds,batch_size", [(75.0, 8), (75.0, 2), (20.0, 8)])
def test_transcribe_longform_timestamps_matches_jax(seconds, batch_size):
    jax_tok, tok = JaxWhisperTokenizer.byte_fallback(), WhisperTokenizer.byte_fallback()
    audio = _clip(seconds)
    want = jax_longform.transcribe_longform_timestamps(
        audio, _stub_generate(jax_tok, seconds, True, False), jax_tok, batch_size=batch_size)
    got = longform.transcribe_longform_timestamps(
        audio, _stub_generate(tok, seconds, True, True), tok, batch_size=batch_size)
    assert got == want and len(got) > 3
    starts = [s for s, _, _ in got]
    assert starts == sorted(starts) and 0.0 <= starts[0] and starts[-1] <= seconds


@pytest.mark.parametrize("keep", [None, CHARS])
@pytest.mark.parametrize("lower_case", [True, False])
@pytest.mark.parametrize("convert", [True, False])
def test_clean_transcription_matches_jax(keep, lower_case, convert):
    for text in DANISH:
        want = jax_normalization.clean_transcription(text, keep, lower_case=lower_case,
                                                     convert_numerals=convert)
        got = normalization.clean_transcription(text, keep, lower_case=lower_case,
                                                convert_numerals=convert)
        assert got == want, text
    assert normalization.DEFAULT_CONVERSION_DICT == jax_normalization.DEFAULT_CONVERSION_DICT


def test_numerals_match_jax():
    for n in list(range(0, 130)) + [999, 1000, 1001, 1100, 2021, 10_000, 123_456, 1_000_000,
                                    2_500_001, 999_999_999, 1_000_000_000]:
        for text in (str(n), f"{n:,}".replace(",", "."), f"{n},5"):
            assert numerals.convert_numeral_to_words(text) == \
                jax_numerals.convert_numeral_to_words(text), text
    for text in DANISH:
        assert numerals.convert_numerals_in_text(text) == \
            jax_numerals.convert_numerals_in_text(text)


@pytest.mark.parametrize("normalise", [True, False])
def test_cer_wer_match_jax(normalise):
    labels = [jax_normalization.clean_transcription(t, CHARS, convert_numerals=True)
              for t in DANISH]
    for metric in ("cer", "wer"):
        want = getattr(jax_metrics, metric)(PREDICTIONS, labels, normalise=normalise)
        got = getattr(metrics, metric)(PREDICTIONS, labels, normalise=normalise)
        assert got == want and 0.0 < got
    for pred, label in zip(PREDICTIONS, labels):
        assert metrics.levenshtein_counts(label.split(), pred.split()) == \
            tuple(jax_metrics.levenshtein_counts(label.split(), pred.split()))


@pytest.mark.parametrize("batch_size,max_samples,buckets", [
    (3, None, None), (4, 6, None), (3, None, [SR, 3 * SR])])
def test_run_validation_matches_jax(batch_size, max_samples, buckets):
    """8 samples of 0.5-2.5 s (a ragged last batch at 3), a stub predictor
    that returns a Danish string for each row, from its samples: the same
    rates, the same batches."""
    rng = np.random.default_rng(5)
    samples = [{"audio_array": rng.standard_normal(int(s * SR)).astype(np.float32),
                "text": text} for s, text in zip(np.linspace(0.5, 2.5, 8), DANISH)]
    seen = {"jax": [], "port": []}

    def predict(key, batch):
        seen[key].append({k: v.copy() for k, v in batch.items()})
        return [PREDICTIONS[int(n) % len(PREDICTIONS)].upper() + "  " if n > 1 else "x"
                for n in batch["input_lengths"]]

    want = jax_eval_loop.run_validation(lambda params, b: predict("jax", b), None,
                                        lambda: iter(samples), batch_size, 2.0, SR, buckets,
                                        max_samples)
    got = eval_loop.run_validation(lambda b: predict("port", b), lambda: iter(samples),
                                   batch_size, 2.0, SR, buckets, max_samples)
    assert got == want and 0.0 < got["wer"] <= 1.0 and 0.0 < got["cer"] <= 1.0
    assert len(seen["port"]) == len(seen["jax"])
    for a, b in zip(seen["port"], seen["jax"]):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
