"""The n-gram decoder's pipeline: sentence corpus -> LM -> stored beside the model.

Port of ``coral_tpu/decoding/ngram_pipeline.py`` (the reference's KenLM
pipeline, ``src/coral/ngram.py:26-384``): a cleaned, de-duplicated sentence
corpus from the decoder datasets, with every sentence of the CoRal test split
cut out of it, a pruned modified-Kneser-Ney LM estimated by the native trainer
(``native/ngram.cc``), and its ARPA file and compact binary written into the
model's directory, where the beam search finds it. Rank 0 alone trains, as in
the reference; ranks come from ``data.loading.is_main_process``.
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path
from typing import Any, Iterable

from ..data.loading import is_main_process
from ..text.normalization import clean_transcription
from . import NGramModel

logger = logging.getLogger(__package__)

# Corpora above this size are counted through sorted shards on disk.
STREAMED_CORPUS_BYTES = 512 * 1024 * 1024


def train_and_store_ngram_model(config: Any) -> Path | None:
    """Train the n-gram LM of a fine-tuned model into ``config.model_dir``
    as ``{N}gram.arpa`` and ``{N}gram.bin`` (N is
    ``model.decoder_num_ngrams``, default 3). Returns the ARPA path (an
    existing one is kept as it is), or None on any rank but 0."""
    if not is_main_process():
        return None

    num_ngrams = int(config.model.get("decoder_num_ngrams", 3))
    model_dir = Path(config.model_dir)
    arpa_path = model_dir / f"{num_ngrams}gram.arpa"
    if arpa_path.exists():
        logger.info(f"n-gram model already exists at {arpa_path}")
        return arpa_path

    corpus_path = get_sentence_corpus_path(config)
    logger.info("Training n-gram language model...")
    prune = [0] + [1] * (num_ngrams - 1)  # lmplz's --prune 0 1 1 ...
    streamed = corpus_path.stat().st_size > STREAMED_CORPUS_BYTES
    if streamed:
        logger.info("Corpus exceeds 512 MiB; using disk-streamed estimation.")
    lm = NGramModel.train(corpus_path, arpa_path, order=num_ngrams, prune=prune,
                          streamed=streamed, scratch_dir=model_dir)
    lm.save_binary(arpa_path.with_suffix(".bin"))
    logger.info(f"Trained n-gram language model stored at {arpa_path}")
    return arpa_path


def get_sentence_corpus_path(config: Any) -> Path:
    """Build the decoder's sentence corpus, one sentence a line, or reuse
    the one already in ``cache_dir`` (named by the md5 of the decoder
    datasets' names): each dataset's texts cleaned as the acoustic labels
    are, concatenated, de-duplicated, and every test-split sentence cut out
    of the sentences that hold it."""
    cache_dir = Path(config.get("cache_dir") or (Path.home() / ".cache"))
    cache_dir.mkdir(parents=True, exist_ok=True)
    dataset_hash = hashlib.md5(
        ",".join(sorted(config.decoder_datasets.keys())).encode("utf-8")).hexdigest()
    sentence_path = cache_dir / f"ngram-sentences-{dataset_hash}.txt"
    if sentence_path.exists():
        logger.info(f"Loading existing sentence corpus from {sentence_path}")
        return sentence_path

    sentences: list[str] = []
    for name, ds_cfg in config.decoder_datasets.items():
        logger.info(f"Loading decoder dataset {name!r}...")
        for text in _iter_texts(ds_cfg, cache_dir):
            cleaned = clean_transcription(
                text, characters_to_keep=config.model.characters_to_keep,
                lower_case=config.model.lower_case, convert_numerals=False)
            if cleaned:
                sentences.append(cleaned)
        logger.info(f"{name}: corpus now holds {len(sentences):,} sentences")

    # Kneser-Ney estimation wants each sentence once.
    before = len(sentences)
    sentences = list(dict.fromkeys(sentences))
    logger.info(f"Removed {before - len(sentences):,} duplicate sentences")

    eval_sentences = _load_test_split_sentences(config, cache_dir)
    if eval_sentences:
        changed = 0
        excised = []
        for sentence in sentences:
            hit = False
            for eval_sentence in eval_sentences:
                if eval_sentence and eval_sentence in sentence:
                    sentence = sentence.replace(eval_sentence, "")
                    hit = True
            changed += hit
            excised.append(sentence)
        sentences = excised
        logger.info(f"Removed evaluation sentences from {changed:,} examples")

    sentence_path.write_text("\n".join(sentences), encoding="utf-8")
    return sentence_path


def _iter_texts(ds_cfg: Any, cache_dir: Path) -> Iterable[str]:
    """The text column of one decoder dataset: ``synthetic://N``'s
    transcripts, or a Hugging Face dataset streamed."""
    dataset_id = ds_cfg["id"]
    text_col = ds_cfg.get("text_column", "text")
    if dataset_id.startswith("synthetic://"):
        from ..data.synthetic import make_synthetic_examples

        n = int(dataset_id.split("://")[1])
        for ex in make_synthetic_examples(n=n, seed=0):
            yield ex["text"]
        return

    import datasets as hfds

    ds = hfds.load_dataset(
        path=dataset_id,
        name=ds_cfg.get("subset"),
        split=ds_cfg.get("split", "train"),
        streaming=True,
        cache_dir=str(cache_dir),
        token=os.getenv("HUGGINGFACE_HUB_TOKEN", True),
    )
    for row in ds:
        yield row[text_col]


def _load_test_split_sentences(config: Any, cache_dir: Path) -> set[str]:
    """The test split's sentences (``decoder_excision_dataset``, CoRal's
    read-aloud test split by default), which the LM's corpus must not hold;
    an empty set, with a warning, where the split cannot be loaded."""
    excision_dataset = config.get("decoder_excision_dataset",
                                  "CoRal-project/coral-v3::read_aloud")
    if not excision_dataset:
        return set()
    from ..config import DictConfig
    from ..data.loading import load_dataset_for_evaluation

    eval_config = DictConfig({
        "dataset": excision_dataset,
        "cache_dir": str(cache_dir),
        "eval_split_name": "test",
        "text_column": "text",
        "audio_column": "audio",
        "sampling_rate": 16_000,
        "min_seconds_per_example": 0.0,
        "max_seconds_per_example": 1e6,
        "lower_case": config.model.lower_case,
        "characters_to_keep": config.model.characters_to_keep,
    })
    try:
        return {row["text"] for row in load_dataset_for_evaluation(eval_config)()}
    except Exception as error:  # no network, or the dataset is not there
        logger.warning(f"Could not load the test split for sentence excision: {error}")
        return set()
