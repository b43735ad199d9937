"""Dataset loading for fine-tuning and evaluation.

Mirrors the reference's source handling (reference: ``src/coral/data.py:93-339``):
local arrow datasets, HF Hub (streaming) datasets, probability-weighted interleaving
of multiple sources, filtering, seeded shuffling, and per-example processing — but
organised as restartable host iterators feeding the bucketed device pipeline, with
all DSP moved on-device. Additionally supports ``synthetic://N`` dataset ids so the
whole stack runs without network egress (tests, offline dev).

A copy of ``coral_tpu/data/loading.py``; ``is_main_process`` asks
``torch.distributed`` where the JAX package asks ``jax.process_index()``.
Local arrow and Hub sources import ``datasets`` when they are first read, so
a host without it raises there and nowhere else.

Split naming matches the reference: ``train`` plus ``val_{id}[_{subset}]``
(reference: ``src/coral/data.py:333-337``).
"""

from __future__ import annotations

import logging
import os
from functools import partial
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator

from .interleave import interleave_iterables
from .processing import filter_example, process_example
from .synthetic import make_synthetic_examples

logger = logging.getLogger(__package__)

SourceFactory = Callable[[], Iterable[dict]]


def is_main_process() -> bool:
    """Rank-0 detection (reference: src/coral/data.py:113).

    An explicit ``RANK`` env var wins (the reference's accelerate-style
    plumbing); otherwise the rank of an initialised ``torch.distributed``
    process group decides, and a single process is the main one.
    """
    rank = os.getenv("RANK")
    if rank is not None:
        return rank == "0"
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _parse_synthetic_id(dataset_id: str) -> tuple[int, bool, float, float]:
    """``synthetic://N[@MIN-MAX]`` or ``synthetic://spelled:N`` (per-character
    tone audio with a learnable alignment — see
    ``synthetic.synth_spelled_audio``). The optional ``@MIN-MAX`` suffix sets
    the clip-duration range in seconds (default 1.5–5.0) so throughput
    benchmarks can match the step bench's clip length."""
    tail = dataset_id.split("://")[1]
    min_s, max_s = 1.5, 5.0
    if "@" in tail:
        tail, dur = tail.split("@", 1)
        lo, _, hi = dur.partition("-")
        min_s = float(lo)
        max_s = float(hi) if hi else min_s
    if tail.startswith("spelled:"):
        return int(tail.split(":", 1)[1]), True, min_s, max_s
    return int(tail), False, min_s, max_s


def _rename_columns(example: dict, text_column: str, audio_column: str) -> dict:
    out = dict(example)
    if text_column != "text" and text_column in out:
        out["text"] = out.pop(text_column)
    if audio_column != "audio" and audio_column in out:
        out["audio"] = out.pop(audio_column)
    return out


def make_raw_source(
    dataset_id: str,
    subset: str | None,
    split: str,
    streaming: bool = True,
    cache_dir: str | None = None,
    seed: int = 0,
) -> SourceFactory:
    """Create a restartable raw-example source for one dataset.

    Supports ``synthetic://N`` ids, local arrow paths, and HF Hub ids.
    """
    if dataset_id.startswith("synthetic://"):
        n, spelled, min_s, max_s = _parse_synthetic_id(dataset_id)
        # Generate once, reshuffle per epoch: per-clip host DSP re-run every
        # epoch was costing ~40% of end-to-end train throughput at B=64 on
        # the synthetic benchmark source.
        cache: dict[tuple[int, int, bool, float, float], list] = {}

        def synthetic_factory(epoch: int = 0) -> Iterable[dict]:
            import numpy as np

            key = (n, seed, spelled, min_s, max_s)
            if key not in cache:
                cache[key] = make_synthetic_examples(
                    n=n, seed=seed, spelled=spelled,
                    min_seconds=min_s, max_seconds=max_s,
                )
            examples = cache[key]
            order = np.random.default_rng(seed + epoch).permutation(len(examples))
            return [examples[i] for i in order]

        return synthetic_factory

    if Path(dataset_id).exists():

        def local_factory(epoch: int = 0) -> Iterable[dict]:
            import datasets as hfds

            path = Path(dataset_id)
            split_path = path / split
            if (split_path / "dataset_info.json").exists() or (
                split_path / "state.json"
            ).exists():
                ds = hfds.Dataset.load_from_disk(str(split_path))
            elif (path / "dataset_info.json").exists() or (
                path / "state.json"
            ).exists():
                ds = hfds.Dataset.load_from_disk(str(path))
            else:
                ds = hfds.load_dataset(
                    str(path), name=subset, split=split, cache_dir=cache_dir
                )
            return iter(ds.shuffle(seed=seed + epoch))

        return local_factory

    def hub_factory(epoch: int = 0) -> Iterable[dict]:
        import datasets as hfds

        ds = hfds.load_dataset(
            path=dataset_id,
            name=subset,
            split=split,
            streaming=streaming,
            cache_dir=cache_dir,
            token=os.getenv("HUGGINGFACE_HUB_TOKEN", True),
        )
        if streaming:
            ds = ds.shuffle(seed=seed + epoch, buffer_size=1000)
        else:
            ds = ds.shuffle(seed=seed + epoch)
        return iter(ds)

    return hub_factory


def make_processed_source(
    dataset_config: Any,
    split: str,
    config: Any,
    tokenizer,
    lower_case: bool,
    characters_to_keep: str | None,
    convert_numerals: bool = False,
    seed: int = 0,
) -> SourceFactory:
    """Raw source -> renamed -> filtered -> processed example stream."""
    raw = make_raw_source(
        dataset_config.id,
        dataset_config.get("subset"),
        split,
        streaming=config.get("streaming", True),
        cache_dir=config.get("cache_dir"),
        seed=seed,
    )
    text_col = dataset_config.get("text_column", "text")
    audio_col = dataset_config.get("audio_column", "audio")
    should_filter = dataset_config.get("filter_dataset", True)

    proc = partial(
        process_example,
        characters_to_keep=characters_to_keep,
        text_column="text",
        audio_column="audio",
        lower_case=lower_case,
        convert_numerals=convert_numerals,
        tokenizer=tokenizer,
        target_sample_rate=config.model.sampling_rate,
    )

    def factory(epoch: int = 0) -> Iterator[dict]:
        for example in raw(epoch):
            example = _rename_columns(example, text_col, audio_col)
            if should_filter and not filter_example(
                example,
                audio_column="audio",
                text_column="text",
                min_seconds_per_example=config.min_seconds_per_example,
                max_seconds_per_example=config.max_seconds_per_example,
            ):
                continue
            yield proc(example)

    return factory


def load_data_for_finetuning(config: Any, tokenizer) -> dict[str, SourceFactory]:
    """Build the train stream (+ val streams) for fine-tuning.

    Returns:
        Mapping of split name -> restartable processed-example factory; split
        names match the reference (``train``, ``val_...``).
    """
    train_sources: list[SourceFactory] = []
    for name, dataset_config in config.datasets.items():
        if is_main_process():
            logger.info(f"Loading dataset {name!r}")
        train_sources.append(
            make_processed_source(
                dataset_config,
                dataset_config.get("train_name", "train"),
                config,
                tokenizer,
                lower_case=config.model.lower_case,
                characters_to_keep=config.model.characters_to_keep,
                convert_numerals=False,
                seed=config.seed,
            )
        )
    assert len(train_sources) > 0, "No datasets were loaded"

    probabilities = config.get("dataset_probabilities")
    if probabilities is not None:
        probabilities = list(probabilities)
        if abs(sum(probabilities) - 1.0) > 1e-6:
            raise ValueError(
                f"Dataset probabilities must sum to 1, but sum to {sum(probabilities)}"
            )
    elif len(train_sources) > 1 and is_main_process():
        logger.warning(
            "No dataset probabilities were specified for the training split; "
            "datasets will be sampled equally often, oversampling the smaller ones."
        )

    def train_factory(epoch: int = 0) -> Iterable[dict]:
        # Per-epoch reseeding re-draws both the per-source shuffles and the
        # interleaving order every pass, the role of the reference's per-epoch
        # dataloader shuffling.
        return interleave_iterables(
            [lambda src=src: src(epoch) for src in train_sources],
            probabilities=probabilities,
            seed=config.seed + epoch,
            stopping_strategy="all_exhausted",
        )

    splits: dict[str, SourceFactory] = {"train": train_factory}

    for ds_cfg in config.get("evaluation_datasets") or []:
        split_name = f"val_{ds_cfg['id'].split('/')[-1].lower().replace('-', '_')}"
        if ds_cfg.get("subset"):
            split_name += f"_{ds_cfg['subset'].lower().replace('-', '_')}"
        splits[split_name] = MemoizedSource(
            make_processed_source(
                ds_cfg,
                ds_cfg.get("val_name", "val"),
                config,
                tokenizer,
                lower_case=config.evaluation_lower_case,
                characters_to_keep=config.evaluation_characters_to_keep,
                convert_numerals=False,
                seed=config.seed,
            )
        )

    return splits


class MemoizedSource:
    """Materialise a processed split on first use; iterate from memory after.

    The reference materialises validation splits to an arrow disk cache so that
    repeated evals don't re-stream from the Hub (reference:
    ``src/coral/data.py:266-337``, ``utils.py:101``); the in-memory equivalent
    serves the periodic training-time validation passes.
    """

    def __init__(self, factory: SourceFactory) -> None:
        self._factory = factory
        self._cache: list[dict] | None = None

    def __call__(self, epoch: int = 0) -> Iterator[dict]:
        if self._cache is None:
            self._cache = list(self._factory())
        return iter(self._cache)


def interpret_dataset_name(dataset_name: str) -> tuple[str, str | None, str | None]:
    """Parse the ``id::subset@revision`` grammar (reference: utils.py:176-232)."""
    dataset_id = dataset_name
    dataset_subset = None
    dataset_revision = None
    if "@" in dataset_id:
        dataset_id, dataset_revision = dataset_id.split("@", 1)
    if "::" in dataset_id:
        dataset_id, dataset_subset = dataset_id.split("::", 1)
    return dataset_id, dataset_subset, dataset_revision


def load_dataset_for_evaluation(config: Any) -> SourceFactory:
    """Build the evaluation-split example stream (reference: data.py:342-417).

    Filtering bounds and text processing come from the evaluation config;
    numerals are converted to words and metadata columns are kept for the
    demographic score breakdown. Real Hub datasets are materialised to a disk
    cache under ``cache_dir/test-sets`` on first use, like the reference.
    """
    dataset_id, subset, revision = interpret_dataset_name(config.dataset)
    text_col = config.get("text_column", "text")
    audio_col = config.get("audio_column", "audio")

    proc = partial(
        process_example,
        characters_to_keep=config.characters_to_keep,
        text_column="text",
        audio_column="audio",
        lower_case=config.lower_case,
        convert_numerals=True,
        tokenizer=None,
        target_sample_rate=config.sampling_rate,
    )

    def postprocess(stream: Iterable[dict]) -> Iterator[dict]:
        for example in stream:
            example = _rename_columns(example, text_col, audio_col)
            if not filter_example(
                example,
                audio_column="audio",
                text_column="text",
                min_seconds_per_example=config.min_seconds_per_example,
                max_seconds_per_example=config.max_seconds_per_example,
            ):
                continue
            out = proc(example)
            out.pop("audio", None)  # resampled copy lives in "audio_array"
            yield out

    if dataset_id.startswith("synthetic://"):
        n, spelled, min_s, max_s = _parse_synthetic_id(dataset_id)

        def synthetic_factory() -> Iterator[dict]:
            return postprocess(
                make_synthetic_examples(n=n, seed=0, spelled=spelled,
                                        min_seconds=min_s, max_seconds=max_s)
            )

        return synthetic_factory

    cache_path = None
    if config.get("cache_dir"):
        cache_path = (
            Path(config.cache_dir) / "test-sets" / dataset_id.replace("/", "--")
        )

    def hub_factory() -> Iterator[dict]:
        import datasets as hfds

        if cache_path is not None and cache_path.exists():
            ds = hfds.Dataset.load_from_disk(str(cache_path))
            yield from iter(ds)
            return
        ds = hfds.load_dataset(
            path=dataset_id,
            name=subset,
            split=config.get("eval_split_name", "test"),
            revision=revision,
            streaming=True,
            token=os.getenv("HUGGINGFACE_HUB_TOKEN", True),
        )
        rows = list(postprocess(ds))
        if cache_path is not None:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            hfds.Dataset.from_list(rows).save_to_disk(str(cache_path))
        yield from rows

    return hub_factory
