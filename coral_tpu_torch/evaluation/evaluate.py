"""Scoring a model over an evaluation set, and building its transcriber.

Port of ``coral_tpu/evaluation/evaluate.py`` (the reference's
``src/coral/evaluate.py:29-216``): ``evaluate`` transcribes the evaluation
split with the model's predictor, re-normalises every prediction through the
text pipeline and scores WER/CER over every combination of age group, gender
and dialect with their marginals (``get_score_df``), with bootstrap
confidence intervals on the overall row where asked.

One reference fault is not inherited: the JAX ``AGE_GROUPS`` bins "25-50"
from 26, so age 25 lies in no bin and the JAX ``evaluate`` raises
``StopIteration`` on any set that holds it. Here "25-50" starts at 25, its
label's lower bound; every age the JAX bins take gets their bin.

``load_saved_predictor`` ports :125-230. The saved-directory branch serves the
port's own saved model (``training/finetune.py`` ``save_model``): a directory
with ``config.yaml`` and ``model/params.pt`` builds the setup from the saved
config, with the eval-time overrides ``generation_num_beams``,
``generation_length_penalty``, ``return_timestamps`` and
``generation_max_length`` (-> ``model.max_length``) applied as JAX applies
them, and loads the fp32 masters into it. A directory that the JAX package
saved (``config.yaml`` beside an orbax ``model/`` tree) serves once
``tools/convert_coral_tpu_model.py`` has written its ``model/params.pt``
into a new directory; unconverted, it raises ``ValueError`` naming that
command. The pretrained-id branch builds the family the id names
(wav2vec2, or Whisper when the id contains "whisper") with the checkpoint on
disk where there is one (a directory holding
``model.safetensors`` or ``pytorch_model.bin``, whole or sharded, or the
Hugging Face cache) and seeded random weights otherwise. Either way a
wav2vec2 model whose directory also holds ``*gram.arpa`` serves by CTC beam
search with that n-gram LM unless ``no_lm``; Whisper ignores an LM.
"""

from __future__ import annotations

import itertools as it
import logging
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..data.loading import load_dataset_for_evaluation
from ..data.processing import process_example
from ..training.finetune import SAVED_PARAMS, load_saved_params
from ..training.model_setup import Wav2Vec2Setup, load_model_setup
from .eval_loop import batch_for_eval
from .metrics import cer, wer

# Eval-time generation overrides -> the saved model config's keys (the
# reference's evaluation surface re-decides the decoding strategy per run).
EVAL_OVERRIDES = (
    ("generation_num_beams", "generation_num_beams"),
    ("generation_length_penalty", "generation_length_penalty"),
    ("return_timestamps", "return_timestamps"),
    ("generation_max_length", "max_length"),
)

logger = logging.getLogger(__package__)

# [start, end) in years; None leaves a side open.
AGE_GROUPS = {"0-25": (0, 25), "25-50": (25, 50), "50+": (50, None)}


def evaluate(config: Any, device: str | torch.device = "cuda") -> "pandas.DataFrame":  # noqa: F821
    """Score ``config.model_id`` on ``config.dataset`` (the composed
    ``evaluation`` config), on ``device``.

    Returns:
        The score grid of ``get_score_df``: WER/CER a demographic slice.
    """
    if config.get("model_id") is None:
        raise ValueError("`model_id` must be set to perform an evaluation!")

    logger.info("Loading the dataset...")
    source = load_dataset_for_evaluation(config)

    logger.info(f"Loading the {config.model_id!r} ASR model...")
    predictor, batch_geometry = load_saved_predictor(config, device=device)

    rows: list[dict] = []
    predictions: list[str] = []

    def tee(stream):
        for example in stream:
            rows.append({k: v for k, v in example.items() if k != "audio_array"})
            yield example

    for batch, texts in batch_for_eval(tee(source()), batch_size=int(config.batch_size),
                                       **batch_geometry):
        for raw_prediction in predictor(batch)[: len(texts)]:
            # The prediction through the text pipeline the labels went through.
            predictions.append(process_example(
                example={"text": raw_prediction},
                characters_to_keep=config.characters_to_keep,
                text_column="text",
                audio_column=None,
                lower_case=True,
                convert_numerals=True,
            )["text"])

    logger.info("Computing the scores for each metadata category...")
    df = convert_evaluation_rows_to_df(
        rows, sub_dialect_to_dialect_mapping=dict(config.sub_dialect_to_dialect))
    df["prediction"] = predictions
    return get_score_df(df=df, categories=["age_group", "gender", "dialect"],
                        n_bootstrap=int(config.get("bootstrap_samples", 0) or 0))


def age_group(age: float) -> str:
    """The ``AGE_GROUPS`` key whose range holds ``age``."""
    for group, (start, end) in AGE_GROUPS.items():
        if (start is None or age >= start) and (end is None or age < end):
            return group
    raise ValueError(f"age {age!r} lies in no range of AGE_GROUPS")


def convert_evaluation_rows_to_df(
    rows: list[dict], sub_dialect_to_dialect_mapping: dict[str, str]
) -> "pandas.DataFrame":  # noqa: F821
    """The evaluated rows' metadata as a DataFrame: ages binned into
    ``age_group``, sub-dialects mapped to dialects, and the dialect of a
    speaker born outside Denmark (``country_birth``, missing read as "DK")
    set to "Non-native"; a column the rows lack is None."""
    import pandas as pd

    df = pd.DataFrame.from_records(rows)

    if "age" in df.columns:
        df["age_group"] = df.age.map(age_group)
    else:
        df["age_group"] = None

    if "dialect" in df.columns:
        df.dialect = df.dialect.map(lambda d: sub_dialect_to_dialect_mapping.get(d, d))
    else:
        df["dialect"] = None

    if "country_birth" in df.columns:
        df.country_birth = df.country_birth.map(lambda x: "DK" if pd.isna(x) else x)
        df.loc[df.country_birth != "DK", "dialect"] = "Non-native"

    if "gender" not in df.columns:
        df["gender"] = None
    return df


def bootstrap_interval(predictions: list[str], labels: list[str], metric,
                       n_bootstrap: int = 1000, seed: int = 4242) -> tuple[float, float]:
    """The 2.5th and 97.5th percentiles of ``metric`` over ``n_bootstrap``
    resamples of the pairs, drawn with replacement by numpy from ``seed``
    (the reference's published "1000x bootstrap, 95% CI")."""
    rng = np.random.default_rng(seed)
    n = len(predictions)
    scores = []
    preds = np.asarray(predictions, dtype=object)
    labs = np.asarray(labels, dtype=object)
    for _ in range(n_bootstrap):
        idx = rng.integers(0, n, n)
        scores.append(metric(predictions=list(preds[idx]), labels=list(labs[idx])))
    lo, hi = np.percentile(scores, [2.5, 97.5])
    return float(lo), float(hi)


def _narrow_to_slice(df: "pandas.DataFrame", slice_spec: dict  # noqa: F821
                     ) -> tuple["pandas.DataFrame", bool]:  # noqa: F821
    """The rows of one demographic slice, and whether the slice informs.

    A ``None`` value marginalises its column. The slice informs unless one
    constraint is vacuous on the rows narrowed so far: it matches none of
    them, or all (then its numbers are a marginal row's).
    """
    subset = df
    for column, wanted in slice_spec.items():
        if wanted is None:
            continue
        narrowed = subset[subset[column] == wanted]
        if len(narrowed) == 0 or len(narrowed) == len(subset):
            return subset, False
        subset = narrowed
    return subset, True


def get_score_df(df: "pandas.DataFrame", categories: list[str],  # noqa: F821
                 n_bootstrap: int = 0) -> "pandas.DataFrame":  # noqa: F821
    """WER/CER of every informative slice of ``categories``' values, each
    with None (the marginal) too, in product order; with ``n_bootstrap``
    > 0, the overall row also gets the 95% bootstrap interval's columns
    (``cer_ci_low`` ...). Logs one line a slice."""
    import pandas as pd

    axis_values = {c: [*df[c].unique().tolist(), None] for c in categories}

    rows = []
    for point in it.product(*axis_values.values()):
        slice_spec = dict(zip(categories, point))
        subset, informative = _narrow_to_slice(df, slice_spec)
        if not informative:
            continue

        hyp = subset.prediction.tolist()
        ref = subset.text.tolist()
        measured = {"cer": cer(predictions=hyp, labels=ref),
                    "wer": wer(predictions=hyp, labels=ref)}
        is_overall = all(v is None for v in point)
        if n_bootstrap and is_overall:
            for name, metric in (("cer", cer), ("wer", wer)):
                lo, hi = bootstrap_interval(hyp, ref, metric, n_bootstrap=n_bootstrap)
                measured[f"{name}_ci_low"] = lo
                measured[f"{name}_ci_high"] = hi
        rows.append(slice_spec | measured)

        where = ("overall" if is_overall else
                 " & ".join(f"{c}={v}" for c, v in slice_spec.items() if v is not None))
        summary = ", ".join(f"{name.upper()} {value:.1%}" for name, value in measured.items())
        logger.info(f"[{where}] {summary}")

    return pd.DataFrame.from_records(data=rows)


def load_saved_predictor(
    config: Mapping[str, Any], device: str | torch.device = "cuda"
) -> tuple[Callable[[Mapping[str, Any]], list[str]], dict]:
    """Build a transcriber for ``config["model_id"]`` on ``device``.

    ``config`` has these keys of the JAX package's evaluation surface:
    ``model_id``, ``sampling_rate``, and optionally ``no_lm`` and (for a
    saved directory) the eval-time overrides ``EVAL_OVERRIDES``; a
    pretrained id also needs ``characters_to_keep``,
    ``max_seconds_per_example`` and optionally ``lower_case`` (default true).

    Returns:
        ``(predict(batch) -> list[str], batch_geometry_kwargs)``.
    """
    model_id = str(config["model_id"])
    model_dir = Path(model_id)
    if (model_dir / "config.yaml").exists():
        if not (model_dir / SAVED_PARAMS).exists():
            raise ValueError(
                f"{model_dir} is a saved coral-tpu model without {SAVED_PARAMS} (the JAX "
                "package's orbax params?): convert it on a host with JAX with "
                f"`python tools/convert_coral_tpu_model.py {model_dir} DST`, then serve DST")
        import yaml

        from ..config import DictConfig

        saved = DictConfig(yaml.safe_load((model_dir / "config.yaml").read_text("utf-8")))
        saved.model_dir = str(model_dir)
        for key, model_key in EVAL_OVERRIDES:
            if config.get(key) is not None:
                saved.model[model_key] = config.get(key)
        setup = load_model_setup(saved, is_main=True, device=device)
        model = setup.init_params(seed=0, pretrained=False)
        load_saved_params(model, model_dir / SAVED_PARAMS)
    else:
        # A pretrained checkpoint id: the training-config surface the JAX
        # branch builds (its model_dir, where the JAX setup writes vocab.json,
        # aside).
        train_cfg = {
            "model": {
                "type": "whisper" if "whisper" in model_id.lower() else "wav2vec2",
                "pretrained_model_id": model_id,
                "sampling_rate": config["sampling_rate"],
                "characters_to_keep": config["characters_to_keep"],
                "lower_case": config.get("lower_case", True),
                "language": "danish",
            },
            "max_seconds_per_example": config["max_seconds_per_example"],
            "bf16_allowed": True,
            "gradient_checkpointing": False,
        }
        setup = load_model_setup(train_cfg, is_main=True, device=device)
        model = setup.init_params(seed=0)
    # Beam search with the n-gram LM stored beside a wav2vec2 model, unless
    # no_lm; the last by name, as the JAX branch picks it.
    arpa_files = sorted(model_dir.glob("*gram.arpa")) if model_dir.is_dir() else []
    if arpa_files and not config.get("no_lm", False) and isinstance(setup, Wav2Vec2Setup):
        logger.info(f"Decoding with the n-gram LM at {arpa_files[-1]}")
        predict = setup.make_beam_predictor(model, arpa_files[-1])
    else:
        predict = setup.make_predictor(model)
    geometry = {
        "max_seconds": setup.audio_pad_seconds,
        "sample_rate": int(config["sampling_rate"]),
    }
    return predict, geometry

