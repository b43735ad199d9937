"""The port's command line: ``python -m coral_tpu_torch <command> [--device D] [overrides]``.

One command for each of the JAX package's entry scripts, composing the same
config (``config/``) with the same Hydra-style overrides and doing what the
script does, on the card unless ``--device`` names another device:

- ``finetune`` (``scripts/finetune_asr_model.py``, config ``asr_finetuning``):
  ``training.finetune.finetune``;
- ``evaluate`` (``scripts/evaluate_model.py``, config ``evaluation``):
  ``evaluation.evaluate.evaluate``, the score grid stored as
  ``{model-id}.{dataset}.csv`` (``-no-lm`` after the model id with
  ``no_lm``) in the working directory unless ``store_results`` is false;
- ``train-ngram`` (``scripts/train_ngram_decoder.py``, config
  ``asr_finetuning``): ``decoding.ngram_pipeline.train_and_store_ngram_model``;
- ``validate`` (``scripts/validate_coral_asr.py``, config
  ``dataset_validation``): ``data.validation.add_validations`` over the raw
  dataset, written as ``validated.jsonl`` under ``output_path``, or pushed to
  ``output_dataset_id`` on the Hub (60 tries a minute apart);
- ``demo`` (``scripts/run_asr_demo.py``, config ``demo``): a gradio
  microphone page where ``gradio`` imports, else a loop that reads WAV paths
  from standard input and prints each transcript.

For example::

    python -m coral_tpu_torch evaluate model_id=models/roest-315m \\
        dataset=CoRal-project/coral-v3::read_aloud
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import sys
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np

from .config import compose

CONFIG_DIR = Path(__file__).resolve().parents[1] / "config"

logger = logging.getLogger(__name__)

TITLE = "Dansk Talegenkendelse"
DESCRIPTION = """Optag dansk tale med mikrofonen, og få den transskriberet."""


def finetune(config: Any, device: str) -> None:
    from .training.finetune import finetune as run

    run(config, device=device)


def evaluate(config: Any, device: str) -> None:
    from .evaluation.evaluate import evaluate as run

    score_df = run(config, device=device)
    if config.get("store_results", True):
        filename = results_filename(config)
        score_df.to_csv(filename, index=False)
        logger.info(f"Stored results in {filename}")


def results_filename(config: Any) -> Path:
    """The score grid's CSV name: '/' -> '--', '.' and '::' -> '-' in the
    model id and the dataset (the reference's naming)."""
    single_dash = re.compile(r"\.|\:\:")
    double_dash = re.compile(r"\/")
    model_id = single_dash.sub("-", double_dash.sub("--", str(config.model_id)))
    if config.get("no_lm", False):
        model_id += "-no-lm"
    dataset = single_dash.sub("-", double_dash.sub("--", str(config.dataset)))
    return Path(f"{model_id}.{dataset}.csv")


def train_ngram(config: Any, device: str) -> None:
    from .decoding.ngram_pipeline import train_and_store_ngram_model

    train_and_store_ngram_model(config)


def validate(config: Any, device: str) -> None:
    from .data.loading import make_raw_source
    from .data.validation import add_validations
    from .evaluation.evaluate import load_saved_predictor

    parts = config.dataset.split("::")
    raw = make_raw_source(parts[0], parts[1] if len(parts) > 1 else None,
                          split=config.get("train_name", "train"),
                          cache_dir=config.get("cache_dir"))
    predictor, _ = load_saved_predictor(config, device=device)
    validated = list(add_validations(
        raw(),
        predictor=predictor,
        model_id=str(config.model_id),
        text_column=config.get("text_column", "text"),
        audio_column=config.get("audio_column", "audio"),
        lower_case=bool(config.get("lower_case", True)),
        sampling_rate=int(config.sampling_rate),
        characters_to_keep=config.get("characters_to_keep"),
        batch_size=int(config.batch_size),
        max_cer=float(config.max_cer),
        max_pad_seconds=float(config.get("max_seconds_per_example", 10)),
    ))
    logger.info(f"Validated dataset holds {len(validated):,} samples.")

    output_id = config.get("output_dataset_id")
    if output_id:
        import datasets as hfds

        ds = hfds.Dataset.from_list([{k: v for k, v in row.items() if k != "audio_array"}
                                     for row in validated])
        for _ in range(60):  # the reference's 60 tries, a minute apart
            try:
                ds.push_to_hub(output_id,
                               config_name=config.get("output_dataset_subset") or "default")
                break
            except Exception as error:
                logger.warning(f"Upload failed ({error}); retrying in 60 s.")
                time.sleep(60)
    else:
        out_path = Path(config.get("output_path", "validated-dataset"))
        out_path.mkdir(parents=True, exist_ok=True)
        with (out_path / "validated.jsonl").open("w", encoding="utf-8") as f:
            for row in validated:
                row = {k: v for k, v in row.items() if k not in ("audio", "audio_array")}
                f.write(json.dumps(row, ensure_ascii=False) + "\n")
        logger.info(f"Wrote validation results to {out_path}/validated.jsonl")


def make_transcriber(config: Any, device: str) -> Callable[[tuple[int, np.ndarray]], str]:
    """The demo's transcriber: ``(sample rate, audio) -> text`` for one
    recording, mixed down to mono, int PCM scaled to [-1, 1], resampled to
    the model's rate, and cut into overlapping windows (a sixth of the
    window's length on each side) where longer than the model's window, the
    windows' texts joined by spaces; punctuated by ``punctfix`` where it
    imports."""
    from .audio.resample import resample
    from .evaluation.evaluate import load_saved_predictor
    from .evaluation.longform import chunk_waveform

    predictor, geometry = load_saved_predictor(config, device=device)
    sample_rate = geometry["sample_rate"]
    T = int(geometry["max_seconds"] * sample_rate)

    try:
        from punctfix import PunctFixer

        fixer = PunctFixer(language="da")
    except ImportError:
        logger.info("punctfix is not installed; returning raw transcripts.")
        fixer = None

    def window_text(window: np.ndarray) -> str:
        padded = np.zeros((1, T), dtype=np.float32)
        padded[0, : len(window)] = window
        lengths = np.asarray([max(1, len(window))], dtype=np.int32)
        return predictor({"input_values": padded, "input_lengths": lengths})[0]

    def transcribe(recording: tuple[int, np.ndarray]) -> str:
        in_rate, audio = recording
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
        if np.abs(audio).max() > 1.5:  # int PCM, as a browser sends it
            audio = audio / 32768.0
        if in_rate != sample_rate:
            audio = resample(audio, in_rate, sample_rate)
        if len(audio) <= T:
            text = window_text(audio)
        else:
            text = " ".join(window_text(window) for _, window in chunk_waveform(audio, T, T // 6))
        if fixer is not None:
            text = fixer.punctuate(text)
        return text

    return transcribe


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """A 16-bit PCM WAV file as (sample rate, mono float32 in [-1, 1])."""
    import wave

    with wave.open(path, "rb") as w:
        audio = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16).astype(
            np.float32) / 32768.0
        return w.getframerate(), audio.reshape(-1, w.getnchannels()).mean(axis=1)


def demo(config: Any, device: str) -> None:
    transcribe = make_transcriber(config, device)
    try:
        import gradio as gr
    except ImportError:
        logger.warning("gradio is not installed; reading WAV paths from stdin instead.")
        for line in sys.stdin:
            path = line.strip()
            if path:
                print(transcribe(read_wav(path)), flush=True)
        return

    gr.Interface(
        fn=transcribe,
        inputs=gr.Audio(sources=["microphone", "upload"], type="numpy"),
        outputs=gr.Textbox(label="Transskription"),
        title=TITLE,
        description=DESCRIPTION,
        allow_flagging="never",
    ).launch(share=bool(config.get("share", False)))


# command -> (root config, what it runs)
COMMANDS: dict[str, tuple[str, Callable[[Any, str], None]]] = {
    "finetune": ("asr_finetuning", finetune),
    "evaluate": ("evaluation", evaluate),
    "train-ngram": ("asr_finetuning", train_ngram),
    "validate": ("dataset_validation", validate),
    "demo": ("demo", demo),
}


def main(argv: list[str] | None = None) -> int:
    """Run one command; returns 0 (a failure raises)."""
    parser = argparse.ArgumentParser(prog="python -m coral_tpu_torch",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("command", choices=sorted(COMMANDS))
    parser.add_argument("--device", default="cuda",
                        help="the torch device to run on (default: cuda)")
    parser.add_argument("overrides", nargs="*", help="Hydra-style config overrides")
    args = parser.parse_intermixed_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s ⋅ %(name)s ⋅ %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    config_name, run = COMMANDS[args.command]
    run(compose(config_name, overrides=args.overrides, config_path=CONFIG_DIR), args.device)
    return 0
