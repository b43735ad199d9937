#!/usr/bin/env python3
"""Convert a model directory saved by coral_tpu into one that coral_tpu_torch serves.

    python tools/convert_coral_tpu_model.py SRC DST

SRC is what ``coral_tpu.training.finetune.save_model`` writes: ``config.yaml``,
the orbax params under ``model/`` and the tokenizer's files (``vocab.json``;
Whisper's also ``merges.txt`` and ``tokenizer_config.json``), with the n-gram
LM (``*gram.arpa``, ``*gram.bin``) where ``model.use_decoder`` trained one.
DST gets those files and ``model/params.pt``: the fp32 parameters by the
port's names, the file ``coral_tpu_torch.training.finetune.save_model``
writes, so ``ASRPipeline(DST)`` and ``python -m coral_tpu_torch evaluate
model_id=DST`` serve it as they serve the port's own saved models.

It runs where JAX and orbax are installed. The params are restored into the
JAX setup's shapes by ``coral_tpu.evaluation.evaluate._restore_params``, the
JAX package's own restore, then mapped by ``wav2vec2_state_dict_from_jax`` or
``whisper_state_dict_from_jax``; their names and shapes must be the port
model's parameters exactly. A failed restore raises: nothing is written
instead. Nothing is written under SRC, and a DST that already holds
``model/params.pt`` is refused.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# The files beside the params that serving reads: the saved config, the
# tokenizer's files, and the n-gram LM (ARPA and its binary).
COPIED = ("config.yaml", "vocab.json", "merges.txt", "tokenizer_config.json")
LM_GLOBS = ("*gram.arpa", "*gram.bin")


def convert(src: str | Path, dst: str | Path) -> Path:
    """Write ``DST/model/params.pt`` and the files beside it from the saved
    JAX model directory ``src``; returns the params file's path.

    Raises:
        ValueError: ``src`` is not a saved model directory, or ``dst`` is
            ``src`` or lies inside it, or the restored tree does not map onto
            the port model's parameters.
        FileExistsError: ``dst`` already holds ``model/params.pt``.
    """
    import jax
    import torch
    import yaml

    from coral_tpu.config import DictConfig as JaxDictConfig
    from coral_tpu.evaluation.evaluate import _restore_params
    from coral_tpu.training.model_setup import load_model_setup as jax_load_model_setup
    from coral_tpu_torch.config import DictConfig
    from coral_tpu_torch.models import whisper
    from coral_tpu_torch.models.convert import (wav2vec2_state_dict_from_jax,
                                                whisper_state_dict_from_jax)
    from coral_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC
    from coral_tpu_torch.training.finetune import SAVED_PARAMS
    from coral_tpu_torch.training.model_setup import load_model_setup

    src, dst = Path(src).resolve(), Path(dst).resolve()
    if not (src / "config.yaml").is_file() or not (src / "model").is_dir():
        raise ValueError(f"{src} is not a saved coral_tpu model directory "
                         "(config.yaml and an orbax model/)")
    if dst == src or src in dst.parents:
        raise ValueError(f"{dst} is {src} or lies inside it: nothing is written under SRC")
    target = dst / SAVED_PARAMS
    if target.exists():
        raise FileExistsError(f"{target} exists; convert into a new directory")

    text = (src / "config.yaml").read_text("utf-8")
    jax_config = JaxDictConfig(yaml.safe_load(text))
    # The JAX wav2vec2 setup writes vocab.json into model_dir when is_main.
    jax_config.model_dir = str(dst)
    jax_setup = jax_load_model_setup(jax_config, is_main=False)
    params = jax.device_get(_restore_params(src / "model", jax_setup))

    setup = load_model_setup(DictConfig(yaml.safe_load(text)), is_main=False, device="cpu")
    family = jax_config.model.type
    with torch.device("meta"):
        model = (Wav2Vec2ForCTC(setup.model_config) if family == "wav2vec2"
                 else whisper.WhisperForConditionalGeneration(setup.model_config))
    to_port = (wav2vec2_state_dict_from_jax if family == "wav2vec2"
               else whisper_state_dict_from_jax)
    state = to_port(params, setup.model_config)
    want = {name: tuple(p.shape) for name, p in model.named_parameters()}
    got = {name: tuple(t.shape) for name, t in state.items()}
    if got != want:
        raise ValueError(
            f"{src}: the restored params do not map onto the port's {family} model: missing "
            f"{sorted(set(want) - set(got))[:5]}, unexpected {sorted(set(got) - set(want))[:5]}, "
            f"shapes {[(k, got[k], want[k]) for k in sorted(set(got) & set(want)) if got[k] != want[k]][:5]}")

    target.parent.mkdir(parents=True)
    torch.save(state, target)
    for path in [src / name for name in COPIED] + [p for g in LM_GLOBS for p in src.glob(g)]:
        if path.is_file():
            shutil.copy2(path, dst / path.name)
    return target


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="a model directory saved by coral_tpu")
    parser.add_argument("dst", help="the new directory for coral_tpu_torch")
    args = parser.parse_args(argv)
    target = convert(args.src, args.dst)
    print(f"wrote {target} and the files beside it; serve it with coral_tpu_torch "
          f"(ASRPipeline({str(target.parent.parent)!r}))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
