"""High-level ASR pipeline: one object from model id to transcripts.

Port of ``coral_tpu/pipeline.py`` (``ASRPipeline``) on PyTorch:

    from coral_tpu_torch import ASRPipeline
    asr = ASRPipeline("facebook/wav2vec2-xls-r-300m", device="cuda")
    print(asr("recording.wav"))

Clips are padded to the model window (30 s) and run in fixed batches; a
partial batch is filled with ``lengths=1`` rows whose outputs are dropped.
Audio beyond the window goes through overlapping windows
(``coral_tpu.evaluation.longform.chunk_waveform``, which imports no JAX).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

import numpy as np
import torch

from .training.model_setup import GreedyCtcPredictor


class ASRPipeline:
    """Batched transcriber.

    Args:
        model_id: A pretrained checkpoint id or path (its name picks the
            architecture, e.g. ``facebook/wav2vec2-xls-r-300m``).
        batch_size: Device batch size for transcription.
        no_lm: Decode greedily even when an n-gram LM is stored with the model
            (beam search is not ported yet).
        sampling_rate: Input audio is resampled to this rate.
        device: Where the model runs (``"cuda"`` for the kernels).
    """

    def __init__(
        self,
        model_id: str | Path,
        batch_size: int = 8,
        no_lm: bool = False,
        sampling_rate: int = 16_000,
        device: str | torch.device = "cpu",
    ) -> None:
        from .evaluation.evaluate import load_saved_predictor

        self.sampling_rate = sampling_rate
        self.batch_size = batch_size
        config = {
            "model_id": str(model_id),
            "no_lm": no_lm,
            "sampling_rate": sampling_rate,
            "characters_to_keep": "abcdefghijklmnopqrstuvwxyzæøå0123456789éü",
            "max_seconds_per_example": 30,
        }
        self._predict, geometry = load_saved_predictor(config, device=device)
        self.window_seconds = float(geometry["max_seconds"])

    @property
    def predictor(self) -> GreedyCtcPredictor:
        """The batch transcriber: its ``model``, ``tokenizer`` and ``logits``."""
        return self._predict

    # -- input handling ---------------------------------------------------------
    def _load_audio(self, item) -> np.ndarray:
        if isinstance(item, (str, Path)):
            from .audio.noise_bank import _read_wav

            audio = _read_wav(Path(item), self.sampling_rate)
            if audio is None:
                raise ValueError(f"Could not decode audio file: {item}")
            return audio
        if isinstance(item, dict):  # HF-style {"array", "sampling_rate"}
            audio = np.asarray(item["array"], dtype=np.float32)
            if int(item.get("sampling_rate", self.sampling_rate)) != (
                self.sampling_rate
            ):
                from .audio.resample import resample

                audio = resample(
                    audio, int(item["sampling_rate"]), self.sampling_rate
                )
            return audio
        return np.asarray(item, dtype=np.float32)

    # -- transcription -----------------------------------------------------------
    def transcribe_batch(self, items: Sequence) -> list[str]:
        """Transcribe a sequence of short clips (padded to the model window)."""
        T = int(self.window_seconds * self.sampling_rate)
        out: list[str] = []
        audios = [self._load_audio(item) for item in items]
        for start in range(0, len(audios), self.batch_size):
            group = audios[start : start + self.batch_size]
            batch_audio = np.zeros((self.batch_size, T), dtype=np.float32)
            lengths = np.ones((self.batch_size,), dtype=np.int32)
            for j, audio in enumerate(group):
                clip = audio[:T]
                batch_audio[j, : len(clip)] = clip
                lengths[j] = max(1, len(clip))
            predictions = self._predict(
                {"input_values": batch_audio, "input_lengths": lengths}
            )
            out.extend(predictions[: len(group)])
        return out

    def transcribe(self, item) -> str:
        """Transcribe one input (path / array / HF audio dict), any length."""
        audio = self._load_audio(item)
        T = int(self.window_seconds * self.sampling_rate)
        if len(audio) <= T:
            return self.transcribe_batch([audio])[0]
        from coral_tpu.evaluation.longform import chunk_waveform

        stride = T // 6
        windows = [w for _, w in chunk_waveform(audio, T, stride)]
        pieces = self.transcribe_batch(windows)
        return " ".join(piece for piece in pieces if piece).strip()

    __call__ = transcribe

    def transcribe_stream(self, items: Iterable) -> Iterable[str]:
        """Lazily transcribe an iterable of inputs."""
        buffer: list = []
        for item in items:
            buffer.append(item)
            if len(buffer) == self.batch_size:
                yield from self.transcribe_batch(buffer)
                buffer = []
        if buffer:
            yield from self.transcribe_batch(buffer)
