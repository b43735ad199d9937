"""High-level ASR pipeline: one object from model id to transcripts.

Port of ``coral_tpu/pipeline.py`` (``ASRPipeline``) on PyTorch:

    from coral_tpu_torch import ASRPipeline
    asr = ASRPipeline("facebook/wav2vec2-xls-r-300m")  # or "openai/whisper-large-v3"
    print(asr("recording.wav"))

The model runs on the card unless ``device="cpu"`` is asked for. Clips are
padded to the model window (30 s) and run in fixed batches; a partial batch is
filled with ``lengths=1`` rows whose outputs are dropped. Audio beyond the
window goes through overlapping windows (``evaluation/longform.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch


class ASRPipeline:
    """Batched transcriber.

    Args:
        model_id: A pretrained checkpoint id or path (its name picks the
            family and architecture, e.g. ``facebook/wav2vec2-xls-r-300m`` or
            ``openai/whisper-large-v3``): a directory holding an HF-layout
            ``model.safetensors`` or ``pytorch_model.bin`` (beside it, a
            Whisper model's ``vocab.json`` and ``merges.txt``, a wav2vec2
            model's ``*gram.arpa``), or an id of the Hugging Face cache;
            seeded random weights where no checkpoint is on disk.
        batch_size: Device batch size for transcription.
        no_lm: Decode greedily even when an n-gram LM (``*gram.arpa``) is
            stored beside a wav2vec2 model, which otherwise serves by CTC
            beam search with it.
        sampling_rate: Input audio is resampled to this rate.
        device: Where the model runs: the card (the kernels), or ``"cpu"``
            (the kernels' plain versions).
    """

    def __init__(
        self,
        model_id: str | Path,
        batch_size: int = 8,
        no_lm: bool = False,
        sampling_rate: int = 16_000,
        device: str | torch.device = "cuda",
    ) -> None:
        from .evaluation.evaluate import load_saved_predictor

        self.sampling_rate = sampling_rate
        self.batch_size = batch_size
        config = {
            "model_id": str(model_id),
            "no_lm": no_lm,
            "sampling_rate": sampling_rate,
            "lower_case": True,
            "characters_to_keep": "abcdefghijklmnopqrstuvwxyzæøå0123456789éü",
            "max_seconds_per_example": 30,
        }
        self._predict, geometry = load_saved_predictor(config, device=device)
        self.window_seconds = float(geometry["max_seconds"])

    @property
    def predictor(self) -> Callable[[Mapping[str, Any]], list[str]]:
        """The batch transcriber, with its ``model`` and ``tokenizer``."""
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
        from .evaluation.longform import chunk_waveform

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
