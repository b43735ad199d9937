"""The wav2vec2-CTC and Whisper models and the bridge from the JAX package's weights."""

from .wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from .whisper import WhisperConfig, WhisperForConditionalGeneration

__all__ = ["Wav2Vec2Config", "Wav2Vec2ForCTC", "WhisperConfig",
           "WhisperForConditionalGeneration"]
