"""The wav2vec2-CTC model and the bridge from the JAX package's weights."""

from .wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC

__all__ = ["Wav2Vec2Config", "Wav2Vec2ForCTC"]
