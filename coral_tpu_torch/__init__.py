"""coral-tpu-torch: the coral-tpu serving path in PyTorch with CUDA kernels for Hopper.

A port of ``coral_tpu`` (JAX, TPU) that runs on one NVIDIA H100. It covers the
wav2vec2-CTC serving slice: ``ASRPipeline`` -> ``load_saved_predictor`` ->
``Wav2Vec2Setup.make_predictor`` -> ``Wav2Vec2ForCTC`` with greedy CTC
decoding. It imports ``torch`` and never ``jax``; of ``coral_tpu`` it reuses
only the modules that import no JAX (``coral_tpu.text``,
``coral_tpu.evaluation.longform``).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy, as in coral_tpu: a bare `import coral_tpu_torch` stays light.
    if name == "ASRPipeline":
        from .pipeline import ASRPipeline

        return ASRPipeline
    raise AttributeError(name)
