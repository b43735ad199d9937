"""coral-tpu-torch: the coral-tpu serving path in PyTorch with CUDA kernels for Hopper.

A port of ``coral_tpu`` (JAX, TPU) that runs on one NVIDIA H100. It serves
published Hugging Face checkpoints or seeded weights: wav2vec2-CTC
(``ASRPipeline`` -> ``load_saved_predictor`` -> ``Wav2Vec2Setup.make_predictor``
-> ``Wav2Vec2ForCTC``, greedy CTC decoding, or ``make_beam_predictor``'s CTC
beam search with an n-gram LM, ``decoding/``) and Whisper
(``WhisperSetup.make_predictor`` -> the log-mel frontend and greedy
generation of ``WhisperForConditionalGeneration``), trains both families
(the setups' ``make_train_step``) and fine-tunes them end to end
(``training.finetune.finetune``: the config composer of ``config``, the data
pipeline of ``data``, checkpoints, evaluation, the saved model that
``load_saved_predictor`` serves). It imports ``torch`` and never ``jax``,
and nothing of ``coral_tpu``: the jax-free pieces it needs (the tokenisers,
``chunk_waveform``, the config composer, the data pipeline, the native
decoder's C++ sources) are copied into it. Its entry points run on
the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy, as in coral_tpu: a bare `import coral_tpu_torch` stays light.
    if name == "ASRPipeline":
        from .pipeline import ASRPipeline

        return ASRPipeline
    raise AttributeError(name)
