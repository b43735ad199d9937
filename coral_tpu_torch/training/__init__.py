"""Model setup, optimizer and the train steps (the JAX package's ``training/``)."""

from .optimizer import create_learning_rate_schedule, create_optimizer
from .train_state import TrainState, make_ctc_train_step, make_seq2seq_train_step

__all__ = ["TrainState", "create_learning_rate_schedule", "create_optimizer",
           "make_ctc_train_step", "make_seq2seq_train_step"]
