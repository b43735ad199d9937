"""Logging/noise-control utilities.

Rebuild of the reference's terminal-noise controls (reference:
``src/coral/utils.py:34-98``): blanket suppression of chatty third-party
loggers, plus context managers for temporary monkeypatching and tqdm/log
verbosity control used around noisy library calls.

A copy of ``coral_tpu/utils/logging_utils.py``, with the JAX loggers left out
of ``NOISY_LOGGERS``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import warnings
from typing import Any, Iterator

NOISY_LOGGERS = (
    "absl",
    "datasets",
    "fsspec",
    "huggingface_hub",
    "urllib3",
)


def block_terminal_output() -> None:
    """Silence known-noisy loggers and warnings (reference: ``utils.py:34-66``).

    Like the reference, suppression is skipped while pytest is running
    (``sys._called_from_test``) so test logs stay complete.
    """
    if hasattr(sys, "_called_from_test"):
        return
    for name in NOISY_LOGGERS:
        logging.getLogger(name).setLevel(logging.WARNING)
    warnings.filterwarnings("ignore", category=UserWarning, module="datasets")
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")


@contextlib.contextmanager
def monkeypatched(obj: Any, attribute: str, value: Any) -> Iterator[None]:
    """Temporarily replace ``obj.attribute`` (reference: ``utils.py:68-84``)."""
    original = getattr(obj, attribute)
    setattr(obj, attribute, value)
    try:
        yield
    finally:
        setattr(obj, attribute, original)


@contextlib.contextmanager
def disable_tqdm() -> Iterator[None]:
    """Run a block with tqdm progress bars disabled (reference:
    ``utils.py:86-98``)."""
    try:
        import tqdm as tqdm_module

        original = tqdm_module.tqdm.__init__

        def patched(self, *args, **kwargs):  # noqa: ANN001
            kwargs["disable"] = True
            original(self, *args, **kwargs)

        with monkeypatched(tqdm_module.tqdm, "__init__", patched):
            yield
    except ImportError:
        yield
