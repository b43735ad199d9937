"""Shared utilities: Hub upload, logging helpers."""

from .logging_utils import block_terminal_output, disable_tqdm, monkeypatched

__all__ = ["block_terminal_output", "disable_tqdm", "monkeypatched"]
