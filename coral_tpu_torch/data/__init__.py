"""Data pipeline: sources, interleaving, processing, batching, device prefetch,
and the ASR-based dataset QA (``validation.py``); the JAX package's ``data/``."""

from .batching import BucketBatcher, StreamedBatch, device_put_fn, prefetch_to_device
from .interleave import interleave_iterables
from .processing import filter_example, process_example

__all__ = [
    "BucketBatcher",
    "StreamedBatch",
    "device_put_fn",
    "prefetch_to_device",
    "interleave_iterables",
    "filter_example",
    "process_example",
]
