"""Length-bucketed fixed-shape batching and device prefetch.

A copy of ``coral_tpu/data/batching.py`` (``BucketBatcher``,
``prefetch_to_device``) with the CUDA half of the infeed that the JAX package
gets from ``jax.device_put``: ``device_put_fn`` copies each batch into pinned
host memory and issues the host-to-device copies on a side stream, and
``StreamedBatch.wait`` makes the consumer's stream wait for them.

The reference pads per-batch to the longest sample on one GPU and forces global
max-length padding on multiple GPUs (reference:
``src/scripts/finetune_asr_model.py:55-61``, ``src/coral/data_collators.py:48-95``).
Here `padding=longest` is realised as *length bucketing*: a small fixed set of audio
lengths, with samples routed to the shortest bucket that fits — recovering most
of the padding waste with a bounded set of shapes. This replaces the
reference's length-grouped batching (``length_column_name``, wav2vec2.py:228).

``prefetch_to_device`` overlaps host batch assembly with device compute via a
background thread and a small queue (the double-buffering role of the reference's
dataloader workers).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch


class BucketBatcher:
    """Assemble fixed-shape (accum, batch, T_bucket) batches from a sample stream.

    Args:
        batch_size: Per-step global batch size B (across all microbatches' axis 1).
        accum_steps: Gradient-accumulation microbatches A per emitted batch.
        max_seconds: Upper audio-length bound (defines the largest bucket).
        sample_rate: Audio sample rate.
        num_buckets: Number of audio-length buckets (padding=longest emulation).
        max_label_length: Fixed label padding length (reference caps at 512).
        label_pad_id: Fill value for label padding (-100, masked by the loss).
        drop_last: Drop incomplete trailing batches (reference:
            ``dataloader_drop_last=True``).
    """

    def __init__(
        self,
        batch_size: int,
        accum_steps: int = 1,
        max_seconds: float = 10.0,
        sample_rate: int = 16_000,
        num_buckets: int = 4,
        max_label_length: int = 512,
        label_pad_id: int = -100,
        drop_last: bool = True,
        audio_transfer_dtype: str = "float32",
        fixed_label_length: bool = False,
    ) -> None:
        self.batch_size = batch_size
        self.accum_steps = accum_steps
        self.sample_rate = sample_rate
        self.max_label_length = max_label_length
        self.label_pad_id = label_pad_id
        self.drop_last = drop_last
        # Multi-process runs need host-independent shapes: every host must
        # emit the same (A, B, L) for batch k so the per-host slices stitch
        # into one global array (finetune.py forces this with one bucket,
        # mirroring the reference's multi-GPU padding=max_length forcing,
        # src/scripts/finetune_asr_model.py:55-61).
        self.fixed_label_length = fixed_label_length
        # "int16" ships audio as PCM16 and converts to float on device: half
        # the host->device infeed bytes, lossless for 16-bit-sourced audio
        # (the training corpora are 16-bit PCM — the finetune loop selects it
        # via config), but it quantises float-origin audio (~-96 dB noise),
        # so the constructor default is the lossless "float32".
        assert audio_transfer_dtype in ("int16", "float32")
        self.audio_transfer_dtype = audio_transfer_dtype
        max_len = int(max_seconds * sample_rate)
        # Bucket boundaries: equal splits of the max length, rounded up to a
        # multiple of 1280 (= 2^8 * 5, keeping conv frame counts nicely aligned).
        edges = [
            -(-max_len * (i + 1) // num_buckets) for i in range(num_buckets)
        ]
        self.bucket_lengths = [(-(-e // 1280)) * 1280 for e in edges]
        self._buffers: dict[int, list[dict]] = {b: [] for b in self.bucket_lengths}

    def _bucket_for(self, n: int) -> int:
        for b in self.bucket_lengths:
            if n <= b:
                return b
        return self.bucket_lengths[-1]

    def _assemble(self, samples: list[dict], bucket_len: int) -> dict[str, np.ndarray]:
        A, B = self.accum_steps, self.batch_size
        # Labels pad to the batch's longest row quantised up to 64 (the
        # reference's padding=longest, realised with a bounded set of static
        # shapes); the 512 cap matches the reference collator. Full-length
        # padding would septuple the CTC recursion's (2L+1)-lane state for
        # typical Danish utterances.
        longest = max(
            (len(np.asarray(s["labels"])) for s in samples), default=1
        )
        if self.fixed_label_length:
            L = self.max_label_length
        else:
            L = min(self.max_label_length, max(64, -(-longest // 64) * 64))
        audio = np.zeros((A * B, bucket_len), dtype=np.float32)
        use_int16 = self.audio_transfer_dtype == "int16"
        lengths = np.zeros((A * B,), dtype=np.int32)
        labels = np.full((A * B, L), self.label_pad_id, dtype=np.int32)
        label_lengths = np.zeros((A * B,), dtype=np.int32)
        for i, s in enumerate(samples):
            arr = s["audio_array"][:bucket_len]
            audio[i, : len(arr)] = arr
            lengths[i] = len(arr)
            lab = np.asarray(s["labels"])[:L]
            labels[i, : len(lab)] = lab
            label_lengths[i] = len(lab)
        if use_int16:
            audio = np.clip(
                np.rint(audio * 32768.0), -32768, 32767
            ).astype(np.int16)
        return {
            "input_values": audio.reshape(A, B, bucket_len),
            "input_lengths": lengths.reshape(A, B),
            "labels": labels.reshape(A, B, L),
            "label_lengths": label_lengths.reshape(A, B),
        }

    def __call__(self, samples: Iterable[dict]) -> Iterator[dict[str, np.ndarray]]:
        """Stream fixed-shape batches; same-bucket samples batch together."""
        need = self.accum_steps * self.batch_size
        for s in samples:
            b = self._bucket_for(len(s["audio_array"]))
            buf = self._buffers[b]
            buf.append(s)
            if len(buf) >= need:
                yield self._assemble(buf[:need], b)
                del buf[:need]
        if not self.drop_last:
            for b, buf in self._buffers.items():
                while buf:
                    chunk = buf[:need]
                    del buf[:need]
                    # pad the final ragged chunk by repeating its first sample
                    while len(chunk) < need:
                        chunk.append(chunk[0])
                    yield self._assemble(chunk, b)
        for buf in self._buffers.values():
            buf.clear()


def prefetch_to_device(
    batches: Iterable[Any],
    put_fn: Callable[[Any], Any],
    prefetch_size: int = 2,
) -> Iterator[Any]:
    """Background-thread device transfer with a bounded queue.

    Args:
        batches: Host batch iterator.
        put_fn: e.g. ``lambda b: jax.device_put(b, sharding)``.
        prefetch_size: Queue depth (2 = double buffering).

    Yields:
        Device-resident batches, overlapped with consumer compute.
    """
    q: queue.Queue = queue.Queue(maxsize=prefetch_size)
    sentinel = object()
    error: list[BaseException] = []

    def worker() -> None:
        try:
            for batch in batches:
                q.put(put_fn(batch))
        except BaseException as e:  # surface worker errors to the consumer
            error.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            if error:
                raise error[0]
            return
        yield item


class StreamedBatch:
    """A batch whose host-to-device copies were issued on a side stream.

    ``wait`` makes the calling thread's current stream wait for the copies'
    event and marks each tensor as used on that stream (``record_stream``),
    so the caching allocator does not hand its memory to the side stream
    before the consumer's work on it has run. The pinned host tensors are
    kept until ``copied`` (the event has fired)."""

    def __init__(self, tensors: dict[str, torch.Tensor], event: torch.cuda.Event | None = None,
                 host: dict[str, torch.Tensor] | None = None) -> None:
        self.tensors = tensors
        self.event = event
        self.host = host

    def wait(self) -> dict[str, torch.Tensor]:
        """The device tensors, safe to use on the current stream."""
        if self.event is not None:
            stream = torch.cuda.current_stream(next(iter(self.tensors.values())).device)
            stream.wait_event(self.event)
            for tensor in self.tensors.values():
                tensor.record_stream(stream)
        return self.tensors

    def copied(self) -> bool:
        """Whether the copies have run, so the pinned host memory may go."""
        return self.event is None or self.event.query()


def device_put_fn(device: str | torch.device) -> Callable[[dict[str, np.ndarray]], StreamedBatch]:
    """The infeed's ``put_fn`` for ``prefetch_to_device``: numpy batch ->
    ``StreamedBatch`` on ``device``.

    On a CUDA device each array is copied into pinned host memory and sent
    with ``non_blocking=True`` on one side stream (made here, used by the
    prefetch thread), whose event is recorded after the last copy. On the CPU
    the arrays become tensors that share their memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: StreamedBatch({k: torch.from_numpy(np.ascontiguousarray(v))
                                            for k, v in batch.items()})
    stream = torch.cuda.Stream(device)

    def put(batch: dict[str, np.ndarray]) -> StreamedBatch:
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in batch.items()}
        with torch.cuda.stream(stream):
            tensors = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return StreamedBatch(tensors, event, host)

    return put
