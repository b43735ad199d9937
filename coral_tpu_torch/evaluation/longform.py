"""Long-form transcription: chunked Whisper inference with overlap merging.

A copy of ``coral_tpu/evaluation/longform.py``: the port imports nothing of
``coral_tpu``. The reference relies on the HF ASR pipeline's chunking for
audio longer than the model window (reference: ``src/coral/evaluate.py:56-60``,
pipeline ``chunk_length_s``): the waveform is split into overlapping windows
(``chunk_waveform``, also what ``ASRPipeline.transcribe`` cuts), each window
is transcribed, and the token sequences are merged by maximising agreement in
the overlap. The windows go to the device in batches of ``batch_size``, one
generate call each. ``generate_ids`` is the generate step of a predictor, e.g.
``lambda b: predictor.generate(predictor.model, b)``.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np


def chunk_waveform(
    audio: np.ndarray, chunk_length: int, stride: int
) -> list[tuple[int, np.ndarray]]:
    """Split a 1-D waveform into overlapping windows.

    Args:
        audio: (T,) waveform.
        chunk_length: Window size in samples (e.g. 30 s).
        stride: Overlap on each side, in samples (HF default: chunk / 6).

    Returns:
        List of (start_offset, window) pairs; the last window may be short.
    """
    if len(audio) <= chunk_length:
        return [(0, audio)]
    step = chunk_length - 2 * stride
    if step <= 0:
        raise ValueError("stride too large for the chunk length")
    out = []
    start = 0
    while start < len(audio):
        out.append((start, audio[start : start + chunk_length]))
        if start + chunk_length >= len(audio):
            break
        start += step
    return out


def merge_token_sequences(sequences: Sequence[Sequence[int]]) -> list[int]:
    """Merge overlapping token sequences (HF's longest-common-sequence merge).

    The semantics of ``transformers``' whisper tokenizer
    ``_find_longest_common_sequence`` (the merge the reference reaches through
    the ASR pipeline's ``_decode_asr``): each new window slides across the
    *remainder* of the previous one over every alignment (including windows
    shorter or longer than the remainder), alignments are scored by match
    density plus an ``i / 10000`` bonus that favours long perfect matches, and
    the winning overlap is split down the middle: the left window keeps the
    first half, the right window supplies the rest.
    """
    if not sequences:
        return []
    left = list(sequences[0])
    total: list[int] = []
    for right in sequences[1:]:
        right = list(right)
        nl, nr = len(left), len(right)
        best = 0.0
        cut = (nl, nl, 0, 0)
        for i in range(1, nl + nr):
            ls, lstop = max(0, nl - i), min(nl, nl + nr - i)
            rs, rstop = max(0, i - nl), min(nr, i)
            matches = sum(a == b for a, b in zip(left[ls:lstop], right[rs:rstop]))
            score = matches / i + i / 10000.0
            if matches > 1 and score > best:
                best = score
                cut = (ls, lstop, rs, rstop)
        ls, lstop, rs, rstop = cut
        total.extend(left[: (ls + lstop) // 2])
        left = right[(rs + rstop) // 2:]
    total.extend(left)
    return total


def _window_ids(
    audio: np.ndarray,
    generate_ids: Callable[[Mapping[str, np.ndarray]], object],
    chunk_length: int,
    stride: int,
    batch_size: int,
):
    """Yield (window index, number of windows, start sample, ids) for every
    window, the windows sent in zero-padded batches of ``batch_size``."""
    windows = chunk_waveform(np.asarray(audio, dtype=np.float32), chunk_length, stride)
    for i in range(0, len(windows), batch_size):
        group = windows[i : i + batch_size]
        batch_audio = np.zeros((batch_size, chunk_length), dtype=np.float32)
        lengths = np.ones((batch_size,), dtype=np.int32)
        for j, (_, w) in enumerate(group):
            batch_audio[j, : len(w)] = w
            lengths[j] = len(w)
        ids = generate_ids({"input_values": batch_audio, "input_lengths": lengths})
        ids = np.asarray(ids.cpu() if hasattr(ids, "cpu") else ids)
        for j, (start, _) in enumerate(group):
            yield i + j, len(windows), start, ids[j]


def transcribe_longform(
    audio: np.ndarray,
    generate_ids: Callable[[Mapping[str, np.ndarray]], object],
    tokenizer,
    chunk_seconds: float = 30.0,
    stride_seconds: float = 5.0,
    sample_rate: int = 16_000,
    batch_size: int = 8,
) -> str:
    """Transcribe arbitrarily long audio, one generate call per ``batch_size``
    windows.

    Args:
        audio: (T,) waveform at ``sample_rate``.
        generate_ids: ``(batch dict) -> (B, L) token ids`` (a predictor's
            generate step), fed padded batches of one shape.
        tokenizer: Whisper tokenizer for stripping specials and decoding.

    Returns:
        The merged transcript.
    """
    stride = int(stride_seconds * sample_rate)
    id_sequences = [
        [int(t) for t in ids if int(t) < tokenizer.first_special_id]
        for _, _, _, ids in _window_ids(audio, generate_ids, int(chunk_seconds * sample_rate),
                                        stride, batch_size)
    ]
    if stride == 0:
        # No overlap to reconcile: the HF pipeline only runs its
        # longest-common-sequence merge on stride overlaps; with none, the
        # heuristic would find weak matches between unrelated neighbouring
        # windows and swallow tokens.
        merged = [t for seq in id_sequences for t in seq]
    else:
        merged = merge_token_sequences(id_sequences)
    return tokenizer.bpe.decode(merged).strip()


def transcribe_longform_timestamps(
    audio: np.ndarray,
    generate_ids: Callable[[Mapping[str, np.ndarray]], object],
    tokenizer,
    chunk_seconds: float = 30.0,
    stride_seconds: float = 5.0,
    sample_rate: int = 16_000,
    batch_size: int = 8,
) -> list[tuple[float, float, str]]:
    """Timestamped long-form transcription.

    ``generate_ids`` must run the timestamp grammar (``return_timestamps``,
    ``make_whisper_generate_step(timestamps=True)``). Each window's segments
    are cut out of the overlap by time: a segment survives when its midpoint
    falls inside the window's exclusive region (the HF pipeline's stride
    trimming for ``return_timestamps``, reference surface:
    ``src/coral/evaluate.py:47-74``), then it is shifted by the window's
    offset.

    Returns:
        Absolute-time (start_seconds, end_seconds, text) tuples.
    """
    out: list[tuple[float, float, str]] = []
    for index, n_windows, start_sample, ids in _window_ids(
            audio, generate_ids, int(chunk_seconds * sample_rate),
            int(stride_seconds * sample_rate), batch_size):
        lo = 0.0 if index == 0 else stride_seconds
        hi = chunk_seconds if index == n_windows - 1 else chunk_seconds - stride_seconds
        offset = start_sample / sample_rate
        for seg_start, seg_end, text in tokenizer.decode_segments(ids):
            if lo <= (seg_start + seg_end) / 2.0 < hi:
                out.append((seg_start + offset, seg_end + offset, text))
    return out
