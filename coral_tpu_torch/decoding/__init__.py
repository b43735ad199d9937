"""The n-gram LM and the CTC beam search with shallow fusion (C++ through ctypes).

Port of ``coral_tpu/decoding/__init__.py``. The decoder is native code:
``coral_tpu_torch/native/ngram.cc`` (modified Kneser-Ney training, ARPA and
binary I/O, backoff queries) and ``ctc_beam.cc`` (pyctcdecode's beam search
with the LM fused inside the frame loop) are copies of ``coral_tpu/native/``'s
sources; the binding reaches what serving and the LM pipeline use: training
an ARPA file (in memory or streamed through sorted shards on disk), loading
it or its compact binary, writing the binary, scoring words and sentences,
and the beam search at pyctcdecode's defaults. They are built with ``g++ -O3
-std=c++17 -shared -fPIC`` at first use into ``coral_tpu_torch/_build/``,
under a name that hashes the sources and the flags, so an edited source builds
anew and a stale library is never loaded; a failed build raises. Nothing is
built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__package__)

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

__all__ = ["NGramModel", "BeamSearchDecoder", "build_native_library"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_native_library() -> Path:
    """The decoder library's path, compiled from ``native/*.cc`` if no library
    of these sources and flags is built yet. Raises with g++'s output if the
    build fails."""
    sources = sorted(NATIVE_DIR.glob("*.cc"))
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    target = BUILD_DIR / f"libcoral_decoder_{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / "lib.so"
        cmd = ["g++", *_FLAGS, *map(str, sources), "-o", str(lib)]
        logger.info(f"Building the native decoder: {' '.join(cmd)}")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(lib, target)  # atomic: concurrent builds agree
    return target


def _load() -> ctypes.CDLL:
    """The loaded decoder library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native_library()))
        c_int, c_float, c_char_p, c_void_p = (ctypes.c_int, ctypes.c_float, ctypes.c_char_p,
                                              ctypes.c_void_p)
        for name, restype, argtypes in (
            ("coral_ngram_train", c_int,
             [c_char_p, c_char_p, c_int, ctypes.POINTER(ctypes.c_uint64), c_int]),
            ("coral_ngram_train_streamed", c_int,
             [c_char_p, c_char_p, c_int, ctypes.POINTER(ctypes.c_uint64), c_int,
              ctypes.c_uint64, c_char_p]),
            ("coral_ngram_load_any", c_void_p, [c_char_p]),
            ("coral_ngram_save_binary", c_int, [c_void_p, c_char_p]),
            ("coral_ngram_logprob", c_float, [c_void_p, c_char_p, c_char_p]),
            ("coral_ngram_sentence_logprob", c_float, [c_void_p, c_char_p]),
            ("coral_ngram_free", None, [c_void_p]),
            ("coral_ngram_order", c_int, [c_void_p]),
            # char*, freed by coral_free
            ("coral_ctc_beam_search", c_void_p,
             [ctypes.POINTER(c_float), c_int, c_int, ctypes.POINTER(c_char_p), c_int, c_int,
              c_int, c_void_p, c_float, c_float, c_int, c_int, c_float, c_float, c_char_p,
              c_float, c_char_p, c_float]),
            ("coral_free", None, [c_void_p]),
        ):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


class NGramModel:
    """A Kneser-Ney n-gram LM, trained to an ARPA file and loaded from one.

    Training follows ``lmplz -o N --prune 0 1 1...`` as the reference calls
    it, and the ARPA file holds a ``</s>`` unigram.
    """

    def __init__(self, arpa_path: str | Path) -> None:
        self.arpa_path = Path(arpa_path)
        self._handle = _load().coral_ngram_load_any(str(arpa_path).encode())
        if not self._handle:
            raise FileNotFoundError(f"Could not load LM: {arpa_path}")
        self.order = _load().coral_ngram_order(self._handle)

    @classmethod
    def train(cls, corpus_path: str | Path, arpa_path: str | Path, order: int = 3,
              prune: list[int] | None = None, streamed: bool = False,
              budget_entries: int = 20_000_000,
              scratch_dir: str | Path | None = None) -> "NGramModel":
        """Estimate the LM from a one-sentence-per-line corpus file.

        Args:
            prune: Per-order count thresholds (default ``[0, 1, 1, ...]``, the
                reference's).
            streamed: Count through sorted shards on disk (under
                ``scratch_dir``), spilled whenever the in-memory map reaches
                ``budget_entries``, as lmplz does, so the corpus's size does
                not bound memory. The ARPA entries are the in-memory path's.
        """
        if prune is None:
            prune = [0] + [1] * (order - 1)
        arr = (ctypes.c_uint64 * len(prune))(*prune)
        if streamed:
            rc = _load().coral_ngram_train_streamed(
                str(corpus_path).encode(), str(arpa_path).encode(), order, arr, len(prune),
                budget_entries, str(scratch_dir).encode() if scratch_dir else None)
        else:
            rc = _load().coral_ngram_train(
                str(corpus_path).encode(), str(arpa_path).encode(), order, arr, len(prune))
        if rc != 0:
            raise RuntimeError(f"n-gram training failed with code {rc}")
        return cls(arpa_path)

    def save_binary(self, path: str | Path) -> Path:
        """Write the LM in the compact binary format (the reference's
        ``build_binary`` step), which ``NGramModel(path)`` loads too."""
        rc = _load().coral_ngram_save_binary(self._handle, str(path).encode())
        if rc != 0:
            raise RuntimeError(f"binary serialisation failed with code {rc}")
        return Path(path)

    def logprob(self, word: str, context: str = "") -> float:
        """log10 P(word | the context's words)."""
        return _load().coral_ngram_logprob(self._handle, context.encode(), word.encode())

    def sentence_logprob(self, sentence: str) -> float:
        """log10 P(<s> sentence </s>)."""
        return _load().coral_ngram_sentence_logprob(self._handle, sentence.encode())

    def __del__(self) -> None:
        if getattr(self, "_handle", None):
            _load().coral_ngram_free(self._handle)
            self._handle = None


class BeamSearchDecoder:
    """CTC beam search with pyctcdecode's n-gram shallow fusion.

    ``alpha``, ``beta`` and the beam width default to pyctcdecode's (0.5,
    1.5, 100); the rest is pyctcdecode's defaults as constants: a per-frame
    token floor of ``TOKEN_MIN_LOGP``, beams pruned ``BEAM_PRUNE_LOGP``
    below the best fused score, ``<s>``/``</s>`` scored at the boundaries,
    and no unigram list or hotwords.
    """

    TOKEN_MIN_LOGP = -5.0
    BEAM_PRUNE_LOGP = -10.0
    SCORE_BOUNDARY = True

    def __init__(self, vocab: list[str], blank_id: int, word_sep_id: int,
                 lm: NGramModel | None = None, alpha: float = 0.5, beta: float = 1.5,
                 beam_width: int = 100) -> None:
        self.vocab = list(vocab)
        self._vocab_c = (ctypes.c_char_p * len(vocab))(*[t.encode() for t in vocab])
        self.blank_id = blank_id
        self.word_sep_id = word_sep_id
        self.lm = lm
        self.alpha = alpha
        self.beta = beta
        self.beam_width = beam_width

    def decode(self, log_probs: np.ndarray) -> str:
        """Decode one utterance from its (T, V) natural-log probabilities."""
        log_probs = np.ascontiguousarray(log_probs, dtype=np.float32)
        T, V = log_probs.shape
        if V != len(self._vocab_c):
            raise ValueError(f"log_probs have {V} columns for a vocabulary of "
                             f"{len(self._vocab_c)}")
        lib = _load()
        # The C entry's unigram and hotword arguments: none, so their offset
        # and weight (pyctcdecode's -10 and 10) are never read.
        ptr = lib.coral_ctc_beam_search(
            log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            T, V, self._vocab_c, self.blank_id, self.word_sep_id, self.beam_width,
            self.lm._handle if self.lm is not None else None,
            self.alpha, self.beta, self.lm.order if self.lm is not None else 0,
            int(self.SCORE_BOUNDARY), self.BEAM_PRUNE_LOGP, self.TOKEN_MIN_LOGP,
            None, -10.0, None, 10.0,
        )
        try:
            return ctypes.string_at(ptr).decode("utf-8", errors="replace")
        finally:
            lib.coral_free(ptr)

    def decode_batch(self, log_probs: np.ndarray,
                     lengths: np.ndarray | None = None) -> list[str]:
        """Decode a (B, T, V) batch, each row cut to its valid length."""
        out = []
        for i in range(log_probs.shape[0]):
            row = log_probs[i]
            if lengths is not None:
                row = row[: int(lengths[i])]
            out.append(self.decode(row))
        return out
