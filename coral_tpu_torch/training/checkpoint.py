"""Train-state checkpoints with best-k retention and resume, in a torch format.

Port of ``coral_tpu/training/checkpoint.py`` (``Checkpointer`` :27-109),
which writes the train state with an orbax ``CheckpointManager``. This one
keeps its interface and semantics in a format of its own:

- one directory per step under the checkpoint root, named by the step,
  holding ``state.pt`` (``torch.save`` of the step count, the fp32 master
  parameters by name and the AdamW state: count, first and second moments in
  their dtypes) and, when the save had metrics, ``metrics.json`` beside it;
  files are read back with ``torch.load(weights_only=True)``;
- a save is written into a temporary directory that is renamed to the step
  when it is complete, so a reader never sees a half-written step;
- asynchronous, as orbax's manager: ``save`` copies the state to host memory
  before it returns (the train step updates the parameters and moments in
  place) and one background thread writes that copy; ``wait`` and ``close``
  join it, and the next ``save`` waits for the previous write first;
- retention as ``CheckpointManagerOptions(max_to_keep=max(1,
  save_total_limit), best_fn=lambda m: m[metric_name], best_mode="min")``
  gives it: a save at or below the latest step is skipped; after each write,
  with a metric name the ``max_to_keep`` steps of least metric stay, with
  every step saved without metrics, and without one the latest
  ``max_to_keep``; ``best_step`` is the step of least metric (the later of
  equals), the latest step without a metric name, and None when no kept step
  has metrics.
"""

from __future__ import annotations

import json
import logging
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any

import torch

logger = logging.getLogger(__package__)

_STATE_FILE = "state.pt"
_METRICS_FILE = "metrics.json"
_TMP = ".tmp-"


def _host_copy(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Host copies of ``tensors``: pinned and asynchronous from a CUDA device
    (the caller synchronises once), clones on the CPU."""
    return {n: t.detach().to("cpu", non_blocking=True) if t.is_cuda else t.detach().clone()
            for n, t in tensors.items()}


def state_to_host(state: Any) -> dict[str, Any]:
    """A host snapshot of a ``TrainState``: ``{"step", "params", "opt_state":
    {"count", "mu", "nu"}}``, complete when this returns."""
    snapshot = {
        "step": int(state.step),
        "params": _host_copy(state.params),
        "opt_state": {"count": int(state.opt_state.count),
                      "mu": _host_copy(state.opt_state.mu),
                      "nu": _host_copy(state.opt_state.nu)},
    }
    devices = {t.device for t in state.params.values() if t.is_cuda}
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    return snapshot


def _copy_into(live: dict[str, torch.Tensor], saved: dict[str, torch.Tensor], what: str) -> None:
    """Copy ``saved`` into ``live`` in place; a missing or unexpected name, or
    a shape or dtype that differs, raises ``ValueError`` naming it."""
    missing = sorted(set(live) - set(saved))
    unexpected = sorted(set(saved) - set(live))
    if missing or unexpected:
        raise ValueError(f"checkpoint {what}: missing {missing[:5]}, unexpected {unexpected[:5]}")
    for name, tensor in live.items():
        value = saved[name]
        if value.shape != tensor.shape or value.dtype != tensor.dtype:
            raise ValueError(
                f"checkpoint {what} {name!r}: {tuple(value.shape)} {value.dtype}, the live "
                f"state has {tuple(tensor.shape)} {tensor.dtype}")
    for name, tensor in live.items():
        tensor.copy_(saved[name])


class Checkpointer:
    """Step-indexed train-state checkpoints with best-k retention.

    Args:
        directory: Checkpoint root (created if missing).
        save_total_limit: Max checkpoints kept; 0 is promoted to 1 so resume
            always works (the reference promotes 0 to >=1 under early stopping).
        metric_name: Metric key used for "best" ranking (e.g. first val split's
            CER); lower is better, matching the reference's
            ``greater_is_better=False``.
    """

    def __init__(
        self,
        directory: str | Path,
        save_total_limit: int = 1,
        metric_name: str | None = None,
    ) -> None:
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.metric_name = metric_name
        self.max_to_keep = max(1, int(save_total_limit))
        for leftover in self.directory.glob(f"*{_TMP}*"):
            shutil.rmtree(leftover, ignore_errors=True)
        # (step, metrics or None) of every step on disk, in step order.
        self._infos: list[tuple[int, dict | None]] = []
        for path in sorted((p for p in self.directory.iterdir()
                            if p.is_dir() and p.name.isdigit()), key=lambda p: int(p.name)):
            metrics_path = path / _METRICS_FILE
            metrics = (json.loads(metrics_path.read_text("utf-8"))
                       if metrics_path.exists() else None)
            self._infos.append((int(path.name), metrics))
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        # The last save's host snapshot and write times and its bytes.
        self.snapshot_seconds: float | None = None
        self.write_seconds: float | None = None
        self.saved_bytes: int | None = None

    # -- retention ----------------------------------------------------------------
    def _sorted_by_metric(self) -> list[tuple[int, dict]]:
        """The steps with metrics, worst first (orbax's order: a stable sort,
        descending for ``best_mode="min"``)."""
        with_metrics = [(s, m) for s, m in self._infos if m is not None]
        return sorted(with_metrics, key=lambda info: info[1][self.metric_name], reverse=True)

    def _steps_to_remove(self) -> list[int]:
        if len(self._infos) <= self.max_to_keep:
            return []
        if self.metric_name is None:
            return [s for s, _ in self._infos[: len(self._infos) - self.max_to_keep]]
        keep = {s for s, _ in self._sorted_by_metric()[-self.max_to_keep:]}
        keep |= {s for s, m in self._infos if m is None}
        return [s for s, _ in self._infos if s not in keep]

    def latest_step(self) -> int | None:
        with self._lock:
            return self._infos[-1][0] if self._infos else None

    def best_step(self) -> int | None:
        if self.metric_name is None:
            return self.latest_step()
        with self._lock:
            ranked = self._sorted_by_metric()
            return ranked[-1][0] if ranked else None

    def all_steps(self) -> list[int]:
        """The steps kept (on disk once ``wait`` returns)."""
        with self._lock:
            return [s for s, _ in self._infos]

    # -- save / restore -----------------------------------------------------------
    def save(self, step: int, state: Any, metrics: dict | None = None) -> bool:
        """Save the train state (async; overlaps with the next train steps).

        Returns False, saving nothing, for a step at or below the latest."""
        self.wait()
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        start = time.perf_counter()
        snapshot = state_to_host(state)
        self.snapshot_seconds = time.perf_counter() - start
        metrics = {k: float(v) for k, v in metrics.items()} if metrics else None
        with self._lock:
            self._infos.append((int(step), metrics))
        self._thread = threading.Thread(target=self._write, args=(int(step), snapshot, metrics),
                                        name=f"checkpoint-{step}", daemon=True)
        self._thread.start()
        return True

    def _write(self, step: int, snapshot: dict, metrics: dict | None) -> None:
        try:
            start = time.perf_counter()
            tmp = self.directory / f"{step}{_TMP}{uuid.uuid4().hex}"
            tmp.mkdir()
            torch.save(snapshot, tmp / _STATE_FILE)
            if metrics is not None:
                (tmp / _METRICS_FILE).write_text(json.dumps(metrics), encoding="utf-8")
            tmp.rename(self.directory / str(step))
            self.saved_bytes = (tmp.parent / str(step) / _STATE_FILE).stat().st_size
            with self._lock:
                removed = self._steps_to_remove()
                self._infos = [info for info in self._infos if info[0] not in removed]
            for old in removed:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
            self.write_seconds = time.perf_counter() - start
        except Exception as error:  # surfaced by wait()
            self._error = error

    def restore(self, state: Any, step: int | None = None) -> Any:
        """Restore a checkpoint into the live ``state``'s tensors in place
        (their devices and dtypes kept) and return it.

        Args:
            state: The live ``TrainState``; its names, shapes and dtypes must
                be the checkpoint's (``ValueError`` naming the first that is
                not).
            step: Step to restore; latest if None.
        """
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        saved = torch.load(self.directory / str(step) / _STATE_FILE, map_location="cpu",
                           weights_only=True)
        _copy_into(state.params, saved["params"], "parameter")
        _copy_into(state.opt_state.mu, saved["opt_state"]["mu"], "first moment")
        _copy_into(state.opt_state.nu, saved["opt_state"]["nu"], "second moment")
        state.step = int(saved["step"])
        state.opt_state.count = int(saved["opt_state"]["count"])
        return state

    def wait(self) -> None:
        """Block until any in-flight async save has finished."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()
