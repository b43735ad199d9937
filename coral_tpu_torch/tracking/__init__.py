"""Pluggable experiment tracking (wandb / mlflow / none).

Mirrors the reference's plugin layer (reference:
``src/coral/experiment_tracking/extracking_factory.py:13-32``,
``extracking_setup.py:8-34``, ``wandb_setup.py``, ``mlflow_setup.py``): a factory
dispatching on ``config.experiment_tracking.type`` to a setup object with
``run_initialization`` / ``run_finalization`` hooks, plus a ``log_metrics`` hook the
training loop calls every ``logging_steps``. SDKs are imported lazily and absence
degrades to the no-op tracker, so offline environments train unchanged.

A copy of ``coral_tpu/tracking/__init__.py``.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Any

logger = logging.getLogger(__package__)

__all__ = ["TrackingSetup", "NoOpSetup", "WandbSetup", "MLFlowSetup",
           "load_tracking_setup"]


class TrackingSetup(ABC):
    """Experiment-tracking lifecycle hooks."""

    def __init__(self, config: Any) -> None:
        self.config = config

    @abstractmethod
    def run_initialization(self) -> None:
        """Start a tracked run."""

    def log_metrics(self, metrics: dict, step: int) -> None:
        """Record scalar metrics at a global step."""

    @abstractmethod
    def run_finalization(self) -> None:
        """Close the tracked run."""


class NoOpSetup(TrackingSetup):
    """Tracking disabled (``enable_experiment_tracking=false`` or SDK missing)."""

    def run_initialization(self) -> None:
        pass

    def run_finalization(self) -> None:
        pass


class WandbSetup(TrackingSetup):
    """Weights & Biases run wrapper (reference: ``wandb_setup.py:8-24``)."""

    def run_initialization(self) -> None:
        import wandb

        from ..config import to_container

        tracking = self.config.experiment_tracking
        wandb.init(
            project=tracking.get("name_experiment", "coral-tpu"),
            name=tracking.get("name_run", self.config.get("model_id")),
            group=tracking.get("name_group"),
            config=to_container(self.config, resolve=True),
        )

    def log_metrics(self, metrics: dict, step: int) -> None:
        import wandb

        wandb.log(metrics, step=step)

    def run_finalization(self) -> None:
        import wandb

        wandb.finish()


class MLFlowSetup(TrackingSetup):
    """MLFlow run wrapper (reference: ``mlflow_setup.py:8-20``)."""

    def run_initialization(self) -> None:
        import mlflow

        tracking = self.config.experiment_tracking
        mlflow.set_experiment(tracking.get("name_experiment", "coral-tpu"))
        mlflow.start_run(
            run_name=tracking.get("name_run", self.config.get("model_id"))
        )

    def log_metrics(self, metrics: dict, step: int) -> None:
        import mlflow

        mlflow.log_metrics(
            {k: float(v) for k, v in metrics.items()}, step=step
        )

    def run_finalization(self) -> None:
        import mlflow

        mlflow.end_run()


def load_tracking_setup(config: Any) -> TrackingSetup:
    """Factory (reference: ``extracking_factory.py:13-32``).

    Falls back to :class:`NoOpSetup` when tracking is disabled, the type is
    unknown, or the SDK is not installed.
    """
    if not config.get("enable_experiment_tracking", False):
        return NoOpSetup(config)
    tracking_type = config.select("experiment_tracking.type", "none")
    setup_cls = {"wandb": WandbSetup, "mlflow": MLFlowSetup}.get(tracking_type)
    if setup_cls is None:
        if tracking_type not in ("none", None):
            raise ValueError(f"Unsupported experiment tracking: {tracking_type!r}")
        return NoOpSetup(config)
    try:
        __import__(tracking_type)
    except ImportError:
        logger.warning(
            f"{tracking_type} is not installed; experiment tracking is disabled."
        )
        return NoOpSetup(config)
    return setup_cls(config)
