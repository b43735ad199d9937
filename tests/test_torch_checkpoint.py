"""coral_tpu_torch's Checkpointer against coral_tpu's (orbax), on the CPU.

The port writes a torch format of its own (``training/checkpoint.py``); what
must match the JAX ``Checkpointer`` is its retention: for the same sequences
of saves (with metrics, without, before the first eval, at a step already
passed) and ``save_total_limit`` 0 to 3, with a metric name and without,
the steps left on disk, ``latest_step`` and ``best_step`` are the JAX ones
after every save, and again from a new Checkpointer over the same directory
(a resumed run). Also: a round trip restores every tensor bit for bit in
place, keeping its device and dtype; ``save`` copies the state before it
returns, so a step that changes it in place right after does not reach the
file; a name, shape or dtype that differs raises ``ValueError`` naming it; a
half-written step (its temporary directory) is never a step.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coral_tpu.training.checkpoint import Checkpointer as JaxCheckpointer
from coral_tpu_torch.training import TrainState, create_optimizer
from coral_tpu_torch.training.checkpoint import Checkpointer

torch.set_num_threads(1)

METRIC = "val_x_cer"
# (step, metric value or None (no metrics, as before the first eval)); a step
# at or below the latest is skipped by both.
SEQUENCES = {
    "metrics_with_ties": [(1, 0.5), (2, 0.3), (3, 0.4), (4, 0.3), (5, 0.6), (6, 0.2), (7, 0.2)],
    "metrics_after_none": [(1, None), (2, 0.5), (3, None), (2, 0.1), (4, 0.7), (5, 0.5),
                           (6, 0.9)],
    "no_metrics": [(2, None), (4, None), (4, None), (6, None), (8, None)],
}


def _steps_on_disk(directory):
    return sorted(int(p.name) for p in directory.iterdir() if p.is_dir() and p.name.isdigit())


def _state(seed=0):
    """A small TrainState: two fp32 masters, a bf16 first moment."""
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    tx, _ = create_optimizer(1e-3, warmup_steps=1, max_steps=10, mu_dtype="bfloat16")
    state = TrainState.create(model, tx)
    for d in (state.opt_state.mu, state.opt_state.nu):
        for n in d:
            d[n].copy_(torch.randn(d[n].shape, generator=gen).to(d[n].dtype))
    return state


@pytest.mark.parametrize("limit", [0, 1, 2, 3])
@pytest.mark.parametrize("with_metric", [True, False], ids=["metric", "no_metric_name"])
@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
def test_retention_matches_orbax(tmp_path, sequence, with_metric, limit):
    name = METRIC if with_metric else None
    jax_ckpt = JaxCheckpointer(tmp_path / "jax", save_total_limit=limit, metric_name=name)
    port = Checkpointer(tmp_path / "port", save_total_limit=limit, metric_name=name)
    jax_state = {"w": jnp.zeros((2,))}
    state = _state()
    for step, value in SEQUENCES[sequence]:
        metrics = None if value is None else {METRIC: value, "val_x_wer": 1.0}
        jax_ckpt.save(step, jax_state, metrics)
        port.save(step, state, metrics)
        jax_ckpt.wait()
        port.wait()
        assert _steps_on_disk(tmp_path / "port") == _steps_on_disk(tmp_path / "jax"), step
        assert port.all_steps() == _steps_on_disk(tmp_path / "port")
        assert port.latest_step() == jax_ckpt.latest_step()
        assert port.best_step() == jax_ckpt.best_step()
    jax_ckpt.close()
    port.close()
    # A resumed run: a new Checkpointer over the same directory.
    jax_again = JaxCheckpointer(tmp_path / "jax", save_total_limit=limit, metric_name=name)
    again = Checkpointer(tmp_path / "port", save_total_limit=limit, metric_name=name)
    assert again.latest_step() == jax_again.latest_step()
    assert again.best_step() == jax_again.best_step()
    step = again.latest_step() + 1
    jax_again.save(step, jax_state, {METRIC: 0.0} if with_metric else None)
    again.save(step, state, {METRIC: 0.0} if with_metric else None)
    jax_again.close()
    again.close()
    assert _steps_on_disk(tmp_path / "port") == _steps_on_disk(tmp_path / "jax")
    assert again.best_step() == jax_again.best_step()


def test_round_trip_in_place(tmp_path):
    state = _state(0)
    ckpt = Checkpointer(tmp_path, save_total_limit=2)
    state.step, state.opt_state.count = 7, 7
    want = {k: {n: t.clone() for n, t in d.items()}
            for k, d in (("params", state.params), ("mu", state.opt_state.mu),
                         ("nu", state.opt_state.nu))}
    assert ckpt.save(7, state, {"val_x_cer": 0.25})
    # The state changes in place before the write has finished: the file
    # holds the values of the save.
    for d in (state.params, state.opt_state.mu, state.opt_state.nu):
        for t in d.values():
            t.add_(1)
    ckpt.wait()
    assert json.loads((tmp_path / "7" / "metrics.json").read_text()) == {"val_x_cer": 0.25}
    other = _state(1)
    live = {n: t for n, t in other.params.items()}
    restored = ckpt.restore(other)
    assert restored is other and other.step == 7 and other.opt_state.count == 7
    for k, d in (("params", other.params), ("mu", other.opt_state.mu),
                 ("nu", other.opt_state.nu)):
        for n, t in d.items():
            assert t.dtype == want[k][n].dtype and torch.equal(t, want[k][n]), (k, n)
    assert all(other.params[n] is t for n, t in live.items())  # in place
    assert other.opt_state.mu["weight"].dtype == torch.bfloat16
    assert ckpt.saved_bytes == (tmp_path / "7" / "state.pt").stat().st_size
    assert ckpt.snapshot_seconds is not None and ckpt.write_seconds is not None
    ckpt.close()


@pytest.mark.parametrize("change", ["shape", "dtype", "missing", "unexpected"])
def test_a_state_that_differs_raises(tmp_path, change):
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, _state())
    ckpt.wait()
    state = _state()
    if change == "shape":
        state.params["bias"] = torch.zeros(5)
    elif change == "dtype":
        state.opt_state.mu["weight"] = state.opt_state.mu["weight"].float()
    elif change == "missing":
        state.params["extra"] = torch.zeros(1)
    else:
        del state.opt_state.nu["bias"]
    with pytest.raises(ValueError, match="bias|weight|extra"):
        ckpt.restore(state)


def test_a_half_written_step_is_not_a_step(tmp_path):
    ckpt = Checkpointer(tmp_path)
    ckpt.save(3, _state())
    ckpt.close()
    (tmp_path / "5.tmp-0123").mkdir()
    again = Checkpointer(tmp_path)
    assert again.latest_step() == 3 and again.all_steps() == [3]
    assert not (tmp_path / "5.tmp-0123").exists()
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(_state())


def test_save_at_a_passed_step_is_skipped(tmp_path):
    ckpt = Checkpointer(tmp_path)
    assert ckpt.save(4, _state())
    assert not ckpt.save(4, _state())
    assert not ckpt.save(2, _state())
    ckpt.close()
    assert _steps_on_disk(tmp_path) == [4]
    assert np.isfinite(ckpt.write_seconds)
