"""The fault-tolerant training loop.

Port of ``repro/train/loop.py``:

* auto-resume: on start, restore the newest valid checkpoint and continue
  from its step (the data is a pure function of (seed, step), so no
  pipeline state is saved);
* periodic async checkpoints (``CheckpointManager``) and a final sync save
  (which ``final_save=False`` leaves out);
* a NaN/Inf guard: a non-finite loss skips the parameter update (the step
  still advances; more than ``max_bad_steps`` in a row abort the run with a
  clean checkpoint);
* straggler detection: an EWMA of each step's wall time; a step slower than
  ``straggler_factor`` x EWMA is logged to ``quarantine`` with its shard
  (the port runs one process a card, so the shard is always 0);
* a metrics JSONL stream, one line a log interval.

The port's steps update the state IN PLACE (``distributed.steps``), so a
step whose loss is not finite must not run its update at all: where
``step_fn`` has the two halves ``step_fn.grads(state, batch) -> ((loss,
metrics), grads)`` and ``step_fn.update(state, grads, metrics) -> (state,
metrics)`` (as ``make_train_step``'s step has), the loop runs ``grads``,
tests the loss and only then ``update``.  A plain ``step_fn(state, batch)
-> (state, metrics)`` keeps the reference's contract: it returns a new
state, and the old one is kept on a bad loss.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Callable

import torch

from repro_torch.train.checkpoint import CheckpointManager, latest_step, restore


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    total_steps: int
    checkpoint_dir: str | None = None
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    log_every: int = 10
    metrics_path: str | None = None
    max_bad_steps: int = 10  # consecutive non-finite losses tolerated
    straggler_factor: float = 3.0
    straggler_warmup: int = 5  # steps before the EWMA is trusted
    ewma_alpha: float = 0.1
    # False: no sync save at the end (a run that resumes a checkpoint where
    # the disk holds only one of its size); the periodic saves still run.
    final_save: bool = True


def _scalar(x) -> float:
    return float(x.detach().cpu()) if isinstance(x, torch.Tensor) else float(x)


def _is_scalar(x) -> bool:
    return (x.ndim == 0) if isinstance(x, torch.Tensor) else isinstance(x, (int, float))


class TrainLoop:
    def __init__(self, step_fn: Callable[[Any, Any], tuple[Any, dict]],
                 batch_fn: Callable[[int], Any], cfg: TrainLoopConfig, *,
                 state_shardings=None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.state_shardings = state_shardings
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
                     if cfg.checkpoint_dir else None)
        self.history: list[dict] = []
        self.quarantine: list[dict] = []
        self.restore_stats: dict = {}

    # -- resume -----------------------------------------------------------

    def restore_or(self, init_state):
        """Newest valid checkpoint if any (restored into ``init_state``'s
        tensors in place), else ``init_state``.  Returns (state, start_step)."""
        if self.ckpt is None or latest_step(self.cfg.checkpoint_dir) is None:
            return init_state, 0
        self.restore_stats = {}
        state, step, _ = restore(self.cfg.checkpoint_dir, init_state,
                                 shardings=self.state_shardings, stats=self.restore_stats)
        return state, step

    # -- main -------------------------------------------------------------

    def _step(self, state, batch):
        """(state after the step or ``state`` itself, metrics, loss, finite)."""
        halves = getattr(self.step_fn, "grads", None), getattr(self.step_fn, "update", None)
        if all(halves):
            (_, metrics), grads = halves[0](state, batch)
            loss = _scalar(metrics.get("loss", 0.0))
            if not math.isfinite(loss):
                return state, metrics, loss, False
            state, metrics = halves[1](state, grads, metrics)
            return state, metrics, loss, True
        new_state, metrics = self.step_fn(state, batch)
        loss = _scalar(metrics.get("loss", 0.0))
        return (new_state if math.isfinite(loss) else state), metrics, loss, math.isfinite(loss)

    def run(self, init_state, start_step: int | None = None):
        state, resumed = self.restore_or(init_state)
        step = resumed if start_step is None else start_step
        cfg = self.cfg
        ewma = None
        bad_streak = 0
        mfile = open(cfg.metrics_path, "a") if cfg.metrics_path else None

        try:
            while step < cfg.total_steps:
                batch = self.batch_fn(step)
                t0 = time.perf_counter()
                state, metrics, loss, finite = self._step(state, batch)
                dt = time.perf_counter() - t0

                # NaN guard: the update was skipped (the state is the old
                # one); advance the step (the batch is a function of the
                # step, so retrying it would loop).
                if not finite:
                    bad_streak += 1
                    self._log(mfile, step, {"loss": loss, "skipped": 1}, dt)
                    if bad_streak > cfg.max_bad_steps:
                        if self.ckpt:
                            self.ckpt.save(state, step, block=True)
                        raise FloatingPointError(
                            f"{bad_streak} consecutive non-finite losses at step {step}")
                else:
                    bad_streak = 0

                # Straggler detection (EWMA of the step's wall time).
                if ewma is None:
                    ewma = dt
                elif step > cfg.straggler_warmup and dt > cfg.straggler_factor * ewma:
                    self.quarantine.append({"step": step, "dt": dt, "ewma": ewma, "shard": 0})
                else:
                    ewma = (1 - cfg.ewma_alpha) * ewma + cfg.ewma_alpha * dt

                step += 1
                if step % cfg.log_every == 0 or step == cfg.total_steps:
                    rec = {k: _scalar(v) for k, v in metrics.items() if _is_scalar(v)}
                    self._log(mfile, step, rec, dt)
                if self.ckpt and step % cfg.checkpoint_every == 0:
                    self.ckpt.save(state, step)

            if self.ckpt and cfg.final_save:
                self.ckpt.save(state, step, block=True)
        finally:
            if self.ckpt:
                self.ckpt.wait()
            if mfile:
                mfile.close()
        return state, step

    def _log(self, mfile, step: int, metrics: dict, dt: float):
        rec = {"step": step, "dt_s": round(dt, 4), **metrics}
        self.history.append(rec)
        if mfile:
            mfile.write(json.dumps(rec) + "\n")
            mfile.flush()
