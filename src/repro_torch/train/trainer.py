"""Training loop of the port with the JAX package's fault-tolerance
behaviours (``repro/train/trainer.py``):

* resume from the latest valid checkpoint (the data pipeline is indexed by
  step, so batches replay identically);
* atomic periodic checkpointing (``checkpoint/``): every ``ckpt_every``
  steps and at the end;
* step watchdog: a wall-time EWMA per step; steps slower than
  ``straggler_factor`` x EWMA are logged as straggler events;
* NaN guard: a step with a non-finite loss is skipped, and after
  ``max_bad_steps`` in a row the state is restored from the latest
  checkpoint;
* ``trainer_report.json`` in the checkpoint directory.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint.checkpointing import restore_latest, save_checkpoint
from repro_torch.train.train_step import load_state

PyTree = Any


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    straggler_factor: float = 3.0
    max_bad_steps: int = 3
    keep_checkpoints: int = 3


@dataclass
class TrainerReport:
    steps_run: int = 0
    resumed_from: int = -1
    losses: list[float] = field(default_factory=list)
    straggler_events: list[dict] = field(default_factory=list)
    bad_step_events: int = 0
    restores: int = 0
    wall_time_s: float = 0.0


class Trainer:
    def __init__(
        self,
        train_step: Callable[[PyTree, dict], tuple[PyTree, dict]],
        pipeline,
        cfg: TrainerConfig,
    ):
        self.train_step = train_step
        self.pipeline = pipeline
        self.cfg = cfg

    def run(self, state: PyTree) -> tuple[PyTree, TrainerReport]:
        cfg = self.cfg
        report = TrainerReport()
        t_start = time.perf_counter()

        restored, step0 = restore_latest(cfg.ckpt_dir, state)
        if restored is not None:
            state = load_state(state, restored)
            report.resumed_from = step0
            report.restores += 1
        step = int(state["step"]) if "step" in state else max(step0, 0)

        ewma = None
        bad = 0
        while step < cfg.total_steps:
            batch = self.pipeline.batch_at(step)
            t0 = time.perf_counter()
            new_state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])  # blocks; wall time real
            dt = time.perf_counter() - t0

            if ewma is None:
                ewma = dt
            if dt > cfg.straggler_factor * ewma and step > 2:
                report.straggler_events.append(
                    {"step": step, "wall_s": round(dt, 4), "ewma_s": round(ewma, 4)}
                )
            ewma = 0.9 * ewma + 0.1 * dt

            if not np.isfinite(loss):
                bad += 1
                report.bad_step_events += 1
                if bad >= cfg.max_bad_steps:
                    restored, rstep = restore_latest(cfg.ckpt_dir, state)
                    if restored is not None:
                        state = load_state(state, restored)
                        step = rstep
                        report.restores += 1
                    bad = 0
                    continue
                step += 1  # skip the update
                continue
            bad = 0
            state = new_state
            step += 1
            report.losses.append(loss)
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                save_checkpoint(cfg.ckpt_dir, step, state, keep=cfg.keep_checkpoints)
            if step % cfg.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"wall={dt*1e3:.1f}ms", flush=True)

        report.steps_run = cfg.total_steps - max(step0, 0)
        report.wall_time_s = time.perf_counter() - t_start
        Path(cfg.ckpt_dir, "trainer_report.json").write_text(
            json.dumps(report.__dict__, default=str))
        return state, report
