"""Training loop with fault tolerance and straggler monitoring (port of
``repro.train.loop``).

TrainLoop wires: resumable data -> train step -> async checkpoints. On
preemption, a new loop restores the latest checkpoint (params, optimizer
state) AND seeks the data iterator, resuming bit-exact. Each step's wall
time ends when its loss reaches the host (``.item()``, where the reference
calls ``block_until_ready``).

StepMonitor is the straggler hook: per-step wall times feed an outlier
detector (> threshold x running median).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from ..checkpoint.manager import CheckpointManager

__all__ = ["StepMonitor", "TrainLoop"]


class StepMonitor:
    def __init__(self, window: int = 32, threshold: float = 3.0):
        self.times: list[float] = []
        self.window = window
        self.threshold = threshold
        self.flagged: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = float(np.median(hist))
        is_outlier = len(hist) >= 8 and dt > self.threshold * med
        if is_outlier:
            self.flagged.append(step)
        return is_outlier

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,  # (params, opt, batch, step) -> (params, opt, metrics)
        dataset,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        keep_last_k: int = 3,
        on_straggler: Optional[Callable] = None,
    ):
        self.step_fn = step_fn
        self.dataset = dataset
        self.manager = CheckpointManager(ckpt_dir, keep_last_k) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.monitor = StepMonitor()
        self.on_straggler = on_straggler
        self.step = 0
        self.losses: list[float] = []  # each step's loss, as the host read it

    def maybe_restore(self, params, opt_state):
        """Resume from the latest checkpoint if one exists."""
        if self.manager and self.manager.latest_step() is not None:
            tree = {"params": params, "opt": opt_state}
            tree, step, extra = self.manager.restore(tree)
            self.step = step
            self.dataset.load_state_dict(extra.get("data", {"step": step}))
            return tree["params"], tree["opt"], True
        return params, opt_state, False

    def run(self, params, opt_state, num_steps: int, log_every: int = 10, log_fn=print):
        it = iter(self.dataset)
        metrics = {}
        target = self.step + num_steps
        while self.step < target:
            batch = next(it)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch, self.step)
            loss = metrics["loss"].item()  # waits for the step
            dt = time.perf_counter() - t0
            self.losses.append(loss)
            if self.monitor.record(self.step, dt) and self.on_straggler:
                self.on_straggler(self.step, dt, self.monitor)
            self.step += 1
            if log_every and self.step % log_every == 0:
                log_fn(f"step {self.step} loss {loss:.6f} ({dt * 1e3:.0f} ms)")
            if self.manager and self.step % self.ckpt_every == 0:
                self.manager.save_async(
                    self.step, {"params": params, "opt": opt_state},
                    extra={"data": self.dataset.state_dict()},
                )
        if self.manager:
            self.manager.save(
                self.step, {"params": params, "opt": opt_state},
                extra={"data": self.dataset.state_dict()},
            )
        return params, opt_state, metrics
